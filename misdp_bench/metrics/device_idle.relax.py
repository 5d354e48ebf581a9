"""device_idle.relax: share of the profiled solves' wall in which no device
operation ran, in %."""

from misdp_bench.records import idle_percent


def read(rec):
    return idle_percent(rec) if "solves" in rec else None
