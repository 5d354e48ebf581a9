"""device_idle.tree: share of the profiled tree's wall in which no device
operation ran, in %."""

from misdp_bench.records import idle_percent


def read(rec):
    return idle_percent(rec) if "trees" in rec else None
