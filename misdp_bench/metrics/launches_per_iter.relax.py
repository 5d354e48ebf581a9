"""launches_per_iter.relax: kernels in the profiled solves over their IPM
iterations."""

from misdp_bench.records import launches_per_iter


def read(rec):
    return launches_per_iter(rec) if "solves" in rec else None
