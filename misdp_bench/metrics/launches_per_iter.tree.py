"""launches_per_iter.tree: kernels in the profiled tree over its IPM
iterations (BBResult.stats.ipm_iterations)."""

from misdp_bench.records import launches_per_iter


def read(rec):
    return launches_per_iter(rec) if "trees" in rec else None
