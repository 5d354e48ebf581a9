"""tree_ipm_iters: IPM iterations a tree (BBResult.stats.ipm_iterations),
every instance weighing the same."""

from misdp_bench.records import per_instance_mean


def read(rec):
    if not rec.get("trees"):
        return None
    return per_instance_mean(rec["trees"], "ipm_iters")
