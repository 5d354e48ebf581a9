"""tree_nodes: B&B nodes a tree (BBResult.stats.nodes), every instance
weighing the same."""

from misdp_bench.records import per_instance_mean


def read(rec):
    if not rec.get("trees"):
        return None
    return per_instance_mean(rec["trees"], "nodes")
