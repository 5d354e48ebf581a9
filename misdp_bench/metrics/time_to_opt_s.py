"""time_to_opt_s: mean wall to a proven optimum, every instance of the
cycle weighing the same (the mean of its trees' walls)."""

from misdp_bench.records import per_instance_mean


def read(rec):
    if not rec.get("trees"):
        return None
    return per_instance_mean(rec["trees"], "wall_s")
