"""Small reductions that several metric readers share."""

from __future__ import annotations

import collections


def per_instance_mean(trees: list, key: str) -> float:
    """Mean over instances of each instance's mean of ``key``: every
    instance weighs the same, however many of its trees the window held."""
    by = collections.defaultdict(list)
    for t in trees:
        by[t["instance"]].append(t[key])
    means = [sum(v) / len(v) for v in by.values()]
    return sum(means) / len(means)


def idle_percent(rec: dict):
    """Share of the profiled wall in which no device operation ran, in %;
    None without a profile."""
    prof = rec.get("profile")
    if not prof or prof["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])


def launches_per_iter(rec: dict):
    """Kernels in the profiled span over the IPM iterations it ran; None
    without a profile."""
    prof = rec.get("profile")
    if not prof or not rec.get("profile_iters"):
        return None
    return prof["kernels"] / rec["profile_iters"]
