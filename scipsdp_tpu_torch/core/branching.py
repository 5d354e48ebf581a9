"""Branching rules on relaxation candidates.

Vectorized ports of the reference's four external branching rules
(priority order: sdpinfobjective 2000000 > sdpmostinf 1000000 >
sdpmostfrac 500000 > sdpobjective; branch_sdp*.c):

* ``mostfrac``      — maximal fractional part y - floor(y)
                      (branch_sdpmostfrac.c:88)
* ``mostinf``       — maximal infeasibility min(frac, 1 - frac)
                      (branch_sdpmostinf.c:88)
* ``objective``     — maximal |obj| among fractional candidates
                      (branch_sdpobjective.c:102)
* ``infobjective``  — maximal product infeasibility * |obj|
                      (branch_sdpinfobjective.c:101), the default.

All operate on a single node's relaxation solution (host-side numpy; the
per-node candidate sets are tiny compared to the device solves).

numpy only: a copy of the JAX package's ``core/branching.py``, kept beside it
rather than imported so this package never imports JAX.
"""

from __future__ import annotations

import numpy as np


def fractionalities(y: np.ndarray, integral: np.ndarray, feastol: float
                    ) -> np.ndarray:
    """frac part of integer vars; 0 for continuous / integral values."""
    frac = y - np.floor(y)
    isint = np.minimum(frac, 1.0 - frac) <= feastol
    return np.where(integral & ~isint, frac, 0.0)


def select_branch_var(
    y: np.ndarray,
    obj: np.ndarray,
    integral: np.ndarray,
    feastol: float,
    rule: str = "infobjective",
) -> int:
    """Return the branching variable index, or -1 if no candidate."""
    frac = fractionalities(y, integral, feastol)
    cand = frac > 0.0
    if not cand.any():
        return -1
    inf_score = np.minimum(frac, 1.0 - frac)
    if rule == "mostfrac":
        score = frac
    elif rule == "mostinf":
        score = inf_score
    elif rule == "objective":
        # |obj| with fractionality tie-break (branch_sdpobjective.c picks
        # the highest-|obj| fractional candidate)
        score = np.abs(obj) + 1e-9 * inf_score
    elif rule == "infobjective":
        score = inf_score * np.maximum(np.abs(obj), 1e-6)
    else:
        raise ValueError(f"unknown branching rule '{rule}'")
    score = np.where(cand, score, -np.inf)
    return int(np.argmax(score))
