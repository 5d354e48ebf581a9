"""Reduced-cost / dual fixing propagation.

Port of prop_sdpredcost.c (doc :100-144): after a node relaxation solve
with value v and primal bound-multiplier values xlb/xub (the reference's
X̄_lb/X̄_ub from SCIPsdpiGetPrimalBoundVars, sdpi.c:4379), any feasible
point better than the cutoff bound v_CO (incumbent) satisfies

    y_j <= l_j + (v_CO - v) / xlb_j      when xlb_j > 0
    y_j >= u_j - (v_CO - v) / xub_j      when xub_j > 0

(convexity: the bound multiplier is the reduced cost of moving off the
active bound).  For binary variables this fixes them outright when the
allowed interval excludes 0 or 1 (prop_sdpredcost.c:100-133).

numpy only: a copy of the JAX package's ``core/propredcost.py``, kept beside it
rather than imported so this package never imports JAX.
"""

from __future__ import annotations

import numpy as np

MIN_MULT = 1e-6   # ignore tiny multipliers (numerical noise)


def redcost_tighten(lb: np.ndarray, ub: np.ndarray,
                    xlb: np.ndarray, xub: np.ndarray, relaxval: float,
                    cutoff: float, integral: np.ndarray,
                    feastol: float) -> int:
    """Tighten lb/ub in place; returns the number of tightenings."""
    if not np.isfinite(cutoff) or cutoff - relaxval < 0:
        return 0
    slack = cutoff - relaxval
    n = 0
    # upper bounds from lower-bound multipliers
    act_lo = (xlb > MIN_MULT) & (lb > -1e19)
    cand_ub = np.where(act_lo, lb + slack / np.maximum(xlb, MIN_MULT), np.inf)
    cand_ub = np.where(integral & act_lo, np.floor(cand_ub + feastol), cand_ub)
    mask = cand_ub < ub - feastol
    n += int(mask.sum())
    ub[mask] = cand_ub[mask]
    # lower bounds from upper-bound multipliers
    act_hi = (xub > MIN_MULT) & (ub < 1e19)
    cand_lb = np.where(act_hi, ub - slack / np.maximum(xub, MIN_MULT), -np.inf)
    cand_lb = np.where(integral & act_hi, np.ceil(cand_lb - feastol), cand_lb)
    mask = cand_lb > lb + feastol
    n += int(mask.sum())
    lb[mask] = cand_lb[mask]
    return n
