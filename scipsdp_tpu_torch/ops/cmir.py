"""Complemented mixed-integer rounding (c-MIR) cut strengthening.

The reference strengthens every eigenvector cut with SCIP's c-MIR
heuristic (cons_sdp.c:1039-1127: the >=-row is flipped to <=-form, loaded
into an aggregation row and passed to SCIPcutGenerationHeuristicCMIR;
DEFAULT_GENERATECMIR = TRUE, cons_sdp.c:145).  This module is a standalone
implementation of the same Marchand-Wolsey c-MIR procedure:

1. *Bound complementation*: each variable with a nonzero coefficient is
   shifted to a nonnegative variable using its global lower or upper bound
   (choosing the bound closer to the point being separated).
2. *Scaling trials*: for a set of divisors delta (the absolute values of
   the integer-variable coefficients), apply the MIR function to the
   scaled row  sum_j (a_j / delta) x_j <= b / delta  with fractionality
   f0 = frac(b / delta) in [minfrac, maxfrac]:

       integer j:    floor(a_j) + (frac(a_j) - f0)^+ / (1 - f0)
       continuous j: min(a_j, 0) / (1 - f0)

3. Keep the most *efficacious* resulting cut (violation at the separation
   point divided by the coefficient norm), un-complement back to the
   original variable space.

The conflict-cut path of the relaxator uses the same routine
(relax_sdp.c:954 computeConflictCut with usecmir).

numpy only: a copy of the JAX package's ``ops/cmir.py``, kept beside it
rather than imported so this package never imports JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from scipsdp_tpu_torch.models.problem import INF

MINFRAC = 0.05       # SCIP's BOUNDSWITCH defaults used by cons_sdp.c:90-96
MAXFRAC = 0.999
MIN_EFFICACY = 1e-4  # SCIP minimal cut efficacy


def cmir_cut(g: np.ndarray, lhs: float, lb: np.ndarray, ub: np.ndarray,
             integral: np.ndarray, ystar: np.ndarray,
             eps: float = 1e-9) -> Optional[Tuple[np.ndarray, float]]:
    """Strengthen the valid >=-row  g @ y >= lhs  by c-MIR.

    ``lb``/``ub`` must be *globally* valid bounds so the returned cut is
    globally valid.  Returns the strengthened row as (coefs, lhs') in
    >=-form, or None when no efficacious MIR cut exists.
    """
    g = np.asarray(g, dtype=np.float64)
    m = g.shape[0]
    a = -g                      # <=-form:  a @ y <= b
    b = -float(lhs)
    nz = np.where(np.abs(a) > eps)[0]
    if nz.size == 0:
        return None

    # 1. bound complementation
    use_ub = np.zeros(m, dtype=bool)
    for j in nz:
        flb = lb[j] > -INF / 2
        fub = ub[j] < INF / 2
        if not flb and not fub:
            return None
        if flb and fub:
            # choose the bound closer to the separation point
            use_ub[j] = (ub[j] - ystar[j]) < (ystar[j] - lb[j])
        else:
            use_ub[j] = not flb
    ap = np.where(use_ub, -a, a)[nz]                    # transformed coefs
    shift = np.where(use_ub, ub, lb)[nz]
    bp = b - float(a[nz] @ shift)
    xstar = np.where(use_ub[nz], ub[nz] - ystar[nz], ystar[nz] - lb[nz])
    xstar = np.maximum(xstar, 0.0)
    isint = integral[nz]

    # MIR needs nonnegative continuous variables only on the complemented
    # side; positive continuous coefficients are dropped (made weaker) —
    # this is always valid for x >= 0

    # 2. scaling candidates from integer coefficients
    cand = set()
    for aj in np.abs(ap[isint]):
        if aj > eps:
            cand.add(round(float(aj), 12))
    cand.add(1.0)
    best = None
    best_eff = MIN_EFFICACY
    for delta in cand:
        d = bp / delta
        f0 = d - np.floor(d)
        if f0 < MINFRAC or f0 > MAXFRAC:
            continue
        sc = ap / delta
        coef = np.where(
            isint,
            np.floor(sc) + np.maximum((sc - np.floor(sc)) - f0, 0.0)
            / (1.0 - f0),
            np.minimum(sc, 0.0) / (1.0 - f0),
        )
        rhs = np.floor(d)
        norm = np.linalg.norm(coef)
        viol = float(coef @ xstar - rhs)
        if norm <= eps:
            if viol > eps:
                # empty cut with positive violation: infeasibility proof
                return np.zeros(m), 1.0
            continue
        eff = viol / norm
        if eff > best_eff:
            best_eff = eff
            best = (coef.copy(), float(rhs))
    if best is None:
        return None

    # 3. un-complement:  sum_j c_j x'_j <= rhs  with x'_j = y_j - lb_j or
    # ub_j - y_j  ->  ghat @ y <= rhs_hat
    coef, rhs = best
    ghat = np.zeros(m)
    rhs_hat = rhs
    for i, j in enumerate(nz):
        if abs(coef[i]) <= eps:
            continue
        if use_ub[j]:
            ghat[j] -= coef[i]
            rhs_hat -= coef[i] * ub[j]
        else:
            ghat[j] += coef[i]
            rhs_hat += coef[i] * lb[j]
    # return in >=-form
    return -ghat, -float(rhs_hat)
