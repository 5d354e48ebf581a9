"""Host-side bound propagation.

Activity-based bound tightening over the LP rows (the role SCIP's core
propagation plays for the reference) plus integer-bound rounding.  Used at
the root and at node creation; vectorized numpy fixpoint iteration.

For a row  lhs <= d^T y <= rhs  and variable j with d_j != 0, the residual
activity bounds of the other variables give

    d_j > 0:  y_j >= (lhs - restmax_{-j}) / d_j,  y_j <= (rhs - restmin_{-j}) / d_j
    d_j < 0:  symmetric.

Infinite bounds are handled by *counting* infinite contributions per row
rather than arithmetic with +-1e20 sentinels (naive subtraction suffers
catastrophic absorption: 1e20 + 1 == 1e20 in double precision, silently
dropping finite terms): a residual activity is usable only when no *other*
variable contributes an infinite term.

This derives finite boxes for CBF PSD-variable entries (free scalar
variables constrained only through rows), which the rank-1 secant cuts and
spatial branching need (core/rank1.py).

numpy only: a copy of the JAX package's ``core/propagate.py``, kept beside it
rather than imported so this package never imports JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from scipsdp_tpu_torch.models.problem import INF, MISDP


def tighten_bounds(prob: MISDP, lb: np.ndarray, ub: np.ndarray,
                   rounds: int = 5, feastol: float = 1e-9,
                   extra=None) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Return (lb', ub', conflict). Does not modify inputs.

    ``extra``: optional (D, lhs, rhs) additional rows — e.g. conflict
    constraints (generateConflictCons, relax_sdp.c:1424), which the
    reference adds as propagation-only linear constraints."""
    lb = lb.copy()
    ub = ub.copy()
    # integer-bound rounding FIRST: upstream tighteners (one-var SDP
    # bounds, upper-bound propagation) may have derived fractional bounds
    # on integer variables; these must be ceiled/floored even when the
    # row loop below exits early (no LP rows)
    ints = prob.integral
    lb[ints] = np.where(lb[ints] > -INF / 2, np.ceil(lb[ints] - 1e-6),
                        lb[ints])
    ub[ints] = np.where(ub[ints] < INF / 2, np.floor(ub[ints] + 1e-6),
                        ub[ints])
    if np.any(lb > ub + 1e-6):
        return lb, ub, True
    D = prob.lp.dense(prob.nvars)       # (p, m)
    lhs = prob.lp.lhs
    rhs = prob.lp.rhs
    if prob.proprows is not None and prob.proprows.nrows:
        # propagation-only presolve rows (presollinconssparam=0 semantics)
        D = np.concatenate([D, prob.proprows.dense(prob.nvars)], axis=0)
        lhs = np.concatenate([lhs, prob.proprows.lhs])
        rhs = np.concatenate([rhs, prob.proprows.rhs])
    if extra is not None and len(extra[1]):
        D = np.concatenate([D, np.asarray(extra[0])], axis=0)
        lhs = np.concatenate([lhs, np.asarray(extra[1])])
        rhs = np.concatenate([rhs, np.asarray(extra[2])])
    if D.shape[0] == 0:
        return lb, ub, False
    pos = np.maximum(D, 0.0)
    neg = np.minimum(D, 0.0)
    nzmask = D != 0.0
    has_lhs = lhs > -INF / 2
    has_rhs = rhs < INF / 2

    for _ in range(rounds):
        lbinf = lb < -INF / 2
        ubinf = ub > INF / 2
        lbf = np.where(lbinf, 0.0, lb)
        ubf = np.where(ubinf, 0.0, ub)
        # per-(row, var) contribution bounds, infinite ones zeroed + counted
        cmax = pos * ubf[None, :] + neg * lbf[None, :]
        cmin = pos * lbf[None, :] + neg * ubf[None, :]
        infmax = (pos > 0) & ubinf[None, :] | (neg < 0) & lbinf[None, :]
        infmin = (pos > 0) & lbinf[None, :] | (neg < 0) & ubinf[None, :]
        cmax = np.where(infmax, 0.0, cmax)
        cmin = np.where(infmin, 0.0, cmin)
        maxact = cmax.sum(axis=1)
        minact = cmin.sum(axis=1)
        ninfmax = infmax.sum(axis=1)
        ninfmin = infmin.sum(axis=1)
        # residual activities excluding var j; usable iff no OTHER infinite
        rest_max = maxact[:, None] - cmax
        rest_min = minact[:, None] - cmin
        ok_max = (ninfmax[:, None] - infmax) == 0
        ok_min = (ninfmin[:, None] - infmin) == 0

        dpos = D > 0
        dneg = D < 0
        # from lhs:  d_j y_j >= lhs - rest_max
        vlhs = np.where(nzmask & has_lhs[:, None] & ok_max,
                        (lhs[:, None] - rest_max)
                        / np.where(nzmask, D, 1.0), np.nan)
        cand_lb_1 = np.where(dpos, vlhs, -np.inf)
        cand_ub_1 = np.where(dneg, vlhs, np.inf)
        # from rhs:  d_j y_j <= rhs - rest_min
        vrhs = np.where(nzmask & has_rhs[:, None] & ok_min,
                        (rhs[:, None] - rest_min)
                        / np.where(nzmask, D, 1.0), np.nan)
        cand_ub_2 = np.where(dpos, vrhs, np.inf)
        cand_lb_2 = np.where(dneg, vrhs, -np.inf)

        with np.errstate(invalid="ignore"):
            new_lb = np.fmax(np.nanmax(np.where(np.isnan(cand_lb_1),
                                                -np.inf, cand_lb_1), axis=0),
                             np.nanmax(np.where(np.isnan(cand_lb_2),
                                                -np.inf, cand_lb_2), axis=0))
            new_ub = np.fmin(np.nanmin(np.where(np.isnan(cand_ub_1),
                                                np.inf, cand_ub_1), axis=0),
                             np.nanmin(np.where(np.isnan(cand_ub_2),
                                                np.inf, cand_ub_2), axis=0))

        changed = False
        m_lb = new_lb > lb + feastol
        m_ub = new_ub < ub - feastol
        if m_lb.any():
            lb[m_lb] = np.minimum(new_lb[m_lb], INF)
            changed = True
        if m_ub.any():
            ub[m_ub] = np.maximum(new_ub[m_ub], -INF)
            changed = True

        # integer rounding
        ints = prob.integral
        lb[ints] = np.where(lb[ints] > -INF / 2, np.ceil(lb[ints] - 1e-6),
                            lb[ints])
        ub[ints] = np.where(ub[ints] < INF / 2, np.floor(ub[ints] + 1e-6),
                            ub[ints])
        if np.any(lb > ub + 1e-6):
            return lb, ub, True
        if not changed:
            break
    return lb, ub, False


def matrix_view(prob: MISDP):
    """The reference's "matrix view" (constructMatrixvar, cons_sdp.c:570):
    per block, entries covered by exactly ONE variable, as
    {(k, i, j): (var, coef, const)} with entry value = coef*y_var - const."""
    view = {}
    for k, blk in enumerate(prob.blocks):
        A = blk.dense_coeff(prob.nvars)
        C = blk.dense_const()
        nz = np.abs(A) > 1e-12
        count = nz.sum(axis=0)
        for i in range(blk.size):
            for j in range(i + 1):
                if count[i, j] == 1:
                    v = int(np.argmax(nz[:, i, j]))
                    view[(k, i, j)] = (v, float(A[v, i, j]), float(C[i, j]))
                elif count[i, j] == 0:
                    view[(k, i, j)] = (-1, 0.0, float(C[i, j]))
    return view


def _entry_interval(view, lb, ub, key):
    """Value interval of a matrix-view entry under current bounds."""
    v, c, d = view[key]
    if v < 0:
        return -d, -d
    lo = c * (lb[v] if c > 0 else ub[v]) - d
    hi = c * (ub[v] if c > 0 else lb[v]) - d
    if abs(lo) > INF / 2:
        lo = -np.inf
    if abs(hi) > INF / 2:
        hi = np.inf
    return lo, hi


def trace_bounds(prob: MISDP, view=None) -> dict:
    """Per-block trace-bound detection (cons_sdp.c:4903-4950): a linear
    row whose variables are exactly the unique diagonal covers of block k,
    all with coefficient 1, bounds the trace; then
    |X_st| <= (X_ss + X_tt)/2 <= tracebound/2 tightens off-diagonals
    beyond the sqrt(diag-product) bound.  Stricter than the reference's
    match (which only checks that each row variable covers SOME diagonal):
    here every diagonal must be covered with coefficient 1 and zero
    constant, so  trace = sum(row vars)  holds exactly and tracebound/2
    is sound.  Returns {block index: tracebound}."""
    if view is None:
        view = matrix_view(prob)
    out = {}
    D = prob.lp.dense(prob.nvars)
    rhs = prob.lp.rhs
    if prob.proprows is not None and prob.proprows.nrows:
        D = np.concatenate([D, prob.proprows.dense(prob.nvars)], axis=0)
        rhs = np.concatenate([rhs, prob.proprows.rhs])
    if D.shape[0] == 0:
        return out
    for k, blk in enumerate(prob.blocks):
        diagvars = set()
        ok = True
        for i in range(blk.size):
            ent = view.get((k, i, i))
            if (ent is None or ent[0] < 0 or abs(ent[1] - 1.0) > 1e-9
                    or abs(ent[2]) > 1e-9):
                ok = False
                break
            diagvars.add(ent[0])
        if not ok or len(diagvars) != blk.size:
            continue
        for r in range(D.shape[0]):
            nz = np.where(np.abs(D[r]) > 1e-12)[0]
            if (len(nz) == blk.size
                    and np.allclose(D[r, nz], 1.0, atol=1e-9)
                    and set(int(j) for j in nz) == diagvars
                    and rhs[r] < INF / 2):
                out[k] = float(rhs[r])
                break
    return out


def propagate_upper_bounds(prob: MISDP, lb: np.ndarray, ub: np.ndarray,
                           view=None, feastol: float = 1e-9) -> int:
    """propagateUpperBounds (cons_sdp.c:4868): PSD implies
    |X_st| <= sqrt(X_ss X_tt); with uniquely-covered entries this tightens
    the covering variables' bounds.  Also X_ss >= 0 for diagonal entries,
    and |X_st| <= tracebound/2 when a trace constraint is detected
    (cons_sdp.c:4903-4950,5053-5066).
    Returns the number of tightenings (modifies lb/ub in place)."""
    if view is None:
        view = matrix_view(prob)
    tbs = trace_bounds(prob, view)
    n = 0
    for k, blk in enumerate(prob.blocks):
        # diagonal entries are nonnegative
        diag_hi = {}
        for i in range(blk.size):
            key = (k, i, i)
            if key not in view:
                diag_hi[i] = np.inf
                continue
            v, c, d = view[key]
            if v >= 0:
                # c*y - d >= 0
                if c > 0:
                    cand = d / c
                    if cand > lb[v] + feastol and cand < INF / 2:
                        lb[v] = cand
                        n += 1
                elif c < 0:
                    cand = d / c
                    if cand < ub[v] - feastol and cand > -INF / 2:
                        ub[v] = cand
                        n += 1
            _, hi = _entry_interval(view, lb, ub, key)
            diag_hi[i] = max(hi, 0.0)
        # off-diagonal: |X_st| <= sqrt(diag_s * diag_t)
        for s in range(blk.size):
            for t in range(s):
                key = (k, s, t)
                if key not in view:
                    continue
                v, c, d = view[key]
                tb = tbs.get(k, -1.0)
                if v < 0 or ((not np.isfinite(diag_hi[s])
                              or not np.isfinite(diag_hi[t]))
                             and tb <= 0.0):
                    continue
                if np.isfinite(diag_hi[s]) and np.isfinite(diag_hi[t]):
                    bound = np.sqrt(max(diag_hi[s], 0.0)
                                    * max(diag_hi[t], 0.0))
                else:
                    bound = np.inf
                # trace bound: X_ss + X_tt <= trace <= tb, and PSD of the
                # 2x2 minor gives |X_st| <= (X_ss + X_tt)/2
                if tb > 0.0 and tb / 2.0 < bound:
                    bound = tb / 2.0
                # -bound <= c*y - d <= bound
                hi_y = (bound + d) / c if c > 0 else (-bound + d) / c
                lo_y = (-bound + d) / c if c > 0 else (bound + d) / c
                if hi_y < ub[v] - feastol:
                    ub[v] = hi_y
                    n += 1
                if lo_y > lb[v] + feastol:
                    lb[v] = lo_y
                    n += 1
    return n


def propagate_3minors(prob: MISDP, lb: np.ndarray, ub: np.ndarray,
                      view=None, feastol: float = 1e-6) -> int:
    """propagate3Minors (cons_sdp.c:5277): if X_ss = X_tt = 1 (constant)
    and X_st is fixed to 1, PSD-ness forces rows s and t to be equal, so
    entries (s,u) and (t,u) carry the same value — their variable bounds
    intersect.  Returns number of tightenings."""
    if view is None:
        view = matrix_view(prob)
    n = 0
    for k, blk in enumerate(prob.blocks):
        ones = set()
        for i in range(blk.size):
            key = (k, i, i)
            if key in view and view[key][0] < 0 \
                    and abs(-view[key][2] - 1.0) <= feastol:
                ones.add(i)
        for s in range(blk.size):
            for t in range(s):
                if s not in ones or t not in ones:
                    continue
                key = (k, s, t)
                if key not in view:
                    continue
                lo, hi = _entry_interval(view, lb, ub, key)
                if not (abs(lo - 1.0) <= feastol and abs(hi - 1.0) <= feastol):
                    continue
                # rows s and t coincide: intersect value intervals of
                # (s,u) and (t,u) and push back to variable bounds
                for u in range(blk.size):
                    if u in (s, t):
                        continue
                    k1 = (k, max(s, u), min(s, u))
                    k2 = (k, max(t, u), min(t, u))
                    if k1 not in view or k2 not in view:
                        continue
                    v1, c1, d1 = view[k1]
                    v2, c2, d2 = view[k2]
                    lo1, hi1 = _entry_interval(view, lb, ub, k1)
                    lo2, hi2 = _entry_interval(view, lb, ub, k2)
                    lo_c, hi_c = max(lo1, lo2), min(hi1, hi2)
                    for (vv, cc, dd) in ((v1, c1, d1), (v2, c2, d2)):
                        if vv < 0 or cc == 0:
                            continue
                        a = (lo_c + dd) / cc
                        bby = (hi_c + dd) / cc
                        nlo, nhi = (a, bby) if cc > 0 else (bby, a)
                        if nlo > lb[vv] + feastol and nlo > -INF / 2:
                            lb[vv] = nlo
                            n += 1
                        if nhi < ub[vv] - feastol and nhi < INF / 2:
                            ub[vv] = nhi
                            n += 1
    return n


def tighten_bounds_onevar(prob: MISDP, lb: np.ndarray, ub: np.ndarray,
                          feastol: float = 1e-6) -> int:
    """tightenBounds (cons_sdp.c:1969, default on): when every coefficient
    matrix of a block is PSD, bounding the other variables from above gives
    the necessary condition  y_j A_j >= A_0 - sum_{i!=j} ub_i A_i, a
    one-variable SDP whose feasible interval tightens y_j's bounds."""
    from scipsdp_tpu_torch.ops.onevar import solve_one_var_sdp

    n = 0
    for blk in prob.blocks:
        A = blk.dense_coeff(prob.nvars)
        C = blk.dense_const()
        vars_in = np.where(np.abs(A).reshape(prob.nvars, -1).sum(1) > 1e-12)[0]
        if len(vars_in) < 1 or len(vars_in) > 32:
            continue
        psd = all(np.linalg.eigvalsh(A[v])[0] >= -1e-9 for v in vars_in)
        if not psd:
            continue
        if np.any(ub[vars_in] > INF / 2):
            continue
        total_ub = np.einsum("j,jab->ab", ub[vars_in], A[vars_in])
        for j in vars_in:
            Cp = C - (total_ub - ub[j] * A[j])
            stl, ylo = solve_one_var_sdp(A[j], Cp, 1.0, lb[j], ub[j],
                                         feastol=feastol)
            if stl == "infeasible":
                continue
            sth, yhi = solve_one_var_sdp(A[j], Cp, -1.0, lb[j], ub[j],
                                         feastol=feastol)
            if stl == "optimal" and ylo > lb[j] + 10 * feastol:
                lb[j] = ylo
                n += 1
            if sth == "optimal" and yhi < ub[j] - 10 * feastol:
                ub[j] = yhi
                n += 1
    return n
