"""Problem-level SDP presolve transformations.

Ports of cons_sdp.c's presolving routines that rewrite the problem once
before solving (consPresolSdp:7314):

* ``move_1x1_blocks``   — 1x1 SDP blocks become LP rows
                          (move_1x1_blocks_to_lp, cons_sdp.c:3790);
* ``diag_ge_zero_rows`` — rows  sum_j (A_j)_kk y_j >= (A_0)_kk  per
                          diagonal entry (diagGEzero, cons_sdp.c:2209;
                          default off like DEFAULT_DIAGGEZEROCUTS);
* ``two_minor_lin_rows``— eigenvector cuts with v = e_s - e_t:
                          A(y)_ss + A(y)_tt - 2 A(y)_st >= 0
                          (addTwoMinorLinConstraints, cons_sdp.c:2642;
                          default off like DEFAULT_TWOMINORLINCONSS);
* ``diag_zero_impl_rows``— implications of structurally zero diagonals:
                          X_kl != 0 forces X_kk > 0, so when (A_0)_kl != 0
                          is constant and the diagonal (k,k) is only covered
                          by nonnegative integer variables, the cut
                          sum_{i in I: (A_i)_kk > 0} y_i >= 1 is valid
                          (diagZeroImpl, cons_sdp.c:2376-2390;
                          default ON like DEFAULT_DIAGZEROIMPLCUTS);
* ``two_minor_prod_rows``— sum_i (A_i)_st y_i >= (A_0)_st
                          - sqrt((A_0)_ss (A_0)_tt)  when
                          (A_i)_ss = (A_i)_tt = 0 for all i and
                          (A_0)_ss (A_0)_tt > 0 (addTwoMinorProdConstraints,
                          cons_sdp.c:3039-3045, Gally diss. p.150;
                          default off like DEFAULT_TWOMINORPRODCONSS);
* ``two_minor_varbound_rows`` — from |X_st| <= sqrt(X_ss X_tt) and interval
                          upper bounds U_pq on the affine entries A(y)_pq
                          - (A_0)_pq:  2 U_st A(y)_st - U_tt A(y)_ss
                          <= U_st^2 (+ the constant parts), and the (s<->t)
                          twin (addTwoMinorVarBounds, cons_sdp.c:3196-3205;
                          default ON like DEFAULT_TWOMINORVARBOUNDS);
* ``tighten_matrices``  — when every coefficient matrix of a block is PSD
                          and all lower bounds are nonnegative, a binary
                          variable's matrix A_i can be scaled down to
                          factor*A_i with factor = min{y : y A_i - A_0 >= 0}
                          without changing the feasible set
                          (tightenMatrices, cons_sdp.c:1851-1960;
                          default off like DEFAULT_TIGHTENMATRICES).

All produce valid linear rows implied by the PSD constraints.  Following
the reference's ``presollinconssparam = 0`` default ("propagate, if solving
LPs also separate", cons_sdp.c:146), generated rows go to ``MISDP.proprows``
(bound propagation only) in SDP mode and into the LP relaxation rows in LP
outer-approximation mode.

numpy only: a copy of the JAX package's ``core/presolve_sdp.py``, kept beside it
rather than imported so this package never imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from scipsdp_tpu_torch.models.problem import INF, LinearConstraints, MISDP, SDPBlock


def _append_rows(lp: LinearConstraints, rows) -> LinearConstraints:
    if not rows:
        return lp
    old = [
        (list(lp.ind[lp.beg[i]:lp.beg[i + 1]]),
         list(lp.val[lp.beg[i]:lp.beg[i + 1]]), lp.lhs[i], lp.rhs[i])
        for i in range(lp.nrows)
    ]
    return LinearConstraints.from_rows(old + rows)


def move_1x1_blocks(prob: MISDP) -> MISDP:
    """1x1 SDP blocks  sum_j a_j y_j - a_0 >= 0  -> LP rows."""
    keep = []
    rows = []
    for blk in prob.blocks:
        if blk.size == 1:
            A = blk.dense_coeff(prob.nvars)[:, 0, 0]
            c = blk.dense_const()[0, 0]
            nz = np.nonzero(A)[0]
            rows.append((list(nz), list(A[nz]), float(c), INF))
        else:
            keep.append(blk)
    if not rows:
        return prob
    return dataclasses.replace(prob, blocks=keep,
                               lp=_append_rows(prob.lp, rows))


def diag_ge_zero_rows(prob: MISDP) -> List[tuple]:
    """diagGEzero rows for every diagonal entry of every block."""
    rows = []
    for blk in prob.blocks:
        A = blk.dense_coeff(prob.nvars)
        C = blk.dense_const()
        for k in range(blk.size):
            coefs = A[:, k, k]
            nz = np.nonzero(coefs)[0]
            if len(nz):
                rows.append((list(nz), list(coefs[nz]), float(C[k, k]), INF))
    return rows


def two_minor_lin_rows(prob: MISDP) -> List[tuple]:
    """v = e_s - e_t eigenvector rows per off-diagonal pair."""
    rows = []
    for blk in prob.blocks:
        A = blk.dense_coeff(prob.nvars)
        C = blk.dense_const()
        for s in range(blk.size):
            for t in range(s):
                coefs = A[:, s, s] + A[:, t, t] - 2.0 * A[:, s, t]
                rhs = C[s, s] + C[t, t] - 2.0 * C[s, t]
                nz = np.nonzero(coefs)[0]
                if len(nz):
                    rows.append((list(nz), list(coefs[nz]), float(rhs), INF))
    return rows


def diag_zero_impl_rows(prob: MISDP) -> List[tuple]:
    """diagZeroImpl cuts  sum_{i in I: (A_i)_kk > 0} y_i >= 1
    (cons_sdp.c:2376-2390).  Conditions per endpoint k of a constant
    nonzero off-diagonal (A_0)_kl: (A_0)_kk = 0, no variable covers (k,l)
    or contributes a continuous term to (k,k), and every integer variable
    has a nonnegative lower bound."""
    rows = []
    eps = 1e-12
    if prob.nvars == 0:
        return rows
    for blk in prob.blocks:
        A = blk.dense_coeff(prob.nvars)      # (m, n, n)
        C = blk.dense_const()
        vars_in = np.where(np.abs(A).reshape(prob.nvars, -1).sum(1) > eps)[0]
        # early termination: integral variable with negative lower bound
        if np.any(prob.integral[vars_in]
                  & (prob.lb[vars_in] < -eps)):
            continue
        covered = np.abs(A) > eps            # (m, n, n) variable coverage
        anyvar = covered.any(axis=0)         # (n, n)
        cont = ~prob.integral
        diag_cont = covered[cont][:, range(blk.size), range(blk.size)].any(0) \
            if cont.any() else np.zeros(blk.size, dtype=bool)
        diag_const = np.abs(np.diag(C)) > eps
        seen = set()
        for s in range(blk.size):
            for t in range(s):
                if abs(C[s, t]) <= eps or anyvar[s, t]:
                    continue                 # entry (s,t) not constant-nonzero
                for k in (s, t):
                    if k in seen or diag_const[k] or diag_cont[k]:
                        continue
                    ivars = [int(v) for v in vars_in
                             if prob.integral[v] and A[v, k, k] > eps]
                    if ivars:
                        seen.add(k)
                        rows.append((ivars, [1.0] * len(ivars), 1.0, INF))
    return rows


def two_minor_prod_rows(prob: MISDP) -> List[tuple]:
    """addTwoMinorProdConstraints (cons_sdp.c:3039-3045):
    X_st >= -sqrt(X_ss X_tt) with X_ss = -(A_0)_ss constant gives
    sum_i (A_i)_st y_i >= (A_0)_st - sqrt((A_0)_ss (A_0)_tt)."""
    rows = []
    eps = 1e-12
    for blk in prob.blocks:
        A = blk.dense_coeff(prob.nvars)
        C = blk.dense_const()
        diag_var = np.abs(A[:, range(blk.size), range(blk.size)]).max(0) \
            if prob.nvars else np.zeros(blk.size)
        for s in range(blk.size):
            for t in range(s):
                if diag_var[s] > eps or diag_var[t] > eps:
                    continue
                if C[s, s] * C[t, t] <= eps:
                    continue
                coefs = A[:, s, t]
                nz = np.nonzero(np.abs(coefs) > eps)[0]
                if len(nz) == 0:
                    continue
                lhs = float(C[s, t] - np.sqrt(C[s, s] * C[t, t]))
                rows.append((list(nz), list(coefs[nz]), lhs, INF))
    return rows


def two_minor_soc_quadcons(prob: MISDP, max_blocksize: int = 12):
    """addTwoMinorSOCConstraints (cons_sdp.c:2786-2807): per off-diagonal
    2-minor of an SDP block, PSD implies the rotated-SOC relation
    X_st^2 <= X_ss X_tt.  The reference adds SCIP SOC constraints with
    auxiliary variables; here the expanded QUADRATIC form

        (g3.y - c3)^2 - (g1.y - c1)(g2.y - c2) <= 0

    (entries as affine forms) becomes a QuadConstraint, which the
    quadratic->rank-1 upgrade lifts like any user quadratic."""
    from scipsdp_tpu_torch.models.problem import QuadConstraint

    out = []
    eps = 1e-12
    m = prob.nvars
    for bi, blk in enumerate(prob.blocks):
        if blk.size > max_blocksize:
            continue   # quadratic count grows as size^2; cap like the
        #                reference's presolve timing guards
        A = blk.dense_coeff(m)
        C = blk.dense_const()
        for s in range(blk.size):
            for t in range(s):
                g1, c1 = A[:, s, s], C[s, s]
                g2, c2 = A[:, t, t], C[t, t]
                g3, c3 = A[:, s, t], C[s, t]
                if np.abs(g3).max(initial=0.0) <= eps:
                    continue   # constant off-diagonal: nothing to bound
                nz = np.nonzero((np.abs(g1) > eps) | (np.abs(g2) > eps)
                                | (np.abs(g3) > eps))[0]
                if nz.size == 0:
                    continue
                qrow, qcol, qval = [], [], []
                for a_i, i in enumerate(nz):
                    for j in nz[: a_i + 1]:
                        if i == j:
                            q = g3[i] * g3[i] - g1[i] * g2[i]
                        else:
                            q = (2.0 * g3[i] * g3[j]
                                 - g1[i] * g2[j] - g1[j] * g2[i])
                        if abs(q) > eps:
                            qrow.append(int(i))
                            qcol.append(int(j))
                            qval.append(float(q))
                if not qval:
                    continue
                lin = -2.0 * c3 * g3 + c2 * g1 + c1 * g2
                lnz = np.nonzero(np.abs(lin) > eps)[0]
                out.append(QuadConstraint(
                    lin_ind=lnz.astype(np.int32), lin_val=lin[lnz],
                    qrow=np.asarray(qrow, np.int32),
                    qcol=np.asarray(qcol, np.int32),
                    qval=np.asarray(qval),
                    lhs=-INF, rhs=float(c1 * c2 - c3 * c3),
                    name=f"soc2minor_b{bi}_{s}_{t}"))
    return out


def _entry_interval_max(A_entry: np.ndarray, c0: float,
                        lb: np.ndarray, ub: np.ndarray):
    """Interval maximum of  sum_i a_i y_i - c0  over the box, or +inf."""
    hi = -c0
    for i in np.nonzero(np.abs(A_entry) > 1e-12)[0]:
        b = ub[i] if A_entry[i] > 0 else lb[i]
        if abs(b) >= INF / 2:
            return np.inf
        hi += A_entry[i] * b
    return hi


def two_minor_varbound_rows(prob: MISDP) -> List[tuple]:
    """addTwoMinorVarBounds (cons_sdp.c:3196-3205): with U_pq the interval
    maxima of the affine entries X_pq = A(y)_pq - (A_0)_pq, PSD-ness implies
    X_st^2 <= X_ss X_tt <= U_ss X_tt, linearized at the bound as

        2 U_st X_st - U_tt X_ss <= U_st^2    (and the s<->t twin).

    In variable terms:  sum_i (2 U_st (A_i)_st - U_tt (A_i)_ss) y_i
    <= U_st^2 + 2 U_st (A_0)_st - U_tt (A_0)_ss."""
    rows = []
    eps = 1e-9
    for blk in prob.blocks:
        A = blk.dense_coeff(prob.nvars)
        C = blk.dense_const()
        for s in range(1, blk.size):
            u_ss = _entry_interval_max(A[:, s, s], C[s, s], prob.lb, prob.ub)
            for t in range(s):
                u_st = _entry_interval_max(A[:, s, t], C[s, t],
                                           prob.lb, prob.ub)
                if not np.isfinite(u_st) or abs(u_st) <= eps:
                    continue
                u_tt = _entry_interval_max(A[:, t, t], C[t, t],
                                           prob.lb, prob.ub)
                for (ud, d1, d2) in ((u_tt, s, t), (u_ss, t, s)):
                    # row uses the diagonal (d1,d1): 2 u_st X_st - ud X_d1d1
                    if not np.isfinite(ud):
                        continue
                    coefs = 2.0 * u_st * A[:, s, t] - ud * A[:, d1, d1]
                    rhs = (u_st * u_st + 2.0 * u_st * C[s, t]
                           - ud * C[d1, d1])
                    nz = np.nonzero(np.abs(coefs) > eps)[0]
                    if len(nz):
                        rows.append((list(nz), list(coefs[nz]), -INF,
                                     float(rhs)))
    return rows


def tighten_matrices(prob: MISDP, feastol: float = 1e-6) -> MISDP:
    """tightenMatrices (cons_sdp.c:1851-1960): in a block where every
    coefficient matrix is PSD and all variable lower bounds are >= 0, a
    binary variable's matrix can be replaced by factor * A_i with
    factor = min{ y in [0,1] : y A_i - A_0 >= 0 } < 1 without changing
    the feasible set (other terms are PSD, so y_i = 1 stays feasible and
    the constraint only tightens)."""
    from scipsdp_tpu_torch.ops.onevar import solve_one_var_sdp

    eps = 1e-12
    new_blocks = []
    changed = False
    for blk in prob.blocks:
        A = blk.dense_coeff(prob.nvars)
        C = blk.dense_const()
        vars_in = np.where(np.abs(A).reshape(prob.nvars, -1).sum(1) > eps)[0]
        if len(vars_in) == 0 or np.any(prob.lb[vars_in] < -eps):
            new_blocks.append(blk)
            continue
        if not all(np.linalg.eigvalsh(A[v])[0] >= -1e-9 for v in vars_in):
            new_blocks.append(blk)
            continue
        scale = np.ones(prob.nvars)
        for v in vars_in:
            if not (prob.integral[v] and prob.lb[v] == 0.0
                    and prob.ub[v] == 1.0):
                continue
            st, factor = solve_one_var_sdp(A[v], C, 1.0, 0.0, 1.0,
                                           feastol=feastol)
            # the bisection accepts lambda_min >= -feastol; nudge the factor
            # up so the tightened matrix stays PSD-feasible at y = factor
            if st == "optimal" and factor + feastol < 1.0 - feastol:
                scale[v] = min(1.0, max(factor + feastol, 0.0))
        if np.any(scale < 1.0):
            changed = True
            new_blocks.append(dataclasses.replace(
                blk, val=blk.val * scale[blk.var]))
        else:
            new_blocks.append(blk)
    if not changed:
        return prob
    return dataclasses.replace(prob, blocks=new_blocks)


def fix_and_aggregate(prob: MISDP, aggregate: bool = False,
                      feastol: float = 1e-9) -> MISDP:
    """Eliminate fixed variables and (optionally) doubleton-equality
    aggregations from the problem (fixAndAggrVars cons_sdp.c:4498,
    multiaggrVar cons_sdp.c:4317, SdpVarfixer.c triple-merge role).

    * fixed y_i = f: merge f*A_i into the constant matrices, f*d_i into
      row sides, f*obj_i into the objective offset;
    * doubleton equality a y_i + b y_j = c with y_i continuous:
      substitute y_i = alpha y_j + beta (alpha = -b/a, beta = c/a)
      everywhere and transfer y_i's bounds onto y_j.

    Records a postsolve map on the returned MISDP so solutions of the
    reduced problem can be lifted back to the original space.  Problems
    with indicators/quadratics/lifts are returned unchanged (their
    index-based side structures would need rewriting).
    """
    if prob.indicators or prob.quadcons or prob.liftinfo or prob.proprows:
        return prob
    m = prob.nvars
    lb = prob.lb.copy()
    ub = prob.ub.copy()
    obj = prob.obj.copy()
    offset = 0.0
    # dense working copies (problem-level presolve; one-off cost)
    D = prob.lp.dense(m)
    lhs = prob.lp.lhs.copy()
    rhs = prob.lp.rhs.copy()
    A = [blk.dense_coeff(m) for blk in prob.blocks]
    C = [blk.dense_const() for blk in prob.blocks]
    alive_rows = np.ones(prob.lp.nrows, dtype=bool)
    alive = np.ones(m, dtype=bool)
    ops = []
    extra_rows = []   # bound rows of multi-aggregated variables (in
    #                   ORIGINAL indices; remapped at rebuild)

    def eliminate_multi(i, terms, beta):
        """y_i := sum_k alpha_k * y_{j_k} + beta  (terms = [(alpha, j)];
        empty terms = a fixing).  The general multi-aggregation
        substitution (multiaggrVar, cons_sdp.c:4317-4498)."""
        nonlocal offset
        for k in range(len(A)):
            Ai = A[k][i].copy()
            for alpha, j in terms:
                A[k][j] += alpha * Ai
            C[k] -= beta * Ai
            A[k][i] = 0.0
        di = D[:, i].copy()
        for alpha, j in terms:
            D[:, j] += alpha * di
        fin = lhs > -INF / 2
        lhs[fin] -= beta * di[fin]
        fin = rhs < INF / 2
        rhs[fin] -= beta * di[fin]
        D[:, i] = 0.0
        for alpha, j in terms:
            obj[j] += alpha * obj[i]
        offset += beta * obj[i]
        obj[i] = 0.0
        alive[i] = False
        ops.append((i, list(terms), beta))

    def eliminate(i, alpha, j, beta):
        """y_i := alpha * y_j + beta  (alpha = 0, j = -1 for a fixing)."""
        eliminate_multi(i, ([] if alpha == 0.0 else [(alpha, j)]), beta)

    changed = True
    while changed:
        changed = False
        # fixed variables
        for i in np.where(alive & (ub - lb <= feastol)
                          & (lb > -INF / 2))[0]:
            eliminate(int(i), 0.0, -1, 0.5 * (lb[i] + ub[i]))
            changed = True
        if not aggregate:
            break
        # doubleton equalities over two live variables
        for r in np.where(alive_rows)[0]:
            if not (lhs[r] > -INF / 2 and rhs[r] < INF / 2
                    and abs(lhs[r] - rhs[r]) <= feastol):
                continue
            nz = np.where(alive & (np.abs(D[r]) > 1e-12))[0]
            if len(nz) != 2:
                continue
            # eliminate a continuous variable (keeps integrality intact)
            cand = [v for v in nz if not prob.integral[v]]
            if not cand:
                continue
            i = int(cand[0])
            j = int(nz[0] if nz[1] == i else nz[1])
            a, b = D[r, i], D[r, j]
            alpha, beta = -b / a, rhs[r] / a
            # transfer y_i's bounds onto y_j: alpha y_j + beta in [l_i,u_i]
            if alpha > 0:
                if lb[i] > -INF / 2:
                    lb[j] = max(lb[j], (lb[i] - beta) / alpha)
                if ub[i] < INF / 2:
                    ub[j] = min(ub[j], (ub[i] - beta) / alpha)
            elif alpha < 0:
                if lb[i] > -INF / 2:
                    ub[j] = min(ub[j], (lb[i] - beta) / alpha)
                if ub[i] < INF / 2:
                    lb[j] = max(lb[j], (ub[i] - beta) / alpha)
            else:  # b == 0: row fixes y_i
                if not (lb[i] - feastol <= beta <= ub[i] + feastol):
                    continue   # conflict surfaces at solve time
            eliminate(i, alpha, j, beta)
            alive_rows[r] = False
            changed = True
        if changed:
            continue
        # general multi-aggregation (multiaggrVar, cons_sdp.c:4317-4498):
        # an equality row with a well-scaled continuous variable
        # substitutes  y_i = (c - sum_k b_k y_k) / a  everywhere; the
        # eliminated variable's finite bounds survive as a ranged row
        # over the aggregation variables
        for r in np.where(alive_rows)[0]:
            if not (lhs[r] > -INF / 2 and rhs[r] < INF / 2
                    and abs(lhs[r] - rhs[r]) <= feastol):
                continue
            nz = np.where(alive & (np.abs(D[r]) > 1e-12))[0]
            if len(nz) < 3 or len(nz) > 8:
                continue
            rmax = np.abs(D[r, nz]).max()
            cand = [v for v in nz if not prob.integral[v]
                    and abs(D[r, v]) >= 1e-7 * rmax]
            if not cand:
                continue
            i = int(cand[0])
            a = D[r, i]
            terms = [(-D[r, j] / a, int(j)) for j in nz if j != i]
            beta = rhs[r] / a
            # bounds of y_i become a ranged row over the aggregation vars
            if lb[i] > -INF / 2 or ub[i] < INF / 2:
                lo = lb[i] - beta if lb[i] > -INF / 2 else -INF
                hi = ub[i] - beta if ub[i] < INF / 2 else INF
                extra_rows.append(([j for _, j in terms],
                                   [al for al, _ in terms],
                                   float(lo), float(hi)))
            eliminate_multi(i, terms, beta)
            alive_rows[r] = False
            changed = True
            break   # rescan (D changed under us)

    if ops and not alive.any():
        # keep one variable so the reduced problem stays well-formed; its
        # contributions are already folded into the constant data, so it
        # survives as a zero-coefficient variable pinned to its value
        i, _terms, beta = ops.pop()
        alive[i] = True
        lb[i] = ub[i] = beta   # it was a fixing (aggregations keep j alive)
    if not ops:
        return prob
    keep = np.where(alive)[0]
    colmap = -np.ones(m, dtype=np.int64)
    colmap[keep] = np.arange(len(keep))

    blocks = []
    for k, blk in enumerate(prob.blocks):
        Ak = A[k][keep]
        nzv, nzr, nzc = np.nonzero(np.abs(Ak) > 1e-14)
        tri = nzr >= nzc
        cr, cc = np.nonzero(np.abs(C[k]) > 1e-14)
        ctri = cr >= cc
        blocks.append(SDPBlock(
            size=blk.size,
            var=nzv[tri].astype(np.int32), row=nzr[tri].astype(np.int32),
            col=nzc[tri].astype(np.int32), val=Ak[nzv, nzr, nzc][tri],
            const_row=cr[ctri].astype(np.int32),
            const_col=cc[ctri].astype(np.int32),
            const_val=C[k][cr, cc][ctri],
            rank1=blk.rank1))
    rows = []
    for r in np.where(alive_rows)[0]:
        nz = np.where(np.abs(D[r, keep]) > 1e-14)[0]
        if len(nz) == 0:
            continue
        rows.append((list(nz), list(D[r, keep][nz]),
                     float(lhs[r]), float(rhs[r])))
    for inds, vals, lo, hi in extra_rows:
        # remap to reduced indices; entries on since-eliminated vars were
        # substituted into D only for live rows, so rebuild the row in
        # the ORIGINAL space and project: all aggregation vars that were
        # themselves eliminated later need their substitutions applied
        g = np.zeros(m)
        for v, al in zip(inds, vals):
            g[v] += al
        const = 0.0
        # replay subsequent eliminations on this row
        for (ei, eterms, ebeta) in ops:
            if g[ei] != 0.0:
                coef = g[ei]
                for al2, j2 in eterms:
                    g[j2] += coef * al2
                const += coef * ebeta
                g[ei] = 0.0
        nz = np.where(np.abs(g[keep]) > 1e-14)[0]
        if len(nz) == 0:
            continue
        lo2 = lo - const if lo > -INF / 2 else -INF
        hi2 = hi - const if hi < INF / 2 else INF
        rows.append((list(nz), list(g[keep][nz]), float(lo2), float(hi2)))
    return dataclasses.replace(
        prob,
        nvars=len(keep),
        obj=obj[keep],
        lb=lb[keep],
        ub=ub[keep],
        integral=prob.integral[keep],
        blocks=blocks,
        lp=LinearConstraints.from_rows(rows),
        objoffset=prob.objoffset + prob.objsense * offset,
        varnames=([prob.varnames[int(i)] for i in keep]
                  if prob.varnames is not None else None),
        postsolve=(m, keep, ops),
    )


def postsolve_solution(prob: MISDP, y: np.ndarray) -> np.ndarray:
    """Map a reduced-space solution back to the original variable space."""
    if prob.postsolve is None:
        return y
    m_orig, keep, ops = prob.postsolve
    out = np.zeros(m_orig)
    out[keep] = y[: len(keep)]
    for (i, terms, beta) in reversed(ops):
        out[i] = sum(alpha * out[j] for alpha, j in terms) + beta
    return out


def presolve_problem(prob: MISDP, settings) -> MISDP:
    """Apply the enabled problem-level transformations."""
    pres = settings.presolve
    if pres.fixvars or pres.aggregate:
        prob = fix_and_aggregate(prob, aggregate=pres.aggregate,
                                 feastol=settings.bb.feastol * 1e-3)
    if pres.twominorsocconss:
        extra_qc = two_minor_soc_quadcons(prob)
        if extra_qc:
            prob = dataclasses.replace(
                prob, quadcons=list(prob.quadcons) + extra_qc)
    if prob.quadcons:
        # quadratic constraints -> rank-1 SDP lifting (consQuadConsUpgdSdp
        # role; always on here — see core/quadupgrade.py design note)
        from scipsdp_tpu_torch.core.quadupgrade import upgrade_quadconss
        prob = upgrade_quadconss(prob)
    if pres.move_1x1_blocks:
        prob = move_1x1_blocks(prob)
    if pres.tightenmatrices:
        prob = tighten_matrices(prob, settings.bb.feastol)
    extra = []
    if pres.diaggezerocuts:
        extra += diag_ge_zero_rows(prob)
    if pres.twominorlinconss:
        extra += two_minor_lin_rows(prob)
    if (getattr(settings, "use_symmetry", False)
            and getattr(settings, "symmetry_mode", "lexrows") == "lexrows"):
        # "orbital" mode keeps the formulation symmetric: orbital fixing in
        # the B&B (core/symmetry.orbital_fixing) owns those orbits instead
        from scipsdp_tpu_torch.core.symmetry import symmetry_breaking_rows
        extra += symmetry_breaking_rows(prob)
    # presollinconssparam = 0 rows: propagate only (SDP mode) / relax (LP)
    prop_extra = []
    if pres.diagzeroimplcuts:
        prop_extra += diag_zero_impl_rows(prob)
    if pres.twominorprodconss:
        prop_extra += two_minor_prod_rows(prob)
    if pres.twominorvarbounds:
        prop_extra += two_minor_varbound_rows(prob)
    if pres.presollinconssparam == 1 or settings.solve_sdps == 0:
        extra += prop_extra
        prop_extra = []
    if extra:
        prob = dataclasses.replace(prob, lp=_append_rows(prob.lp, extra))
    if prop_extra:
        base = (prob.proprows if prob.proprows is not None
                else LinearConstraints.empty())
        prob = dataclasses.replace(prob,
                                   proprows=_append_rows(base, prop_extra))
    return prob
