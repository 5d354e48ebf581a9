"""Probing-based heuristics and propagators (PyTorch).

Counterpart of ``scipsdp_tpu/core/probing.py``: batched analogs of the
reference's probing plugins (everything that re-solves relaxations under
temporary bound changes):

* ``fracdive``        — heur_sdpfracdiving.c: iteratively round-fix the
                        most fractional variable and re-solve; one
                        *batched* dive advances every node of a batch one
                        probing level per solve;
* ``obbt_root``       — prop_sdpobbt.c: optimization-based bound
                        tightening by min/max-imizing single variables over
                        the relaxation (with an objective-cutoff row);
* ``slater_check``    — sdpi.c checkSlaterCondition:1518 (dual side): the
                        relaxation has a strictly feasible point iff
                        min r s.t. Z(y) + r I >= 0, G y + r >= h  (r free)
                        has a negative optimum;
* ``slater_check_primal`` — the primal side (sdpi.c:1483-1515);
* ``inner_lp_point``  — heur_sdpinnerlp.c: a diagonally dominant inner
                        approximation LP;
* ``analytic_center`` — SCIPrelaxSdpComputeAnalyticCenters
                        (relax_sdp.c:5589): a central feasible point from a
                        zero-objective solve (warmstartiptype=2);
* ``rounding_problem``— solvePrimalRoundingProblem (relax_sdp.c:1551-2400,
                        warmstartproject = 4): restrict the primal/dual SDPs
                        to the parent solution's eigenbases and solve the
                        resulting LPs.

Host numpy around ``SDPInterface.solve_batch``.  Every interface built
here runs on the device of the caller's interface, or on the ``device``
the caller passes (``None`` = the card, as everywhere in the port).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from scipsdp_tpu_torch.core.feascheck import check_points
from scipsdp_tpu_torch.core.sdpi import SDPInterface, to_host
from scipsdp_tpu_torch.models.problem import (INF, LinearConstraints, MISDP,
                                              densify)
from scipsdp_tpu_torch.utils.config import Settings
from scipsdp_tpu_torch.utils.status import SolverResultStatus

_OPT_CODES = (int(SolverResultStatus.OPTIMAL),
              int(SolverResultStatus.PRESOLVED_OPTIMAL))
_INFEAS_CODES = (int(SolverResultStatus.INFEASIBLE),
                 int(SolverResultStatus.PRESOLVED_INFEASIBLE))


def fracdive(iface: SDPInterface, lb: np.ndarray, ub: np.ndarray,
             y: np.ndarray, integral: np.ndarray, feastol: float,
             max_depth: int = 8, start_ok=None):
    """One batched dive: returns (best_y (B, m) or NaN rows, feas (B,)).

    Per level: fix the most fractional integer variable of every instance
    to its rounded value, re-solve the whole batch, stop when integral or
    infeasible (heur_sdpfracdiving.c:354-390 depth control simplified).
    ``start_ok`` masks instances whose starting point is a valid
    relaxation solution; every reported point is re-verified with the
    independent feasibility check before being declared feasible.
    """
    B, m = y.shape
    lb = lb.copy()
    ub = ub.copy()
    active = (np.ones(B, dtype=bool) if start_ok is None
              else np.asarray(start_ok, dtype=bool).copy())
    out_y = np.full((B, m), np.nan)
    out_feas = np.zeros(B, dtype=bool)
    cur_y = y.copy()

    for _ in range(max_depth):
        frac = np.abs(cur_y[:, integral] - np.round(cur_y[:, integral]))
        if frac.size == 0:
            break
        worst = np.max(frac, axis=1)
        done_int = worst <= feastol
        newly = active & done_int
        out_y[newly] = cur_y[newly]
        out_feas[newly] = True
        active = active & ~done_int
        if not active.any():
            break
        # fix the most fractional integer var per active instance
        ints = np.where(integral)[0]
        pick = ints[np.argmax(frac, axis=1)]
        vals = np.round(cur_y[np.arange(B), pick])
        for i in np.where(active)[0]:
            j = pick[i]
            v = min(max(vals[i], lb[i, j]), ub[i, j])
            lb[i, j] = v
            ub[i, j] = v
        res = iface.solve_batch(lb, ub)
        ok = np.isin(res.status, _OPT_CODES)
        active = active & ok
        cur_y = np.where(ok[:, None], res.y, cur_y)
    # independent verification of every claimed-feasible point (role of
    # the reference's sdpsolchecker: never trust a heuristic path)
    if out_feas.any():
        ys = np.where(out_feas[:, None], out_y, 0.0)
        okv, _ = check_points(iface.data, ys, lb, ub, feastol=feastol)
        out_feas = out_feas & okv.cpu().numpy()
    return out_y, out_feas


def obbt_root(iface: SDPInterface, lb: np.ndarray, ub: np.ndarray,
              targets: np.ndarray, cutoff: Optional[float],
              batch_size: int, feastol: float
              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Min/max each target variable over the relaxation (plus an objective
    cutoff row when an incumbent exists); returns tightened (lb, ub) and
    the number of tightenings (prop_sdpobbt.c:197-444)."""
    m = lb.shape[0]
    lb = lb.copy()
    ub = ub.copy()
    jobs = [(j, s) for j in targets for s in (+1.0, -1.0)]
    ntight = 0
    cuts = None
    if cutoff is not None and np.isfinite(cutoff):
        obj0 = np.asarray(iface.dense.obj)[:m]
        g = -obj0[None, None, :].repeat(batch_size, 0)
        h = np.full((batch_size, 1), -cutoff)
        v = np.ones((batch_size, 1), dtype=bool)
        cuts = (g, h, v)
    for start in range(0, len(jobs), batch_size):
        chunk = jobs[start:start + batch_size]
        objs = np.zeros((batch_size, m))
        for i, (j, s) in enumerate(chunk):
            objs[i, j] = s
        res = iface.solve_batch(np.tile(lb, (batch_size, 1)),
                                np.tile(ub, (batch_size, 1)),
                                obj=objs, cuts=cuts)
        for i, (j, s) in enumerate(chunk):
            if res.status[i] != int(SolverResultStatus.OPTIMAL):
                continue
            if s > 0 and res.objval[i] > lb[j] + feastol:
                lb[j] = res.objval[i]
                ntight += 1
            elif s < 0 and -res.objval[i] < ub[j] - feastol:
                ub[j] = -res.objval[i]
                ntight += 1
    return lb, ub, ntight


def slater_check(iface: SDPInterface, lb: np.ndarray, ub: np.ndarray
                 ) -> np.ndarray:
    """Dual Slater condition per instance: 1 = holds, 0 = fails (boundary
    or infeasible), -1 = undecided (sdpi.c:1518)."""
    B = lb.shape[0]
    m = iface.m
    # feasibility probe with free r: one batched solve of min r with r in
    # [-BIG, +inf) (bounds shifted by the interface's extension)
    lbx = iface._extend(lb, -1e6)
    ubx = iface._extend(ub, INF)
    bm = np.zeros((B, m + 1))
    bm[:, m] = 1.0
    out = to_host(iface._run(bm, lbx, ubx))[0]   # host read: the probe
    status = np.full(B, -1, dtype=np.int8)
    conv = out.status == int(SolverResultStatus.OPTIMAL)
    r = out.r
    status[conv & (r < -iface.settings.ipm.feastol)] = 1
    status[conv & (r >= -iface.settings.ipm.feastol)] = 0
    return status


def slater_check_primal(prob: MISDP, settings: Settings, lb: np.ndarray,
                        ub: np.ndarray, device=None) -> int:
    """Primal Slater condition (sdpi.c:1483-1515): maximize r subject to
    A_i * (X + r I) = c_i, X >= 0, r >= 0 — reformulated as the modified
    dual

        min b^T x   s.t.  sum_i A_i x_i >= 0  (A_0 dropped),
                          all finite LP lhs/rhs and var bounds zeroed,
                          sum_i (sum_j (A_i)_jj) x_i >= 1.

    Returns 1 = holds (objective < -feastol or problem unbounded /
    infeasible-dual), 0 = fails, -1 = undecided (sdpi.c:1760-1845).
    The auxiliary problem is solved on ``device`` (``None`` = the card)."""
    m = prob.nvars
    blocks = []
    diagsum = np.zeros(m)
    for blk in prob.blocks:
        A = blk.dense_coeff(m)
        diagsum += A[:, range(blk.size), range(blk.size)].sum(axis=1)
        blocks.append(dataclasses.replace(
            blk, const_row=np.zeros(0, np.int32),
            const_col=np.zeros(0, np.int32), const_val=np.zeros(0)))
    rows = []
    for i in range(prob.lp.nrows):
        sl = slice(prob.lp.beg[i], prob.lp.beg[i + 1])
        lo = 0.0 if prob.lp.lhs[i] > -INF / 2 else -INF
        hi = 0.0 if prob.lp.rhs[i] < INF / 2 else INF
        rows.append((list(prob.lp.ind[sl]), list(prob.lp.val[sl]), lo, hi))
    nz = np.nonzero(np.abs(diagsum) > 1e-12)[0]
    if len(nz) == 0:
        return -1
    rows.append((list(nz), list(diagsum[nz]), 1.0, INF))
    lbz = np.where(lb > -INF / 2, 0.0, -INF)
    ubz = np.where(ub < INF / 2, 0.0, INF)
    aux = MISDP(nvars=m, obj=prob.obj, lb=lbz, ub=ubz,
                integral=np.zeros(m, bool), blocks=blocks,
                lp=LinearConstraints.from_rows(rows),
                name=prob.name + "_slaterprimal")
    iface = SDPInterface(densify(aux), Settings(ipm=settings.ipm),
                         device=device)
    res = iface.solve_batch(aux.lb[None], aux.ub[None])
    st = int(res.status[0])
    feastol = settings.ipm.feastol
    if st == int(SolverResultStatus.UNBOUNDED):
        return 1
    if st in _INFEAS_CODES:
        return 1   # modified dual infeasible => sup r unbounded => holds
    if st in _OPT_CODES:
        return 1 if res.objval[0] <= -feastol else 0
    return -1


def inner_lp_point(prob: MISDP, settings: Settings,
                   y_ref: Optional[np.ndarray] = None, device=None):
    """Inner-approximation LP heuristic (heur_sdpinnerlp.c, Ahmadi-Dash-
    Hall): restrict each SDP block to *diagonally dominant* matrices —
    Z_ii >= sum_{j != i} |Z_ij| with auxiliary variables t_ij >= +-Z_ij —
    a linear RESTRICTION whose feasible points are SDP-feasible.  Integer
    variables are fixed to the rounding of ``y_ref`` (or their bounds'
    midpoint rounding) before solving, so a feasible LP point is a feasible
    MISDP point.  The block-free LP goes through the batched IPM on
    ``device`` (``None`` = the card).  Returns (y (m,), feasible: bool)."""
    m = prob.nvars
    lb = prob.lb.copy()
    ub = prob.ub.copy()
    ints = np.where(prob.integral)[0]
    if y_ref is None:
        y_ref = np.clip(0.0, lb, ub)
    for j in ints:
        v = np.round(np.clip(y_ref[j], lb[j], ub[j]))
        lb[j] = ub[j] = v

    # auxiliary |Z_ij| variables and dd rows
    extra_rows = []
    naux = 0
    for blk in prob.blocks:
        A = blk.dense_coeff(m)
        C = blk.dense_const()
        nk = blk.size
        tidx = {}
        for i in range(nk):
            for jj in range(i):
                tidx[(i, jj)] = m + naux
                naux += 1
                gi = list(np.nonzero(A[:, i, jj])[0])
                gv = list(A[gi, i, jj]) if gi else []
                # t >= Z_ij:  t - sum A_ij y >= -C_ij  (Z = sum A y - C)
                extra_rows.append((gi + [tidx[(i, jj)]],
                                   [-v for v in gv] + [1.0],
                                   -float(C[i, jj]), INF))
                # t >= -Z_ij: t + sum A_ij y >= C_ij
                extra_rows.append((gi + [tidx[(i, jj)]],
                                   list(gv) + [1.0],
                                   float(C[i, jj]), INF))
        for i in range(nk):
            gi = list(np.nonzero(A[:, i, i])[0])
            gv = list(A[gi, i, i]) if gi else []
            ts = [tidx[(max(i, jj), min(i, jj))] for jj in range(nk)
                  if jj != i]
            # Z_ii - sum_j t_ij >= 0:  sum A_ii y - sum t >= C_ii
            extra_rows.append((gi + ts, list(gv) + [-1.0] * len(ts),
                               float(C[i, i]), INF))

    old_rows = [
        (list(prob.lp.ind[prob.lp.beg[i]:prob.lp.beg[i + 1]]),
         list(prob.lp.val[prob.lp.beg[i]:prob.lp.beg[i + 1]]),
         prob.lp.lhs[i], prob.lp.rhs[i])
        for i in range(prob.lp.nrows)
    ]
    lp = LinearConstraints.from_rows(old_rows + extra_rows)
    aux = MISDP(
        nvars=m + naux,
        obj=np.concatenate([prob.obj, np.zeros(naux)]),
        lb=np.concatenate([lb, np.zeros(naux)]),
        ub=np.concatenate([ub, np.full(naux, INF)]),
        integral=np.zeros(m + naux, dtype=bool),
        blocks=[],
        lp=lp,
        name=prob.name + "_innerlp",
    )
    iface = SDPInterface(densify(aux), settings, device=device)
    res = iface.solve_batch(aux.lb[None, :], aux.ub[None, :])
    if res.status[0] not in _OPT_CODES:
        return None, False
    return res.y[0][:m], True


def _lp_as_misdp(nvars, obj, lb, ub, rows, name):
    """Build a block-free MISDP (a pure LP) for the shared batched IPM."""
    return MISDP(nvars=nvars, obj=np.asarray(obj, float),
                 lb=np.asarray(lb, float), ub=np.asarray(ub, float),
                 integral=np.zeros(nvars, bool), blocks=[],
                 lp=LinearConstraints.from_rows(rows), name=name)


def rounding_problem(prob: MISDP, dense, settings: Settings, parent_X,
                     parent_y, lb: np.ndarray, ub: np.ndarray,
                     cutoff: float = INF, feastol: float = 1e-6,
                     device=None):
    """Primal/dual rounding problems of warmstartproject = 4
    (solvePrimalRoundingProblem, relax_sdp.c:1551-2400).

    ``parent_X``: list of per-block primal matrices of the parent node;
    ``parent_y``: parent dual solution (defines Z(y) eigenbases).  The
    *primal rounding LP* optimizes over primal matrices restricted to
    X = V diag(lambda) V^T (V from the parent X eigendecomposition),
    lambda >= 0; by inclusion its optimum bounds the primal SDP from
    below, so

      * an unbounded primal rounding LP proves the node's dual (our
        relaxation) infeasible  -> "cutoff" (roundingprobinf stat);
      * optimum >= cutoff bound -> "cutoff" by weak duality.

    Otherwise the *dual rounding LP* (y with Z(y) restricted to the
    parent Z eigenbasis, eigenvalue coefficients >= 0) is solved; its
    optimal y is the warmstart point.  Both LPs go through the batched
    IPM on ``device`` (``None`` = the card).  Returns (action, warm_y)
    with action in {"cutoff", "failed", "ok"}.
    """
    m = prob.nvars
    blocks = prob.blocks
    G = dense.G
    h = dense.h
    p = G.shape[0]
    b = prob.obj

    # eigenbases of the parent primal matrices
    VX = []
    for k, blk in enumerate(blocks):
        Xk = np.asarray(parent_X[k])[: blk.size, : blk.size]
        _, V = np.linalg.eigh(0.5 * (Xk + Xk.T))
        VX.append(V)

    # ---- primal rounding LP -----------------------------------------------
    # variables: lam (sum n_k) >= 0; xl (p) >= 0; w (lb mult) >= 0;
    # v (ub mult) >= 0.  equality per original variable i:
    #   sum_e lam_e v_e^T A_i v_e + sum_r G_ri xl_r + w_i - v_i = b_i
    # objective (max -> min of negative):
    #   sum_e lam_e v_e^T A_0 v_e + h.xl + lb.w - ub.v
    fin_lb = lb > -INF / 2
    fin_ub = ub < INF / 2
    nlam = sum(blk.size for blk in blocks)
    nv = nlam + p + int(fin_lb.sum()) + int(fin_ub.sum())
    coef = np.zeros((m, nv))
    objp = np.zeros(nv)
    pos = 0
    for k, blk in enumerate(blocks):
        A = blk.dense_coeff(m)
        C = blk.dense_const()
        V = VX[k]
        coef[:, pos:pos + blk.size] = np.einsum("ae,jab,be->je", V, A, V)
        objp[pos:pos + blk.size] = np.einsum("ae,ab,be->e", V, C, V)
        pos += blk.size
    if p:
        coef[:, pos:pos + p] = G[:, :m].T
        objp[pos:pos + p] = h
        pos += p
    for i in np.where(fin_lb)[0]:
        coef[i, pos] = 1.0
        objp[pos] = lb[i]
        pos += 1
    for i in np.where(fin_ub)[0]:
        coef[i, pos] = -1.0
        objp[pos] = -ub[i]
        pos += 1
    rows = []
    for i in range(m):
        nz = np.nonzero(np.abs(coef[i]) > 1e-14)[0]
        rows.append((list(nz), list(coef[i, nz]), float(b[i]), float(b[i])))
    plp = _lp_as_misdp(nv, -objp, np.zeros(nv), np.full(nv, INF), rows,
                       prob.name + "_primalround")
    iface = SDPInterface(densify(plp), Settings(ipm=settings.ipm),
                         device=device)
    res = iface.solve_batch(plp.lb[None], plp.ub[None])
    st = int(res.status[0])
    if st == int(SolverResultStatus.UNBOUNDED):
        return "cutoff", None
    if st not in _OPT_CODES:
        # restricted primal infeasible (or unsolved): no information about
        # the original
        return "failed", None
    if -float(res.objval[0]) >= cutoff - 1e-9:
        return "cutoff", None

    # ---- dual rounding LP --------------------------------------------------
    # variables: y (m) and mu (sum n_k) >= 0 with, per block k and lower-
    # triangular entry (a, c):
    #   sum_i (A_i)_ac y_i - sum_e mu_e (u_e u_e^T)_ac = (A_0)_ac
    # where u_e are the eigenvectors of the parent's Z(y).
    nmu = nlam
    rows = []
    pos = m
    for k, blk in enumerate(blocks):
        A = blk.dense_coeff(m)
        C = blk.dense_const()
        Zk = np.einsum("j,jab->ab", parent_y[:m], A) - C
        _, U = np.linalg.eigh(0.5 * (Zk + Zk.T))
        outer = np.einsum("ae,ce->eac", U, U)      # (n, n, n): u_e u_e^T
        for a in range(blk.size):
            for c in range(a + 1):
                gi = list(np.nonzero(np.abs(A[:, a, c]) > 1e-14)[0])
                gv = list(A[gi, a, c]) if gi else []
                mi = list(range(pos, pos + blk.size))
                mv = list(-outer[:, a, c])
                rhs = float(C[a, c])
                rows.append((gi + mi, gv + mv, rhs, rhs))
        pos += blk.size
    # original LP rows on y
    for r in range(p):
        nz = np.nonzero(np.abs(G[r, :m]) > 1e-14)[0]
        rows.append((list(nz), list(G[r, nz]), float(h[r]), INF))
    dlb = np.concatenate([lb, np.zeros(nmu)])
    dub = np.concatenate([ub, np.full(nmu, INF)])
    dobj = np.concatenate([b, np.zeros(nmu)])
    dlp = _lp_as_misdp(m + nmu, dobj, dlb, dub, rows,
                       prob.name + "_dualround")
    iface2 = SDPInterface(densify(dlp), Settings(ipm=settings.ipm),
                          device=device)
    res2 = iface2.solve_batch(dlp.lb[None], dlp.ub[None])
    if int(res2.status[0]) not in _OPT_CODES:
        # Z restricted to the parent eigenbasis is a *restriction* of the
        # dual: infeasibility here does not prove node infeasibility
        return "failed", None
    return "ok", res2.y[0][:m]


def analytic_center(iface: SDPInterface, lb: np.ndarray, ub: np.ndarray,
                    with_X: bool = False):
    """Central point of the relaxation's feasible set from a zero-objective
    solve (the IPM converges to the analytic center of the optimal face,
    which for b = 0 is the whole feasible set).

    With ``with_X`` also returns the primal center matrices in bucket
    layout (the pair SCIPrelaxSdpComputeAnalyticCenters stores for
    warmstartiptype=2, relax_sdp.c:5589), the form
    ``SDPInterface.set_interior_point`` takes."""
    B = lb.shape[0]
    res = iface.solve_batch(lb, ub, obj=np.zeros((B, iface.m)))
    ok = res.status == int(SolverResultStatus.OPTIMAL)
    if with_X:
        return res.y, ok, [np.asarray(x[0]) for x in res.X]
    return res.y, ok
