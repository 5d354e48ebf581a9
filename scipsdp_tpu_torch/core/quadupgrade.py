"""Quadratic-constraint -> rank-1-SDP upgrade.

Analog of the reference's nonlinear-constraint upgrade callback
(consQuadConsUpgdSdp, cons_sdp.c:5636-6106): collect every variable that
appears in a quadratic constraint, introduce one scalar variable per
lower-triangular entry of their outer-product matrix, and add the lifted
rank-1 SDP constraint

    [ 1    x^T ]
    [ x    X   ]  >= 0  (PSD),  rank 1        (so X = x x^T exactly)

with each quadratic constraint rewritten as a *linear* row over (x, X).

Design note: the reference keeps this upgrade off by default
(DEFAULT_UPGRADEQUADCONSS, cons_sdp.c:129) because SCIP's nonlinear
handler can enforce quadratic constraints directly; this framework has no
general nonlinear enforcement, so problems carrying quadratic constraints
are always upgraded in presolve.  The lift identity X = x x^T is enforced
by *McCormick envelopes + spatial branching* (global envelope rows added
here; per-child refreshed envelopes in the B&B loop via ``mccormick_rows``
— the convergent spatial-B&B scheme for bilinear terms), with the PSD
block providing the SDP strengthening.

numpy only: a copy of the JAX package's ``core/quadupgrade.py``, kept beside it
rather than imported so this package never imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from scipsdp_tpu_torch.models.problem import INF, LinearConstraints, MISDP, SDPBlock


def _prod_interval(li, ui, lj, uj):
    """Interval of y_i * y_j over the box (inf-safe)."""
    cands = []
    for a in (li, ui):
        for b in (lj, uj):
            if abs(a) >= INF / 2 or abs(b) >= INF / 2:
                # sign-resolve infinite corners conservatively
                if a == 0.0 or b == 0.0:
                    cands.append(0.0)
                else:
                    cands.append(np.sign(a) * np.sign(b) * INF)
            else:
                cands.append(a * b)
    return max(min(cands), -INF), min(max(cands), INF)


def mccormick_rows(nvars: int, lifts, lb: np.ndarray, ub: np.ndarray):
    """McCormick envelope rows for lift triples (w, i, j) under the box.

    Returns rows as (g (nvars,), rhs) in >=-form  g @ y >= rhs.  For a
    bilinear term w = y_i y_j over [l_i,u_i] x [l_j,u_j]:

        w >= l_j y_i + l_i y_j - l_i l_j
        w >= u_j y_i + u_i y_j - u_i u_j
        w <= u_j y_i + l_i y_j - u_j l_i
        w <= l_j y_i + u_i y_j - l_j u_i

    and for squares (i == j) the two tangents + secant.  Rows with an
    infinite ingredient are skipped.
    """
    out = []

    def fin(x):
        return abs(x) < INF / 2

    def row(cw, ci, vi, cj, vj, rhs):
        g = np.zeros(nvars)
        g[cw[0]] += cw[1]
        g[vi] += ci
        g[vj] += cj
        out.append((g, rhs))

    for (w, i, j) in lifts:
        li, ui = lb[i], ub[i]
        lj, uj = lb[j], ub[j]
        if i == j:
            if fin(li):
                row((w, 1.0), -2.0 * li, i, 0.0, j, -li * li)
            if fin(ui):
                row((w, 1.0), -2.0 * ui, i, 0.0, j, -ui * ui)
            if fin(li) and fin(ui):
                row((w, -1.0), li + ui, i, 0.0, j, li * ui)
        else:
            if fin(li) and fin(lj):
                row((w, 1.0), -lj, i, -li, j, -li * lj)
            if fin(ui) and fin(uj):
                row((w, 1.0), -uj, i, -ui, j, -ui * uj)
            if fin(li) and fin(uj):
                row((w, -1.0), uj, i, li, j, uj * li)
            if fin(ui) and fin(lj):
                row((w, -1.0), lj, i, ui, j, lj * ui)
    return out


def upgrade_quadconss(prob: MISDP) -> MISDP:
    """Return an equivalent MISDP without quadratic constraints."""
    if not prob.quadcons:
        return prob

    qvars = sorted({int(v) for qc in prob.quadcons
                    for v in np.concatenate([qc.qrow, qc.qcol])})
    nq = len(qvars)
    pos = {v: i for i, v in enumerate(qvars)}
    m = prob.nvars

    # new scalar variables: X_ij for lower-triangular (i >= j) over qvars
    lift = {}
    new_lb: List[float] = []
    new_ub: List[float] = []
    for i in range(nq):
        for j in range(i + 1):
            lift[(i, j)] = m + len(new_lb)
            lo, hi = _prod_interval(prob.lb[qvars[i]], prob.ub[qvars[i]],
                                    prob.lb[qvars[j]], prob.ub[qvars[j]])
            if i == j:
                lo = max(lo, 0.0)          # X_ii = y_i^2 >= 0
            new_lb.append(lo)
            new_ub.append(hi)
    nnew = len(new_lb)

    # lifted rank-1 block of size nq + 1:
    #   entry (0,0) = 1 (constant), (i+1,0) = y_{qvars[i]}, (i+1,j+1) = X_ij
    var_l, row_l, col_l, val_l = [], [], [], []
    for i, v in enumerate(qvars):
        var_l.append(v)
        row_l.append(i + 1)
        col_l.append(0)
        val_l.append(1.0)
    for (i, j), xv in lift.items():
        var_l.append(xv)
        row_l.append(i + 1)
        col_l.append(j + 1)
        val_l.append(1.0)
    block = SDPBlock(
        size=nq + 1,
        var=np.array(var_l, np.int32),
        row=np.array(row_l, np.int32),
        col=np.array(col_l, np.int32),
        val=np.array(val_l),
        const_row=np.array([0], np.int32),
        const_col=np.array([0], np.int32),
        const_val=np.array([-1.0]),
        # rank-1-ness (X = x x^T) is enforced by the dedicated McCormick /
        # spatial-branching path keyed on MISDP.liftinfo, not the generic
        # rank-1 machinery — the block itself serves as PSD strengthening
        rank1=False,
    )

    # each quadratic constraint becomes a linear row over (y, X)
    rows = [
        (list(prob.lp.ind[prob.lp.beg[i]:prob.lp.beg[i + 1]]),
         list(prob.lp.val[prob.lp.beg[i]:prob.lp.beg[i + 1]]),
         prob.lp.lhs[i], prob.lp.rhs[i])
        for i in range(prob.lp.nrows)
    ]
    for qc in prob.quadcons:
        coef: dict = {}
        for v, c in zip(qc.lin_ind, qc.lin_val):
            coef[int(v)] = coef.get(int(v), 0.0) + float(c)
        for r, c, q in zip(qc.qrow, qc.qcol, qc.qval):
            i, j = pos[int(r)], pos[int(c)]
            xv = lift[(max(i, j), min(i, j))]
            coef[xv] = coef.get(xv, 0.0) + float(q)
        inds = sorted(coef)
        rows.append((inds, [coef[k] for k in inds],
                     float(qc.lhs), float(qc.rhs)))

    # global McCormick envelopes for every lifted entry (root-box valid)
    liftinfo = [(xv, qvars[i], qvars[j]) for (i, j), xv in lift.items()]
    nvars_new = m + nnew
    lb_new = np.concatenate([prob.lb, new_lb])
    ub_new = np.concatenate([prob.ub, new_ub])
    for g, rhs in mccormick_rows(nvars_new, liftinfo, lb_new, ub_new):
        nz = np.nonzero(np.abs(g) > 1e-14)[0]
        rows.append((list(nz), list(g[nz]), float(rhs), INF))

    return dataclasses.replace(
        prob,
        nvars=nvars_new,
        obj=np.concatenate([prob.obj, np.zeros(nnew)]),
        lb=lb_new,
        ub=ub_new,
        integral=np.concatenate([prob.integral, np.zeros(nnew, bool)]),
        blocks=list(prob.blocks) + [block],
        lp=LinearConstraints.from_rows(rows),
        quadcons=[],
        liftinfo=liftinfo,
        varnames=(prob.varnames + [f"X_{i}_{j}" for (i, j) in lift]
                  if prob.varnames is not None else None),
    )
