"""Batched primal-dual interior-point SDP solver (PyTorch).

Counterpart of ``scipsdp_tpu/ops/ipm.py`` in its float64 configuration
(``phase32="off"``): one solve over a *batch* of SDPs that share problem
data (A, A_0, LP rows) and differ per instance in bounds, objective and
cuts — the shape of branch-and-bound node relaxations.

Problem form (the reference dual form, sdpi.c:37-58), per batch instance:

    min  b^T y
    s.t. Z^k(y) = sum_j A^k_j y_j - A^k_0  >= 0 (PSD)   for blocks k
         G y >= h                                         (LP rows, >=-form)
         l <= y <= u

The *penalty formulation* (sdpisolver.h:237-245; sdpi.c:3437-3599) is built
in structurally: variable index m (the last one) is the penalty variable r
with coefficient matrix I on every block and coefficient 1 on every LP row.
Callers select the mode purely through bounds and objective:

  * direct solve:      lb[m] = ub[m] = 0 (r fixed), b[m] = 0
  * penalty solve:     lb[m] = 0, ub[m] = +inf,     b[m] = Gamma
  * feasibility probe: penalty bounds, b[:m] = 0, b[m] = 1  (Gamma = 1)

Algorithm: infeasible-start Mehrotra predictor-corrector with the HKM
direction; Schur complement M_ij = sum_k tr(A_i X A_j S^{-1}) plus diagonal
contributions of LP rows and bounds; per-instance convergence masks so one
batch runs until every instance is done.  Blocks are grouped into size
buckets, each padded only to its bucket's maximum.

The iteration loop is a Python loop: it reads ``all(done)`` on the host
once per iteration (one device sync per iteration).  Updates are guarded
with ``torch.where`` (never a multiply by a 0/1 mask: 0 * NaN would poison
frozen instances), and every Cholesky returns NaN for a matrix that is not
positive definite, which the solver reads as "not PSD".
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from scipsdp_tpu_torch.models.problem import DenseSDPData
from scipsdp_tpu_torch.ops import kernels
from scipsdp_tpu_torch.ops.eigen import (
    cholesky,
    gersh_step_from_ymat,
    max_step_eigh_from_ymat,
    max_step_from_ymat,
    max_step_pos,
    min_eigenvalue,
    sym,
    ymat,
)
from scipsdp_tpu_torch.utils.config import IPMSettings
from scipsdp_tpu_torch.utils.status import SolverResultStatus

INF_THRESH = 1e19  # values beyond this are treated as infinite
_PROBE_MULTS = (1.0, 2.0, 4.0, 8.0, 16.0)


def _schur_product(Wall: torch.Tensor) -> torch.Tensor:
    """M = Wall @ Wall^T per batch element — the hot matmul of the IPM."""
    return torch.einsum("xif,xjf->xij", Wall, Wall)


def _wfeat_flat(LxOp, A_t, Lsinv_t, B, mp):
    """W features W_j = LxOp^T A_j Lsinv^T in the flattened (B, mp, K*n*n)
    layout (the 'xkba' spec transposes LxOp)."""
    P = torch.einsum("xkba,kjbc->xkjac", LxOp, A_t)
    W = torch.einsum("xkjab,xkcb->xkjac", P, Lsinv_t)
    return W.permute(0, 2, 1, 3, 4).reshape(B, mp, -1)


def _tril_inv(L: torch.Tensor) -> torch.Tensor:
    """Batched lower-triangular inverse (identity-RHS forward solves)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)


def _chol_probe(A: torch.Tensor, settings: IPMSettings) -> torch.Tensor:
    """Cholesky used ONLY as a PSD probe (the caller tests for NaN and
    discards the factor): the hand-written kernel when ``use_lanes_chol``
    is on, else its plain version.  Factor-quality call sites stay on
    :func:`cholesky`: probe decisions tolerate implementation rounding,
    scaling factors do not."""
    if A.dtype == torch.float32 and settings.use_lanes_chol is True:
        return kernels.cholesky_lanes(A)
    return kernels.cholesky_lanes_plain(A)


@dataclasses.dataclass(frozen=True)
class IPMData:
    """Static (per-problem) tensors for the batched solver.

    Per-bucket tuples: bucket t holds K_t blocks padded to size n_t;
    mp = nvars + 1 variables, index ``nvars`` being the structural penalty
    variable r; p LP rows in >=-form (at least one row; a trivially-true
    dummy is added if the problem has none).
    """

    A: Tuple[torch.Tensor, ...]        # per bucket (K_t, mp, n_t, n_t)
    C: Tuple[torch.Tensor, ...]        # per bucket (K_t, n_t, n_t)
    dimmask: Tuple[torch.Tensor, ...]  # per bucket (K_t, n_t) bool
    G: torch.Tensor        # (p, mp)    penalty column = 1
    h: torch.Tensor        # (p,)
    b_base: torch.Tensor   # (mp,) objective with b[m] = 0
    nvars: int             # m (without penalty var)
    ndim_sdp: int          # total real SDP dimensions (for mu)
    block_of: Tuple[Tuple[int, int], ...]  # original block k -> (bucket, idx)

    @property
    def nbuckets(self) -> int:
        return len(self.A)

    @property
    def device(self) -> torch.device:
        return self.G.device

    def to(self, device) -> "IPMData":
        """The same data with every tensor on ``device``."""
        return dataclasses.replace(
            self,
            A=tuple(a.to(device) for a in self.A),
            C=tuple(c.to(device) for c in self.C),
            dimmask=tuple(d.to(device) for d in self.dimmask),
            G=self.G.to(device), h=self.h.to(device),
            b_base=self.b_base.to(device))


def _bucketize(sizes, max_buckets: int = 4):
    """Group block sizes into at most ``max_buckets`` buckets; returns a
    list of (bucket_padded_size, [block indices])."""
    order = sorted(set(int(s) for s in sizes))
    # merge smallest-gap neighbors until within budget
    groups = [[s] for s in order]
    while len(groups) > max_buckets:
        # merging two buckets pads the smaller one up: merge where the
        # padded span is smallest
        costs = [groups[i + 1][-1] - groups[i][0]
                 for i in range(len(groups) - 1)]
        i = int(np.argmin(costs))
        groups[i] = groups[i] + groups[i + 1]
        del groups[i + 1]
    out = []
    for g in groups:
        cap = g[-1]
        idxs = [k for k, s in enumerate(sizes) if int(s) in g]
        out.append((cap, idxs))
    return out


def build_ipm_data(dense: DenseSDPData, device, dtype=torch.float64,
                   max_buckets: int = 4) -> IPMData:
    """Bucket blocks by size, append the structural penalty variable, and
    pad degenerate shapes; tensors are made on ``device``."""
    m = dense.nvars
    mp = m + 1

    def tens(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    sizes = [int(s) for s in dense.blocksizes]
    buckets = _bucketize(sizes, max_buckets) if sizes else [(1, [])]

    A_t, C_t, mask_t = [], [], []
    block_of = [None] * len(sizes)
    for t, (cap, idxs) in enumerate(buckets):
        Kt = max(len(idxs), 1)
        A = np.zeros((Kt, mp, cap, cap))
        C = np.zeros((Kt, cap, cap))
        dm = np.zeros((Kt, cap), dtype=bool)
        for slot, k in enumerate(idxs):
            nk = sizes[k]
            A[slot, :m, :nk, :nk] = dense.A[k][:, :nk, :nk]
            C[slot, :nk, :nk] = dense.C[k][:nk, :nk]
            dm[slot, :nk] = True
            block_of[k] = (t, slot)
        # padding diagonal of C is -1 so the slack block gets +1 there
        for slot in range(Kt):
            for d in range(cap):
                if not dm[slot, d]:
                    C[slot, d, d] = -1.0
            # penalty variable: identity on real dims
            A[slot, m] = np.diag(dm[slot].astype(np.float64))
        A_t.append(tens(A))
        C_t.append(tens(C))
        mask_t.append(tens(dm, torch.bool))

    p = dense.G.shape[0]
    if p == 0:
        G = np.zeros((1, mp))
        h = np.array([-1.0])  # trivially satisfied dummy row
    else:
        G = np.concatenate([dense.G, np.ones((p, 1))], axis=1)
        h = dense.h.copy()

    ndim_sdp = int(sum(int(mk.sum()) for mk in mask_t))
    return IPMData(
        A=tuple(A_t),
        C=tuple(C_t),
        dimmask=tuple(mask_t),
        G=tens(G),
        h=tens(h),
        b_base=tens(np.concatenate([dense.obj, [0.0]])),
        nvars=m,
        ndim_sdp=max(ndim_sdp, 1),
        block_of=tuple(bo if bo is not None else (0, 0) for bo in block_of),
    )


class PresolveOut(NamedTuple):
    lb: torch.Tensor        # (B, mp) tightened
    ub: torch.Tensor
    fix: torch.Tensor       # (B, mp) bool
    fixval: torch.Tensor    # (B, mp)
    lbmask: torch.Tensor    # (B, mp) finite-and-free lower bound rows
    ubmask: torch.Tensor
    rowmask: torch.Tensor   # (B, P) active rows (LP rows ++ cut rows)
    conflict: torch.Tensor  # (B,) bool
    allfixed: torch.Tensor  # (B,) bool
    fixed_feasible: torch.Tensor  # (B,) bool (valid when allfixed)


def presolve(data: IPMData, Gall, hall, rowvalid, lb, ub, feastol, epsfix,
             rounds: int) -> PresolveOut:
    """Vectorized SDPI presolve (sdpi.c:3190-3275, prepareLPData:1131).

    Operates on the unified per-node row system ``Gall`` (B, P, mp) /
    ``hall`` (B, P): the problem's static LP rows broadcast over the batch
    followed by per-node cut rows.
    """
    B = lb.shape[0]
    Gnz = Gall != 0
    rowmask = rowvalid
    conflict = torch.zeros((B,), dtype=torch.bool, device=lb.device)

    for _ in range(rounds):
        fin_lb = lb > -INF_THRESH
        fin_ub = ub < INF_THRESH
        conflict = conflict | (lb > ub + feastol).any(dim=1)
        fix = fin_lb & fin_ub & (ub - lb <= epsfix)
        fixval = torch.where(fix, 0.5 * (lb + ub), 0.0)
        free = ~fix
        nfree = torch.einsum("xpm,xm->xp", Gnz.to(lb.dtype), free.to(lb.dtype))
        rowconst = torch.einsum("xpm,xm->xp", Gall, fixval)
        # rows with all variables fixed: check & drop (sdpi.c bound conflicts)
        rows0 = rowmask & (nfree < 0.5)
        unsat = rows0 & (rowconst < hall - feastol)
        conflict = conflict | unsat.any(dim=1)
        rowmask = rowmask & ~rows0
        # rows with exactly one free variable -> bound (prepareLPData).
        # argmax of the 0/1 pattern picks the FIRST free nonzero, as
        # jnp.argmax over a bool array does.
        rows1 = rowmask & (nfree > 0.5) & (nfree < 1.5)
        jstar = torch.argmax((Gnz & free[:, None, :]).to(torch.int32), dim=2)
        g = torch.gather(Gall, 2, jstar[:, :, None])[:, :, 0]
        newb = (hall - rowconst) / torch.where(g.abs() > 0, g, 1.0)
        cand_lb = torch.where(rows1 & (g > 0), newb, -float("inf"))
        cand_ub = torch.where(rows1 & (g < 0), newb, float("inf"))
        # several rows may bound the same variable: reduce them all (an
        # indexed assignment would keep only the last write)
        lb = lb.scatter_reduce(1, jstar, cand_lb, reduce="amax",
                               include_self=True)
        ub = ub.scatter_reduce(1, jstar, cand_ub, reduce="amin",
                               include_self=True)
        rowmask = rowmask & ~rows1

    fin_lb = lb > -INF_THRESH
    fin_ub = ub < INF_THRESH
    conflict = conflict | (lb > ub + feastol).any(dim=1)
    fix = fin_lb & fin_ub & (ub - lb <= epsfix)
    fixval = torch.where(fix, 0.5 * (lb + ub), 0.0)
    allfixed = fix.all(dim=1)

    # all-fixed feasibility by eigenvalue check (checkFixedFeasibilitySdp)
    fixed_feasible = torch.ones((B,), dtype=torch.bool, device=lb.device)
    for t in range(data.nbuckets):
        Zf = torch.einsum("kjab,xj->xkab", data.A[t], fixval) - data.C[t][None]
        lam = min_eigenvalue(Zf, data.dimmask[t][None, :, :])   # (B, K_t)
        fixed_feasible = fixed_feasible & (lam >= -feastol).all(dim=1)

    return PresolveOut(
        lb=lb,
        ub=ub,
        fix=fix,
        fixval=fixval,
        lbmask=fin_lb & ~fix,
        ubmask=fin_ub & ~fix,
        rowmask=rowmask,
        conflict=conflict,
        allfixed=allfixed,
        fixed_feasible=fixed_feasible,
    )


class IPMState(NamedTuple):
    y: torch.Tensor                  # (B, mp)
    X: Tuple[torch.Tensor, ...]      # per bucket (B, K_t, n_t, n_t)
    S: Tuple[torch.Tensor, ...]
    xl: torch.Tensor    # (B, P)
    sl: torch.Tensor    # (B, P)
    xlb: torch.Tensor   # (B, mp)
    slb: torch.Tensor   # (B, mp)
    xub: torch.Tensor   # (B, mp)
    sub: torch.Tensor   # (B, mp)
    it: int
    done: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,)
    failed: torch.Tensor     # (B,)
    best_merit: torch.Tensor  # (B,) best progress merit seen
    stall: torch.Tensor       # (B,) iterations without progress


class SolveOutput(NamedTuple):
    status: torch.Tensor     # (B,) int32 SolverResultStatus
    dobj: torch.Tensor       # (B,) objective b^T y (incl. Gamma*r)
    y: torch.Tensor          # (B, mp)
    r: torch.Tensor          # (B,) penalty variable value
    gap: torch.Tensor        # (B,) complementarity gap
    pinf: torch.Tensor       # (B,) stationarity residual (scaled)
    dinf: torch.Tensor       # (B,) constraint residual (scaled)
    iters: int               # iterations used by the batch
    X: Tuple[torch.Tensor, ...]  # per-bucket primal blocks
    xl: torch.Tensor         # (B, P) row primal multipliers (LP ++ cuts)
    xlb: torch.Tensor        # (B, mp) lower-bound multipliers
    xub: torch.Tensor        # (B, mp) upper-bound multipliers


class EvalOut(NamedTuple):
    Rp: Tuple[torch.Tensor, ...]   # dual-infeasibility residual Z(y)-S
    rpl: torch.Tensor
    rplb: torch.Tensor
    rpub: torch.Tensor
    rd: torch.Tensor               # stationarity residual
    gap: torch.Tensor
    relgap: torch.Tensor
    pinf: torch.Tensor
    dinf: torch.Tensor
    conv: torch.Tensor


def _check_supported(settings: IPMSettings, warm) -> None:
    """Raise for the parts of the JAX solver this port does not carry yet."""
    if settings.dtype != "float64":
        raise NotImplementedError(
            "ipm_solve: only dtype='float64'; the float32 direction tiers "
            "come with the phase32 refine-tier port")
    if settings.phase32 in ("on", "lite", "refine"):
        raise NotImplementedError(
            f"ipm_solve: phase32={settings.phase32!r} (iter_products_refine "
            "and the f32 tiers) waits for the refine-tier port with the df32 "
            "and fused kernels")
    if settings.use_df32 == "on" or settings.fused_direction == "on":
        raise NotImplementedError(
            "ipm_solve: use_df32/fused_direction 'on' wait for the "
            "refine-tier port with the df32 and fused kernels")
    if settings.use_pallas:
        raise NotImplementedError(
            "ipm_solve: use_pallas (schur_wwt, cholesky, tril_inverse "
            "kernels) waits for the port of those kernels")
    if settings.preopt_gap > 0.0:
        raise NotImplementedError(
            "ipm_solve: preopt_gap > 0 (pre-optimal snapshots) waits for "
            "the warm-start port with the host B&B")
    if any(w is not None for w in warm):
        raise NotImplementedError(
            "ipm_solve: warm_y/warm_mask/warm_X/ip_point wait for the "
            "warm-start port with the host B&B")


def ipm_solve(
    data: IPMData,
    b,                    # (B, mp) objective incl. penalty coefficient
    lb,                   # (B, mp)
    ub,                   # (B, mp)
    Gcut=None,            # (B, q, mp) per-node cut rows  Gcut y >= hcut
    hcut=None,            # (B, q)
    cutvalid=None,        # (B, q) bool
    warm_y=None,          # not ported yet (raises)
    warm_mask=None,       # not ported yet (raises)
    gaptol_vec=None,      # (B,) per-instance gap tolerance
    warm_X=None,          # not ported yet (raises)
    ip_point=None,        # not ported yet (raises)
    feastol_vec=None,     # (B,) per-instance CONVERGENCE feastol override
    *,
    settings: IPMSettings,
) -> SolveOutput:
    """Solve a batch of SDPs on ``data``'s device.  Array arguments may be
    tensors or numpy arrays; they are moved to that device in float64."""
    _check_supported(settings, (warm_y, warm_mask, warm_X, ip_point))
    dtype = torch.float64
    dev = data.device

    def tens(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=dev)

    b, lb, ub = tens(b), tens(lb), tens(ub)
    B, mp = b.shape
    NB = data.nbuckets
    feastol = settings.feastol
    gaptol = settings.gaptol if gaptol_vec is None else tens(gaptol_vec)
    ftv = feastol if feastol_vec is None else tens(feastol_vec)
    bidx = range(NB)

    def bsum(vals):
        """Sum a sequence of (B,) tensors."""
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    # unified per-node row system: static LP rows ++ per-node cuts
    Gs = data.G[None].expand(B, -1, -1)
    hs = data.h[None].expand(B, -1)
    valids = torch.ones((B, data.G.shape[0]), dtype=torch.bool, device=dev)
    if Gcut is not None:
        Gall = torch.cat([Gs, tens(Gcut)], dim=1)
        hall = torch.cat([hs, tens(hcut)], dim=1)
        rowvalid = torch.cat([valids, tens(cutvalid, torch.bool)], dim=1)
    else:
        Gall, hall, rowvalid = Gs, hs, valids

    pre = presolve(data, Gall, hall, rowvalid, lb, ub, feastol,
                   settings.epsilon, settings.presolve_rounds)

    pad_diag = tuple(data.dimmask[t][None, :, :] for t in bidx)  # (1,K_t,n_t)
    pad_outer = tuple(pad_diag[t][..., :, None] & pad_diag[t][..., None, :]
                      for t in bidx)
    eyen = tuple(torch.eye(data.A[t].shape[-1], dtype=dtype, device=dev)
                 for t in bidx)
    eye_act = tuple(eyen[t][None, None] * pad_diag[t][..., None]
                    * pad_diag[t][..., None, :] for t in bidx)
    eye_mp = torch.eye(mp, dtype=dtype, device=dev)

    nu = (pre.rowmask.sum(dim=1) + pre.lbmask.sum(dim=1)
          + pre.ubmask.sum(dim=1)).to(dtype) + float(data.ndim_sdp)
    nu = torch.clamp_min(nu, 1.0)

    def blockmap_y(y):
        """Z_t(y) = sum_j A_j y_j - A_0 per bucket."""
        return tuple(torch.einsum("kjab,xj->xkab", data.A[t], y)
                     - data.C[t][None] for t in bidx)

    # ---- initial point ----------------------------------------------------
    two = pre.lbmask & pre.ubmask
    y0 = torch.where(two, 0.5 * (pre.lb + pre.ub), 0.0)
    y0 = torch.where(pre.lbmask & ~pre.ubmask,
                     torch.clamp_min(pre.lb + 1.0, 0.0), y0)
    y0 = torch.where(pre.ubmask & ~pre.lbmask,
                     torch.clamp_max(pre.ub - 1.0, 0.0), y0)
    y0 = torch.where(pre.fix, pre.fixval, y0)

    Z0 = blockmap_y(y0)
    normb = torch.amax(b.abs(), dim=1)
    # initial-point scale: exclude the penalty objective coefficient Gamma
    # (b[m]) — a large Gamma must not blow up X0/S0 (lambda* heuristic,
    # sdpisolver_sdpa.cpp lambdastar)
    normb_orig = (torch.amax(b[:, :data.nvars].abs(), dim=1) if data.nvars > 0
                  else torch.zeros((B,), dtype=dtype, device=dev))
    normZ0 = bsum([torch.amax(torch.where(pad_outer[t], Z0[t], 0.0).abs(),
                              dim=(1, 2, 3)) for t in bidx])
    normh = torch.amax(torch.where(pre.rowmask, hall, 0.0).abs(), dim=1)
    scale = settings.init_point_scale * torch.clamp_min(
        torch.maximum(normb_orig, torch.maximum(normZ0, normh)), 1.0)
    xi = scale[:, None, None, None]
    X0 = tuple(xi * eyen[t][None, None]
               * torch.ones((B, data.A[t].shape[0], 1, 1), dtype=dtype,
                            device=dev) for t in bidx)
    S0 = X0
    sl0 = torch.where(pre.rowmask,
                      torch.maximum(torch.einsum("xpm,xm->xp", Gall, y0)
                                    - hall, scale[:, None]),
                      1.0)
    xl0 = torch.where(pre.rowmask, scale[:, None], 0.0)
    slb0 = torch.where(pre.lbmask, torch.clamp_min(y0 - pre.lb, 1.0), 1.0)
    sub0 = torch.where(pre.ubmask, torch.clamp_min(pre.ub - y0, 1.0), 1.0)
    xlb0 = torch.where(pre.lbmask, scale[:, None], 0.0)
    xub0 = torch.where(pre.ubmask, scale[:, None], 0.0)

    zeros_b = torch.zeros((B,), dtype=torch.bool, device=dev)
    st0 = IPMState(
        y=y0, X=X0, S=S0, xl=xl0, sl=sl0, xlb=xlb0, slb=slb0, xub=xub0,
        sub=sub0, it=0, done=pre.conflict | pre.allfixed,
        converged=zeros_b, failed=zeros_b,
        best_merit=torch.full((B,), float("inf"), dtype=dtype, device=dev),
        stall=torch.zeros((B,), dtype=torch.int32, device=dev),
    )

    cmax = torch.stack([data.C[t].abs().max() for t in bidx]).max()
    datascale = 1.0 + torch.maximum(cmax, data.h.abs().max())
    free_outer = (~pre.fix)[:, :, None] & (~pre.fix)[:, None, :]

    def comp_gap(st: IPMState):
        gsdp = bsum([torch.where(pad_outer[t], st.X[t] * st.S[t], 0.0)
                     .sum(dim=(1, 2, 3)) for t in bidx])
        return (
            gsdp
            + torch.where(pre.rowmask, st.xl * st.sl, 0.0).sum(dim=1)
            + torch.where(pre.lbmask, st.xlb * st.slb, 0.0).sum(dim=1)
            + torch.where(pre.ubmask, st.xub * st.sub, 0.0).sum(dim=1)
        )

    def probe_ladder_scaled(Yxs, Yss, gp, gd):
        """step_rule="probe": certified PSD max-steps from ONE stacked f32
        Cholesky probing a geometric candidate ladder above the Gershgorin
        base — in the SCALED space: X + a dX >= 0  <=>  I + a Y >= 0 with
        Y = L^{-1} dX L^{-T}, which stays well-conditioned in f32 near
        convergence.  The PSD segment {a >= 0 : I + a Y >= 0} is an
        interval containing 0, so any candidate whose probe factorizes
        certifies every smaller step too; the largest passing candidate is
        within 2x of the exact max-step."""
        f32p = torch.float32
        capv = 1.0 / settings.tau
        nc = len(_PROBE_MULTS)
        cp = [torch.clamp_max(gp * mlt, capv).to(f32p) for mlt in _PROBE_MULTS]
        cd = [torch.clamp_max(gd * mlt, capv).to(f32p) for mlt in _PROBE_MULTS]
        okx = [torch.ones((B,), dtype=torch.bool, device=dev)
               for _ in range(nc)]
        oks = [torch.ones((B,), dtype=torch.bool, device=dev)
               for _ in range(nc)]
        for t in bidx:
            Yx = Yxs[t].to(f32p)
            Ys = Yss[t].to(f32p)
            Kt = Yx.shape[1]
            eyep = torch.eye(Yx.shape[-1], dtype=f32p, device=dev)
            # certify with a PSD margin: factor I(1-delta) + aY, so a trial
            # passes only when lambda_min(I + aY) > delta — robust to f32
            # rounding differences between Cholesky implementations
            eyem = (1.0 - 1e-5) * eyep
            trials = [eyem + cp[k][:, None, None, None] * Yx
                      for k in range(nc)]
            trials += [eyem + cd[k][:, None, None, None] * Ys
                       for k in range(nc)]
            Lp = _chol_probe(torch.cat(trials, dim=1), settings)
            nanb = torch.isnan(Lp).any(dim=-1).any(dim=-1)  # (B, 2*nc*Kt)
            for k in range(nc):
                okx[k] = okx[k] & ~nanb[:, k * Kt:(k + 1) * Kt].any(dim=1)
                off = (nc + k) * Kt
                oks[k] = oks[k] & ~nanb[:, off:off + Kt].any(dim=1)
        # largest passing candidate wins; if even the certified Gershgorin
        # base fails the f32 factorization (marginal), shrink it
        ap = (0.4 * gp).to(f32p)
        ad = (0.4 * gd).to(f32p)
        for k in range(nc):
            ap = torch.where(okx[k], cp[k], ap)
            ad = torch.where(oks[k], cd[k], ad)
        return ap, ad

    def probe_steps(Lxinv, Lsinv, dX, dS):
        """PSD max-steps for step_rule="probe": ONE congruence per bucket
        yields both the Gershgorin base (certified) and the scaled
        directions the ladder probes."""
        Yxs, Yss, gx, gs_ = [], [], [], []
        for t in bidx:
            Yb = ymat(torch.cat([Lxinv[t], Lsinv[t]], dim=1),
                      torch.cat([dX[t], dS[t]], dim=1))
            Kt = dX[t].shape[1]
            stp = gersh_step_from_ymat(Yb)
            gx.append(torch.amin(stp[:, :Kt], dim=1))
            gs_.append(torch.amin(stp[:, Kt:], dim=1))
            Yxs.append(Yb[:, :Kt])
            Yss.append(Yb[:, Kt:])
        gp = torch.amin(torch.stack(gx), dim=0)
        gd = torch.amin(torch.stack(gs_), dim=0)
        return probe_ladder_scaled(Yxs, Yss, gp, gd)

    def evaluate(st: IPMState) -> EvalOut:
        """Residuals + duality gap + per-instance convergence, computed once
        per iteration on the new state and carried into the next one."""
        yh = torch.where(pre.fix, pre.fixval, st.y)
        Z = blockmap_y(yh)
        Rp = tuple(torch.where(pad_outer[t], Z[t] - st.S[t], 0.0)
                   for t in bidx)
        Gy = torch.einsum("xpm,xm->xp", Gall, yh)
        rpl = torch.where(pre.rowmask, Gy - hall - st.sl, 0.0)
        rplb = torch.where(pre.lbmask, (yh - pre.lb) - st.slb, 0.0)
        rpub = torch.where(pre.ubmask, (pre.ub - yh) - st.sub, 0.0)
        AstarX = bsum([torch.einsum("kjab,xkba->xj", data.A[t], st.X[t])
                       for t in bidx])
        GTxl = torch.einsum("xpm,xp->xm", Gall, st.xl)
        rd = b - AstarX - GTxl - st.xlb + st.xub
        rd = torch.where(pre.fix, 0.0, rd)
        gap = comp_gap(st)
        dobj = (b * yh).sum(dim=1)
        # explicit primal (Lagrange-dual) objective of the reduced problem
        # with fixed variables folded into the constant data:
        #   pobj = <A_0eff, X> + h_eff.xl + l.xlb - u.xub + sum_fix b_j f_j
        CX = bsum([torch.where(pad_outer[t], data.C[t][None] * st.X[t], 0.0)
                   .sum(dim=(1, 2, 3)) for t in bidx])
        hxl = torch.where(pre.rowmask, hall * st.xl, 0.0).sum(dim=1)
        lxlb = torch.where(pre.lbmask, pre.lb * st.xlb, 0.0).sum(dim=1)
        uxub = torch.where(pre.ubmask, pre.ub * st.xub, 0.0).sum(dim=1)
        fixcorr = torch.where(pre.fix, pre.fixval * (AstarX + GTxl - b),
                              0.0).sum(dim=1)
        pobj = CX + hxl + lxlb - uxub - fixcorr
        pinf = torch.amax(rd.abs(), dim=1) / (1.0 + normb)
        dinf_sdp = torch.stack([torch.amax(Rp[t].abs(), dim=(1, 2, 3))
                                for t in bidx])
        dinf = torch.maximum(
            torch.amax(dinf_sdp, dim=0),
            torch.maximum(
                torch.amax(rpl.abs(), dim=1),
                torch.maximum(torch.amax(rplb.abs(), dim=1),
                              torch.amax(rpub.abs(), dim=1)),
            ),
        ) / datascale
        relgap = gap / (1.0 + dobj.abs())
        # strong-duality check: guards against spurious convergence when a
        # huge objective scale (e.g. penalty Gamma) makes the scaled
        # residual tolerances too lax (sdpsolchecker.c:58 role)
        dualgap = (dobj - pobj).abs() / (
            1.0 + torch.maximum(dobj.abs(), pobj.abs()))
        conv = ((pinf <= ftv) & (dinf <= ftv)
                & (relgap <= gaptol) & (dualgap <= 10.0 * gaptol))
        return EvalOut(Rp=Rp, rpl=rpl, rplb=rplb, rpub=rpub, rd=rd, gap=gap,
                       relgap=relgap, pinf=pinf, dinf=dinf, conv=conv)

    def iter_products(st: IPMState, ev: EvalOut):
        """One Mehrotra predictor-corrector direction + step-length pass in
        float64.  Per bucket, ONE stacked Cholesky + ONE stacked triangular
        inverse cover both X and S; the Schur factor is inverted explicitly
        so both direction solves and all PSD max-step rules become batched
        matmuls (ops/eigen.ymat)."""
        X, S = st.X, st.S
        xl, sl, xlb, slb, xub, sub = st.xl, st.sl, st.xlb, st.slb, st.xub, st.sub
        Rp, rpl, rplb, rpub, rd = ev.Rp, ev.rpl, ev.rplb, ev.rpub, ev.rd
        mu = ev.gap / nu

        def chol_inv(t):
            Kt = X[t].shape[1]
            L = cholesky(torch.cat([X[t], S[t]], dim=1))   # (B, 2K, n, n)
            Linv = _tril_inv(L)
            return L[:, :Kt], L[:, Kt:], Linv[:, :Kt], Linv[:, Kt:]

        LXS = [chol_inv(t) for t in bidx]
        Lx = tuple(v[0] for v in LXS)
        Lxinv = tuple(v[2] for v in LXS)
        Lsinv = tuple(v[3] for v in LXS)
        Sinv = tuple(sym(torch.einsum("xkba,xkbc->xkac", Lsinv[t], Lsinv[t]))
                     for t in bidx)

        # Schur complement M_ij = sum_k tr(A_i X A_j S^{-1}).  Factorized
        # form: W_j = Lx^T A_j Ls^{-T} gives M = sum_{t,k} <W_i, W_j>_F; LP
        # and cut rows contribute G^T diag(xl/sl) G = Wg^T Wg — everything
        # stacks into one feature axis and M is ONE batched matmul.
        wl = torch.where(pre.rowmask, xl / sl, 0.0)
        Wg = torch.sqrt(wl)[:, :, None] * Gall                 # (B, P, mp)
        Wall = torch.cat([_wfeat_flat(Lx[t], data.A[t], Lsinv[t], B, mp)
                          for t in bidx] + [Wg.transpose(1, 2)], dim=2)
        M = _schur_product(Wall)
        wlb = torch.where(pre.lbmask, xlb / slb, 0.0)
        wub = torch.where(pre.ubmask, xub / sub, 0.0)
        M = M + (wlb + wub)[:, :, None] * eye_mp[None]
        # fixed variables: identity row/col, dy = 0
        M = torch.where(free_outer, M, 0.0)
        M = M + pre.fix.to(dtype)[:, :, None] * eye_mp[None]
        reg = settings.chol_reg * (1.0 + torch.amax(M.abs(), dim=(1, 2)))
        M = M + reg[:, None, None] * eye_mp[None]
        Lminv = _tril_inv(cholesky(M))
        Minv = torch.einsum("xba,xbc->xac", Lminv, Lminv)  # Lm^-T Lm^-1

        def direction(Rc, rcl, rclb, rcub):
            PsiSinv = [torch.einsum(
                "xkab,xkbc->xkac",
                Rc[t] - torch.einsum("xkab,xkbc->xkac", X[t], Rp[t]),
                Sinv[t]) for t in bidx]
            rhs = (
                bsum([torch.einsum("kjab,xkba->xj", data.A[t], PsiSinv[t])
                      for t in bidx])
                + torch.einsum("xpm,xp->xm", Gall,
                               torch.where(pre.rowmask,
                                           (rcl - xl * rpl) / sl, 0.0))
                + torch.where(pre.lbmask, (rclb - xlb * rplb) / slb, 0.0)
                - torch.where(pre.ubmask, (rcub - xub * rpub) / sub, 0.0)
                - rd
            )
            rhs = torch.where(pre.fix, 0.0, rhs)
            dy = torch.einsum("xij,xj->xi", Minv, rhs)
            dS = tuple(torch.where(
                pad_outer[t],
                torch.einsum("kjab,xj->xkab", data.A[t], dy) + Rp[t],
                0.0) for t in bidx)
            dsl = torch.where(pre.rowmask,
                              torch.einsum("xpm,xm->xp", Gall, dy) + rpl, 0.0)
            dslb = torch.where(pre.lbmask, dy + rplb, 0.0)
            dsub = torch.where(pre.ubmask, -dy + rpub, 0.0)
            dX = tuple(torch.where(pad_outer[t], sym(torch.einsum(
                "xkab,xkbc->xkac",
                Rc[t] - torch.einsum("xkab,xkbc->xkac", X[t], dS[t]),
                Sinv[t])), 0.0) for t in bidx)
            dxl = torch.where(pre.rowmask, (rcl - xl * dsl) / sl, 0.0)
            dxlb = torch.where(pre.lbmask, (rclb - xlb * dslb) / slb, 0.0)
            dxub = torch.where(pre.ubmask, (rcub - xub * dsub) / sub, 0.0)
            return dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub

        if settings.step_rule == "power":
            psd_ymat_step = max_step_from_ymat
        elif settings.step_rule in ("gershgorin", "probe"):
            psd_ymat_step = gersh_step_from_ymat
        else:
            psd_ymat_step = max_step_eigh_from_ymat

        def psd_steps(dX, dS, step_fn):
            """min over blocks of the X- and S-side PSD max-steps, with the
            X/S congruence transforms stacked."""
            apv, adv = [], []
            for t in bidx:
                Yb = ymat(torch.cat([Lxinv[t], Lsinv[t]], dim=1),
                          torch.cat([dX[t], dS[t]], dim=1))
                stp = step_fn(Yb)
                Kt = dX[t].shape[1]
                apv.append(torch.amin(stp[:, :Kt], dim=1))
                adv.append(torch.amin(stp[:, Kt:], dim=1))
            return (torch.amin(torch.stack(apv), dim=0),
                    torch.amin(torch.stack(adv), dim=0))

        def steplens(dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub, step_fn,
                     psd=None):
            ap, ad = psd_steps(dX, dS, step_fn) if psd is None else psd
            ap = torch.minimum(ap, max_step_pos(xl, dxl, pre.rowmask))
            ap = torch.minimum(ap, max_step_pos(xlb, dxlb, pre.lbmask))
            ap = torch.minimum(ap, max_step_pos(xub, dxub, pre.ubmask))
            ad = torch.minimum(ad, max_step_pos(sl, dsl, pre.rowmask))
            ad = torch.minimum(ad, max_step_pos(slb, dslb, pre.lbmask))
            ad = torch.minimum(ad, max_step_pos(sub, dsub, pre.ubmask))
            return ap, ad

        XS = tuple(torch.einsum("xkab,xkbc->xkac", X[t], S[t]) for t in bidx)
        # predictor (affine scaling)
        Rc_a = tuple(torch.where(pad_outer[t], -XS[t], 0.0) for t in bidx)
        rcl_a = torch.where(pre.rowmask, -xl * sl, 0.0)
        rclb_a = torch.where(pre.lbmask, -xlb * slb, 0.0)
        rcub_a = torch.where(pre.ubmask, -xub * sub, 0.0)
        da = direction(Rc_a, rcl_a, rclb_a, rcub_a)
        dy_a, dX_a, dS_a, dxl_a, dsl_a, dxlb_a, dslb_a, dxub_a, dsub_a = da
        # the affine step lengths only feed Mehrotra's sigma estimate, so
        # the cheap conservative Gershgorin bound serves regardless of rule
        ap_a, ad_a = steplens(dX_a, dS_a, dxl_a, dsl_a, dxlb_a, dslb_a,
                              dxub_a, dsub_a, gersh_step_from_ymat)
        ap_a = torch.clamp_max(ap_a, 1.0)
        ad_a = torch.clamp_max(ad_a, 1.0)

        # Mehrotra centering parameter
        apx = ap_a[:, None, None, None]
        adx = ad_a[:, None, None, None]
        gap_sdp_a = bsum([torch.where(
            pad_outer[t],
            (X[t] + apx * dX_a[t]) * (S[t] + adx * dS_a[t]), 0.0)
            .sum(dim=(1, 2, 3)) for t in bidx])
        gap_a = (
            gap_sdp_a
            + torch.where(pre.rowmask,
                          (xl + ap_a[:, None] * dxl_a)
                          * (sl + ad_a[:, None] * dsl_a), 0.0).sum(dim=1)
            + torch.where(pre.lbmask,
                          (xlb + ap_a[:, None] * dxlb_a)
                          * (slb + ad_a[:, None] * dslb_a), 0.0).sum(dim=1)
            + torch.where(pre.ubmask,
                          (xub + ap_a[:, None] * dxub_a)
                          * (sub + ad_a[:, None] * dsub_a), 0.0).sum(dim=1)
        )
        sigma = torch.clamp(
            (torch.clamp_min(gap_a, 0.0) / torch.clamp_min(ev.gap, 1e-30))
            ** 3, settings.sigma_min, 1.0)

        # corrector
        smu = (sigma * mu)[:, None, None, None]
        Rc_c = tuple(torch.where(
            pad_outer[t],
            smu * eye_act[t] - XS[t]
            - torch.einsum("xkab,xkbc->xkac", dX_a[t], dS_a[t]),
            0.0) for t in bidx)
        smu_v = (sigma * mu)[:, None]
        rcl_c = torch.where(pre.rowmask, smu_v - xl * sl - dxl_a * dsl_a, 0.0)
        rclb_c = torch.where(pre.lbmask,
                             smu_v - xlb * slb - dxlb_a * dslb_a, 0.0)
        rcub_c = torch.where(pre.ubmask,
                             smu_v - xub * sub - dxub_a * dsub_a, 0.0)
        dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub = direction(
            Rc_c, rcl_c, rclb_c, rcub_c)
        psd_pair = None
        if settings.step_rule == "probe":
            app, adp = probe_steps(Lxinv, Lsinv, dX, dS)
            psd_pair = (app.to(dtype), adp.to(dtype))
        ap, ad = steplens(dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub,
                          psd_ymat_step, psd=psd_pair)
        ap = torch.clamp_max(settings.tau * ap, 1.0)
        ad = torch.clamp_max(settings.tau * ad, 1.0)

        if settings.step_rule == "power":
            # the power estimate can overshoot the PSD boundary: probe the
            # stepped matrices with a (stacked) Cholesky and shrink
            # offending steps
            for _ in range(2):
                okx = torch.ones((B,), dtype=torch.bool, device=dev)
                oks = torch.ones((B,), dtype=torch.bool, device=dev)
                for t in bidx:
                    Kt = dX[t].shape[1]
                    probe = torch.cat(
                        [X[t] + ap[:, None, None, None] * dX[t],
                         S[t] + ad[:, None, None, None] * dS[t]], dim=1)
                    Lp = _chol_probe(probe, settings)
                    nan_half = torch.isnan(Lp).any(dim=-1).any(dim=-1)
                    okx = okx & ~nan_half[:, :Kt].any(dim=1)
                    oks = oks & ~nan_half[:, Kt:].any(dim=1)
                ap = torch.where(okx, ap, 0.4 * ap)
                ad = torch.where(oks, ad, 0.4 * ad)

        return dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub, ap, ad

    def body(st: IPMState, ev: EvalOut):
        dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub, ap, ad = \
            iter_products(st, ev)

        # freeze finished instances; detect numerical failure (NaN)
        bad = torch.isnan(dy).any(dim=1) | torch.isnan(ap) | torch.isnan(ad)
        for t in bidx:
            bad = bad | torch.isnan(dX[t]).any(dim=-1).any(dim=-1).any(dim=-1)
        failed = st.failed | (bad & ~st.done)
        act = (~st.done) & ~bad
        # guarded updates (where, not multiply-by-zero: 0 * NaN = NaN
        # would poison frozen instances' states)
        a1 = torch.where(act, ap, 0.0)[:, None]
        a2 = torch.where(act, ad, 0.0)[:, None]
        a1x = a1[:, :, None, None]
        a2x = a2[:, :, None, None]
        actx = act[:, None, None, None]
        actv = act[:, None]

        def updm(old, d, a):
            return torch.where(actx, old + a * d, old)

        def updv(old, d, a):
            return torch.where(actv, old + a * d, old)

        new = st._replace(
            y=updv(st.y, dy, a2),
            X=tuple(updm(st.X[t], dX[t], a1x) for t in bidx),
            S=tuple(updm(st.S[t], dS[t], a2x) for t in bidx),
            xl=updv(st.xl, dxl, a1),
            sl=updv(st.sl, dsl, a2),
            xlb=updv(st.xlb, dxlb, a1),
            slb=updv(st.slb, dslb, a2),
            xub=updv(st.xub, dxub, a1),
            sub=updv(st.sub, dsub, a2),
            it=st.it + 1,
            failed=failed,
        )
        ev_n = evaluate(new)
        conv = ev_n.conv
        # stall detection: instances making no progress burn the whole
        # batch's wall clock (the loop runs until ALL are done) — declare
        # them failed early and let the recovery ladder handle them
        merit = ev_n.relgap + ev_n.pinf + ev_n.dinf
        improved = merit < settings.stall_factor * new.best_merit
        best_merit = torch.where(improved, merit, new.best_merit)
        stall_cnt = torch.where(improved | new.done, 0, new.stall + 1)
        stalled = stall_cnt >= settings.stall_window
        failed2 = new.failed | (stalled & ~new.done & ~conv)
        newly_conv = conv & ~new.done & ~failed2
        st_out = new._replace(
            converged=new.converged | newly_conv,
            done=new.done | newly_conv | failed2,
            failed=failed2,
            best_merit=best_merit,
            stall=stall_cnt,
        )
        return st_out, ev_n

    st, ev = st0, evaluate(st0)
    # one host read of the batch's done mask per iteration
    while st.it < settings.max_iters and not bool(st.done.all()):
        st, ev = body(st, ev)

    converged = st.converged | (ev.conv & ~pre.conflict & ~pre.allfixed)
    yh = torch.where(pre.fix, pre.fixval, st.y)
    dobj = (b * yh).sum(dim=1)
    dobj = torch.where(pre.allfixed & pre.fixed_feasible,
                       (b * pre.fixval).sum(dim=1), dobj)

    status = torch.full((B,), int(SolverResultStatus.FAILED),
                        dtype=torch.int32, device=dev)
    # iteration-limit: ran out of iterations while still making progress
    # (stall-detected instances keep FAILED; SCIPsdpiIsIterlimExc analog)
    if st.it >= settings.max_iters:
        status = torch.where((~st.done) & (~st.failed),
                             int(SolverResultStatus.ITERLIMIT), status)
    status = torch.where(converged, int(SolverResultStatus.OPTIMAL), status)
    status = torch.where(
        pre.allfixed & ~pre.conflict,
        torch.where(pre.fixed_feasible,
                    int(SolverResultStatus.PRESOLVED_OPTIMAL),
                    int(SolverResultStatus.PRESOLVED_INFEASIBLE)),
        status,
    )
    status = torch.where(pre.conflict,
                         int(SolverResultStatus.PRESOLVED_INFEASIBLE), status)

    return SolveOutput(
        status=status,
        dobj=dobj,
        y=yh,
        r=yh[:, data.nvars],
        gap=ev.gap,
        pinf=ev.pinf,
        dinf=ev.dinf,
        iters=st.it,
        X=st.X,
        xl=st.xl,
        xlb=st.xlb,
        xub=st.xub,
    )
