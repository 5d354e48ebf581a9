"""Batched primal-dual interior-point SDP solver (PyTorch).

Counterpart of ``scipsdp_tpu/ops/ipm.py`` in its float64 configuration
(``phase32="off"``), its plain float32 direction tiers (``phase32="on"``
and ``"lite"``: every factorization, inverse and product of an iteration
in float32 against the float64 residuals; "lite" polishes the Schur solve
with float64 residual passes) and its "refine" tier (``phase32="refine"``:
float32 factorizations, float64 assembly and refined Schur solves, with the
exact contractions of ``ops/df32.py`` and the fused direction of
``ops/fused.py``), with ``use_pallas`` routing the float32 factors,
inverses and Schur Gram through the kernels of ``ops/kernels.py``: one
solve over a *batch* of SDPs that
share problem data (A, A_0, LP rows) and differ per instance in bounds,
objective and cuts — the shape of branch-and-bound node relaxations.

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
once per iteration (one device sync per iteration; in the float32 tiers
the choice of tier for the next iteration comes back in the same read).
The loop is a generator, :func:`ipm_steps`, that yields those flags, and
:func:`lockstep` reads them: ``ipm_solve`` advances one generator, a mesh
(``parallel/mesh.py``) one per shard of the batch, read together.
On one CUDA device an iteration is captured as CUDA graphs once per key
(the data, the batch's shape, the settings) and replayed, with the probe
Cholesky launched between the graphs' segments (``ops/graphs.py``).
Every float32 iteration runs its library matmuls in full float32,
whatever the caller set: the solver saves the caller's TF32 / float32
matmul precision settings (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.get_float32_matmul_precision()``, through the per-backend
``fp32_precision`` they are views of), sets full precision, and restores
them after the iteration (the JAX package forces
``jax.default_matmul_precision("float32")`` there; see
``_full_f32_matmul``).  Updates are guarded
with ``torch.where`` (never a multiply by a 0/1 mask: 0 * NaN would poison
frozen instances), and every Cholesky returns NaN for a matrix that is not
positive definite, which the solver reads as "not PSD".
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Generator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scipsdp_tpu_torch.models.problem import DenseSDPData
from scipsdp_tpu_torch.ops import df32, fused, graphs, kernels
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
from scipsdp_tpu_torch.utils import trace
from scipsdp_tpu_torch.utils.config import IPMSettings
from scipsdp_tpu_torch.utils.status import SolverResultStatus

INF_THRESH = 1e19  # values beyond this are treated as infinite
_PROBE_MULTS = (1.0, 2.0, 4.0, 8.0, 16.0)
SCHUR_REFINE64 = 2  # float64 residual passes on the Schur solve where the
                    # penalty variable is free


def _pallas(A: torch.Tensor, settings: IPMSettings) -> bool:
    """``use_pallas`` and a float32 operand: the hand-written kernel (its
    plain version on a CPU tensor); a float64 operand goes to the library,
    as the JAX package's dispatch sends it to XLA."""
    return bool(settings.use_pallas) and A.dtype == torch.float32


def _schur_product(Wall: torch.Tensor, settings: IPMSettings) -> torch.Tensor:
    """M = Wall @ Wall^T per batch element — the hot matmul of the IPM."""
    if _pallas(Wall, settings):
        return kernels.schur_wwt(Wall)
    return kernels.schur_wwt_plain(Wall)


def _wfeat_flat(LxOp, A_t, Lsinv_t, B, mp):
    """W features W_j = LxOp^T A_j Lsinv^T in the flattened (B, mp, K*n*n)
    layout (the 'xkba' spec transposes LxOp)."""
    P = torch.einsum("xkba,kjbc->xkjac", LxOp, A_t)
    W = torch.einsum("xkjab,xkcb->xkjac", P, Lsinv_t)
    return W.permute(0, 2, 1, 3, 4).reshape(B, mp, -1)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of (B, K, n, n) block stacks."""
    return torch.einsum("xkab,xkbc->xkac", a, b)


def _chol(A: torch.Tensor, settings: IPMSettings) -> torch.Tensor:
    """Batched lower Cholesky at the factor-quality sites (see
    :func:`_chol_probe` for the probe sites); NaN for a matrix that is not
    positive definite."""
    if _pallas(A, settings):
        return kernels.cholesky(A)
    return cholesky(A)


def _tril_inv(L: torch.Tensor, settings: IPMSettings) -> torch.Tensor:
    """Batched lower-triangular inverse (identity-RHS forward solves)."""
    if _pallas(L, settings):
        return kernels.tril_inverse(L)
    return kernels.tril_inverse_plain(L)


@contextlib.contextmanager
def _full_f32_matmul():
    """Library float32 matmuls in full float32 inside, the caller's
    settings restored after.  Torch keeps the matmul precision per backend
    (``fp32_precision`` of ``torch.backends.cuda.matmul`` and
    ``torch.backends.mkldnn.matmul``); ``allow_tf32`` and
    ``get_float32_matmul_precision()`` are views of these that raise on a
    state set through both APIs, so these two are saved, set to "ieee"
    and restored."""
    cuda, mkldnn = torch.backends.cuda.matmul, torch.backends.mkldnn.matmul
    saved = cuda.fp32_precision, mkldnn.fp32_precision
    cuda.fp32_precision = mkldnn.fp32_precision = "ieee"
    try:
        yield
    finally:
        cuda.fp32_precision, mkldnn.fp32_precision = saved


def _chol_probe(A: torch.Tensor, settings: IPMSettings) -> torch.Tensor:
    """Cholesky used ONLY as a PSD probe (the caller tests for NaN and
    discards the factor): the hand-written kernel when ``use_lanes_chol``
    is on, else its plain version.  Factor-quality call sites stay on
    :func:`cholesky`: probe decisions tolerate implementation rounding,
    scaling factors do not."""
    if A.dtype == torch.float32 and settings.use_lanes_chol is True:
        capture = graphs.splitting()
        if capture is not None:
            # a CUDA graph of the iteration is being captured: the kernel
            # runs between two of its segments (ops/graphs.py)
            return capture.split(A)
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
    # buckets spread over several devices (a mesh row, parallel/mesh.py):
    # ``home`` holds G, h, b_base and the batch's vectors, ``places[t]``
    # bucket t's A, C and dimmask.  Devices as the mesh names them (its CPU
    # entries cpu:0, cpu:1, ... are one CPU to torch).  None and () when
    # everything is on G's device.
    home: Optional[torch.device] = None
    places: Tuple[torch.device, ...] = ()

    @property
    def nbuckets(self) -> int:
        return len(self.A)

    @property
    def device(self) -> torch.device:
        """The home device: the batch's vectors and the per-bucket sums."""
        return self.G.device if self.home is None else self.home

    def place(self, t: int) -> torch.device:
        """The device of bucket t."""
        return self.places[t] if self.places else self.device

    def to(self, device) -> "IPMData":
        """The same data with every tensor on ``device``."""
        return dataclasses.replace(
            self,
            A=tuple(a.to(device) for a in self.A),
            C=tuple(c.to(device) for c in self.C),
            dimmask=tuple(d.to(device) for d in self.dimmask),
            G=self.G.to(device), h=self.h.to(device),
            b_base=self.b_base.to(device), home=None, places=())


def to_device(x, device: torch.device):
    """The one cross-device move of a solve spread over several devices: a
    tensor to ``device`` (itself when it is there already), or numpy as a
    tensor there (see :func:`host_in`).  A tensor's move between the host
    and a card blocks the host: counted as a sync at site ``move``."""
    if not isinstance(x, torch.Tensor):
        return host_in(x, None, device)
    if x.device == device:
        return x
    if (x.device.type == "cpu") != (device.type == "cpu"):
        return trace.sync("move", x.to, device)
    return x.to(device)


def host_in(x, dtype, device: torch.device):
    """``x`` as a ``dtype`` tensor on ``device``.  An input in host memory
    (numpy, a list, a CPU tensor) is a blocking copy on the card: counted
    as a sync at site ``inputs`` on every device, so that the CPU counts
    the card's syncs; a tensor already on a card is not."""
    if isinstance(x, torch.Tensor) and (x.device.type != "cpu"
                                        or device.type == "cpu"):
        return torch.as_tensor(x, dtype=dtype, device=device)
    return trace.sync("inputs", torch.as_tensor, x, dtype=dtype,
                      device=device)


def _moved(xs, device: torch.device):
    """``xs`` (tensors of one shape and type) on ``device``: one tensor in
    one move, several stacked into one move."""
    if len(xs) == 1:
        return to_device(xs[0], device)
    return list(to_device(torch.stack(xs), device).unbind(0))


def _to_bucket(data: IPMData, t: int, *xs):
    """Home tensors into bucket t's device (as they are when it is the
    home): one tensor, or a list for several of one shape and type."""
    if data.place(t) == data.device:
        return xs[0] if len(xs) == 1 else list(xs)
    return _moved(xs, data.place(t))


def _to_home(data: IPMData, t: int, *xs):
    """Bucket t's results to the home device (as they are when bucket t is
    there): one tensor, or a list for several of one shape and type."""
    if data.place(t) == data.device:
        return xs[0] if len(xs) == 1 else list(xs)
    return _moved(xs, data.device)


def _bsum(vals):
    """Sum a sequence of tensors in order."""
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out


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
             rounds: int, fixed_check: bool = True) -> PresolveOut:
    """Vectorized SDPI presolve (sdpi.c:3190-3275, prepareLPData:1131).

    Operates on the unified per-node row system ``Gall`` (B, P, mp) /
    ``hall`` (B, P): the problem's static LP rows broadcast over the batch
    followed by per-node cut rows.  ``fixed_check=False`` leaves out the
    eigenvalue check of all-fixed instances (``fixed_feasible`` all True).
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
    for t in range(data.nbuckets if fixed_check else 0):
        Zf = (torch.einsum("kjab,xj->xkab", data.A[t],
                           _to_bucket(data, t, fixval)) - data.C[t][None])
        lam = min_eigenvalue(Zf, data.dimmask[t][None, :, :])   # (B, K_t)
        fixed_feasible = fixed_feasible & _to_home(
            data, t, (lam >= -feastol).all(dim=1))

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
    nan32: torch.Tensor       # (B,) float32-tier NaN: repair in float64 next
    esc: torch.Tensor         # (B,) stalled in a float32 tier: float64 on


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
    f64_iters: int           # iterations that ran the float64 tier (all of
                             # them with phase32="off"; in a float32 tier
                             # the nan32 repairs, escalations and handoff)
    # pre-optimal snapshot (settings.preopt_gap > 0): the first iterate
    # whose relative gap fell below preopt_gap, a more interior warm start
    y_pre: Optional[torch.Tensor] = None       # (B, mp)
    X_pre: Optional[Tuple[torch.Tensor, ...]] = None
    has_pre: Optional[torch.Tensor] = None     # (B,) bool


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


def _check_supported(settings: IPMSettings) -> None:
    """Raise for the part of the JAX solver this port does not carry."""
    if settings.dtype != "float64":
        raise NotImplementedError(
            "ipm_solve: only dtype='float64'.  The JAX reference's "
            "dtype='float32' solve raises NameError (its float32 pass reads "
            "A32, which it binds only for phase32 tiers, and those need "
            "dtype='float64'), so there is nothing to hold a port against")


def _start(data: IPMData, b, lb, ub, Gcut, hcut, cutvalid, warm_y,
           warm_mask, settings: IPMSettings, fixed_check: bool = True):
    """A solve's inputs on ``data``'s home device, its row system (the
    static LP rows ++ the per-node cuts), presolve and initial dual point:
    ``(b, Gall, hall, pre, y0, wm)``, ``wm`` the rows with a warm start
    (None without ``warm_y``)."""
    dev = data.device

    def tens(x, dt=torch.float64):
        return host_in(x, dt, dev)

    b, lb, ub = tens(b), tens(lb), tens(ub)
    B = b.shape[0]
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

    pre = presolve(data, Gall, hall, rowvalid, lb, ub, settings.feastol,
                   settings.epsilon, settings.presolve_rounds, fixed_check)

    two = pre.lbmask & pre.ubmask
    y0 = torch.where(two, 0.5 * (pre.lb + pre.ub), 0.0)
    y0 = torch.where(pre.lbmask & ~pre.ubmask,
                     torch.clamp_min(pre.lb + 1.0, 0.0), y0)
    y0 = torch.where(pre.ubmask & ~pre.lbmask,
                     torch.clamp_max(pre.ub - 1.0, 0.0), y0)
    y0 = torch.where(pre.fix, pre.fixval, y0)
    wm = None
    if warm_y is not None:
        # warm start (warmstartproject=2): the parent's point projected
        # into the child's box with a strict-interior margin
        wm = (torch.ones((B,), dtype=torch.bool, device=dev)
              if warm_mask is None else tens(warm_mask, torch.bool))
        margin = 0.05 * torch.where(two, pre.ub - pre.lb, 2.0)
        yw = torch.clamp(tens(warm_y),
                         torch.where(pre.lbmask, pre.lb + margin, -torch.inf),
                         torch.where(pre.ubmask, pre.ub - margin, torch.inf))
        y0 = torch.where(pre.fix, pre.fixval, torch.where(wm[:, None], yw, y0))
    return b, Gall, hall, pre, y0, wm


def _pad_masks(data: IPMData):
    """Per bucket the real dimensions (1, K_t, n_t) and their outer
    product (1, K_t, n_t, n_t), on the bucket's device."""
    pad_diag = tuple(m[None, :, :] for m in data.dimmask)
    return pad_diag, tuple(p[..., :, None] & p[..., None, :]
                           for p in pad_diag)


def _blockmap(data: IPMData, y):
    """Z_t(y) = sum_j A_j y_j - A_0 per bucket, on the bucket's device (y
    on the home device)."""
    return tuple(torch.einsum("kjab,xj->xkab", data.A[t],
                              _to_bucket(data, t, y)) - data.C[t][None]
                 for t in range(data.nbuckets))


def _norm_z0(data: IPMData, Z0, pad_outer):
    """The initial point's normZ0: per instance the sum over buckets of
    Z(y0)'s largest |entry| on the real dimensions."""
    return _bsum([_to_home(data, t, torch.amax(
        torch.where(pad_outer[t], Z0[t], 0.0).abs(), dim=(1, 2, 3)))
        for t in range(data.nbuckets)])


def start_norm(data: IPMData, b, lb, ub, Gcut=None, hcut=None,
               cutvalid=None, warm_y=None, warm_mask=None, *,
               settings: IPMSettings) -> torch.Tensor:
    """The initial point's normZ0 (B,) on ``data``'s home device, as
    :func:`ipm_steps` computes it.  A mesh that splits buckets computes it
    from the unsplit data and passes it in as ``norm_z0``: a bucket's
    largest entry is over all its blocks."""
    _check_supported(settings)
    y0 = _start(data, b, lb, ub, Gcut, hcut, cutvalid, warm_y, warm_mask,
                settings, fixed_check=False)[4]
    return _norm_z0(data, _blockmap(data, y0), _pad_masks(data)[1])


def ipm_steps(
    data: IPMData,
    b,                    # (B, mp) objective incl. penalty coefficient
    lb,                   # (B, mp)
    ub,                   # (B, mp)
    Gcut=None,            # (B, q, mp) per-node cut rows  Gcut y >= hcut
    hcut=None,            # (B, q)
    cutvalid=None,        # (B, q) bool
    warm_y=None,          # (B, mp) parent dual solution (warm start)
    warm_mask=None,       # (B,) bool: rows with a valid warm_y
    gaptol_vec=None,      # (B,) per-instance gap tolerance
    warm_X=None,          # per-bucket (B, K_t, n, n) parent primal blocks
    ip_point=None,        # (y_ip (mp,), per-bucket X_ip (K_t, n, n)):
                          # root analytic centres, the warm start's
                          # interior target instead of the scaled identity
    feastol_vec=None,     # (B,) per-instance CONVERGENCE feastol override
    *,
    settings: IPMSettings,
    norm_z0=None,         # (B,) the initial point's normZ0 (start_norm)
) -> Generator[torch.Tensor, Tuple[bool, bool], SolveOutput]:
    """:func:`ipm_solve` as a generator that :func:`lockstep` advances
    one iteration at a time.  Before every iteration it
    yields a 1-D bool tensor on ``data``'s device: the batch's done mask
    reduced to one flag, and in a float32 tier the tier's choice for the
    next iteration (``tier32``) after it.  Its caller sends back the global
    ``(all_done, use32)``; the generator returns the SolveOutput when
    ``all_done`` or at ``max_iters``.  Several generators over slices of
    one batch, sent the conjunction of their flags, run the iterations
    of one solve over the whole batch.

    Buckets may live away from the home device (``IPMData.places``):
    per-bucket partial sums, reductions and W features come home, where
    they are combined in bucket order, and home vectors go into the
    buckets, each through :func:`to_device`; ``warm_X`` and ``ip_point``'s
    blocks come on their bucket's device.  On one device nothing moves."""
    _check_supported(settings)
    # the request's set-up: its inputs on the device, presolve, the start
    # point and its evaluation, up to the first flags; attributes the
    # batch B, the Schur size mp and the buckets' (K, n), known on the host
    setup = trace.span("ipm.setup", B=b.shape[0], mp=data.nvars + 1,
                       phase32=settings.phase32,
                       buckets=tuple((a.shape[0], a.shape[-1])
                                     for a in data.A))
    dtype = torch.float64
    dev = data.device

    def tens(x, dt=dtype):
        return host_in(x, dt, dev)

    b, Gall, hall, pre, y0, wm = _start(data, b, lb, ub, Gcut, hcut,
                                        cutvalid, warm_y, warm_mask, settings)
    B, mp = b.shape
    NB = data.nbuckets
    feastol = settings.feastol
    gaptol = settings.gaptol if gaptol_vec is None else tens(gaptol_vec)
    ftv = feastol if feastol_vec is None else tens(feastol_vec)
    bidx = range(NB)

    def into(t, *xs):
        """Home tensors into bucket t (see _to_bucket)."""
        return _to_bucket(data, t, *xs)

    def back(t, *xs):
        """Bucket t's results home (see _to_home)."""
        return _to_home(data, t, *xs)

    def tensb(t, x):
        """A per-bucket input as float64 on bucket t's device."""
        return host_in(x, dtype, data.place(t))

    pad_diag, pad_outer = _pad_masks(data)
    eyen = tuple(torch.eye(data.A[t].shape[-1], dtype=dtype,
                           device=data.place(t)) for t in bidx)
    eye_act = tuple(eyen[t][None, None] * pad_diag[t][..., None]
                    * pad_diag[t][..., None, :] for t in bidx)
    eye_act32 = tuple(e.to(torch.float32) for e in eye_act)
    eye_mp = torch.eye(mp, dtype=dtype, device=dev)

    nu = (pre.rowmask.sum(dim=1) + pre.lbmask.sum(dim=1)
          + pre.ubmask.sum(dim=1)).to(dtype) + float(data.ndim_sdp)
    nu = torch.clamp_min(nu, 1.0)

    # ---- initial point ----------------------------------------------------
    Z0 = _blockmap(data, y0)
    normb = torch.amax(b.abs(), dim=1)
    # initial-point scale: exclude the penalty objective coefficient Gamma
    # (b[m]) — a large Gamma must not blow up X0/S0 (lambda* heuristic,
    # sdpisolver_sdpa.cpp lambdastar)
    normb_orig = (torch.amax(b[:, :data.nvars].abs(), dim=1) if data.nvars > 0
                  else torch.zeros((B,), dtype=dtype, device=dev))
    normZ0 = (_norm_z0(data, Z0, pad_outer) if norm_z0 is None
              else tens(norm_z0))
    normh = torch.amax(torch.where(pre.rowmask, hall, 0.0).abs(), dim=1)
    scale = settings.init_point_scale * torch.clamp_min(
        torch.maximum(normb_orig, torch.maximum(normZ0, normh)), 1.0)
    xi = scale[:, None, None, None]
    xis = [into(t, xi) for t in bidx]
    X0 = tuple(xis[t] * eyen[t][None, None]
               * torch.ones((B, data.A[t].shape[0], 1, 1), dtype=dtype,
                            device=data.place(t)) for t in bidx)
    S0 = X0
    if warm_y is not None:
        # the slack from the projected point (and the parent's primal),
        # floored on the PSD cone and convex-combined with an interior
        # target (fillStartZ / fillStartX): the scaled identity, or the
        # analytic centres of ``ip_point``
        f = settings.warmstartipfactor
        wmk = [into(t, wm[:, None, None, None]) for t in bidx]

        def psd_floor(t, Mt, floor_rel):
            """Project onto the PSD cone with an eigenvalue floor relative
            to the largest |eigenvalue|; the padding keeps the scaled
            identity."""
            pad = eyen[t][None, None] * xis[t]
            # eigh checks its result on the host: a sync on the card
            lam, V = trace.sync("eigh", torch.linalg.eigh,
                                torch.where(pad_outer[t], Mt, pad))
            lfloor = floor_rel * torch.clamp_min(
                lam.abs().amax(dim=-1, keepdim=True), 1.0)
            lam = torch.maximum(lam, lfloor)
            proj = torch.einsum("xkae,xke,xkbe->xkab", V, lam, V)
            return torch.where(pad_outer[t], proj, pad)

        if ip_point is not None:
            y_ip, X_ip = ip_point
            S_tgt = tuple(psd_floor(t, (torch.einsum(
                "kjab,j->kab", data.A[t], into(t, tens(y_ip)))
                - data.C[t])[None].expand(Z0[t].shape), 1e-2) for t in bidx)
            X_tgt = tuple(psd_floor(t, tensb(t, X_ip[t])[None].expand(
                X0[t].shape), 1e-2) for t in bidx)
        else:
            S_tgt = X_tgt = X0
        S0 = tuple(sym(torch.where(
            wmk[t], (1.0 - f) * psd_floor(t, Z0[t], 1e-3) + f * S_tgt[t],
            S0[t])) for t in bidx)
        if warm_X is not None:
            X0 = tuple(sym(torch.where(
                wmk[t], (1.0 - f) * psd_floor(t, sym(tensb(t, warm_X[t])),
                                              1e-3)
                + f * X_tgt[t], X0[t])) for t in bidx)
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
        nan32=zeros_b, esc=zeros_b,
    )

    cmax = torch.stack([back(t, data.C[t].abs().max()) for t in bidx]).max()
    datascale = 1.0 + torch.maximum(cmax, data.h.abs().max())
    free_outer = (~pre.fix)[:, :, None] & (~pre.fix)[:, None, :]

    # float32 tiers (JAX ipm.py:641-644): float32 shadows of the static
    # data, built once per solve; the refine tier adds the loop-invariant
    # operands of its exact contractions — A flattened per bucket to
    # (mp, K*n*n) in feature order (k, a, b), and the row system and its
    # transpose, contiguous
    use_refine = settings.phase32 == "refine"
    use_lite = settings.phase32 == "lite"
    use_phase32 = settings.phase32 == "on" or use_refine or use_lite
    A32 = G32 = A_flat = Gall_c = GallT = None
    if use_phase32:
        A32 = tuple(data.A[t].to(torch.float32) for t in bidx)
        G32 = Gall.to(torch.float32)
    if use_refine:
        A_flat = tuple(data.A[t].transpose(0, 1).reshape(mp, -1) for t in bidx)
        Gall_c = Gall.contiguous()
        GallT = Gall.transpose(1, 2).contiguous()
        mm_f64, short64, long64 = (
            (df32.bmm64, df32.contract_short64, df32.contract_long64)
            if settings.use_df32 != "off" else
            (df32.bmm64_plain, df32.contract_short64_plain,
             df32.contract_long64_plain))
    # fused direction (JAX ipm.py:724 without its TPU VMEM gates): the
    # rhs-assembly / Schur-solve / recovery chain as three kernels per
    # direction and bucket (ops/fused.py)
    use_fused = (use_refine and settings.use_df32 != "off"
                 and settings.fused_direction != "off")

    def comp_gap(st: IPMState):
        gsdp = _bsum([back(t, torch.where(pad_outer[t], st.X[t] * st.S[t],
                                          0.0).sum(dim=(1, 2, 3)))
                      for t in bidx])
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
            eyep = torch.eye(Yx.shape[-1], dtype=f32p, device=Yx.device)
            # certify with a PSD margin: factor I(1-delta) + aY, so a trial
            # passes only when lambda_min(I + aY) > delta — robust to f32
            # rounding differences between Cholesky implementations
            eyem = (1.0 - 1e-5) * eyep
            cands = into(t, *cp, *cd)
            trials = [eyem + cands[k][:, None, None, None] * Yx
                      for k in range(nc)]
            trials += [eyem + cands[nc + k][:, None, None, None] * Ys
                       for k in range(nc)]
            Lp = _chol_probe(torch.cat(trials, dim=1), settings)
            # (B, 2*nc*Kt), home
            nanb = back(t, torch.isnan(Lp).any(dim=-1).any(dim=-1))
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

    def congruences(Lxinv, Lsinv, dX, dS, cast32):
        """Per bucket the stacked X- and S-side congruences Y = L^-1 dM
        L^-T (``cast32``: directions cast to the refine tier's float32
        factors first)."""
        f32 = torch.float32
        return [ymat(torch.cat([Lxinv[t], Lsinv[t]], dim=1),
                     torch.cat([dX[t].to(f32), dS[t].to(f32)] if cast32
                               else [dX[t], dS[t]], dim=1)) for t in bidx]

    def probe_steps(Lxinv, Lsinv, dX, dS, cast32=False):
        """PSD max-steps for step_rule="probe": ONE congruence per bucket
        yields both the Gershgorin base (certified) and the scaled
        directions the ladder probes."""
        Yxs, Yss, gx, gs_ = [], [], [], []
        for t, Yb in enumerate(congruences(Lxinv, Lsinv, dX, dS, cast32)):
            Kt = dX[t].shape[1]
            stp = gersh_step_from_ymat(Yb)
            gxt, gst = back(t, torch.amin(stp[:, :Kt], dim=1),
                            torch.amin(stp[:, Kt:], dim=1))
            gx.append(gxt)
            gs_.append(gst)
            Yxs.append(Yb[:, :Kt])
            Yss.append(Yb[:, Kt:])
        gp = torch.amin(torch.stack(gx), dim=0)
        gd = torch.amin(torch.stack(gs_), dim=0)
        return probe_ladder_scaled(Yxs, Yss, gp, gd)

    def evaluate(st: IPMState) -> EvalOut:
        """Residuals + duality gap + per-instance convergence, computed once
        per iteration on the new state and carried into the next one."""
        yh = torch.where(pre.fix, pre.fixval, st.y)
        Z = _blockmap(data, yh)
        Rp = tuple(torch.where(pad_outer[t], Z[t] - st.S[t], 0.0)
                   for t in bidx)
        Gy = torch.einsum("xpm,xm->xp", Gall, yh)
        rpl = torch.where(pre.rowmask, Gy - hall - st.sl, 0.0)
        rplb = torch.where(pre.lbmask, (yh - pre.lb) - st.slb, 0.0)
        rpub = torch.where(pre.ubmask, (pre.ub - yh) - st.sub, 0.0)
        AstarX = _bsum([back(t, torch.einsum("kjab,xkba->xj", data.A[t],
                                             st.X[t])) for t in bidx])
        GTxl = torch.einsum("xpm,xp->xm", Gall, st.xl)
        rd = b - AstarX - GTxl - st.xlb + st.xub
        rd = torch.where(pre.fix, 0.0, rd)
        gap = comp_gap(st)
        dobj = (b * yh).sum(dim=1)
        # explicit primal (Lagrange-dual) objective of the reduced problem
        # with fixed variables folded into the constant data:
        #   pobj = <A_0eff, X> + h_eff.xl + l.xlb - u.xub + sum_fix b_j f_j
        CX = _bsum([back(t, torch.where(pad_outer[t],
                                        data.C[t][None] * st.X[t], 0.0)
                         .sum(dim=(1, 2, 3))) for t in bidx])
        hxl = torch.where(pre.rowmask, hall * st.xl, 0.0).sum(dim=1)
        lxlb = torch.where(pre.lbmask, pre.lb * st.xlb, 0.0).sum(dim=1)
        uxub = torch.where(pre.ubmask, pre.ub * st.xub, 0.0).sum(dim=1)
        fixcorr = torch.where(pre.fix, pre.fixval * (AstarX + GTxl - b),
                              0.0).sum(dim=1)
        pobj = CX + hxl + lxlb - uxub - fixcorr
        pinf = torch.amax(rd.abs(), dim=1) / (1.0 + normb)
        dinf_sdp = torch.stack([back(t, torch.amax(Rp[t].abs(),
                                                   dim=(1, 2, 3)))
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

    def psd_steps(Lxinv, Lsinv, dX, dS, step_fn, cast32, wdt):
        """min over blocks of the X- and S-side PSD max-steps, with the
        X/S congruence transforms stacked (``cast32``: in the refine tier's
        float32; the steps come back in ``wdt``)."""
        apv, adv = [], []
        for t, Yb in enumerate(congruences(Lxinv, Lsinv, dX, dS, cast32)):
            stp = step_fn(Yb)
            Kt = dX[t].shape[1]
            apt, adt = back(t, torch.amin(stp[:, :Kt], dim=1),
                            torch.amin(stp[:, Kt:], dim=1))
            apv.append(apt)
            adv.append(adt)
        return (torch.amin(torch.stack(apv), dim=0).to(wdt),
                torch.amin(torch.stack(adv), dim=0).to(wdt))

    def steplens(st, d, psd):
        """Primal and dual step lengths of direction ``d``: the PSD pair
        ``psd`` capped by the LP rows' and bounds' ratio tests."""
        dxl, dsl, dxlb, dslb, dxub, dsub = d[3:]
        ap, ad = psd
        ap = torch.minimum(ap, max_step_pos(st.xl, dxl, pre.rowmask))
        ap = torch.minimum(ap, max_step_pos(st.xlb, dxlb, pre.lbmask))
        ap = torch.minimum(ap, max_step_pos(st.xub, dxub, pre.ubmask))
        ad = torch.minimum(ad, max_step_pos(st.sl, dsl, pre.rowmask))
        ad = torch.minimum(ad, max_step_pos(st.slb, dslb, pre.lbmask))
        ad = torch.minimum(ad, max_step_pos(st.sub, dsub, pre.ubmask))
        return ap, ad

    def lp_rhs(st, ev, sdp, gt, rcl, rclb, rcub):
        """Schur right-hand side: the blocks' part ``sdp`` plus the LP
        rows' (``gt`` is G^T w) and the bounds' parts, minus rd."""
        return (sdp
                + gt(torch.where(pre.rowmask, (rcl - st.xl * ev.rpl) / st.sl,
                                 0.0))
                + torch.where(pre.lbmask, (rclb - st.xlb * ev.rplb) / st.slb,
                              0.0)
                - torch.where(pre.ubmask, (rcub - st.xub * ev.rpub) / st.sub,
                              0.0)
                - ev.rd)

    def lp_recover(st, ev, dy, Gdy, rcl, rclb, rcub):
        """The LP rows' and bounds' multiplier and slack steps from dy
        (``Gdy`` = G dy)."""
        dsl = torch.where(pre.rowmask, Gdy + ev.rpl, 0.0)
        dslb = torch.where(pre.lbmask, dy + ev.rplb, 0.0)
        dsub = torch.where(pre.ubmask, -dy + ev.rpub, 0.0)
        dxl = torch.where(pre.rowmask, (rcl - st.xl * dsl) / st.sl, 0.0)
        dxlb = torch.where(pre.lbmask, (rclb - st.xlb * dslb) / st.slb, 0.0)
        dxub = torch.where(pre.ubmask, (rcub - st.xub * dsub) / st.sub, 0.0)
        return dxl, dsl, dxlb, dslb, dxub, dsub

    def mehrotra(st, ev, Lxinv, Lsinv, direction, mm, refine):
        """Mehrotra predictor-corrector on one factored iteration.
        ``direction(Rc, rcl, rclb, rcub)`` solves the Newton system for a
        complementarity right-hand side and returns (dy, dX, dS, dxl, dsl,
        dxlb, dslb, dxub, dsub); ``mm`` is the batched float64 product of
        the complementarity terms.  ``refine``: the step rules run on the
        tier's float32 factors, and the Gondzio correctors run.  The pass
        computes in the type of ``st`` and ``ev`` (float32 in the plain
        float32 tiers)."""
        X, S = st.X, st.S
        wdt = st.xl.dtype
        eyea = eye_act32 if wdt == torch.float32 else eye_act
        mu = ev.gap / nu.to(wdt)
        if settings.step_rule == "power":
            psd_ymat_step = max_step_from_ymat
        elif settings.step_rule in ("gershgorin", "probe"):
            psd_ymat_step = gersh_step_from_ymat
        else:
            psd_ymat_step = max_step_eigh_from_ymat

        def rule_steps(d):
            """Step lengths of direction ``d`` by the step rule, with the
            fraction-to-boundary factor tau."""
            if settings.step_rule == "probe":
                app, adp = probe_steps(Lxinv, Lsinv, d[1], d[2], cast32=refine)
                psd = (app.to(wdt), adp.to(wdt))
            else:
                psd = psd_steps(Lxinv, Lsinv, d[1], d[2], psd_ymat_step,
                                refine, wdt)
            ap, ad = steplens(st, d, psd)
            return (torch.clamp_max(settings.tau * ap, 1.0),
                    torch.clamp_max(settings.tau * ad, 1.0))

        XS = tuple(mm(X[t], S[t]) for t in bidx)
        # predictor (affine scaling)
        Rc_a = tuple(torch.where(pad_outer[t], -XS[t], 0.0) for t in bidx)
        rcl_a = torch.where(pre.rowmask, -st.xl * st.sl, 0.0)
        rclb_a = torch.where(pre.lbmask, -st.xlb * st.slb, 0.0)
        rcub_a = torch.where(pre.ubmask, -st.xub * st.sub, 0.0)
        da = direction(Rc_a, rcl_a, rclb_a, rcub_a)
        dy_a, dX_a, dS_a, dxl_a, dsl_a, dxlb_a, dslb_a, dxub_a, dsub_a = da
        # the affine step lengths only feed Mehrotra's sigma estimate, so
        # the cheap conservative Gershgorin bound serves regardless of rule
        ap_a, ad_a = steplens(st, da, psd_steps(
            Lxinv, Lsinv, dX_a, dS_a, gersh_step_from_ymat, refine, wdt))
        ap_a = torch.clamp_max(ap_a, 1.0)
        ad_a = torch.clamp_max(ad_a, 1.0)

        # Mehrotra centering parameter
        apx = ap_a[:, None, None, None]
        adx = ad_a[:, None, None, None]
        steps_a = [into(t, apx, adx) for t in bidx]
        gap_sdp_a = _bsum([back(t, torch.where(
            pad_outer[t], (X[t] + steps_a[t][0] * dX_a[t])
            * (S[t] + steps_a[t][1] * dS_a[t]), 0.0).sum(dim=(1, 2, 3)))
            for t in bidx])
        gap_a = (
            gap_sdp_a
            + torch.where(pre.rowmask,
                          (st.xl + ap_a[:, None] * dxl_a)
                          * (st.sl + ad_a[:, None] * dsl_a), 0.0).sum(dim=1)
            + torch.where(pre.lbmask,
                          (st.xlb + ap_a[:, None] * dxlb_a)
                          * (st.slb + ad_a[:, None] * dslb_a), 0.0).sum(dim=1)
            + torch.where(pre.ubmask,
                          (st.xub + ap_a[:, None] * dxub_a)
                          * (st.sub + ad_a[:, None] * dsub_a), 0.0).sum(dim=1)
        )
        sigma = torch.clamp(
            (torch.clamp_min(gap_a, 0.0) / torch.clamp_min(ev.gap, 1e-30))
            ** 3, settings.sigma_min, 1.0)

        # corrector
        smu = (sigma * mu)[:, None, None, None]
        Rc_c = tuple(torch.where(
            pad_outer[t],
            into(t, smu) * eyea[t] - XS[t] - mm(dX_a[t], dS_a[t]),
            0.0) for t in bidx)
        smu_v = (sigma * mu)[:, None]
        rcl_c = torch.where(pre.rowmask,
                            smu_v - st.xl * st.sl - dxl_a * dsl_a, 0.0)
        rclb_c = torch.where(pre.lbmask,
                             smu_v - st.xlb * st.slb - dxlb_a * dslb_a, 0.0)
        rcub_c = torch.where(pre.ubmask,
                             smu_v - st.xub * st.sub - dxub_a * dsub_a, 0.0)
        d = direction(Rc_c, rcl_c, rclb_c, rcub_c)
        ap, ad = rule_steps(d)

        # Gondzio multiple centrality correctors (refine tier): reuse the
        # factored Schur complement to pull outlier complementarity
        # products toward [0.1, 10] * sigma*mu; per instance, a corrected
        # direction is kept only when its step lengths (by the same rule)
        # grow by 0.05
        tgt = sigma * mu
        for _ in range(max(int(settings.gondzio), 0) if refine else 0):
            dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub = d
            aptv = torch.clamp_max(ap + 0.1, 1.0)
            adtv = torch.clamp_max(ad + 0.1, 1.0)
            apt = aptv[:, None, None, None]
            adt = adtv[:, None, None, None]

            def cor(prod, lo, hi):
                return torch.minimum(torch.maximum(prod, lo), hi) - prod

            lo4 = (0.1 * tgt)[:, None, None, None]
            hi4 = (10.0 * tgt)[:, None, None, None]
            four = [into(t, apt, adt, lo4, hi4) for t in bidx]
            Rc_g = tuple(torch.where(
                pad_outer[t],
                cor(mm(X[t] + four[t][0] * dX[t], S[t] + four[t][1] * dS[t]),
                    four[t][2] * eyea[t], four[t][3] * eyea[t]),
                0.0) for t in bidx)
            lo, hi = (0.1 * tgt)[:, None], (10.0 * tgt)[:, None]
            rcl_g = torch.where(pre.rowmask, cor(
                (st.xl + aptv[:, None] * dxl) * (st.sl + adtv[:, None] * dsl),
                lo, hi), 0.0)
            rclb_g = torch.where(pre.lbmask, cor(
                (st.xlb + aptv[:, None] * dxlb)
                * (st.slb + adtv[:, None] * dslb), lo, hi), 0.0)
            rcub_g = torch.where(pre.ubmask, cor(
                (st.xub + aptv[:, None] * dxub)
                * (st.sub + adtv[:, None] * dsub), lo, hi), 0.0)
            dg = direction(Rc_g, rcl_g, rclb_g, rcub_g)
            cand = tuple(
                tuple(a + b for a, b in zip(x, g)) if isinstance(x, tuple)
                else x + g for x, g in zip(d, dg))
            ap2, ad2 = rule_steps(cand)
            acc = (ap2 + ad2) >= (ap + ad) + 0.05
            accs = [into(t, acc) for t in bidx]

            def pick(new, old, keep=acc):
                return torch.where(keep.view((-1,) + (1,) * (new.dim() - 1)),
                                   new, old)

            d = tuple(
                tuple(pick(a, b, accs[t])
                      for t, (a, b) in enumerate(zip(x, y)))
                if isinstance(x, tuple) else pick(x, y)
                for x, y in zip(cand, d))
            ap = torch.where(acc, ap2, ap)
            ad = torch.where(acc, ad2, ad)

        if settings.step_rule == "power":
            # the power estimate can overshoot the PSD boundary: probe the
            # stepped matrices with a (stacked) Cholesky and shrink
            # offending steps (the refine tier probes in float32)
            dX, dS = d[1], d[2]
            for _ in range(2):
                okx = torch.ones((B,), dtype=torch.bool, device=dev)
                oks = torch.ones((B,), dtype=torch.bool, device=dev)
                for t in bidx:
                    Kt = dX[t].shape[1]
                    apt, adt = into(t, ap[:, None, None, None],
                                    ad[:, None, None, None])
                    probe = torch.cat([X[t] + apt * dX[t],
                                       S[t] + adt * dS[t]], dim=1)
                    Lp = (cholesky(probe.to(torch.float32)) if refine
                          else _chol_probe(probe, settings))
                    nan_half = back(t, torch.isnan(Lp).any(dim=-1)
                                    .any(dim=-1))
                    okx = okx & ~nan_half[:, :Kt].any(dim=1)
                    oks = oks & ~nan_half[:, Kt:].any(dim=1)
                ap = torch.where(okx, ap, 0.4 * ap)
                ad = torch.where(oks, ad, 0.4 * ad)

        return (*d, ap, ad)

    def iter_products(st: IPMState, ev: EvalOut, dtp):
        """One Mehrotra predictor-corrector direction + step-length pass
        with every factorization, solve and product in ``dtp`` (JAX
        ``iter_products``): float64, or float32 in the plain float32 tiers,
        where the state and residuals are cast down first and the
        direction and steps cast back up at the end.  Per bucket, ONE
        stacked Cholesky + ONE stacked triangular inverse cover both X and
        S; the Schur factor is inverted explicitly so both direction solves
        and all PSD max-step rules become batched matmuls
        (ops/eigen.ymat)."""
        f32 = dtp == torch.float32
        lite = f32 and use_lite
        Ad, Gd = (A32, G32) if f32 else (data.A, Gall)

        def cast(a):
            return a.to(dtp)

        st = st._replace(X=tuple(map(cast, st.X)), S=tuple(map(cast, st.S)),
                         xl=cast(st.xl), sl=cast(st.sl), xlb=cast(st.xlb),
                         slb=cast(st.slb), xub=cast(st.xub), sub=cast(st.sub))
        ev = ev._replace(Rp=tuple(map(cast, ev.Rp)), rpl=cast(ev.rpl),
                         rplb=cast(ev.rplb), rpub=cast(ev.rpub),
                         rd=cast(ev.rd), gap=cast(ev.gap))
        X, S = st.X, st.S
        xl, sl, xlb, slb, xub, sub = st.xl, st.sl, st.xlb, st.slb, st.xub, st.sub
        Rp = ev.Rp
        eye = eye_mp.to(dtp)

        def chol_inv(t):
            Kt = X[t].shape[1]
            L = _chol(torch.cat([X[t], S[t]], dim=1), settings)  # (B, 2K, n, n)
            Linv = _tril_inv(L, settings)
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
        Wg = torch.sqrt(wl)[:, :, None] * Gd                   # (B, P, mp)
        Wall = torch.cat([back(t, _wfeat_flat(Lx[t], Ad[t], Lsinv[t], B, mp))
                          for t in bidx] + [Wg.transpose(1, 2)], dim=2)
        M = _schur_product(Wall, settings)
        wlb = torch.where(pre.lbmask, xlb / slb, 0.0)
        wub = torch.where(pre.ubmask, xub / sub, 0.0)
        M = M + (wlb + wub)[:, :, None] * eye[None]
        # fixed variables: identity row/col, dy = 0
        M = torch.where(free_outer, M, 0.0)
        M = M + pre.fix.to(dtp)[:, :, None] * eye[None]
        chol_reg = max(settings.chol_reg, 1e-9) if f32 else settings.chol_reg
        reg = chol_reg * (1.0 + torch.amax(M.abs(), dim=(1, 2)))
        if f32:
            M = M + reg[:, None, None] * eye[None]
        else:
            # where the penalty variable is free (the probe and penalty
            # modes), each row's shift is chol_reg * (1 + its own
            # diagonal), elsewhere the largest entry's on every row.  With
            # r free its bound barrier xlb/slb grows without limit as
            # r -> 0 (~1e17), and X S^-1 along a box's fixed null
            # directions (~1e10); a shift scaled by the largest entry
            # swamps every other row of the Newton system and the primal
            # residual stalls
            dM = torch.diagonal(M, dim1=1, dim2=2)
            shift = torch.where(pre.fix[:, -1:], reg[:, None],
                                chol_reg * (1.0 + dM))
            dM.add_(shift)
        if f32:
            # Jacobi equilibration: near convergence the Schur diagonal
            # spans many orders of magnitude; cond(D M D) << cond(M) lets
            # the float32 factorization carry the solve
            dsc = 1.0 / torch.sqrt(torch.clamp_min(
                torch.diagonal(M, dim1=1, dim2=2), 1e-30))
            Lminv = _tril_inv(_chol(M * dsc[:, :, None] * dsc[:, None, :],
                                    settings), settings)
            Minv = (torch.einsum("xba,xbc->xac", Lminv, Lminv)
                    * dsc[:, :, None] * dsc[:, None, :])
        else:
            Lminv = _tril_inv(_chol(M, settings), settings)
            Minv = torch.einsum("xba,xbc->xac", Lminv, Lminv)  # Lm^-T Lm^-1
        if lite:
            # "lite": float32 assembly throughout, the Schur back-solve
            # polished by float64 residual passes against the exact Gram
            # of the float32 features (plain float64 matvecs, no kernel)
            Wall64 = Wall.to(dtype)
            diag64 = (wlb + wub).to(dtype)
            reg64 = reg.to(dtype)

        def solve_dy(rhs):
            dy = torch.einsum("xij,xj->xi", Minv, rhs)
            if not f32:
                # where the penalty variable is free, residual passes
                # against the unshifted system: near a box with no
                # interior M's rows span ~1e17, the explicit inverse's
                # product leaves a residual that the Newton step carries
                # into the primal residual, and the solve stalls with the
                # gap closed and the primal residual above feastol
                rfree = ~pre.fix[:, -1:]
                for _ in range(SCHUR_REFINE64):
                    res = rhs - torch.einsum("xij,xj->xi", M, dy) + shift * dy
                    dy = torch.where(
                        rfree, dy + torch.einsum("xij,xj->xi", Minv, res), dy)
            if not lite:
                return dy
            rhs64 = torch.where(pre.fix, 0.0, rhs.to(dtype))
            dy = dy.to(dtype)
            for _ in range(max(int(settings.schur_refine), 0)):
                vf = torch.where(pre.fix, 0.0, dy)
                wt = torch.einsum("xif,xi->xf", Wall64, vf)
                u = (torch.einsum("xif,xf->xi", Wall64, wt)
                     + diag64 * vf + reg64[:, None] * vf)
                r = rhs64 - torch.where(pre.fix, 0.0, u)
                dy = dy + torch.einsum("xij,xj->xi", Minv,
                                       r.to(dtp)).to(dtype)
            return torch.where(pre.fix, 0.0, dy).to(dtp)

        def direction(Rc, rcl, rclb, rcub):
            PsiSinv = [_bmm(Rc[t] - _bmm(X[t], Rp[t]), Sinv[t]) for t in bidx]
            rhs = lp_rhs(
                st, ev,
                _bsum([back(t, torch.einsum("kjab,xkba->xj", Ad[t],
                                            PsiSinv[t])) for t in bidx]),
                lambda w: torch.einsum("xpm,xp->xm", Gd, w),
                rcl, rclb, rcub)
            rhs = torch.where(pre.fix, 0.0, rhs)
            dy = solve_dy(rhs)
            dS = tuple(torch.where(
                pad_outer[t],
                torch.einsum("kjab,xj->xkab", Ad[t], into(t, dy)) + Rp[t],
                0.0) for t in bidx)
            dX = tuple(torch.where(pad_outer[t], sym(_bmm(
                Rc[t] - _bmm(X[t], dS[t]), Sinv[t])), 0.0) for t in bidx)
            dxl, dsl, dxlb, dslb, dxub, dsub = lp_recover(
                st, ev, dy, torch.einsum("xpm,xm->xp", Gd, dy),
                rcl, rclb, rcub)
            return dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub

        out = mehrotra(st, ev, Lxinv, Lsinv, direction, _bmm, refine=False)
        return tuple(tuple(v.to(dtype) for v in x) if isinstance(x, tuple)
                     else x.to(dtype) for x in out)

    def iter_products_refine(st: IPMState, ev: EvalOut):
        """float32-factorization / float64-assembly Mehrotra pass (the JAX
        package's "refine" tier, with the fused or the non-fused
        direction).

        Factor-class work (Cholesky, triangular inverse, W features, Schur
        Gram, step-rule congruences and probes) runs in float32.
        Everything whose ACCURACY the Newton step depends on near
        convergence stays float64: the corrector targets (X S products at
        size ~mu), the right-hand side from the carried float64 residuals,
        the dS/dX recoveries, and the Schur solve — refined to float64
        accuracy by ``schur_refine`` passes of (float64 residual matvec ->
        float32 back-solve) against the float32 feature Gram plus
        regularization.  The exact contractions are ``mm_f64``,
        ``short64`` and ``long64`` (the df32 kernels, or their plain
        versions); with ``use_fused`` the direction's assembly, Schur solve
        and recovery are the three kernels of ``ops/fused.py``."""
        f32 = torch.float32
        X32 = tuple(st.X[t].to(f32) for t in bidx)

        def chol_inv(t):
            Kt = X32[t].shape[1]
            both = torch.cat([X32[t], st.S[t].to(f32)], dim=1)
            # Jacobi equilibration before the float32 factorization: any
            # factor basis serves the congruences downstream, so factor
            # D B D (cond(DBD) << cond(B)) and fold D into the returned
            # inverse factor.  A float32 NaN here is repaired by the nan32
            # float64 iteration in body().
            dg = torch.sqrt(torch.clamp_min(
                torch.diagonal(both, dim1=-2, dim2=-1), 1e-30))
            dinv = 1.0 / dg
            scaled = both * dinv[..., :, None] * dinv[..., None, :]
            Linv = (_tril_inv(_chol(scaled, settings), settings)
                    * dinv[..., None, :])
            return Linv[:, :Kt], Linv[:, Kt:]

        LXS = [chol_inv(t) for t in bidx]
        Lxinv = tuple(v[0] for v in LXS)
        Lsinv = tuple(v[1] for v in LXS)
        # S^-1 is float32-VALUED (a preconditioner-quality inverse), upcast
        # exactly: exactness is only needed in the cancelling products
        Sinv32 = tuple(sym(torch.einsum("xkba,xkbc->xkac", Lsinv[t],
                                        Lsinv[t])) for t in bidx)
        if not use_fused:
            # bmm64 reads the float32 S^-1 as it is; its plain version
            # would upcast it at every product, so it gets one exact upcast
            Sinv_mm = Sinv32 if mm_f64 is df32.bmm64 else tuple(
                Sinv32[t].to(dtype) for t in bidx)

        def astar_f64(P):
            """sum_t einsum('kjab,xkba->xj', A_t, P_t)."""
            return _bsum([back(t, long64(
                A_flat[t], P[t].transpose(-1, -2).reshape(B, -1)))
                for t in bidx])

        def aapply_f64(dy):
            """einsum('kjab,xj->xkab', A_t, dy) per bucket."""
            return tuple(short64(A_flat[t], into(t, dy)).reshape(
                (B, data.A[t].shape[0]) + data.A[t].shape[2:]) for t in bidx)

        # W features + Schur Gram in float32.  W_j = Lx^T A_j Ls^{-T} with
        # Lx^T = Lxinv X (exactly, as X = Lx Lx^T): no second factor.
        def wfeat(t):
            LxT = torch.einsum("xkab,xkbc->xkac", Lxinv[t], X32[t])
            return _wfeat_flat(LxT.transpose(-1, -2), A32[t], Lsinv[t], B, mp)

        wl64 = torch.where(pre.rowmask, st.xl / st.sl, 0.0)
        wlb64 = torch.where(pre.lbmask, st.xlb / st.slb, 0.0)
        wub64 = torch.where(pre.ubmask, st.xub / st.sub, 0.0)
        Wg = torch.sqrt(wl64).to(f32)[:, :, None] * G32
        Wall = torch.cat([back(t, wfeat(t)) for t in bidx]
                         + [Wg.transpose(1, 2)], dim=2)
        M = _schur_product(Wall, settings)
        eye32 = eye_mp.to(f32)
        M = M + (wlb64 + wub64).to(f32)[:, :, None] * eye32[None]
        M = torch.where(free_outer, M, 0.0)
        M = M + pre.fix.to(f32)[:, :, None] * eye32[None]
        # float32-safe regularization: the factor is only a preconditioner
        # (the refinement target includes the same shift, so the system
        # solved is the proximally regularized Newton system)
        reg = max(settings.chol_reg, 1e-7) * (
            1.0 + torch.amax(M.abs(), dim=(1, 2)))
        M = M + reg[:, None, None] * eye32[None]
        # Jacobi equilibration: near convergence the Schur diagonal spans
        # many orders of magnitude, and cond(D M D) << cond(M) keeps the
        # float32-preconditioned refinement contracting
        dsc = 1.0 / torch.sqrt(torch.clamp_min(
            torch.diagonal(M, dim1=1, dim2=2), 1e-30))
        Ms = M * dsc[:, :, None] * dsc[:, None, :]
        Lminv = _tril_inv(_chol(Ms, settings), settings)
        Minv = torch.einsum("xba,xbc->xac", Lminv, Lminv)
        dsc64 = dsc.to(dtype)
        diag64 = wlb64 + wub64
        reg64 = reg.to(dtype)

        def mv_M(vf):
            """(W W^T + diag + reg I) vf in float64 on the float32 features."""
            wt = short64(Wall, vf)
            return long64(Wall, wt) + diag64 * vf + reg64[:, None] * vf

        def precond(r64):
            """float32 back-solve through the equilibrated factor."""
            v = (dsc64 * r64).to(f32)
            return dsc64 * torch.einsum("xij,xj->xi", Minv, v).to(dtype)

        def schur_solve(rhs):
            """(M + reg I) dy = rhs to float64 accuracy: float32
            preconditioned solve + float64 residual refinement against the
            exact Gram of the float32 features."""
            rhsf = torch.where(pre.fix, 0.0, rhs)
            dy = precond(rhsf)
            for _ in range(max(int(settings.schur_refine), 0)):
                vf = torch.where(pre.fix, 0.0, dy)
                r = rhsf - torch.where(pre.fix, 0.0, mv_M(vf))
                dy = dy + precond(r)
            return torch.where(pre.fix, 0.0, dy)

        # X Rp is direction-independent: hoisted out of direction()
        XRp = tuple(mm_f64(st.X[t], ev.Rp[t]) for t in bidx)
        if use_fused:
            # the fused kernels' other direction-independent operand
            reg_b = reg64[:, None].expand(B, mp).contiguous()
            nrefine = max(int(settings.schur_refine), 0)

        def direction_fused(Rc, rcl, rclb, rcub):
            """Newton direction through the fused kernels (JAX
            ``direction_fused``): per bucket ONE rhs assembly and ONE
            recovery, plus ONE Schur solve with its refinement passes —
            the math of the non-fused direction below.  The recovery
            zeroes the padding of dS and dX itself."""
            rhs_sdp = _bsum([back(t, fused.rhs_bucket(
                data.A[t], Rc[t], XRp[t], Sinv32[t])) for t in bidx])
            rhs = lp_rhs(st, ev, rhs_sdp, lambda w: long64(GallT, w),
                         rcl, rclb, rcub)
            dy = fused.schur_solve_fused(
                Wall, torch.where(pre.fix, 0.0, rhs), Minv, dsc64, diag64,
                reg_b, pre.fix, nrefine)
            dS, dX = [], []
            for t in bidx:
                dSt, dXt = fused.recover_bucket(
                    data.A[t], into(t, dy), ev.Rp[t], Rc[t], st.X[t],
                    Sinv32[t], pad_outer[t])
                dS.append(dSt)
                dX.append(sym(dXt))
            dxl, dsl, dxlb, dslb, dxub, dsub = lp_recover(
                st, ev, dy, long64(Gall_c, dy), rcl, rclb, rcub)
            return dy, tuple(dX), tuple(dS), dxl, dsl, dxlb, dslb, dxub, dsub

        def direction(Rc, rcl, rclb, rcub):
            """Newton direction with exact assembly and recovery (float64
            in and out; only the Schur back-solve passes through
            float32)."""
            if use_fused:
                return direction_fused(Rc, rcl, rclb, rcub)
            PsiSinv = [mm_f64(Rc[t] - XRp[t], Sinv_mm[t]) for t in bidx]
            rhs = lp_rhs(st, ev, astar_f64(PsiSinv),
                         lambda w: long64(GallT, w), rcl, rclb, rcub)
            dy = schur_solve(torch.where(pre.fix, 0.0, rhs))
            dSr = aapply_f64(dy)
            dS = tuple(torch.where(pad_outer[t], dSr[t] + ev.Rp[t], 0.0)
                       for t in bidx)
            # the dX recovery stays exact: the recovered primal must track
            # the size-mu complementarity targets
            dX = tuple(torch.where(pad_outer[t], sym(mm_f64(
                Rc[t] - mm_f64(st.X[t], dS[t]), Sinv_mm[t])), 0.0)
                for t in bidx)
            dxl, dsl, dxlb, dslb, dxub, dsub = lp_recover(
                st, ev, dy, long64(Gall_c, dy), rcl, rclb, rcub)
            return dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub

        return mehrotra(st, ev, Lxinv, Lsinv, direction, mm_f64, refine=True)

    def body(st: IPMState, ev: EvalOut, use32: bool):
        if not use32:
            prods = iter_products(st, ev, dtype)
        else:
            with _full_f32_matmul():
                prods = (iter_products_refine(st, ev) if use_refine
                         else iter_products(st, ev, torch.float32))
        dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub, ap, ad = prods

        # freeze finished instances; detect numerical failure (NaN)
        bad = torch.isnan(dy).any(dim=1) | torch.isnan(ap) | torch.isnan(ad)
        for t in bidx:
            bad = bad | back(t, torch.isnan(dX[t]).any(dim=-1).any(dim=-1)
                             .any(dim=-1))
        nan32 = st.nan32
        if use_phase32 and settings.nan32_policy != "fail":
            # a NaN from a float32 tier is a PRECISION failure, not a solve
            # failure: skip the update and run the next iteration in
            # float64.  A one-iteration repair: nan32 clears after every
            # float64 iteration, so the batch drops back to the tier.
            if use32:
                failed = st.failed
                nan32 = st.nan32 | (bad & ~st.done)
            else:
                failed = st.failed | (bad & ~st.done)
                nan32 = torch.zeros_like(st.nan32)
        else:
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
        steps = [(*into(t, a1x, a2x), into(t, actx)) for t in bidx]

        def updm(old, d, a, keep):
            return torch.where(keep, old + a * d, old)

        def updv(old, d, a):
            return torch.where(actv, old + a * d, old)

        new = st._replace(
            y=updv(st.y, dy, a2),
            X=tuple(updm(st.X[t], dX[t], steps[t][0], steps[t][2])
                    for t in bidx),
            S=tuple(updm(st.S[t], dS[t], steps[t][1], steps[t][2])
                    for t in bidx),
            xl=updv(st.xl, dxl, a1),
            sl=updv(st.sl, dsl, a2),
            xlb=updv(st.xlb, dxlb, a1),
            slb=updv(st.slb, dslb, a2),
            xub=updv(st.xub, dxub, a1),
            sub=updv(st.sub, dsub, a2),
            it=st.it + 1,
            failed=failed,
            nan32=nan32,
        )
        ev_n = evaluate(new)
        conv = ev_n.conv
        # stall detection: instances making no progress burn the whole
        # batch's wall clock (the loop runs until ALL are done) — declare
        # them failed early and let the recovery ladder handle them.  The
        # merit's gap is relative to the objective without the penalty
        # term (the same as the relative gap where the penalty variable is
        # fixed at 0): while r is large Gamma r inflates |dobj|, the first
        # iterates' relative gap reads small, and a penalty solve that is
        # converging reads as stalled
        yh_n = torch.where(pre.fix, pre.fixval, new.y)
        dobj_n = (b * yh_n).sum(dim=1) - b[:, -1] * yh_n[:, -1]
        merit = ev_n.gap / (1.0 + dobj_n.abs()) + ev_n.pinf + ev_n.dinf
        improved = merit < settings.stall_factor * new.best_merit
        best_merit = torch.where(improved, merit, new.best_merit)
        stall_cnt = torch.where(improved | new.done, 0, new.stall + 1)
        stalled = stall_cnt >= settings.stall_window
        esc = new.esc
        if use_phase32:
            # fast->stable escalation (sdpisolver_sdpa.cpp:1416-1441 role):
            # an instance stalling in a float32 tier moves to float64
            # (sticky via esc) with a fresh stall budget; only a SECOND
            # stall, in float64, fails it
            esc_now = stalled & ~new.done & ~conv & ~new.esc
            stalled = stalled & ~esc_now
            stall_cnt = torch.where(esc_now, 0, stall_cnt)
            esc = new.esc | esc_now
        failed2 = new.failed | (stalled & ~new.done & ~conv)
        newly_conv = conv & ~new.done & ~failed2
        st_out = new._replace(
            converged=new.converged | newly_conv,
            done=new.done | newly_conv | failed2,
            failed=failed2,
            best_merit=best_merit,
            stall=stall_cnt,
            esc=esc,
        )
        return st_out, ev_n

    # the float32 tiers' hand-over to float64 (JAX ipm.py:1704-1724)
    switch = (settings.phase32_switch if settings.phase32 == "on"
              else settings.refine_switch)

    def tier32(st: IPMState, ev: EvalOut) -> torch.Tensor:
        """A float32 tier's choice for the next iteration, on the device:
        float32 while every active instance's relative gap is above the
        switch and none of them needs the nan32 repair or has
        escalated."""
        active = ~st.done
        return (((ev.relgap > switch) | st.done).all()
                & ~(st.nan32 & active).any() & ~(st.esc & active).any())

    def flags_of(st: IPMState, ev: EvalOut) -> torch.Tensor:
        """What lockstep reads before an iteration: the batch's done mask
        reduced to one flag, and in a float32 tier the choice of tier."""
        return (torch.stack([st.done.all(), tier32(st, ev)]) if use_phase32
                else st.done.all().reshape(1))

    # pre-optimal snapshot: the first iterate of each instance whose
    # relative gap fell below preopt_gap (updated on the device), carried
    # in ``aux`` as (y_pre, X_pre, has_pre)
    track_pre = settings.preopt_gap > 0.0

    def step(st: IPMState, ev: EvalOut, aux, use32: bool):
        """One iteration: the next state, residuals and snapshot."""
        was_done = st.done
        st, ev = body(st, ev, use32)
        if track_pre:
            y_pre, X_pre, has_pre = aux
            hit = ~has_pre & ~was_done & (ev.relgap <= settings.preopt_gap)
            aux = (torch.where(hit[:, None], st.y, y_pre),
                   tuple(torch.where(into(t, hit[:, None, None, None]),
                                     st.X[t], X_pre[t]) for t in bidx),
                   has_pre | hit)
        return st, ev, aux

    def in_place(st: IPMState, ev: EvalOut, aux, use32: bool):
        """:func:`step` over a CUDA graph key's buffers (``st``, ``ev`` and
        ``aux`` are them), the result copied into them; returns the
        flags."""
        graphs.copy_into(graphs.leaves((st, ev, aux)),
                         graphs.leaves(step(st, ev, aux, use32)))
        return flags_of(st, ev)

    st, ev = st0, evaluate(st0)
    aux = ((st0.y, st0.X, torch.zeros((B,), dtype=torch.bool, device=dev))
           if track_pre else ())
    f64_iters = 0
    # on one CUDA device the iteration is replayed as CUDA graphs over the
    # key's buffers once the key has run eagerly (ops/graphs.py)
    entry = graphs.lookup(data, settings, B, Gall.shape[1],
                          gaptol_vec is not None, feastol_vec is not None,
                          Gcut is not None)
    held = entry is not None and entry.acquire()
    bound = False       # the solve's operands are the key's
    on_keys = False     # st, ev and aux are the key's buffers
    flags = None        # the flags a replay left
    setup.end()
    try:
        while st.it < settings.max_iters:
            # lockstep reads these once per iteration: the batch's done
            # mask, and in a float32 tier the choice of tier in the same
            # transfer
            all_done, use32 = yield (flags if flags is not None
                                     else flags_of(st, ev))
            if all_done:
                break
            mode = entry.mode(use32) if held else "eager"
            # issuing one iteration; the span ends before the next yield
            with trace.span("ipm.iter", it=st.it, use32=use32, graph=mode):
                f64_iters += not use32
                flags = None
                if mode != "eager":
                    if not bound:
                        # the closures below read these names: from here
                        # on they are the key's static operands
                        (b, Gall, hall, pre, gaptol, ftv, nu, normb,
                         datascale, free_outer, pad_outer, eyen, eye_act,
                         eye_act32, eye_mp, A32, G32, A_flat, Gall_c,
                         GallT) = entry.bind(
                            (b, Gall, hall, pre, gaptol, ftv, nu, normb,
                             datascale, free_outer, pad_outer, eyen, eye_act,
                             eye_act32, eye_mp, A32, G32, A_flat, Gall_c,
                             GallT))
                        bound = True
                    if not on_keys:
                        st, ev, aux = entry.load((st, ev, aux))
                        on_keys = True
                    flags = entry.run(use32, functools.partial(
                        in_place, st, ev, aux, use32))
                if flags is None:
                    st, ev, aux = step(st, ev, aux, use32)
                    on_keys = False
                    if entry is not None:
                        entry.warm.add(use32)
                else:
                    st = st._replace(it=st.it + 1)
    finally:
        if held:
            entry.release()
    if on_keys:
        # the key's buffers are the next solve's: what is returned from
        # them is copied out
        kept = (st.X, st.xl, st.xlb, st.xub, ev.gap, ev.pinf, ev.dinf,
                aux[1:])
        X, xl, xlb, xub, gap, pinf, dinf, pre_out = graphs.rebuild(
            kept, iter(graphs.copies(graphs.leaves(kept))))
        st = st._replace(X=X, xl=xl, xlb=xlb, xub=xub)
        ev = ev._replace(gap=gap, pinf=pinf, dinf=dinf)
        aux = aux[:1] + pre_out
    y_pre, X_pre, has_pre = aux if track_pre else (None, None, None)
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
        f64_iters=f64_iters,
        y_pre=(torch.where(pre.fix, pre.fixval, y_pre) if track_pre
               else None),
        X_pre=X_pre if track_pre else None,
        has_pre=has_pre if track_pre else None,
    )


def lockstep(steppers, combine):
    """Advance :func:`ipm_steps` generators together.  Every iteration
    ``combine`` reduces their flags to one tensor, read on the host ONCE
    (the iteration's one host sync, whatever the number of steppers), and
    each stepper is sent the global ``(all_done, use32)``.  The steppers
    stop together (they share ``max_iters`` and the flags); returns their
    SolveOutputs in order.  The call is one request: one ``ipm.solve``
    span, however many steppers."""
    with trace.span(trace.SOLVE, steppers=len(steppers)):
        msg = None
        while True:
            flags, outs = [], []
            for s in steppers:
                try:
                    flags.append(s.send(msg))
                except StopIteration as stop:
                    outs.append(stop.value)
            if outs:
                if flags:
                    raise RuntimeError("lockstep: steppers stopped apart")
                return outs
            # host read: the flags
            vals = trace.sync("flags", combine(flags).tolist)
            msg = (bool(vals[0]), len(vals) > 1 and bool(vals[1]))


def ipm_solve(
    data: IPMData,
    b,                    # (B, mp) objective incl. penalty coefficient
    lb,                   # (B, mp)
    ub,                   # (B, mp)
    Gcut=None,            # (B, q, mp) per-node cut rows  Gcut y >= hcut
    hcut=None,            # (B, q)
    cutvalid=None,        # (B, q) bool
    warm_y=None,          # (B, mp) parent dual solution (warm start)
    warm_mask=None,       # (B,) bool: rows with a valid warm_y
    gaptol_vec=None,      # (B,) per-instance gap tolerance
    warm_X=None,          # per-bucket (B, K_t, n, n) parent primal blocks
    ip_point=None,        # (y_ip (mp,), per-bucket X_ip (K_t, n, n)):
                          # root analytic centres, the warm start's
                          # interior target instead of the scaled identity
    feastol_vec=None,     # (B,) per-instance CONVERGENCE feastol override
    *,
    settings: IPMSettings,
) -> SolveOutput:
    """Solve a batch of SDPs on ``data``'s device.  Array arguments may be
    tensors or numpy arrays; they are moved to that device in float64.

    ``settings.phase32``: "off" runs every iteration in float64; "on"
    runs an iteration wholly in float32 while every active relative gap is
    above ``phase32_switch``, "lite" the same above ``refine_switch`` with
    the Schur solve polished by ``schur_refine`` float64 residual passes;
    "refine" runs the JAX package's refine tier from the first iteration —
    float32 factors, float64 assembly, ``schur_refine`` refinement passes —
    and an iteration in float64 below ``refine_switch``.  In every float32
    tier an iteration runs in float64 after a float32 NaN
    (``nan32_policy="repair"``) or for an instance that stalled in the
    tier.  ``use_pallas`` sends the float32 Cholesky factors, triangular
    inverses and Schur Gram to the kernels of ``ops/kernels.py`` (their
    plain versions on CPU tensors); float64 operands stay on the library.
    The refine tier's exact contractions go through the ``ops/df32.py``
    kernels unless ``use_df32="off"`` (their plain versions; either way on
    CPU tensors).  With ``use_df32`` not "off", ``fused_direction`` "auto" or
    "on" runs the tier's Newton direction through the three fused kernels
    of ``ops/fused.py`` (plain versions on CPU tensors), "off" through the
    separate contractions; outside the refine tier it is inert, as in JAX.

    ``warm_y`` (with ``warm_mask``) projects the parent's dual point into
    each child's box with a strict-interior margin, floors its slack on
    the PSD cone and convex-combines it with an interior target (the
    scaled identity, or ``ip_point``'s analytic centres);
    ``warm_X`` does the same for the primal blocks (JAX ipm.py:523-600).
    ``settings.preopt_gap > 0`` also returns the first iterate whose
    relative gap fell below it (``y_pre``, ``X_pre``, ``has_pre``).
    """
    return lockstep([ipm_steps(data, b, lb, ub, Gcut, hcut, cutvalid, warm_y,
                               warm_mask, gaptol_vec, warm_X, ip_point,
                               feastol_vec, settings=settings)],
                    lambda flags: flags[0])[0]
