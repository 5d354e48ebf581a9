"""Solver-independent SDP interface with the recovery ladder (PyTorch).

Counterpart of ``scipsdp_tpu/core/sdpi.py``, the analog of the reference
SDPI (src/sdpi/sdpi.c): wraps the batched IPM (``ops/ipm.py``) behind a
host-side API and implements the layered failure recovery of
``SCIPsdpiSolve`` (sdpi.c:3399-3599):

1. direct solve (penalty variable fixed to 0), optionally together with
   the fractional and randomized rounding heuristics;
2. for failed instances, the *feasibility probe*: penalty formulation with
   Gamma = 1 and zeroed objective; an optimal r above
   ``peninfeasadjust * max(feastol, gaptol)`` proves dual infeasibility;
3. penalty rescue solves with Gamma escalating from ``penaltyparam``
   toward ``maxpenaltyparam`` and gaptol shrinking toward ``min_gaptol``,
   first as one speculative solve of clones at several (Gamma, gaptol)
   tiers in the free batch slots, then serially; a converged rescue with
   r <= feastol is feasible for the original problem, otherwise its
   objective is still a valid lower bound (BOUND_ONLY);
4. a Farkas-style box bound from the primal iterate, then a *box rescue*
   replacing infinite bounds by a large box (a converged box solve with an
   artificial bound active proves dual unboundedness);

then an independent check of every OPTIMAL point, with feastol-tightened
re-solves of the points that fail it.

Every rung is one batched ``ipm_solve`` over the whole batch on the
interface's device (decided instances get a conflict box, which the IPM's
presolve retires at once).  Between rungs the ladder is host numpy: each
rung's outputs come to the host in ONE device-to-host transfer
(:func:`to_host`), and its inputs go to the device in one host-to-device
copy.  The interface runs on the card unless it is given
``device="cpu"``; it never falls back to the CPU on its own.  With a
device mesh every rung is that batch solved over the mesh
(``parallel/mesh.py``); the host side stays on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Optional

import numpy as np
import torch

from scipsdp_tpu_torch.models.problem import INF, DenseSDPData
from scipsdp_tpu_torch.ops.eigen import cholesky
from scipsdp_tpu_torch.ops.ipm import IPMData, build_ipm_data, ipm_solve
from scipsdp_tpu_torch.parallel.mesh import ShardedIPM
from scipsdp_tpu_torch.utils.config import Settings, resolve_backend_autos
from scipsdp_tpu_torch.utils.status import SolverResultStatus

BOX_BOUND = 1e7       # artificial box for unboundedness detection
BOX_ACTIVE_TOL = 0.99  # |y| >= BOX_ACTIVE_TOL * BOX_BOUND counts as active

# statuses with no usable bound: the recovery ladder keeps escalating these
_UNSOLVED_CODES = (int(SolverResultStatus.FAILED),
                   int(SolverResultStatus.ITERLIMIT),
                   int(SolverResultStatus.TIMELIMIT))


@dataclasses.dataclass
class BatchSolveResult:
    """Per-instance outcome of one batched relaxation solve (numpy)."""

    status: np.ndarray    # (B,) SolverResultStatus values
    objval: np.ndarray    # (B,) optimal value / valid lower bound (BOUND_ONLY)
    y: np.ndarray         # (B, m) dual solution (original variables)
    X: list               # per bucket (B, K_t, n_t, n_t) primal SDP blocks
    xl: np.ndarray        # (B, p) primal LP-row multipliers
    xlb: np.ndarray       # (B, m) primal lower-bound multipliers
    xub: np.ndarray       # (B, m) primal upper-bound multipliers
    iters: int            # IPM iterations of the direct solve
    nsolves: int          # total batched solver invocations used
    npenalty: int         # instances decided via penalty formulation
    nunsolved: int        # instances with no usable information
    ndirect: int = 0      # instances decided at the direct rung
    # rounding-heuristic results (when solve_batch got a seed)
    round_y: Optional[np.ndarray] = None     # (B, m) best rounded points
    round_feas: Optional[np.ndarray] = None  # (B,) feasibility flags
    round_val: Optional[np.ndarray] = None   # (B,) objective values
    # per-instance settings tier that decided the instance via the penalty
    # ladder: (B, 2) [Gamma, gaptol], NaN rows for direct solves
    # (cons_savedsdpsettings role: children inherit the parent's tier)
    tier: Optional[np.ndarray] = None
    # pre-optimal iterate of the direct solve (warmstartpreoptsol)
    pre_y: Optional[np.ndarray] = None   # (B, m)
    pre_X: Optional[list] = None         # per-bucket (B, K, n, n)
    pre_has: Optional[np.ndarray] = None  # (B,)


def to_host(out, *extra) -> tuple:
    """(``out`` with numpy fields, ``extra`` as numpy) from a SolveOutput
    whose fields are tensors or numpy arrays (tuples of them for the
    per-bucket blocks), and further tensors.  The tensors come back in
    ONE transfer: packed into one float64 buffer on their device (exact
    for the solver's float64, int32 and bool outputs) and unpacked on the
    host."""
    leaves, shape = [], []
    for v in (*out, *extra):
        if isinstance(v, tuple):
            shape.append(len(v))
            leaves.extend(v)
        else:
            shape.append(None)
            leaves.append(v)
    dev = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
    if dev:
        flat = torch.cat([leaves[i].reshape(-1).to(torch.float64)
                          for i in dev]).cpu()
        parts = flat.split([leaves[i].numel() for i in dev])
        for i, part in zip(dev, parts):
            leaves[i] = part.view(leaves[i].shape).to(leaves[i].dtype)
    leaves = [v.numpy() if isinstance(v, torch.Tensor) else v for v in leaves]
    vals, pos = [], 0
    for n in shape:
        vals.append(leaves[pos] if n is None else tuple(leaves[pos:pos + n]))
        pos += 1 if n is None else n
    return (type(out)(*vals[:len(out)]), *vals[len(out):])


def _to_device(values, device) -> list:
    """The numpy arrays among ``values`` as tensors on ``device`` (float64,
    bool for bool arrays) in ONE host-to-device copy; other values as
    they are."""
    values = list(values)
    idx = [i for i, v in enumerate(values) if isinstance(v, np.ndarray)]
    if not idx:
        return values
    flat = torch.from_numpy(np.concatenate(
        [values[i].astype(np.float64).ravel() for i in idx])).to(device)
    for i, part in zip(idx, flat.split([values[i].size for i in idx])):
        dt = torch.bool if values[i].dtype == bool else torch.float64
        values[i] = part.view(values[i].shape).to(dt)
    return values


def psd_probe(data: IPMData, yx: torch.Tensor, feastol: float):
    """(B,) bool: Z(yx) + feastol*I positive definite on every block, by a
    float32 Cholesky (NaN = not PSD): the accept / reject decision of
    lambda_min >= -feastol (cons_sdp.c:672) without an eigendecomposition.
    ``yx``: (B, m + 1) points with the penalty variable."""
    ok = torch.ones((yx.shape[0],), dtype=torch.bool, device=yx.device)
    for t in range(data.nbuckets):
        Z = torch.einsum("kjab,xj->xkab", data.A[t], yx) - data.C[t][None]
        dm = data.dimmask[t]
        outer = dm[:, :, None] & dm[:, None, :]
        eye = torch.eye(Z.shape[-1], dtype=Z.dtype, device=Z.device)
        L = cholesky(torch.where(outer[None], Z + feastol * eye, eye)
                     .to(torch.float32))
        ok = ok & ~torch.isnan(L).flatten(1).any(dim=1)
    return ok


def solve_and_round(data: IPMData, ipms, feastol: float,
                    integral: torch.Tensor, indicator_pairs: np.ndarray,
                    b, lb, ub, generator: torch.Generator, cuts=None,
                    warm_y=None, warm_mask=None, gaptol_vec=None,
                    warm_X=None, ip_point=None, use_frac: bool = True,
                    use_rand: bool = True, solve=ipm_solve):
    """One ``ipm_solve`` (``solve``: or a solve of its signature, such as
    ``parallel/mesh.ShardedIPM``) and the rounding heuristics on its solution
    (heur_sdpfracround.c, heur_sdprand.c), on ``data``'s device: the
    fractional candidate rounds every integral coordinate, the randomized
    one rounds it up with probability equal to its fractional part (a
    uniform draw from ``generator``).  Each candidate is clipped to the
    box, indicator pairs are applied, and it is checked against the SDP
    blocks (a float32 Cholesky of Z(y) + feastol I, NaN = not PSD), the LP
    and cut rows and integrality.  ``use_frac``/``use_rand`` gate the two
    heuristics.  Returns (SolveOutput, best rounded y (B, m), feasible
    (B,), objective (B,)), all on the device."""
    Gcut, hcut, cvalid = (None, None, None) if cuts is None else cuts
    out = solve(data, b, lb, ub, Gcut, hcut, cvalid, warm_y, warm_mask,
                gaptol_vec, warm_X, ip_point, settings=ipms)
    dev, f64 = data.device, torch.float64
    m = data.nvars
    lb = torch.as_tensor(lb, dtype=f64, device=dev)[:, :m]
    ub = torch.as_tensor(ub, dtype=f64, device=dev)[:, :m]
    if Gcut is not None:
        Gcut = torch.as_tensor(Gcut, dtype=f64, device=dev)
        hcut = torch.as_tensor(hcut, dtype=f64, device=dev)
        cvalid = torch.as_tensor(cvalid, dtype=torch.bool, device=dev)
    y = out.y[:, :m]
    B = y.shape[0]

    def finish(yc):
        yc = torch.clamp(yc, lb, ub)
        for bi, si in indicator_pairs:
            yc[:, si] = torch.where(yc[:, bi] >= 0.5, 0.0, yc[:, si])
        yx = torch.cat([yc, yc.new_zeros((B, 1))], dim=1)
        ok = psd_probe(data, yx, feastol)
        Gy = torch.einsum("pm,xm->xp", data.G, yx)
        ok = ok & (Gy >= data.h[None] - feastol).all(dim=1)
        if Gcut is not None:
            Gcy = torch.einsum("xqm,xm->xq", Gcut[:, :, :m], yc)
            ok = ok & torch.where(cvalid, Gcy >= hcut - feastol,
                                  True).all(dim=1)
        # clipping against fractional bounds may destroy integrality
        frac_c = torch.where(integral[None], (yc - torch.round(yc)).abs(),
                             0.0)
        ok = ok & (frac_c.amax(dim=1) <= feastol)
        return yc, ok, (yc * data.b_base[None, :m]).sum(dim=1)

    y0 = torch.where(integral[None], torch.round(y), y)
    frac = y - torch.floor(y)
    rnd = torch.rand(frac.shape, generator=generator, dtype=f64, device=dev)
    y1 = torch.where(integral[None], torch.floor(y) + (rnd < frac).to(f64), y)
    y0c, f0, v0 = finish(y0)
    y1c, f1, v1 = finish(y1)
    if not use_frac:
        f0 = torch.zeros_like(f0)
    if not use_rand:
        f1 = torch.zeros_like(f1)
    use1 = f1 & (~f0 | (v1 < v0))
    yr = torch.where(use1[:, None], y1c, y0c)
    return out, yr, f0 | f1, torch.where(use1, v1, v0)


class SDPInterface:
    """Batched SDP relaxation solver for one problem's data.

    Per-call inputs are only the per-node variable bounds (and optionally a
    per-node objective, cut rows and warm starts), matching how B&B node
    relaxations differ.  ``device=None`` means the CUDA card; without one
    the constructor raises unless ``device="cpu"`` is given.  With a
    ``mesh`` (``parallel/mesh.py``) the interface lives on the mesh's first
    device and every rung's batch is solved sharded over the mesh
    (``ShardedIPM``): the batch must be a multiple of its nodes axis.
    """

    _ip_point = None

    def __init__(self, dense: DenseSDPData, settings: Optional[Settings] = None,
                 indicator_pairs=None, mesh=None, lp_host: bool = False,
                 device=None):
        if mesh is not None:
            device = mesh.devices.flat[0]
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SDPInterface: no CUDA device; pass device='cpu' to solve "
                "on the CPU")
        self.settings = resolve_backend_autos(settings or Settings(),
                                              self.device)
        if self.settings.ipm.mixed_precision == "on":
            raise NotImplementedError(
                "SDPInterface: mixed_precision='on' needs the dtype='float32' "
                "solve, which the JAX reference itself cannot run (NameError)")
        bb = self.settings.bb
        if (bb.warmstart and bb.warmstartpreoptsol
                and self.settings.ipm.preopt_gap == 0.0):
            # pre-optimal warmstart capture (sdpisolver_sdpa.cpp:1612-1618)
            self.settings = dataclasses.replace(
                self.settings,
                ipm=dataclasses.replace(self.settings.ipm,
                                        preopt_gap=bb.warmstartpreoptgap))
        self.dense = dense
        # LP-outer-approximation mode: node relaxations on the host
        # simplex (see _solve_batch_lp_host)
        self.lp_host = lp_host and len(dense.blocksizes) == 0
        self.data: IPMData = build_ipm_data(dense, self.device)
        # every rung's solve: on the device, or sharded over the mesh
        self._ipm = (ipm_solve if mesh is None
                     else ShardedIPM(self.data, mesh))
        self.m = dense.nvars
        self._indicator_pairs = (
            np.asarray(indicator_pairs, dtype=np.int32).reshape(-1, 2)
            if indicator_pairs is not None and len(indicator_pairs)
            else np.zeros((0, 2), np.int32))
        self._integral = torch.as_tensor(np.asarray(dense.integral, bool),
                                         device=self.device)
        # the static data on the host, for the host-side rungs
        self._np_data = (
            [a.cpu().numpy() for a in self.data.A],
            [c.cpu().numpy() for c in self.data.C],
            [d.cpu().numpy() for d in self.data.dimmask],
            self.data.G.cpu().numpy(),
            self.data.h.cpu().numpy(),
            self.data.b_base.cpu().numpy(),
        )
        # statistics (the relaxator's counters, relax_sdp.c:166-235)
        self.stat_nsolves = 0
        self.stat_iterations = 0
        self.stat_npenalty = 0
        self.stat_nprobes = 0
        self.stat_nunsolved = 0
        self.stat_nonevar = 0   # instances decided by the one-var solver
        self.stat_nveri_resolve = 0  # feastol-tightened re-solve rungs

    # -- helpers -----------------------------------------------------------

    def _extend(self, arr: np.ndarray, val: float) -> np.ndarray:
        B = arr.shape[0]
        return np.concatenate([arr, np.full((B, 1), val)], axis=1)

    @staticmethod
    def _mask_decided(lbx, ubx, active):
        """Ladder rungs only need the still-failed instances; decided ones
        get a bound conflict so presolve retires them instantly (their
        results are ignored anyway)."""
        lbm = lbx.copy()
        ubm = ubx.copy()
        lbm[~active, :] = 1.0
        ubm[~active, :] = 0.0
        return lbm, ubm

    def set_interior_point(self, y_ip, X_ip) -> None:
        """Install root analytic centers for warmstartiptype=2 convex
        combinations (SCIPrelaxSdpComputeAnalyticCenters role); ``X_ip``
        is a per-bucket tuple of (K_t, n, n) primal center matrices."""
        def tens(x):
            return torch.as_tensor(x, dtype=torch.float64, device=self.device)

        y = tens(y_ip)
        self._ip_point = (torch.cat([y, y.new_zeros(1)]),
                          tuple(tens(x) for x in X_ip))

    def _run(self, b, lb, ub, cuts=None, warm_y=None, warm_mask=None,
             gaptol=None, warm_X=None, feastol_vec=None):
        """One batched ``ipm_solve`` on the interface's device, its numpy
        inputs moved there in one copy; returns the SolveOutput as it
        comes (tensors on the device)."""
        self.stat_nsolves += 1
        if gaptol is None:
            gaptol = np.full(b.shape[0], self.settings.ipm.gaptol)
        Gc, hc, cv = (None, None, None) if cuts is None else cuts
        wX = () if warm_X is None else tuple(warm_X)
        args = _to_device((b, lb, ub, Gc, hc, cv, warm_y, warm_mask,
                           np.asarray(gaptol, np.float64), feastol_vec, *wX),
                          self.device)
        b, lb, ub, Gc, hc, cv, warm_y, warm_mask, gaptol, feastol_vec = \
            args[:10]
        return self._ipm(self.data, b, lb, ub, Gc, hc, cv, warm_y, warm_mask,
                         gaptol, None if warm_X is None else tuple(args[10:]),
                         self._ip_point, feastol_vec,
                         settings=self.settings.ipm)

    def conflict_cuts(self, res: "BatchSolveResult"):
        """Dual-aggregation cuts from the primal certificates
        (computeConflictCut, relax_sdp.c:954-1410): for any X_b >= 0 and
        LP multipliers xl >= 0,

            sum_j (sum_b tr(A_j^b X_b) + xl @ G_j) y_j
                >= sum_b tr(A_0^b X_b) + xl @ h

        holds for every point feasible w.r.t. the SDP blocks and LP rows —
        globally valid.  With the Farkas certificate of an infeasible node
        the row conflicts with that node's box; with a feasible node's
        optimal primal it is a supporting hyperplane.  Returns
        (G (B, m), lhs (B,))."""
        B = res.y.shape[0]
        g = np.zeros((B, self.m))
        lhs = np.zeros(B)
        As, Cs, dms, G, h, _ = self._np_data
        for t, Xt in enumerate(res.X):
            outer = dms[t][:, :, None] & dms[t][:, None, :]
            Xm = np.where(outer[None], np.asarray(Xt), 0.0)
            g += np.einsum("xkab,kjab->xj", Xm, As[t][:, : self.m])
            lhs += np.einsum("xkab,kab->x", Xm, Cs[t])
        if G.shape[0]:
            # only the static LP rows: node-local cut rows are not
            # globally valid, and the aggregation needs no multiplier
            xlp = np.maximum(res.xl[:, : G.shape[0]], 0.0)
            g += xlp @ G[:, : self.m]
            lhs += xlp @ h
        return g, lhs

    def _onevar_prepass(self, lb, ub, bmat, cuts):
        """One-active-variable fast path (sdpi.c:3301-3381): instances
        whose box leaves exactly one variable free are decided exactly by
        the special solver (ops/onevar.py) — LP/cut rows fold into bounds
        on the free variable, each block contributes a feasible interval,
        and the optimum sits at an interval endpoint.  Returns
        (lb', ub', decided) where decided maps instance -> (status,
        objval, y, cert) and decided instances carry a conflict box so the
        batched IPM retires them at the presolve rung (0 iterations).

        ``cert``: optional (block k, eigenvector v) — the active/violated
        eigenvector certificate, placed into the returned primal X so
        conflict-cut aggregation sees the supporting rank-1 witness."""
        from scipsdp_tpu_torch.ops.onevar import (_lam_min_vec,
                                                  feasible_interval,
                                                  solve_one_var_sdp)
        ipms = self.settings.ipm
        feastol = ipms.feastol
        epsfix = max(ipms.epsilon, 1e-12)
        B, m = lb.shape
        dense = self.dense
        decided = {}
        if not ipms.onevar:
            return lb, ub, decided
        free_all = (ub - lb) > epsfix
        nfree = free_all.sum(axis=1)
        cand = np.where((nfree == 1) & ~(lb > ub + feastol).any(axis=1))[0]
        if cand.size == 0:
            return lb, ub, decided
        lb2, ub2 = lb.copy(), ub.copy()
        for i in cand:
            j = int(np.argmax(free_all[i]))
            fixval = 0.5 * (lb[i] + ub[i])
            fixval[j] = 0.0
            glo, ghi = float(lb[i, j]), float(ub[i, j])
            infeas = False
            # fold rows (static LP rows ++ this node's valid cut rows)
            rows = [(dense.G, dense.h)]
            if cuts is not None:
                Gc, hc, cval = cuts
                vrows = np.asarray(cval[i], bool)
                if vrows.any():
                    rows.append((np.asarray(Gc[i])[vrows, :m],
                                 np.asarray(hc[i])[vrows]))
            for Gr, hr in rows:
                if Gr.shape[0] == 0:
                    continue
                const = Gr[:, :m] @ fixval
                gj = Gr[:, j]
                inert = np.abs(gj) < 1e-14
                if np.any(inert & (const < hr - feastol)):
                    infeas = True
                    break
                pos = gj > 1e-14
                neg = gj < -1e-14
                if pos.any():
                    glo = max(glo, float(np.max(
                        (hr[pos] - const[pos]) / gj[pos])))
                if neg.any():
                    ghi = min(ghi, float(np.min(
                        (hr[neg] - const[neg]) / gj[neg])))
            cert = None
            if not infeas and glo > ghi + feastol:
                infeas = True
            if not infeas:
                for k in range(dense.nblocks):
                    nk = int(dense.blocksizes[k])
                    Aj = dense.A[k][j][:nk, :nk]
                    Ceff = (dense.C[k][:nk, :nk]
                            - np.einsum("m,mab->ab", fixval,
                                        dense.A[k][:, :nk, :nk]))
                    iv = feasible_interval(Aj, Ceff, glo, ghi, feastol)
                    if iv is None:
                        stat, _, c_inf = solve_one_var_sdp(
                            Aj, Ceff, 0.0, glo, ghi, feastol,
                            with_certificate=True)
                        cert = (k, c_inf.eigvec)
                        infeas = True
                        break
                    lft, rgt = iv
                    if lft > glo + 1e-12 * max(1.0, abs(lft)):
                        glo = lft
                        cert = (k, _lam_min_vec(lft, Aj, Ceff)[1])
                    if rgt < ghi - 1e-12 * max(1.0, abs(rgt)):
                        ghi = rgt
                        cert = (k, _lam_min_vec(rgt, Aj, Ceff)[1])
                    if glo > ghi + feastol:
                        infeas = True
                        break
            if infeas:
                decided[int(i)] = (int(SolverResultStatus.INFEASIBLE),
                                   np.inf, np.zeros(m), cert)
            else:
                c = float(bmat[i, j])
                if c > 0:
                    ystar = glo
                elif c < 0:
                    ystar = ghi
                else:
                    ystar = glo if np.isfinite(glo) else (
                        ghi if np.isfinite(ghi) else 0.0)
                if not np.isfinite(ystar):
                    decided[int(i)] = (int(SolverResultStatus.UNBOUNDED),
                                       -np.inf, np.zeros(m), None)
                else:
                    yfull = fixval.copy()
                    yfull[j] = ystar
                    objval = float(bmat[i, :m] @ yfull)
                    decided[int(i)] = (int(SolverResultStatus.OPTIMAL),
                                       objval, yfull, cert)
            # conflict box: the IPM retires the slot at the presolve rung
            lb2[i, :] = lb[i]
            ub2[i, :] = ub[i]
            lb2[i, j] = 1.0
            ub2[i, j] = 0.0
            self.stat_nonevar += 1
        return lb2, ub2, decided

    def _apply_onevar(self, decided, status, objval, y, X, xl, xlb, xub):
        """Overwrite the dispatch outputs with the one-var decisions."""
        for i, (st, ov, yi, cert) in decided.items():
            status[i] = st
            objval[i] = ov
            y[i] = yi
            xl[i] = 0.0
            xlb[i] = 0.0
            xub[i] = 0.0
            for t in range(len(X)):
                X[t][i] = 0.0
            if cert is not None:
                k, v = cert
                if v is not None:
                    t, slot = self.data.block_of[k]
                    nk = v.shape[0]
                    X[t][i, slot, :nk, :nk] = np.outer(v, v)

    # -- main entry --------------------------------------------------------

    def _solve_batch_lp_host(self, lb, ub, bmat, cuts, time_limit):
        """LP-mode node relaxations on the host (scipy HiGHS).

        The relaxation is  min b^T y  s.t.  G y >= h (+ cut rows),
        lb <= y <= ub — SCIP's LP relaxation role (the ``none`` back-end
        mode, sdpisolver_none.c).  Returns the same BatchSolveResult
        contract as the IPM path, with HiGHS duals filling the
        bound-multiplier slots (prop_sdpredcost role).
        """
        from scipy.optimize import linprog
        t0 = time.time()
        B = lb.shape[0]
        m = self.m
        As, _, _, G, h, _ = self._np_data
        G = G[:, :m]
        status = np.full((B,), int(SolverResultStatus.FAILED), np.int32)
        objval = np.full((B,), np.inf)
        y = np.zeros((B, m))
        xl_rows = G.shape[0] if cuts is None else G.shape[0] + cuts[0].shape[1]
        xl = np.zeros((B, xl_rows))
        xlb = np.zeros((B, m))
        xub = np.zeros((B, m))
        for i in range(B):
            if np.any(lb[i] > ub[i]):   # conflict/dummy box marker
                status[i] = int(SolverResultStatus.PRESOLVED_INFEASIBLE)
                continue
            A_ub = -G
            b_ub = -h
            if cuts is not None:
                Gc, hc, cval = cuts
                v = np.asarray(cval[i], bool)
                A_ub = np.concatenate([A_ub, -np.asarray(Gc[i, v][:, :m])])
                b_ub = np.concatenate([b_ub, -np.asarray(hc[i, v])])
            bounds = list(zip(
                np.where(lb[i] <= -1e19, -np.inf, lb[i]),
                np.where(ub[i] >= 1e19, np.inf, ub[i])))
            res = linprog(bmat[i, :m], A_ub=A_ub, b_ub=b_ub, bounds=bounds,
                          method="highs")
            if res.status == 0:
                status[i] = int(SolverResultStatus.OPTIMAL)
                objval[i] = float(res.fun)
                y[i] = res.x
                # HiGHS marginals: ineqlin <= 0 for <=-rows at optimum of
                # a min problem; LP-row multipliers are their negatives
                ng = G.shape[0]
                try:
                    mar = -np.asarray(res.ineqlin.marginals)
                    xl[i, :ng] = np.maximum(mar[:ng], 0.0)
                    xlb[i] = np.maximum(np.asarray(res.lower.marginals), 0.0)
                    xub[i] = np.maximum(-np.asarray(res.upper.marginals),
                                        0.0)
                except AttributeError:   # no marginals from this HiGHS run
                    pass
            elif res.status == 2:
                status[i] = int(SolverResultStatus.INFEASIBLE)
            elif res.status == 3:
                status[i] = int(SolverResultStatus.UNBOUNDED)
                objval[i] = -np.inf
            if time_limit is not None and time.time() - t0 > time_limit:
                break
        X = [np.zeros((B, a.shape[0]) + a.shape[2:]) for a in As]
        nun = int(np.sum(status == int(SolverResultStatus.FAILED)))
        return BatchSolveResult(
            status=status, objval=objval, y=y, X=X, xl=xl, xlb=xlb,
            xub=xub, iters=0, nsolves=1, npenalty=0, nunsolved=nun,
            ndirect=int(np.sum(status != int(SolverResultStatus.FAILED))))

    def solve_batch(self, lb: np.ndarray, ub: np.ndarray,
                    obj: Optional[np.ndarray] = None,
                    cuts=None, rounding_seed: Optional[int] = None,
                    warm=None,
                    time_limit: Optional[float] = None,
                    tier: Optional[np.ndarray] = None) -> BatchSolveResult:
        """Solve B node relaxations; lb/ub: (B, m) bounds per node.

        ``cuts``: optional (Gcut (B,q,m), hcut (B,q), valid (B,q)) per-node
        linear cut rows  Gcut y >= hcut  in original variable space; the
        penalty column is 1 (cut rows are relaxed by r like LP rows in the
        penalty formulation, sdpisolver.h:237-245).

        ``rounding_seed``: the direct rung also runs the rounding
        heuristics (:func:`solve_and_round`), with a ``torch.Generator``
        on the interface's device seeded by it.

        ``warm``: (y (B, m), mask (B,)[, per-bucket X]) parent solutions
        the direct rung starts from.

        ``time_limit``: wall-clock budget in seconds for this call; when
        exhausted, remaining recovery-ladder rungs are skipped and still-
        undecided instances get status TIMELIMIT (SCIPsdpiIsTimelimExc
        analog, sdpi.c:3653-4110).

        ``tier``: optional (B, 2) per-instance [Gamma, gaptol] inherited
        from the parent node's successful penalty solve
        (cons_savedsdpsettings, relax_sdp.c:4085-4120): when the direct
        solve fails, the penalty ladder STARTS at the inherited tier
        instead of re-climbing from the bottom.  NaN rows = no inheritance.
        """
        t_start = time.time()

        def out_of_time() -> bool:
            return (time_limit is not None
                    and time.time() - t_start > time_limit)

        ipms = self.settings.ipm
        feastol = ipms.feastol
        B = lb.shape[0]
        m = self.m
        if obj is None:
            bmat = np.tile(self._np_data[5], (B, 1))
        else:
            bmat = self._extend(np.asarray(obj, dtype=np.float64), 0.0)
        if cuts is not None:
            Gc, hc, cval = cuts
            Gc = np.concatenate(
                [Gc, np.ones((B, Gc.shape[1], 1))], axis=2)
            cuts = (Gc, np.asarray(hc, np.float64), np.asarray(cval, bool))

        # pure-LP relaxations (LP outer-approximation mode: no SDP
        # blocks) solve with a HOST dual simplex (scipy HiGHS), as the
        # reference solves its LP relaxations with SCIP's simplex
        if (self.lp_host and self.settings.bb.lp_host_simplex
                and warm is None and rounding_seed is None):
            return self._solve_batch_lp_host(lb, ub, bmat, cuts,
                                             time_limit)

        # one-active-variable fast path (sdpi.c:3301-3381): decided
        # exactly on the host, masked out of the IPM with a conflict box
        lb_eff, ub_eff, onevar = self._onevar_prepass(lb, ub, bmat, cuts)

        # rung 1: direct solve, r fixed at 0 (optionally with the
        # rounding heuristics)
        lbx = self._extend(lb_eff, 0.0)
        ubx = self._extend(ub_eff, 0.0)
        round_y = round_feas = round_val = None
        wy = wm = wX = None
        if warm is not None:
            wy = self._extend(np.asarray(warm[0]), 0.0)
            wm = np.asarray(warm[1], dtype=bool)
            if len(warm) > 2 and warm[2] is not None:
                wX = tuple(warm[2])
        if rounding_seed is not None:
            self.stat_nsolves += 1
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(rounding_seed))
            Gc, hc, cv = (None, None, None) if cuts is None else cuts
            (bd, lbd, ubd, Gc, hc, cv, wyd, wmd, gtd, *wXd) = _to_device(
                (bmat, lbx, ubx, Gc, hc, cv, wy, wm, np.full(B, ipms.gaptol),
                 *(wX or ())), self.device)
            bb = self.settings.bb
            out, round_y, round_feas, round_val = to_host(*solve_and_round(
                self.data, ipms, bb.feastol, self._integral,
                self._indicator_pairs, bd, lbd, ubd, gen,
                None if Gc is None else (Gc, hc, cv), wyd, wmd, gtd,
                None if wX is None else tuple(wXd),
                self._ip_point, use_frac=bb.heuristic_fracround,
                use_rand=bb.heuristic_rand, solve=self._ipm))
        else:
            out = to_host(self._run(bmat, lbx, ubx, cuts, wy, wm,
                                    warm_X=wX))[0]
        self.stat_iterations += int(out.iters)

        pre_y = None if out.y_pre is None else np.asarray(out.y_pre)[:, :m]
        pre_X = None if out.X_pre is None else [np.asarray(x)
                                                 for x in out.X_pre]
        pre_has = None if out.has_pre is None else np.asarray(out.has_pre)
        status = np.asarray(out.status).copy()
        objval = np.asarray(out.dobj).copy()
        y = np.asarray(out.y)[:, :m].copy()
        X = [np.array(xb) for xb in out.X]
        xl = np.asarray(out.xl).copy()
        xlb = np.asarray(out.xlb)[:, :m].copy()
        xub = np.asarray(out.xub)[:, :m].copy()
        direct_iters = int(out.iters)
        nsolves = 1
        npenalty = 0
        out_tier = np.full((B, 2), np.nan)
        if onevar:
            self._apply_onevar(onevar, status, objval, y, X, xl, xlb, xub)

        failed = np.isin(status, _UNSOLVED_CODES)
        live = ~(lb > ub).any(axis=1)    # dummy slots don't count
        ndirect = int((~failed & live).sum())
        if failed.any() and not out_of_time():
            # rung 2: feasibility probe (Gamma = 1, objective zero)
            self.stat_nprobes += 1
            ubp = ubx.copy()
            ubp[:, m] = INF
            bprobe = np.zeros_like(bmat)
            bprobe[:, m] = 1.0
            lbq, ubq = self._mask_decided(lbx, ubp, failed)
            outp = to_host(self._run(bprobe, lbq, ubq, cuts))[0]
            nsolves += 1
            pstat = np.asarray(outp.status)
            rstar = np.asarray(outp.r)
            infeas_margin = ipms.peninfeasadjust * max(feastol, ipms.gaptol)
            proved_infeas = (
                failed
                & (pstat == int(SolverResultStatus.OPTIMAL))
                & (rstar > infeas_margin)
            )
            status[proved_infeas] = int(SolverResultStatus.INFEASIBLE)
            if proved_infeas.any():
                # keep the probe's primal certificate (X, lp multipliers):
                # the Farkas-style witness the conflict cut is built from
                for t in range(len(X)):
                    X[t][proved_infeas] = np.asarray(outp.X[t])[proved_infeas]
                xl[proved_infeas] = np.asarray(outp.xl)[proved_infeas]
                xlb[proved_infeas] = np.asarray(outp.xlb)[proved_infeas, :m]
                xub[proved_infeas] = np.asarray(outp.xub)[proved_infeas, :m]
            failed = np.isin(status, _UNSOLVED_CODES)

        if failed.any() and not out_of_time():
            # rung 3: penalty rescue with the reference's escalation rule
            # (sdpi.c:3497-3599): per instance, Gamma grows toward
            # maxpenaltyparam and gaptol shrinks toward MIN_GAPTOL; when a
            # solve converges but its r > feastol (not ``feasorig``), the
            # primal penalty bound decides which knob moves —
            # Tr(X) ~ Gamma within PENALTYBOUNDTOL (read off the r-column
            # bound multiplier: xlb_r = Gamma - Tr(X)) means the penalty
            # cap binds, so raise Gamma; otherwise tighten gaptol.
            gamma = np.full(B, ipms.penaltyparam)
            gtol = np.full(B, ipms.gaptol)
            if tier is not None:
                # settings inheritance: start at the parent's tier
                tg = np.asarray(tier[:, 0], dtype=np.float64)
                tt = np.asarray(tier[:, 1], dtype=np.float64)
                okg = np.isfinite(tg)
                gamma[okg] = np.clip(tg[okg], ipms.penaltyparam,
                                     ipms.maxpenaltyparam)
                okt = np.isfinite(tt)
                gtol[okt] = np.clip(tt[okt], ipms.min_gaptol, ipms.gaptol)
            if ipms.npenaltyincr > 0:
                pfact = (ipms.maxpenaltyparam / ipms.penaltyparam) ** (
                    1.0 / ipms.npenaltyincr)
                gfact = (ipms.min_gaptol / ipms.gaptol) ** (
                    1.0 / ipms.npenaltyincr)
            else:
                pfact = 2.0 * ipms.maxpenaltyparam / ipms.penaltyparam
                gfact = 0.5 * ipms.min_gaptol / ipms.gaptol
            bound_only = np.full(B, -np.inf)
            have_bound = np.zeros(B, dtype=bool)
            did_spec = np.zeros(B, dtype=bool)

            # --- speculative parallel ladder (one solve) ----------------
            # clone each failed instance into the free batch slots at
            # DIFFERENT (Gamma, gaptol) tiers along the escalation lattice
            # (both edges and the diagonal) and solve them all at once,
            # adopting the lowest-tier acceptable outcome (SCIPsdpiClone +
            # concurrent settings role, sdpi.c:2144)
            n_i = max(int(ipms.npenaltyincr), 1)
            sched = []
            for i, j in ((1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 2),
                         (4, 0), (0, 4), (4, 4), (8, 0), (0, 8), (8, 8)):
                ij = (min(i, n_i), min(j, n_i))
                if ij not in sched and ij != (0, 0):
                    sched.append(ij)
            fidx = np.where(failed)[0]
            ntiers = min(len(sched) + 1, B // max(len(fidx), 1))
            if ntiers >= 3 and not out_of_time():
                free = [s for s in range(B) if not failed[s]]
                bpen = bmat.copy()
                lbq = np.ones_like(lbx)     # default: conflict box
                ubq = np.zeros_like(ubx)
                gt_vec = np.full(B, ipms.gaptol)
                cuts_s = None
                if cuts is not None:
                    Gc0, hc0, cv0 = cuts
                    Gc_s, hc_s, cv_s = (Gc0.copy(), hc0.copy(), cv0.copy())
                assign = {}   # owner -> [(slot, Gamma, gaptol), ...]
                for f in fidx:
                    slots = [int(f)] + [free.pop() for _ in range(
                        min(ntiers - 1, len(free)))]
                    assign[int(f)] = []
                    for k, s in enumerate(slots):
                        i, j = ((0, 0) if k == 0 else sched[k - 1])
                        g_s = min(gamma[f] * pfact ** i,
                                  ipms.maxpenaltyparam)
                        t_s = max(gtol[f] * gfact ** j, ipms.min_gaptol)
                        bpen[s] = bmat[f]
                        bpen[s, m] = g_s
                        lbq[s] = lbx[f]
                        ubq[s] = ubx[f]
                        ubq[s, m] = INF
                        gt_vec[s] = t_s
                        if cuts is not None:
                            Gc_s[s] = Gc0[f]
                            hc_s[s] = hc0[f]
                            cv_s[s] = cv0[f]
                        assign[int(f)].append((s, g_s, t_s))
                if cuts is not None:
                    cuts_s = (Gc_s, hc_s, cv_s)
                outk = to_host(self._run(bpen, lbq, ubq, cuts_s,
                                         gaptol=gt_vec))[0]
                nsolves += 1
                kstat = np.asarray(outk.status)
                kr = np.asarray(outk.r)
                kdobj = np.asarray(outk.dobj)
                ky = np.asarray(outk.y)
                kxl = np.asarray(outk.xl)
                kxlb = np.asarray(outk.xlb)
                kxub = np.asarray(outk.xub)
                kX = [np.asarray(xb) for xb in outk.X]
                for f, slots in assign.items():
                    for s, g_s, t_s in slots:
                        conv = kstat[s] == int(SolverResultStatus.OPTIMAL)
                        if conv and kr[s] <= feastol:
                            npenalty += 1
                            status[f] = int(SolverResultStatus.OPTIMAL)
                            objval[f] = kdobj[s] - g_s * kr[s]
                            y[f] = ky[s, :m]
                            for t in range(len(X)):
                                X[t][f] = kX[t][s]
                            xl[f] = kxl[s]
                            xlb[f] = kxlb[s, :m]
                            xub[f] = kxub[s, :m]
                            out_tier[f] = (g_s, t_s)
                            break
                        if conv:
                            bound_only[f] = max(bound_only[f], kdobj[s])
                            have_bound[f] = True
                    did_spec[f] = True
                failed = np.isin(status, _UNSOLVED_CODES)

            # --- serial escalation (fallback when slots are scarce) -----
            for _ in range(2 * ipms.npenaltyincr + 2):
                active = (failed & ~did_spec
                          & (gamma < ipms.maxpenaltyparam + ipms.epsilon)
                          & (gtol > 0.99 * ipms.min_gaptol))
                if not active.any() or out_of_time():
                    break
                bpen = bmat.copy()
                bpen[:, m] = gamma
                ubp = ubx.copy()
                ubp[:, m] = INF
                lbq, ubq = self._mask_decided(lbx, ubp, active)
                outk = to_host(self._run(bpen, lbq, ubq, cuts,
                                         gaptol=gtol))[0]
                nsolves += 1
                kstat = np.asarray(outk.status)
                kr = np.asarray(outk.r)
                kconv = kstat == int(SolverResultStatus.OPTIMAL)
                # not acceptable -> raise Gamma (sdpi.c:3540-3546)
                notacc = active & ~kconv
                gamma[notacc] *= pfact
                feasorig = active & kconv & (kr <= feastol)
                if feasorig.any():
                    npenalty += int(feasorig.sum())
                    out_tier[feasorig, 0] = gamma[feasorig]
                    out_tier[feasorig, 1] = gtol[feasorig]
                    status[feasorig] = int(SolverResultStatus.OPTIMAL)
                    ky = np.asarray(outk.y)
                    objval[feasorig] = (
                        np.asarray(outk.dobj)[feasorig]
                        - gamma[feasorig] * kr[feasorig]
                    )
                    y[feasorig] = ky[feasorig, :m]
                    for t in range(len(X)):
                        X[t][feasorig] = np.asarray(outk.X[t])[feasorig]
                    xl[feasorig] = np.asarray(outk.xl)[feasorig]
                    xlb[feasorig] = np.asarray(outk.xlb)[feasorig, :m]
                    xub[feasorig] = np.asarray(outk.xub)[feasorig, :m]
                # converged but r > feastol: the penalty objective still
                # bounds the original optimum from below (sdpi.c
                # GetLowerObjbound :3551), and the penaltybound test picks
                # the next knob (:3554-3570)
                usable = active & kconv & ~feasorig
                bound_only = np.where(
                    usable, np.maximum(bound_only, np.asarray(outk.dobj)),
                    bound_only,
                )
                have_bound = have_bound | usable
                xlb_r = np.asarray(outk.xlb)[:, m]
                penaltybound = xlb_r < ipms.penaltyboundtol * gamma
                gamma[usable & penaltybound] *= pfact
                gtol[usable & ~penaltybound] *= gfact
                failed = np.isin(status, _UNSOLVED_CODES)

            salvage = failed & have_bound
            if salvage.any():
                status[salvage] = int(SolverResultStatus.BOUND_ONLY)
                objval[salvage] = bound_only[salvage]
                failed = np.isin(status, _UNSOLVED_CODES)
            # ladder-exhausted instances: children start one step below
            # the TOP tier instead of re-climbing the whole ladder
            exhausted = salvage | failed
            if exhausted.any():
                out_tier[exhausted, 0] = ipms.maxpenaltyparam / pfact
                out_tier[exhausted, 1] = ipms.min_gaptol / gfact

        if failed.any() and not out_of_time():
            # Farkas-style box bound from the primal iterate
            # (computeConflictCut aggregation, relax_sdp.c:954-1410):
            # for ANY X >= 0 and xl >= 0,
            #   b^T y  =  (b - g)^T y + g^T y  >=  (b - g)^T y + lhs
            # with g_j = sum_b tr(A_j^b X_b) + xl G_j and lhs = tr(C X)
            # + xl h; minimizing the linear term over the node box gives
            # a VALID dual bound even when the solve cannot certify
            g, lhs = self.conflict_cuts(
                types.SimpleNamespace(X=X, xl=xl, y=y))
            coef = bmat[:, :m] - g
            lo = np.where(lb <= -1e19, -np.inf, lb)
            hi = np.where(ub >= 1e19, np.inf, ub)
            with np.errstate(invalid="ignore"):
                t1 = coef * lo
                t2 = coef * hi
            terms = np.where(np.abs(coef) <= 1e-14, 0.0,
                             np.minimum(t1, t2))
            bnd = lhs + terms.sum(axis=1)
            good = failed & np.isfinite(bnd)
            if good.any():
                # safety margin for the iterate's numerical PSD slack
                bnd = bnd - feastol * (1.0 + np.abs(bnd))
                status[good] = int(SolverResultStatus.BOUND_ONLY)
                objval[good] = bnd[good]
                failed = np.isin(status, _UNSOLVED_CODES)

        if failed.any() and not out_of_time():
            # rung 4: box rescue / unboundedness detection
            lbb = lbx.copy()
            ubb = ubx.copy()
            art_lb = lbb[:, :m] < -BOX_BOUND
            art_ub = ubb[:, :m] > BOX_BOUND
            lbb[:, :m] = np.maximum(lbb[:, :m], -BOX_BOUND)
            ubb[:, :m] = np.minimum(ubb[:, :m], BOX_BOUND)
            lbb, ubb = self._mask_decided(lbb, ubb, failed)
            outb = to_host(self._run(bmat, lbb, ubb, cuts))[0]
            nsolves += 1
            bstat = np.asarray(outb.status)
            byfull = np.asarray(outb.y)[:, :m]
            at_box = np.any(
                (art_lb & (byfull <= -BOX_ACTIVE_TOL * BOX_BOUND))
                | (art_ub & (byfull >= BOX_ACTIVE_TOL * BOX_BOUND)),
                axis=1,
            )
            bconv = bstat == int(SolverResultStatus.OPTIMAL)
            unbounded = failed & bconv & at_box
            recovered = failed & bconv & ~at_box
            status[unbounded] = int(SolverResultStatus.UNBOUNDED)
            objval[unbounded] = -np.inf
            status[recovered] = int(SolverResultStatus.OPTIMAL)
            objval[recovered] = np.asarray(outb.dobj)[recovered]
            y[recovered] = byfull[recovered]
            for t in range(len(X)):
                X[t][recovered] = np.asarray(outb.X[t])[recovered]
            xl[recovered] = np.asarray(outb.xl)[recovered]
            xlb[recovered] = np.asarray(outb.xlb)[recovered, :m]
            xub[recovered] = np.asarray(outb.xub)[recovered, :m]

        # independent solution verification + feastol-tightened re-solve
        # (sdpsolchecker.c:58; INFEASFEASTOLCHANGE, sdpisolver_dsdp.c:66):
        # a "converged" instance whose y fails the independent feastol
        # check is re-solved with the CONVERGENCE feastol tightened 10x,
        # and only declared FAILED when even the tightened solves cannot
        # produce a verifiable solution.  One-var-decided instances are
        # exempt: their optimum is an exact eigenvalue-interval endpoint
        # (the interval computation IS the independent check), and their
        # slots carry a conflict box.
        optm = (status == int(SolverResultStatus.OPTIMAL)) & live
        for i in onevar:
            optm[i] = False
        if optm.any():
            from scipsdp_tpu_torch.core.feascheck import check_points

            def verified():
                pts = _to_device((y, lb, ub), self.device)
                return check_points(self.data, *pts,
                                    feastol=float(feastol))[0].cpu().numpy()

            okv = verified()
            bad = optm & ~okv
            ft = feastol
            while bad.any() and ft > 1e-9 and not out_of_time():
                ft *= 0.1
                self.stat_nveri_resolve += 1
                lbq, ubq = self._mask_decided(lbx, ubx, bad)
                outv = to_host(self._run(bmat, lbq, ubq, cuts,
                                         feastol_vec=np.full(B, ft)))[0]
                nsolves += 1
                vstat = np.asarray(outv.status)
                take = bad & (vstat == int(SolverResultStatus.OPTIMAL))
                if take.any():
                    objval[take] = np.asarray(outv.dobj)[take]
                    y[take] = np.asarray(outv.y)[take, :m]
                    for t in range(len(X)):
                        X[t][take] = np.asarray(outv.X[t])[take]
                    xl[take] = np.asarray(outv.xl)[take]
                    xlb[take] = np.asarray(outv.xlb)[take, :m]
                    xub[take] = np.asarray(outv.xub)[take, :m]
                    okv = verified()
                    bad = bad & ~(take & okv)
            status[bad] = int(SolverResultStatus.FAILED)

        if out_of_time():
            # ladder was cut short by the per-solve budget: undecided
            # instances report TIMELIMIT, not numerical failure
            timed_out = np.isin(status, (int(SolverResultStatus.FAILED),
                                         int(SolverResultStatus.ITERLIMIT)))
            status[timed_out] = int(SolverResultStatus.TIMELIMIT)

        nunsolved = int(np.isin(status, _UNSOLVED_CODES).sum())
        self.stat_npenalty += npenalty
        self.stat_nunsolved += nunsolved

        return BatchSolveResult(
            status=status,
            objval=objval,
            y=y,
            X=X,
            xl=xl,
            xlb=xlb,
            xub=xub,
            iters=direct_iters,
            nsolves=nsolves,
            npenalty=npenalty,
            nunsolved=nunsolved,
            ndirect=ndirect,
            tier=out_tier,
            pre_y=pre_y,
            pre_X=pre_X,
            pre_has=pre_has,
            round_y=round_y,
            round_feas=round_feas,
            round_val=round_val,
        )
