"""Vectorized branch-and-bound for MISDPs (PyTorch).

Counterpart of ``scipsdp_tpu/core/branchbound.py``: the tree loop that SCIP
provides for the reference.  A *host-side* best-first frontier (the
reference's re-defaulted node selection, scipsdpdefplugins.c:152-158 —
best-first because SDP warmstarts are weak) and *device-side batched*
relaxation solves of many open nodes per step through the recovery ladder
of ``core/sdpi.py``.

Plugin roles folded in, as in the JAX package:

* fracround / randomized rounding heuristics (heur_sdpfracround.c,
  heur_sdprand.c) — rounded and checked on the device inside the direct
  rung of every batched solve;
* indicator constraints — bound propagation at node creation + enforcement
  branching (reader_sdpa.c:1195-1252 translation);
* rank-1 constraints — eigenvalue check (isMatrixRankOne, cons_sdp.c:733)
  with secant/McCormick cuts + spatial branching;
* bilinear lifts of the quadratic upgrade — McCormick cuts + spatial
  branching;
* conflict rows from the relaxation certificates and binary no-goods from
  propagation conflicts, used for bound propagation at every node.

Two relaxation modes, switched by ``settings.solve_sdps`` like the
reference's ``misc/solvesdps`` master switch (relax_sdp.c:5428):

* ``solve_sdps = 1`` (default): nonlinear B&B — every node solves the SDP
  relaxation through the recovery ladder;
* ``solve_sdps = 0``: LP outer approximation — nodes solve LP relaxations
  (scipy HiGHS on the host) and the SDP blocks are enforced by
  *eigenvector cutting planes* (``ops/cuts.py``) separated into a global
  cut pool (cons_sdp.c:separateSol:1612, produceCutFromEigenvector:896),
  with an exact SDP solve of an integral node after ``enforce_after``
  fruitless rounds (enforcesdp, cons_sdp.c:8276-8423).

The probing plugins of ``core/probing.py`` run when their options are on:
the root inner-LP heuristic, analytic-center warm starts, OBBT at the root
and in the tree, rounding-problem warm starts (warmstartproject = 4),
per-node Slater statistics and fractional diving.

The loop runs on one device: the card unless ``device="cpu"`` is given,
with no fall-back to the CPU.  When the problem fits its feature set
(``core/turbo.py::eligible``), the tree runs device-resident in
``core/turbo.py::solve_turbo`` instead, engaged as in the JAX package:
``bb.turbo="on"`` at once on any device; ``"auto"`` at once on the card
and, on the CPU, by handing the host loop's frontier over after three
batches once it holds 2B nodes; the host loop takes over when turbo bails.

``use_mesh`` shards every batched solve over a device mesh
(``parallel/mesh.py``) built from the solver's device: its CUDA cards, or
``mesh_devices`` CPU entries on the CPU; one card means no mesh.
``sync_hook`` runs the loop in lockstep with other processes
(``parallel/multihost.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from scipsdp_tpu_torch.core import probing
from scipsdp_tpu_torch.core import rank1 as r1
from scipsdp_tpu_torch.core import turbo as _turbo
from scipsdp_tpu_torch.core.branching import select_branch_var
from scipsdp_tpu_torch.core.feascheck import check_points
from scipsdp_tpu_torch.core.presolve_sdp import (postsolve_solution,
                                                 presolve_problem)
from scipsdp_tpu_torch.core.propagate import (matrix_view, propagate_3minors,
                                              propagate_upper_bounds,
                                              tighten_bounds,
                                              tighten_bounds_onevar)
from scipsdp_tpu_torch.core.propredcost import redcost_tighten
from scipsdp_tpu_torch.core.sdpi import SDPInterface, to_host
from scipsdp_tpu_torch.models.problem import INF, MISDP, DenseSDPData, densify
from scipsdp_tpu_torch.native.frontier import FrontierStore
from scipsdp_tpu_torch.ops.cmir import cmir_cut
from scipsdp_tpu_torch.ops.cuts import (multiple_sparse_cuts,
                                        separate_eigenvector_cuts)
from scipsdp_tpu_torch.parallel.mesh import make_mesh
from scipsdp_tpu_torch.utils.config import Settings
from scipsdp_tpu_torch.utils.status import SolveStatus, SolverResultStatus

CUT_CHUNK = 16          # cut-buffer capacity granularity (padded rows keep
#                         the batched solve's shapes few)
MAX_POOL = 512          # global eigenvector cut pool cap (LP mode)
MAX_SEP_ROUNDS = 8      # separation rounds per node batch (LP mode)

_OPT_CODES = (int(SolverResultStatus.OPTIMAL),
              int(SolverResultStatus.PRESOLVED_OPTIMAL))
_INFEAS_CODES = (int(SolverResultStatus.INFEASIBLE),
                 int(SolverResultStatus.PRESOLVED_INFEASIBLE))


@dataclasses.dataclass
class BBStats:
    nodes: int = 0
    relax_solves: int = 0
    ipm_iterations: int = 0
    solver_calls: int = 0
    npenalty: int = 0
    nunsolved: int = 0
    ndirect: int = 0          # fastest-tier (direct rung) decisions
    #                           (disp_sdpfastsettings role)
    heur_found: int = 0
    ncuts: int = 0
    sep_rounds: int = 0
    redcost_tightenings: int = 0
    roundingprobinf: int = 0  # nodes cut off by the primal rounding problem
    nnogoods: int = 0         # learned binary no-good conflict rows
    nenforce_sdp: int = 0     # LP-mode exact-SDP probing enforcement
    #                           solves (cons_sdp.c:8276-8423)
    ndropped_nodes: int = 0   # nodes dropped undecidable (LP mode)
    nnogoods_dropped: int = 0  # no-goods dropped for length (> cap)
    ncuts_dropped: int = 0    # pool-cut additions rejected (LP mode)
    sym_capped: str = ""      # why the automorphism search was skipped /
    #                           truncated ("" = it ran to completion)
    nstolen: int = 0          # nodes received from other hosts (multi-host)
    ndonated: int = 0         # nodes donated to other hosts (multi-host)
    orbital_fixings: int = 0  # 0-fixings from symmetry orbits
    #                           (prop_sdpsymmetry.c role)
    slater_holds: int = 0     # per-node dual Slater accounting
    slater_fails: int = 0     # (table_slater.c role; slatercheck knob)
    slater_undecided: int = 0
    slater_primal_holds: int = 0    # per-node PRIMAL Slater accounting
    slater_primal_fails: int = 0    # (sdpi.c:1748-1812 primal branch)
    slater_primal_undecided: int = 0
    # per-routine propagation timing (constraints/SDP/enableproptiming,
    # cons_sdp.c:265-292): routine name -> accumulated seconds
    prop_times: dict = dataclasses.field(default_factory=dict)
    wall_time: float = 0.0
    solve_time: float = 0.0   # relaxation-solve time (sdpiclock role)


@dataclasses.dataclass
class BBResult:
    status: SolveStatus
    objval: Optional[float]        # external (original-sense) objective
    best_y: Optional[np.ndarray]   # incumbent solution (original vars)
    dual_bound: float              # external-sense proven bound
    gap: float
    stats: BBStats

    def __repr__(self):
        return (f"BBResult(status={self.status.name}, objval={self.objval}, "
                f"bound={self.dual_bound}, nodes={self.stats.nodes})")


class _Node:
    __slots__ = ("lb", "ub", "bound", "depth", "cuts", "requeues", "ysol",
                 "xsol", "wsrows", "tier", "b1")

    def __init__(self, lb, ub, bound, depth, cuts=(), requeues=0, ysol=None,
                 xsol=None, wsrows=-1, tier=None, b1=frozenset()):
        self.lb = lb
        self.ub = ub
        self.bound = bound
        self.depth = depth
        self.cuts = list(cuts)   # node-local cuts: [(g (m,), rhs), ...]
        self.requeues = requeues  # LP-mode re-separation attempts
        self.ysol = ysol          # parent relaxation solution (warmstart;
        #                           cons_savesdpsol.c role)
        self.xsol = xsol          # parent primal matrices in bucket layout
        #                           (fillStartX + project=4 rounding)
        self.wsrows = wsrows      # cut-row count when ysol was saved:
        #                           warmstart info is invalidated when the
        #                           row structure changed
        #                           (cons_savesdpsol.c:57 nlpcons)
        self.tier = tier          # inherited (Gamma, gaptol) penalty tier
        #                           (cons_savedsdpsettings role,
        #                           relax_sdp.c:4085-4120)
        self.b1 = b1              # frozenset of binaries BRANCHED to 1 on
        #                           the path (orbital-fixing stabilizer,
        #                           performOrbitalFixing role); None =
        #                           provenance unknown (restored node) ->
        #                           pin all 1-fixed binaries


def _apply_indicator_propagation(prob: MISDP, lb: np.ndarray, ub: np.ndarray):
    """binvar fixed to 1 => slack forced to 0 (indicator semantics)."""
    for link in prob.indicators:
        if lb[link.binvar] >= 0.5:
            ub[link.slackvar] = min(ub[link.slackvar], 0.0)


def _lift_violated(prob: MISDP, y: np.ndarray, feastol: float) -> bool:
    """Does y violate a bilinear-lift identity w = y_i y_j (quad upgrade)?"""
    if not prob.liftinfo:
        return False
    return any(abs(y[w] - y[vi] * y[vj]) > 10.0 * feastol
               for (w, vi, vj) in prob.liftinfo)


def _violated_indicator(prob: MISDP, y: np.ndarray, feastol: float) -> int:
    """Return the binvar of a violated indicator link (binvar ~ 1 but slack
    positive), or -1.  Enforcement role of SCIP's cons_indicator."""
    for link in prob.indicators:
        if y[link.binvar] >= 0.5 and y[link.slackvar] > feastol:
            return link.binvar
    return -1


def _round_up(x: int, chunk: int) -> int:
    return ((x + chunk - 1) // chunk) * chunk


def _split_value(y_j: float, l_: float, u_: float) -> float:
    """Spatial split point with guaranteed box shrinkage (sBB contraction):
    y_j kept 20 % of the width inside a finite box, a unit inside a
    half-open one."""
    sv = float(y_j)
    if l_ > -INF / 2 and u_ < INF / 2:
        w = u_ - l_
        sv = min(max(sv, l_ + 0.2 * w), u_ - 0.2 * w)
    elif l_ > -INF / 2:
        sv = max(sv, l_ + 1.0)
    elif u_ < INF / 2:
        sv = min(sv, u_ - 1.0)
    return sv


class _Solver:
    """Shared state of one solve_misdp run."""

    def __init__(self, prob: MISDP, settings: Settings, device=None):
        prob = presolve_problem(prob, settings)
        self.prob = prob
        self.settings = settings
        mesh = None
        if settings.use_mesh:
            # the solver's device decides: all its CUDA cards (or
            # mesh_devices of them), or mesh_devices CPU entries
            dev = torch.device("cuda" if device is None else device)
            ndev = settings.mesh_devices or (
                torch.cuda.device_count() if dev.type == "cuda" else 1)
            if ndev > 1:
                axes = (("nodes", "blocks")
                        if ndev % 2 == 0 and len(prob.blocks) > 1
                        else ("nodes",))
                mesh = make_mesh(ndev, axes, device=dev)
        self.mesh = mesh
        self.dense: DenseSDPData = densify(prob)
        self.m = prob.nvars
        self.lp_mode = settings.solve_sdps == 0
        pairs = [(link.binvar, link.slackvar) for link in prob.indicators]
        # full data: the SDP relaxations, and in LP mode separation and
        # feasibility checks
        self.full_iface = SDPInterface(self.dense, settings,
                                       indicator_pairs=pairs, mesh=mesh,
                                       device=device)
        self.iface = self.full_iface
        if self.lp_mode:
            # LP relaxation data: same rows/bounds, no SDP blocks, solved
            # on the host simplex
            lp_dense = densify(
                MISDP(nvars=prob.nvars, obj=prob.obj, lb=prob.lb,
                      ub=prob.ub, integral=prob.integral, blocks=[],
                      lp=prob.lp, indicators=prob.indicators,
                      name=prob.name + "_lp"))
            self.iface = SDPInterface(lp_dense, settings, mesh=mesh,
                                      lp_host=True, device=device)
        self.pool: List[Tuple[np.ndarray, float]] = []  # global cuts
        self._pool_keys = set()
        # conflict constraints (generateConflictCons, relax_sdp.c:1424):
        # globally valid rows used for bound propagation only (the
        # reference adds them with propagate=TRUE, everything else FALSE)
        self._conf_D: List[np.ndarray] = []
        self._conf_lhs: List[float] = []
        self._conf_keys = set()
        self._conf_cache = None
        self.stats = BBStats()
        # LP-row violation evaluator for the rank-1 completion heuristic
        D = prob.lp.dense(prob.nvars)
        lhs, rhs = prob.lp.lhs, prob.lp.rhs

        def violation(yv: np.ndarray, nlb=None, nub=None) -> float:
            v = 0.0
            if D.shape[0]:
                act = D @ yv
                va = np.maximum(np.where(lhs > -INF, lhs - act, 0.0), 0.0)
                va = np.maximum(va, np.where(rhs < INF, act - rhs, 0.0))
                v = float(va.max())
            if nlb is not None:
                v = max(v, float(np.maximum(
                    np.where(nlb > -INF, nlb - yv, 0.0), 0.0).max()))
            if nub is not None:
                v = max(v, float(np.maximum(
                    np.where(nub < INF, yv - nub, 0.0), 0.0).max()))
            return v

        self.violation = violation

    _mv = None   # cached matrix view (constructMatrixvar, cons_sdp.c:570)

    def _timed(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.stats.prop_times[name] = (self.stats.prop_times.get(name, 0.0)
                                       + t1 - t0)
        return t1

    def propagate_node(self, lb: np.ndarray, ub: np.ndarray,
                       depth: int = 0):
        """Propagation at node creation; returns (lb, ub, conflict).

        Activity-based tightening over LP + conflict rows always; every
        ``prop_freq``-th depth additionally the SDP-structural
        propagation of consPropSdp (cons_sdp.c:7046): upper-bound
        propagation |X_st| <= sqrt(X_ss X_tt) and 3x3-minor equalities on
        the matrix view — the reference runs these at EVERY node, not
        just the root."""
        timing = self.settings.bb.enableproptiming
        extra = None
        if self._conf_D:
            if self._conf_cache is None or len(self._conf_cache[1]) != len(
                    self._conf_lhs):
                self._conf_cache = (
                    np.stack(self._conf_D),
                    np.array(self._conf_lhs),
                    np.full(len(self._conf_lhs), INF),
                )
            extra = self._conf_cache
        t0 = time.perf_counter()
        lb, ub, conflict = tighten_bounds(self.prob, lb, ub, rounds=2,
                                          extra=extra)
        if timing:
            self._timed("tightenbounds", t0)
        pf = self.settings.bb.prop_freq
        if (not conflict and pf > 0 and depth % pf == 0
                and self.prob.blocks):
            if self._mv is None:
                self._mv = matrix_view(self.prob)
            t0 = time.perf_counter()
            nt = propagate_upper_bounds(self.prob, lb, ub, self._mv)
            if timing:
                t0 = self._timed("propupperbounds", t0)
            nt += propagate_3minors(self.prob, lb, ub, self._mv)
            if timing:
                self._timed("prop3minor", t0)
            if nt:
                self.stats.redcost_tightenings += nt
                lb, ub, conflict = tighten_bounds(self.prob, lb, ub,
                                                  rounds=1, extra=extra)
        return lb, ub, conflict

    def learn_nogood(self, clb: np.ndarray, cub: np.ndarray,
                     root_lb: np.ndarray, root_ub: np.ndarray) -> None:
        """Conflict analysis on a propagation-infeasible child
        (cons_sdp.c:4793,5138 analog): the set of binary fixings that led
        here cannot all hold together — learn the binary no-good row
        sum_{j fixed to 0} y_j + sum_{j fixed to 1} (1 - y_j) >= 1 as a
        globally valid propagation row."""
        bb = self.settings.bb
        if len(self._conf_lhs) >= bb.max_conflict_rows:
            return
        binary = (self.prob.integral & (root_lb <= 0.0) & (root_ub >= 1.0)
                  & (root_ub - root_lb <= 1.0 + 1e-9))
        fix0 = binary & (cub <= 0.5) & (root_ub > 0.5)
        fix1 = binary & (clb >= 0.5) & (root_lb < 0.5)
        nfix = int(fix0.sum() + fix1.sum())
        if nfix == 0:
            return
        if nfix > 32:   # too-long no-goods never propagate
            if self.stats.nnogoods_dropped == 0:
                print(f"  [notice] conflict no-good with {nfix} fixings "
                      f"exceeds the 32-literal cap; dropped")
            self.stats.nnogoods_dropped += 1
            return
        # VALIDITY GUARD: the no-good claims the binary fixings ALONE are
        # jointly infeasible, so every bound the child tightened relative
        # to the root must either be one of those fixings or follow from
        # them (indicator propagation: binvar = 1 => slack <= 0); a child
        # also carrying general-integer splits or propagation tightenings
        # would yield an UNSOUND row
        implied = fix0 | fix1
        for link in self.prob.indicators:
            if fix1[link.binvar] or clb[link.binvar] >= 0.5:
                implied[link.slackvar] = True
        moved = ((clb > root_lb + 1e-9) | (cub < root_ub - 1e-9))
        if bool(np.any(moved & ~implied)):
            return
        g = np.zeros(self.m)
        g[fix0] = 1.0
        g[fix1] = -1.0
        lhs = 1.0 - float(fix1.sum())
        key = (g.tobytes(), round(lhs, 9))
        if key in self._conf_keys:
            return
        self._conf_keys.add(key)
        self._conf_D.append(g)
        self._conf_lhs.append(lhs)
        self.stats.nnogoods += 1

    def collect_conflicts(self, batch: List[_Node], res) -> None:
        """Store conflict rows from this batch's certificates
        (relax_sdp.c:4353 relaxExecSdp calls generateConflictCons after
        both feasible and infeasible solves, per conflictfeas/-infeas)."""
        bb = self.settings.bb
        want = np.zeros(res.status.shape[0], dtype=bool)
        if bb.conflictfeas:
            want |= res.status == int(SolverResultStatus.OPTIMAL)
        if bb.conflictinfeas:
            want |= res.status == int(SolverResultStatus.INFEASIBLE)
        want[len(batch):] = False
        if not want.any() or len(self._conf_lhs) >= bb.max_conflict_rows:
            return
        G, lhs = self.iface.conflict_cuts(res)
        for i in np.where(want)[0]:
            g = G[i]
            scale = np.abs(g).max()
            if not np.isfinite(lhs[i]) or not np.all(np.isfinite(g)) \
                    or scale < 1e-12:
                continue
            lhs_i = lhs[i]
            if bb.conflictcmir:
                mir = cmir_cut(g, lhs[i], self.prob.lb, self.prob.ub,
                               self.prob.integral, res.y[i])
                if mir is not None:
                    g, lhs_i = mir
                    scale = max(np.abs(g).max(), 1e-12)
            key = (np.round(g / scale, 6).tobytes(),
                   round(float(lhs_i / scale), 6))
            if key in self._conf_keys:
                continue
            if len(self._conf_lhs) >= bb.max_conflict_rows:
                break
            self._conf_keys.add(key)
            self._conf_D.append(g.astype(np.float64))
            self._conf_lhs.append(float(lhs_i))

    # -- cuts ---------------------------------------------------------------

    def _add_pool_cut(self, g: np.ndarray, rhs: float) -> bool:
        if len(self.pool) >= MAX_POOL:
            # no silent caps: a saturated pool is a measurable event
            if self.stats.ncuts_dropped == 0:
                print(f"  [notice] eigenvector cut pool saturated at "
                      f"{MAX_POOL} rows; further cuts dropped")
            self.stats.ncuts_dropped += 1
            return False
        key = (np.round(g / max(1.0, np.abs(g).max() or 1.0), 6).tobytes(),
               round(float(rhs), 6))
        if key in self._pool_keys:
            return False
        self._pool_keys.add(key)
        self.pool.append((g.astype(np.float64), float(rhs)))
        self.stats.ncuts += 1
        return True

    def _assemble_cuts(self, batch: List[_Node], B: int):
        """Padded per-node cut arrays: the global pool (LP mode) ++ the
        node-local cuts (rank-1 secants, McCormick rows)."""
        npool = len(self.pool)
        q = npool + max((len(n.cuts) for n in batch), default=0)
        if q == 0:
            return None
        q = _round_up(q, CUT_CHUNK)
        Gc = np.zeros((B, q, self.m))
        hc = np.zeros((B, q))
        valid = np.zeros((B, q), dtype=bool)
        for c, (g, rhs) in enumerate(self.pool):
            Gc[:, c, :] = g
            hc[:, c] = rhs
            valid[:, c] = True
        for i, node in enumerate(batch):
            for c, (g, rhs) in enumerate(node.cuts):
                Gc[i, npool + c, :] = g
                hc[i, npool + c] = rhs
                valid[i, npool + c] = True
        valid[len(batch):] = False   # dummy slots
        return Gc, hc, valid

    def _separate(self, y: np.ndarray, nreal: int,
                  rowmask: Optional[np.ndarray] = None) -> int:
        """Add violated eigenvector cuts at points y to the pool (LP mode).

        One batched eigh per bucket yields every candidate cut
        (ops/cuts.py), brought to the host in one transfer; each kept cut
        is optionally strengthened by c-MIR (produceCutFromEigenvector's
        CMIR path, cons_sdp.c:1039-1127) and optionally complemented by
        disjoint-support sparse cuts (addMultipleSparseCuts,
        cons_sdp.c:1340)."""
        cs = self.settings.cuts
        has_int = bool(np.any(self.prob.integral))
        data = self.full_iface.data
        sep = to_host(separate_eigenvector_cuts(
            data, y, tol=self.settings.bb.feastol))[0]
        added = 0
        for t in range(data.nbuckets):
            coefs = sep.coefs[t][:nreal]
            rhs = sep.rhs[t][:nreal]
            valid = sep.valid[t][:nreal]
            if rowmask is not None:
                valid = valid & rowmask[:nreal, None, None]
            if cs.separateonecut and valid.any():
                lam = sep.lam[t][:nreal]
                best = np.argmin(np.where(valid, lam, np.inf), axis=2)
                onemask = np.zeros_like(valid)
                ii, kk = np.meshgrid(range(valid.shape[0]),
                                     range(valid.shape[1]), indexing="ij")
                onemask[ii, kk, best] = True
                valid = valid & onemask
            for (i, k, e) in np.argwhere(valid):
                g = coefs[i, k, e, : self.m]
                r = rhs[i, k, e]
                if self._add_pool_cut(g, r):
                    added += 1
                if cs.generatecmir and has_int:
                    mir = cmir_cut(g, r, self.prob.lb, self.prob.ub,
                                   self.prob.integral, y[i, : self.m])
                    if mir is not None and self._add_pool_cut(*mir):
                        added += 1
            if cs.multiplesparsecuts and valid.any():
                As, Cs, dms = self.full_iface._np_data[:3]
                A, C, dimmask = As[t], Cs[t], dms[t]
                if cs.sparsifytargetsize > 0:
                    size = cs.sparsifytargetsize
                else:
                    size = max(10, int(cs.sparsifyfactor * self.m))
                yx = np.concatenate([y[:, : self.m],
                                     np.zeros((y.shape[0], 1))], axis=1)
                for (i, k) in {(i, k) for (i, k, _) in np.argwhere(valid)}:
                    ns = int(dimmask[k].sum())
                    if size > ns:
                        continue
                    Zk = np.einsum("jab,j->ab", A[k], yx[i])[:ns, :ns] \
                        - C[k][:ns, :ns]
                    for v in multiple_sparse_cuts(
                            Zk, size, cs.maxnsparsecuts or -1,
                            tol=self.settings.bb.feastol):
                        gj = np.einsum("a,jab,b->j", v, A[k, : self.m,
                                                         :ns, :ns], v)
                        rj = float(v @ C[k][:ns, :ns] @ v)
                        if self._add_pool_cut(gj, rj):
                            added += 1
        return added

    # -- relaxation solving -------------------------------------------------

    def node_X_buckets(self, res, i: int) -> List[np.ndarray]:
        """Batch row i's primal matrices in bucket layout (the form the
        IPM's fillStartX warmstart consumes)."""
        return [np.asarray(res.X[t][i]) for t in range(len(res.X))]

    @staticmethod
    def buckets_to_blocks(data, xsol) -> List[np.ndarray]:
        """Bucket-layout node X -> per-original-block matrices."""
        return [np.asarray(xsol[t][s]) for (t, s) in data.block_of]

    last_q = 0   # cut-row count of the most recent relaxation solve

    def solve_relaxations(self, batch: List[_Node], B: int,
                          lb: np.ndarray, ub: np.ndarray):
        t_solve = time.time()
        cuts = self._assemble_cuts(batch, B)
        self.last_q = 0 if cuts is None else cuts[0].shape[1]
        # in SDP mode the rounding heuristics ride the solve dispatch
        # (relaxation data == full data); LP mode checks on the host
        seed = (None if self.lp_mode
                else self.settings.seed + 7919 * self.stats.nodes)
        warm = None
        bb = self.settings.bb
        if bb.warmstart:
            wy = np.zeros((lb.shape[0], self.m))
            wmask = np.zeros(lb.shape[0], dtype=bool)
            wX = None
            if bb.warmstartprimal:
                wX = [np.zeros((lb.shape[0],) + tuple(C.shape))
                      for C in self.iface.data.C]
            for i, node in enumerate(batch):
                # invalidate when the relaxation's row structure changed
                # since the parent solve (cons_savesdpsol.c:57)
                if node.ysol is not None and node.wsrows == self.last_q:
                    wy[i] = node.ysol
                    wmask[i] = True
                    if wX is not None and node.xsol is not None:
                        for t in range(len(wX)):
                            wX[t][i] = node.xsol[t]
            if wmask.any():
                warm = (wy, wmask, wX)
        # per-node settings inheritance (cons_savedsdpsettings): pass the
        # parents' successful penalty tiers so the ladder skips re-climbing
        tier = None
        if any(n.tier is not None for n in batch):
            tier = np.full((lb.shape[0], 2), np.nan)
            for i, n in enumerate(batch):
                if n.tier is not None:
                    tier[i] = n.tier
        res = self.iface.solve_batch(lb, ub, cuts=cuts, rounding_seed=seed,
                                     warm=warm, tier=tier)
        self.stats.relax_solves += 1
        self.stats.ipm_iterations += res.iters
        self.stats.solver_calls += res.nsolves
        self.stats.npenalty += res.npenalty
        self.stats.ndirect += res.ndirect

        if self.lp_mode:
            # separation loop: add eigenvector cuts until SDP-feasible or
            # no violated cuts (the reference's LP loop: consSepalpSdp ->
            # separateSol per LP round)
            integral = self.prob.integral
            for rnd in range(MAX_SEP_ROUNDS):
                usable = np.isin(res.status, _OPT_CODES)
                if not usable.any():
                    break
                sep_mask = None
                if bb.enforcesdp and rnd >= bb.enforce_after:
                    # exact-SDP enforcement takes over for INTEGRAL points
                    # after ``enforce_after`` separation rounds
                    # (consEnfolpSdp -> enforceSdp, cons_sdp.c:8276-8423):
                    # those members stop separating so the acceptance path
                    # solves their true SDP; fractional members of the
                    # same batch keep their remaining cut rounds
                    frac = np.abs(res.y[:, integral]
                                  - np.round(res.y[:, integral]))
                    is_int = (frac.max(axis=1) <= bb.feastol if frac.size
                              else np.ones(res.y.shape[0], dtype=bool))
                    stop_rows = usable & is_int
                    if (usable & ~stop_rows).sum() == 0:
                        break    # every usable member awaits enforcement
                    sep_mask = ~stop_rows
                added = self._separate(res.y, len(batch), rowmask=sep_mask)
                self.stats.sep_rounds += 1
                if added == 0:
                    break
                cuts = self._assemble_cuts(batch, B)
                res = self.iface.solve_batch(lb, ub, cuts=cuts)
                self.stats.relax_solves += 1
                self.stats.solver_calls += res.nsolves
        self.stats.solve_time += time.time() - t_solve
        return res


def save_checkpoint(path: str, frontier, incumbent_val, incumbent_y,
                    stats: BBStats) -> None:
    """Serialize the B&B frontier + incumbent (the reference has no solve-
    level checkpointing, SURVEY.md section 5 — this adds it).  The file
    format is the JAX package's, so either package resumes the other's."""
    nodes = [(nlb, nub, side[0], ndepth)
             for (nlb, nub, _prio, ndepth, side) in frontier.dump()]
    np.savez_compressed(
        path,
        lbs=np.array([n[0] for n in nodes]) if nodes else np.zeros((0, 0)),
        ubs=np.array([n[1] for n in nodes]) if nodes else np.zeros((0, 0)),
        bounds=np.array([n[2] for n in nodes]),
        depths=np.array([n[3] for n in nodes]),
        incumbent_val=incumbent_val,
        incumbent_y=(incumbent_y if incumbent_y is not None
                     else np.zeros(0)),
        nodes_processed=stats.nodes,
    )


def load_checkpoint(path: str):
    """Returns (node tuples, incumbent_val, incumbent_y, nodes_processed)."""
    z = np.load(path)
    nodes = [(z["lbs"][i], z["ubs"][i], float(z["bounds"][i]),
              int(z["depths"][i])) for i in range(len(z["bounds"]))]
    inc_y = z["incumbent_y"] if z["incumbent_y"].size else None
    return nodes, float(z["incumbent_val"]), inc_y, int(z["nodes_processed"])


def solve_misdp(prob: MISDP, settings: Optional[Settings] = None,
                log: bool = False, checkpoint: Optional[str] = None,
                checkpoint_every: int = 50,
                resume: bool = False,
                sync_hook=None, device=None) -> BBResult:
    """Solve a MISDP by branch-and-bound with batched relaxation solves.

    ``checkpoint``: path for periodic frontier+incumbent snapshots (every
    ``checkpoint_every`` batches); ``resume=True`` restarts from it.

    ``device``: where the relaxations are solved; ``None`` means the CUDA
    card and raises without one, ``"cpu"`` solves on the CPU.

    ``sync_hook``: multi-host coordination callback (parallel/multihost's
    DistributedSync).  Called once per loop iteration IN LOCKSTEP across
    hosts with a SyncCtx; may adopt a remote incumbent value, donate or
    receive frontier nodes, and reports global termination.  While the
    hook is set the loop keeps spinning (syncing) even with an empty
    local frontier until every host is out of work."""
    settings = settings or Settings()
    bb = settings.bb
    feastol = bb.feastol
    # DIMACS-scaled check tolerance (usedimacsfeastol, cons_sdp.c:703-710):
    # the check callback's eigenvalue tolerance scales with 1 + sum|obj_j|
    # (dimacsfeastol = feastol * (1 + sum), cons_sdp.c:7716-7727)
    feastol_check = (feastol * (1.0 + float(np.sum(np.abs(prob.obj))))
                     if bb.usedimacsfeastol else feastol)
    t0 = time.time()

    m_user = prob.nvars   # report solutions in the user's variable space
    sol = _Solver(prob, settings, device=device)
    if sol.mesh is not None:
        # the node-batch axis must divide the mesh's "nodes" axis
        nodes_ax = sol.mesh.shape["nodes"]
        if bb.batch_size % nodes_ax:
            bb = dataclasses.replace(
                bb, batch_size=_round_up(bb.batch_size, nodes_ax))
    prob = sol.prob       # presolve may lift (quad upgrade) or shrink
    m = prob.nvars        # (fix_and_aggregate) the problem

    def to_user_space(yv):
        if yv is None:
            return None
        return postsolve_solution(prob, yv)[:m_user]
    integral = prob.integral
    obj = prob.obj
    stats = sol.stats
    has_rank1 = bool(np.any(sol.dense.rank1))

    incumbent_val = np.inf
    incumbent_y: Optional[np.ndarray] = None

    root_lb = prob.lb.copy()
    root_ub = prob.ub.copy()
    _apply_indicator_propagation(prob, root_lb, root_ub)
    # root propagation: activity-based bound tightening derives finite
    # boxes for free variables constrained only through rows (needed by
    # rank-1 secant cuts and spatial branching; SCIP-core propagation role)
    root_lb, root_ub, root_conflict = tighten_bounds(prob, root_lb, root_ub)
    if not root_conflict:
        # SDP-structural propagation (cons_sdp defaults: propupperbounds,
        # prop3minors, tightenbounds all TRUE)
        mv = matrix_view(prob)
        stats.redcost_tightenings += propagate_upper_bounds(
            prob, root_lb, root_ub, mv)
        stats.redcost_tightenings += propagate_3minors(
            prob, root_lb, root_ub, mv)
        stats.redcost_tightenings += tighten_bounds_onevar(
            prob, root_lb, root_ub)
        root_lb, root_ub, root_conflict = tighten_bounds(
            prob, root_lb, root_ub)
    if root_conflict and sync_hook is None:
        # with a sync hook the host must keep participating in the
        # lockstep protocol (it may also receive stolen work), so it
        # falls through to the loop with an empty frontier instead
        stats.wall_time = time.time() - t0
        return BBResult(SolveStatus.INFEASIBLE, None, None,
                        prob.external_objval(np.inf), 0.0, stats)

    def heuristic_ok(yv: np.ndarray) -> bool:
        """A heuristic point satisfies what the relaxation check leaves
        out: indicator links, bilinear lifts and rank-1 blocks."""
        return (_violated_indicator(prob, yv, feastol) < 0
                and not _lift_violated(prob, yv, feastol)
                and (not has_rank1 or r1.rank1_violation(
                    sol.dense, yv, feastol) is None))

    # optional root inner-approximation LP heuristic (heur_sdpinnerlp.c)
    if bb.heuristic_innerlp and not root_conflict:
        y_in, ok_in = probing.inner_lp_point(prob, settings,
                                             device=sol.full_iface.device)
        if ok_in and y_in is not None:
            okc, _ = check_points(sol.full_iface.data, y_in[None, :],
                                  root_lb[None, :], root_ub[None, :],
                                  feastol=feastol_check)
            if bool(okc[0].item()) and heuristic_ok(y_in):
                incumbent_val = float(obj @ y_in)
                incumbent_y = y_in.copy()
                stats.heur_found += 1

    # root analytic centers for warmstartiptype = 2 (prop_companalcent.c
    # one-shot trigger of SCIPrelaxSdpComputeAnalyticCenters); the host
    # loop's solves start from their convex combinations, turbo's do not,
    # as in the JAX package
    if (bb.warmstart and bb.warmstartiptype == 2 and not sol.lp_mode
            and not root_conflict):
        ac_y, ac_ok, ac_X = probing.analytic_center(
            sol.iface, root_lb[None, :], root_ub[None, :], with_X=True)
        if bool(ac_ok[0]):
            sol.iface.set_interior_point(ac_y[0], ac_X)

    # optional root OBBT (prop_sdpobbt.c)
    if bb.obbt_at_root and not sol.lp_mode and not root_conflict:
        targets = np.where(integral)[0]
        if targets.size:
            root_lb, root_ub, nt = probing.obbt_root(
                sol.full_iface, root_lb, root_ub, targets, None,
                bb.batch_size, feastol)
            stats.redcost_tightenings += nt

    # full automorphism group for orbital fixing (compute_symmetry_bliss
    # role; generators verified exactly — see core/symmetry.py)
    sym_group = None
    if (settings.use_symmetry
            and getattr(settings, "symmetry_mode", "lexrows") == "orbital"
            and not root_conflict):
        from scipsdp_tpu_torch.core.symmetry import automorphism_group
        sym_group = automorphism_group(prob)
        if sym_group.capped:
            stats.sym_capped = sym_group.capped
            if log:
                print(f"  [notice] automorphism search capped: "
                      f"{sym_group.capped}")
        if not sym_group.nontrivial:
            sym_group = None

    # device-resident B&B (core/turbo.py): when the problem fits turbo's
    # feature set, the whole tree loop runs on the device; the host loop
    # below remains the general and fallback engine.  Engagement as in the
    # JAX package: at once on the card (which JAX keys to a non-CPU
    # backend) or with "on"; on the CPU with "auto" the host loop runs
    # first and hands its frontier over once the tree proves big
    turbo_ok = (_turbo.eligible(prob, sol.dense, settings, sol.lp_mode)
                and checkpoint is None and not resume
                and sync_hook is None and sym_group is None
                and bb.slatercheck == 0)
    turbo_now = turbo_ok and (sol.iface.device.type == "cuda"
                              or bb.turbo == "on")
    turbo_deferred = turbo_ok and not turbo_now

    def add_turbo_stats(tres) -> None:
        stats.nodes += tres.nodes
        stats.relax_solves += tres.rounds
        stats.ipm_iterations += tres.iters
        stats.solver_calls += tres.nsolves
        stats.heur_found += tres.nheur
        stats.ndirect += tres.ndirect
        stats.nunsolved += tres.nunsolved
        stats.solve_time += tres.solve_time

    if turbo_now:
        tres = _turbo.solve_turbo(
            sol.dense, prob, dataclasses.replace(settings, bb=bb), root_lb,
            root_ub, incumbent_val, incumbent_y, data=sol.iface.data,
            rounds_per_dispatch=bb.turbo_rounds, mesh=sol.mesh)
        if tres is not None:
            add_turbo_stats(tres)
            stats.wall_time = time.time() - t0
            inc_y = tres.inc_y
            if tres.hit_node_limit or tres.hit_time_limit:
                status = (SolveStatus.NODE_LIMIT if tres.hit_node_limit
                          else SolveStatus.TIME_LIMIT)
                gap = (abs(tres.inc_val - tres.dual_bound)
                       / max(1e-9, abs(tres.inc_val))
                       if inc_y is not None else np.inf)
                return BBResult(
                    status,
                    (prob.external_objval(tres.inc_val)
                     if inc_y is not None else None),
                    to_user_space(inc_y),
                    prob.external_objval(tres.dual_bound), gap, stats)
            if inc_y is None:
                return BBResult(SolveStatus.INFEASIBLE, None, None,
                                prob.external_objval(np.inf), 0.0, stats)
            return BBResult(
                SolveStatus.OPTIMAL,
                prob.external_objval(tres.inc_val),
                to_user_space(inc_y),
                prob.external_objval(tres.inc_val), 0.0, stats)
        # turbo bailed (overflow / hard instances): fall through to the
        # host loop, which implements the full recovery ladder

    def _push_node(node: _Node, prio: float) -> None:
        frontier.push(node.lb, node.ub, prio, node.depth,
                      side=(node.bound, node.cuts, node.requeues,
                            node.ysol, node.xsol, node.wsrows, node.tier,
                            node.b1))

    # native slab-allocated node pool (SCIP-core tree-management role;
    # native/frontier.cpp), Python-heap fallback of the same pop order
    frontier = FrontierStore(m)
    if resume and checkpoint is not None and os.path.exists(checkpoint):
        nodes_ck, inc_v, inc_y, nproc = load_checkpoint(checkpoint)
        incumbent_val = inc_v
        incumbent_y = inc_y
        stats.nodes = nproc
        for nlb, nub, nbound, ndepth in nodes_ck:
            # restored nodes lose branching provenance: b1=None keeps
            # orbital fixing on its always-sound pin-all-ones fallback
            _push_node(_Node(nlb, nub, nbound, ndepth, b1=None), nbound)
        if not len(frontier) and incumbent_y is None:
            resume = False
    if (not len(frontier) and (not resume or incumbent_y is None)
            and not root_conflict):
        _push_node(_Node(root_lb, root_ub, -np.inf, 0), -np.inf)

    unbounded = False
    # a child keeps its parent's X for the primal warm start and for the
    # rounding problems of warmstartproject = 4
    want_x = bb.warmstartprimal or bb.warmstartproject == 4
    hit_limit: Optional[SolveStatus] = None
    turbo_open_bound = np.inf   # open bound of a limit-hit turbo handoff

    class _SyncCtx:
        """What a multi-host sync hook may see and do at the barrier
        (all frontier nodes are at rest when the hook runs)."""

        stopping = False   # this host hit a local limit (set by the loop)

        @property
        def nvars(self):
            return m   # internal variable-space dimension (node box width)

        @property
        def incumbent_val(self):
            return incumbent_val

        @property
        def nopen(self):
            return len(frontier)

        @property
        def best_open_bound(self):
            return (frontier.best_bound() if len(frontier) else np.inf)

        def adopt_incumbent(self, val: float) -> None:
            """A remote incumbent VALUE (its y stays on the host that
            found it): it prunes here from now on."""
            nonlocal incumbent_val
            if val < incumbent_val - 1e-12:
                incumbent_val = val

        def pop_for_donation(self, k: int):
            """Up to k cut-free nodes as plain (lb, ub, bound, depth)
            boxes; nodes carrying node-local cuts stay home (their cuts
            are only locally derived)."""
            out = []
            keep = []
            for (nlb, nub, prio, ndepth, side) in frontier.pop_upto(k):
                if side[1]:
                    keep.append((nlb, nub, prio, ndepth, side))
                else:
                    out.append((nlb, nub, side[0], ndepth))
            for (nlb, nub, prio, ndepth, side) in keep:
                frontier.push(nlb, nub, prio, ndepth, side=side)
            stats.ndonated += len(out)
            return out

        def push_nodes(self, nodes) -> None:
            for (nlb, nub, nbound, ndepth) in nodes:
                _push_node(_Node(np.asarray(nlb), np.asarray(nub),
                                 float(nbound), int(ndepth), b1=None),
                           float(nbound))
            stats.nstolen += len(nodes)

    sync_ctx = _SyncCtx() if sync_hook is not None else None

    while True:
        if hit_limit is None and stats.nodes >= bb.node_limit:
            hit_limit = SolveStatus.NODE_LIMIT
        if hit_limit is None and time.time() - t0 > bb.time_limit:
            hit_limit = SolveStatus.TIME_LIMIT
        if sync_hook is not None:
            sync_ctx.stopping = hit_limit is not None
            if sync_hook(sync_ctx):
                break
            if hit_limit is not None or not len(frontier):
                # keep participating (a stopped host's nodes can still be
                # stolen and drained by the others) until global done
                continue
        elif hit_limit is not None or not len(frontier):
            break

        # deferred turbo engagement (the CPU policy above): once the host
        # loop proves the tree large, ship the WHOLE frontier to the
        # device-resident path
        if (turbo_deferred and stats.relax_solves >= 3
                and len(frontier) >= 2 * bb.batch_size):
            popped = frontier.pop_upto(len(frontier))
            turbo_deferred = False
            if any(side[1] for (_, _, _, _, side) in popped):
                # nodes carry node-local cuts turbo cannot represent
                for (nlb, nub, nprio, ndepth, side) in popped:
                    frontier.push(nlb, nub, nprio, ndepth, side=side)
            else:
                init_nodes = [(nlb, nub, side[0])
                              for (nlb, nub, _p, _d, side) in popped]
                tbb = dataclasses.replace(
                    bb, node_limit=max(bb.node_limit - stats.nodes, 1),
                    time_limit=max(bb.time_limit - (time.time() - t0), 1.0))
                tres = _turbo.solve_turbo(
                    sol.dense, prob, dataclasses.replace(settings, bb=tbb),
                    root_lb, root_ub, incumbent_val, incumbent_y,
                    data=sol.iface.data,
                    rounds_per_dispatch=bb.turbo_rounds,
                    mesh=sol.mesh, init_nodes=init_nodes)
                if tres is None:
                    for (nlb, nub, nprio, ndepth, side) in popped:
                        frontier.push(nlb, nub, nprio, ndepth, side=side)
                else:
                    add_turbo_stats(tres)
                    if (tres.inc_y is not None
                            and tres.inc_val < incumbent_val - 1e-12):
                        incumbent_val = float(tres.inc_val)
                        incumbent_y = np.asarray(tres.inc_y)
                    if tres.hit_node_limit:
                        hit_limit = SolveStatus.NODE_LIMIT
                        turbo_open_bound = tres.dual_bound
                    elif tres.hit_time_limit:
                        hit_limit = SolveStatus.TIME_LIMIT
                        turbo_open_bound = tres.dual_bound
                    continue   # frontier drained: loop exits via the top

        # bound pruning slack: rank-1 heuristic incumbents are only
        # ~feastol-accurate, so close the tree at a matching relative gap
        # (the reference's own tolerances are 1e-5, BASELINE.md)
        prune_slack = max(1e-9, (2e-5 if has_rank1 else 1e-6)
                          * abs(incumbent_val if np.isfinite(incumbent_val)
                                else 0.0))
        batch: List[_Node] = []
        cap = (max(1, bb.batch_size // 4) if bb.node_selection == "dfs"
               else bb.batch_size)   # DFS: smaller batches, dive quickly
        while len(frontier) and len(batch) < cap:
            for (nlb, nub, _prio, ndepth, side) in frontier.pop_upto(
                    cap - len(batch)):
                nbound, ncuts, nreq, nysol, nxsol, nws, ntier, nb1 = side
                if nbound >= incumbent_val - prune_slack:
                    continue   # late bound pruning
                batch.append(_Node(nlb, nub, nbound, ndepth, ncuts, nreq,
                                   nysol, nxsol, nws, ntier, nb1))
        if not batch:
            if sync_hook is not None:
                continue
            break

        # orbital fixing (prop_sdpsymmetry.c): in each orbit of the
        # stabilizer of the node's 1-fixed binaries, a 0-fixed member
        # fixes the whole orbit to 0
        if sym_group is not None:
            from scipsdp_tpu_torch.core.symmetry import orbital_fixing
            for node in batch:
                node.lb, node.ub, nf, oinf = orbital_fixing(
                    sym_group, node.lb, node.ub, integral, eps=feastol,
                    branched_ones=node.b1)
                stats.orbital_fixings += nf
                if oinf:
                    # 0- and 1-fixed member in one orbit: node infeasible;
                    # a conflict box retires it at the presolve rung
                    node.lb = node.lb.copy()
                    node.ub = node.ub.copy()
                    node.lb[0], node.ub[0] = 1.0, 0.0

        # in-tree OBBT (prop_sdpobbt.c, PROP_FREQ=-1 in the reference —
        # opt-in here via obbt_freq): tighten continuous bounds of nodes
        # at qualifying depths with objective-cutoff probing solves
        if bb.obbt_freq > 0 and not sol.lp_mode:
            cont = np.where(~integral)[0]
            for node in batch:
                if (cont.size and node.depth > 0
                        and node.depth % bb.obbt_freq == 0):
                    node.lb, node.ub, nt = probing.obbt_root(
                        sol.full_iface, node.lb, node.ub, cont,
                        (incumbent_val if np.isfinite(incumbent_val)
                         else None),
                        bb.batch_size, feastol)
                    stats.redcost_tightenings += nt

        if bb.warmstart and bb.warmstartproject == 4 and not sol.lp_mode:
            # warmstartproject = 4: solve the rounding problems before the
            # SDP solves (determineWarmStartInformation, relax_sdp.c:3051);
            # the primal rounding LP can prune the node outright
            kept = []
            for node in batch:
                if node.ysol is None or node.xsol is None:
                    kept.append(node)
                    continue
                action, wy = probing.rounding_problem(
                    sol.prob, sol.dense, settings,
                    sol.buckets_to_blocks(sol.iface.data, node.xsol),
                    node.ysol, node.lb, node.ub,
                    cutoff=(incumbent_val if np.isfinite(incumbent_val)
                            else INF),
                    feastol=feastol, device=sol.iface.device)
                if action == "cutoff":
                    stats.roundingprobinf += 1
                    stats.nodes += 1
                    continue
                if action == "ok" and not bb.warmstartroundonlyinf:
                    node.ysol = wy
                else:
                    node.ysol = None   # coldstart (roundonlyinf / failure)
                kept.append(node)
            batch = kept
            if not batch:
                continue

        B = bb.batch_size
        lb = np.empty((B, m))
        ub = np.empty((B, m))
        for i in range(B):
            if i < len(batch):
                lb[i] = batch[i].lb
                ub[i] = batch[i].ub
            else:
                lb[i] = 1.0   # dummy slot: bound conflict, presolved away
                ub[i] = 0.0

        # per-node Slater accounting (checkSlaterCondition, sdpi.c:1518;
        # table_slater.c summary) — one extra batched probe solve
        if bb.slatercheck > 0 and not sol.lp_mode:
            sl = probing.slater_check(sol.full_iface, lb[: len(batch)],
                                      ub[: len(batch)])
            stats.slater_holds += int((sl == 1).sum())
            stats.slater_fails += int((sl == 0).sum())
            stats.slater_undecided += int((sl == -1).sum())
            # primal side per node (checkSlaterCondition's primal branch,
            # sdpi.c:1748-1812): all-finite node bounds make the primal
            # Slater condition hold STRUCTURALLY (every X is feasible via
            # the bound-slack variables, sdpi.c:1769-1781) — the aux solve
            # is needed only for boxes with an infinite side
            slp = np.empty(len(batch), dtype=np.int8)
            for bi in range(len(batch)):
                if bool(np.all(lb[bi] > -INF / 2)
                        & np.all(ub[bi] < INF / 2)):
                    slp[bi] = 1
                else:
                    slp[bi] = probing.slater_check_primal(
                        prob, settings, lb[bi], ub[bi],
                        device=sol.full_iface.device)
            stats.slater_primal_holds += int((slp == 1).sum())
            stats.slater_primal_fails += int((slp == 0).sum())
            stats.slater_primal_undecided += int((slp == -1).sum())
            if bb.slatercheck >= 2:
                print(f"node slater: dual {sl.tolist()} "
                      f"primal {slp.tolist()}")

        res = sol.solve_relaxations(batch, B, lb, ub)
        stats.nodes += len(batch)
        if bb.conflictconss and not sol.lp_mode:
            sol.collect_conflicts(batch, res)

        # batched fracdiving (heur_sdpfracdiving.c): every diving_freq
        # batches, dive all nodes of the batch one probing line each
        if (bb.diving_freq > 0 and not sol.lp_mode
                and stats.relax_solves % bb.diving_freq == 0):
            start_ok = np.isin(res.status, _OPT_CODES)
            start_ok[len(batch):] = False
            ydive, dfeas = probing.fracdive(sol.full_iface, lb, ub, res.y,
                                            integral, feastol,
                                            start_ok=start_ok)
            for i in range(len(batch)):
                if dfeas[i] and heuristic_ok(ydive[i]):
                    val = float(obj @ ydive[i])
                    if val < incumbent_val - 1e-12:
                        incumbent_val = val
                        incumbent_y = ydive[i].copy()
                        stats.heur_found += 1

        # batched rounding heuristics: nearest rounding
        # (heur_sdpfracround.c) and randomized rounding (heur_sdprand.c)
        if ((bb.heuristic_fracround or bb.heuristic_rand)
                and res.round_feas is not None):
            # SDP mode: rounded and checked on the device inside the
            # direct rung (which gates each heuristic's candidate itself)
            yr = res.round_y
            feas = res.round_feas.copy()
            for i in range(len(batch)):
                if feas[i] and has_rank1 and r1.rank1_violation(
                        sol.dense, yr[i], feastol) is not None:
                    feas[i] = False
                if feas[i] and _lift_violated(prob, yr[i], feastol):
                    feas[i] = False
        elif bb.heuristic_fracround or bb.heuristic_rand:
            # LP mode: the LP points rounded on the host, each candidate
            # set checked against the full data in one batched check
            rng_h = np.random.default_rng(settings.seed + stats.nodes)
            cands = []
            if bb.heuristic_fracround:
                yr0 = res.y.copy()
                yr0[:, integral] = np.round(yr0[:, integral])
                cands.append(yr0)
            if bb.heuristic_rand:
                yr1 = res.y.copy()
                frac1 = yr1[:, integral] - np.floor(yr1[:, integral])
                yr1[:, integral] = np.floor(yr1[:, integral]) + (
                    rng_h.random(frac1.shape) < frac1)
                cands.append(yr1)
            feas = np.zeros(B, dtype=bool)
            yr = res.y.copy()
            best = np.full(B, np.inf)
            for yc in cands:
                yc = np.clip(yc, lb, ub)
                for link in prob.indicators:
                    on = yc[:, link.binvar] >= 0.5
                    yc[on, link.slackvar] = 0.0
                f, _ = check_points(sol.full_iface.data, yc, lb, ub,
                                    feastol=feastol_check)
                f = f.cpu().numpy()
                for i in range(len(batch)):
                    if f[i] and has_rank1 and r1.rank1_violation(
                            sol.dense, yc[i], feastol) is not None:
                        f[i] = False
                    if f[i] and _lift_violated(prob, yc[i], feastol):
                        f[i] = False
                vals = yc @ obj
                better = f & (vals < best)
                yr[better] = yc[better]
                best[better] = vals[better]
                feas = feas | better
        else:
            feas = np.zeros(B, dtype=bool)
            yr = res.y

        for i, node in enumerate(batch):
            st = res.status[i]
            if st in (SolverResultStatus.INFEASIBLE,
                      SolverResultStatus.PRESOLVED_INFEASIBLE):
                continue  # cutoff
            if st == SolverResultStatus.UNBOUNDED:
                unbounded = True
                continue
            if st in (SolverResultStatus.FAILED,
                      SolverResultStatus.ITERLIMIT,
                      SolverResultStatus.TIMELIMIT):
                stats.nunsolved += 1
                bound = node.bound  # no new information; keep parent bound
                y = None
            else:
                # monotone: the parent bound stays valid for the child, so
                # a looser rescue bound (BOUND_ONLY salvage) never weakens
                # the subtree's pruning
                bound = max(float(res.objval[i]), node.bound)
                y = res.y[i]

            if bound >= incumbent_val - prune_slack + bb.gaplimit * abs(
                    incumbent_val):
                continue  # bound pruning

            # heuristic incumbent
            if y is not None and feas[i]:
                val = float(obj @ yr[i])
                if val < incumbent_val - 1e-12:
                    incumbent_val = val
                    incumbent_y = yr[i].copy()
                    stats.heur_found += 1

            if (st == SolverResultStatus.PRESOLVED_OPTIMAL
                    and not has_rank1 and not sol.lp_mode):
                # all vars fixed & feasible: leaf with known value (in LP
                # mode / with rank-1 constraints the presolve decision only
                # covers the relaxation data, so fall through to the full
                # acceptance check below)
                if bound < incumbent_val - 1e-12:
                    incumbent_val = bound
                    incumbent_y = 0.5 * (node.lb + node.ub)
                continue

            # acceptance check of the relaxation solution
            enforce_ind = -1
            spatial = None   # (var, splitval, child cuts) for rank-1
            lp_enforced = False  # exact-SDP enforcement decided to branch
            if y is not None and st in _OPT_CODES:
                frac = np.abs(y[integral] - np.round(y[integral]))
                if frac.size == 0 or np.max(frac) <= feastol:
                    enforce_ind = _violated_indicator(prob, y, feastol)
                    if enforce_ind < 0 and sol.lp_mode:
                        # LP mode enforcement (consEnfolpSdp:8235): an
                        # integral LP solution must still be SDP-feasible;
                        # if not, separate more cuts and requeue the node —
                        # and after ``enforce_after`` fruitless rounds,
                        # solve the node's TRUE SDP in probing
                        # (enforcesdp, cons_sdp.c:8276-8423)
                        ok, _ = check_points(
                            sol.full_iface.data, y[None, :],
                            node.lb[None, :], node.ub[None, :],
                            feastol=feastol_check)
                        if not bool(ok[0].item()):
                            if (bb.enforcesdp
                                    and node.requeues >= bb.enforce_after):
                                stats.nenforce_sdp += 1
                                er = sol.full_iface.solve_batch(
                                    node.lb[None, :], node.ub[None, :])
                                est = int(er.status[0])
                                if est in _INFEAS_CODES:
                                    continue  # exact cutoff (:8338)
                                if est in _OPT_CODES:
                                    eb = float(er.objval[0])
                                    ey = er.y[0]
                                    if eb >= (incumbent_val - prune_slack
                                              + bb.gaplimit
                                              * abs(incumbent_val)):
                                        continue  # exact bound prunes
                                    efr = np.abs(ey[integral]
                                                 - np.round(ey[integral]))
                                    eind = _violated_indicator(prob, ey,
                                                               feastol)
                                    if ((efr.size == 0
                                         or np.max(efr) <= feastol)
                                            and eind < 0):
                                        # exact node optimum is feasible:
                                        # node solved (SCIPaddSol +
                                        # cutoff, :8355-8362)
                                        okx, _ = check_points(
                                            sol.full_iface.data,
                                            ey[None, :], node.lb[None, :],
                                            node.ub[None, :],
                                            feastol=feastol_check)
                                        if bool(okx[0].item()):
                                            if eb < incumbent_val - 1e-12:
                                                incumbent_val = eb
                                                incumbent_y = ey.copy()
                                            continue
                                    # fractional exact solution: adopt the
                                    # exact bound + point and branch on it
                                    y = ey
                                    bound = max(bound, eb)
                                    enforce_ind = eind
                                    # LP bound multipliers are stale for
                                    # the SDP bound: no dual fixing here
                                    res.xlb[i] = 0.0
                                    res.xub[i] = 0.0
                                    lp_enforced = True
                                # FAILED exact solve: fall back to
                                # separation / requeue below
                            if not lp_enforced:
                                if node.requeues < 20:
                                    sol._separate(y[None, :], 1)
                                    node.bound = bound
                                    node.requeues += 1
                                    _push_node(node, bound)
                                    continue
                                # separation + enforcement exhausted:
                                # branch on an unfixed integer for sound
                                # progress instead of dropping the node
                                unfx = np.where(
                                    integral
                                    & (node.ub - node.lb > feastol))[0]
                                if unfx.size == 0:
                                    stats.ndropped_nodes += 1
                                    print("  [notice] LP-mode node "
                                          "undecidable (separation + "
                                          "enforcement exhausted); "
                                          "dropped")
                                    continue
                                y = None
                                lp_enforced = True
                    if (enforce_ind < 0 and not lp_enforced
                            and prob.liftinfo):
                        # bilinear-lift enforcement (quad upgrade): find the
                        # most violated identity w = y_i y_j, branch on the
                        # wider factor at its current value; children get
                        # refreshed McCormick envelopes for their boxes
                        from scipsdp_tpu_torch.core.quadupgrade import \
                            mccormick_rows
                        best_v, best_t = 10.0 * feastol, None
                        for (w, vi, vj) in prob.liftinfo:
                            viol = abs(y[w] - y[vi] * y[vj])
                            if viol > best_v:
                                best_v, best_t = viol, (w, vi, vj)
                        if best_t is not None:
                            w, vi, vj = best_t
                            wi = node.ub[vi] - node.lb[vi]
                            wj = node.ub[vj] - node.lb[vj]
                            j_br = vi if (vi == vj or wi >= wj) else vj
                            touched = [t for t in prob.liftinfo
                                       if j_br in (t[1], t[2])]

                            def child_mcc(clb, cub, touched=touched):
                                return [(g, rhs) for g, rhs in
                                        mccormick_rows(m, touched, clb, cub)]

                            spatial = (j_br, _split_value(
                                y[j_br], node.lb[j_br], node.ub[j_br]),
                                child_mcc)
                        else:
                            # identities hold: solution is truly feasible
                            if bound < incumbent_val - 1e-12:
                                incumbent_val = bound
                                incumbent_y = y.copy()
                            continue
                    if (enforce_ind < 0 and spatial is None
                            and not lp_enforced and has_rank1):
                        v = r1.rank1_violation(sol.dense, y, feastol)
                        if v is not None:
                            # rank-1 extreme-point heuristic: re-solve the
                            # node with an objective perturbation driving
                            # the solution toward a rank-1 extreme point
                            # of the (near-)optimal face, then project and
                            # verify; accepts the node when the heuristic
                            # value meets the node bound
                            node_done = False

                            def try_candidate(yc):
                                nonlocal incumbent_val, incumbent_y, node_done
                                yp = yc.copy()
                                fr = np.abs(yp[integral]
                                            - np.round(yp[integral]))
                                if fr.size and np.max(fr) > feastol:
                                    return False
                                yp[integral] = np.round(yp[integral])
                                # heuristic candidates carry a small
                                # least-squares completion residual; accept
                                # at a modestly relaxed tolerance (their
                                # objective is evaluated exactly)
                                okp, _ = check_points(
                                    sol.iface.data, yp[None, :],
                                    node.lb[None, :], node.ub[None, :],
                                    feastol=10.0 * feastol_check)
                                if not (bool(okp[0].item())
                                        and _violated_indicator(
                                            prob, yp, feastol) < 0
                                        and r1.rank1_violation(
                                            sol.dense, yp, feastol) is None):
                                    return False
                                val = float(obj @ yp)
                                if val < incumbent_val - 1e-12:
                                    incumbent_val = val
                                    incumbent_y = yp.copy()
                                    stats.heur_found += 1
                                if val <= bound + max(
                                        1e-6, 2e-5 * abs(bound)):
                                    node_done = True
                                return True

                            def node_viol(yv, node=node):
                                return sol.violation(yv, node.lb, node.ub)

                            # candidate 0: the relaxation point itself
                            # (PSD/LP-feasible at solver tolerance; accepted
                            # when its rank-1 violation is within feastol);
                            # candidate 1: the sign-enumerating rank-1
                            # completion at the relaxation solution
                            if not (try_candidate(y) or try_candidate(
                                    r1.rank1_complete(sol.dense, y, obj,
                                                      viol_fn=node_viol))):
                                # candidates 2..: perturbed re-solves that
                                # land on an extreme point of the optimal
                                # face — the eigen-directed perturbation
                                # plus random directions (deterministic
                                # seed), solved as ONE batched dispatch
                                oscale = max(1.0, np.abs(obj).max())
                                dirs = [r1.eigen_perturbation(sol.dense, y)]
                                rng = np.random.default_rng(
                                    settings.seed + stats.nodes)
                                for _ in range(4):
                                    rd = rng.standard_normal(m)
                                    rd[integral] = 0.0
                                    dirs.append(rd)
                                dirs = [p / max(1.0, np.abs(p).max())
                                        for p in dirs]
                                P = len(dirs)
                                objs = np.stack(
                                    [obj - 1e-2 * oscale * p for p in dirs])
                                rp = sol.iface.solve_batch(
                                    np.tile(node.lb, (P, 1)),
                                    np.tile(node.ub, (P, 1)), obj=objs)
                                found_dir = None
                                for di, pert in enumerate(dirs):
                                    if rp.status[di] != int(
                                            SolverResultStatus.OPTIMAL):
                                        continue
                                    if try_candidate(rp.y[di]) or \
                                       try_candidate(r1.rank1_project(
                                            sol.dense, rp.y[di])) or \
                                       try_candidate(r1.rank1_complete(
                                            sol.dense, rp.y[di], obj,
                                            viol_fn=node_viol)):
                                        found_dir = pert
                                        break
                                if found_dir is not None and not node_done:
                                    # polish: shrink the perturbation to
                                    # reduce the O(eps) objective distortion
                                    # (both eps levels in one dispatch,
                                    # padded to the P-row batch)
                                    epss = (1e-3, 1e-4)
                                    objs2 = np.stack(
                                        [obj - e * oscale * found_dir
                                         for e in epss]
                                        + [obj] * (P - len(epss)))
                                    lbp = np.tile(node.lb, (P, 1))
                                    ubp = np.tile(node.ub, (P, 1))
                                    lbp[len(epss):] = 1.0  # dummy slots:
                                    ubp[len(epss):] = 0.0  # presolved away
                                    rp2 = sol.iface.solve_batch(
                                        lbp, ubp, obj=objs2)
                                    for ke in range(len(epss)):
                                        if rp2.status[ke] != int(
                                                SolverResultStatus.OPTIMAL):
                                            break
                                        ok_polish = (
                                            try_candidate(r1.rank1_project(
                                                sol.dense, rp2.y[ke]))
                                            or try_candidate(
                                                r1.rank1_complete(
                                                    sol.dense, rp2.y[ke],
                                                    obj, viol_fn=node_viol)))
                                        if not ok_polish or node_done:
                                            break
                            if node_done:
                                continue
                            k, s, t, _ = v
                            j = r1.rank1_branch_var(
                                sol.dense, k, s, t, y, node.lb, node.ub,
                                feastol)
                            if j >= 0:
                                spatial = (j, _split_value(
                                    y[j], node.lb[j], node.ub[j]),
                                    r1.rank1_cuts(sol.dense, k, s, t,
                                                  node.lb, node.ub))
                    if (enforce_ind < 0 and spatial is None
                            and not lp_enforced):
                        if bound < incumbent_val - 1e-12:
                            incumbent_val = bound
                            incumbent_y = y.copy()
                        continue

            # reduced-cost / dual fixing propagation on the node bounds
            # (prop_sdpredcost.c analog; children inherit the tightening)
            if (st == SolverResultStatus.OPTIMAL
                    and np.isfinite(incumbent_val)):
                stats.redcost_tightenings += redcost_tighten(
                    node.lb, node.ub, res.xlb[i], res.xub[i],
                    bound, incumbent_val, integral, feastol)

            # branching
            if enforce_ind >= 0:
                j, split = enforce_ind, 0.0
            elif spatial is not None:
                j, split, child_cuts = spatial
            else:
                j = (select_branch_var(y, obj, integral, feastol,
                                       bb.branching_rule)
                     if y is not None else -1)
                if j < 0:
                    unfixed = np.where(
                        integral & (node.ub - node.lb > feastol))[0]
                    if unfixed.size == 0:
                        continue  # nothing to do
                    j = int(unfixed[0])
                    split = np.floor(0.5 * (node.lb[j] + node.ub[j]))
                else:
                    split = np.floor(y[j])

            if spatial is not None:
                # continuous split at the current value; both children get
                # locally valid cuts for their (shrunken) boxes — a static
                # list (rank-1 secants) or a per-child generator (McCormick
                # envelopes, which depend on the child box)
                children = []
                for side in (0, 1):
                    clb, cub = node.lb.copy(), node.ub.copy()
                    if side == 0:
                        cub[j] = split
                    else:
                        clb[j] = split
                    gen = (child_cuts(clb, cub) if callable(child_cuts)
                           else child_cuts)
                    children.append((clb, cub, list(node.cuts) + list(gen),
                                     node.b1))
            else:
                lb1, ub1 = node.lb.copy(), node.ub.copy()
                lb2, ub2 = node.lb.copy(), node.ub.copy()
                ub1[j] = split
                lb2[j] = split + 1.0
                # up-child of a binary at split 0: a BRANCHED 1-fixing
                # (the orbital-fixing stabilizer pins exactly these)
                b1_up = node.b1
                if (node.b1 is not None and integral[j]
                        and lb2[j] >= 0.5 and node.lb[j] < 0.5
                        and node.ub[j] <= 1.0 + feastol
                        and node.lb[j] >= -feastol):
                    b1_up = node.b1 | {int(j)}
                children = [(lb1, ub1, list(node.cuts), node.b1),
                            (lb2, ub2, list(node.cuts), b1_up)]

            for clb, cub, ccuts, cb1 in children:
                _apply_indicator_propagation(prob, clb, cub)
                clb, cub, child_conflict = sol.propagate_node(
                    clb, cub, node.depth + 1)
                if child_conflict:
                    # conflict analysis on the propagation conflict
                    # (cons_sdp.c:4793): learn a binary no-good
                    if bb.conflict_nogoods:
                        sol.learn_nogood(clb, cub, root_lb, root_ub)
                    continue
                if np.all(clb <= cub + feastol):
                    prio = (bound if bb.node_selection != "dfs"
                            else -float(node.depth + 1))
                    # children inherit the tier that solved THIS node
                    # (cons_savedsdpsettings, relax_sdp.c:4194-4203)
                    ctier = None
                    if (res.tier is not None
                            and np.isfinite(res.tier[i]).any()):
                        ctier = res.tier[i].copy()
                    # warmstartpreoptsol: store the captured PRE-optimal
                    # iterate instead of the optimum (more interior)
                    ws_y, ws_X = y, None
                    if (bb.warmstart and res.pre_has is not None
                            and bool(res.pre_has[i])):
                        ws_y = res.pre_y[i]
                        if want_x and res.pre_X is not None:
                            ws_X = [np.asarray(res.pre_X[t][i])
                                    for t in range(len(res.pre_X))]
                    elif bb.warmstart and want_x and y is not None:
                        ws_X = sol.node_X_buckets(res, i)
                    _push_node(
                        _Node(clb, cub, bound, node.depth + 1, ccuts,
                              ysol=(ws_y.copy() if ws_y is not None
                                    and bb.warmstart else None),
                              xsol=ws_X,
                              wsrows=sol.last_q,
                              tier=ctier,
                              b1=cb1),
                        prio)

        if (checkpoint is not None
                and stats.relax_solves % max(checkpoint_every, 1) == 0):
            save_checkpoint(checkpoint, frontier, incumbent_val,
                            incumbent_y, stats)

        if log:
            # live display columns (disp_sdpiterations/avgiterations/
            # penalty/unsolved analogs)
            if stats.relax_solves == 1:
                print(f"{'nodes':>7} {'open':>6} {'incumbent':>14} "
                      f"{'dualbound':>14} {'sdpiter':>8} {'avgiter':>8} "
                      f"{'fast':>5} {'pen':>4} {'uns':>4} {'cuts':>5}")
            fb = (frontier.best_bound() if len(frontier)
                  else incumbent_val)
            avg = stats.ipm_iterations / max(stats.relax_solves, 1)
            print(f"{stats.nodes:>7} {len(frontier):>6} "
                  f"{prob.external_objval(incumbent_val):>14.6g} "
                  f"{prob.external_objval(fb):>14.6g} "
                  f"{stats.ipm_iterations:>8} {avg:>8.1f} "
                  f"{stats.ndirect:>5} "
                  f"{stats.npenalty:>4} {stats.nunsolved:>4} "
                  f"{stats.ncuts:>5}")

    stats.wall_time = time.time() - t0

    if unbounded and incumbent_y is None:
        return BBResult(SolveStatus.UNBOUNDED, None, None,
                        -np.inf * prob.objsense, np.inf, stats)

    dual_bound_internal = min(incumbent_val, turbo_open_bound)
    if len(frontier):
        dual_bound_internal = min(
            dual_bound_internal,
            min(side[0] for (_, _, _, _, side) in frontier.dump()))
    if hit_limit is not None:
        objval = (prob.external_objval(incumbent_val)
                  if incumbent_y is not None else None)
        gap = (abs(incumbent_val - dual_bound_internal)
               / max(1e-9, abs(incumbent_val))
               if incumbent_y is not None else np.inf)
        return BBResult(hit_limit, objval, to_user_space(incumbent_y),
                        prob.external_objval(dual_bound_internal), gap, stats)

    if incumbent_y is None:
        return BBResult(SolveStatus.INFEASIBLE, None, None,
                        prob.external_objval(np.inf), 0.0, stats)

    return BBResult(
        SolveStatus.OPTIMAL,
        prob.external_objval(incumbent_val),
        to_user_space(incumbent_y),
        prob.external_objval(incumbent_val),
        0.0,
        stats,
    )
