"""Device-resident branch-and-bound ("turbo" path), PyTorch.

Counterpart of ``scipsdp_tpu/core/turbo.py``.  For the common MISDP shape
— integer branching (indicator constraints included), no rank-1 or
bilinear-lift enforcement, no LP outer approximation — the whole tree loop
vectorizes, so the frontier lives on the device as a fixed-capacity slab
of node boxes (:class:`TurboState`) and every round is tensor work there:

    select the B best-bound nodes (stable sort, lower slot first among
    ties)  ->  batched IPM relaxation (``ops/ipm.ipm_solve``) with the
    Gamma = 1 probe rung and one penalty rung for slots that FAILED  ->
    rounding heuristics checked by :func:`psd_feasible` (the probe
    Cholesky, #1) + incumbent update  ->  vectorized branching (the four
    reference rules)  ->  children into free slots

Fallback contract: :func:`solve_turbo` returns ``None`` when it cannot
finish faithfully (frontier overflow, a node it cannot branch, too many
unsolved relaxations); the caller then runs the host loop, which has the
full recovery ladder and every enforcement feature.

The host reads the device at most three times a round — whether the round
runs, and whether each rung has a slot to take — plus ``ipm_solve``'s own
reads and one packed summary a chunk.  The frontier tensors never leave
the device inside the loop; only the final incumbent does.

Not carried over, as TPU workarounds: the jit caches of chunks and state
builders (``_CHUNK_CACHE``, ``_INIT_CACHE``, ``_chunk_for``,
``mesh_key``) — nothing here is compiled, :func:`_init_state` builds the
slab on the device directly; the HBM width cap ``w_cap`` and the executable
eviction ``clear_cache``; the relay-watchdog schedule of rounds a chunk
(the production-shape start at one round and the wall-clock shrink and
grow rules): here a chunk starts at ``min(8, rounds_per_dispatch)`` rounds
and doubles after each chunk while it stays within ``rounds_per_dispatch``,
which is what the JAX package does whenever its dispatches are quick.

Over a device mesh (``parallel/mesh.py``) the rounds' relaxation solves
are sharded over it; the frontier slab and ``psd_feasible`` stay on the
mesh's first device, and the width is the configured batch from the start
(no ramp), as in the JAX package.

Reference behavior mirrored: calcRelax outcome rules (relax_sdp.c:4205-
4346), fracround/randround heuristics (heur_sdpfracround.c, heur_sdprand.c),
best-first selection (scipsdpdefplugins.c:152-158), branching rules
(branch_sdp*.c), bound pruning at the reference tolerances (BASELINE.md).
"""

from __future__ import annotations

import logging
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from scipsdp_tpu_torch.models.problem import MISDP, DenseSDPData
from scipsdp_tpu_torch.ops.ipm import (IPMData, _chol_probe, build_ipm_data,
                                       ipm_solve)
from scipsdp_tpu_torch.parallel.mesh import ShardedIPM
from scipsdp_tpu_torch.utils.config import (IPMSettings, Settings,
                                            resolve_backend_autos)
from scipsdp_tpu_torch.utils.status import SolverResultStatus

_log = logging.getLogger(__name__)

OPT = int(SolverResultStatus.OPTIMAL)
PRE_OPT = int(SolverResultStatus.PRESOLVED_OPTIMAL)
PRE_INF = int(SolverResultStatus.PRESOLVED_INFEASIBLE)
INFEAS = int(SolverResultStatus.INFEASIBLE)
FAILED = int(SolverResultStatus.FAILED)
ITERLIM = int(SolverResultStatus.ITERLIMIT)


class TurboState(NamedTuple):
    """Whole B&B state, on the device between chunks."""

    flb: torch.Tensor       # (N, m) frontier node lower bounds
    fub: torch.Tensor       # (N, m)
    fbound: torch.Tensor    # (N,) parent dual bound (minimization sense)
    fwarm: torch.Tensor     # (N, m) parent relaxation solution
    fwok: torch.Tensor      # (N,) warmstart validity
    fvalid: torch.Tensor    # (N,) slot occupied
    inc_val: torch.Tensor   # () incumbent objective (internal sense)
    inc_y: torch.Tensor     # (m,)
    has_inc: torch.Tensor   # () bool
    nodes: torch.Tensor     # () int32 processed node count
    rounds: torch.Tensor    # () executed (non-idle) rounds
    iters: torch.Tensor     # () accumulated IPM iterations
    nsolves: torch.Tensor   # () solver invocations (incl. probe rungs)
    nheur: torch.Tensor     # () heuristic incumbents
    ndirect: torch.Tensor   # () instances decided at the direct rung
    nunsolved: torch.Tensor  # () relaxations with no usable information
    npruned_inf: torch.Tensor  # () nodes cut off as infeasible
    overflow: torch.Tensor  # () bool: slab full or a node turbo cannot branch


def eligible(prob: MISDP, dense: DenseSDPData, settings: Settings,
             lp_mode: bool) -> bool:
    """The turbo path covers exactly the feature set it implements; any
    other problem goes through the general host loop."""
    bb = settings.bb
    return (
        not lp_mode
        and not prob.liftinfo
        and not bool(np.any(dense.rank1))
        and bool(np.any(prob.integral))   # pure-continuous = 1 root solve;
        #                                   the host ladder handles it
        and bb.node_selection == "bestbound"
        and bb.diving_freq == 0
        and not (bb.warmstart and bb.warmstartproject == 4)
        and bb.turbo != "off"
    )


def _branch_scores(y, frac, obj, rule):
    """Vectorized branching scores ((B, m) -> per-var score); mirrors
    core/branching.select_branch_var (branch_sdp*.c)."""
    inf_score = torch.minimum(frac, 1.0 - frac)
    if rule == "mostfrac":
        return frac
    if rule == "mostinf":
        return inf_score
    if rule == "objective":
        return obj.abs()[None, :] + 1e-9 * inf_score
    # default: infobjective
    return inf_score * torch.clamp_min(obj.abs(), 1e-6)[None, :]


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the 1-D ``x`` in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values (``torch.topk`` orders ties otherwise)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def probe_stacks(data: IPMData, yc: torch.Tensor,
                 chktol: float) -> List[torch.Tensor]:
    """Per bucket, the float32 stacks (B, K_t, n_t, n_t) that
    :func:`psd_feasible` factors: Z(y) + chktol * I on the real
    dimensions (assembled in float64), the identity on the padding."""
    yx = torch.cat([yc, yc.new_zeros((yc.shape[0], 1))], dim=1)
    out = []
    for t in range(data.nbuckets):
        Z = torch.einsum("kjab,xj->xkab", data.A[t], yx) - data.C[t][None]
        dm = data.dimmask[t]
        outer = dm[:, :, None] & dm[:, None, :]
        eye = torch.eye(Z.shape[-1], dtype=Z.dtype, device=Z.device)
        out.append(torch.where(outer[None], Z + chktol * eye, eye)
                   .to(torch.float32))
    return out


def psd_feasible(data: IPMData, yc: torch.Tensor, chktol: float,
                 feastol: float, ipms: IPMSettings) -> torch.Tensor:
    """Batched feasibility of points: Z(y) + chktol*I PSD (the probe
    Cholesky — the same decision as lambda_min >= -chktol, cons_sdp.c:672,
    without an eigendecomposition) and the LP rows at ``feastol``.  The
    factorization runs in float32 (the shift dwarfs its rounding at these
    scales); Z itself is assembled in float64."""
    ok = torch.ones((yc.shape[0],), dtype=torch.bool, device=yc.device)
    for Zs in probe_stacks(data, yc, chktol):
        L = _chol_probe(Zs, ipms)
        ok = ok & ~torch.isnan(L).any(dim=(1, 2, 3))
    yx = torch.cat([yc, yc.new_zeros((yc.shape[0], 1))], dim=1)
    Gy = torch.einsum("pm,xm->xp", data.G, yx)
    return ok & (Gy >= data.h[None] - feastol).all(dim=1)


def make_round(settings: Settings, integral: np.ndarray, B: int,
               ind_pairs: Optional[np.ndarray] = None,
               check_feastol: Optional[float] = None, device="cpu",
               solve=ipm_solve):
    """Build the chunk function ``chunk_fn(data, st, gen, node_limit, k)``
    over (IPMData, TurboState) at batch width ``B`` on ``device``.  The
    direct, probe and penalty solves go through ``solve`` (``ipm_solve``,
    or ``parallel/mesh.ShardedIPM`` over a mesh); the rest of a round
    stays on ``device``.

    ``ind_pairs``: (K, 2) [binvar, slackvar] indicator links; vectorized
    propagation (binvar fixed 1 => slack <= 0), candidate/leaf indicator
    feasibility, and enforcement branching on a violated binvar (the
    cons_indicator roles)."""
    bb = settings.bb
    feastol = bb.feastol
    # solution-check PSD tolerance; DIMACS-scaled when
    # bb.usedimacsfeastol (cons_sdp.c:703-710)
    chktol = feastol if check_feastol is None else float(check_feastol)
    m = int(integral.shape[0])
    mp = m + 1
    dev = torch.device(device)
    integral_d = torch.as_tensor(integral, dtype=torch.bool, device=dev)
    warm_on = bool(bb.warmstart)
    ipms = settings.ipm
    nind = 0 if ind_pairs is None else int(ind_pairs.shape[0])
    if nind:
        ibv = torch.as_tensor(ind_pairs[:, 0], dtype=torch.long, device=dev)
        isv = torch.as_tensor(ind_pairs[:, 1], dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)
    inf = float("inf")

    def isin(status, codes):
        """``jnp.isin(status, codes)`` without a device copy of codes."""
        return (status == codes[0]) | (status == codes[1])

    def ind_violated(yc, lo=None, hi=None):
        """(B, K) indicator violations of candidate points; with lo/hi
        given, only links whose binvar is still UNFIXED count (fixed
        binvars are handled by propagation)."""
        v = (yc[:, ibv] >= 0.5) & (yc[:, isv] > feastol)
        if lo is not None:
            v = v & ((hi[:, ibv] - lo[:, ibv]) > feastol)
        return v

    def round_fn(data: IPMData, st: TurboState, gen) -> TurboState:
        obj = data.b_base[:m]
        prune_slack = torch.clamp_min(
            1e-6 * torch.where(st.has_inc, st.inc_val.abs(), 0.0), 1e-9)
        cutoff = torch.where(st.has_inc,
                             st.inc_val - prune_slack
                             + bb.gaplimit * st.inc_val.abs(), inf)

        # ---- selection: best-bound top-B ---------------------------------
        prio = torch.where(st.fvalid, st.fbound, inf)
        idx = top_k_indices(-prio, B)
        sel_valid = st.fvalid[idx]
        sel_live = sel_valid & (st.fbound[idx] < cutoff)
        fvalid = st.fvalid.index_fill(0, idx, False)

        lb = torch.where(sel_live[:, None], st.flb[idx], 1.0)
        ub = torch.where(sel_live[:, None], st.fub[idx], 0.0)
        if nind:
            # indicator propagation (binvar fixed 1 => slack <= 0) at
            # selection time, so stored child boxes stay plain
            on = lb[:, ibv] >= 0.5
            cur = ub[:, isv]
            ub[:, isv] = torch.where(on, torch.clamp_max(cur, 0.0), cur)
        par_bound = torch.where(sel_live, st.fbound[idx], inf)
        zcol = lb.new_zeros((B, 1))
        lbx = torch.cat([lb, zcol], dim=1)
        ubx = torch.cat([ub, zcol], dim=1)
        bmat = data.b_base[None].expand(B, mp).clone()

        if warm_on:
            out = solve(data, bmat, lbx, ubx,
                        warm_y=torch.cat([st.fwarm[idx], zcol], dim=1),
                        warm_mask=st.fwok[idx] & sel_live, settings=ipms)
        else:
            out = solve(data, bmat, lbx, ubx, settings=ipms)
        status = out.status
        y = out.y[:, :m]
        bound = out.dobj

        # ---- rung 2: feasibility probe for failed instances --------------
        # (Gamma = 1, zero objective; optimal r above the margin proves
        # dual infeasibility, sdpi.c:3450-3490)
        failed0 = sel_live & isin(status, (FAILED, ITERLIM))
        nsolves = st.nsolves + 1
        if bool(failed0.any()):                 # host read: rung 2
            bprobe = torch.zeros((B, mp), dtype=lbx.dtype, device=dev)
            bprobe[:, m] = 1.0
            ubp = ubx.clone()
            ubp[:, m] = 1e20
            # decided instances get a conflict box: presolve retires them
            lbq = torch.where(failed0[:, None], lbx, 1.0)
            ubq = torch.where(failed0[:, None], ubp, 0.0)
            outp = solve(data, bprobe, lbq, ubq, settings=ipms)
            margin = ipms.peninfeasadjust * max(ipms.feastol, ipms.gaptol)
            proved = failed0 & (outp.status == OPT) & (outp.r > margin)
            status = status.masked_fill(proved, INFEAS)
            nsolves = nsolves + 1

        # ---- rung 3: one penalty solve at the ladder's start tier
        # (sdpi.c:3497-3599; Gamma = penaltyparam).  feasorig results
        # (r <= feastol) are adopted as OPTIMAL; converged penalty solves
        # with residual r still yield a valid dual bound for pruning
        # (GetLowerObjbound role, sdpi.c:3551)
        failed1 = sel_live & isin(status, (FAILED, ITERLIM))
        gam_mid = float(ipms.penaltyparam)
        bound_pen = torch.full((B,), -inf, dtype=bound.dtype, device=dev)
        has_pen = torch.zeros((B,), dtype=torch.bool, device=dev)
        feas_pen = has_pen
        if bool(failed1.any()):                 # host read: rung 3
            bpen = bmat.clone()
            bpen[:, m] = gam_mid
            ubp = ubx.clone()
            ubp[:, m] = 1e20
            lbq = torch.where(failed1[:, None], lbx, 1.0)
            ubq = torch.where(failed1[:, None], ubp, 0.0)
            outp = solve(data, bpen, lbq, ubq, settings=ipms)
            has_pen = failed1 & (outp.status == OPT)
            feas_pen = has_pen & (outp.r <= feastol)
            status = status.masked_fill(feas_pen, OPT)
            y = torch.where(feas_pen[:, None], outp.y[:, :m], y)
            bound_pen = torch.where(has_pen, outp.dobj - gam_mid * outp.r,
                                    bound_pen)
            nsolves = nsolves + 1
        # adopted instances take the penalty value (their direct-solve
        # dobj carries no meaning); converged-with-residual instances
        # contribute their bound below, after the parent-bound fallback
        bound = torch.where(feas_pen, bound_pen, bound)

        unsolved = sel_live & isin(status, (FAILED, ITERLIM))
        infeas = sel_live & isin(status, (INFEAS, PRE_INF))
        solved = sel_live & isin(status, (OPT, PRE_OPT))
        bound = torch.where(solved, bound, par_bound)  # unsolved: parent's
        # penalty-converged-but-inexact instances carry a valid dual bound
        # even though their relaxation stays "unsolved" for branching
        bound = torch.where(unsolved & has_pen,
                            torch.maximum(bound, bound_pen), bound)
        pruned = sel_live & ~infeas & (bound >= cutoff)

        # ---- incumbent candidates ---------------------------------------
        frac = torch.where(integral_d[None, :], (y - torch.round(y)).abs(),
                           0.0)
        is_leaf_sol = solved & (frac.amax(dim=1) <= feastol)
        if nind:
            # an integral solution violating an indicator is NOT a leaf:
            # it must be enforced by branching on the violated binvar
            iv = ind_violated(y, lb, ub)
            is_leaf_sol = is_leaf_sol & ~iv.any(dim=1)

        # rounding heuristics (heur_sdpfracround / heur_sdprand), each
        # gated by its plugin toggle
        heur_cands = []
        if bb.heuristic_fracround:
            heur_cands.append(torch.where(integral_d[None, :], torch.round(y),
                                          y))
        if bb.heuristic_rand:
            fr = y - torch.floor(y)
            rnd = torch.rand(fr.shape, generator=gen, dtype=fr.dtype,
                             device=dev)
            heur_cands.append(torch.where(
                integral_d[None, :], torch.floor(y) + (rnd < fr).to(y.dtype),
                y))
        cands = []
        for yc in heur_cands:
            yc = torch.minimum(torch.maximum(yc, lb), ub)
            # clipping against fractional bounds may destroy integrality;
            # such candidates are not MISDP-feasible
            fr_c = torch.where(integral_d[None, :],
                               (yc - torch.round(yc)).abs(), 0.0)
            feas = (psd_feasible(data, yc, chktol, feastol, ipms) & solved
                    & ~is_leaf_sol & (fr_c.amax(dim=1) <= feastol))
            if nind:
                feas = feas & ~ind_violated(yc).any(dim=1)
            cands.append((feas, yc @ obj, yc))
        # exact leaves: relaxation solution is integral -> value = bound
        cands.append((is_leaf_sol, bound, y))

        inc_val, inc_y, has_inc, nheur = (st.inc_val, st.inc_y, st.has_inc,
                                          st.nheur)
        for ci, (feas, val, yc) in enumerate(cands):
            val = torch.where(feas, val, inf)
            # the first minimum; index_select, as indexing with a 0-d
            # tensor would read it on the host
            i_best = torch.argmin(val).view(1)
            v_best = val.index_select(0, i_best)[0]
            better = v_best < inc_val - 1e-12
            inc_y = torch.where(better, yc.index_select(0, i_best)[0], inc_y)
            inc_val = torch.where(better, v_best, inc_val)
            has_inc = has_inc | better
            if ci < len(heur_cands):
                nheur = nheur + better.to(torch.int32)

        # ---- branching ---------------------------------------------------
        expand = (solved & ~is_leaf_sol & ~pruned
                  & (status != PRE_OPT)) | (unsolved & ~pruned)
        scores = _branch_scores(y, frac, obj, bb.branching_rule)
        cand = (frac > feastol) & integral_d[None, :]
        scores = torch.where(cand, scores, -inf)
        j_frac = torch.argmax(scores, dim=1)
        has_frac = cand.any(dim=1)
        # unsolved nodes (or no fractional candidate): first unfixed
        # integer variable, split at the box midpoint
        unfixed = integral_d[None, :] & (ub - lb > feastol)
        j_unf = torch.argmax(unfixed.to(torch.uint8), dim=1)
        has_unf = unfixed.any(dim=1)
        if nind:
            # indicator enforcement: branch on the (unfixed) binvar of the
            # most violated link — children binvar<=0 / binvar>=1, the
            # latter forcing slack<=0 through selection-time propagation.
            # Fractional branching first (the reference enforces
            # indicators at integral solutions); y only counts where the
            # relaxation solved
            iv_br = iv & solved[:, None]
            has_iv_br = iv_br.any(dim=1)
            j_iv = ibv[torch.argmax(torch.where(iv_br, y[:, isv], -inf),
                                    dim=1)]
            j_unf = torch.where(has_iv_br, j_iv, j_unf)
            has_unf = has_unf | has_iv_br
        use_frac = solved & has_frac
        j = torch.where(use_frac, j_frac, j_unf)
        # a non-leaf node that cannot be branched (unsolved relaxation and
        # no unfixed integer variable) would silently lose its subtree —
        # flag it so the host loop (with the full recovery ladder) takes
        # over instead
        dead = expand & ~(use_frac | has_unf)
        expand = expand & (use_frac | has_unf)
        # integer split range: children [lb, s] and [s+1, ub] must cover
        # every integer point even if the box bounds are fractional
        lo = torch.ceil(lb[rows, j] - 1e-6)
        hi = torch.floor(ub[rows, j] + 1e-6)
        split = torch.where(use_frac, torch.floor(y[rows, j]),
                            torch.floor(0.5 * (lo + hi)))
        split = torch.minimum(torch.maximum(split, lo), hi - 1.0)

        # children: (2B, m) boxes
        oh = torch.nn.functional.one_hot(j, m) > 0
        ub1 = torch.where(oh, torch.minimum(ub, split[:, None]), ub)
        lb2 = torch.where(oh, torch.maximum(lb, split[:, None] + 1.0), lb)
        child_lb = torch.cat([lb, lb2], dim=0)
        child_ub = torch.cat([ub1, ub], dim=0)
        child_ok = torch.cat([expand, expand], dim=0)
        child_bound = torch.cat([bound, bound], dim=0)
        child_warm = torch.cat([y, y], dim=0)
        child_wok = torch.cat([solved, solved], dim=0) & child_ok

        # ---- children into free slots ------------------------------------
        free = ~fvalid
        slot = top_k_indices(free.to(torch.int32), 2 * B)
        can_place = free[slot]
        place = child_ok & can_place
        # overflow doubles as the "host must take over" flag: slab full OR
        # a node whose subtree turbo cannot faithfully process
        overflow = (st.overflow | (child_ok & ~can_place).any()
                    | dead.any())
        fvalid = fvalid.index_copy(0, slot, place | fvalid[slot])
        wrow = place[:, None]
        flb = st.flb.index_copy(0, slot, torch.where(wrow, child_lb,
                                                     st.flb[slot]))
        fub = st.fub.index_copy(0, slot, torch.where(wrow, child_ub,
                                                     st.fub[slot]))
        fbound = st.fbound.index_copy(0, slot, torch.where(
            place, child_bound, st.fbound[slot]))
        fwarm = st.fwarm.index_copy(0, slot, torch.where(
            wrow, child_warm, st.fwarm[slot]))
        fwok = st.fwok.index_copy(0, slot, torch.where(
            place, child_wok, st.fwok[slot]))

        # frontier-wide pruning frees slots for future children
        fvalid = fvalid & (fbound < cutoff)

        def count(mask):
            return mask.sum().to(torch.int32)

        return TurboState(
            flb=flb, fub=fub, fbound=fbound, fwarm=fwarm, fwok=fwok,
            fvalid=fvalid,
            inc_val=inc_val, inc_y=inc_y, has_inc=has_inc,
            nodes=st.nodes + count(sel_live),
            rounds=st.rounds + 1,
            iters=st.iters + out.iters,
            nsolves=nsolves,
            nheur=nheur,
            ndirect=st.ndirect + count(solved),
            nunsolved=st.nunsolved + count(unsolved),
            npruned_inf=st.npruned_inf + count(infeas),
            overflow=overflow,
        )

    def chunk_fn(data: IPMData, st: TurboState, gen, node_limit: int,
                 k: int):
        """Up to k rounds, each run only while the frontier holds a node,
        the node limit is not reached and nothing overflowed (a round
        without work leaves the state as it is, so the chunk ends there);
        the caller passes a state that is live, or k = 0.  Returns the new
        state and ONE packed float64 summary vector, the host's one
        transfer a chunk."""
        for i in range(k):
            live = st.fvalid.any() & (st.nodes < node_limit) & ~st.overflow
            if i and not bool(live):            # host read: the round
                break
            st = round_fn(data, st, gen)
        open_bound = torch.where(st.fvalid, st.fbound, inf).amin()
        summary = torch.stack([t.to(torch.float64) for t in (
            st.fvalid.any(), st.overflow, st.nunsolved, st.nodes, st.rounds,
            st.iters, st.nsolves, st.nheur, st.ndirect, st.npruned_inf,
            st.inc_val, st.has_inc, open_bound,
            st.fvalid.sum())])                  # the last: live width
        return st, summary

    return chunk_fn


def _init_state(N: int, m: int, seed_lb: np.ndarray, seed_ub: np.ndarray,
                seed_bound: np.ndarray, inc_val: float,
                inc_y: np.ndarray, has_inc: bool, device) -> TurboState:
    """The TurboState with the K seed node boxes in slots 0..K-1 of the
    (N, m) frontier slab, built on ``device`` from one host transfer."""
    K = seed_lb.shape[0]
    host = np.concatenate([seed_lb.ravel(), seed_ub.ravel(), seed_bound,
                           inc_y, [inc_val, float(has_inc)]])
    seed = torch.as_tensor(host, dtype=torch.float64, device=device)
    flb = torch.zeros((N, m), dtype=torch.float64, device=device)
    fub = torch.zeros_like(flb)
    flb[:K] = seed[:K * m].view(K, m)
    fub[:K] = seed[K * m:2 * K * m].view(K, m)
    fbound = torch.full((N,), float("inf"), dtype=torch.float64,
                        device=device)
    fbound[:K] = seed[2 * K * m:2 * K * m + K]
    fvalid = torch.zeros((N,), dtype=torch.bool, device=device)
    fvalid[:K] = True

    def zero():
        return torch.zeros((), dtype=torch.int32, device=device)

    return TurboState(
        flb=flb, fub=fub, fbound=fbound,
        fwarm=torch.zeros_like(flb),
        fwok=torch.zeros((N,), dtype=torch.bool, device=device),
        fvalid=fvalid,
        inc_val=seed[-2], inc_y=seed[-2 - m:-2], has_inc=seed[-1] > 0,
        nodes=zero(), rounds=zero(), iters=zero(), nsolves=zero(),
        nheur=zero(), ndirect=zero(), nunsolved=zero(), npruned_inf=zero(),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


class TurboResult(NamedTuple):
    inc_val: float
    inc_y: Optional[np.ndarray]
    dual_bound: float
    nodes: int
    rounds: int
    iters: int
    nsolves: int
    nheur: int
    ndirect: int
    nunsolved: int
    hit_node_limit: bool
    hit_time_limit: bool
    solve_time: float = 0.0   # host wall of the rounds' relaxation solves


def solve_turbo(dense: DenseSDPData, prob: MISDP, settings: Settings,
                root_lb: np.ndarray, root_ub: np.ndarray,
                inc_val0: float, inc_y0: Optional[np.ndarray],
                data: Optional[IPMData] = None,
                rounds_per_dispatch: int = 8,
                mesh=None,
                init_nodes=None,
                device=None,
                ) -> Optional[TurboResult]:
    """Run the device-resident B&B; returns None on fallback conditions.

    Runs on ``data``'s device when ``data`` is given; otherwise on the
    ``mesh``'s first device or on ``device``, where ``None`` means the
    CUDA card (raising without one, never falling back to the CPU).  With
    a ``mesh`` the rounds' solves are sharded over it; a batch that its
    nodes axis does not divide drops the mesh (logged).

    ``init_nodes``: optional list of (lb, ub, bound) open nodes to seed
    the frontier with INSTEAD of the root box — the deferred-engagement
    handoff from the host loop."""
    if data is not None:
        dev = data.device
    elif mesh is not None:
        dev = mesh.devices.flat[0]
    else:
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("solve_turbo: no CUDA device; pass "
                               "device='cpu' to solve on the CPU")
    settings = resolve_backend_autos(settings, dev)
    bb = settings.bb
    B = bb.batch_size
    m = dense.nvars
    N = max(bb.turbo_capacity, 8 * B)
    if init_nodes is not None and len(init_nodes) > N // 2:
        return None   # frontier too large for the slab
    if data is None:
        data = build_ipm_data(dense, dev)
    if mesh is not None and B % mesh.shape["nodes"]:
        _log.warning("solve_turbo: batch %d is not a multiple of the mesh's "
                     "nodes axis (%d): solving on one device", B,
                     mesh.shape["nodes"])
        mesh = None
    inner = ipm_solve if mesh is None else ShardedIPM(data, mesh)
    solve_s = 0.0

    def solve(*args, **kw):
        """``inner``, its host wall added to ``solve_s``: each call ends in
        its last flags read, after the device has run its iterations."""
        nonlocal solve_s
        t = time.perf_counter()
        out = inner(*args, **kw)
        solve_s += time.perf_counter() - t
        return out

    ind_pairs = (np.asarray([(l.binvar, l.slackvar)
                             for l in prob.indicators], dtype=np.int32)
                 if prob.indicators else None)
    chk = (bb.feastol * (1.0 + float(np.sum(np.abs(dense.obj))))
           if bb.usedimacsfeastol else None)
    # adaptive batch ramp (turbo_adaptive_batch): run narrow while the
    # frontier is narrow, double the width once the live frontier reaches
    # 4x the current width (small trees stop paying for speculative nodes
    # a wide batch would expand; deep trees still reach the configured
    # width).  The slab does not depend on the width.  Over a mesh the
    # width stays at B
    widths = [B]
    if bb.turbo_adaptive_batch and mesh is None and B > 8:
        widths, w = [], 8
        while w < B:
            widths.append(w)
            w *= 2
        widths.append(B)
    wi = 0
    if init_nodes is not None:
        while wi < len(widths) - 1 and len(init_nodes) >= 4 * widths[wi]:
            wi += 1

    def chunk_at(width):
        return make_round(settings, dense.integral, width, ind_pairs,
                          check_feastol=chk, device=dev, solve=solve)

    chunk = chunk_at(widths[wi])

    has0 = inc_y0 is not None and np.isfinite(inc_val0)
    if init_nodes is not None:
        flb0 = np.array([n[0] for n in init_nodes], dtype=np.float64)
        fub0 = np.array([n[1] for n in init_nodes], dtype=np.float64)
        fb0 = np.array([n[2] for n in init_nodes], dtype=np.float64)
    else:
        flb0 = np.asarray(root_lb, dtype=np.float64)[None, :]
        fub0 = np.asarray(root_ub, dtype=np.float64)[None, :]
        fb0 = np.array([-np.inf])
    st = _init_state(N, m, flb0.reshape(-1, m), fub0.reshape(-1, m), fb0,
                     float(inc_val0) if has0 else np.inf,
                     inc_y0 if has0 else np.zeros((m,)), bool(has0), dev)

    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(settings.seed)
    hit_time = False
    node_limit = min(bb.node_limit, 2**31 - 1)
    k_cur = max(1, min(8, rounds_per_dispatch))
    k_cap = max(1, rounds_per_dispatch)
    # the first chunk's state is live unless there is nothing to do; every
    # later chunk's is, or the loop has ended on the summary
    live = flb0.shape[0] > 0 and node_limit > 0
    while True:
        st, summary = chunk(data, st, gen, node_limit, k_cur if live else 0)
        live = True
        # loop control AND the final counts in one transfer
        vals = summary.tolist()                 # host read: the chunk
        (any_valid, overflow, nunsolved, nodes, rounds, iters, nsolves,
         nheur, ndirect, _npruned, inc_val_f, has_inc_f,
         open_bound, nlive) = vals
        if overflow or nunsolved > 4 * B:
            return None    # host path handles what turbo cannot
        if not any_valid or nodes >= bb.node_limit:
            break
        if time.time() - t0 > bb.time_limit:
            hit_time = True
            break
        if 2 * k_cur <= k_cap:
            k_cur *= 2
        # batch ramp: the frontier outgrew the current width
        stepped = False
        while wi < len(widths) - 1 and nlive >= 4 * widths[wi]:
            wi += 1
            stepped = True
        if stepped:
            chunk = chunk_at(widths[wi])

    has_inc = bool(has_inc_f)
    inc_val = float(inc_val_f) if has_inc else np.inf
    return TurboResult(
        inc_val=inc_val,
        inc_y=(st.inc_y.cpu().numpy() if has_inc else None),
        dual_bound=min(float(open_bound), inc_val),
        nodes=int(nodes),
        rounds=int(rounds),
        iters=int(iters),
        nsolves=int(nsolves),
        nheur=int(nheur),
        ndirect=int(ndirect),
        nunsolved=int(nunsolved),
        hit_node_limit=int(nodes) >= bb.node_limit,
        hit_time_limit=hit_time,
        solve_time=solve_s,
    )
