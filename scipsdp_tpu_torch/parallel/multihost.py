"""Multi-process branch-and-bound over ``torch.distributed``.

Counterpart of ``scipsdp_tpu/parallel/multihost.py``.  The scale-out
follows the JAX package's:

* each process owns a shard of the open-node frontier (a partition of the
  root box, :func:`partition_root`);
* every process runs the same batched solves on its own devices (a local
  mesh, ``parallel/mesh.py``, when ``use_mesh`` asks for one);
* incumbent values and global dual bounds synchronize at every turn of the
  tree loop with an all-gather of (incumbent, best open bound, load);
* work stealing: processes with empty frontiers receive node boxes from
  the most loaded one.

The collectives carry a few host scalars and a ``(max_steal, 2m + 2)`` box
buffer, which the JAX package also moves as host numpy
(``process_allgather``), so they run on the ``gloo`` backend over CPU
float64 tensors: NCCL would need a card for each process.  One process
(no process group) degenerates to ``solve_misdp``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from scipsdp_tpu_torch.models.problem import MISDP
from scipsdp_tpu_torch.utils.config import Settings


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join a gloo process group when ``num_processes > 1``, at
    ``tcp://<coordinator>`` (``"host:port"``) or, without a coordinator,
    from the ``MASTER_ADDR``/``MASTER_PORT`` environment (``env://``);
    returns (process index, process count), (0, 1) without a group."""
    if num_processes is not None and num_processes > 1:
        dist.init_process_group(
            "gloo", init_method=(f"tcp://{coordinator}" if coordinator
                                 else "env://"),
            world_size=num_processes, rank=process_id)
    return process_index(), process_count()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def allgather(vec: np.ndarray) -> np.ndarray:
    """Every process's ``vec`` (same shape everywhere), stacked in process
    order, as float64 numpy (``vec[None]`` without a process group)."""
    if process_count() == 1:
        return np.asarray(vec, np.float64)[None]
    t = torch.as_tensor(np.asarray(vec, np.float64)).contiguous()
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def sync_bounds(incumbent: float, best_open_bound: float,
                nopen: int) -> Tuple[float, float, np.ndarray]:
    """All-gather (incumbent, bound, load) across processes.

    Returns (global_incumbent, global_dual_bound, per-process open
    counts); on one process it is the identity.
    """
    if process_count() == 1:
        return incumbent, best_open_bound, np.array([nopen])
    allv = allgather(np.array([incumbent, best_open_bound, float(nopen)]))
    global_inc = float(np.min(allv[:, 0]))
    global_bound = float(np.min(allv[:, 1]))
    return global_inc, global_bound, allv[:, 2].astype(int)


def partition_root(prob: MISDP, nparts: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split the root box into ``nparts`` disjoint sub-boxes by fixing the
    leading integer variables (static frontier partitioning over hosts).

    For nparts a power of two and enough binary variables this is an exact
    partition; surplus parts get empty (conflicting) boxes.
    """
    parts = [(prob.lb.copy(), prob.ub.copy())]
    ints = [j for j in np.where(prob.integral)[0]
            if prob.ub[j] - prob.lb[j] <= 64]  # bounded integer vars only
    k = 0
    while len(parts) < nparts and k < len(ints):
        j = ints[k]
        newparts = []
        for lb, ub in parts:
            span = ub[j] - lb[j]
            if span < 1:
                newparts.append((lb, ub))
                continue
            mid = np.floor(0.5 * (lb[j] + ub[j]))
            l1, u1 = lb.copy(), ub.copy()
            l2, u2 = lb.copy(), ub.copy()
            u1[j] = mid
            l2[j] = mid + 1
            newparts += [(l1, u1), (l2, u2)]
        parts = newparts
        k += 1
    # pad with empty boxes, truncate extras back into the last part
    while len(parts) < nparts:
        lb = prob.lb.copy()
        ub = prob.ub.copy()
        lb[:] = 1.0
        ub[:] = 0.0   # conflicting: presolved away instantly
        parts.append((lb, ub))
    return parts[:nparts]


class DistributedSync:
    """Lockstep multi-process coordination for the B&B loop.

    `solve_misdp` calls this hook once per loop iteration on EVERY process
    (a barrier: all frontier nodes are at rest).  Each call all-gathers a
    small scalar vector (incumbent value, best open bound, open-node
    count, stopped flag); every ``sync_every``-th call additionally runs a
    work-stealing exchange when some process is idle while another still
    has open nodes.

    Work stealing protocol (deterministic, computed identically on every
    process from the gathered loads): the most-loaded process donates up
    to ``max_steal`` cut-free nodes, serialized as flat (lb, ub, bound,
    depth) boxes into a fixed-shape buffer; idle processes take
    round-robin slices of the donated batch.

    Termination: globally done when no process has open nodes at the
    barrier (nothing is in flight at hook time, so the count is exact).
    """

    def __init__(self, nvars: int = -1, sync_every: int = 4,
                 max_steal: int = 8):
        self.nvars = nvars   # informational; the live width comes from ctx
        self.sync_every = max(1, sync_every)
        self.max_steal = max_steal
        self.calls = 0
        self.global_incumbent = np.inf
        self.global_bound = np.inf

    def _allgather(self, vec: np.ndarray) -> np.ndarray:
        return allgather(vec)

    def __call__(self, ctx) -> bool:
        self.calls += 1
        pid = process_index()
        local = np.array([ctx.incumbent_val, ctx.best_open_bound,
                          float(ctx.nopen),
                          1.0 if getattr(ctx, "stopping", False) else 0.0])
        allv = self._allgather(local)
        ginc = float(np.min(allv[:, 0]))
        self.global_incumbent = ginc
        self.global_bound = float(np.min(
            np.minimum(allv[:, 1], allv[:, 0])))
        if ginc < ctx.incumbent_val - 1e-12:
            ctx.adopt_incumbent(ginc)
        loads = allv[:, 2].astype(int)
        stopped = allv[:, 3] > 0.5
        # done when every process is out of work or has hit its local limit
        if bool(np.all(stopped | (loads == 0))):
            return True

        if self.calls % self.sync_every == 0:
            # receivers: running processes that are idle; donor: the most
            # loaded process (a stopped process's open nodes are drained by
            # the running ones)
            idle = np.where((loads == 0) & ~stopped)[0]
            donor = int(np.argmax(loads))
            if len(idle) and loads[donor] > 1:
                # node boxes live in the INTERNAL (presolved) variable
                # space, identical on every process because distributed
                # mode disables bound-dependent presolve shrinkage
                m = ctx.nvars
                width = 2 * m + 2
                buf = np.full((self.max_steal, width), np.nan)
                if pid == donor:
                    nodes = ctx.pop_for_donation(
                        min(self.max_steal, int(loads[donor]) // 2))
                    for i, (nlb, nub, nbound, ndepth) in enumerate(nodes):
                        buf[i] = np.concatenate(
                            [nlb, nub, [nbound, float(ndepth)]])
                allbuf = self._allgather(buf)      # (nproc, K, width)
                donated = allbuf[donor]
                valid = ~np.isnan(donated[:, -2])
                take = []
                for i in np.where(valid)[0]:
                    # round-robin over idle processes
                    tgt = idle[i % len(idle)]
                    if tgt == pid:
                        row = donated[i]
                        take.append((row[:m], row[m:2 * m],
                                     float(row[-2]), int(row[-1])))
                if take:
                    ctx.push_nodes(take)
        return False


def solve_misdp_distributed(prob: MISDP,
                            settings: Optional[Settings] = None,
                            sync_every: int = 4,
                            max_steal: int = 8,
                            device=None):
    """Distributed B&B: each process starts on a partition of the root box
    and runs the local `solve_misdp` machinery on ``device`` (None = the
    card) with a lockstep DistributedSync hook — periodic incumbent/dual-
    bound synchronization and dynamic work redistribution when a process's
    frontier empties.

    Single-process: equivalent to solve_misdp(prob).  The incumbent
    SOLUTION vector lives on the process that found it; every process
    returns the globally reduced objective and dual bound.
    """
    from scipsdp_tpu_torch.core.branchbound import solve_misdp
    from scipsdp_tpu_torch.utils.status import SolveStatus

    pid, nproc = process_index(), process_count()
    if nproc == 1:
        return solve_misdp(prob, settings, device=device)

    # stolen node boxes must live in ONE shared variable space: disable
    # the bound-dependent presolve reductions (fixing/aggregation depend
    # on each process's root partition)
    settings = settings or Settings()
    settings = dataclasses.replace(
        settings,
        presolve=dataclasses.replace(settings.presolve, fixvars=False,
                                     aggregate=False))
    lb, ub = partition_root(prob, nproc)[pid]
    sub = dataclasses.replace(prob, lb=lb, ub=ub)
    hook = DistributedSync(prob.nvars, sync_every=sync_every,
                           max_steal=max_steal)
    res = solve_misdp(sub, settings, sync_hook=hook, device=device)
    # final reduction of objectives/bounds across processes
    inc = res.objval if res.objval is not None else np.inf
    ginc, gbound, _ = sync_bounds(
        inc * prob.objsense if res.objval is not None else np.inf,
        res.dual_bound * prob.objsense, res.stats.nodes)
    status = res.status
    if np.isfinite(ginc) and status == SolveStatus.INFEASIBLE:
        # another process holds the incumbent
        status = SolveStatus.OPTIMAL
    return dataclasses.replace(
        res,
        status=status,
        objval=(prob.objsense * ginc if np.isfinite(ginc) else None),
        dual_bound=prob.objsense * gbound,
    )
