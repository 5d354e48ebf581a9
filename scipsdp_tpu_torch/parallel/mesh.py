"""Device meshes for batched relaxation solves (PyTorch).

Counterpart of ``scipsdp_tpu/parallel/mesh.py``.  The JAX package shards
the node batch of ``ipm_solve`` over a mesh axis ``"nodes"`` and each
bucket's SDP blocks over ``"blocks"``, and GSPMD runs the one program over
the mesh.  Here the same plan is carried out by hand (:class:`ShardedIPM`):

* ``"nodes"``: the batch is cut into one slice per row of the mesh, each
  solved by its own ``ops/ipm.ipm_steps`` on that row's devices, and
  ``ops/ipm.lockstep`` runs them together, reading every slice's flags
  in ONE host read per iteration.  So the batch stops on one global
  ``all(done)`` and a float32 tier picks its tier from the whole batch,
  as under GSPMD, and the iteration counts are the unsharded solve's;
* ``"blocks"``: a bucket whose block count the axis divides
  (:func:`data_sharding`) becomes that many buckets of consecutive
  blocks, the j-th on the row's j-th device; an unsplit bucket, the LP
  rows and the batch's vectors stay on the row's first (home) device.
  ``ipm_steps`` brings each bucket's partial sums and W features home and
  combines them there in bucket order, where JAX's psum falls, so the
  split computes the same numbers on distinct devices as on repeated
  ones.  The initial point's scale comes from the unsplit data
  (``ops/ipm.start_norm``).  Outputs come back in the unsplit layout, so
  no caller sees the slices.

Inputs going out, sums coming home, flags and outputs coming back: every
cross-device move goes through :func:`to_device`.  :func:`make_mesh` gives
distinct entries (n cards, or cpu:0 ... cpu:{n-1}, which torch keeps on
one CPU); an explicit device list may repeat (a virtual mesh on one card)
or mix the card with the CPU.  It never falls back from the card to the
CPU.  Not carried over: ``mesh_key`` and the jit caches it keyed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from scipsdp_tpu_torch.ops.ipm import (IPMData, SolveOutput, ipm_steps,
                                       lockstep, start_norm, to_device)
from scipsdp_tpu_torch.utils.config import IPMSettings


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out on named axes: ``devices`` is an object array of
    ``torch.device`` with one dimension per name in ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("nodes",), device=None,
              devices=None) -> Mesh:
    """A mesh over ``n_devices`` devices: the first n CUDA cards
    (``device`` None or a CUDA device; ``ValueError`` when there are fewer
    than n), the n CPU entries cpu:0 ... cpu:{n-1} (``device="cpu"``), or
    the first n of an explicit ``devices`` list, which may repeat.

    With one axis the whole mesh is the node (batch) axis.  With two axes
    ("nodes", "blocks") devices are split evenly, blocks getting at most 2.
    """
    if devices is None:
        kind = torch.device("cuda" if device is None else device)
        if kind.type == "cuda":
            have = torch.cuda.device_count()
            n = have if n_devices is None else n_devices
            if n < 1 or have < n:
                raise ValueError(f"mesh needs {n} CUDA devices, have {have};"
                                 f" pass devices=[...] for a virtual mesh")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [torch.device(kind.type, i) for i in
                       range(1 if n_devices is None else n_devices)]
    else:
        devices = [_indexed(torch.device(d)) for d in devices]
        n = len(devices) if n_devices is None else n_devices
        if len(devices) < n:
            raise ValueError(f"mesh needs {n} devices, {len(devices)} given")
        devices = devices[:n]
    n = len(devices)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    if len(axes) == 1:
        return Mesh(grid, tuple(axes))
    if len(axes) != 2:
        raise ValueError(f"make_mesh: one or two axes, got {tuple(axes)}")
    nb = 2 if n % 2 == 0 else 1
    return Mesh(grid.reshape(n // nb, nb), tuple(axes))


def _indexed(d: torch.device) -> torch.device:
    """A CUDA device with its index, as a tensor's ``.device`` reports it."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def data_sharding(mesh: Mesh, data: IPMData) -> Tuple[Optional[str], ...]:
    """Per bucket, the mesh axis its blocks are split over: ``"blocks"``
    when the mesh has that axis and it divides the bucket's block count,
    else None (replicated) — JAX's PartitionSpec choice."""
    nb = mesh.shape.get("blocks")
    return tuple("blocks" if nb is not None and a.shape[0] % nb == 0
                 else None for a in data.A)


def _slices(K: int, k: int):
    """The k consecutive block ranges of a bucket of K blocks."""
    return [slice(j * K // k, (j + 1) * K // k) for j in range(k)]


class ShardedIPM:
    """``ipm_solve`` over a mesh, with its signature: ``solve(data, b, lb,
    ub, ..., settings=)``, where ``data`` is the IPMData the solver was
    built for.  Outputs are on the mesh's first device, concatenated along
    the batch, in ``data``'s bucket layout; ``iters`` and ``f64_iters``
    are the batch's (every slice runs every iteration).  The batch must be
    a multiple of the nodes axis."""

    def __init__(self, data: IPMData, mesh: Mesh):
        nodes = mesh.shape["nodes"]
        self.grid = mesh.devices.reshape(nodes, -1)
        self.data = data
        self.devices = [row[0] for row in self.grid]   # the rows' homes
        nb = mesh.shape.get("blocks", 1)
        self.split = tuple(nb if spec else 1
                           for spec in data_sharding(mesh, data))
        # per bucket of the split data, its column of a mesh row
        self.column = tuple(j for k in self.split for j in range(k))
        sub = self._split_data(data)
        self.shards = [self._placed(sub, row) for row in self.grid]

    def _placed(self, sub: IPMData, row) -> IPMData:
        """The split data on one mesh row: bucket t on the row's device
        ``column[t]``, the rest on its first."""
        places = tuple(row[j] for j in self.column)
        return dataclasses.replace(
            sub, A=tuple(to_device(a, d) for a, d in zip(sub.A, places)),
            C=tuple(to_device(c, d) for c, d in zip(sub.C, places)),
            dimmask=tuple(to_device(m, d)
                          for m, d in zip(sub.dimmask, places)),
            G=to_device(sub.G, row[0]), h=to_device(sub.h, row[0]),
            b_base=to_device(sub.b_base, row[0]), home=row[0],
            places=places)

    def _split_data(self, data: IPMData) -> IPMData:
        """``data`` with each split bucket cut into consecutive block
        slices, adjacent in bucket order."""
        if all(k == 1 for k in self.split):
            return data
        A, C, dm, first = [], [], [], []
        for t, k in enumerate(self.split):
            first.append(len(A))
            for sl in _slices(data.A[t].shape[0], k):
                A.append(data.A[t][sl])
                C.append(data.C[t][sl])
                dm.append(data.dimmask[t][sl])
        block_of = []
        for t, slot in data.block_of:
            per = data.A[t].shape[0] // self.split[t]
            block_of.append((first[t] + slot // per, slot % per))
        return dataclasses.replace(data, A=tuple(A), C=tuple(C),
                                   dimmask=tuple(dm),
                                   block_of=tuple(block_of))

    def _by_slice(self, xs, dim: int):
        """Per-bucket arrays (numpy or tensors) with the block axis at
        ``dim`` -> the per-slice list of the split data."""
        out = []
        for x, k in zip(xs, self.split):
            for sl in _slices(x.shape[dim], k):
                out.append(x[(slice(None),) * dim + (sl,)])
        return out

    def _whole(self, xs):
        """Per-slice (B, K, n, n) outputs -> the unsplit buckets."""
        out, i = [], 0
        for k in self.split:
            out.append(xs[i] if k == 1 else torch.cat(xs[i:i + k], dim=1))
            i += k
        return tuple(out)

    def __call__(self, data: IPMData, b, lb, ub, Gcut=None, hcut=None,
                 cutvalid=None, warm_y=None, warm_mask=None,
                 gaptol_vec=None, warm_X=None, ip_point=None,
                 feastol_vec=None, *, settings: IPMSettings) -> SolveOutput:
        if data is not self.data:
            raise ValueError("ShardedIPM: called with other data than it "
                             "was built for")
        B, nn = b.shape[0], len(self.devices)
        if B % nn:
            raise ValueError(f"ShardedIPM: a batch of {B} is not a multiple "
                             f"of the mesh's nodes axis ({nn})")
        r = B // nn
        # a split bucket's largest initial entry is over all its blocks:
        # the initial point's scale from the unsplit data
        norm = None if all(k == 1 for k in self.split) else start_norm(
            data, b, lb, ub, Gcut, hcut, cutvalid, warm_y, warm_mask,
            settings=settings)
        wX = None if warm_X is None else self._by_slice(warm_X, 1)
        ipX = None if ip_point is None else self._by_slice(ip_point[1], 0)
        steppers = []
        for i, row in enumerate(self.grid):
            rows = slice(i * r, (i + 1) * r)
            places = self.shards[i].places

            def part(x, rows=rows, dev=row[0]):
                if x is None or np.ndim(x) == 0:
                    return x
                return to_device(x[rows], dev)

            ipp = None if ipX is None else (
                to_device(ip_point[0], row[0]),
                [to_device(x, d) for x, d in zip(ipX, places)])
            steppers.append(ipm_steps(
                self.shards[i], part(b), part(lb), part(ub), part(Gcut),
                part(hcut), part(cutvalid), part(warm_y), part(warm_mask),
                part(gaptol_vec),
                None if wX is None else [part(x, dev=d)
                                         for x, d in zip(wX, places)],
                ipp, part(feastol_vec), settings=settings,
                norm_z0=part(norm)))
        dev0 = self.devices[0]
        outs = lockstep(steppers, lambda flags: torch.stack(
            [to_device(f, dev0) for f in flags]).all(dim=0))

        def cat(xs):
            return torch.cat([to_device(x, dev0) for x in xs], dim=0)

        def field(name):
            vals = [getattr(o, name) for o in outs]
            if vals[0] is None:
                return None
            if isinstance(vals[0], tuple):
                return self._whole([cat(v) for v in zip(*vals)])
            return cat(vals)

        return outs[0]._replace(**{
            name: field(name) for name in SolveOutput._fields
            if name not in ("iters", "f64_iters")})


def sharded_solver(data: IPMData, settings: IPMSettings, mesh: Mesh):
    """The batched IPM with its node-batch axis sharded over the mesh: a
    function of (b, lb, ub) whose leading batch dimension is a multiple
    of the "nodes" axis; blocks split over the "blocks" axis when the mesh
    has one."""
    return functools.partial(ShardedIPM(data, mesh), data, settings=settings)
