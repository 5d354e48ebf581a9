"""Fused Newton-direction kernels of the refine interior-point tier.

Counterpart of ``scipsdp_tpu/ops/fused.py``.  The refine tier's direction
(``ops/ipm.py``, ``iter_products_refine``) is a chain of some sixty small
device ops per call when it is assembled from separate contractions; the
per-launch cost, not the arithmetic, dominates it.  Three kernels per
direction and bucket replace that chain:

* :func:`rhs_bucket` (K1) — ``P = (Rc - X Rp) S^-1`` per block and its
  A*-contraction ``out[b, j] = sum_{k,a,c} A[k, j, a, c] P[b, k, a, c]`` into
  the Schur right-hand side (``csrc/rhs_bucket.cu``);
* :func:`schur_solve_fused` (K2) — the float32-preconditioned Schur solve
  with ``nrefine`` passes of float64 residual refinement against the float32
  feature Gram, one thread-block cluster per instance
  (``csrc/schur_solve_fused.cu``);
* :func:`recover_bucket` (K3) — ``dS = pad (A(dy) + Rp)`` and the
  unsymmetrized ``dX = pad ((Rc - X dS) S^-1)`` (``csrc/recover_bucket.cu``).

The JAX kernels carry float64 as double-single float32 pairs (the TPU has no
float64); the H100's native float64 FMA meets their accuracy contract as it
is, so here everything is float64 in and out, and the float32-valued
operands of the tier (``S^-1``, the features ``Wall``, the preconditioner
``Minv``) are float32 and upcast exactly.  The constraint matrices ``A`` are
SYMMETRIC: both the elementwise A*-contraction of K1 and K3's ``A(dy)`` rely
on it, as the JAX kernels do.

Each function has a plain version beside it (``*_plain``: float64
``torch.einsum`` after the exact upcast; for K2 the loop of the tier's
non-fused ``schur_solve``).  A wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches its kernel or raises, and counts its
launches in ``<wrapper>.launches`` (a plain integer a caller may reset).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scipsdp_tpu_torch import _build

_F64 = torch.float64
_F32 = torch.float32
# K1 and K3 stage n x n operands in shared memory up to n = 144; above it
# their row-panel kernels keep two 16-row float64 panels of a block there:
# 256 n bytes, at most the 227 KB a block may use
MAX_N = 900
# K2 (csrc/schur_solve_fused.cu) runs a thread-block cluster of at most
# _SCHUR_MAX_CLUSTER blocks per instance (above 8 a non-portable size,
# allowed on the H100), each block's slice of F at least _SCHUR_MIN_SLICE
# columns; SMEM_LIMIT is the dynamic shared memory a block may use on sm_90
# (227 KB); _SCHUR_THREADS is the source's kThreads.  A wave of clusters
# costs about as much as _SCHUR_WAVE columns more of slice, each block of a
# cluster _SCHUR_BLOCK, and a streamed slice (read once a pass)
# _SCHUR_STREAMED times a kept one (fitted to the kernel's times over
# cluster sizes on an H100, profile_torch_kernels.py variants schur)
_SCHUR_MAX_CLUSTER = 16
_SCHUR_MIN_SLICE = 32
_SCHUR_THREADS = 1024
_SCHUR_WAVE = 2000
_SCHUR_BLOCK = 15
_SCHUR_STREAMED = 3.5
SMEM_LIMIT = 232448


def schur_smem(mp: int, chunk: int, resident: bool) -> int:
    """Shared-memory bytes of a block of :func:`schur_solve_fused`'s kernel
    (the source's ``smem_bytes``): the W buffer(s) of mp rows x ``chunk``
    float32 (two when the slice is streamed), Minv (mp x mp float32,
    padded to a multiple of 4) with a kept slice, rhs, dsc, diag, reg, vf,
    u twice and dy (mp float64 each), wt (max(chunk, 2 _SCHUR_THREADS)
    float64), v32 (mp float32) and fix (mp bytes, padded to a multiple of
    4)."""
    minv = -(-mp * mp // 4) * 4 if resident else 0
    return (((1 if resident else 2) * mp * chunk + minv) * 4
            + (8 * mp + max(chunk, 2 * _SCHUR_THREADS)) * 8 + mp * 4
            + -(-mp // 4) * 4)


def _quarter_up(x: int, parts: int) -> int:
    """ceil(x / parts) rounded up to a multiple of 4, at least 4."""
    return max(4, -(-(-(-x // parts)) // 4) * 4)


def schur_split(mp: int, F: int, C: int,
                smem_limit: int = SMEM_LIMIT) -> tuple | None:
    """(C, slice, chunk) for a cluster of C blocks: F cut into C slices of
    ``slice`` columns (a multiple of 4, the last one shorter or empty),
    each kept whole in a block's shared memory where it fits (chunk ==
    slice), else streamed in the fewest equal chunks (multiples of 4) that
    two buffers hold; None where not even a 4-column chunk fits."""
    width = _quarter_up(F, C)
    if schur_smem(mp, width, True) <= smem_limit:
        return C, width, width
    widest = (smem_limit - schur_smem(mp, 0, False)) // (2 * mp * 4) + 4
    widest -= widest % 4
    while widest >= 4 and schur_smem(mp, widest, False) > smem_limit:
        widest -= 4
    if widest < 4:
        return None
    return C, width, _quarter_up(width, -(-width // widest))


def schur_plan(B: int, mp: int, F: int, held=None,
               smem_limit: int = SMEM_LIMIT) -> tuple:
    """(C, slice, chunk) of :func:`schur_solve_fused`'s kernel for B
    instances of W (mp, F).  The kernel is bound by each block's chain of
    dependent steps: a fixed part a wave of clusters, a part that grows
    with the cluster's blocks and one that grows with the slice, so the
    plan takes the cluster size C (1 to _SCHUR_MAX_CLUSTER, slices of at
    least _SCHUR_MIN_SLICE columns) with the least waves x (_SCHUR_WAVE +
    _SCHUR_BLOCK C + slice), a streamed slice counting _SCHUR_STREAMED
    times; ``held(plan)`` is the number of clusters the
    card holds at once (the occupancy query; without it, all B), and
    waves = ceil(B / held).  Ties go to the smaller C.  Raises where no
    plan fits."""
    best, best_cost = None, None
    for C in range(1, _SCHUR_MAX_CLUSTER + 1):
        if C > 1 and -(-F // C) < _SCHUR_MIN_SLICE:
            break
        plan = schur_split(mp, F, C, smem_limit)
        if plan is None:
            continue
        at_once = held(plan) if held is not None else B
        if at_once < 1:
            continue
        cost = -(-B // at_once) * (_SCHUR_WAVE + _SCHUR_BLOCK * C + plan[1] * (
            1 if plan[2] == plan[1] else _SCHUR_STREAMED))
        if best is None or cost < best_cost:
            best, best_cost = plan, cost
    if best is None:
        raise ValueError(f"schur_solve_fused: no cluster plan for mp = {mp}, "
                         f"F = {F} in {smem_limit} bytes of shared memory")
    return best


@functools.lru_cache(maxsize=None)
def _device_plan(device_index: int, B: int, mp: int, F: int) -> tuple:
    """schur_plan on CUDA device ``device_index``, with the card's count of
    clusters held at once (the kernel library's occupancy query)."""
    query = _build.load("schur_solve_fused").schur_solve_fused_clusters
    query.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    query.restype = ctypes.c_int

    def held(plan):
        n = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            err = query(mp, F, *plan, ctypes.byref(n))
        return n.value if err == 0 else 0

    return schur_plan(B, mp, F, held)


def rhs_bucket_plain(A: torch.Tensor, Rc: torch.Tensor, XRp: torch.Tensor,
                     Sinv32: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rhs_bucket`."""
    P = torch.einsum("xkac,xkcd->xkad", Rc - XRp, Sinv32.to(_F64))
    return torch.einsum("kjac,xkac->xj", A, P)


def schur_solve_fused_plain(Wall32: torch.Tensor, rhs: torch.Tensor,
                            Minv32: torch.Tensor, dsc: torch.Tensor,
                            diag: torch.Tensor, reg: torch.Tensor,
                            fix: torch.Tensor, nrefine: int) -> torch.Tensor:
    """Plain version of :func:`schur_solve_fused`: the refine tier's
    ``schur_solve`` loop on float64 einsums."""
    W64 = Wall32.to(_F64)

    def precond(r):
        v = (dsc * r).to(_F32)
        return dsc * torch.einsum("xij,xj->xi", Minv32, v).to(_F64)

    rhsf = torch.where(fix, 0.0, rhs)
    dy = precond(rhsf)
    for _ in range(max(int(nrefine), 0)):
        vf = torch.where(fix, 0.0, dy)
        wt = torch.einsum("xjf,xj->xf", W64, vf)
        u = torch.einsum("xjf,xf->xj", W64, wt) + diag * vf + reg * vf
        dy = dy + precond(rhsf - torch.where(fix, 0.0, u))
    return torch.where(fix, 0.0, dy)


def recover_bucket_plain(A: torch.Tensor, dy: torch.Tensor, Rp: torch.Tensor,
                         Rc: torch.Tensor, X: torch.Tensor,
                         Sinv32: torch.Tensor, pad: torch.Tensor):
    """Plain version of :func:`recover_bucket`."""
    dS = torch.where(pad, torch.einsum("kjab,xj->xkab", A, dy) + Rp, 0.0)
    T = Rc - torch.einsum("xkab,xkbc->xkac", X, dS)
    dX = torch.where(pad, torch.einsum("xkab,xkbc->xkac", T,
                                       Sinv32.to(_F64)), 0.0)
    return dS, dX


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {   # of each C entry point <name>_f64, the stream last
    "rhs_bucket": (_P,) * 7 + (_I,) * 4 + (_P,),
    "schur_solve_fused": (_P,) * 8 + (_I,) * 7 + (_P,),
    "recover_bucket": (_P,) * 7 + (_I,) + (_P,) * 2 + (_I,) * 4 + (_P,),
}


@functools.lru_cache(maxsize=None)
def _rhs_work(B: int, K: int, mp: int, n: int) -> int:
    """float64 elements of :func:`rhs_bucket`'s contraction scratch (the
    slice partials and arrival counters), as its C library counts them."""
    query = _build.load("rhs_bucket").rhs_bucket_work_doubles
    query.argtypes = [ctypes.c_int] * 4
    query.restype = ctypes.c_longlong
    return int(query(B, K, mp, n))


def _on_cpu(name: str, *xs: torch.Tensor) -> bool:
    """True for CPU operands (plain version); raises for operands on two
    devices or on a device that is neither CPU nor CUDA."""
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on different devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def _expect(name: str, what: str, x: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``x`` has exactly ``dtype`` and ``shape``."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} of shape {tuple(shape)} expected, "
                         f"got {tuple(x.shape)}")


def _int32(name: str, *xs: torch.Tensor) -> None:
    if max(x.numel() for x in xs) >= 2**31:
        raise ValueError(f"{name}: an operand exceeds int32 indexing")


def _block_shapes(name: str, A: torch.Tensor, blk: torch.Tensor):
    """(B, K, mp, n) of a bucket: A (K, mp, n, n), blk (B, K, n, n)."""
    if A.dim() != 4 or blk.dim() != 4:
        raise ValueError(f"{name}: A (K, mp, n, n) and (B, K, n, n) blocks "
                         f"expected, got {tuple(A.shape)}, {tuple(blk.shape)}")
    K, mp, n, _ = A.shape
    B = blk.shape[0]
    _expect(name, "A", A, _F64, (K, mp, n, n))
    if n > MAX_N:
        raise ValueError(f"{name}: block size {n} above {MAX_N}")
    return B, K, mp, n


def rhs_bucket(A: torch.Tensor, Rc: torch.Tensor, XRp: torch.Tensor,
               Sinv32: torch.Tensor) -> torch.Tensor:
    """A*-contraction of ``P = (Rc - XRp) S^-1`` for one bucket:
    ``out[b, j] = sum_{k,a,c} A[k, j, a, c] P[b, k, a, c]``.

    A (K, mp, n, n) float64, symmetric matrices; Rc, XRp (B, K, n, n)
    float64; Sinv32 (B, K, n, n) float32.  Returns (B, mp) float64.  CUDA:
    ``csrc/rhs_bucket.cu``."""
    if _on_cpu("rhs_bucket", A, Rc, XRp, Sinv32):
        return rhs_bucket_plain(A, Rc, XRp, Sinv32)
    B, K, mp, n = _block_shapes("rhs_bucket", A, Rc)
    blk = (B, K, n, n)
    _expect("rhs_bucket", "Rc", Rc, _F64, blk)
    _expect("rhs_bucket", "XRp", XRp, _F64, blk)
    _expect("rhs_bucket", "Sinv32", Sinv32, _F32, blk)
    A, Rc, XRp, Sinv32 = (x.contiguous() for x in (A, Rc, XRp, Sinv32))
    if B * mp == 0 or Rc.numel() == 0:
        return torch.zeros((B, mp), dtype=_F64, device=Rc.device)
    out = torch.empty((B, mp), dtype=_F64, device=Rc.device)
    _int32("rhs_bucket", A, Rc)
    P = torch.empty_like(Rc)            # scratch: the (B, K, n, n) products
    work = torch.empty(_rhs_work(B, K, mp, n), dtype=_F64, device=Rc.device)
    _build.launch("rhs_bucket", _ARGTYPES["rhs_bucket"], Rc.device,
                  A.data_ptr(), Rc.data_ptr(), XRp.data_ptr(),
                  Sinv32.data_ptr(), P.data_ptr(), work.data_ptr(),
                  out.data_ptr(), B, K, mp, n)
    rhs_bucket.launches += 1
    return out


def schur_solve_fused(Wall32: torch.Tensor, rhs: torch.Tensor,
                      Minv32: torch.Tensor, dsc: torch.Tensor,
                      diag: torch.Tensor, reg: torch.Tensor, fix: torch.Tensor,
                      nrefine: int) -> torch.Tensor:
    """``(W W^T + diag + reg) dy = rhs`` on the live (not ``fix``) rows to
    float64 accuracy: ``dy = precond(rhs)``, then ``nrefine`` passes of
    ``dy += precond(rhs - live (W (W^T vf) + diag vf + reg vf))`` with
    ``vf = live dy``, where ``precond(r) = dsc (Minv32 f32(dsc r))``.

    Wall32 (B, mp, F) and Minv32 (B, mp, mp) float32; rhs, dsc, diag, reg
    (B, mp) float64; fix (B, mp) bool.  Returns ``live dy`` (B, mp) float64.
    CUDA: ``csrc/schur_solve_fused.cu``, a thread-block cluster per
    instance in :func:`schur_plan`'s split of F (for the card's count of
    clusters held at once)."""
    if _on_cpu("schur_solve_fused", Wall32, rhs, Minv32, dsc, diag, reg,
               fix):
        return schur_solve_fused_plain(Wall32, rhs, Minv32, dsc, diag, reg,
                                       fix, nrefine)
    name = "schur_solve_fused"
    if Wall32.dim() != 3:
        raise ValueError(f"{name}: Wall32 (B, mp, F) expected, got "
                         f"{tuple(Wall32.shape)}")
    B, mp, F = Wall32.shape
    _expect(name, "Wall32", Wall32, _F32, (B, mp, F))
    _expect(name, "Minv32", Minv32, _F32, (B, mp, mp))
    for what, x in (("rhs", rhs), ("dsc", dsc), ("diag", diag), ("reg", reg)):
        _expect(name, what, x, _F64, (B, mp))
    _expect(name, "fix", fix, torch.bool, (B, mp))
    Wall32, rhs, Minv32, dsc, diag, reg, fix = (
        x.contiguous() for x in (Wall32, rhs, Minv32, dsc, diag, reg, fix))
    dy = torch.empty((B, mp), dtype=_F64, device=rhs.device)
    if dy.numel() == 0:
        return dy
    _int32(name, Wall32, Minv32)
    if B >= 2**16:
        raise ValueError(f"{name}: {B} instances exceed one grid")
    _build.launch(name, _ARGTYPES[name], rhs.device, Wall32.data_ptr(),
                  rhs.data_ptr(), Minv32.data_ptr(), dsc.data_ptr(),
                  diag.data_ptr(), reg.data_ptr(), fix.data_ptr(),
                  dy.data_ptr(), B, mp, F, max(int(nrefine), 0),
                  *_device_plan(dy.device.index, B, mp, F))
    schur_solve_fused.launches += 1
    return dy


def recover_bucket(A: torch.Tensor, dy: torch.Tensor, Rp: torch.Tensor,
                   Rc: torch.Tensor, X: torch.Tensor, Sinv32: torch.Tensor,
                   pad: torch.Tensor):
    """``dS = pad (A(dy) + Rp)`` with ``A(dy)[b, k] = sum_j A[k, j] dy[b, j]``,
    and ``dX = pad ((Rc - X dS) S^-1)``, not symmetrized.

    A (K, mp, n, n) float64; dy (B, mp) float64; Rp, Rc, X (B, K, n, n)
    float64; Sinv32 (B, K, n, n) float32; pad bool, (K, n, n), (1, K, n, n)
    or (B, K, n, n).  Returns (dS, dX), each (B, K, n, n) float64.  CUDA:
    ``csrc/recover_bucket.cu``."""
    if _on_cpu("recover_bucket", A, dy, Rp, Rc, X, Sinv32, pad):
        return recover_bucket_plain(A, dy, Rp, Rc, X, Sinv32, pad)
    name = "recover_bucket"
    B, K, mp, n = _block_shapes(name, A, Rp)
    blk = (B, K, n, n)
    _expect(name, "dy", dy, _F64, (B, mp))
    for what, x in (("Rp", Rp), ("Rc", Rc), ("X", X)):
        _expect(name, what, x, _F64, blk)
    _expect(name, "Sinv32", Sinv32, _F32, blk)
    if pad.dim() == 4 and pad.shape[0] == 1:
        pad = pad[0]
    per_instance = pad.dim() == 4
    _expect(name, "pad", pad, torch.bool, blk if per_instance else (K, n, n))
    A, dy, Rp, Rc, X, Sinv32, pad = (
        x.contiguous() for x in (A, dy, Rp, Rc, X, Sinv32, pad))
    dS = torch.empty_like(Rp)
    dX = torch.empty_like(Rp)
    if dS.numel() == 0:
        return dS, dX
    _int32(name, A, Rp)
    _build.launch(name, _ARGTYPES[name], Rp.device, A.data_ptr(),
                  dy.data_ptr(), Rp.data_ptr(), Rc.data_ptr(), X.data_ptr(),
                  Sinv32.data_ptr(), pad.data_ptr(), int(per_instance),
                  dS.data_ptr(), dX.data_ptr(), B, K, mp, n)
    recover_bucket.launches += 1
    return dS, dX


rhs_bucket.launches = 0
schur_solve_fused.launches = 0
recover_bucket.launches = 0
