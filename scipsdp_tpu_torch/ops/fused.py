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
  feature Gram, in one cooperative launch (``csrc/schur_solve_fused.cu``);
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

import torch

from scipsdp_tpu_torch import _build

_F64 = torch.float64
_F32 = torch.float32
# the row-panel kernels of K1 and K3 keep two 16-row float64 panels of a
# block in shared memory: 256 n bytes, at most the 227 KB a block may use
MAX_N = 900


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
    "rhs_bucket": (_P,) * 6 + (_I,) * 4 + (_P,),
    "schur_solve_fused": (_P,) * 10 + (_I,) * 4 + (_P,),
    "recover_bucket": (_P,) * 7 + (_I,) + (_P,) * 2 + (_I,) * 4 + (_P,),
}


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
    _build.launch("rhs_bucket", _ARGTYPES["rhs_bucket"], Rc.device,
                  A.data_ptr(), Rc.data_ptr(), XRp.data_ptr(),
                  Sinv32.data_ptr(), P.data_ptr(), out.data_ptr(), B, K, mp,
                  n)
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
    CUDA: ``csrc/schur_solve_fused.cu``, one cooperative launch."""
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
    wt = torch.empty((B, F), dtype=_F64, device=rhs.device)    # W^T vf
    v32 = torch.empty((B, mp), dtype=_F32, device=rhs.device)  # f32(dsc r)
    _build.launch(name, _ARGTYPES[name], rhs.device, Wall32.data_ptr(),
                  rhs.data_ptr(), Minv32.data_ptr(), dsc.data_ptr(),
                  diag.data_ptr(), reg.data_ptr(), fix.data_ptr(),
                  wt.data_ptr(), v32.data_ptr(), dy.data_ptr(), B, mp, F,
                  max(int(nrefine), 0))
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
