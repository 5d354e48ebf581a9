"""Hand-written CUDA kernels of the port for ``pallas_kernels.py``'s TPU
kernels, each beside its plain PyTorch version.

* :func:`cholesky_lanes` — the PSD probes' Cholesky (``csrc/cholesky_lanes.cu``);
* :func:`cholesky` — the factor-quality Cholesky (``csrc/cholesky.cu``);
* :func:`tril_inverse` — ``L^-1`` of lower factors (``csrc/tril_inverse.cu``);
* :func:`schur_wwt` — the Schur Gram ``M = W W^T`` (``csrc/schur_wwt.cu``);
* :func:`chol_inverse_lanes` — the fused ``A -> L^-1``
  (``csrc/chol_inverse_lanes.cu``).

Every kernel takes float32 only (the JAX package's float64 branches are
the solver's dispatch, ``ops/ipm.py``, not the kernels'); all but
:func:`cholesky_lanes` raise ``TypeError`` on any other type, on any
device.  A wrapper takes the plain version only for a tensor on the CPU
(the tests' device).  For a CUDA tensor it launches its kernel or raises;
it never falls back.  Each wrapper counts its launches in
``<wrapper>.launches``, a plain integer that a caller may reset, so a run
can show that its main path went through the kernel.  The plain versions
of :func:`tril_inverse` and :func:`schur_wwt` are also the solver's
library path when ``use_pallas`` is off.
"""

from __future__ import annotations

import ctypes

import torch

from scipsdp_tpu_torch import _build
from scipsdp_tpu_torch.ops.eigen import cholesky as cholesky_plain

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {   # of each C entry point <name>_f32, the stream last
    "cholesky_lanes": (_P, _P, _LL, _I, _I, _P),
    "cholesky": (_P, _P, _LL, _I, _I, _P),
    "tril_inverse": (_P, _P, _LL, _I, _I, _P),
    "chol_inverse_lanes": (_P, _P, _LL, _I, _I, _P),
    "schur_wwt": (_P, _P, _P, _I, _I, _LL, _I, _I, _P),
}
# Schur Gram (csrc/schur_wwt.cu): rows in panels of _GRAM_PANEL, one block
# per (pair of panels, batch element, F-chunk); F split so that about
# _GRAM_BLOCKS blocks run (eight per SM: short blocks balance best, in
# the timings of profile_torch_kernels.py), with at least _GRAM_MIN_CHUNK
# columns in a chunk and every chunk a multiple of the _GRAM_SLAB columns a
# pipeline stage holds
_GRAM_PANEL = 80
_GRAM_SLAB = 32
_GRAM_BLOCKS = 1056
_GRAM_MIN_CHUNK = 128
# Blocked triangular kernels (csrc/cholesky_lanes.cu, csrc/cholesky.cu,
# csrc/tril_inverse.cu, csrc/chol_inverse_lanes.cu): columns in blocks of
# _TRI_NB, the Cholesky factors' panels and the triangular inverse's block
# columns (one thread block per matrix and block column); the sources' kNB,
# which their C entry points check the block count against
_TRI_NB = 16


def tri_blocks(n: int) -> tuple:
    """(nb, nblk) of :func:`cholesky_lanes`'s, :func:`cholesky`'s and
    :func:`chol_inverse_lanes`' panels and :func:`tril_inverse`'s block
    columns for matrices of size n: blocks of
    nb columns, the last one non-empty, together covering n.  The kernels
    take nblk; nb is fixed in their sources."""
    return _TRI_NB, max(1, -(-n // _TRI_NB))


def cholesky_lanes_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`cholesky_lanes`: ``torch.linalg.cholesky_ex``
    on the lower triangle, with every matrix whose factorization failed
    set to NaN on and below the diagonal (the probe reads NaN as "not
    PSD"); zeros above the diagonal, as the kernel leaves them."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")).tril(), L)


def tril_inverse_plain(L: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`tril_inverse`: identity-RHS forward solves."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)


def schur_wwt_plain(W: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`schur_wwt`."""
    return torch.einsum("...if,...jf->...ij", W, W)


def chol_inverse_lanes_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`chol_inverse_lanes`: :func:`cholesky_plain`
    (``eigen.cholesky``) then :func:`tril_inverse_plain`."""
    return tril_inverse_plain(cholesky_plain(A))


def cholesky_lanes(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a stack of float32 matrices (..., n, n),
    exact zeros above the diagonal; a matrix that is not positive definite
    comes back with NaN in its own factor only.

    CUDA: ``csrc/cholesky_lanes.cu``, blocked right-looking in panels of
    :func:`tri_blocks`' nb columns, one thread block per matrix (one group
    of nb lanes for n <= nb), on the current stream.  CPU:
    :func:`cholesky_lanes_plain`.
    """
    if A.device.type == "cpu":
        return cholesky_lanes_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"cholesky_lanes: unsupported device {A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"cholesky_lanes: float32 only, got {A.dtype}")
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"cholesky_lanes: (..., n, n) expected, got "
                         f"{tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("cholesky_lanes: input must be contiguous")
    return _per_matrix(cholesky_lanes, A)


def _on_cpu(name: str, A: torch.Tensor, square: bool = True) -> bool:
    """Checks of the float32 kernels: True for a CPU tensor (plain
    version); raises on a type, shape or device the kernel does not take."""
    if A.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got {A.dtype}")
    if A.dim() < 2 or (square and A.shape[-1] != A.shape[-2]):
        raise ValueError(f"{name}: (..., {'n, n' if square else 'mp, F'}) "
                         f"expected, got {tuple(A.shape)}")
    if A.device.type == "cpu":
        return True
    if A.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {A.device}")
    return False


def _per_matrix(wrapper, A: torch.Tensor):
    """Launch a per-matrix blocked kernel on the stack ``A`` (..., n, n)
    into a new tensor of its shape, with :func:`tri_blocks`' block count
    nblk; counts the launch on ``wrapper``."""
    name = wrapper.__name__
    A = A.contiguous()
    out = torch.empty_like(A)
    n = A.shape[-1]
    nmat = A.numel() // (n * n) if n else 0
    if nmat == 0:
        return out
    nblk = tri_blocks(n)[1]
    if nmat * nblk >= 2**31:
        raise ValueError(f"{name}: {nmat} matrices exceed one grid")
    _build.launch(name, _ARGTYPES[name], A.device, A.data_ptr(),
                  out.data_ptr(), nmat, n, nblk, entry=f"{name}_f32")
    wrapper.launches += 1
    return out


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a stack of float32 matrices (..., n, n),
    read from the lower triangle, exact zeros above the diagonal; a matrix
    that is not positive definite comes back NaN on and below its diagonal
    and touches no other matrix.

    CUDA: ``csrc/cholesky.cu``, blocked right-looking in panels of
    :func:`tri_blocks`' nb columns with IEEE square roots and divisions,
    one thread block per matrix (one group of nb lanes for n <= nb).  CPU:
    :func:`cholesky_plain` (``eigen.cholesky``, which symmetrizes first:
    the two agree on symmetric input).
    """
    if _on_cpu("cholesky", A):
        return cholesky_plain(A)
    return _per_matrix(cholesky, A)


def tril_inverse(L: torch.Tensor) -> torch.Tensor:
    """``L^-1`` of a stack of float32 lower-triangular matrices
    (..., n, n), read from the lower triangle, exactly lower triangular; a
    NaN in a matrix stays in that matrix's inverse.

    CUDA: ``csrc/tril_inverse.cu``, one thread block per matrix and block
    column of :func:`tri_blocks`' nb columns.  CPU:
    :func:`tril_inverse_plain`.
    """
    if _on_cpu("tril_inverse", L):
        return tril_inverse_plain(L)
    return _per_matrix(tril_inverse, L)


def chol_inverse_lanes(A: torch.Tensor) -> torch.Tensor:
    """``L^-1`` with ``A = L L^T`` of a stack of float32 matrices
    (..., n, n), read from the lower triangle, in one launch, exactly lower
    triangular; a matrix that is not positive definite comes back NaN on
    and below its diagonal and touches no other matrix.

    CUDA: ``csrc/chol_inverse_lanes.cu``, blocked right-looking in panels
    of :func:`tri_blocks`' nb columns with the inverse carried along, one
    thread block per matrix (one group of nb lanes for n <= nb).  CPU:
    :func:`chol_inverse_lanes_plain`.
    """
    if _on_cpu("chol_inverse_lanes", A):
        return chol_inverse_lanes_plain(A)
    return _per_matrix(chol_inverse_lanes, A)


def gram_panels(mp: int) -> int:
    """Row panels of :func:`schur_wwt`'s kernel: _GRAM_PANEL rows each, the
    last one shorter; the kernel's grid has one entry per pair of panels
    on or below the diagonal."""
    return -(-mp // _GRAM_PANEL)


def gram_chunks(B: int, mp: int, F: int) -> tuple:
    """(nchunks, chunk_len) of :func:`schur_wwt`'s F split, from the shapes
    alone: about _GRAM_BLOCKS blocks of (pair of row panels, batch element,
    chunk), every chunk a multiple of 32 columns and non-empty."""
    panels = gram_panels(mp)
    pairs = B * panels * (panels + 1) // 2
    nchunks = max(1, min(-(-F // _GRAM_MIN_CHUNK), -(-_GRAM_BLOCKS // pairs)))
    chunk_len = -(-F // nchunks)
    chunk_len = -(-chunk_len // _GRAM_SLAB) * _GRAM_SLAB
    return -(-F // chunk_len), chunk_len


def schur_wwt(W: torch.Tensor) -> torch.Tensor:
    """``M = W W^T`` per matrix of a float32 stack W (..., mp, F), to
    float32 accuracy, symmetric.

    CUDA: ``csrc/schur_wwt.cu`` (three TF32 tensor-core products per
    multiply-add on a hi/lo split of W; F split across blocks into a
    float32 workspace allocated here, the partial sums added in a fixed
    order).  CPU: :func:`schur_wwt_plain`.
    """
    if _on_cpu("schur_wwt", W, square=False):
        return schur_wwt_plain(W)
    mp, F = W.shape[-2:]
    W = W.contiguous()
    out = torch.empty(W.shape[:-1] + (mp,), dtype=W.dtype, device=W.device)
    B = W.numel() // (mp * F) if mp * F else 0
    if out.numel() == 0:
        return out
    if F == 0:
        return out.zero_()
    if B >= 2**16 or max(mp, F) >= 2**31:
        raise ValueError(f"schur_wwt: shape beyond one grid {tuple(W.shape)}")
    nchunks, chunk_len = gram_chunks(B, mp, F)
    work = (torch.empty((nchunks, B, mp, mp), dtype=W.dtype, device=W.device)
            if nchunks > 1 else out)
    _build.launch("schur_wwt", _ARGTYPES["schur_wwt"], W.device, W.data_ptr(),
                  out.data_ptr(), work.data_ptr(), B, mp, F, nchunks,
                  chunk_len, entry="schur_wwt_f32")
    schur_wwt.launches += 1
    return out


cholesky_lanes.launches = 0
cholesky.launches = 0
tril_inverse.launches = 0
chol_inverse_lanes.launches = 0
schur_wwt.launches = 0
