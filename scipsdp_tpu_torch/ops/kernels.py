"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

A wrapper takes the plain version only for a tensor on the CPU (the tests'
device).  For a CUDA tensor it launches its kernel or raises; it never
falls back.  Each wrapper counts its launches in ``<wrapper>.launches``,
a plain integer that a caller may reset, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scipsdp_tpu_torch import _build


def cholesky_lanes_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`cholesky_lanes`: ``torch.linalg.cholesky_ex``
    on the lower triangle, with every matrix whose factorization failed
    set to NaN on and below the diagonal (the probe reads NaN as "not
    PSD"); zeros above the diagonal, as the kernel leaves them."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")).tril(), L)


@functools.lru_cache(maxsize=None)
def _cholesky_lanes_lib() -> ctypes.CDLL:
    lib = _build.load("cholesky_lanes")
    lib.cholesky_lanes_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_int]
    lib.cholesky_lanes_f32.restype = ctypes.c_int
    return lib


def cholesky_lanes(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a stack of float32 matrices (..., n, n),
    exact zeros above the diagonal; a matrix that is not positive definite
    comes back with NaN in its own factor only.

    CUDA: ``csrc/cholesky_lanes.cu``, one thread block per matrix, on the
    current stream.  CPU: :func:`cholesky_lanes_plain`.
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
    out = torch.empty_like(A)
    n = A.shape[-1]
    nmat = A.numel() // (n * n) if n else 0
    if nmat == 0:
        return out
    if nmat >= 2**31:
        raise ValueError(f"cholesky_lanes: {nmat} matrices exceed one grid")
    # the launch and the shared-memory opt-in act on the current device
    with torch.cuda.device(A.device):
        err = _cholesky_lanes_lib().cholesky_lanes_f32(
            A.data_ptr(), out.data_ptr(), nmat, n,
            torch.cuda.current_stream(A.device).cuda_stream, A.device.index)
    if err != 0:
        raise RuntimeError(f"cholesky_lanes: kernel launch failed with CUDA "
                           f"error {err} (N={nmat}, n={n})")
    cholesky_lanes.launches += 1
    return out


cholesky_lanes.launches = 0
