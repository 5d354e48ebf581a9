"""Exact float64 contractions of the refine interior-point tier.

Counterpart of ``scipsdp_tpu/ops/df32.py``.  The JAX package computes these
contractions in double-single float32 (hi/lo pairs with TwoProd/TwoSum, ~2^-45
relative) because the TPU has no float64.  The H100 has native float64 FMA,
which meets that accuracy contract directly, so the port keeps the three
public functions and their meaning and drops the hi/lo pairs
(``split64``/``join64``):

* :func:`bmm64` — ``einsum('...ab,...bc->...ac')``, leading axes flattened
  into G square matrices (``csrc/bmm64.cu``);
* :func:`contract_short64` — ``out[g, f] = sum_j M[(g,) j, f] v[g, j]``
  (``csrc/contract_short64.cu``);
* :func:`contract_long64` — ``out[g, j] = sum_f M[(g,) j, f] v[g, f]``
  (``csrc/contract_long64.cu``).

``M`` is static ``(J, F)`` (shared by every g) or per instance ``(G, J, F)``.
Operands are float64, or float32 for an f32-valued operand of the tier (the
Schur features ``Wall``, ``S^-1``): the kernels read ``M`` and the right
operand of :func:`bmm64` as float32 and widen them exactly on the way in (no
upcast pass before the launch), the plain versions upcast first; every
result is float64.

Each function has a plain version beside it (``*_plain``: a float64
``torch.einsum`` after the exact upcast).  A wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches its kernel or raises, and
counts its launches in ``<wrapper>.launches`` (a plain integer a caller may
reset).  The solver uses the plain versions on any device when
``use_df32="off"``.
"""

from __future__ import annotations

import ctypes

import torch

from scipsdp_tpu_torch import _build

_F64 = torch.float64
_OPERAND_DTYPES = (torch.float32, torch.float64)


def bmm64_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bmm64`."""
    return torch.einsum("...ab,...bc->...ac", A.to(_F64), B.to(_F64))


def contract_short64_plain(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`contract_short64`."""
    spec = "jf,gj->gf" if M.dim() == 2 else "gjf,gj->gf"
    return torch.einsum(spec, M.to(_F64), v.to(_F64))


def contract_long64_plain(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`contract_long64`."""
    spec = "jf,gf->gj" if M.dim() == 2 else "gjf,gf->gj"
    return torch.einsum(spec, M.to(_F64), v.to(_F64))


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {   # of each C entry point <name>_f64, the stream last
    "bmm64": (_P, _P, _P, ctypes.c_longlong, _I, _I, _P),
    "contract_short64": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "contract_long64": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def _on_cpu(name: str, *xs: torch.Tensor) -> bool:
    """True for CPU operands (plain version); checks a CUDA call's devices
    and dtypes and raises on anything the kernels do not take."""
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on different devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for x in xs:
        if x.dtype not in _OPERAND_DTYPES:
            raise TypeError(f"{name}: float32/float64 operands only, got "
                            f"{x.dtype}")
    return False


def _int32(name: str, *dims: int) -> None:
    if max(dims, default=0) >= 2**31:
        raise ValueError(f"{name}: dimension beyond int32 {dims}")


def bmm64(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` over stacks of square matrices of one shape (..., n, n),
    float64 result.  CUDA: ``csrc/bmm64.cu`` (a float32 B is read as
    float32)."""
    if _on_cpu("bmm64", A, B):
        return bmm64_plain(A, B)
    if A.shape != B.shape or A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"bmm64: two (..., n, n) stacks of one shape "
                         f"expected, got {tuple(A.shape)}, {tuple(B.shape)}")
    A = A.to(_F64).contiguous()
    B = B.contiguous()
    out = torch.empty_like(A)
    n = A.shape[-1]
    G = A.numel() // (n * n) if n else 0
    if G == 0:
        return out
    _int32("bmm64", G)
    _build.launch("bmm64", _ARGTYPES["bmm64"], A.device, A.data_ptr(),
                  B.data_ptr(), out.data_ptr(), G, n,
                  int(B.dtype == torch.float32))
    bmm64.launches += 1
    return out


def _contract(wrapper, M: torch.Tensor, v: torch.Tensor, short: bool):
    """Shared shape checks and launch of the two contraction kernels;
    counts the launch on ``wrapper``."""
    name = wrapper.__name__
    if M.dim() not in (2, 3) or v.dim() != 2:
        raise ValueError(f"{name}: M (J, F) or (G, J, F) and v (G, D) "
                         f"expected, got {tuple(M.shape)}, {tuple(v.shape)}")
    G = v.shape[0]
    J, F = M.shape[-2:]
    if (M.dim() == 3 and M.shape[0] != G) or v.shape[1] != (J if short else F):
        raise ValueError(f"{name}: shapes do not contract: M "
                         f"{tuple(M.shape)}, v {tuple(v.shape)}")
    M = M.contiguous()
    v = v.to(_F64).contiguous()
    out = torch.empty((G, F) if short else (G, J), dtype=_F64, device=v.device)
    if out.numel() == 0:
        return out
    _int32(name, G, J, F, M.numel())
    _build.launch(name, _ARGTYPES[name], v.device, M.data_ptr(), v.data_ptr(),
                  out.data_ptr(), G, J, F, int(M.dtype == torch.float32),
                  int(M.dim() == 3))
    wrapper.launches += 1
    return out


def contract_short64(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out[g, f] = sum_j M[(g,) j, f] v[g, j]``, float64 result.  CUDA:
    ``csrc/contract_short64.cu`` (a float32 M is read as float32)."""
    if _on_cpu("contract_short64", M, v):
        return contract_short64_plain(M, v)
    return _contract(contract_short64, M, v, short=True)


def contract_long64(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out[g, j] = sum_f M[(g,) j, f] v[g, f]``, float64 result.  CUDA:
    ``csrc/contract_long64.cu`` (a float32 M is read as float32)."""
    if _on_cpu("contract_long64", M, v):
        return contract_long64_plain(M, v)
    return _contract(contract_long64, M, v, short=False)


bmm64.launches = 0
contract_short64.launches = 0
contract_long64.launches = 0
