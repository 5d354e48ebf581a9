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

A static M goes through both contractions' tensor-core paths
(``csrc/contract_tile.cuh``), launched on :func:`contract_plan`'s tiles
(and, for the long one, its split of F and the partials' shape; split F
makes the launch cooperative, its grid within the SMs).

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
reset); the two contractions count their static-M launches also in
``<wrapper>.static_launches``.  The solver uses the plain versions on any
device when ``use_df32="off"``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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
    "contract_short64": (_P,) * 3 + (_I,) * 9 + (_P,),
    "contract_long64": (_P,) * 4 + (_I,) * 10 + (_P,),
}

# the static paths' constants (csrc/contract_tile.cuh and the short
# source; a test reads them there): warps a block, fragments a warp at
# most, rows of j of v the short kernel stages at once; and the card's SMs
# (H100 SXM) and the shared memory a block may take for two blocks an SM
_WARPS, _MAX_FRAGS = 8, 4
_PIECE = 144
_SMS = 132
_SMEM_TWO = 115200
_STAGE_MAX = 8    # instances a block row up to which the short one stages v


class ContractPlan(NamedTuple):
    """Launch plan of a static contraction (:func:`contract_plan`): a
    block owns ``panels`` 16-row panels of M's kept axis (f or j) and
    ``frags * groups`` 8-instance fragments; its 8 warps split them
    (a warp: one panel, ``frags`` fragments) and the contracted axis."""

    panels: int    # P, a power of two
    frags: int     # fragments a warp: 1, 2 or 4
    groups: int    # fragment groups a panel, a power of two; P groups <= 8
    chunk: int     # long: columns of F a block; short: 0
    chunks: int    # long: blocks along F (split-K); short: 1
    grid: tuple    # blocks (x, y, z)
    work: tuple    # shape of the float64 partials: (chunks, G, J) or (0,)
    stage: int     # short: 1 stages v in shared memory, 0 reads fragments


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(x: int) -> int:
    """The least power of two >= x (1 for x <= 1)."""
    return 1 << max(x - 1, 0).bit_length()


def contract_smem(J: int, frags: int) -> int:
    """Shared memory of a short static launch of ``frags`` fragments a
    block row (``contract_short64.cu``'s ``layout``): v's row tile, a
    piece of up to _PIECE rows of j, at least the reduction's buffer."""
    rows = min(_PIECE, max(16, _cdiv(J, 16) * 16))
    return max(8 * frags * (rows + 4) * 8, 8 * 4 * _MAX_FRAGS * 32 * 8)


def contract_plan(kind: str, G: int, J: int, F: int,
                  static: bool = True) -> ContractPlan | None:
    """Launch plan of :func:`contract_short64` (``kind`` "short") or
    :func:`contract_long64` ("long") for v (G, .) and M (J, F); None for a
    per-instance M, whose kernels have one launch shape.

    Short: a warp takes about half the instance fragments, up to 4, and a
    block up to 8 groups of them (256 instances; fewer where v's staged
    tile would not leave room for two blocks an SM), so that one block
    row reads M once, unless F is so short that one row would not give
    half the SMs a block; and the widest panel count P that still gives
    every SM a block.
    Long: a block row of up to 16 instances, one panel a block, and F cut
    into chunks so that the blocks fill the SMs at most once (a split
    F's launch is cooperative: all its blocks resident at once), each
    warp keeps at least two 16-column slices, and the partials (chunks x
    G x J) stay below M's size."""
    if kind not in ("short", "long"):
        raise ValueError(f"contract_plan: kind 'short' or 'long', not "
                         f"{kind!r}")
    if not static:
        return None
    gf = max(_cdiv(G, 8), 1)
    if kind == "short":
        frags = min(_MAX_FRAGS, _pow2(max(gf // 2, 1)))
        groups = min(_WARPS, _pow2(_cdiv(gf, frags)))
        while groups > 1 and contract_smem(J, frags * groups) > _SMEM_TWO:
            groups //= 2
        fp = max(_cdiv(F, 16), 1)
        # a short F: narrower block rows (M is small, read once a row)
        while (frags * groups > 1
               and fp * _cdiv(gf, frags * groups) < _SMS // 2):
            if groups > 1:
                groups //= 2
            else:
                frags //= 2
        rows = _cdiv(gf, frags * groups)
        P = next((p for p in (8, 4, 2) if p * groups <= _WARPS
                  and _cdiv(fp, p) * rows >= _SMS), 1)
        return plan_of("short", G, J, F, P, frags, groups)
    frags = min(2, _pow2(gf))
    parts = max(_cdiv(J, 16), 1) * _cdiv(gf, frags)
    chunks = max(1, min(_SMS // parts, F // (32 * _WARPS), F // max(G, 1)))
    return plan_of("long", G, J, F, 1, frags, 1, chunks)


def plan_of(kind: str, G: int, J: int, F: int, panels: int, frags: int,
            groups: int, chunks: int = 1,
            stage: int | None = None) -> ContractPlan:
    """The plan of blocks of ``panels`` x ``frags * groups`` and, for the
    long contraction, F cut into about ``chunks`` chunks of whole 16-column
    slices (the chunks tile F: chunk * (chunks - 1) < F <= chunk *
    chunks).  The short one stages v in shared memory for block rows of
    up to _STAGE_MAX instances (``stage`` None) and reads its fragments
    from device memory, where the cache keeps them, for wider rows."""
    q = frags * groups
    ys = _cdiv(max(_cdiv(G, 8), 1), q)
    if kind == "short":
        grid = (_cdiv(max(_cdiv(F, 16), 1), panels), ys, 1)
        if stage is None:
            stage = int(8 * q <= _STAGE_MAX)
        return ContractPlan(panels, frags, groups, 0, 1, grid, (0,), stage)
    chunk = _cdiv(_cdiv(max(F, 1), chunks), 16) * 16
    chunks = max(_cdiv(F, chunk), 1)
    grid = (chunks, _cdiv(max(_cdiv(J, 16), 1), panels), ys)
    return ContractPlan(panels, frags, groups, chunk, chunks, grid,
                        (chunks, G, J) if chunks > 1 else (0,), 0)


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
    counts the launch on ``wrapper`` (a static M's also in
    ``wrapper.static_launches``)."""
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
    plan = contract_plan("short" if short else "long", G, J, F,
                         M.dim() == 2)
    _int32(name, G, J, F, M.numel())
    head = (M.data_ptr(), v.data_ptr(), out.data_ptr())
    tail = (G, J, F, int(M.dtype == torch.float32), int(plan is None))
    tiles = (plan.panels, plan.frags, plan.groups) if plan else (0,) * 3
    if short:
        args = (*head, *tail, *tiles, plan.stage if plan else 0)
    else:
        work = torch.empty(plan.work if plan else (0,), dtype=_F64,
                           device=v.device)
        _int32(name, work.numel())
        args = (*head, work.data_ptr(), *tail,
                *((plan.chunk, plan.chunks) if plan else (0, 0)), *tiles)
    _build.launch(name, _ARGTYPES[name], v.device, *args)
    wrapper.launches += 1
    if plan is not None:
        wrapper.static_launches += 1
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
contract_short64.launches = contract_short64.static_launches = 0
contract_long64.launches = contract_long64.static_launches = 0
