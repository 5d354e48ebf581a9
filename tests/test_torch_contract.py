"""The static paths of the port's two float64 contractions on the CPU:
``ops/df32.py::contract_plan`` (the launch plan of ``csrc/contract_short64.cu``
and ``csrc/contract_long64.cu`` over ``csrc/contract_tile.cuh``), the C
entry points' signatures and constants as the wrappers declare them, and
numpy sums over the plan's tiles, slices and chunks (the long
contraction's split-K partials added in chunk order) against the plain
versions: a check that the plan covers every term once, not of the
kernels.

The kernels run only on the card: ``python3 chip_smoke.py`` (its
``contract_edge_phase`` and df32 phase) and ``python3
profile_torch_kernels.py check contract`` hold them to the same plain
versions there, two launches bit for bit.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from scipsdp_tpu_torch import _build
from scipsdp_tpu_torch.ops import df32

# the tile edges of chip_smoke.CONTRACT_EDGE_*, with 0
EDGE_G = (0, 1, 3, 17, 33, 128)
EDGE_J = (0, 1, 16, 17, 46, 130, 145)
EDGE_F = (0, 1, 100, 4225, 16641)
# the refine tier's static shapes (G, J, F) of chip_smoke.DF32_SHAPES
DF32_STATIC = [(32, 66, 4225), (16, 66, 4225), (8, 66, 4225), (8, 129, 8450),
               (8, 129, 16900), (8, 130, 16641), (32, 46, 100),
               (128, 66, 4225)]
CTYPE = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


def _cdiv(a, b):
    return -(-a // b)


def _signature(name):
    """The ctypes types of ``csrc/<name>.cu``'s ``<name>_f64`` parameters."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(rf'extern "C" int {name}_f64\(([^)]*)\)', src)
    assert m, name
    types = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split()[:-1])
        types.append(df32._P if "*" in param else CTYPE[decl])
    return tuple(types)


def _constant(path, name):
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, (path.name, name)
    return int(m.group(1))


@pytest.mark.parametrize("name", ["bmm64", "contract_short64",
                                  "contract_long64"])
def test_entry_point_signatures(name):
    """Each ``extern "C"`` entry point's parameters, pointers and ints in
    order, are the wrapper's ``_ARGTYPES``."""
    assert _signature(name) == df32._ARGTYPES[name]


def test_plan_constants_are_the_sources():
    """The plan's constants are the sources': warps a block and fragments
    a warp of contract_tile.cuh, the rows of j the short kernel stages at
    once.  The long contraction's split-K launch is cooperative and keeps
    no device state of its own between launches."""
    tile = _build.CSRC / "contract_tile.cuh"
    assert _constant(tile, "kWarps") == df32._WARPS
    assert _constant(tile, "kMaxFrags") == df32._MAX_FRAGS
    assert _constant(_build.CSRC / "contract_short64.cu",
                     "kPiece") == df32._PIECE
    long_ = (_build.CSRC / "contract_long64.cu").read_text()
    assert "cudaLaunchCooperativeKernel" in long_
    assert "this_grid().sync()" in long_
    assert not re.search(r"^__device__ \w+ \w+\[", long_, re.M)
    for name in ("contract_short64", "contract_long64"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "contract_tile.cuh"' in text
        assert "atomicAdd(double" not in text and "cublas" not in text.lower()


def _ks(plan):
    """Warps that split the contracted axis of one (panel, group)."""
    return df32._WARPS // (plan.panels * plan.groups)


def _check_plan(kind, G, J, F):
    plan = df32.contract_plan(kind, G, J, F)
    P, Q = plan.panels, plan.frags * plan.groups
    assert plan.frags in (1, 2, 4) and P & (P - 1) == 0
    assert plan.groups & (plan.groups - 1) == 0 and _ks(plan) >= 1
    assert P * plan.groups * _ks(plan) == df32._WARPS
    gx, gy, gz = plan.grid
    if kind == "short":
        assert plan.chunks == 1 and plan.work == (0,) and gz == 1
        assert df32.contract_smem(J, Q) <= df32._SMEM_TWO
        assert gx * 16 * P >= F and (gx - 1) * 16 * P < max(F, 1)
        assert gy * 8 * Q >= G and (gy - 1) * 8 * Q < max(G, 1)
        return plan
    assert plan.chunk >= 16 and plan.chunk % 16 == 0
    # the chunks tile F exactly: every column in one chunk, no empty chunk
    assert plan.chunk * plan.chunks >= F
    assert plan.chunk * (plan.chunks - 1) < max(F, 1)
    assert gx == plan.chunks
    assert gy * 16 * P >= J and (gy - 1) * 16 * P < max(J, 1)
    assert gz * 8 * Q >= G and (gz - 1) * 8 * Q < max(G, 1)
    if plan.chunks > 1:
        assert plan.work == (plan.chunks, G, J)
        assert gx * gy * gz <= df32._SMS    # resident at once
        assert plan.chunks * G <= F      # the partials stay below M
    else:
        assert plan.work == (0,)
    return plan


@pytest.mark.parametrize("F", EDGE_F)
@pytest.mark.parametrize("kind", ["short", "long"])
def test_plan_at_the_tile_edges(kind, F):
    """Every (G, J, F) of the edges, 0 and 1 among them: a valid launch,
    the grid covering the output exactly, the long chunks tiling F, the
    partials' shape."""
    for G in EDGE_G:
        for J in EDGE_J:
            _check_plan(kind, G, J, F)


@pytest.mark.parametrize("G,J,F", DF32_STATIC)
def test_plan_at_the_refine_shapes(G, J, F):
    """The refine tier's shapes: the short plan reads M once (one block
    row of instances) unless F is short, and gives every SM a block where
    F allows; the long
    plan fills the SMs at most twice over, two slices a warp at least."""
    short = _check_plan("short", G, J, F)
    assert short.grid[1] == 1 or short.grid[0] * short.grid[1] < df32._SMS
    blocks = short.grid[0]
    assert blocks >= df32._SMS or short.panels == 1
    long_ = _check_plan("long", G, J, F)
    gx, gy, gz = long_.grid
    assert gx * gy * gz <= 2 * df32._SMS + gy * gz
    if long_.chunks > 1:   # two 16-column slices a warp at least
        assert long_.chunk >= 32 * df32._WARPS


def test_plan_per_instance_and_kind():
    """A per-instance M has no plan; an unknown kind raises."""
    assert df32.contract_plan("short", 4, 5, 6, static=False) is None
    assert df32.contract_plan("long", 4, 5, 6, static=False) is None
    with pytest.raises(ValueError, match="kind"):
        df32.contract_plan("wide", 4, 5, 6)


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_warps_cover_the_block_tile(P):
    """contract_tile.cuh's warp map (w = (p groups + qg) ks + split)
    gives every (panel, fragment group) of a block ks warps, one for each
    residue of the contracted axis' slices, for every group count."""
    W = df32._WARPS
    for groups in (1, 2, 4, 8):
        if P * groups > W:
            continue
        lg_g = groups.bit_length() - 1
        lg_ks = (W // (P * groups)).bit_length() - 1
        owned = sorted((w >> (lg_g + lg_ks), (w >> lg_ks) & (groups - 1),
                        w & ((1 << lg_ks) - 1)) for w in range(W))
        assert owned == [(p, g, s) for p in range(P) for g in range(groups)
                         for s in range(W // (P * groups))]


def _slices_by_split(lo, hi, ks):
    """The 16-column slices of [lo, hi) of each warp split, in its order."""
    starts = list(range(lo, hi, 16))
    return [[(a, min(hi, a + 16)) for a in starts[sp::ks]]
            for sp in range(ks)]


def _short_by_plan(M, v, plan):
    """The short contraction summed in numpy over the plan's warp splits:
    each split's slices of j, piece by staged piece, then the splits'
    sums in split order."""
    J = M.shape[0]
    splits = [np.zeros((v.shape[0], M.shape[1])) for _ in range(_ks(plan))]
    for j0 in range(0, J, df32._PIECE):
        pieces = _slices_by_split(j0, min(J, j0 + df32._PIECE), _ks(plan))
        for part, slices in zip(splits, pieces):
            for a, b in slices:
                part += v[:, a:b] @ M[a:b]
    out = np.zeros_like(splits[0])
    for part in splits:
        out += part
    return out


def _long_by_plan(M, v, plan):
    """The long contraction summed in numpy over the plan's chunks: each
    chunk's sum (its warp splits' sums over their slices, added in split
    order), then the chunks' partials (of the plan's workspace shape)
    added in chunk order."""
    J, F = M.shape
    parts = []
    for c in range(plan.chunks):
        lo, hi = c * plan.chunk, min(F, (c + 1) * plan.chunk)
        part = np.zeros((v.shape[0], J))
        for slices in _slices_by_split(lo, hi, _ks(plan)):
            split = np.zeros_like(part)
            for a, b in slices:
                split += v[:, a:b] @ M[:, a:b].T
            part += split
        parts.append(part)
    if plan.chunks > 1:
        assert np.stack(parts).shape == plan.work
    out = np.zeros((v.shape[0], J))
    for part in parts:
        out += part
    return out


@pytest.mark.parametrize("G,J,F", [(32, 66, 4225), (8, 130, 16641),
                                   (128, 66, 4225), (3, 17, 100),
                                   (17, 1, 16641), (1, 46, 1),
                                   (5, 300, 40)])
def test_plan_slices_and_chunks_cover_the_contraction(G, J, F):
    """Sums over the plan's slices and chunks (the split-K partials in
    chunk order), in numpy, within 1e-13 relative of the plain versions
    (float64 einsum), for a float64 and a float32-valued M: the plan
    covers every term once.  This runs no kernel code; the kernels'
    own sums are held to the plain versions on the card."""
    rng = np.random.default_rng(G * 7919 + J * 31 + F)
    M = rng.standard_normal((J, F)) * np.exp(rng.uniform(-3, 3, (J, F)))
    vs, vl = rng.standard_normal((G, J)), rng.standard_normal((G, F))
    for Mx in (M, M.astype(np.float32).astype(np.float64)):
        for kind, v, emu, plain in (
                ("short", vs, _short_by_plan, df32.contract_short64_plain),
                ("long", vl, _long_by_plan, df32.contract_long64_plain)):
            plan = df32.contract_plan(kind, G, J, F)
            got = emu(Mx, v, plan)
            want = plain(torch.as_tensor(Mx), torch.as_tensor(v)).numpy()
            scale = max(np.abs(want).max(), 1e-300)
            assert np.abs(got - want).max() / scale <= 1e-13, (kind, plan)
