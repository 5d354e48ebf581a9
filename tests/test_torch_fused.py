"""scipsdp_tpu_torch.ops.fused on the CPU: the plain version of each fused
direction kernel against the JAX package's kernel math and against float64
numpy references, and the wrappers' CPU dispatch.

The JAX math runs eagerly, as tests/test_fused.py runs it (under
``jax.disable_jit()``: XLA:CPU's compiled code FMA-contracts the error-free
transforms away), with hi/lo pairs made by ``split64`` and read back by
``join64``.  Inputs and bars are test_fused.py's: K1 atol 1e-12 max|ref|;
K2 atol 1e-10 max|ref| against the exact solve of the live subsystem; K3
1e-12 max(1, max|ref|) for dS and 1e-11 max(1, max|ref|) for dX.  Beside
those inputs (B=4, K=2, n=13, mp=9, F=37) each kernel runs at the main
path's block shape (K=1, n=65, mp=66, F=4290: cardinality_least_squares(32,
64, 8)), K3 with a zeroed padding (blocks of two sizes in one bucket) and K2
with several fixed rows; K2's split of F across a thread-block cluster, and
K1's and K3's summation order (tensor-core k16 steps, K1's contraction
split over K n^2), are emulated in numpy and held to the JAX math too.

The CUDA kernels run only on the card: ``python3 chip_smoke.py`` holds each
against the same plain version there.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scipsdp_tpu.ops.fused as jfused
from scipsdp_tpu_torch import _build
from scipsdp_tpu_torch.ops import fused

KERNELS = ("rhs_bucket", "schur_solve_fused", "recover_bucket")
NREFINE = 3
# (B, K, n, mp, F): test_fused.py's inputs, and the main path's block shape
SHAPES = {"test_fused": (4, 2, 13, 9, 37), "main_block": (2, 1, 65, 66, 4290)}


def split64(x):
    hi = np.asarray(x).astype(np.float32)
    return hi, (np.asarray(x) - hi.astype(np.float64)).astype(np.float32)


def join64(hi, lo):
    return np.asarray(hi).astype(np.float64) + np.asarray(lo).astype(
        np.float64)


def _run(mathfn, *args):
    """The JAX kernel math, eagerly (per-op IEEE float32)."""
    with jax.disable_jit():
        out = mathfn(*args)
    return tuple(np.asarray(o) for o in out)


def _sym(a):
    return 0.5 * (a + np.swapaxes(a, -1, -2))


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _rhs_inputs(B, K, n, mp, seed):
    rng = np.random.default_rng(seed)
    A = _sym(rng.standard_normal((K, mp, n, n)))
    Rc = rng.standard_normal((B, K, n, n)) * 1e-6    # corrector-scale
    XRp = rng.standard_normal((B, K, n, n)) * 1e-6
    Sinv = _sym(rng.standard_normal((B, K, n, n))).astype(np.float32)
    return A, Rc, XRp, Sinv


@pytest.mark.parametrize("shape", list(SHAPES))
def test_rhs_bucket_matches_jax_math(shape):
    B, K, n, mp, _ = SHAPES[shape]
    A, Rc, XRp, Sinv = _rhs_inputs(B, K, n, mp, seed=7)
    P = np.einsum("zkac,zkcd->zkad", Rc - XRp, Sinv.astype(np.float64))
    want = np.einsum("kjpq,zkqp->zj", A, P)
    jax_got = join64(*_run(jfused._rhs_math, *split64(A), *split64(Rc),
                           *split64(XRp), jnp.asarray(Sinv)))
    got = fused.rhs_bucket_plain(_t(A), _t(Rc), _t(XRp), _t(Sinv))
    assert got.dtype == torch.float64 and got.shape == (B, mp)
    atol = 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(got.numpy(), jax_got, rtol=0, atol=atol)


def _schur_inputs(B, mp, F, nfix, seed):
    """test_fused.py's K2 inputs with the last ``nfix`` rows fixed, the
    preconditioner built exactly as the refine tier builds it, and the
    exact float64 solve of each live subsystem."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((B, mp, F)).astype(np.float32)
    diag = np.abs(rng.standard_normal((B, mp))) * 1e3
    reg = np.full((B,), 1e-7)
    fix = np.zeros((B, mp), bool)
    fix[:, mp - nfix:] = True
    rhs = rng.standard_normal((B, mp))
    W64 = W.astype(np.float64)
    want = np.zeros((B, mp))
    for b in range(B):
        live = ~fix[b]
        M = (W64[b] @ W64[b].T + np.diag(diag[b])
             + reg[b] * np.eye(mp))[np.ix_(live, live)]
        want[b, live] = np.linalg.solve(M, rhs[b, live])
    Mfull = (np.einsum("bif,bjf->bij", W64, W64)
             + np.eye(mp)[None] * diag[:, :, None]
             + reg[:, None, None] * np.eye(mp)[None])
    Mfull = np.where(fix[:, :, None] | fix[:, None, :], 0.0, Mfull)
    Mfull += np.eye(mp)[None] * fix[:, :, None]
    dsc = 1.0 / np.sqrt(np.maximum(np.einsum("bii->bi", Mfull), 1e-30))
    Ms = Mfull * dsc[:, :, None] * dsc[:, None, :]
    Minv = np.linalg.inv(Ms.astype(np.float32)).astype(np.float32)
    regv = np.broadcast_to(reg[:, None], (B, mp))
    return W, rhs, Minv, dsc, diag, regv, fix, want


@pytest.mark.parametrize("shape,nfix", [("test_fused", 1), ("test_fused", 3),
                                        ("main_block", 5)])
def test_schur_solve_fused_matches_jax_math(shape, nfix):
    B, _, _, mp, F = SHAPES[shape]
    W, rhs, Minv, dsc, diag, reg, fix, want = _schur_inputs(B, mp, F, nfix,
                                                            seed=7)
    jax_got = join64(*_run(
        jfused._schur_math, NREFINE, jnp.asarray(W), *split64(rhs),
        jnp.asarray(Minv), *split64(dsc), *split64(diag), *split64(reg),
        jnp.asarray(fix.astype(np.float32))))
    got = fused.schur_solve_fused_plain(
        _t(W), _t(rhs), _t(Minv), _t(dsc), _t(diag), _t(reg), _t(fix),
        NREFINE).numpy()
    atol = 1e-10 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(jax_got, want, rtol=0, atol=atol)
    assert (got[fix] == 0.0).all()


def _schur_cluster(W, rhs, Minv, dsc, diag, reg, fix, nrefine, plan):
    """numpy emulation of csrc/schur_solve_fused.cu's summation order under
    ``plan`` = (C, slice, chunk): u = W (W^T vf) as C slice partials, each
    the sum of its chunks' W_c (W_c^T vf) in order, the partials added in
    rank order; the preconditioner's product summed in float64 and rounded
    to float32, as the kernel takes it."""
    B, mp, F = W.shape
    C, width, chunk = plan
    W64 = W.astype(np.float64)
    M64 = Minv.astype(np.float64)

    def precond(r):
        v = (dsc * r).astype(np.float32).astype(np.float64)
        return dsc * np.einsum("bij,bj->bi", M64, v).astype(
            np.float32).astype(np.float64)

    rhsf = np.where(fix, 0.0, rhs)
    dy = precond(rhsf)
    for _ in range(nrefine):
        vf = np.where(fix, 0.0, dy)
        u = None
        for rank in range(C):
            end = min(F, (rank + 1) * width)
            part = np.zeros((B, mp))
            for c0 in range(rank * width, end, chunk):
                cols = slice(c0, min(end, c0 + chunk))
                wt = np.einsum("bif,bi->bf", W64[:, :, cols], vf)
                part = part + np.einsum("bif,bf->bi", W64[:, :, cols], wt)
            u = part if u is None else u + part
        r = np.where(fix, 0.0, rhs - ((u + diag * vf) + reg * vf))
        dy = dy + precond(r)
    return np.where(fix, 0.0, dy)


# the main path's block shape under two plans the kernel takes: clusters of
# 8 blocks, each slice kept in shared memory, and clusters of 4, slices of
# 1,076 columns streamed in chunks of 212; neither C divides F
@pytest.mark.parametrize("plan", ["kept", "streamed"])
@pytest.mark.parametrize("nrefine", [0, 1, 3])
def test_schur_cluster_split_matches_jax_math(nrefine, plan):
    """The CUDA kernel's split of F across a cluster, emulated, against
    the JAX kernel math and the exact solve, with five fixed rows: within
    1e-10 max|ref| after one refinement pass or more; with none (nrefine =
    0: the float32 preconditioner alone, whose product both round to
    float32 in their own order) within 1e-6 max|ref|.  Fixed rows are 0."""
    B, _, _, mp, F = SHAPES["main_block"]
    W, rhs, Minv, dsc, diag, reg, fix, want = _schur_inputs(B, mp, F, 5,
                                                            seed=7)
    split = {"kept": (8, 540, 540), "streamed": (4, 1076, 212)}[plan]
    assert split == fused.schur_split(mp, F, split[0]) or plan == "streamed"
    got = _schur_cluster(W, rhs, Minv, dsc, diag, reg, fix, nrefine, split)
    jax_got = join64(*_run(
        jfused._schur_math, nrefine, jnp.asarray(W), *split64(rhs),
        jnp.asarray(Minv), *split64(dsc), *split64(diag), *split64(reg),
        jnp.asarray(fix.astype(np.float32))))
    bar = 1e-10 if nrefine else 1e-6
    np.testing.assert_allclose(got, jax_got, rtol=0,
                               atol=bar * np.abs(jax_got).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bar * np.abs(want).max())
    assert (got[fix] == 0.0).all()


def _held(plan):
    """A stand-in for the card's occupancy query: the clusters of a plan
    that 132 SMs hold at once, two blocks an SM (one if its shared memory
    exceeds half the limit), clusters not spread over its 8 GPCs of 16."""
    C, width, chunk = plan
    per_sm = 1 if 2 * fused.schur_smem(66, chunk, chunk == width) > (
        fused.SMEM_LIMIT) else 2
    return min(132 * per_sm // C, 8 * (16 * per_sm // C))


# chip_smoke.py's FUSED_SHAPES (B, mp, F) and F that the cluster size does
# not divide, odd and even
@pytest.mark.parametrize("B,mp,F", [(32, 66, 4290), (16, 66, 4290),
                                    (8, 66, 4290), (8, 130, 16770),
                                    (32, 46, 101), (4, 9, 37), (8, 30, 420),
                                    (8, 40, 700), (4, 66, 4097),
                                    (3, 130, 4099), (1, 1, 1)])
@pytest.mark.parametrize("held", [None, _held])
def test_schur_plan_covers_f_and_fits(B, mp, F, held):
    """The Schur solve's plan: C slices of a multiple of 4 columns cover F,
    every slice but the last whole; chunks of a multiple of 4 columns cover
    a slice; one block's shared memory holds it; slices of at least 32
    columns for a cluster of more than one block; with the card's count
    of clusters held at once or without it."""
    C, width, chunk = fused.schur_plan(B, mp, F, held)
    assert 1 <= C <= 16 and (C == 1 or -(-F // C) >= 32)
    assert width % 4 == 0 and chunk % 4 == 0 and 4 <= chunk <= width
    assert (C - 1) * width < F <= C * width
    assert -(-width // chunk) * chunk >= width
    assert fused.schur_smem(mp, chunk, chunk == width) <= fused.SMEM_LIMIT
    assert (C, width, chunk) == fused.schur_split(mp, F, C)
    if (mp, F) == (130, 16770):     # cls_64: too wide to keep, streamed
        assert chunk < width
    if held is None and (B, mp, F) == (32, 66, 4290):   # the main path
        assert chunk == width and C > 1


def test_schur_plan_constants_are_the_source_s():
    """The plan's thread count and largest cluster are the kernel source's
    kThreads and kMaxCluster (its shared memory holds max(chunk, kThreads)
    float64 of wt, and it refuses larger clusters)."""
    src = (_build.CSRC / "schur_solve_fused.cu").read_text()
    for name, value in (("kThreads", fused._SCHUR_THREADS),
                        ("kMaxCluster", fused._SCHUR_MAX_CLUSTER)):
        assert re.findall(rf"constexpr int {name} = (\d+);", src) == [
            str(value)], name


def _recover_inputs(B, K, n, mp, seed, padded):
    rng = np.random.default_rng(seed)
    A = _sym(rng.standard_normal((K, mp, n, n)))
    dy = rng.standard_normal((B, mp)) * 1e-3
    Rp = rng.standard_normal((B, K, n, n)) * 1e-7
    Rc = rng.standard_normal((B, K, n, n)) * 1e-6
    X = _sym(rng.standard_normal((B, K, n, n)))
    Sinv = _sym(rng.standard_normal((B, K, n, n))).astype(np.float32)
    pad = np.ones((1, K, n, n), bool)
    if padded:     # the bucket's last block is smaller: zero its padding
        act = np.arange(n) < n - 4
        pad[0, -1] = act[:, None] & act[None, :]
    return A, dy, Rp, Rc, X, Sinv, pad


@pytest.mark.parametrize("shape,padded", [("test_fused", False),
                                          ("test_fused", True),
                                          ("main_block", False)])
def test_recover_bucket_matches_jax_math(shape, padded):
    B, K, n, mp, _ = SHAPES[shape]
    A, dy, Rp, Rc, X, Sinv, pad = _recover_inputs(B, K, n, mp, seed=7,
                                                  padded=padded)
    dS_want = np.where(pad, np.einsum("kjpq,zj->zkpq", A, dy) + Rp, 0.0)
    dX_want = np.where(pad, np.einsum(
        "zkac,zkcd->zkad", Rc - np.einsum("zkac,zkcd->zkad", X, dS_want),
        Sinv.astype(np.float64)), 0.0)
    dyh, dyl = split64(dy)
    out = _run(jfused._recover_math, *split64(A),
               dyh.reshape(B, mp, 1, 1), dyl.reshape(B, mp, 1, 1),
               *split64(Rp), *split64(Rc), *split64(X), jnp.asarray(Sinv),
               jnp.asarray(np.broadcast_to(pad, (B, K, n, n))
                           .astype(np.float32)))
    dS, dX = fused.recover_bucket_plain(_t(A), _t(dy), _t(Rp), _t(Rc), _t(X),
                                        _t(Sinv), _t(pad))
    sbar = 1e-12 * max(1.0, np.abs(dS_want).max())
    xbar = 1e-11 * max(1.0, np.abs(dX_want).max())
    for got, jax_got, want, bar in ((dS, join64(out[0], out[1]), dS_want,
                                     sbar),
                                    (dX, join64(out[2], out[3]), dX_want,
                                     xbar)):
        assert got.dtype == torch.float64 and got.shape == (B, K, n, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bar)
        np.testing.assert_allclose(jax_got, want, rtol=0, atol=bar)
    assert (dS.numpy()[:, ~pad[0]] == 0).all()
    assert (dX.numpy()[:, ~pad[0]] == 0).all()


# the summation order of csrc/rhs_bucket.cu and csrc/recover_bucket.cu:
# their staged tensor-core panels up to n = STAGED_MAX_N (m16n8k16 steps:
# K in chunks of 16, the chunks added in order), the row panels above (k
# in order); rhs_bucket's contraction in blocks of CWARPS warps of
# _slice_steps(n^2) k16 steps over one k's n^2 elements, the warps'
# partials added in warp order and the blocks' in (k, slice) order;
# recover_bucket's A(dy) in k16 steps over j, added in order
STAGED_MAX_N = 144
CWARPS = 4
MIN_STEPS, MAX_STEPS, SLICES_PER_TILE = 2, 8, 8


def _slice_steps(nn):
    """rhs_bucket.cu's slice_steps: k16 steps a warp of the contraction."""
    steps = -(-nn // (16 * CWARPS * SLICES_PER_TILE))
    return min(MAX_STEPS, max(MIN_STEPS, steps))


def _chunked(a, b, n):
    """a @ b over the last axis of a as the kernels sum it at block size
    n: partial products of 16 (tensor cores) or 1 (FMA chains) terms,
    added in k order."""
    step = 16 if n <= STAGED_MAX_N else 1
    acc = np.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], step):
        acc = acc + a[..., k0:k0 + step] @ b[..., k0:k0 + step, :]
    return acc


def _rhs_kernel_order(A, Rc, XRp, Sinv):
    """numpy emulation of csrc/rhs_bucket.cu's summation order."""
    K, mp, n, _ = A.shape
    B = Rc.shape[0]
    nn = n * n
    P = _chunked(Rc - XRp, Sinv.astype(np.float64), n).reshape(B, K, nn)
    Af = A.reshape(K, mp, nn)
    steps = _slice_steps(nn)
    slice_len = 16 * steps * CWARPS
    blocks = []
    for k in range(K):
        for s0 in range(0, nn, slice_len):
            part = None
            for w0 in range(s0, s0 + slice_len, 16 * steps):
                acc = np.zeros((B, mp))
                for e0 in range(w0, min(nn, w0 + 16 * steps), 16):
                    e = slice(e0, min(nn, e0 + 16))
                    acc = acc + P[:, k, e] @ Af[k, :, e].T
                part = acc if part is None else part + acc
            blocks.append(part)
    out = blocks[0]
    for part in blocks[1:]:
        out = out + part
    return out


def _recover_kernel_order(A, dy, Rp, Rc, X, Sinv, pad):
    """numpy emulation of csrc/recover_bucket.cu's summation order."""
    K, mp, n, _ = A.shape
    B = dy.shape[0]
    Af = A.reshape(K, mp, n * n)
    Ady = np.zeros((B, K, n * n))
    for k in range(K):
        for j0 in range(0, mp, 16):
            Ady[:, k] = Ady[:, k] + dy[:, j0:j0 + 16] @ Af[k, j0:j0 + 16]
    dS = np.where(pad, Ady.reshape(B, K, n, n) + Rp, 0.0)
    T = Rc - _chunked(X, dS, n)
    return dS, np.where(pad, _chunked(T, Sinv.astype(np.float64), n), 0.0)


def test_bucket_order_constants_are_the_source_s():
    """The emulated order's constants are the kernel sources': the staged
    panels' largest n, the contraction's warps a block and its rule for
    the k16 steps a warp; both sources choose the staged kernel up to
    that n and add no value atomically."""
    rhs = (_build.CSRC / "rhs_bucket.cu").read_text()
    rec = (_build.CSRC / "recover_bucket.cu").read_text()
    hdr = (_build.CSRC / "panel_dmma.cuh").read_text()
    for src, name, value in ((hdr, "kMaxN", STAGED_MAX_N),
                             (rhs, "kCWarps", CWARPS),
                             (rhs, "kMinSteps", MIN_STEPS),
                             (rhs, "kMaxSteps", MAX_STEPS),
                             (rhs, "kSlicesPerTile", SLICES_PER_TILE)):
        assert re.findall(rf"constexpr int {name} = (\d+);", src) == [
            str(value)], name
    assert STAGED_MAX_N <= fused.MAX_N
    for src in (rhs, rec):
        assert "if (n <= panel::kMaxN) {" in src
        assert "atomicAdd(" not in src.replace(
            "atomicAdd(counters + tile, 1)", "")


# (B, K, n, mp): test_fused.py's inputs (K = 2), the main path's block,
# mkp_10's n = 10 (one k16 step), and K = 2 with a ragged last slice of the
# contraction
ORDER_SHAPES = {"test_fused": (4, 2, 13, 9), "main_block": (2, 1, 65, 66),
                "n=10": (4, 1, 10, 46), "n=33 K=2": (3, 2, 33, 12)}


@pytest.mark.parametrize("shape", list(ORDER_SHAPES))
def test_rhs_bucket_kernel_order_matches_jax_math(shape):
    """rhs_bucket's CUDA summation order, emulated, against the JAX kernel
    math and float64 numpy, at test_fused.py's bar (1e-12 max|ref|)."""
    B, K, n, mp = ORDER_SHAPES[shape]
    A, Rc, XRp, Sinv = _rhs_inputs(B, K, n, mp, seed=11)
    P = np.einsum("zkac,zkcd->zkad", Rc - XRp, Sinv.astype(np.float64))
    want = np.einsum("kjpq,zkqp->zj", A, P)
    jax_got = join64(*_run(jfused._rhs_math, *split64(A), *split64(Rc),
                           *split64(XRp), jnp.asarray(Sinv)))
    got = _rhs_kernel_order(A, Rc, XRp, Sinv)
    atol = 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got, jax_got, rtol=0, atol=atol)


@pytest.mark.parametrize("shape,pad_kind", [
    ("test_fused", "shared"), ("main_block", "none"), ("n=10", "shared"),
    ("n=33 K=2", "instance"), ("test_fused", "instance")])
def test_recover_bucket_kernel_order_matches_jax_math(shape, pad_kind):
    """recover_bucket's CUDA summation order, emulated, against the JAX
    kernel math and float64 numpy, at test_fused.py's bars (dS 1e-12, dX
    1e-11, times max(1, max|ref|)); with a shared or a per-instance
    (B, K, n, n) pad, 0 where the pad is."""
    B, K, n, mp = ORDER_SHAPES[shape]
    A, dy, Rp, Rc, X, Sinv, pad = _recover_inputs(
        B, K, n, mp, seed=11, padded=pad_kind == "shared")
    if pad_kind == "instance":
        pad = np.ones((B, K, n, n), bool)
        for b in range(B):
            act = np.arange(n) < n - 1 - b
            pad[b, -1] = act[:, None] & act[None, :]
    dS_want = np.where(pad, np.einsum("kjpq,zj->zkpq", A, dy) + Rp, 0.0)
    dX_want = np.where(pad, np.einsum(
        "zkac,zkcd->zkad", Rc - np.einsum("zkac,zkcd->zkad", X, dS_want),
        Sinv.astype(np.float64)), 0.0)
    dyh, dyl = split64(dy)
    out = _run(jfused._recover_math, *split64(A),
               dyh.reshape(B, mp, 1, 1), dyl.reshape(B, mp, 1, 1),
               *split64(Rp), *split64(Rc), *split64(X), jnp.asarray(Sinv),
               jnp.asarray(np.broadcast_to(pad, (B, K, n, n))
                           .astype(np.float32)))
    dS, dX = _recover_kernel_order(A, dy, Rp, Rc, X, Sinv, pad)
    for got, jax_got, want, bar in (
            (dS, join64(out[0], out[1]), dS_want, 1e-12),
            (dX, join64(out[2], out[3]), dX_want, 1e-11)):
        atol = bar * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        np.testing.assert_allclose(got, jax_got, rtol=0, atol=atol)
        assert (got[~np.broadcast_to(pad, got.shape)] == 0).all()


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch; a per-instance (B, K, n, n) pad gives the same as the
    shared one."""
    B, K, n, mp, F = SHAPES["test_fused"]
    A, Rc, XRp, Sinv = (_t(x) for x in _rhs_inputs(B, K, n, mp, seed=3))
    W, rhs, Minv, dsc, diag, reg, fix, _ = (
        _t(x) for x in _schur_inputs(B, mp, F, 2, seed=3))
    _, dy, Rp, _, X, _, pad = (_t(x) for x in _recover_inputs(
        B, K, n, mp, seed=3, padded=True))
    before = [getattr(fused, k).launches for k in KERNELS]
    pairs = [
        (fused.rhs_bucket(A, Rc, XRp, Sinv),
         fused.rhs_bucket_plain(A, Rc, XRp, Sinv)),
        (fused.schur_solve_fused(W, rhs, Minv, dsc, diag, reg, fix, NREFINE),
         fused.schur_solve_fused_plain(W, rhs, Minv, dsc, diag, reg, fix,
                                       NREFINE)),
        *zip(fused.recover_bucket(A, dy, Rp, Rc, X, Sinv, pad),
             fused.recover_bucket_plain(A, dy, Rp, Rc, X, Sinv, pad)),
        *zip(fused.recover_bucket(A, dy, Rp, Rc, X, Sinv,
                                  pad.expand(B, K, n, n).contiguous()),
             fused.recover_bucket_plain(A, dy, Rp, Rc, X, Sinv, pad)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [getattr(fused, k).launches for k in KERNELS] == before


def test_wrappers_raise_off_cpu_and_cuda():
    """A device that is neither CPU nor CUDA, or operands on two devices,
    raise instead of falling back."""
    B, K, n, mp, F = 2, 1, 5, 4, 7

    def meta(*shape, dtype=torch.float64):
        return torch.empty(shape, dtype=dtype, device="meta")

    A, blk = meta(K, mp, n, n), meta(B, K, n, n)
    S32 = meta(B, K, n, n, dtype=torch.float32)
    v, fix = meta(B, mp), meta(B, mp, dtype=torch.bool)
    with pytest.raises(ValueError, match="unsupported device"):
        fused.rhs_bucket(A, blk, blk, S32)
    with pytest.raises(ValueError, match="unsupported device"):
        fused.schur_solve_fused(meta(B, mp, F, dtype=torch.float32), v,
                                meta(B, mp, mp, dtype=torch.float32), v, v, v,
                                fix, NREFINE)
    with pytest.raises(ValueError, match="unsupported device"):
        fused.recover_bucket(A, v, blk, blk, blk, S32,
                             meta(K, n, n, dtype=torch.bool))
    with pytest.raises(ValueError, match="different devices"):
        fused.rhs_bucket(A, blk, blk, torch.zeros((B, K, n, n)))


def test_kernel_sources_and_build_paths():
    """Each kernel has its own source with a plain C entry point and no
    library call, built for sm_90a into its own hashed directory."""
    for name in KERNELS:
        p = _build.library_path(name)
        assert p.name == f"lib{name}.so" and p.parent.parent == _build.BUILD_ROOT
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_f64(' in src
        assert "cublas" not in src.lower() and "cusolver" not in src.lower()
    assert len({_build.library_path(k).parent for k in KERNELS}) == 3
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
