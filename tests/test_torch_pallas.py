"""The float32 kernels of scipsdp_tpu_torch.ops.kernels on the CPU: each
plain version against the JAX package's Pallas kernel run in interpret
mode (as tests/test_pallas.py and tests/test_lanes_chol.py run them), at
those tests' shapes and bars, and the wrappers' CPU dispatch and checks.

The CUDA kernels themselves run only on the card: ``python3 chip_smoke.py``
holds each against the same plain version there.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scipsdp_tpu.ops import pallas_kernels as jpk
from scipsdp_tpu_torch import _build
from scipsdp_tpu_torch.ops import kernels

# the four kernels of this module: (wrapper, plain version)
KERNELS = {
    "cholesky": (kernels.cholesky, kernels.cholesky_plain),
    "tril_inverse": (kernels.tril_inverse, kernels.tril_inverse_plain),
    "schur_wwt": (kernels.schur_wwt, kernels.schur_wwt_plain),
    "chol_inverse_lanes": (kernels.chol_inverse_lanes,
                           kernels.chol_inverse_lanes_plain),
}


def _spd(rng, N, n):
    """tests/test_pallas.py's positive definite float32 stack."""
    A = rng.standard_normal((N, n, n)).astype(np.float32)
    return A @ np.transpose(A, (0, 2, 1)) + n * np.eye(n, dtype=np.float32)


def _spd_lanes(rng, N, n):
    """tests/test_lanes_chol.py's positive definite stack."""
    a = rng.randn(N, n, n)
    return np.einsum("bij,bkj->bik", a, a) + n * np.eye(n)


# tests/test_pallas.py's shapes, and its F-chunk case (1, 16, 1024)
@pytest.mark.parametrize("B,mp,F,seed", [(2, 35, 577, 0), (1, 8, 64, 0),
                                         (3, 130, 1024, 0), (1, 16, 1024, 1)])
def test_schur_wwt_matches_pallas_interpret(B, mp, F, seed):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((B, mp, F)).astype(np.float32)
    ref = np.asarray(jpk.schur_wwt(jnp.asarray(W), interpret=True))
    M = kernels.schur_wwt_plain(torch.as_tensor(W))
    assert M.dtype == torch.float32 and M.shape == (B, mp, mp)
    exact = np.einsum("xif,xjf->xij", W.astype(np.float64), W.astype(np.float64))
    scale = max(1.0, np.abs(exact).max())
    assert np.abs(M.numpy() - ref).max() / scale < 1e-5
    assert np.abs(M.numpy() - exact).max() / scale < 1e-5


@pytest.mark.parametrize("N,n", [(4, 20), (2, 48), (1, 128)])
def test_cholesky_matches_pallas_interpret(N, n):
    A = _spd(np.random.default_rng(3), N, n)
    ref = np.asarray(jpk.cholesky(jnp.asarray(A), interpret=True))
    lapack = np.linalg.cholesky(A.astype(np.float64))
    L = kernels.cholesky_plain(torch.as_tensor(A)).numpy()
    assert L.dtype == np.float32
    for other in (ref, lapack):
        assert np.abs(L - other).max() / np.abs(lapack).max() < 1e-4


def test_cholesky_nan_on_the_non_pd_matrix_only():
    A = _spd(np.random.default_rng(4), 3, 16)
    A[1] -= 100.0 * np.eye(16, dtype=np.float32)
    ref = np.asarray(jpk.cholesky(jnp.asarray(A), interpret=True))
    L = kernels.cholesky_plain(torch.as_tensor(A)).numpy()
    for out in (L, ref):
        assert np.isnan(out[1]).any()
        assert np.isfinite(out[0]).all() and np.isfinite(out[2]).all()
    # NaN on and below the diagonal, zeros above (the kernels' pattern)
    assert np.isnan(np.tril(L[1])[np.tril_indices(16)]).all()
    assert (np.triu(L[1], 1) == 0).all()


@pytest.mark.parametrize("N,n", [(4, 20), (1, 96)])
def test_tril_inverse_matches_pallas_interpret(N, n):
    L = np.linalg.cholesky(_spd(np.random.default_rng(5), N, n)
                           .astype(np.float64)).astype(np.float32)
    X = kernels.tril_inverse_plain(torch.as_tensor(L)).numpy()
    ref = np.asarray(jpk.tril_inverse(jnp.asarray(L), interpret=True))
    L64 = L.astype(np.float64)
    for out in (X, ref):
        assert np.abs(out @ L64 - np.eye(n)).max() < 1e-4
    assert np.abs(X - ref).max() / np.abs(ref).max() < 1e-4


def test_chol_inverse_lanes_matches_pallas_interpret():
    A = _spd_lanes(np.random.RandomState(2), 20, 43).astype(np.float32)
    ref = np.linalg.inv(np.linalg.cholesky(A.astype(np.float64)))
    X = kernels.chol_inverse_lanes_plain(torch.as_tensor(A)).numpy()
    jx = np.asarray(jpk.chol_inverse_lanes(jnp.asarray(A), interpret=True))
    np.testing.assert_allclose(X, ref, rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(X, jx, rtol=3e-3, atol=3e-3)


def test_chol_inverse_lanes_leading_shape():
    A = _spd_lanes(np.random.RandomState(3), 12, 9).reshape(3, 4, 9, 9)
    A = torch.as_tensor(A, dtype=torch.float32)
    X = kernels.chol_inverse_lanes_plain(A)
    assert X.shape == (3, 4, 9, 9)
    flat = kernels.chol_inverse_lanes_plain(A.reshape(12, 9, 9))
    np.testing.assert_allclose(X.reshape(12, 9, 9).numpy(), flat.numpy(),
                               rtol=1e-5)
    jx = np.asarray(jpk.chol_inverse_lanes(jnp.asarray(A.numpy()),
                                           interpret=True))
    np.testing.assert_allclose(X.numpy(), jx, rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("name", ["cholesky", "tril_inverse",
                                  "chol_inverse_lanes"])
def test_lower_triangular_outputs(name):
    """Exact zeros above the diagonal, also for a lower-triangular input
    whose upper triangle holds garbage (only the lower one is read)."""
    A = _spd(np.random.default_rng(6), 5, 11)
    if name == "tril_inverse":
        A = np.linalg.cholesky(A.astype(np.float64)).astype(np.float32)
    wrapper, plain = KERNELS[name]
    out = wrapper(torch.as_tensor(A)).numpy()
    assert (np.triu(out, 1) == 0).all()
    junk = A + np.triu(np.full_like(A, 7.0), 1)
    if name == "tril_inverse":   # eigen.cholesky symmetrizes its input
        np.testing.assert_array_equal(plain(torch.as_tensor(junk)).numpy(),
                                      out)


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch; any leading batch shape is kept."""
    rng = np.random.default_rng(7)
    A = torch.as_tensor(_spd(rng, 6, 9).reshape(2, 3, 9, 9))
    L = kernels.cholesky_plain(A)
    W = torch.as_tensor(rng.standard_normal((2, 3, 5, 40)), dtype=torch.float32)
    args = {"cholesky": A, "tril_inverse": L, "schur_wwt": W,
            "chol_inverse_lanes": A}
    for name, (wrapper, plain) in KERNELS.items():
        before = wrapper.launches
        out = wrapper(args[name])
        assert wrapper.launches == before, name
        assert out.shape[:2] == (2, 3), name
        torch.testing.assert_close(out, plain(args[name]), rtol=0, atol=0)


def test_wrappers_take_float32_only_and_raise_off_cpu_and_cuda():
    """float64 raises TypeError on any device (the solver's dispatch sends
    float64 operands to the library); a device that is neither CPU nor
    CUDA raises instead of falling back; a non-square stack raises."""
    for name, (wrapper, _) in KERNELS.items():
        with pytest.raises(TypeError, match="float32 only"):
            wrapper(torch.zeros((2, 4, 4), dtype=torch.float64))
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(torch.empty((2, 4, 4), dtype=torch.float32, device="meta"))
        if name != "schur_wwt":
            with pytest.raises(ValueError, match="expected"):
                wrapper(torch.zeros((2, 4, 5), dtype=torch.float32))


@pytest.mark.parametrize("B,mp,F", [(32, 66, 4290), (8, 130, 16770),
                                    (32, 46, 101), (3, 130, 1024),
                                    (1, 16, 1024), (2, 35, 577), (1, 8, 1),
                                    (2, 16, 101), (2, 17, 256), (1, 80, 515),
                                    (2, 81, 1028), (5, 200, 33),
                                    (700, 9, 4099)])
def test_gram_chunks_cover_f(B, mp, F):
    """The Schur Gram's F split: chunks of a multiple of 32 columns (the
    kernel's pipeline stage), every chunk non-empty, together exactly F;
    at the main path's shapes enough (panel pair, batch, chunk) blocks for
    the card."""
    nchunks, chunk_len = kernels.gram_chunks(B, mp, F)
    assert chunk_len % 32 == 0 and nchunks >= 1
    assert (nchunks - 1) * chunk_len < F <= nchunks * chunk_len
    panels = kernels.gram_panels(mp)
    if F >= 4096:
        assert B * panels * (panels + 1) // 2 * nchunks >= 500


@pytest.mark.parametrize("mp", [1, 8, 16, 17, 35, 46, 66, 80, 81, 130, 160,
                                161, 300])
def test_gram_panels_cover_mp(mp):
    """Row panels of 80 cover mp exactly: the last one non-empty and at
    most a whole panel; mp <= 80 (cls_32, mkp_10) is one panel, so one
    block stages every row of W."""
    panels = kernels.gram_panels(mp)
    assert (panels - 1) * 80 < mp <= panels * 80
    assert (panels == 1) == (mp <= 80)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), nearest, ties away from
    zero: cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _add_f32(acc, term64, toward_zero):
    """acc + term64 rounded once to float32: to nearest, or toward zero as
    the tensor core's accumulator does."""
    exact = acc.astype(np.float64) + term64
    out = exact.astype(np.float32)
    if toward_zero:
        over = np.abs(out.astype(np.float64)) > np.abs(exact)
        out = np.where(over, np.nextafter(out, np.float32(0)), out)
    return out


def _gram_3xtf32(W, toward_zero):
    """numpy emulation of csrc/schur_wwt.cu: W split into hi = tf32(W) and
    lo = tf32(W - hi); per F-chunk (gram_chunks) and 32-column slab the
    products lo hi, hi lo, hi hi of each 8-column step accumulated in
    float32, each slab sum added to the chunk's sum by a rounded float32
    add, the chunk sums added in order; the lower triangle mirrored, as the
    kernel writes it."""
    B, mp, F = W.shape
    hi = _tf32(W)
    lo = _tf32(W - hi)
    hi64, lo64 = hi.astype(np.float64), lo.astype(np.float64)
    nchunks, chunk_len = kernels.gram_chunks(B, mp, F)
    total = np.zeros((B, mp, mp), np.float32)
    for c in range(nchunks):
        acc = np.zeros((B, mp, mp), np.float32)
        for s0 in range(c * chunk_len, min((c + 1) * chunk_len, F), 32):
            part = np.zeros((B, mp, mp), np.float32)
            for k0 in range(s0, min(s0 + 32, F), 8):
                k = slice(k0, min(k0 + 8, F))
                for a, b in ((lo64, hi64), (hi64, lo64), (hi64, hi64)):
                    part = _add_f32(part, np.einsum(
                        "xik,xjk->xij", a[:, :, k], b[:, :, k]), toward_zero)
            acc = acc + part
        total = total + acc
    lower = np.tril(total)
    return lower + np.transpose(np.tril(total, -1), (0, 2, 1))


@pytest.mark.parametrize("toward_zero", [False, True])
@pytest.mark.parametrize("B,mp,F,scaled", [(2, 35, 577, False),
                                           (3, 130, 1024, False),
                                           (1, 66, 4290, False),
                                           (2, 66, 1200, True)])
def test_gram_3xtf32_arithmetic_meets_the_float32_bar(B, mp, F, scaled,
                                                      toward_zero):
    """The arithmetic of the CUDA Gram kernel (three TF32 products per
    multiply-add, float32 accumulation per slab), emulated in numpy with
    the accumulator rounding to nearest and toward zero, stays within
    1e-5 of the largest entry of the float64 Gram, also for rows scaled by
    e^U(-4, 4); plain TF32 (hi hi alone) does not."""
    rng = np.random.default_rng(8)
    W = rng.standard_normal((B, mp, F)).astype(np.float32)
    if scaled:
        W *= np.exp(rng.uniform(-4, 4, (B, mp, 1))).astype(np.float32)
    W64 = W.astype(np.float64)
    exact = np.einsum("xif,xjf->xij", W64, W64)
    scale = np.abs(exact).max()
    M = _gram_3xtf32(W, toward_zero)
    assert M.dtype == np.float32
    assert np.abs(M - exact).max() / scale < 1e-5
    assert (M == np.transpose(M, (0, 2, 1))).all()
    h = _tf32(W).astype(np.float64)
    plain_tf32 = np.einsum("xif,xjf->xij", h, h)
    assert np.abs(plain_tf32 - exact).max() / scale > 1e-5


def _fma32(a, b, c):
    """fmaf in float32: the product of two float32 values is exact in
    float64, so a * b + c is rounded once there and once to float32 (the
    two roundings differ from one only in rare ties)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _trinv_blocked(L):
    """numpy emulation of csrc/tril_inverse.cu in float32 at
    ``kernels.tri_blocks``' split (identity past n): every diagonal block
    inverted column by column, x_r = (delta_rc - sum_{k<r} L[r][k] x_k)
    times the rounded 1 / L[r][r], fmaf in k order; then per block column j
    X_jj = L_jj^-1 and, row block by row block, R = sum_k L_ik X_kj (fmaf in
    k order) and X_ij = -(sum_l (L_ii^-1)[r][l] R[l][c]) (fmaf in l order).
    Only the lower triangle of L is read."""
    N, n, _ = L.shape
    nb, nblk = kernels.tri_blocks(n)
    npd = nb * nblk
    Lp = np.zeros((N, npd, npd), np.float32)
    Lp[:, :n, :n] = np.tril(L)
    Lp[:, np.arange(n, npd), np.arange(n, npd)] = 1.0
    below = np.arange(nb)[None, :] <= np.arange(nb)[:, None]   # c <= r
    Dinv = np.zeros((N, nblk, nb, nb), np.float32)
    for i in range(nblk):
        D = Lp[:, i * nb:(i + 1) * nb, i * nb:(i + 1) * nb]
        x = np.zeros((N, nb, nb), np.float32)
        for r in range(nb):
            acc = np.repeat(np.eye(nb, dtype=np.float32)[r][None], N, 0)
            for k in range(r):
                acc = _fma32(-D[:, r, k][:, None], x[:, k, :], acc)
            with np.errstate(divide="ignore", invalid="ignore"):
                rinv = (np.float32(1) / D[:, r, r]).astype(np.float32)
                x[:, r, :] = np.where(below[r], acc * rinv[:, None], 0.0)
        Dinv[:, i] = x
    X = np.zeros((N, npd, npd), np.float32)
    for j in range(nblk):
        c0 = j * nb
        X[:, c0:c0 + nb, c0:c0 + nb] = Dinv[:, j]
        for i in range(j + 1, nblk):
            i0 = i * nb
            R = np.zeros((N, nb, nb), np.float32)
            for k in range(c0, i0):
                R = _fma32(Lp[:, i0:i0 + nb, k][:, :, None],
                           X[:, k, c0:c0 + nb][:, None, :], R)
            acc = np.zeros((N, nb, nb), np.float32)
            for l in range(nb):
                acc = _fma32(Dinv[:, i, :, l][:, :, None], R[:, l, :][:, None, :],
                             acc)
            X[:, i0:i0 + nb, c0:c0 + nb] = -acc
    return X[:, :n, :n]


@pytest.mark.parametrize("case", ["n=10", "n=17", "n=65", "n=129", "n=130",
                                  "n=300", "ill-conditioned", "nan"])
def test_tril_inverse_blocked_arithmetic_meets_the_bar(case):
    """The CUDA kernel's arithmetic (blocked by tri_blocks), emulated in
    float32, within tests/test_pallas.py's bar (1e-4 max |X|) of the
    float64 inverse of the float32 factor, of the JAX kernel in interpret
    mode and of the plain version, on ragged n, on an IPM-like
    ill-conditioned factor (rows scaled by e^U(-4, 4)), and with a NaN in
    one factor: NaN in that inverse only, the others unchanged; exact
    zeros above the diagonal."""
    rng = np.random.default_rng(9)
    n = {"ill-conditioned": 129, "nan": 65}.get(case) or int(case[2:])
    N = 2 if n == 300 else 3
    L = np.linalg.cholesky(_spd(rng, N, n).astype(np.float64))
    if case == "ill-conditioned":
        L = L * np.exp(rng.uniform(-4, 4, (N, n, 1)))
    L = L.astype(np.float32)
    clean = _trinv_blocked(L)
    if case == "nan":
        L[1, n - 1, 0] = np.nan
    X = _trinv_blocked(L)
    jx = np.asarray(jpk.tril_inverse(jnp.asarray(L), interpret=True))
    assert (np.triu(X, 1) == 0).all()
    if case == "nan":
        for b in range(N):
            assert np.isnan(X[b]).any() == (b == 1)
            assert np.isnan(jx[b]).any() == (b == 1)
        np.testing.assert_array_equal(X[[0, 2]], clean[[0, 2]])
        return
    ref = np.linalg.inv(L.astype(np.float64))
    scale = np.abs(ref).max()
    plain = kernels.tril_inverse_plain(torch.as_tensor(L)).numpy()
    for other in (ref, jx, plain):
        assert np.abs(X - other).max() / scale < 1e-4


def _chol_panels(A):
    """numpy emulation of csrc/cholesky.cu in float32 at
    ``kernels.tri_blocks``' split: the stack padded to whole panels of nb
    with an identity tail; per panel (a) the diagonal block column by
    column (d = sqrt(c), IEEE; l = a / d, IEEE division; fmaf updates
    inside the block), (b) the rows below by forward substitution against
    it (fmaf chain in column order, then an IEEE division by the pivot),
    (c) the trailing part fmaf-updated with the panel's columns in order,
    a panel's column at a time over the whole trailing part.  A matrix
    with a pivot that is not > 0 comes back NaN on and below its
    diagonal.  Only the lower triangle of A is read."""
    N, n, _ = A.shape
    nb, npan = kernels.tri_blocks(n)
    npd = nb * npan
    W = np.zeros((N, npd, npd), np.float32)
    W[:, :n, :n] = np.tril(A)
    W[:, np.arange(n, npd), np.arange(n, npd)] = 1.0
    ok = np.ones(N, bool)
    with np.errstate(invalid="ignore", divide="ignore"):
        for k0 in range(0, npd, nb):
            k1 = k0 + nb
            for q in range(k0, k1):                       # (a)
                ok &= W[:, q, q] > 0
                d = np.sqrt(W[:, q, q])
                W[:, q, q] = d
                W[:, q + 1:k1, q] /= d[:, None]
                lq = W[:, q + 1:k1, q]
                W[:, q + 1:k1, q + 1:k1] = _fma32(
                    -lq[:, :, None], lq[:, None, :], W[:, q + 1:k1, q + 1:k1])
            Lpp = W[:, k0:k1, k0:k1]
            rows = W[:, k1:, k0:k1].copy()                # (b)
            for q in range(nb):
                s = rows[:, :, q]
                for t in range(q):
                    s = _fma32(-rows[:, :, t], Lpp[:, q, t][:, None], s)
                rows[:, :, q] = s / Lpp[:, q, q][:, None]
            W[:, k1:, k0:k1] = rows
            for k in range(nb):                           # (c)
                p = rows[:, :, k]
                W[:, k1:, k1:] = _fma32(-p[:, :, None], p[:, None, :],
                                        W[:, k1:, k1:])
    L = np.tril(W[:, :n, :n])
    lower = np.tri(n, dtype=bool)
    return np.where(ok[:, None, None], L, np.where(lower, np.float32(np.nan),
                                                   np.float32(0)))


def _chol_columns_ieee(A):
    """The same arithmetic one column at a time (right-looking, unblocked,
    no NaN flag): what the panels must reproduce bit for bit."""
    W = np.tril(A).astype(np.float32)
    n = A.shape[-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        for k in range(n):
            d = np.sqrt(W[:, k, k])
            W[:, k, k] = d
            lk = W[:, k + 1:, k] / d[:, None]
            W[:, k + 1:, k] = lk
            W[:, k + 1:, k + 1:] = _fma32(-lk[:, :, None], lk[:, None, :],
                                          W[:, k + 1:, k + 1:])
    return np.tril(W)


@pytest.mark.parametrize("case", ["n=10", "n=16", "n=17", "n=65", "n=66",
                                  "n=129", "n=130", "n=300", "not PD"])
def test_cholesky_panel_arithmetic_meets_the_bar(case):
    """The factor-quality CUDA Cholesky's arithmetic (panels of tri_blocks'
    nb, IEEE square roots and divisions), emulated in float32: equal bit
    for bit to the unblocked column order, and within tests/test_pallas.py's
    bar (1e-4 max|L|) of float64 numpy, of the JAX kernel in interpret
    mode and of the plain version, on ragged n and on both sides of the
    panel width.  A matrix that is not positive definite in a stack comes
    back NaN on and below its diagonal, zeros above, and leaves the
    others' bits alone."""
    rng = np.random.default_rng(10)
    n = 65 if case == "not PD" else int(case[2:])
    N = 2 if n == 300 else 3
    A = _spd(rng, N, n)
    E = _chol_panels(A)
    np.testing.assert_array_equal(E, _chol_columns_ieee(A))
    if case == "not PD":
        bad = A.copy()
        bad[1] -= np.float32(4 * n) * np.eye(n, dtype=np.float32)
        Eb = _chol_panels(bad)
        ref = np.asarray(jpk.cholesky(jnp.asarray(bad), interpret=True))
        lower = np.tri(n, dtype=bool)
        assert np.isnan(Eb[1][lower]).all() and (Eb[1][~lower] == 0).all()
        np.testing.assert_array_equal(Eb[[0, 2]], E[[0, 2]])
        assert np.isnan(ref[1]).any()
        assert np.isfinite(ref[[0, 2]]).all() and np.isfinite(Eb[[0, 2]]).all()
        return
    assert (np.triu(E, 1) == 0).all() and np.isfinite(E).all()
    exact = np.linalg.cholesky(A.astype(np.float64))
    ref = np.asarray(jpk.cholesky(jnp.asarray(A), interpret=True))
    plain = kernels.cholesky_plain(torch.as_tensor(A)).numpy()
    scale = np.abs(exact).max()
    for other in (exact, ref, plain):
        assert np.abs(E - other).max() / scale < 1e-4


def _fma_t(a, b, c):
    """fmaf in float32 on torch tensors, as _fma32."""
    return (a.double() * b.double() + c.double()).float()


def _cholinv_panels(A):
    """torch emulation of csrc/chol_inverse_lanes.cu in float32 at
    ``kernels.tri_blocks``' split: the stack padded to whole panels of nb
    with an identity tail and X = I carried along; per panel (a) the
    diagonal block column by column (rs = 1/sqrt(c), here correctly
    rounded, where the kernel's is within an ulp; l = a * rs; fmaf updates
    inside the block), (b) the rows below, l_q = (a_q - sum_{t<q} l_t
    L11[q][t]) * rs_q, (d1) X's panel rows over the columns < k1, x_q =
    (x_q - sum_{t<q} L11[q][t] x_t) * rs_q, (c) the trailing part and (d2)
    X's rows below (zero in the columns from k0 on) minus the panel's sums,
    each taken from zero by fmaf in column order.  A matrix with a pivot
    that is not a
    positive normal float comes back NaN on and below its diagonal.  Only
    the lower triangle of A is read."""
    A = torch.as_tensor(A, dtype=torch.float32)
    N, n, _ = A.shape
    nb, npan = kernels.tri_blocks(n)
    npd = nb * npan
    tail = torch.arange(n, npd)
    W = torch.zeros((N, npd, npd), dtype=torch.float32)
    W[:, :n, :n] = torch.tril(A)
    W[:, tail, tail] = 1.0
    X = torch.eye(npd, dtype=torch.float32).repeat(N, 1, 1)
    ok = torch.ones(N, dtype=torch.bool)
    tiny = torch.finfo(torch.float32).tiny
    for k0 in range(0, npd, nb):
        k1 = k0 + nb
        S = torch.tril(W[:, k0:k1, k0:k1])                 # (a)
        for q in range(nb):
            c = S[:, q, q].clone()
            good = (c >= tiny) & (c <= torch.finfo(torch.float32).max)
            ok &= good
            rs = torch.where(good, 1.0 / c.double().sqrt(),
                             float("nan")).float()
            lq = S[:, q + 1:, q] * rs[:, None]
            S[:, q, q] = rs
            S[:, q + 1:, q] = lq
            S[:, q + 1:, q + 1:] = _fma_t(-lq[:, :, None], lq[:, None, :],
                                          S[:, q + 1:, q + 1:])
        S = torch.tril(S)
        rows = W[:, k1:, k0:k1].clone()                    # (b)
        Xp = X[:, k0:k1, :k1].clone()                      # (d1)
        for q in range(nb):
            s, x = rows[:, :, q], Xp[:, q, :]
            for t in range(q):
                s = _fma_t(-rows[:, :, t], S[:, q, t][:, None], s)
                x = _fma_t(-S[:, q, t][:, None], Xp[:, t, :], x)
            rows[:, :, q] = s * S[:, q, q][:, None]
            Xp[:, q, :] = x * S[:, q, q][:, None]
        X[:, k0:k1, :k1] = Xp
        sa = torch.zeros_like(W[:, k1:, k1:])              # (c), (d2)
        sx = torch.zeros_like(X[:, k1:, :k1])
        for k in range(nb):
            p = rows[:, :, k]
            sa = _fma_t(p[:, :, None], p[:, None, :], sa)
            sx = _fma_t(p[:, :, None], Xp[:, k, :][:, None, :], sx)
        W[:, k1:, k1:] -= sa
        X[:, k1:, :k1] -= sx
    X = torch.tril(X[:, :n, :n])
    lower = torch.ones(n, n, dtype=torch.bool).tril()
    nan = torch.full_like(X, float("nan"))
    return torch.where(ok[:, None, None] | ~lower, X, nan).numpy()


def _err(X, ref):
    return float(np.abs(X.astype(np.float64) - ref).max())


@pytest.mark.parametrize("case", ["n=5", "n=16", "n=17", "n=43", "n=65",
                                  "n=129", "ill-conditioned", "not PD"])
def test_chol_inverse_panel_arithmetic_meets_the_bar(case):
    """The fused CUDA kernel's arithmetic (panels of tri_blocks' nb with X
    carried along), emulated in float32: within tests/test_lanes_chol.py's
    bar (3e-3, 3e-3) of float64 numpy's inv(cholesky(A)) and of the JAX
    kernel in interpret mode, exact zeros above the diagonal, on ragged n
    and on both sides of the panel width.  On an IPM-like ill-conditioned
    stack (rows and columns scaled by e^U(-4, 4)) its error from numpy is
    at most twice the plain cholesky -> tril_inverse pair's and below the
    emulated cholesky.cu -> tril_inverse.cu pair's.  A matrix of a
    stack that is not positive definite comes back NaN on and below its
    diagonal, zeros above, in the emulation and in JAX, and leaves the
    others' bits alone."""
    rng = np.random.default_rng(11)
    n = {"ill-conditioned": 129, "not PD": 65}.get(case) or int(case[2:])
    N = 3
    A64 = _spd_lanes(np.random.RandomState(n), N, n)
    if case == "ill-conditioned":
        d = np.exp(rng.uniform(-4, 4, (N, n)))
        A64 = d[:, :, None] * A64 * d[:, None, :]
    A = A64.astype(np.float32)
    X = _cholinv_panels(A)
    if case == "not PD":
        bad = A.copy()
        bad[1] -= np.float32(4 * n) * np.eye(n, dtype=np.float32)
        Xb = _cholinv_panels(bad)
        jx = np.asarray(jpk.chol_inverse_lanes(jnp.asarray(bad),
                                               interpret=True))
        lower = np.tri(n, dtype=bool)
        assert np.isnan(Xb[1][lower]).all() and (Xb[1][~lower] == 0).all()
        np.testing.assert_array_equal(Xb[[0, 2]], X[[0, 2]])
        assert np.isnan(jx[1]).any()
        assert np.isfinite(jx[[0, 2]]).all() and np.isfinite(Xb[[0, 2]]).all()
        return
    assert (np.triu(X, 1) == 0).all() and np.isfinite(X).all()
    ref = np.linalg.inv(np.linalg.cholesky(A.astype(np.float64)))
    np.testing.assert_allclose(X, ref, rtol=3e-3, atol=3e-3)
    if case == "ill-conditioned":
        pair = kernels.tril_inverse_plain(
            kernels.cholesky_plain(torch.as_tensor(A))).numpy()
        kernel_pair = _trinv_blocked(_chol_panels(A))
        assert _err(X, ref) <= 2 * _err(pair, ref)
        assert _err(X, ref) < _err(kernel_pair, ref)
        return
    jx = np.asarray(jpk.chol_inverse_lanes(jnp.asarray(A), interpret=True))
    np.testing.assert_allclose(X, jx, rtol=3e-3, atol=3e-3)


def test_chol_inverse_block_width_is_tri_blocks():
    """chol_inverse_lanes.cu's panel width is tri_blocks' nb (its one kNB)
    and its C entry point takes the panel count as the other blocked
    kernels do, with no workspace."""
    src = (_build.CSRC / "chol_inverse_lanes.cu").read_text()
    assert re.findall(r"constexpr int kNB = (\d+);", src) == [
        str(kernels.tri_blocks(1)[0])]
    assert kernels._ARGTYPES["chol_inverse_lanes"] == kernels._ARGTYPES[
        "cholesky"]
    assert re.search(r"smem_ld\(", src) and "invert_lower" not in src


# tests/test_lanes_chol.py's and the solver's n, around the block width
@pytest.mark.parametrize("n", [1, 5, 10, 15, 16, 17, 32, 33, 43, 46, 65, 66,
                               129, 130, 300])
def test_tri_blocks_cover_n(n):
    """The triangular kernels' split: blocks of nb = 16 columns, the last
    one non-empty, together exactly n; at the float32 tiers' X/S stacks
    (cls_32 B=32: 64 x 65, cls_64 B=8: 16 x 129) more blocks of
    tril_inverse's grid than the card's 132 SMs."""
    nb, nblk = kernels.tri_blocks(n)
    assert nb == 16
    assert (nblk - 1) * nb < n <= nblk * nb
    stacks = {65: 64, 129: 16}
    if n in stacks:
        assert stacks[n] * nblk > 132


def test_tri_block_width_one_source_constant():
    """tri_blocks' nb is the block width fixed in the three blocked sources
    (their only one), and their C entry points take the block count
    alone."""
    for name in ("cholesky_lanes", "cholesky", "tril_inverse"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert re.findall(r"constexpr int kNB = (\d+);", src) == [
            str(kernels.tri_blocks(1)[0])], name
        assert "template" not in src, name
        assert len(kernels._ARGTYPES[name]) == 6, name


def test_kernel_sources_and_build_paths():
    """Each kernel has its own source with a plain C float32 entry point
    and no library call; the shared device code is a header whose bytes
    enter every library's hash."""
    for name in KERNELS:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert re.search(rf'extern "C" int {name}_f32\(', src), name
        assert "Replaces: scipsdp_tpu/ops/pallas_kernels.py::" in src
        assert not re.search(r"cublas|cusolver|\btorch\b", src, re.I), name
        p = _build.library_path(name)
        assert p.name == f"lib{name}.so" and p.parent.parent == _build.BUILD_ROOT
    assert len({_build.library_path(k).parent for k in KERNELS}) == 4
    header = (_build.CSRC / "tri_factor.cuh").read_text()
    assert not re.search(r"cublas|cusolver|\btorch\b", header, re.I)
    for name in ("cholesky", "tril_inverse", "chol_inverse_lanes"):
        assert '#include "tri_factor.cuh"' in (
            _build.CSRC / f"{name}.cu").read_text()
