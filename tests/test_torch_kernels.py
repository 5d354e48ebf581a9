"""scipsdp_tpu_torch.ops.kernels on the CPU: the plain version of each
kernel against the JAX package's Pallas kernel (run in interpret mode, as
tests/test_lanes_chol.py runs it), and the wrapper's CPU dispatch.

The CUDA kernel itself runs only on the card: ``python3 chip_smoke.py``
compares it with the same plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scipsdp_tpu.ops.pallas_kernels import cholesky_lanes as jax_cholesky_lanes
from scipsdp_tpu_torch import _build
from scipsdp_tpu_torch.ops import kernels

# the bar of tests/test_lanes_chol.py (float32 factorizations)
TOL = 2e-4


def spd(rng, N, n):
    a = rng.randn(N, n, n)
    return np.einsum("bij,bkj->bik", a, a) + n * np.eye(n)


# the five shapes of tests/test_lanes_chol.py; (384, 65) is the stacked
# probe ladder of cls_32 at B=128 (a batch count that is no multiple of 128)
@pytest.mark.parametrize("N,n", [(3, 5), (16, 43), (130, 17), (1, 64),
                                 (384, 65)])
def test_plain_matches_pallas_interpret(N, n):
    rng = np.random.RandomState(0)
    A = spd(rng, N, n).astype(np.float32)
    ref = np.asarray(jax_cholesky_lanes(jnp.asarray(A), interpret=True))
    L = kernels.cholesky_lanes_plain(torch.as_tensor(A))
    assert L.dtype == torch.float32 and L.shape == (N, n, n)
    np.testing.assert_allclose(L.numpy(), ref, rtol=TOL, atol=TOL)
    assert (np.triu(L.numpy(), 1) == 0).all()


def test_nan_only_in_the_indefinite_matrix():
    rng = np.random.RandomState(1)
    A = spd(rng, 8, 12)
    A[3] -= 40.0 * np.eye(12)   # indefinite matrix
    A = A.astype(np.float32)
    ref = np.asarray(jax_cholesky_lanes(jnp.asarray(A), interpret=True))
    for L in (kernels.cholesky_lanes_plain(torch.as_tensor(A)).numpy(),
              kernels.cholesky_lanes(torch.as_tensor(A)).numpy()):
        for b in range(8):
            assert np.isnan(L[b]).any() == (b == 3)
            assert np.isnan(ref[b]).any() == (b == 3)
        assert (np.triu(L[3], 1) == 0).all()


def test_leading_shape_kept():
    rng = np.random.RandomState(2)
    A = torch.as_tensor(spd(rng, 12, 9).reshape(3, 4, 9, 9), dtype=torch.float32)
    L = kernels.cholesky_lanes_plain(A)
    assert L.shape == (3, 4, 9, 9)
    flat = kernels.cholesky_lanes_plain(A.reshape(12, 9, 9))
    torch.testing.assert_close(L.reshape(12, 9, 9), flat, rtol=0, atol=0)


def test_cpu_wrapper_launches_nothing():
    """On a CPU tensor the wrapper is the plain version and the launch
    counter does not move."""
    rng = np.random.RandomState(3)
    A = torch.as_tensor(spd(rng, 5, 7), dtype=torch.float32)
    before = kernels.cholesky_lanes.launches
    L = kernels.cholesky_lanes(A)
    assert kernels.cholesky_lanes.launches == before
    torch.testing.assert_close(L, kernels.cholesky_lanes_plain(A),
                               rtol=0, atol=0)


def test_build_path_keyed_by_source_and_flags():
    """The library lands under build/ (listed in .gitignore), in a
    directory named by a hash of the kernel source and the nvcc flags."""
    p = _build.library_path("cholesky_lanes")
    assert p.name == "libcholesky_lanes.so"
    assert p.parent.parent == _build.BUILD_ROOT
    assert p == _build.library_path("cholesky_lanes")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC / "cholesky_lanes.cu").read_text()
    assert 'extern "C" int cholesky_lanes_f32(' in src


def _fma32(a, b, c):
    """fmaf in float32: the product of two float32 values is exact in
    float64, so a * b + c is rounded once there and once to float32 (the
    two roundings differ from one only in rare ties)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _pivot(c):
    """The kernel's reciprocal square root r of the pivot c (here rounded
    to nearest; the card's rsqrt.approx is within 2^-22.9 of it) and d =
    c r: both NaN for a pivot <= 0, subnormal or NaN; r = 0 and d = +inf
    for c = +inf."""
    pd = c >= np.finfo(np.float32).tiny
    r = np.where(pd, 1.0 / np.sqrt(np.where(pd, c, 1.0).astype(np.float64)),
                 np.nan).astype(np.float32)
    with np.errstate(invalid="ignore"):
        d = np.where(c == np.inf, c, c * r).astype(np.float32)
    return d, r


def _chol_lanes_blocked(A):
    """numpy emulation of csrc/cholesky_lanes.cu in float32: the stack
    padded to whole panels of ``kernels.tri_blocks``' nb with an identity
    tail; per panel (a) the diagonal block column by column (the pivot's
    reciprocal square root r and d = c r, l = a r, fmaf updates inside the
    block), (b) the rows
    below by forward substitution against it (fmaf chain in column order,
    times r), (c) the trailing part fmaf-updated with the panel's columns
    in order.  Only the lower triangle of A is read."""
    N, n, _ = A.shape
    nb, npan = kernels.tri_blocks(n)
    npd = nb * npan
    W = np.zeros((N, npd, npd), np.float32)
    W[:, :n, :n] = np.tril(A)
    W[:, np.arange(n, npd), np.arange(n, npd)] = 1.0
    for k0 in range(0, npd, nb):
        k1 = k0 + nb
        pivots = []
        for q in range(k0, k1):                       # (a)
            pivots.append(W[:, q, q].copy())
            d, r = _pivot(W[:, q, q])
            W[:, q, q] = d
            W[:, q + 1:k1, q] = W[:, q + 1:k1, q] * r[:, None]
            lq = W[:, q + 1:k1, q]
            W[:, q + 1:k1, q + 1:k1] = _fma32(-lq[:, :, None], lq[:, None, :],
                                              W[:, q + 1:k1, q + 1:k1])
        Lpp = W[:, k0:k1, k0:k1]
        rinv = np.stack([_pivot(c)[1] for c in pivots], axis=1)
        rows = W[:, k1:, k0:k1].copy()                # (b)
        for q in range(nb):
            s = rows[:, :, q]
            for t in range(q):
                s = _fma32(-rows[:, :, t], Lpp[:, q, t][:, None], s)
            rows[:, :, q] = s * rinv[:, q][:, None]
        W[:, k1:, k0:k1] = rows
        for k in range(nb):                           # (c)
            p = rows[:, :, k]
            W[:, k1:, k1:] = _fma32(-p[:, :, None], p[:, None, :], W[:, k1:, k1:])
    return np.tril(W[:, :n, :n])


def _chol_columns(A):
    """The same arithmetic one column at a time (right-looking, unblocked):
    what the blocking must reproduce bit for bit."""
    W = np.tril(A).astype(np.float32)
    n = A.shape[-1]
    for k in range(n):
        d, r = _pivot(W[:, k, k])
        W[:, k, k] = d
        lk = W[:, k + 1:, k] * r[:, None]
        W[:, k + 1:, k] = lk
        W[:, k + 1:, k + 1:] = _fma32(-lk[:, :, None], lk[:, None, :],
                                      W[:, k + 1:, k + 1:])
    return np.tril(W)


@pytest.mark.parametrize("case", ["n=10", "n=17", "n=65", "n=129", "n=130",
                                  "n=300", "ill-conditioned", "nan"])
def test_blocked_arithmetic_meets_the_bar(case):
    """The CUDA kernel's arithmetic, emulated in float32 at its panel split:
    equal bit for bit to the unblocked column order (the panels change the
    schedule only), within the lanes-Cholesky bar of float64 numpy and of
    the JAX kernel (Pallas in interpret mode up to n ~ 110, where it
    falls back to XLA), on ragged n, on an IPM-like ill-conditioned matrix
    (rows and columns scaled by e^U(-4, 4)) and with a non-PD and a
    NaN-bearing matrix in the stack, each NaN in its own factor only."""
    rng = np.random.RandomState(4)
    n = {"ill-conditioned": 65, "nan": 65}.get(case) or int(case[2:])
    N = 2 if n == 300 else 4
    A = spd(rng, N, n)
    if case == "ill-conditioned":
        d = np.exp(rng.uniform(-4, 4, (N, n)))
        A = d[:, :, None] * A * d[:, None, :]
    A = A.astype(np.float32)
    clean = _chol_lanes_blocked(A)
    if case == "nan":
        A[1] -= np.float32(4 * n) * np.eye(n, dtype=np.float32)
        A[2, n - 1, 0] = np.nan
    E = _chol_lanes_blocked(A)
    np.testing.assert_array_equal(E, _chol_columns(A))
    ref = np.asarray(jax_cholesky_lanes(jnp.asarray(A), interpret=True))
    assert (np.triu(E, 1) == 0).all()
    if case == "nan":
        for b in range(N):
            assert np.isnan(E[b]).any() == (b in (1, 2))
            assert np.isnan(ref[b]).any() == (b in (1, 2))
        np.testing.assert_array_equal(E[[0, 3]], clean[[0, 3]])
        return
    exact = np.linalg.cholesky(A.astype(np.float64))
    np.testing.assert_allclose(E, exact, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(E, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [10, 65])
def test_pivot_edges_as_the_jax_kernel(n):
    """Pivots that are no positive normal float, emulated as the CUDA
    kernel computes them and held to the JAX kernel in interpret mode: a
    subnormal pivot reads as zero (XLA's CPU flushes it, as the TPU does),
    so NaN in that factor only; a +inf pivot gives +inf on the diagonal,
    zeros below it and the factor of the trailing matrix (sqrt, then
    divide)."""
    rng = np.random.RandomState(5)
    S = spd(rng, 1, n)[0].astype(np.float32)
    A = np.stack([S, S, S])
    A[0, 0, 0] = np.float32(1e-40)
    A[1, 0, 0] = np.inf
    E = _chol_lanes_blocked(A)
    np.testing.assert_array_equal(E, _chol_columns(A))
    ref = np.asarray(jax_cholesky_lanes(jnp.asarray(A), interpret=True))
    for L in (E, ref):
        assert np.isnan(L).reshape(3, -1).any(1).tolist() == [True, False,
                                                               False]
        assert L[1, 0, 0] == np.inf and (L[1, 1:, 0] == 0).all()
    np.testing.assert_allclose(E[1:], ref[1:], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(E[1, 1:, 1:], np.linalg.cholesky(
        S[1:, 1:].astype(np.float64)), rtol=TOL, atol=TOL)
