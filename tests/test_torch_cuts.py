"""The port's eigenvector cuts (``ops/cuts.py``) against the JAX
package's on the CPU.

* ``separate_eigenvector_cuts`` on random points of a random problem
  whose blocks fall into padded size buckets: eigenvalues within
  1e-9·(1 + |lam|), the same ``valid`` flags, coefficients and right-hand
  sides within 1e-7 relative (the spectra are simple, so each eigenvector
  is the same up to its sign, which a cut does not see).  At an integral
  LP vertex of min-k-partition an eigenvalue repeats, and how its
  eigenspace is split into vectors depends on the LAPACK build: there the
  sum of each eigenspace's cuts (the trace of A_j over the eigenspace) is
  held instead.
* ``sparsify_cut_tpower`` on random symmetric matrices and on one with
  exact ties among its largest entries, and ``multiple_sparse_cuts``: the
  same vectors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bbcases import torch_one_thread  # noqa: F401
from _torch_parity import port_data
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models.problem import (LinearConstraints, MISDP, SDPBlock,
                                        densify)
from scipsdp_tpu.ops import cuts as jcuts
from scipsdp_tpu.ops.ipm import build_ipm_data
from scipsdp_tpu_torch.ops import cuts as tcuts

pytestmark = pytest.mark.usefixtures("torch_one_thread")

LAM_TOL = 1e-9
COEF_RTOL = 1e-7


def random_prob(sizes, m, seed):
    """Dense random symmetric blocks of the given sizes over m variables."""
    rng = np.random.default_rng(seed)
    blocks = []
    for n in sizes:
        r, c = np.tril_indices(n)
        var = np.repeat(np.arange(m), len(r))
        blocks.append(SDPBlock(
            size=n, var=var, row=np.tile(r, m), col=np.tile(c, m),
            val=rng.standard_normal(m * len(r)), const_row=r, const_col=c,
            const_val=rng.standard_normal(len(r))))
    return MISDP(nvars=m, obj=rng.standard_normal(m), lb=np.full(m, -5.0),
                 ub=np.full(m, 5.0), integral=np.zeros(m, bool),
                 blocks=blocks, lp=LinearConstraints.empty(), name="rand")


def both_cuts(prob, y, tol=1e-6):
    jdata = build_ipm_data(densify(prob))
    a = jcuts.separate_eigenvector_cuts(jdata, jnp.asarray(y), tol=tol)
    b = tcuts.separate_eigenvector_cuts(port_data(jdata), y, tol=tol)
    return jdata, a, b


@pytest.mark.parametrize("sizes,m,seed", [((7, 3, 5, 12, 2, 4), 4, 0),
                                          ((9, 2, 3, 4, 6), 6, 1),
                                          ((6,), 3, 2)])
@pytest.mark.parametrize("with_penalty", [False, True])
def test_separate_matches_jax(sizes, m, seed, with_penalty):
    prob = random_prob(sizes, m, seed)
    rng = np.random.default_rng(seed + 10)
    y = rng.uniform(-1.0, 1.0, size=(5, m + int(with_penalty)))
    jdata, a, b = both_cuts(prob, y)
    assert jdata.nbuckets == len(b.lam) >= 1
    padded = 0
    for t in range(jdata.nbuckets):
        lam_j = np.asarray(a.lam[t])
        lam_t = b.lam[t].numpy()
        assert b.coefs[t].shape == a.coefs[t].shape
        assert b.valid[t].dtype == torch.bool
        np.testing.assert_allclose(lam_t, lam_j, rtol=0,
                                   atol=LAM_TOL * (1 + np.abs(lam_j).max()))
        np.testing.assert_array_equal(b.valid[t].numpy(),
                                      np.asarray(a.valid[t]))
        for got, want in ((b.coefs[t], a.coefs[t]), (b.rhs[t], a.rhs[t])):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=COEF_RTOL * (1 + np.abs(want).max()))
        padded += int((~np.asarray(jdata.dimmask[t])).sum())
    if len(sizes) > 1:
        assert padded > 0
    assert any(v.any() for v in b.valid)


def test_separate_on_a_repeated_eigenvalue():
    """An integral LP vertex of min-k-partition: the eigenvalue -1
    repeats.  Eigenvalues and flags agree; per eigenspace the sum of the
    cuts (basis-free) agrees."""
    prob = jfam.min_k_partition(5, 2)
    y = np.array([[0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0]])
    jdata, a, b = both_cuts(prob, y)
    repeated = 0
    for t in range(jdata.nbuckets):
        lam = np.asarray(a.lam[t])[0, 0]
        np.testing.assert_allclose(b.lam[t].numpy()[0, 0], lam, atol=1e-9)
        np.testing.assert_array_equal(b.valid[t].numpy(),
                                      np.asarray(a.valid[t]))
        groups = np.split(np.arange(lam.size),
                          np.flatnonzero(np.diff(lam) > 1e-8) + 1)
        for g in groups:
            repeated += len(g) > 1
            for got, want in ((b.coefs[t], a.coefs[t]),
                              (b.rhs[t], a.rhs[t])):
                gs = got.numpy()[0, 0][g].sum(axis=0)
                ws = np.asarray(want)[0, 0][g].sum(axis=0)
                np.testing.assert_allclose(gs, ws, atol=1e-9)
    assert repeated > 0


def symmetric(rng, n):
    M = rng.standard_normal((n, n))
    return M + M.T


@pytest.mark.parametrize("n,s", [(8, 3), (12, 5), (20, 6), (5, 5)])
def test_sparsify_cut_tpower(n, s):
    rng = np.random.default_rng(n + s)
    Z = symmetric(rng, n)
    vj = np.asarray(jcuts.sparsify_cut_tpower(jnp.asarray(Z), s))
    vt = tcuts.sparsify_cut_tpower(torch.from_numpy(Z), s).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-12)
    assert np.count_nonzero(vt) == s


def test_sparsify_keeps_every_tie():
    """Entries tied with the s-th largest stay, as lax.top_k's threshold
    keeps them: on a block of two equal diagonal blocks every power step
    keeps the tied pairs (exact ties, whatever the summation order)."""
    D = np.diag([-3.0, -1.0, -2.0, 0.5])
    Z = np.kron(np.eye(2), D)
    vj = np.asarray(jcuts.sparsify_cut_tpower(jnp.asarray(Z), 3))
    vt = tcuts.sparsify_cut_tpower(torch.from_numpy(Z), 3).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-12)
    assert np.count_nonzero(vt) == 4


@pytest.mark.parametrize("n,s,maxn", [(10, 3, -1), (16, 4, 2), (9, 9, -1)])
def test_multiple_sparse_cuts(n, s, maxn):
    rng = np.random.default_rng(n * s)
    Z = symmetric(rng, n)
    vj = jcuts.multiple_sparse_cuts(Z, s, maxn)
    vt = tcuts.multiple_sparse_cuts(Z, s, maxn)
    assert len(vt) == len(vj) > 0
    for a, b in zip(vt, vj):
        np.testing.assert_allclose(a, b, atol=1e-10)
    supports = [set(np.flatnonzero(v)) for v in vt]
    for i in range(len(supports)):
        for j in range(i):
            assert not supports[i] & supports[j]
