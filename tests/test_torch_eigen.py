"""scipsdp_tpu_torch.ops.eigen against scipsdp_tpu.ops.eigen (float64, CPU).

Same numpy inputs through both.  Tolerance: rtol 1e-12 plus an absolute
1e-12 * (1 + max|ref|) — the two frameworks call different LAPACK builds,
which agree to rounding relative to the matrix norm, not per entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close_scaled
from scipsdp_tpu.ops import eigen as je
from scipsdp_tpu_torch.ops import eigen as te

RTOL = 1e-12


def _spd(rng, shape, n):
    a = rng.standard_normal(shape + (n, n))
    return np.einsum("...ij,...kj->...ik", a, a) + n * np.eye(n)


def _symm(rng, shape, n):
    a = rng.standard_normal(shape + (n, n))
    return 0.5 * (a + np.swapaxes(a, -1, -2))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    M = _spd(rng, (3, 2), 7)
    L = np.linalg.cholesky(M)
    dM = _symm(rng, (3, 2), 7)
    Y = _symm(rng, (3, 2), 7)
    return rng, M, L, dM, Y


def _both(fn_name, *args):
    j = getattr(je, fn_name)(*[jnp.asarray(a) for a in args])
    t = getattr(te, fn_name)(*[torch.as_tensor(a) for a in args])
    return np.asarray(j), t.numpy()


CASES = {
    "sym": lambda rng, M, L, dM, Y: (rng.standard_normal((4, 5, 5)),),
    "ymat": lambda rng, M, L, dM, Y: (np.linalg.inv(L), dM),
    "max_step_psd": lambda rng, M, L, dM, Y: (L, dM),
    "max_step_psd_power": lambda rng, M, L, dM, Y: (L, dM),
    "max_step_from_ymat": lambda rng, M, L, dM, Y: (Y,),
    "max_step_eigh_from_ymat": lambda rng, M, L, dM, Y: (Y,),
    "gersh_step_from_ymat": lambda rng, M, L, dM, Y: (Y,),
    "spd_inverse": lambda rng, M, L, dM, Y: (M,),
    "chol_solve": lambda rng, M, L, dM, Y: (L, rng.standard_normal((3, 2, 7))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    rng, M, L, dM, Y = _inputs()
    j, t = _both(name, *CASES[name](rng, M, L, dM, Y))
    assert t.dtype == np.float64 and t.shape == j.shape
    assert_close_scaled(t, j, RTOL, 1e-12, name)


def test_step_rules_report_inf_for_psd_directions():
    """A PSD direction never leaves the cone: every exact rule says inf."""
    rng, M, L, dM, Y = _inputs(1)
    Ypsd = _spd(rng, (3,), 6)
    for name in ("max_step_from_ymat", "max_step_eigh_from_ymat"):
        j, t = _both(name, Ypsd)
        assert np.isinf(j).all() and np.isinf(t).all(), name


def test_min_eigenvalue_masks_padding():
    rng = np.random.default_rng(2)
    M = _symm(rng, (4, 3), 6)
    mask = np.ones((4, 3, 6), bool)
    mask[:, 1, 4:] = False          # a padded block
    mask[2, 2, 1:] = False
    j = np.asarray(je.min_eigenvalue(jnp.asarray(M), jnp.asarray(mask)))
    t = te.min_eigenvalue(torch.as_tensor(M), torch.as_tensor(mask)).numpy()
    assert_close_scaled(t, j, RTOL, 1e-12, "min_eigenvalue")


def test_max_step_pos_masks_and_inf():
    rng = np.random.default_rng(3)
    v = rng.random((5, 9)) + 0.1
    dv = rng.standard_normal((5, 9))
    mask = rng.random((5, 9)) < 0.7
    mask[0] = False                 # nothing masked in: inf
    dv[1] = np.abs(dv[1])           # no decreasing entry: inf
    j = np.asarray(je.max_step_pos(jnp.asarray(v), jnp.asarray(dv),
                                   jnp.asarray(mask)))
    t = te.max_step_pos(torch.as_tensor(v), torch.as_tensor(dv),
                        torch.as_tensor(mask)).numpy()
    assert np.isinf(t[:2]).all()
    assert_close_scaled(t[2:], j[2:], RTOL, 0.0, "max_step_pos")
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))


def test_cholesky_nan_semantics_match_jax():
    """jnp.linalg.cholesky symmetrizes its input and fills the factor of a
    matrix that is not PD with NaN on and below the diagonal; the port's
    cholesky does the same (and never raises), matrix by matrix."""
    rng = np.random.default_rng(4)
    A = _spd(rng, (5,), 6)
    A[:, 0, 3] += 1e-3              # not exactly symmetric
    A[2] -= 40.0 * np.eye(6)        # indefinite
    j = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    t = te.cholesky(torch.as_tensor(A)).numpy()
    low = np.tril(np.ones((6, 6), bool))
    np.testing.assert_array_equal(np.isnan(t[2]), low)
    np.testing.assert_array_equal(np.isnan(j[2]), low)
    assert (t[2][~low] == 0).all()
    keep = [0, 1, 3, 4]
    assert not np.isnan(t[keep]).any()
    assert_close_scaled(t[keep], j[keep], RTOL, 1e-12, "cholesky")


def test_eigvalsh_nan_input_gives_nan():
    rng = np.random.default_rng(5)
    M = _symm(rng, (3,), 4)
    M[1, 2, 2] = np.nan
    w = te.eigvalsh(torch.as_tensor(M)).numpy()
    wj = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(M)))
    assert np.isnan(w[1]).all() and np.isnan(wj[1]).all()
    assert_close_scaled(w[[0, 2]], wj[[0, 2]], RTOL, 1e-12, "eigvalsh")
