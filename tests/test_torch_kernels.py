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
