"""scipsdp_tpu_torch.ops.df32 on the CPU: the plain version of each exact
contraction against the JAX package's double-single math, and the
wrappers' CPU dispatch.

The JAX math runs eagerly, as tests/test_df32.py runs it (under
``jax.disable_jit()``: XLA:CPU's compiled code FMA-contracts the error-free
transforms away), on the same seeded inputs and at the same bars: relative
error (max |diff| / max |reference|) at most 1e-11, and 1e-9 on the X S
near-central-path cancellation.  Above 64 instances the JAX package routes
to its lanes kernels, whose recurrences are run here the way
test_df32.py's lanes test runs them.

The CUDA kernels run only on the card: ``python3 chip_smoke.py`` holds each
against the same plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scipsdp_tpu.ops.df32 as jdf
from scipsdp_tpu_torch import _build
from scipsdp_tpu_torch.ops import df32

BAR = 1e-11
CANCEL_BAR = 1e-9
KERNELS = ("bmm64", "contract_short64", "contract_long64")


def _split64(x):
    hi = x.astype(np.float32)
    return hi, (x - hi.astype(np.float64)).astype(np.float32)


def _pair(x):
    """The JAX package's operand pair: a float32 operand is exact in hi."""
    if x.dtype == np.float32:
        return x, np.zeros_like(x)
    return _split64(x)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _joined(mathfn, *args):
    """Run a JAX double-single function eagerly; hi + lo in float64."""
    with jax.disable_jit():
        hi, lo = mathfn(*args)
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _t(x):
    return torch.as_tensor(x)


def _jax_bmm(A, B):
    """Per-matrix grid route (_bmm_math) below 64 matrices, the lanes
    recurrence (_bmm_lanes_kernel's rank-1 dd-MACs) from 64 on."""
    if A.shape[0] < 64:
        return np.stack([_joined(jdf._bmm_math, *_pair(a), *_pair(b))
                         for a, b in zip(A, B)])
    (ah, al), (bh, bl) = _pair(A), _pair(B)

    def lanes():
        sh = jnp.zeros(A.shape, jnp.float32)
        sl = jnp.zeros(A.shape, jnp.float32)
        for c in range(A.shape[-1]):
            sh, sl = jdf._dd_mac(sh, sl, ah[:, :, c, None], al[:, :, c, None],
                                 bh[:, None, c, :], bl[:, None, c, :])
        return sh, sl
    return _joined(lanes)


def _jax_short(M, v):
    """out[g, f] = sum_j M[(g,) j, f] v[g, j] by the route the JAX package
    takes for G instances."""
    G = v.shape[0]
    Ms = M if M.ndim == 3 else np.broadcast_to(M, (G,) + M.shape)
    if G < 64:
        return np.concatenate([
            _joined(jdf._short_math, *_pair(Ms[g]), *_pair(v[g:g + 1]))
            for g in range(G)])
    (mh, ml), (vh, vl) = _pair(np.transpose(Ms, (1, 2, 0))), _pair(v.T)

    def lanes():   # _contract_short_lanes_kernel: out[f, g]
        sh = jnp.zeros(mh.shape[1:], jnp.float32)
        sl = jnp.zeros(mh.shape[1:], jnp.float32)
        for j in range(mh.shape[0]):
            sh, sl = jdf._dd_mac(sh, sl, mh[j], ml[j], vh[j][None, :],
                                 vl[j][None, :])
        return sh, sl
    return _joined(lanes).T


def _jax_long(M, v):
    """out[g, j] = sum_f M[(g,) j, f] v[g, f] by the JAX package's route."""
    G = v.shape[0]
    Ms = M if M.ndim == 3 else np.broadcast_to(M, (G,) + M.shape)
    if G < 64:
        return np.stack([
            _joined(jdf._long_math, *_pair(Ms[g]), *_pair(v[g:g + 1]))
            for g in range(G)])
    (mh, ml), (wh, wl) = _pair(np.transpose(Ms, (1, 2, 0))), _pair(v.T)

    def lanes():   # _contract_long_lanes_kernel: out[j, g]
        rows_h, rows_l = [], []
        for j in range(mh.shape[0]):
            ph, pe = jdf._two_prod(mh[j], wh)
            pe = pe + (mh[j] * wl + ml[j] * wh)
            rh, re = jdf._dd_reduce(ph, pe, axis=0)
            rows_h.append(rh)
            rows_l.append(re)
        return jnp.stack(rows_h), jnp.stack(rows_l)
    return _joined(lanes).T


def test_bmm_against_jax_math_and_cancellation():
    """tests/test_df32.py's bmm inputs: a badly scaled product, and X S on
    the central path (O(1) products cancelling to O(mu))."""
    rng = np.random.default_rng(0)
    n = 24
    A = rng.standard_normal((n, n)) * np.exp(rng.uniform(-6, 6, (n, n)))
    B = rng.standard_normal((n, n))
    got = df32.bmm64_plain(_t(A[None]), _t(B[None])).numpy()[0]
    assert _rel(got, _jax_bmm(A[None], B[None])[0]) <= BAR
    assert _rel(got, A @ B) <= BAR

    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.exp(rng.uniform(-3, 3, n))
    mu = 1e-7
    X = (Q * lam) @ Q.T
    S = (Q * (mu / lam)) @ Q.T
    got = df32.bmm64_plain(_t(X[None]), _t(S[None])).numpy()[0]
    assert _rel(got, _jax_bmm(X[None], S[None])[0]) <= CANCEL_BAR
    assert _rel(got, X @ S) <= CANCEL_BAR


@pytest.mark.parametrize("G,n", [(3, 9), (70, 10)])
def test_bmm_both_routes_and_float32_operand(G, n):
    """G below and at or above 64 (the JAX grid/lanes split; (70, 10) is
    the MkP block shape), with a float32 right operand (the tier's
    float32-valued S^-1) that the port upcasts exactly."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((G, n, n)) * np.exp(rng.uniform(-4, 4, (G, 1, 1)))
    B32 = rng.standard_normal((G, n, n)).astype(np.float32)
    got = df32.bmm64_plain(_t(A), _t(B32))
    assert got.dtype == torch.float64 and got.shape == (G, n, n)
    assert _rel(got.numpy(), _jax_bmm(A, B32)) <= BAR
    assert _rel(got.numpy(), A @ B32.astype(np.float64)) <= BAR


def test_short_against_jax_math():
    """tests/test_df32.py's short-contraction inputs, static (J, F) M and
    the same M per instance."""
    rng = np.random.default_rng(2)
    J, F = 34, 200
    M = rng.standard_normal((J, F)) * 1e3
    v = rng.standard_normal((1, J))
    want = _jax_short(M, v)
    assert _rel(df32.contract_short64_plain(_t(M), _t(v)).numpy(), want) <= BAR
    assert _rel(df32.contract_short64_plain(_t(M[None]), _t(v)).numpy(),
                want) <= BAR
    assert _rel(want, np.einsum("jf,xj->xf", M, v)) <= BAR


def test_long_against_jax_math():
    """tests/test_df32.py's long-contraction inputs (entries spread over
    e^+-4), static and per instance."""
    rng = np.random.default_rng(3)
    J, F = 34, 777
    M = rng.standard_normal((J, F)) * np.exp(rng.uniform(-4, 4, (J, F)))
    v = rng.standard_normal((1, F))
    want = _jax_long(M, v)
    assert _rel(df32.contract_long64_plain(_t(M), _t(v)).numpy(), want) <= BAR
    assert _rel(df32.contract_long64_plain(_t(M[None]), _t(v)).numpy(),
                want) <= BAR
    assert _rel(want, np.einsum("jf,xf->xj", M, v)) <= BAR


def test_per_instance_scales_and_float32_m():
    """tests/test_df32.py's lanes-math inputs (per-instance M scaled by
    e^+-6 per instance), and the same M in float32 with float64 v (the
    tier's Wall)."""
    rng = np.random.default_rng(7)
    G, J, F = 6, 9, 300
    M = rng.standard_normal((G, J, F)) * np.exp(rng.uniform(-6, 6, (G, 1, 1)))
    v_s = rng.standard_normal((G, J))
    v_l = rng.standard_normal((G, F))
    for Mx in (M, M.astype(np.float32)):
        s = df32.contract_short64_plain(_t(Mx), _t(v_s))
        lo = df32.contract_long64_plain(_t(Mx), _t(v_l))
        assert s.dtype == lo.dtype == torch.float64
        assert _rel(s.numpy(), _jax_short(Mx, v_s)) <= BAR
        assert _rel(lo.numpy(), _jax_long(Mx, v_l)) <= BAR


@pytest.mark.parametrize("G,J,F", [(70, 65, 300), (200, 65, 300),
                                   (130, 9, 130)])
def test_lanes_route_shapes(G, J, F):
    """tests/test_df32.py's production-tier lanes shapes (G >= 64), with a
    per-instance and a static M."""
    rng = np.random.RandomState(9)
    M = rng.randn(G, J, F)
    v_s = rng.randn(G, J)
    v_l = rng.randn(G, F)
    for Mx in (M, M[0]):
        assert _rel(df32.contract_short64_plain(_t(Mx), _t(v_s)).numpy(),
                    _jax_short(Mx, v_s)) <= BAR
        assert _rel(df32.contract_long64_plain(_t(Mx), _t(v_l)).numpy(),
                    _jax_long(Mx, v_l)) <= BAR


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch."""
    rng = np.random.default_rng(11)
    A, B = _t(rng.standard_normal((4, 7, 7))), _t(rng.standard_normal((4, 7, 7)))
    M = _t(rng.standard_normal((4, 5, 30)).astype(np.float32))
    vs, vl = _t(rng.standard_normal((4, 5))), _t(rng.standard_normal((4, 30)))
    before = [getattr(df32, k).launches for k in KERNELS]
    pairs = [(df32.bmm64(A, B), df32.bmm64_plain(A, B)),
             (df32.contract_short64(M, vs), df32.contract_short64_plain(M, vs)),
             (df32.contract_short64(M[0], vs),
              df32.contract_short64_plain(M[0], vs)),
             (df32.contract_long64(M, vl), df32.contract_long64_plain(M, vl)),
             (df32.contract_long64(M[0], vl),
              df32.contract_long64_plain(M[0], vl))]
    for got, want in pairs:
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [getattr(df32, k).launches for k in KERNELS] == before


@pytest.mark.parametrize("G,n", [(1, 7), (33, 9), (2, 17), (3, 65)])
def test_bmm_float32_right_operand_on_cpu(G, n):
    """A float32 right operand (the CUDA kernel reads it as float32)
    through the wrapper on the CPU: float64 out, the plain version's bits,
    and the bits of the product with the operand upcast beforehand."""
    rng = np.random.default_rng(13)
    A = _t(rng.standard_normal((G, n, n)))
    B32 = _t(rng.standard_normal((G, n, n)).astype(np.float32))
    got = df32.bmm64(A, B32)
    assert got.dtype == torch.float64 and got.shape == (G, n, n)
    torch.testing.assert_close(got, df32.bmm64_plain(A, B32), rtol=0, atol=0)
    torch.testing.assert_close(got, df32.bmm64_plain(A, B32.double()),
                               rtol=0, atol=0)


def test_bmm_entry_point_takes_the_float32_flag():
    """The C entry point's signature as the wrapper declares it: three
    pointers, G, n, the b_is_f32 flag, the stream."""
    src = (_build.CSRC / "bmm64.cu").read_text()
    assert "int n, int b_is_f32, void* stream)" in src
    assert len(df32._ARGTYPES["bmm64"]) == 7
    assert "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64" in src


def test_bmm_shape_and_device_errors():
    """Stacks of different shapes, operands on two devices and an
    unsupported type or device raise."""
    A = torch.zeros((2, 3, 3), dtype=torch.float64)
    with pytest.raises((RuntimeError, ValueError)):
        df32.bmm64(A, torch.zeros((2, 4, 4), dtype=torch.float64))
    meta = torch.empty((2, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        df32.bmm64(A, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        df32.bmm64(meta, meta.float())


def test_wrappers_raise_off_cpu_and_cuda():
    """A device that is neither CPU nor CUDA, or operands on two devices,
    raise instead of falling back."""
    meta = torch.empty((2, 3, 3), dtype=torch.float64, device="meta")
    vm = torch.empty((2, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        df32.bmm64(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        df32.contract_short64(meta, vm)
    with pytest.raises(ValueError, match="unsupported device"):
        df32.contract_long64(meta, vm)
    with pytest.raises(ValueError, match="different devices"):
        df32.contract_long64(meta, torch.zeros((2, 3), dtype=torch.float64))


def test_kernel_sources_and_build_paths():
    """Each kernel has its own source with a plain C entry point, built
    for sm_90a into its own hashed directory under build/."""
    for name in KERNELS:
        p = _build.library_path(name)
        assert p.name == f"lib{name}.so" and p.parent.parent == _build.BUILD_ROOT
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_f64(' in src
        assert "cublas" not in src.lower()
    assert len({_build.library_path(k).parent for k in KERNELS}) == 3
    _build.build()   # nothing to build: no compiler is needed
