"""scipsdp_tpu_torch.ops.ipm against scipsdp_tpu.ops.ipm on the CPU: the
data build, the presolve, the first iterations of the solve, the settings
and the parts that are not ported yet.  Full solves are in
test_torch_ipm_solve.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close_scaled, jax_solve, node_boxes,
                           pinned, problem, torch_solve)
from scipsdp_tpu.ops import ipm as jipm
from scipsdp_tpu.utils import config as jcfg
from scipsdp_tpu_torch.models import families as tfam
from scipsdp_tpu_torch.models.problem import densify as tdensify
from scipsdp_tpu_torch.ops import ipm as tipm
from scipsdp_tpu_torch.ops import kernels
from scipsdp_tpu_torch.utils import config as tcfg


@pytest.mark.parametrize("name", ["cls", "tt", "mkp"])
def test_build_ipm_data_exact(name):
    """The port's own build (from its copied generators and densify) equals
    the JAX build carried over by ipm_data_from_numpy, bit for bit."""
    prob_j, _, via_jax = problem(name)
    gen = {"cls": lambda: tfam.cardinality_least_squares(6, 12, 3, seed=1),
           "tt": lambda: tfam.truss_topology(6, 2, seed=0),
           "mkp": lambda: tfam.min_k_partition(6, 3, 0.6, seed=1)}[name]
    own = tipm.build_ipm_data(tdensify(gen()), "cpu")
    for f in ("A", "C", "dimmask"):
        a, b = getattr(own, f), getattr(via_jax, f)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in ("G", "h", "b_base"):
        assert torch.equal(getattr(own, f), getattr(via_jax, f)), f
    assert (own.nvars, own.ndim_sdp, own.block_of) == \
        (via_jax.nvars, via_jax.ndim_sdp, via_jax.block_of)
    moved = own.to("cpu")
    assert all(torch.equal(x, y) for x, y in zip(moved.A, own.A))
    assert moved.block_of == own.block_of


@pytest.mark.parametrize("seed", range(4))
def test_bucketize_matches(seed):
    rng = np.random.default_rng(seed)
    sizes = list(rng.integers(1, 30, size=int(rng.integers(1, 12))))
    for nb in (1, 2, 4):
        assert tipm._bucketize(sizes, nb) == jipm._bucketize(sizes, nb)


def _presolve_case():
    """CLS 4x8 (x: 0-3, z: 4-7, t: 8, r: 9) with per-node cut rows and
    five boxes: the root; a box whose single-free-variable cut rows hit one
    variable three times (duplicate scatter indices); a conflicting box; an
    all-fixed box; a fixed-z box whose big-M rows turn into bounds that fix
    x, plus one cut bounding t."""
    prob, jdata, tdata = problem("cls_4x8")
    mp = jdata.nvars + 1
    B = 5
    lb = np.tile(np.concatenate([prob.lb, [0.0]]), (B, 1))
    ub = np.tile(np.concatenate([prob.ub, [0.0]]), (B, 1))
    # cuts: three rows on y0 alone (two lower bounds, one upper bound),
    # valid in box 1 only, and one on t alone, valid in box 4 only
    Gcut = np.zeros((B, 4, mp))
    Gcut[:, 0, 0], Gcut[:, 1, 0], Gcut[:, 2, 0] = 1.0, 2.0, -1.0
    Gcut[:, 3, 8] = 1.0
    hcut = np.tile([0.5, 3.0, -4.0, 7.0], (B, 1))
    cutvalid = np.zeros((B, 4), bool)
    cutvalid[1, :3] = True
    cutvalid[4, 3] = True
    lb[2, 5], ub[2, 5] = 1.0, 0.0             # conflicting box
    lb[3], ub[3] = 0.0, 0.0                   # all fixed (x = z = t = 0)
    lb[4, 4:8], ub[4, 4:8] = 0.0, 0.0         # z fixed: x_j free in 1 row
    return prob, jdata, tdata, Gcut, hcut, cutvalid, lb, ub


def test_presolve_exact():
    prob, jdata, tdata, Gcut, hcut, cutvalid, lb, ub = _presolve_case()
    B = lb.shape[0]
    Gj = jnp.concatenate([jnp.broadcast_to(jdata.G[None], (B,) + jdata.G.shape),
                          jnp.asarray(Gcut)], axis=1)
    hj = jnp.concatenate([jnp.broadcast_to(jdata.h[None], (B,) + jdata.h.shape),
                          jnp.asarray(hcut)], axis=1)
    vj = jnp.concatenate([jnp.ones((B, jdata.G.shape[0]), bool),
                          jnp.asarray(cutvalid)], axis=1)
    ref = jipm.presolve(jdata, Gj, hj, vj, jnp.asarray(lb), jnp.asarray(ub),
                        1e-5, 1e-9, 3)
    out = tipm.presolve(tdata, torch.tensor(np.asarray(Gj)),
                        torch.tensor(np.asarray(hj)),
                        torch.tensor(np.asarray(vj)), torch.as_tensor(lb),
                        torch.as_tensor(ub), 1e-5, 1e-9, 3)
    for f in tipm.PresolveOut._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    # the duplicate-index rows were all applied: y0 >= max(0.5, 1.5)
    assert out.lb[1, 0] == 1.5 and out.ub[1, 0] == 4.0
    assert out.lb[4, 8] == 7.0 and out.fix[4, :8].all()
    assert out.conflict.tolist() == [False, False, True, False, False]
    assert out.allfixed.tolist() == [False, False, False, True, False]


def test_argmax_of_bool_pattern_picks_first_true():
    """presolve's jstar: the port casts the 0/1 pattern to int32 before
    argmax; both frameworks then return the FIRST maximal index (and 0 for
    an all-False row)."""
    rng = np.random.default_rng(9)
    pat = rng.random((6, 7, 9)) < 0.3
    pat[0, 0] = False
    pat[1, 2] = True
    ref = np.asarray(jnp.argmax(jnp.asarray(pat), axis=2))
    got = torch.argmax(torch.as_tensor(pat).to(torch.int32), dim=2).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 0 and got[1, 2] == 0


@pytest.mark.parametrize("max_iters", [1, 3])
@pytest.mark.parametrize("step_rule", ["probe", "eigh"])
def test_first_iterations_match(max_iters, step_rule):
    """After 1 and 3 iterations every returned iterate agrees: rtol 1e-9,
    atol 1e-10 * (1 + max|ref|) (float64 rounding of two LAPACK builds,
    amplified by a few Newton steps)."""
    _, jdata, tdata = problem("cls")
    prob = problem("cls")[0]
    b, lb, ub = node_boxes(prob, 4, seed=1)
    kw = pinned(step_rule, max_iters=max_iters)
    ref = jax_solve(jdata, b, lb, ub, kw)
    out = torch_solve(tdata, b, lb, ub, kw)
    assert out["iters"] == int(ref["iters"]) == max_iters
    for f in ("y", "xl", "xlb", "xub", "gap", "pinf", "dinf", "dobj"):
        assert_close_scaled(out[f], ref[f], 1e-9, 1e-10, f)
    for t, (x, xr) in enumerate(zip(out["X"], ref["X"])):
        assert_close_scaled(x, xr, 1e-9, 1e-10, f"X[{t}]")
    np.testing.assert_array_equal(out["status"], ref["status"])


def test_lanes_chol_flag_on_cpu_uses_plain_version():
    """use_lanes_chol=True routes the probe through the kernel wrapper,
    which on the CPU is the plain version: identical results, no launch."""
    _, _, tdata = problem("cls")
    b, lb, ub = node_boxes(problem("cls")[0], 4, seed=2)
    before = kernels.cholesky_lanes.launches
    on = torch_solve(tdata, b, lb, ub, pinned("probe") | {"use_lanes_chol": True})
    off = torch_solve(tdata, b, lb, ub, pinned("probe"))
    assert kernels.cholesky_lanes.launches == before
    assert on["iters"] == off["iters"]
    np.testing.assert_array_equal(on["dobj"], off["dobj"])


@pytest.mark.parametrize("kw,extra", [
    ({"phase32": "refine"}, {}),
    ({"phase32": "on"}, {}),
    ({"phase32": "lite"}, {}),
    ({"use_df32": "on"}, {}),
    ({"fused_direction": "on"}, {}),
    ({"use_pallas": True}, {}),
    ({"dtype": "float32"}, {}),
    ({"preopt_gap": 1e-2}, {}),
    ({}, {"warm_y": "y"}),
    ({}, {"warm_X": "X"}),
    ({}, {"ip_point": "ip"}),
])
def test_unported_paths_raise(kw, extra):
    """Only dtype="float32" raises: the JAX reference's float32 solve
    itself raises NameError (its float32 pass reads A32, bound only for
    the phase32 tiers, which need float64), so there is no reference to
    hold a port against.  phase32 "refine", "on" and "lite", use_pallas,
    the warm starts (warm_y, warm_X, ip_point) and preopt_gap are ported,
    and use_df32="on" and fused_direction="on" are inert outside the
    refine tier, as in JAX: those cases solve (the warm-start arguments
    come from a first solve of the same boxes)."""
    _, _, tdata = problem("cls")
    b, lb, ub = node_boxes(problem("cls")[0], 2)
    settings = tcfg.IPMSettings(**(pinned("probe") | kw))
    if kw == {"dtype": "float32"}:
        with pytest.raises(NotImplementedError):
            tipm.ipm_solve(tdata, b, lb, ub, settings=settings, **extra)
        return
    if extra:
        first = tipm.ipm_solve(tdata, b, lb, ub, settings=settings)
        extra = {"warm_y": {"warm_y": first.y},
                 "warm_X": {"warm_X": first.X},
                 "ip_point": {"ip_point": (first.y[0],
                                           tuple(x[0] for x in first.X))},
                 }[next(iter(extra))]
    out = tipm.ipm_solve(tdata, b, lb, ub, settings=settings, **extra)
    assert out.status.tolist() == [1, 1]
    assert out.f64_iters <= out.iters
    assert (out.has_pre is not None) == (settings.preopt_gap > 0)


def test_settings_fields_match_jax():
    """The copied dataclasses keep every field and default of the JAX
    package's settings."""
    for cls in ("IPMSettings", "BBSettings", "PresolveSettings",
                "CutSettings", "Settings"):
        j = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, cls))]
        t = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, cls))]
        assert t == j, cls


@pytest.mark.parametrize("device,expect", [
    ("cpu", ("eigh", False, "off")),
    ("cuda", ("probe", True, "off")),
])
def test_resolve_backend_autos(device, expect):
    s = tcfg.resolve_backend_autos(tcfg.Settings(), torch.device(device))
    assert (s.ipm.step_rule, s.ipm.use_lanes_chol, s.ipm.phase32) == expect
    assert tcfg.resolve_backend_autos(s, device) == s
    pinned_s = tcfg.Settings(ipm=tcfg.IPMSettings(step_rule="power",
                                                   use_lanes_chol=False,
                                                   phase32="off"))
    assert tcfg.resolve_backend_autos(pinned_s, device) == pinned_s


def test_resolve_cpu_matches_jax_cpu():
    j = jcfg.resolve_backend_autos(jcfg.Settings()).ipm
    t = tcfg.resolve_backend_autos(tcfg.Settings(), "cpu").ipm
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
