"""The refine tier (phase32="refine"): the port's ipm_solve against the JAX
package's on the CPU.

JAX runs the tier as its CPU tests pin it (use_df32="off",
fused_direction="off": float64 einsums for the exact contractions); the
port runs it with use_df32 on, which on CPU tensors is the df32 wrappers'
plain route.  Per slot the status must agree, the batch's iteration count
within 2, and a settled slot's dobj within DOBJ_BAR * (1 + |dobj|).

The tier factors in float32, and float32 factorizations from two LAPACK
builds (XLA:CPU's and PyTorch's MKL) part after a few iterations, so the
two solves follow different paths to the same bound.  The largest
deviation seen over every case of this file was 1.7e-6 relative (MkP,
B=8, eigh rule), with iteration counts at most 2 apart; the bar is 5e-6,
a quarter of the 2 * gaptol (2e-5) a converged bound is good for.

MkP is min_k_partition(6, 3, 0.6, seed=12) here, not the seed-1 instance
of the other parity files: in the refine tier that instance's root sits at
the float32 edge — a float32 step lets X or S lose definiteness, and the
slot FAILs — in both frameworks, on opposite step rules (JAX FAILs it with
the probe rule, the port with eigh), so no status comparison can hold
there.  Seed 12 stays clear of that edge in both frameworks for every case
below.

The fused direction (fused_direction="on": ops/fused.py's three kernels,
their plain versions on CPU tensors) is held against JAX's NON-fused tier
at the same bars: JAX runs its fused kernels only where Pallas compiles for
a TPU, never on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_solve, node_boxes, port_data, problem, torch_solve
from scipsdp_tpu.ops import ipm as jipm
from scipsdp_tpu_torch.ops import df32, fused
from scipsdp_tpu_torch.ops import ipm as tipm
from scipsdp_tpu_torch.utils.status import SolverResultStatus

DOBJ_BAR = 5e-6
ITERS_TOL = 2
SETTLED = [int(s) for s in (SolverResultStatus.OPTIMAL,
                            SolverResultStatus.PRESOLVED_INFEASIBLE,
                            SolverResultStatus.PRESOLVED_OPTIMAL)]
DF32 = {"use_df32": "on"}
FUSED = {"use_df32": "on", "fused_direction": "on"}
FUSED_KERNELS = ("rhs_bucket", "schur_solve_fused", "recover_bucket")


def refine(step_rule, **kw):
    """The tier's pinned settings on the JAX side."""
    return dict(phase32="refine", step_rule=step_rule, use_lanes_chol=False,
                use_df32="off", fused_direction="off", **kw)


def _compare(name, B, step_rule, mode="direct", seed=1, port=DF32, data=None,
             where_settled=False, **kw):
    """The port (settings ``port`` over JAX's) against JAX on the same
    boxes; ``data`` replaces the instance's (JAX, port) IPMData.  With
    ``where_settled`` the statuses and bounds are compared only where JAX
    settles, and the iterations not at all."""
    prob, jdata, tdata = problem(name)
    if data is not None:
        jdata, tdata = data
    b, lb, ub = node_boxes(prob, B, seed=seed, mode=mode)
    jkw = refine(step_rule, **kw)
    ref = jax_solve(jdata, b, lb, ub, jkw)
    out = torch_solve(tdata, b, lb, ub, jkw | port)
    ok = np.isin(ref["status"], SETTLED)
    if where_settled:
        np.testing.assert_array_equal(out["status"][ok], ref["status"][ok])
    else:
        np.testing.assert_array_equal(out["status"], ref["status"])
        assert abs(out["iters"] - int(ref["iters"])) <= ITERS_TOL
    d, dr = out["dobj"][ok], ref["dobj"][ok]
    assert np.all(np.abs(d - dr) <= DOBJ_BAR * (1.0 + np.abs(dr))), (d, dr)
    return out, ref


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("name", ["cls", "tt", "mkp_s12"])
@pytest.mark.parametrize("step_rule", ["probe", "eigh"])
def test_small_families(step_rule, name, B):
    out, _ = _compare(name, B, step_rule)
    assert out["status"][0] == 1      # the root box converges (OPTIMAL)


@pytest.mark.parametrize("mode", ["direct", "probe", "penalty"])
def test_penalty_modes(mode):
    """The three modes of the penalty variable r.  The Gamma=1e3 penalty
    solve stalls in the refine tier, in JAX as in the port, and escalates
    to float64.  There JAX shifts the Schur system by its largest entry
    (r's bound barrier, without limit as r -> 0), stalls again and FAILs
    every slot; the port shifts each row by its own diagonal where r is
    free and solves most: in that mode the port is held to JAX where JAX
    settles."""
    out, ref = _compare("cls", 8, "probe", mode=mode, seed=3,
                        where_settled=mode == "penalty")
    if mode != "direct":
        assert (out["r"] >= -1e-6).all()
    if mode == "penalty":
        assert (ref["status"] == 5).all()          # FAILED
        assert (out["status"] == 1).sum() >= 4, out["status"]


def test_cls_32():
    """cardinality_least_squares(32, 64, 8, seed=5) at B=8: the card's
    main-path shapes (one 65x65 block, mp = 66, 65 LP rows)."""
    out, _ = _compare("cls_32", 8, "probe")
    assert (out["status"] == 1).all()


def test_gondzio_correctors():
    """gondzio=2 on TT boxes where the corrected directions are accepted
    in both frameworks: the bounds move against the solve without
    correctors."""
    out, _ = _compare("tt", 8, "probe", seed=4, gondzio=2)
    prob, _, tdata = problem("tt")
    b, lb, ub = node_boxes(prob, 8, seed=4)
    plain = torch_solve(tdata, b, lb, ub, refine("probe") | {"use_df32": "on"})
    assert not np.array_equal(out["dobj"], plain["dobj"])


def test_refine_switch_hands_over_to_float64():
    """refine_switch=1e-3: once every active relative gap is below it,
    the batch runs its remaining iterations in float64."""
    out, _ = _compare("tt", 8, "probe", seed=4, refine_switch=1e-3)
    assert 0 < out["f64_iters"] < out["iters"]


def test_nan32_repair(monkeypatch):
    """A float32 NaN injected into one slot's X/S factor in the fourth
    iteration: that slot skips its update, the next iteration runs in
    float64 (the nan32 repair), the tier resumes, and every slot ends as
    in JAX's uninjected solve."""
    prob, jdata, tdata = problem("cls")
    b, lb, ub = node_boxes(prob, 8, seed=1)
    kw = refine("probe")
    clean = torch_solve(tdata, b, lb, ub, kw | {"use_df32": "on"})
    assert clean["f64_iters"] == 0

    real = tipm.cholesky
    calls = []

    def faulty(A):
        L = real(A)
        if A.dtype == torch.float32 and A.dim() == 4:   # the X/S factors
            calls.append(A.shape)
            if len(calls) == 4:
                L = L.clone()
                L[2] = float("nan")
        return L

    monkeypatch.setattr(tipm, "cholesky", faulty)
    out = torch_solve(tdata, b, lb, ub, kw | {"use_df32": "on"})
    ref = jax_solve(jdata, b, lb, ub, kw)
    assert len(calls) >= 4 and out["f64_iters"] >= 1
    np.testing.assert_array_equal(out["status"], ref["status"])
    assert (out["status"] == 1).all()
    assert abs(out["iters"] - int(ref["iters"])) <= ITERS_TOL + 1
    assert np.all(np.abs(out["dobj"] - ref["dobj"])
                  <= DOBJ_BAR * (1.0 + np.abs(ref["dobj"])))


def test_plain_route_matches_wrapper_route():
    """use_df32="off" (the plain versions on any device) and the wrappers
    on CPU tensors are one computation: identical results."""
    prob, _, tdata = problem("mkp_s12")
    b, lb, ub = node_boxes(prob, 4, seed=2)
    kw = refine("probe")
    before = [getattr(df32, k).launches
              for k in ("bmm64", "contract_short64", "contract_long64")]
    on = torch_solve(tdata, b, lb, ub, kw | {"use_df32": "on"})
    off = torch_solve(tdata, b, lb, ub, kw)
    assert on["iters"] == off["iters"]
    np.testing.assert_array_equal(on["dobj"], off["dobj"])
    assert [getattr(df32, k).launches
            for k in ("bmm64", "contract_short64", "contract_long64")] == before


@pytest.mark.parametrize("name,mode,seed", [
    ("cls", "direct", 1), ("tt", "direct", 3), ("mkp_s12", "direct", 1),
    ("cls_32", "direct", 1), ("cls", "probe", 3)])
def test_fused_direction_matches_jax(name, mode, seed):
    """fused_direction="on" at B=8 with the probe rule, against JAX's
    non-fused tier: the small families, the card's main-path block shape
    (cls_32) and the Gamma=1 probe mode of the penalty variable.

    TT uses the boxes of seed 3: with seeds 1 and 2 the batch ends in nan32
    repairs whose timing follows float32 rounding, and the iteration counts
    part by 2-4 (JAX 19 and 16; the port's non-fused direction 21 and 20,
    its fused direction 24 and 18), while the fused and non-fused iterates
    agree to 3e-13 through the first 12 iterations."""
    out, _ = _compare(name, 8, "probe", mode=mode, seed=seed, port=FUSED)
    assert out["status"][0] == 1


def _padded(name, extra):
    """(JAX, port) IPMData of ``name`` with every block of every bucket
    padded by ``extra`` zero rows and columns outside its dimmask, as a
    bucket pads its smaller blocks."""
    _, jdata, _ = problem(name)

    def grow(a, axes, value=0):
        a = np.asarray(a)
        return np.pad(a, [(0, extra if i in axes else 0)
                          for i in range(a.ndim)], constant_values=value)

    jpad = jipm.IPMData(
        A=tuple(jnp.asarray(grow(a, (2, 3))) for a in jdata.A),
        C=tuple(jnp.asarray(grow(c, (1, 2))) for c in jdata.C),
        dimmask=tuple(jnp.asarray(grow(d, (1,), False))
                      for d in jdata.dimmask),
        G=jdata.G, h=jdata.h, b_base=jdata.b_base, nvars=jdata.nvars,
        ndim_sdp=jdata.ndim_sdp, block_of=jdata.block_of)
    return jpad, port_data(jpad)


def test_fused_direction_padded_bucket():
    """TT's two 4x4 blocks padded to 6x6 (the padding a bucket gives its
    smaller blocks): the recovery's pad mask in a full solve, against
    JAX's non-fused tier on the same padded data and against the port's
    solve of the unpadded data."""
    data = _padded("tt", 2)
    assert not data[1].dimmask[0].all()
    out, _ = _compare("tt", 8, "probe", seed=3, port=FUSED, data=data)
    plain, _ = _compare("tt", 8, "probe", seed=3, port=FUSED)
    np.testing.assert_array_equal(out["status"], plain["status"])
    assert np.all(np.abs(out["dobj"] - plain["dobj"])
                  <= DOBJ_BAR * (1.0 + np.abs(plain["dobj"])))
    assert all((x[:, :, 4:, :4] == 0).all() for x in out["X"])


@pytest.mark.parametrize("name", ["cls", "mkp_s12"])
def test_fused_matches_nonfused_port(name):
    """The port's fused and non-fused directions on the same boxes agree
    in statuses and in dobj to DOBJ_BAR; on CPU tensors no kernel launch
    is counted."""
    prob, _, tdata = problem(name)
    b, lb, ub = node_boxes(prob, 8, seed=2)
    before = [getattr(fused, k).launches for k in FUSED_KERNELS]
    on = torch_solve(tdata, b, lb, ub, refine("probe") | FUSED)
    off = torch_solve(tdata, b, lb, ub, refine("probe") | DF32)
    np.testing.assert_array_equal(on["status"], off["status"])
    assert np.all(np.abs(on["dobj"] - off["dobj"])
                  <= DOBJ_BAR * (1.0 + np.abs(off["dobj"])))
    assert [getattr(fused, k).launches for k in FUSED_KERNELS] == before
