"""The plain float32 direction tiers (phase32="on" and "lite") and the
use_pallas dispatch: the port's ipm_solve against the JAX package's on the
CPU.

JAX runs use_pallas=True as a no-op off the TPU (``_pallas_ok()``); the
port's dispatch sends float32 operands to the kernel wrappers, whose plain
versions run on CPU tensors, so both settings are held against the same JAX
solve.  Per slot the status must agree, the batch's iteration count within
2, and a slot OPTIMAL in both within DOBJ_BAR * (1 + |dobj|), the refine
tier's bar (tests/test_torch_ipm_refine.py says why: float32
factorizations of two LAPACK builds part after a few iterations).

"lite" runs float32 until every gap is below refine_switch (0: never), so
its slots end at the float32 accuracy floor, where a step may stall or
lose definiteness.  On CLS both frameworks then converge slots 0-2 and FAIL
slot 3.  On TT (seed-2 boxes) JAX FAILs 3 of 4 slots ([5, 1, 5, 5]); the
two solves agree to 1e-5 until the floor (iteration 9) and part below it,
and which slot survives follows rounding (the port FAILs all 4).  There
the test holds the iterates above the floor and the shared statuses only.
"""

import numpy as np
import pytest
import torch

from _torch_parity import jax_solve, node_boxes, pinned, problem, torch_solve
from scipsdp_tpu_torch.ops import ipm as tipm
from scipsdp_tpu_torch.ops import kernels
from scipsdp_tpu_torch.utils.status import SolverResultStatus

DOBJ_BAR = 5e-6
ITERS_TOL = 2
OPTIMAL = int(SolverResultStatus.OPTIMAL)
FAILED = int(SolverResultStatus.FAILED)
PALLAS_KERNELS = ("cholesky", "tril_inverse", "schur_wwt")


def settings(step_rule, **kw):
    """The pinned settings of tests/_torch_parity.py with ``kw`` over them."""
    return pinned(step_rule) | kw


def _launches():
    return [getattr(kernels, k).launches for k in PALLAS_KERNELS]


def _compare(name, B, seed, jkw, port=None):
    """Port (JAX's settings, ``port`` over them) against JAX on the same
    boxes: statuses, iterations within ITERS_TOL, dobj of OPTIMAL slots."""
    prob, jdata, tdata = problem(name)
    b, lb, ub = node_boxes(prob, B, seed=seed)
    ref = jax_solve(jdata, b, lb, ub, jkw)
    out = torch_solve(tdata, b, lb, ub, jkw | (port or {}))
    np.testing.assert_array_equal(out["status"], ref["status"])
    assert abs(out["iters"] - int(ref["iters"])) <= ITERS_TOL
    ok = ref["status"] == OPTIMAL
    d, dr = out["dobj"][ok], ref["dobj"][ok]
    assert np.all(np.abs(d - dr) <= DOBJ_BAR * (1.0 + np.abs(dr))), (d, dr)
    return out, ref


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("phase32", ["on", "lite"])
@pytest.mark.parametrize("name", ["cls", "cls_4x8"])
def test_cls_matches_jax(name, phase32, use_pallas):
    """CLS boxes with the eigh rule: every slot OPTIMAL under "on" (as in
    float64, in 8 and 7 iterations); under "lite" slot 3 FAILs in both
    frameworks (10 iterations)."""
    before = _launches()
    out, _ = _compare(name, 4, 2, settings("eigh", phase32=phase32),
                      {"use_pallas": use_pallas})
    want = [OPTIMAL] * 4 if phase32 == "on" else [OPTIMAL] * 3 + [FAILED]
    assert out["status"].tolist() == want
    assert 0 < out["f64_iters"] < out["iters"]
    assert _launches() == before     # CPU tensors: plain versions only


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tt_on_matches_jax(use_pallas):
    out, _ = _compare("tt", 4, 2, settings("eigh", phase32="on"),
                      {"use_pallas": use_pallas})
    assert (out["status"] == OPTIMAL).all()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tt_lite_stalls_in_both(use_pallas):
    """TT under "lite": above the float32 floor (8 iterations, every slot
    still running) the iterates agree with JAX's to 1e-5; to the end every
    slot is OPTIMAL or FAILED in both, JAX FAILs three, and a slot OPTIMAL
    in both has the same bound."""
    prob, jdata, tdata = problem("tt")
    b, lb, ub = node_boxes(prob, 4, seed=2)
    kw = settings("eigh", phase32="lite")
    port = {"use_pallas": use_pallas}
    early = kw | {"max_iters": 8}
    ref = jax_solve(jdata, b, lb, ub, early)
    out = torch_solve(tdata, b, lb, ub, early | port)
    itl = int(SolverResultStatus.ITERLIMIT)
    assert (ref["status"] == itl).all() and (out["status"] == itl).all()
    assert np.abs(out["y"] - ref["y"]).max() <= 1e-5 * (
        1.0 + np.abs(ref["y"]).max())
    ref = jax_solve(jdata, b, lb, ub, kw)
    out = torch_solve(tdata, b, lb, ub, kw | port)
    assert (ref["status"] == FAILED).sum() == 3
    assert np.isin(out["status"], [OPTIMAL, FAILED]).all()
    both = (out["status"] == OPTIMAL) & (ref["status"] == OPTIMAL)
    assert np.all(np.abs(out["dobj"][both] - ref["dobj"][both])
                  <= DOBJ_BAR * (1.0 + np.abs(ref["dobj"][both])))


def test_on_probe_rule_matches_jax():
    """phase32="on" with the card's step rule (probe) at B=8."""
    out, _ = _compare("cls", 8, 1, settings("probe", phase32="on"),
                      {"use_pallas": True})
    assert out["status"][0] == OPTIMAL


@pytest.mark.parametrize("name,B", [("cls", 8), ("cls_32", 4)])
def test_refine_with_pallas_matches_jax(name, B):
    """use_pallas in the refine tier: its X/S factors, Schur Gram and Schur
    factor go through the kernel wrappers (plain versions here)."""
    out, _ = _compare(name, B, 1, settings("probe", phase32="refine"),
                      {"use_pallas": True, "use_df32": "on"})
    assert (out["status"] == OPTIMAL).all()


def test_pallas_dispatch_takes_float32_operands_only(monkeypatch):
    """With use_pallas the kernel wrappers see every float32 factor,
    inverse and Gram of a float32 iteration and no float64 operand; the
    float64 iterations stay on the library."""
    seen = {k: [] for k in PALLAS_KERNELS}
    for k in PALLAS_KERNELS:
        real = getattr(kernels, k)

        def spy(x, _real=real, _k=k):
            seen[_k].append(x.dtype)
            return _real(x)
        monkeypatch.setattr(kernels, k, spy)
    prob, _, tdata = problem("cls")
    b, lb, ub = node_boxes(prob, 4, seed=2)
    out = torch_solve(tdata, b, lb, ub,
                      settings("eigh", phase32="on", use_pallas=True))
    n32 = out["iters"] - out["f64_iters"]
    assert n32 > 0
    # per float32 iteration: the X/S factor and the Schur factor, their
    # two inverses, one Gram
    assert seen["cholesky"] == [torch.float32] * (2 * n32)
    assert seen["tril_inverse"] == [torch.float32] * (2 * n32)
    assert seen["schur_wwt"] == [torch.float32] * n32


def test_nan32_repair_in_the_on_tier(monkeypatch):
    """A float32 NaN injected into one slot's X/S factor in the third
    iteration of phase32="on": that slot skips its update, the next
    iteration runs in float64 (the nan32 repair), the tier resumes, and
    every slot ends as in JAX's uninjected solve."""
    prob, jdata, tdata = problem("cls")
    b, lb, ub = node_boxes(prob, 4, seed=2)
    kw = settings("eigh", phase32="on")
    clean = torch_solve(tdata, b, lb, ub, kw)
    real = tipm.cholesky
    calls = []

    def faulty(A):
        L = real(A)
        if A.dtype == torch.float32 and A.dim() == 4:   # the X/S factors
            calls.append(A.shape)
            if len(calls) == 3:
                L = L.clone()
                L[1] = float("nan")
        return L

    monkeypatch.setattr(tipm, "cholesky", faulty)
    out = torch_solve(tdata, b, lb, ub, kw)
    ref = jax_solve(jdata, b, lb, ub, kw)
    assert len(calls) >= 3 and out["f64_iters"] == clean["f64_iters"] + 1
    np.testing.assert_array_equal(out["status"], ref["status"])
    assert (out["status"] == OPTIMAL).all()
    assert abs(out["iters"] - int(ref["iters"])) <= ITERS_TOL + 1
    assert np.all(np.abs(out["dobj"] - ref["dobj"])
                  <= DOBJ_BAR * (1.0 + np.abs(ref["dobj"])))


def test_on_tier_fails_cls_64_slots_in_both():
    """chip_smoke.py's cls_64/direct request (n = 129, 8 node boxes) under
    phase32="on": JAX's own tier FAILs a slot on the CPU, and so does the
    port's (which slots follows float32 rounding); a slot OPTIMAL in both
    has the same bound.  This is why chip_smoke.py holds a direct request
    to its use_pallas=False twin only where the twin converges every
    slot."""
    import chip_smoke
    from scipsdp_tpu.models import families as jfam
    from scipsdp_tpu.models.problem import densify as jdensify
    from scipsdp_tpu.ops import ipm as jipm
    from _torch_parity import port_data

    label, _, _, req, _ = chip_smoke.make_cases("cpu")[3]
    assert label == "cls_64/direct"
    jdata = jipm.build_ipm_data(jdensify(
        jfam.cardinality_least_squares(64, 128, 12, seed=5)))
    kw = settings("probe", phase32="on", max_iters=100)
    ref = jax_solve(jdata, *req, kw)
    out = torch_solve(port_data(jdata), *req, kw)
    for st in (ref["status"], out["status"]):
        assert np.isin(st, [OPTIMAL, FAILED]).all() and (st == FAILED).any()
    both = (out["status"] == OPTIMAL) & (ref["status"] == OPTIMAL)
    assert both.any()
    assert np.all(np.abs(out["dobj"][both] - ref["dobj"][both])
                  <= DOBJ_BAR * (1.0 + np.abs(ref["dobj"][both])))


@pytest.mark.parametrize("phase32", ["on", "refine"])
def test_float32_iterations_ignore_the_callers_matmul_precision(monkeypatch,
                                                                phase32):
    """A caller who allowed TF32 / reduced float32 matmul precision: every
    float32 iteration still runs at full precision (IEEE float32 for cuBLAS
    and oneDNN inside the Gram), the result equals the solve under the
    defaults bit for bit, and the caller's flags come back as they were
    set."""
    prob, _, tdata = problem("cls")
    b, lb, ub = node_boxes(prob, 4, seed=2)
    kw = settings("probe", phase32=phase32, use_pallas=True)
    base = torch_solve(tdata, b, lb, ub, kw)
    inside = []
    real = kernels.schur_wwt

    def spy(W):
        inside.append((torch.backends.cuda.matmul.fp32_precision,
                       torch.backends.mkldnn.matmul.fp32_precision))
        return real(W)

    monkeypatch.setattr(kernels, "schur_wwt", spy)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        out = torch_solve(tdata, b, lb, ub, kw)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)
    assert inside and set(inside) == {("ieee", "ieee")}
    assert out["iters"] == base["iters"]
    np.testing.assert_array_equal(out["status"], base["status"])
    np.testing.assert_array_equal(out["dobj"], base["dobj"])
