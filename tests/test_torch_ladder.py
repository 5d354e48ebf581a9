"""The port's recovery ladder decisions, warm starts, pre-optimal
snapshots and rounding heuristics against the JAX package on the CPU.

* Every scripted case of tests/test_penalty_ladder.py runs through both
  ladders: ``_run`` is replaced by the same script of solver outputs (the
  port's ladder takes the port's SolveOutput with numpy fields, as it
  takes its own with tensors), and the ladders must make the same calls
  (Gamma, gaptol, feastol per slot) and return the same statuses, objvals
  and tiers, to 1e-12; two more scripts drive the independent
  verification's feastol-tightened re-solves.
* ``ipm_solve`` with warm starts (``warm_y``/``warm_mask``/``warm_X``/
  ``ip_point``) and with ``preopt_gap`` on the CLS and MkP instances of
  ``_torch_parity``: the same iterations and ``has_pre``, dobj within
  1e-7 * (1 + |dobj|), ``y_pre`` within 1e-6 (the reference's
  test_preopt_warmstart.py reads an instance file that is not in the
  repository, so its checks are rebuilt here).
* ``solve_batch`` with a rounding seed: with the randomized candidate off
  the fractional rounding is deterministic and must equal JAX's; the
  randomized candidate draws from another generator than JAX's, so it is
  held to its invariants instead.
* The whole slice on node boxes of the CLS instance: solve_batch equal to
  JAX's in statuses and bounds, also with warm-started children.
"""

import time

import numpy as np
import pytest
import torch

from _torch_parity import (interfaces, jax_solve, node_boxes, pinned,
                           port_dense, problem, torch_solve)
from scipsdp_tpu.models import problem as jprob
from scipsdp_tpu.models.problem import densify as jdensify
from scipsdp_tpu.ops.ipm import SolveOutput as JaxSolveOutput
from scipsdp_tpu.utils.config import BBSettings, IPMSettings, Settings
from scipsdp_tpu_torch.core import sdpi as tsdpi
from scipsdp_tpu_torch.interop import settings_from_jax
from scipsdp_tpu_torch.ops.ipm import SolveOutput as TorchSolveOutput
from scipsdp_tpu_torch.utils.status import SolverResultStatus as S

F, OPT = int(S.FAILED), int(S.OPTIMAL)
IL, PRE_INF = int(S.ITERLIMIT), int(S.PRESOLVED_INFEASIBLE)
DOBJ_RTOL = 1e-7


class Script:
    """Replaces SDPInterface._run by a script of per-slot outputs
    (status, r, xlb_r, dobj[, y0]) and records the (Gamma, gaptol,
    feastol) vectors of every call: tests/test_penalty_ladder.py's
    ScriptedRuns and ScriptedVectorRuns in one, for either package's
    SolveOutput.  y0 (default 1, feasible) is the point's first
    coordinate; y0 < 0.5 violates the LP row and fails the independent
    verification."""

    def __init__(self, iface, script, out_cls, scalar_X, delay=0.0):
        self.m = iface.m
        self.script = list(script)
        self.calls = []
        self.out_cls = out_cls
        self.scalar_X = scalar_X
        self.delay = delay

    def __call__(self, b, lb, ub, cuts=None, warm_y=None, warm_mask=None,
                 f32=False, gaptol=None, warm_X=None, feastol_vec=None):
        time.sleep(self.delay)
        B = b.shape[0]
        self.calls.append(tuple(None if v is None else np.asarray(v).copy()
                                for v in (b[:, self.m], gaptol,
                                          feastol_vec)))
        rows = self.script.pop(0)
        rows = rows if isinstance(rows, list) else [rows] * B
        mp = self.m + 1
        status = np.array([r[0] for r in rows], np.int32)
        r = np.array([r[1] for r in rows], float)
        y = np.zeros((B, mp))
        y[:, 0] = [r_[4] if len(r_) > 4 else 1.0 for r_ in rows]
        y[:, self.m] = r
        xlb = np.zeros((B, mp))
        xlb[:, self.m] = [r[2] for r in rows]
        kw = dict(status=status, dobj=np.array([r[3] for r in rows], float),
                  y=y, r=r, gap=np.zeros(B), pinf=np.zeros(B),
                  dinf=np.zeros(B), iters=np.asarray(0),
                  X=(tuple(np.zeros((B, 1, 1, 1))) if self.scalar_X
                     else (np.zeros((B, 1, 1, 1)),)),
                  xl=np.zeros((B, 1)), xlb=xlb, xub=np.zeros((B, mp)))
        if self.out_cls is TorchSolveOutput:
            kw["f64_iters"] = 0
        return self.out_cls(**kw)


def _tiny():
    return jdensify(jprob.MISDP(
        nvars=1, obj=np.array([1.0]), lb=np.array([0.0]),
        ub=np.array([2.0]), integral=np.zeros(1, bool), blocks=[],
        lp=jprob.LinearConstraints.from_rows([([0], [1.0], 0.5,
                                               jprob.INF)]),
        name="tiny"))


FACT = (1000.0 / 10.0) ** 0.5   # npenaltyincr = 2
BIG = 1.0                       # xlb_r large: penalty bound not active
# tests/test_penalty_ladder.py's scripted cases: (per-call outputs — one
# (status, r, xlb_r, dobj) for every slot, or a list per slot —, B, solve
# kwargs, delay of each scripted call in seconds)
CASES = {
    "penaltybound_active_raises_gamma": (
        [(F, 0, 0, 0), (OPT, 0, 0, 0), (OPT, 1, 0, 5), (OPT, 1, 0, 6),
         (OPT, 1, 0, 7), (F, 0, 0, 0)], 1, {}, 0.0),
    "penaltybound_slack_tightens_gaptol": (
        [(F, 0, 0, 0), (OPT, 0, 0, 0), (OPT, 1, BIG, 5), (OPT, 1, BIG, 5),
         (OPT, 1, BIG, 5), (F, 0, 0, 0)], 1, {}, 0.0),
    "feasorig_accepts_with_gamma_correction": (
        [(F, 0, 0, 0), (OPT, 0, 0, 0), (OPT, 1e-7, 1, 5)], 1, {}, 0.0),
    "unacceptable_rescue_raises_gamma": (
        [(F, 0, 0, 0), (OPT, 0, 0, 0), (F, 0, 0, 0), (OPT, 1e-8, 0, 4)],
        1, {}, 0.0),
    "time_limit_yields_timelimit_status": (
        [(F, 0, 0, 0)] * 8, 1, {"time_limit": 0.01}, 0.05),
    "iterlimit_status_surfaces": (
        [(IL, 0, 0, 0), (OPT, 0, 0, 0), (OPT, 1e-8, 0, 4)], 1, {}, 0.0),
    "tier_inheritance_starts_ladder_high": (
        [(F, 0, 0, 0), (OPT, 0, 0, 0), (OPT, 1e-9, 0, 5)], 1,
        {"tier": np.array([[10.0 * FACT, np.nan]])}, 0.0),
    "no_tier_recorded_for_direct_solves": ([(OPT, 0, 0, 3)], 1, {}, 0.0),
    "speculative_parallel_ladder_one_dispatch": (
        [[(F, 0, 0, 0)] + [(PRE_INF, 0, 0, 0)] * 3, (OPT, 0, 0, 0),
         [(F, 0, 0, 0)] * 3 + [(OPT, 1e-9, 0, 5)]], 4, {}, 0.0),
    "speculative_exhausted_records_top_tier": (
        [[(F, 0, 0, 0)] + [(PRE_INF, 0, 0, 0)] * 3, (OPT, 0, 0, 0),
         (F, 0, 0, 0)], 4, {}, 0.0),
    # the independent verification (not scripted in test_penalty_ladder.
    # py): a converged point that violates the LP row is re-solved with
    # feastol tightened 10x, until a re-solve verifies or feastol passes
    # 1e-9
    "verification_resolve_accepts": (
        [(OPT, 0, 0, 3, 0.0), (OPT, 0, 0, 3, 1.0)], 1, {}, 0.0),
    "verification_exhausted_fails": (
        [(OPT, 0, 0, 3, 0.0)] * 8, 1, {}, 0.0),
}
EXPECT = {   # the mirrored test's status of slot 0, and its call count
    #          where it asserts one
    "penaltybound_active_raises_gamma": (int(S.BOUND_ONLY), None),
    "penaltybound_slack_tightens_gaptol": (int(S.BOUND_ONLY), None),
    "feasorig_accepts_with_gamma_correction": (OPT, None),
    "unacceptable_rescue_raises_gamma": (OPT, None),
    "time_limit_yields_timelimit_status": (int(S.TIMELIMIT), 1),
    "iterlimit_status_surfaces": (OPT, 3),
    "tier_inheritance_starts_ladder_high": (OPT, None),
    "no_tier_recorded_for_direct_solves": (OPT, None),
    "speculative_parallel_ladder_one_dispatch": (OPT, 3),
    "speculative_exhausted_records_top_tier": (int(S.BOUND_ONLY), None),
    "verification_resolve_accepts": (OPT, 2),
    "verification_exhausted_fails": (F, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scripted_ladder_decisions(case):
    """Both ladders on the same script: the same calls (Gamma, gaptol and
    feastol of every slot), statuses, objvals, tiers and counters, to
    1e-12; slot 0 ends as the mirrored test says."""
    script, B, kw, delay = CASES[case]
    s = Settings(ipm=IPMSettings(penaltyparam=10.0, maxpenaltyparam=1000.0,
                                 npenaltyincr=2, onevar=False))
    ji, ti = interfaces(_tiny(), s)
    res, calls = [], []
    for iface, cls in ((ji, JaxSolveOutput), (ti, TorchSolveOutput)):
        run = Script(iface, script, cls, scalar_X=B == 1, delay=delay)
        iface._run = run
        res.append(iface.solve_batch(np.zeros((B, 1)), np.full((B, 1), 2.0),
                                     **kw))
        calls.append(run.calls)
    j, t = res
    assert len(calls[0]) == len(calls[1])
    assert EXPECT[case][1] in (None, len(calls[0]))
    for cj, ct in zip(*calls):
        for vj, vt in zip(cj, ct):
            if vj is None:
                assert vt is None
            else:
                np.testing.assert_allclose(vt, vj, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(t.status, j.status)
    assert int(t.status[0]) == EXPECT[case][0]
    np.testing.assert_allclose(t.objval, j.objval, rtol=1e-12, atol=0)
    np.testing.assert_allclose(t.tier, j.tier, rtol=1e-12, atol=0)
    assert (t.nsolves, t.npenalty, t.nunsolved, t.ndirect) == (
        j.nsolves, j.npenalty, j.nunsolved, j.ndirect)
    assert ti.stat_nveri_resolve == ji.stat_nveri_resolve
    if case.startswith("verification"):
        assert ti.stat_nveri_resolve == len(calls[1]) - 1
        np.testing.assert_allclose(calls[1][-1][2], 1e-5 * 0.1 ** (
            len(calls[1]) - 1), rtol=1e-12)


def _warm_inputs(name, B):
    """Child boxes of ``name`` and warm-start inputs from the root's
    solve: the root's y and X for every child, every other child masked,
    and the root's point as the analytic-centre target."""
    prob, jdata, tdata = problem(name)
    kw = pinned("eigh")
    b, lb, ub = node_boxes(prob, B, seed=4)
    root = jax_solve(jdata, b[:1], lb[:1], ub[:1], kw)
    wy = np.tile(root["y"], (B, 1))
    wX = tuple(np.tile(x, (B, 1, 1, 1)) for x in root["X"])
    ip = (root["y"][0].copy(), tuple(x[0].copy() for x in root["X"]))
    return jdata, tdata, kw, (b, lb, ub), wy, wX, ip


WARM_CASES = ["warm_y", "warm_y_mask", "warm_y_X", "warm_ip_point",
              "preopt", "warm_preopt"]


@pytest.mark.parametrize("name", ["cls", "mkp_s12"])
@pytest.mark.parametrize("case", WARM_CASES)
def test_warm_start_and_preopt(name, case):
    """ipm_solve with warm starts and pre-optimal snapshots: the same
    statuses, iterations (within 2 where a slot stalls) and has_pre as
    JAX, dobj within
    1e-7 * (1 + |dobj|), y_pre within 1e-6 and X_pre within
    1e-6 * (1 + max |X_pre|) (both with the eigh rule)."""
    B = 6
    jdata, tdata, kw, req, wy, wX, ip = _warm_inputs(name, B)
    extra = {}
    if case.startswith("warm"):
        extra["warm_y"] = wy
    if case == "warm_y_mask":
        extra["warm_mask"] = np.arange(B) % 2 == 0
    if case in ("warm_y_X", "warm_ip_point"):
        extra["warm_X"] = wX
    if case == "warm_ip_point":
        extra["ip_point"] = ip
    if case.endswith("preopt"):
        kw = kw | {"preopt_gap": 1e-2}
    ref = jax_solve(jdata, *req, kw, **extra)
    out = torch_solve(tdata, *req, kw, **extra)
    np.testing.assert_array_equal(out["status"], ref["status"])
    # a slot that stalls FAILs in both, at an iteration that depends on
    # float64 rounding (test_torch_ipm_solve.py::
    # test_stalled_child_fails_in_both): the cold-started slot 3 of the
    # MkP boxes does
    assert abs(out["iters"] - int(ref["iters"])) <= (
        2 if (ref["status"] == F).any() else 0)
    ok = ref["status"] == OPT
    assert np.all(np.abs(out["dobj"][ok] - ref["dobj"][ok])
                  <= DOBJ_RTOL * (1 + np.abs(ref["dobj"][ok])))
    if case.endswith("preopt"):
        np.testing.assert_array_equal(out["has_pre"], ref["has_pre"])
        assert out["has_pre"].any()
        np.testing.assert_allclose(out["y_pre"], ref["y_pre"], rtol=0,
                                   atol=1e-6)
        for xo, xr in zip(out["X_pre"], ref["X_pre"]):
            np.testing.assert_allclose(xo.numpy(), xr, rtol=0, atol=1e-6
                                       * (1 + np.abs(xr).max()))
        # an earlier iterate than the optimum
        assert np.abs(out["y_pre"] - out["y"]).max() > 1e-8
    else:
        assert out["y_pre"] is None and ref["y_pre"] is None


def rounding_boxes(prob, B, seed):
    """B node boxes of the CLS instance: node_boxes' in the odd slots, and
    in the even ones every binary z fixed, k of them to 1 (the relaxation's
    point is then integral, so its rounding is feasible; at a fractional
    point rounding z breaks the big-M rows |x_j| <= M z_j)."""
    _, lbx, ubx = node_boxes(prob, B, seed=seed)
    lb, ub = lbx[:, :-1], ubx[:, :-1]
    rng = np.random.default_rng(seed)
    zs = np.flatnonzero(prob.integral)
    k = int(prob.lp.rhs[-1])       # the cardinality row sum z <= k
    for s in range(0, B, 2):
        on = np.isin(zs, rng.choice(zs, size=k, replace=False))
        lb[s, zs] = ub[s, zs] = on.astype(float)
    return lb, ub


@pytest.fixture(scope="module")
def cls_ifaces():
    """(JAX, port) interfaces on the CLS instance, rounding on the
    fractional candidate only, and 8 boxes of rounding_boxes."""
    prob = problem("cls")[0]
    s = Settings(bb=BBSettings(heuristic_rand=False))
    return interfaces(jdensify(prob), s), rounding_boxes(prob, 8, seed=6)


def test_slice_solve_batch(cls_ifaces):
    """solve_batch on CLS node boxes, cold and warm-started from the
    cold solve's y and X, and the pre-optimal snapshot of the
    warmstartpreoptsol rewrite: the same statuses, bounds and counters as
    JAX."""
    (ji, ti), (lb, ub) = cls_ifaces
    j, t = ji.solve_batch(lb, ub), ti.solve_batch(lb, ub)
    np.testing.assert_array_equal(t.status, j.status)
    assert (t.status == OPT).all()
    assert np.all(np.abs(t.objval - j.objval) <= DOBJ_RTOL
                  * (1 + np.abs(j.objval)))
    assert (t.iters, t.nsolves) == (j.iters, j.nsolves)
    warm = (t.y, np.ones(len(lb), bool), t.X)
    jw = ji.solve_batch(lb, ub, warm=(j.y, warm[1], j.X))
    tw = ti.solve_batch(lb, ub, warm=warm)
    np.testing.assert_array_equal(tw.status, jw.status)
    assert tw.iters == jw.iters
    assert np.all(np.abs(tw.objval - t.objval) <= 2e-5
                  * (1 + np.abs(t.objval)))
    prob = problem("cls")[0]
    s = Settings(bb=BBSettings(warmstart=True, warmstartpreoptsol=True))
    jp, tp = interfaces(jdensify(prob), s)
    assert tp.settings.ipm.preopt_gap == jp.settings.ipm.preopt_gap == 1e-2
    j, t = jp.solve_batch(lb, ub), tp.solve_batch(lb, ub)
    np.testing.assert_array_equal(t.pre_has, j.pre_has)
    np.testing.assert_allclose(t.pre_y, j.pre_y, rtol=0, atol=1e-6)


def test_fractional_rounding_matches_jax(cls_ifaces):
    """heuristic_rand=False: the fractional candidate alone, so the
    rounded points, their flags and values equal JAX's (the integral
    coordinates exactly; the continuous ones, clipped solution values,
    within 1e-7)."""
    (ji, ti), (lb, ub) = cls_ifaces
    j = ji.solve_batch(lb, ub, rounding_seed=3)
    t = ti.solve_batch(lb, ub, rounding_seed=3)
    integral = ti.dense.integral
    np.testing.assert_array_equal(t.round_feas, j.round_feas)
    assert t.round_feas.any() and not t.round_feas.all()
    np.testing.assert_array_equal(t.round_y[:, integral],
                                  j.round_y[:, integral])
    np.testing.assert_allclose(t.round_y, j.round_y, rtol=0, atol=1e-7)
    np.testing.assert_allclose(t.round_val, j.round_val, rtol=1e-7, atol=0)
    np.testing.assert_array_equal(t.status, j.status)


def _numpy_feasible(dense, y, lb, ub, feastol):
    """(feasible, margin): an independent float64 numpy check of rounded
    points — box, integrality, LP rows and lambda_min(Z(y)) >= -feastol —
    and the distance of lambda_min from that edge."""
    feas, margin = [], []
    for yi, lo, hi in zip(y, lb, ub):
        lam = min(np.linalg.eigvalsh(np.einsum("jab,j->ab", dense.A[k], yi)
                                     - dense.C[k])[0]
                  for k in range(dense.nblocks))
        ok = (lam >= -feastol and np.all(yi >= lo) and np.all(yi <= hi)
              and np.all(dense.G @ yi >= dense.h - feastol)
              and np.all(np.abs(yi - np.round(yi))[dense.integral]
                         <= feastol))
        feas.append(ok)
        margin.append(abs(lam + feastol))
    return np.array(feas), np.array(margin)


def test_random_rounding_invariants():
    """The randomized candidate alone (fractional rounding off): every
    integral coordinate is floor(y) or floor(y) + 1 of the relaxation's
    y, the same seed gives the same bits on two calls, and round_feas
    agrees with an independent numpy check wherever lambda_min is not
    within 1e-6 of the -feastol edge (a float32 Cholesky cannot decide
    there)."""
    prob, jdata, _ = problem("cls")
    s = settings_from_jax(Settings(bb=BBSettings(heuristic_fracround=False)))
    ti = tsdpi.SDPInterface(port_dense(jdensify(prob)), s, device="cpu")
    lb, ub = rounding_boxes(prob, 16, seed=8)
    a = ti.solve_batch(lb, ub, rounding_seed=11)
    b = ti.solve_batch(lb, ub, rounding_seed=11)
    assert np.array_equal(a.round_y, b.round_y)
    np.testing.assert_array_equal(a.round_feas, b.round_feas)
    integral = ti.dense.integral
    fl = np.floor(a.y[:, integral])
    r = a.round_y[:, integral]
    assert np.all((r == fl) | (r == fl + 1))
    feas, margin = _numpy_feasible(ti.dense, a.round_y, lb, ub,
                                   s.bb.feastol)
    clear = margin > 1e-6
    np.testing.assert_array_equal(a.round_feas[clear], feas[clear])
    assert clear.sum() >= 12
    assert a.round_feas.any() and not a.round_feas.all()
    vals = a.round_y @ prob.obj
    np.testing.assert_allclose(a.round_val[a.round_feas],
                               vals[a.round_feas], rtol=1e-12)


def test_psd_probe_clear_points():
    """The rounding check's float32 Cholesky probe on points that are
    clearly PSD (the root optimum with the epigraph variable t raised by 1)
    or clearly not (y = 0, and the optimum with t lowered by 10), against
    lambda_min in float64."""
    prob, _, tdata = problem("cls")
    ti = tsdpi.SDPInterface(port_dense(jdensify(prob)), device="cpu")
    y = ti.solve_batch(prob.lb[None], prob.ub[None]).y[0]
    t_idx = int(np.flatnonzero(prob.obj)[0])   # the epigraph variable t
    pts = np.stack([y, np.zeros_like(y), y])
    pts[0, t_idx] += 1.0
    pts[2, t_idx] -= 10.0
    yx = torch.as_tensor(np.concatenate([pts, np.zeros((3, 1))], 1))
    got = tsdpi.psd_probe(tdata, yx, 1e-5).numpy()
    lam = np.array([np.linalg.eigvalsh(np.einsum(
        "jab,j->ab", ti.dense.A[0], p) - ti.dense.C[0])[0] for p in pts])
    assert np.all(np.abs(lam + 1e-5) > 1e-3), lam
    np.testing.assert_array_equal(got, lam >= -1e-5)
    assert got.tolist() == [True, False, False]
