"""scipsdp_tpu_torch.core.sdpi (the SDPI recovery ladder), core.feascheck
and ops.onevar against the JAX package on the CPU.

Each test mirrors a test of the JAX package (tests/test_sdpi.py,
test_conflict.py, test_onevar_cert.py, test_onevar_fastpath.py,
test_lp_host.py) on inline instances: the same problem goes through the
JAX SDPInterface and the port's (``device="cpu"``), with the same settings
(``interop.settings_from_jax``).  The ladders share every decision rule
and the solves differ only in float64 rounding (two LAPACK builds), so
statuses must agree exactly and bounds within 1e-7 * (1 + |bound|); the
bars of the mirrored tests hold as well.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import interfaces, node_boxes, port_dense, problem
from scipsdp_tpu.core import feascheck as jfeas
from scipsdp_tpu.models import problem as jprob
from scipsdp_tpu.ops import onevar as jonevar
from scipsdp_tpu.utils.config import IPMSettings, Settings
from scipsdp_tpu_torch.core import feascheck as tfeas
from scipsdp_tpu_torch.core import sdpi as tsdpi
from scipsdp_tpu_torch.interop import ipm_data_from_numpy, settings_from_jax
from scipsdp_tpu_torch.ops import onevar as tonevar
from scipsdp_tpu_torch.parallel.mesh import make_mesh
from scipsdp_tpu_torch.utils.status import SolverResultStatus as S

INF = jprob.INF
TOL = 1e-4          # tests/test_sdpi.py's bar on the reference values
OBJ_RTOL = 1e-7     # port against JAX, times (1 + |objval|)
MULT_TOL = 1e-6     # bound multipliers, port against JAX


def both(prob, settings=None, **kw):
    """(JAX SDPInterface, the port's on the CPU) for one MISDP."""
    return interfaces(jprob.densify(prob), settings or Settings(), **kw)


# statuses whose objval is a bound (or -inf); an INFEASIBLE or FAILED
# slot keeps the last iterate of a solve that diverged, which is no result
BOUNDED = [int(s) for s in (S.OPTIMAL, S.PRESOLVED_OPTIMAL, S.BOUND_ONLY,
                            S.UNBOUNDED)]


def assert_objvals(t, j, what="", status=None):
    """On the slots whose status holds a bound: equal infinities, finite
    values within OBJ_RTOL * (1 + |j|)."""
    t, j = np.asarray(t), np.asarray(j)
    if status is not None:
        keep = np.isin(status, BOUNDED)
        t, j = t[keep], j[keep]
    fin = np.isfinite(j)
    np.testing.assert_array_equal(t[~fin], j[~fin], err_msg=what)
    assert np.all(np.abs(t[fin] - j[fin]) <= OBJ_RTOL * (1 + np.abs(j[fin]))
                  ), (what, t, j)


def make_lp(obj, lb, ub, rows):
    n = len(obj)
    return jprob.MISDP(nvars=n, obj=np.array(obj, float),
                       lb=np.array(lb, float), ub=np.array(ub, float),
                       integral=np.zeros(n, bool), blocks=[],
                       lp=jprob.LinearConstraints.from_rows(rows), name="lp")


ROWS = [([0, 1], [2, 1], -INF, 10), ([0, 1], [1, 3], -INF, 15)]


def sdp(nvars, obj, lb, ub, block):
    return jprob.MISDP(nvars=nvars, obj=np.array(obj, float),
                       lb=np.array(lb, float), ub=np.array(ub, float),
                       integral=np.zeros(nvars, bool),
                       blocks=[jprob.SDPBlock(**block)],
                       lp=jprob.LinearConstraints.empty(), name="sdp")


ONEVAR_BLOCK = dict(size=2, var=[0, 0], row=[0, 1], col=[0, 1],
                    val=[1.0, 1.0], const_row=[0, 1, 1],
                    const_col=[0, 0, 1], const_val=[1.0, 2.0, 4.0])
OPT, INFEAS, UNB = S.OPTIMAL, S.INFEASIBLE, S.UNBOUNDED
PRE_OPT, PRE_INF = S.PRESOLVED_OPTIMAL, S.PRESOLVED_INFEASIBLE

# tests/test_sdpi.py cases 1-12 (it has no case 8), test_batched_mixed_
# statuses and test_primal_bound_multipliers: (problem, boxes or None for
# the problem's own, per slot the statuses its test allows, per slot the
# reference objval or None)
CONTRACT = {
    "test1_lp_feasible": (make_lp([-3, -1], [0, 0], [INF, INF], ROWS),
                          None, [(OPT,)], [-15.0]),
    "test2_lp_unbounded": (make_lp([-3, -1], [-INF, -INF], [INF, INF],
                                   ROWS), None, [(UNB,)], [None]),
    "test3_lp_infeasible": (make_lp([10, 15], [0, 0], [INF, INF],
                                    [([0, 1], [2, 1], 3, 3),
                                     ([0, 1], [1, 3], 1, 1)]),
                            None, [(INFEAS,)], [None]),
    "test4_lp_both_infeasible": (make_lp([-1, -1], [-INF, -INF], [INF, INF],
                                         [([0, 1], [1, -1], -INF, 0),
                                          ([0, 1], [-1, 1], -INF, -1)]),
                                 None, [(INFEAS,)], [None]),
    "test5_lp_fixed_feasible": (make_lp([-3, -1], [0, 0], [0, 0], ROWS),
                                None, [(PRE_OPT, OPT)], [0.0]),
    "test6_lp_fixed_infeasible": (make_lp([-3, -1], [4, 3], [4, 3], ROWS),
                                  None, [(PRE_INF, INFEAS)], [None]),
    "test7_conflicting_bounds": (make_lp([-3, -1], [4, 3], [2, 3], ROWS),
                                 None, [(PRE_INF, INFEAS)], [None]),
    "test9_sdp_infeasible": (sdp(2, [-1, 0], [-1, -1], [1, 1], dict(
        size=2, var=[0, 1], row=[0, 1], col=[0, 1], val=[1.0, 0.75],
        const_row=[1], const_col=[0], const_val=[-1.0])),
        None, [(INFEAS,)], [None]),
    "test10_sdp_feasible": (sdp(2, [-1, -1], [-1, -1], [1, 1], dict(
        size=2, var=[0, 1], row=[0, 1], col=[0, 1], val=[1.0, 1.0],
        const_row=[], const_col=[], const_val=[])),
        None, [(OPT,)], [-2.0]),
    "test11_sdp_one_var": (sdp(1, [1], [-INF], [INF], ONEVAR_BLOCK),
                           None, [(OPT,)], [5.0]),
    "test12_sdp_fixed_infeasible": (sdp(1, [1], [0], [0], ONEVAR_BLOCK),
                                    None, [(PRE_INF,)], [None]),
    "test_batched_mixed_statuses": (
        make_lp([-3, -1], [0, 0], [INF, INF], ROWS),
        (np.array([[0.0, 0.0], [0.0, 0.0], [4.0, 3.0]]),
         np.array([[INF, INF], [0.0, 0.0], [2.0, 3.0]])),
        [(OPT,), (PRE_OPT, OPT), (PRE_INF, INFEAS)], [-15.0, 0.0, None]),
    "test_primal_bound_multipliers": (
        make_lp([-3, -1], [0, 0], [INF, INF], ROWS), None, [(OPT,)],
        [-15.0]),
}


@pytest.mark.parametrize("case", list(CONTRACT))
def test_contract_cases(case):
    """Statuses equal to JAX's and allowed by the mirrored test; objvals
    within TOL of its reference values and, where the status holds a
    bound, within OBJ_RTOL of JAX's; xlb/xub within MULT_TOL of JAX's."""
    prob, boxes, allowed, ref = CONTRACT[case]
    lb, ub = boxes or (prob.lb[None, :], prob.ub[None, :])
    ji, ti = both(prob)
    j, t = ji.solve_batch(lb, ub), ti.solve_batch(lb, ub)
    np.testing.assert_array_equal(t.status, j.status)
    for s, ok in enumerate(allowed):
        assert int(t.status[s]) in [int(x) for x in ok], (s, t.status)
    for s, r in enumerate(ref):
        if r is not None:
            assert abs(t.objval[s] - r) < TOL
    assert_objvals(t.objval, j.objval, case, j.status)
    np.testing.assert_allclose(t.xlb, j.xlb, rtol=0, atol=MULT_TOL)
    np.testing.assert_allclose(t.xub, j.xub, rtol=0, atol=MULT_TOL)
    assert (t.nsolves, t.npenalty, t.nunsolved, t.ndirect) == (
        j.nsolves, j.npenalty, j.nunsolved, j.ndirect)
    # a direct solve that fails stalls, and the iteration at which stall
    # detection fires depends on float64 rounding (up to 2 iterations, as
    # in test_torch_ipm_solve.py::test_stalled_child_fails_in_both)
    assert abs(t.iters - j.iters) <= (0 if j.nsolves == 1 else 2)
    if case == "test_primal_bound_multipliers":
        np.testing.assert_allclose(t.xlb[0], [0.0, 0.5], atol=1e-3)
        np.testing.assert_allclose(t.xl[0], [1.5, 0.0], atol=1e-3)


def test_weights_carried_across():
    """The port's SDPInterface builds its data from the DenseSDPData
    itself; it equals the JAX interface's data carried across by
    ipm_data_from_numpy, array by array."""
    prob = problem("cls")[0]
    ji, ti = both(prob)
    jd = ji.data
    via = ipm_data_from_numpy(
        [np.asarray(a) for a in jd.A], [np.asarray(c) for c in jd.C],
        [np.asarray(d) for d in jd.dimmask], np.asarray(jd.G),
        np.asarray(jd.h), np.asarray(jd.b_base), jd.nvars, jd.ndim_sdp,
        jd.block_of, device="cpu")
    for f in ("A", "C", "dimmask"):
        for x, y in zip(getattr(ti.data, f), getattr(via, f), strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in ("G", "h", "b_base"):
        assert torch.equal(getattr(ti.data, f), getattr(via, f)), f
    assert (ti.data.nvars, ti.data.ndim_sdp, ti.data.block_of) == (
        via.nvars, via.ndim_sdp, via.block_of)
    assert dataclasses.asdict(ti.settings) == dataclasses.asdict(ji.settings)


def _conflict_prob():
    """tests/test_conflict.py: min y0 s.t. y0 I - I >= 0 (2x2)."""
    return jprob.MISDP(
        nvars=1, obj=np.array([1.0]), lb=np.zeros(1), ub=np.full(1, 2.0),
        integral=np.zeros(1, bool),
        blocks=[jprob.SDPBlock(size=2, var=[0, 0], row=[0, 1], col=[0, 1],
                               val=[1.0, 1.0], const_row=[0, 1],
                               const_col=[0, 1], const_val=[1.0, 1.0])],
        lp=jprob.LinearConstraints.empty(), name="conf")


@pytest.mark.parametrize("hi,status", [(0.5, S.INFEASIBLE),
                                       (2.0, S.OPTIMAL)])
def test_conflict_cuts(hi, status):
    """tests/test_conflict.py's first two cases: the Farkas row of the
    infeasible box [0, 0.5] excludes the box and holds at y0 = 1.5; the
    optimal node's row supports the feasible set.  Rows within 1e-6 of
    JAX's."""
    ji, ti = both(_conflict_prob())
    lb, ub = np.array([[0.0]]), np.array([[hi]])
    j, t = ji.solve_batch(lb, ub), ti.solve_batch(lb, ub)
    assert int(t.status[0]) == int(j.status[0]) == int(status)
    (Gj, lj), (Gt, lt) = ji.conflict_cuts(j), ti.conflict_cuts(t)
    np.testing.assert_allclose(Gt, Gj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-6)
    g, lhs = Gt[0], lt[0]
    if status == S.INFEASIBLE:
        assert np.sum(np.where(g > 0, g * 0.5, 0.0)) < lhs - 1e-6
        assert g[0] * 1.5 >= lhs - 1e-6
    else:
        assert g @ t.y[0] >= lhs - 1e-5
        for yv in (1.0, 1.5, 2.0):
            assert g[0] * yv >= lhs - 1e-5


def _sym(rng, n):
    M = rng.standard_normal((n, n))
    return 0.5 * (M + M.T)


def _cert_cases():
    """tests/test_onevar_cert.py's five cases as (function name, args)."""
    rng = np.random.default_rng(0)
    out = [("lam_min_lanczos", (_sym(rng, n),)) for n in (50, 200, 400)]
    out += [("solve_one_var_sdp", (np.eye(3), np.diag([0.3, 2.0, -1.0]),
                                   1.0, -10.0, 10.0)),
            ("solve_one_var_sdp", (np.zeros((2, 2)), np.eye(2), 1.0, -1.0,
                                   1.0)),
            ("solve_one_var_sdp", (np.eye(2), np.eye(2), -1.0, 0.0, INF))]
    r1 = np.random.default_rng(1)
    Q = np.linalg.qr(r1.standard_normal((220, 220)))[0]
    C = Q @ np.diag(np.linspace(0.1, 3.0, 220)) @ Q.T
    return out + [("solve_one_var_sdp", (np.eye(220), C, 1.0, -100.0,
                                         100.0))]


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5, 6],
                         ids=["lanczos50", "lanczos200", "lanczos400",
                              "boundary", "infeasible", "unbounded",
                              "lanczos_path"])
def test_onevar_copy_matches(k):
    """tests/test_onevar_cert.py's cases through the copied module and the
    JAX package's: the same numpy code gives the same numbers, bit for
    bit, and the mirrored test's bars hold."""
    name, args = _cert_cases()[k]
    kw = {"with_certificate": True} if (name == "solve_one_var_sdp"
                                        and k < 6) else {}
    t = getattr(tonevar, name)(*args, **kw)
    j = getattr(jonevar, name)(*args, **kw)
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_array_equal(a, b)
    if len(t) > 2:
        for a, b in zip(t[2], j[2]):
            np.testing.assert_array_equal(a, b)
    if name == "lam_min_lanczos":
        M = args[0]
        lam_ref = np.linalg.eigvalsh(M)[0]
        assert abs(t[0] - lam_ref) < 1e-8 * max(1.0, abs(lam_ref))
    elif k == 3:
        assert t[0] == "optimal" and abs(t[1] - 2.0) < 1e-6
        assert abs(t[2].lam) < 1e-6 and abs(t[2].supergrad - 1.0) < 1e-6
    elif k == 4:
        assert t[0] == "infeasible" and t[2].lam < -1e-6
    elif k == 5:
        assert t[0] == "unbounded" and t[2].supergrad > 0.5
    else:
        assert t[0] == "optimal" and abs(t[1] - 3.0) < 1e-5


def _onevar_prob(case):
    """tests/test_onevar_fastpath.py's inline instances."""
    if case == "infeasible_certificate":
        # y0 * I(2) - diag(1, -1) >= 0 needs y0 >= 1; the box says <= 0.5
        blk = dict(size=2, var=[0, 0], row=[0, 1], col=[0, 1],
                   val=[1.0, 1.0], const_row=[0, 1], const_col=[0, 1],
                   const_val=[1.0, -1.0])
        return (jprob.MISDP(nvars=2, obj=np.array([1.0, 0.0]),
                            lb=np.zeros(2), ub=np.array([0.5, 1.0]),
                            integral=np.array([False, True]),
                            blocks=[jprob.SDPBlock(**blk)],
                            lp=jprob.LinearConstraints.empty(), name="ovi"),
                np.array([[0.0, 1.0]]), np.array([[0.5, 1.0]]))
    # y0 >= 0 from the block; the row y0 + y1 >= 1.5 with y1 fixed at 1
    blk = dict(size=2, var=[0, 0], row=[0, 1], col=[0, 1], val=[1.0, 1.0],
               const_row=[0], const_col=[0], const_val=[-1.0])
    rows = [(np.array([0, 1]), np.array([1.0, 1.0]), 1.5, np.inf)]
    return (jprob.MISDP(nvars=2, obj=np.array([1.0, 0.0]),
                        lb=np.zeros(2), ub=np.array([10.0, 1.0]),
                        integral=np.array([False, True]),
                        blocks=[jprob.SDPBlock(**blk)],
                        lp=jprob.LinearConstraints.from_rows(rows),
                        name="ovr"),
            np.array([[0.0, 1.0]]), np.array([[10.0, 1.0]]))


@pytest.mark.parametrize("case", ["infeasible_certificate", "row_folding"])
def test_onevar_fastpath(case):
    """test_onevar_infeasible_certificate and test_onevar_row_folding:
    the same decisions, objvals and stat_nonevar as JAX; the infeasible
    node's rank-1 certificate yields a conflict row that excludes the
    box; the folded row puts the optimum at y0 = 0.5."""
    prob, lb, ub = _onevar_prob(case)
    ji, ti = both(prob)
    j, t = ji.solve_batch(lb, ub), ti.solve_batch(lb, ub)
    np.testing.assert_array_equal(t.status, j.status)
    assert_objvals(t.objval, j.objval, case, j.status)
    np.testing.assert_array_equal(t.y, j.y)
    assert ti.stat_nonevar == ji.stat_nonevar >= 1
    if case == "infeasible_certificate":
        assert int(t.status[0]) == int(S.INFEASIBLE)
        g, lhs = ti.conflict_cuts(t)
        np.testing.assert_allclose(g, ji.conflict_cuts(j)[0], atol=1e-12)
        assert np.where(g[0] > 0, g[0] * ub[0], g[0] * lb[0]).sum() \
            < lhs[0] - 1e-6
    else:
        assert int(t.status[0]) == int(S.OPTIMAL)
        assert t.objval[0] == pytest.approx(0.5, abs=1e-6)


def _lp2():
    """tests/test_lp_host.py: min x0 + 2 x1, x0 + x1 >= 1,
    x0 - x1 >= -0.5, 0 <= x <= 2."""
    return make_lp([1.0, 2.0], [0, 0], [2, 2],
                   [([0, 1], [1.0, 1.0], 1.0, INF),
                    ([0, 1], [1.0, -1.0], -0.5, INF)])


def test_lp_host_matches_ipm():
    """lp_host=True solves on HiGHS in both packages: the same results,
    and the same optimum as the port's IPM ladder (the mirrored test's
    bars)."""
    prob = _lp2()
    lb = np.tile(prob.lb, (3, 1))
    ub = np.tile(prob.ub, (3, 1))
    ub[1, 0] = 0.25
    lb[2, 0] = 1.5
    jh, th = both(prob, lp_host=True)
    _, ti = both(prob)
    j, t, ipm = jh.solve_batch(lb, ub), th.solve_batch(lb, ub), \
        ti.solve_batch(lb, ub)
    assert np.all(t.status == int(S.OPTIMAL))
    np.testing.assert_array_equal(t.status, j.status)
    for f in ("objval", "y", "xl", "xlb", "xub"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    np.testing.assert_allclose(t.objval, ipm.objval, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.y, ipm.y, rtol=1e-5, atol=1e-5)


def test_lp_host_infeasible_and_cuts():
    """A conflicting cut row makes the box infeasible, a loose one keeps
    the optimum 1 at x = (1, 0); both as in JAX."""
    jh, th = both(_lp2(), lp_host=True)
    Gc = np.array([[[-1.0, -1.0]]])
    val = np.array([[True]])
    for hc, status in ((0.5, S.INFEASIBLE), (-10.0, S.OPTIMAL)):
        args = (np.zeros((1, 2)), np.full((1, 2), 2.0))
        cuts = (Gc, np.array([[hc]]), val)
        j, t = jh.solve_batch(*args, cuts=cuts), th.solve_batch(*args,
                                                                 cuts=cuts)
        assert int(t.status[0]) == int(j.status[0]) == int(status)
        np.testing.assert_array_equal(t.objval, j.objval)
    assert t.objval[0] == pytest.approx(1.0, abs=1e-6)


def test_check_points():
    """check_points on feasible points (the root's and children's optima)
    and on infeasible ones (those moved out of their box, or to y = 0,
    where the SDP block is not PSD): the same flags as JAX, viol within
    1e-10."""
    prob, jdata, tdata = problem("cls")
    B = 6
    _, lbx, ubx = node_boxes(prob, B, seed=2)
    lb, ub = lbx[:, :-1], ubx[:, :-1]
    ji, _ = both(prob)
    y = ji.solve_batch(lb, ub).y
    y[3] = 0.0
    y[4] = ub[4] + 0.1
    y[5, -1] -= 1.0
    jok, jv = jfeas.check_points(jdata, y, lb, ub, feastol=1e-5)
    tok, tv = tfeas.check_points(tdata, y, lb, ub, feastol=1e-5)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok[:3].all() and not tok[3:].any()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-10)


def test_unported_options_raise(monkeypatch):
    """mixed_precision="on" needs the dtype="float32" solve, which the JAX
    reference cannot run; with no device the interface means the card and
    raises without one (no fall-back to the CPU); with a mesh it lives on
    the mesh's first device (tests/test_torch_parallel.py holds the
    sharded ladder to the unsharded one)."""
    dense = port_dense(jprob.densify(_lp2()))
    with pytest.raises(NotImplementedError):
        tsdpi.SDPInterface(dense, settings_from_jax(Settings(
            ipm=IPMSettings(mixed_precision="on"))), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsdpi.SDPInterface(dense)
    assert tsdpi.SDPInterface(dense, device="cpu").device.type == "cpu"
    iface = tsdpi.SDPInterface(dense, mesh=make_mesh(2, device="cpu"))
    assert iface.device.type == "cpu" and iface.data.device.type == "cpu"
