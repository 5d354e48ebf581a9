"""The port's probing module (``core/probing.py``) against the JAX
package's on the CPU.

Each function gets the same numpy inputs in both packages, through a JAX
``SDPInterface`` and the port's (``device="cpu"``) built from one dense
problem with the IPM settings pinned (``_torch_parity.interfaces``):
status and flag arrays equal; points, objectives and bounds within the
JAX package's own tests' bars (1e-4 on objectives, 1e-6 on tightened
bounds, 1e-3 on the inner-LP point).  tests/test_probing.py's four tests
that read an instance file not in the repository (``test_slater_check``,
``test_analytic_center``, ``test_obbt_root``, ``test_fracdive``) and its
warmstart-plus-diving regression are rebuilt on generated instances, its
inner-LP and rounding-problem instances are taken as they are, and
tests/test_slater_stats.py's two checks run on a generated CLS.
"""

import dataclasses

import numpy as np
import pytest

from _torch_bbcases import conflict_prob, torch_one_thread  # noqa: F401
from _torch_parity import interfaces
from scipsdp_tpu.core import probing as jprobing
from scipsdp_tpu.core.branchbound import solve_misdp as jax_solve_misdp
from scipsdp_tpu.core.feascheck import check_points as jax_check_points
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models.problem import (INF, LinearConstraints, MISDP,
                                        SDPBlock, densify)
from scipsdp_tpu.utils.config import BBSettings, IPMSettings, Settings
from scipsdp_tpu.utils.status import SolverResultStatus
from scipsdp_tpu_torch.core import branchbound as tbb
from scipsdp_tpu_torch.core import probing as tprobing
from scipsdp_tpu_torch.core.feascheck import check_points
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax

pytestmark = pytest.mark.usefixtures("torch_one_thread")

IPM = IPMSettings(phase32="off", step_rule="eigh", use_lanes_chol=False,
                  use_df32="off", fused_direction="off")
SETTINGS = Settings(ipm=IPM)
OBJ_TOL = 1e-4      # objectives and points (test_probing.py's bar)
BOUND_TOL = 1e-6    # tightened bounds
INNER_TOL = 1e-3    # the inner-LP point


def cls():
    return jfam.cardinality_least_squares(5, 8, 2)


def truss():
    return jfam.truss_topology(4, 1)


def mkp():
    return jfam.min_k_partition(5, 2)


BUILD = {"cls": cls, "truss": truss, "mkp": mkp, "conflict": conflict_prob}


def node_boxes(prob, B, seed=0):
    """(lb, ub) of B boxes: the root, then children that fix 1-2 integral
    variables at a bound."""
    rng = np.random.default_rng(seed)
    lb = np.tile(prob.lb, (B, 1))
    ub = np.tile(prob.ub, (B, 1))
    ints = np.flatnonzero(prob.integral)
    for s in range(1, B):
        for j in rng.choice(ints, size=min(len(ints), int(rng.integers(1, 3))),
                            replace=False):
            if rng.random() < 0.5:
                ub[s, j] = lb[s, j]
            else:
                lb[s, j] = ub[s, j]
    return lb, ub


def numpy_feasible(prob, y, lb, ub, tol):
    """Independent check: every block's Z(y) PSD to tol, LP rows, the box
    and integrality."""
    for blk in prob.blocks:
        Z = np.einsum("j,jab->ab", y, blk.dense_coeff(prob.nvars)) \
            - blk.dense_const()
        if np.linalg.eigvalsh(Z)[0] < -tol:
            return False
    act = prob.lp.dense(prob.nvars) @ y
    if np.any(act < prob.lp.lhs - tol) or np.any(act > prob.lp.rhs + tol):
        return False
    ints = y[prob.integral]
    return bool(np.all(y >= lb - tol) and np.all(y <= ub + tol)
                and np.all(np.abs(ints - np.round(ints)) <= tol))


@pytest.mark.parametrize("name", ["cls", "truss", "mkp"])
def test_slater_check(name):
    """Dual Slater flags of the root and child boxes equal; the truss
    relaxation has a strict interior."""
    prob = BUILD[name]()
    ji, ti = interfaces(densify(prob), SETTINGS)
    lb, ub = node_boxes(prob, 6)
    sj = jprobing.slater_check(ji, lb, ub)
    st = tprobing.slater_check(ti, lb, ub)
    np.testing.assert_array_equal(st, sj)
    assert st.dtype == sj.dtype
    if name == "truss":
        assert st[0] == 1


@pytest.mark.parametrize("name", ["cls", "truss"])
def test_analytic_center(name):
    """The zero-objective solve: ok flags equal, the centers and their
    primal matrices within 1e-4, every ok center feasible by the port's
    check_points and by JAX's."""
    prob = BUILD[name]()
    ji, ti = interfaces(densify(prob), SETTINGS)
    lb, ub = node_boxes(prob, 4)
    yj, okj, Xj = jprobing.analytic_center(ji, lb, ub, with_X=True)
    yt, okt, Xt = tprobing.analytic_center(ti, lb, ub, with_X=True)
    np.testing.assert_array_equal(okt, okj)
    assert okt[0]
    np.testing.assert_allclose(yt[okt], yj[okj], atol=OBJ_TOL,
                               rtol=OBJ_TOL)
    assert len(Xt) == len(Xj)
    for xt, xj in zip(Xt, Xj):
        np.testing.assert_allclose(xt, np.asarray(xj), atol=OBJ_TOL)
    feas, _ = check_points(ti.data, yt, lb, ub)
    jfeas, _ = jax_check_points(ji.data, yt, lb, ub)
    assert np.all(feas.numpy()[okt]) and np.all(np.asarray(jfeas)[okt])


@pytest.mark.parametrize("name,targets,cutoff", [
    ("conflict", "int", None), ("cls", "cont", 0.0754)])
def test_obbt_root(name, targets, cutoff):
    """OBBT over the root box (and an objective cutoff row): the same
    number of tightenings, bounds within 1e-6, never outside the box, and
    the tightened problem keeps the optimum."""
    prob = BUILD[name]()
    ji, ti = interfaces(densify(prob), SETTINGS)
    tg = np.flatnonzero(prob.integral if targets == "int"
                        else ~prob.integral)
    lj, uj, nj = jprobing.obbt_root(ji, prob.lb.copy(), prob.ub.copy(), tg,
                                    cutoff, 8, 1e-5)
    lt, ut, nt = tprobing.obbt_root(ti, prob.lb.copy(), prob.ub.copy(), tg,
                                    cutoff, 8, 1e-5)
    assert nt == nj > 0
    fin = np.isfinite(lj) & (np.abs(lj) < INF / 2)
    np.testing.assert_allclose(lt[fin], lj[fin], atol=BOUND_TOL)
    fin = np.isfinite(uj) & (np.abs(uj) < INF / 2)
    np.testing.assert_allclose(ut[fin], uj[fin], atol=BOUND_TOL)
    assert np.all(lt >= prob.lb - 1e-9) and np.all(ut <= prob.ub + 1e-9)
    s = settings_from_jax(Settings(ipm=IPM, bb=BBSettings(turbo="off")))
    full = tbb.solve_misdp(problem_from_jax(prob), s, device="cpu")
    tight = tbb.solve_misdp(problem_from_jax(dataclasses.replace(
        prob, lb=lt, ub=ut)), s, device="cpu")
    assert tight.status == full.status
    assert abs(tight.objval - full.objval) <= OBJ_TOL * max(
        1.0, abs(full.objval))


@pytest.mark.parametrize("name", ["cls", "mkp"])
def test_fracdive(name):
    """One batched dive from the root and child relaxations: the same
    feasibility flags, the dived points within 1e-4, and every point
    reported feasible passes the independent numpy check."""
    prob = BUILD[name]()
    ji, ti = interfaces(densify(prob), SETTINGS)
    lb, ub = node_boxes(prob, 4, seed=1)
    res = ji.solve_batch(lb, ub)
    ok = res.status == int(SolverResultStatus.OPTIMAL)
    yj, fj = jprobing.fracdive(ji, lb, ub, res.y, prob.integral, 1e-5,
                               start_ok=ok)
    yt, ft = tprobing.fracdive(ti, lb, ub, res.y, prob.integral, 1e-5,
                               start_ok=ok)
    np.testing.assert_array_equal(ft, fj)
    assert ft.any()
    np.testing.assert_allclose(yt[ft], yj[fj], atol=OBJ_TOL, rtol=OBJ_TOL)
    for i in np.flatnonzero(ft):
        assert numpy_feasible(prob, yt[i], lb[i], ub[i], 1e-5)


def dd_prob():
    """test_probing.py::test_inner_lp_point's problem: Z = y1*I + y2*E12,
    y1 in [0, 4], y2 in [0, 1]; the optimum (4, 1) is diagonally
    dominant."""
    blk = SDPBlock(size=2, var=[0, 0, 1], row=[0, 1, 1], col=[0, 1, 0],
                   val=[1.0, 1.0, 1.0], const_row=[], const_col=[],
                   const_val=[])
    return MISDP(nvars=2, obj=np.array([-1.0, -1.0]),
                 lb=np.zeros(2), ub=np.array([4.0, 1.0]),
                 integral=np.zeros(2, bool), blocks=[blk],
                 lp=LinearConstraints.empty(), name="ddtest")


@pytest.mark.parametrize("name", ["dd", "cls"])
def test_inner_lp_point(name):
    """The diagonally dominant inner LP through the block-free IPM: the
    same outcome, the points within 1e-3, and a feasible point is
    SDP-feasible; the dd instance's optimum (4, 1)."""
    prob = dd_prob() if name == "dd" else cls()
    yj, okj = jprobing.inner_lp_point(prob, SETTINGS)
    yt, okt = tprobing.inner_lp_point(problem_from_jax(prob),
                                      settings_from_jax(SETTINGS),
                                      device="cpu")
    assert okt == okj
    if not okt:
        return
    np.testing.assert_allclose(yt, yj, atol=INNER_TOL)
    if name == "dd":
        np.testing.assert_allclose(yt, [4.0, 1.0], atol=INNER_TOL)
    _, ti = interfaces(densify(prob), SETTINGS)
    feas, _ = check_points(ti.data, yt[None], prob.lb[None], prob.ub[None])
    assert bool(feas[0])


def rp_prob():
    """test_probing.py::test_rounding_problem_warmstart_and_cutoff's
    problem: min y, y*I - I >= 0, y in [0, 3]."""
    blk = SDPBlock(size=2, var=[0, 0], row=[0, 1], col=[0, 1],
                   val=[1.0, 1.0],
                   const_row=[0, 1], const_col=[0, 1], const_val=[1.0, 1.0])
    return MISDP(nvars=1, obj=np.array([1.0]), lb=np.zeros(1),
                 ub=np.full(1, 3.0), integral=np.zeros(1, bool),
                 blocks=[blk], lp=LinearConstraints.empty(), name="rp")


@pytest.mark.parametrize("name,cutoff", [("rp", 10.0), ("rp", 0.5),
                                         ("cls", INF), ("cls", 0.05)])
def test_rounding_problem(name, cutoff):
    """warmstartproject = 4's two rounding LPs from the parent's solution:
    the same action and warm start point within 1e-3 (rp: "ok" at y = 1
    under cutoff 10, "cutoff" under 0.5)."""
    prob = rp_prob() if name == "rp" else cls()
    dense = densify(prob)
    ji, ti = interfaces(dense, SETTINGS)
    res = ji.solve_batch(prob.lb[None], prob.ub[None])
    assert res.status[0] == int(SolverResultStatus.OPTIMAL)
    parent_X = [np.asarray(res.X[t][0, slot])
                for (t, slot) in ji.data.block_of]
    aj, wj = jprobing.rounding_problem(prob, dense, SETTINGS, parent_X,
                                       res.y[0], prob.lb, prob.ub,
                                       cutoff=cutoff)
    at, wt = tprobing.rounding_problem(
        problem_from_jax(prob), ti.dense, settings_from_jax(SETTINGS),
        parent_X, res.y[0], prob.lb, prob.ub, cutoff=cutoff, device="cpu")
    assert at == aj
    if wj is None:
        assert wt is None
    else:
        np.testing.assert_allclose(wt, wj, atol=INNER_TOL)
    if name == "rp":
        assert at == ("ok" if cutoff > 1.0 else "cutoff")
        if at == "ok":
            assert abs(wt[0] - 1.0) < INNER_TOL


def nps_prob():
    """test_probing.py::test_slater_check_primal's failing case: a
    feasible primal X must have X_00 = 0."""
    blk = SDPBlock(size=2, var=[0], row=[0], col=[0], val=[1.0],
                   const_row=[], const_col=[], const_val=[])
    return MISDP(nvars=1, obj=np.zeros(1), lb=np.full(1, -INF),
                 ub=np.full(1, INF), integral=np.zeros(1, bool),
                 blocks=[blk], lp=LinearConstraints.empty(), name="nps")


@pytest.mark.parametrize("name,want", [("truss", 1), ("nps", 0),
                                       ("cls", None)])
def test_slater_check_primal(name, want):
    prob = nps_prob() if name == "nps" else BUILD[name]()
    fj = jprobing.slater_check_primal(prob, SETTINGS, prob.lb, prob.ub)
    ft = tprobing.slater_check_primal(problem_from_jax(prob),
                                      settings_from_jax(SETTINGS), prob.lb,
                                      prob.ub, device="cpu")
    assert ft == fj
    if want is not None:
        assert ft == want


def bb_settings(**bb):
    bb = {"turbo": "off", "heuristic_rand": False, "node_limit": 200,
          "batch_size": 16, **bb}
    return Settings(ipm=IPM, bb=BBSettings(**bb))


def test_warmstart_diving_interaction_regression():
    """warmstart + diving once accepted an infeasible incumbent in the JAX
    package: dives verify their points.  Both packages reach the same
    optimum and tree, and the incumbent is feasible."""
    prob = cls()
    s = bb_settings(warmstart=True, diving_freq=2)
    rj = jax_solve_misdp(prob, s)
    rt = tbb.solve_misdp(problem_from_jax(prob), settings_from_jax(s),
                         device="cpu")
    assert rt.status.name == rj.status.name == "OPTIMAL"
    assert abs(rt.objval - rj.objval) <= OBJ_TOL * max(1.0, abs(rj.objval))
    assert rt.stats.nodes == rj.stats.nodes
    assert rt.stats.heur_found == rj.stats.heur_found
    assert numpy_feasible(prob, rt.best_y, prob.lb, prob.ub, 1e-5)


def test_slatercheck_counts_every_node():
    """tests/test_slater_stats.py's first check: every node is counted
    once on the dual side and once on the primal side."""
    res = tbb.solve_misdp(problem_from_jax(cls()),
                          settings_from_jax(bb_settings(slatercheck=1,
                                                        batch_size=4)),
                          device="cpu")
    assert res.status.name == "OPTIMAL"
    s = res.stats
    assert s.slater_holds + s.slater_fails + s.slater_undecided \
        == s.nodes > 0
    assert (s.slater_primal_holds + s.slater_primal_fails
            + s.slater_primal_undecided) == s.nodes


def test_slatercheck_off_keeps_counters_zero():
    res = tbb.solve_misdp(problem_from_jax(cls()),
                          settings_from_jax(bb_settings(batch_size=4)),
                          device="cpu")
    s = res.stats
    assert res.status.name == "OPTIMAL" and s.nodes > 0
    assert s.slater_holds + s.slater_fails + s.slater_undecided == 0
    assert (s.slater_primal_holds + s.slater_primal_fails
            + s.slater_primal_undecided) == 0
