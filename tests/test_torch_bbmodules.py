"""The port's host modules of the B&B against the JAX package's, on the
same seeded numpy inputs: branching, reduced-cost fixing, rank-1 cuts and
heuristics, bound propagation (root and in-tree), the quadratic upgrade,
symmetry, presolve and postsolve, c-MIR, and the node store.  These are
numpy copies, so every result must be equal bit for bit
(``_torch_bbcases.assert_same``).
"""

import numpy as np
import pytest

from _torch_bbcases import PROBLEMS, assert_same
from scipsdp_tpu.core import branchbound as jbb
from scipsdp_tpu.core import branching as jbr
from scipsdp_tpu.core import presolve_sdp as jpre
from scipsdp_tpu.core import propagate as jprop
from scipsdp_tpu.core import propredcost as jrc
from scipsdp_tpu.core import quadupgrade as jqu
from scipsdp_tpu.core import rank1 as jr1
from scipsdp_tpu.core import symmetry as jsym
from scipsdp_tpu.models.problem import densify as jdensify
from scipsdp_tpu.native import frontier as jfront
from scipsdp_tpu.ops import cmir as jcmir
from scipsdp_tpu.utils.config import (BBSettings, PresolveSettings,
                                      Settings)
from scipsdp_tpu_torch.core import branchbound as tbb
from scipsdp_tpu_torch.core import branching as tbr
from scipsdp_tpu_torch.core import presolve_sdp as tpre
from scipsdp_tpu_torch.core import propagate as tprop
from scipsdp_tpu_torch.core import propredcost as trc
from scipsdp_tpu_torch.core import quadupgrade as tqu
from scipsdp_tpu_torch.core import rank1 as tr1
from scipsdp_tpu_torch.core import symmetry as tsym
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax
from scipsdp_tpu_torch.models.problem import densify as tdensify
from scipsdp_tpu_torch import native as tnative
from scipsdp_tpu_torch.native import frontier as tfront
from scipsdp_tpu_torch.ops import cmir as tcmir


def both(name):
    """(JAX MISDP, the port's copy of it)."""
    jp = PROBLEMS[name]()
    return jp, problem_from_jax(jp)


def node_box(prob, rng):
    """A node box of ``prob``: the root box with 0-3 integral variables
    split at an integer and finite stand-ins for infinite bounds on one
    side at random."""
    lb, ub = prob.lb.copy(), prob.ub.copy()
    ints = np.flatnonzero(prob.integral)
    for j in rng.choice(ints, size=min(len(ints), int(rng.integers(0, 4))),
                        replace=False) if len(ints) else []:
        lo = lb[j] if lb[j] > -1e19 else -3.0
        hi = ub[j] if ub[j] < 1e19 else 3.0
        v = float(np.floor(lo + rng.random() * (hi - lo + 1)))
        if rng.random() < 0.5:
            ub[j] = min(max(v, lb[j]), ub[j])
        else:
            lb[j] = max(min(v, ub[j]), lb[j])
    return lb, ub


@pytest.mark.parametrize("rule", ["infobjective", "mostinf", "mostfrac",
                                  "objective"])
@pytest.mark.parametrize("seed", range(3))
def test_branching_copy(rule, seed):
    rng = np.random.default_rng(seed)
    m = 12
    y = rng.normal(size=m) * 3
    near = rng.random(m) < 0.3
    y[near] = np.round(y[near])
    obj = rng.normal(size=m)
    obj[0] = 0.0
    integral = rng.random(m) < 0.7
    for feastol in (1e-6, 0.2):
        assert_same(jbr.fractionalities(y, integral, feastol),
                    tbr.fractionalities(y, integral, feastol))
        assert (jbr.select_branch_var(y, obj, integral, feastol, rule)
                == tbr.select_branch_var(y, obj, integral, feastol, rule))


@pytest.mark.parametrize("seed", range(3))
def test_redcost_copy(seed):
    rng = np.random.default_rng(seed)
    m = 10
    lb = np.where(rng.random(m) < 0.2, -1e20, rng.integers(-3, 1, m) * 1.0)
    ub = np.where(rng.random(m) < 0.2, 1e20, rng.integers(1, 5, m) * 1.0)
    xlb = np.where(rng.random(m) < 0.5, rng.random(m) * 2, 0.0)
    xub = np.where(rng.random(m) < 0.5, rng.random(m) * 2, 0.0)
    integral = rng.random(m) < 0.6
    for relax, cutoff in ((0.0, 1.0), (0.5, 0.7), (1.0, np.inf),
                          (2.0, 1.0)):
        out = []
        for fn in (jrc.redcost_tighten, trc.redcost_tighten):
            lo, hi = lb.copy(), ub.copy()
            n = fn(lo, hi, xlb, xub, relax, cutoff, integral, 1e-6)
            out.append((n, lo, hi))
        assert_same(out[0], out[1])


@pytest.mark.parametrize("seed", range(3))
def test_rank1_copy(seed):
    """Rank-1 check, cuts, branching variable, projection, completion and
    perturbation on the rank-1 block of ``rank1_prob``, at seeded points
    of its box."""
    jp, tp = both("rank1")
    jd, td = jdensify(jp), tdensify(tp)
    assert bool(np.any(jd.rank1))
    rng = np.random.default_rng(seed)
    nviol = 0
    for _ in range(6):
        y = jp.lb + rng.random(jp.nvars) * (jp.ub - jp.lb)
        v = jr1.rank1_violation(jd, y, 1e-6)
        assert_same(v, tr1.rank1_violation(td, y, 1e-6))
        assert_same(jr1.rank1_project(jd, y), tr1.rank1_project(td, y))
        assert_same(jr1.eigen_perturbation(jd, y),
                    tr1.eigen_perturbation(td, y))
        assert_same(jr1.rank1_complete(jd, y, jp.obj),
                    tr1.rank1_complete(td, y, tp.obj))
        if v is not None:
            nviol += 1
            k, s, t, _ = v
            assert_same(jr1.rank1_cuts(jd, k, s, t, jp.lb, jp.ub),
                        tr1.rank1_cuts(td, k, s, t, tp.lb, tp.ub))
            assert (jr1.rank1_branch_var(jd, k, s, t, y, jp.lb, jp.ub, 1e-6)
                    == tr1.rank1_branch_var(td, k, s, t, y, tp.lb, tp.ub,
                                            1e-6))
    assert nviol > 0


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_propagate_copy(name):
    """The root propagation sequence of solve_misdp (tighten_bounds, the
    matrix view, upper-bound and 3-minor propagation, the one-variable
    SDP bounds, trace bounds) and the same on seeded node boxes."""
    jp, tp = both(name)
    assert_same(jprop.matrix_view(jp), tprop.matrix_view(tp))
    assert_same(jprop.trace_bounds(jp), tprop.trace_bounds(tp))
    rng = np.random.default_rng(0)
    boxes = [(jp.lb.copy(), jp.ub.copy())]
    boxes += [node_box(jp, rng) for _ in range(3)]
    for lb, ub in boxes:
        out = []
        for prop, p in ((jprop, jp), (tprop, tp)):
            lo, hi, conflict = prop.tighten_bounds(p, lb, ub)
            mv = prop.matrix_view(p)
            n = [prop.propagate_upper_bounds(p, lo, hi, mv),
                 prop.propagate_3minors(p, lo, hi, mv),
                 prop.tighten_bounds_onevar(p, lo, hi)]
            out.append((conflict, n, prop.tighten_bounds(p, lo, hi,
                                                         rounds=1)))
        assert_same(out[0], out[1])


@pytest.mark.parametrize("name", ["matrixview", "mkp", "cls", "tt"])
def test_intree_propagation_copy(name):
    """_Solver.propagate_node at every depth cadence and learn_nogood on
    seeded children, in both packages."""
    jp, tp = both(name)
    s = Settings(bb=BBSettings(prop_freq=2))
    jsol = jbb._Solver(jp, s)
    tsol = tbb._Solver(tp, settings_from_jax(s), device="cpu")
    rng = np.random.default_rng(1)
    root = (jsol.prob.lb.copy(), jsol.prob.ub.copy())
    for depth in range(4):
        lb, ub = node_box(jsol.prob, rng)
        assert_same(jsol.propagate_node(lb, ub, depth),
                    tsol.propagate_node(lb, ub, depth))
        jsol.learn_nogood(lb, ub, *root)
        tsol.learn_nogood(lb, ub, *root)
    assert_same((jsol._conf_D, jsol._conf_lhs, jsol.stats.nnogoods,
                 jsol.stats.redcost_tightenings),
                (tsol._conf_D, tsol._conf_lhs, tsol.stats.nnogoods,
                 tsol.stats.redcost_tightenings))


@pytest.mark.parametrize("seed", range(2))
def test_quadupgrade_copy(seed):
    jp, tp = both("quadratic")
    jup, tup = jqu.upgrade_quadconss(jp), tqu.upgrade_quadconss(tp)
    assert_same(jup, tup)
    rng = np.random.default_rng(seed)
    lb = -rng.random(jup.nvars) * 2
    ub = rng.random(jup.nvars) * 3
    assert_same(jqu.mccormick_rows(jup.nvars, jup.liftinfo, lb, ub),
                tqu.mccormick_rows(tup.nvars, tup.liftinfo, lb, ub))


@pytest.mark.parametrize("name", ["sym", "cyclic", "mkp", "cls"])
def test_symmetry_copy(name):
    """Orbits, the verified automorphism group, lexicographic rows and
    orbital fixing on seeded node boxes."""
    jp, tp = both(name)
    assert_same(jsym.find_orbits(jp), tsym.find_orbits(tp))
    assert_same(jsym.symmetry_breaking_rows(jp),
                tsym.symmetry_breaking_rows(tp))
    jg, tg = jsym.automorphism_group(jp), tsym.automorphism_group(tp)
    assert_same(jg, tg)
    rng = np.random.default_rng(2)
    for _ in range(4):
        lb, ub = node_box(jp, rng)
        ones = frozenset(int(j) for j in np.flatnonzero(lb >= 0.5))
        for branched in (ones, None):
            assert_same(
                jsym.orbital_fixing(jg, lb, ub, jp.integral,
                                    branched_ones=branched),
                tsym.orbital_fixing(tg, lb, ub, tp.integral,
                                    branched_ones=branched))


PRESOLVE = {
    "default": Settings(),
    "aggregate": Settings(presolve=PresolveSettings(fixvars=True,
                                                    aggregate=True)),
    "lexrows": Settings(use_symmetry=True),
    "socminors": Settings(presolve=PresolveSettings(twominorsocconss=True)),
    "lincons": Settings(presolve=PresolveSettings(presollinconssparam=1,
                                                  twominorlinconss=True,
                                                  twominorprodconss=True)),
}


@pytest.mark.parametrize("variant", sorted(PRESOLVE))
@pytest.mark.parametrize("name", ["cls", "mkp", "tt", "sym", "aggsolve",
                                  "quadratic", "hetero", "upper_bound"])
def test_presolve_copy(name, variant):
    """presolve_problem's whole output problem, and postsolve_solution of
    seeded reduced-space points."""
    jp, tp = both(name)
    s = PRESOLVE[variant]
    jr = jpre.presolve_problem(jp, s)
    tr = tpre.presolve_problem(tp, settings_from_jax(s))
    assert_same(jr, tr)
    rng = np.random.default_rng(3)
    for _ in range(2):
        y = rng.normal(size=jr.nvars)
        assert_same(jpre.postsolve_solution(jr, y),
                    tpre.postsolve_solution(tr, y))


@pytest.mark.parametrize("seed", range(4))
def test_cmir_copy(seed):
    """cmir_cut on test_cmir.py's random base rows (50 trials a seed)."""
    rng = np.random.default_rng(seed)
    nfound = 0
    for _ in range(50):
        m = int(rng.integers(1, 5))
        g = rng.integers(-3, 4, m).astype(float)
        lhs = float(rng.integers(-6, 7)) + rng.choice([0.0, 0.3, 0.5])
        lb = np.where(rng.random(m) < 0.1, -1e20, 0.0)
        ub = rng.integers(1, 4, m).astype(float)
        integral = rng.random(m) < 0.7
        ystar = np.where(lb > -1e19, lb, 0.0) + rng.random(m) * ub
        a = jcmir.cmir_cut(g, lhs, lb, ub, integral, ystar)
        assert_same(a, tcmir.cmir_cut(g, lhs, lb, ub, integral, ystar))
        nfound += a is not None
    assert nfound > 0


def _drive(fs, seed):
    """test_frontier.py's random push / pop / dump script; the trace of
    every pop and dump."""
    rng = np.random.default_rng(seed)
    trace = []
    for step in range(200):
        if rng.random() < 0.6 or len(fs) == 0:
            b = float(np.round(rng.normal(), 3))
            lb = rng.random(4)
            fs.push(lb, lb + 1.0, b, step % 7,
                    side=(b, [step], step, None, None))
        elif rng.random() < 0.1:
            trace.append(sorted((o[4][2], o[0].tolist(), o[2], o[3])
                                for o in fs.dump())
                         + [len(fs), fs.best_bound()])
        else:
            out = fs.pop_upto(int(rng.integers(1, 4)),
                              cutoff=float(rng.normal() + 1.0))
            trace.append([(o[0].tolist(), o[1].tolist(), o[2], o[3],
                           o[4][2]) for o in out])
    trace.append([(o[2], o[3], o[4][2]) for o in fs.pop_upto(10_000)])
    return trace


@pytest.mark.parametrize("store", ["native", "python"])
@pytest.mark.parametrize("seed", range(2))
def test_frontier_copy(store, seed):
    """The port's store, native and Python heap, pops, dumps and prunes as
    the JAX package's Python heap does."""
    if store == "native":
        assert tfront.get_frontier_lib() is not None, "g++ build failed"
    want = _drive(jfront.FrontierStore(4, prefer_native=False), seed)
    port = tfront.FrontierStore(4, prefer_native=store == "native")
    assert port.native == (store == "native")
    assert _drive(port, seed) == want


def test_frontier_library_beside_the_package():
    """The port builds its node store under build/, never beside the
    source, and loads it from there."""
    path = tnative.library_path(tfront._SRC_PATH, "libfrontier.so")
    assert tfront.get_frontier_lib() is not None
    assert path.is_file() and "build" in path.parts
    assert not (tfront._SRC_PATH.parent / "libfrontier.so").exists()
