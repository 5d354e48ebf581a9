"""Turbo's engagement in the port's ``solve_misdp`` against the JAX
package's on the CPU.

* ``bb.turbo="on"``: both packages run the whole tree in ``solve_turbo``
  at once; same status, the optimum within 1e-4 relative (bench.py's
  rule) and every ``BBStats`` counter equal (PR 11's rule for the host
  loop).  The IPM settings are pinned on both sides, the randomized
  rounding is off and a chunk holds at most 8 rounds.
* ``"auto"`` on the CPU: the host loop runs first and hands its whole
  frontier to ``solve_turbo`` after three batches once it holds 2B nodes;
  spies on both packages' ``solve_turbo`` see one such handoff each, of
  the same frontier size, and the counters agree.
* Settings turbo cannot run (orbital symmetry, a checkpoint, a rank-1
  block) never call ``solve_turbo``.
* The randomized rounding draws from one seeded ``torch.Generator``: a
  second run with the same seed gives the same tree.
"""

import dataclasses

import numpy as np
import pytest

from _torch_bbcases import SOLVE, indicator_prob, torch_one_thread
from scipsdp_tpu.core import turbo as jturbo
from scipsdp_tpu.core.branchbound import solve_misdp as jax_solve_misdp
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.utils.config import BBSettings, IPMSettings, Settings
from scipsdp_tpu_torch.core import branchbound as tbb
from scipsdp_tpu_torch.core import turbo as tturbo
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax
from scipsdp_tpu_torch.utils.status import SolveStatus

pytestmark = pytest.mark.usefixtures("torch_one_thread")

IPM = IPMSettings(phase32="off", step_rule="eigh", use_lanes_chol=False,
                  use_df32="off", fused_direction="off")
REL = 1e-4


def settings(batch_size, turbo, **bb):
    return Settings(ipm=IPM, bb=BBSettings(
        batch_size=batch_size, turbo=turbo, heuristic_rand=False,
        turbo_rounds=8, node_limit=400, **bb))


def counters(stats) -> dict:
    """Every BBStats field but the timings."""
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.name not in ("prop_times", "wall_time", "solve_time")}


def spy(monkeypatch, module):
    """Record (len(init_nodes) or None, result) of each solve_turbo call."""
    calls = []
    orig = module.solve_turbo

    def wrapped(*a, **kw):
        res = orig(*a, **kw)
        init = kw.get("init_nodes")
        calls.append((None if init is None else len(init), res))
        return res

    monkeypatch.setattr(module, "solve_turbo", wrapped)
    return calls


def solve_both(monkeypatch, jprob, s):
    """(JAX result, its turbo calls, the port's result, its calls)."""
    jcalls, tcalls = spy(monkeypatch, jturbo), spy(monkeypatch, tturbo)
    rj = jax_solve_misdp(jprob, s)
    rt = tbb.solve_misdp(problem_from_jax(jprob), settings_from_jax(s),
                         device="cpu")
    return rj, jcalls, rt, tcalls


def assert_same_optimum(rj, rt):
    assert rt.status.name == rj.status.name
    assert abs(rt.objval - rj.objval) <= REL * max(1.0, abs(rj.objval))
    assert abs(rt.dual_bound - rj.dual_bound) <= REL * max(
        1.0, abs(rj.dual_bound))


def cls12():
    return jfam.cardinality_least_squares(12, 24, 4, seed=2)


def cls18():
    return jfam.cardinality_least_squares(18, 36, 8, seed=2)


ON = {   # name: (problem, batch size)
    "cls": SOLVE["cls"],
    "mkp": SOLVE["mkp"],
    "conflict": SOLVE["conflict"],
    "hetero": SOLVE["hetero"],
    "aggsolve": SOLVE["aggsolve"],
    "indicator": (indicator_prob, 4),
    "cls12": (cls12, 4),
}


@pytest.mark.parametrize("name", sorted(ON))
def test_turbo_on_matches_jax(monkeypatch, name):
    build, batch = ON[name]
    rj, jcalls, rt, tcalls = solve_both(monkeypatch, build(),
                                        settings(batch, "on"))
    assert rj.status == rj.status.OPTIMAL
    assert_same_optimum(rj, rt)
    assert counters(rt.stats) == counters(rj.stats)
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls] == [None]
    assert tcalls[0][1] is not None


def test_turbo_on_with_a_stalled_slot(monkeypatch):
    """The truss instance: two rounds' direct solves hold a slot that
    stalls (then decided by a rung).  Stall detection reads a merit that
    makes no progress, so the batch's iteration count may differ by up to
    2 there (tests/test_torch_ipm_solve.py::test_stalled_child_fails_in_
    both); every other counter is equal."""
    build, batch = SOLVE["tt"]
    rj, _, rt, _ = solve_both(monkeypatch, build(), settings(batch, "on"))
    assert_same_optimum(rj, rt)
    cj, ct = counters(rj.stats), counters(rt.stats)
    rung_rounds = cj["solver_calls"] - cj["relax_solves"]
    assert rung_rounds > 0
    assert abs(ct.pop("ipm_iterations") - cj.pop("ipm_iterations")) \
        <= 2 * rung_rounds
    assert ct == cj


@pytest.mark.parametrize("build", [cls12, cls18], ids=["cls12", "cls18"])
def test_turbo_auto_defers_on_the_cpu(monkeypatch, build):
    """The host loop runs three batches, then hands its 8-node frontier
    over; the same handoff and the same counters in both packages."""
    rj, jcalls, rt, tcalls = solve_both(monkeypatch, build(),
                                        settings(4, "auto"))
    assert rj.status == rj.status.OPTIMAL
    assert_same_optimum(rj, rt)
    assert counters(rt.stats) == counters(rj.stats)
    assert len(tcalls) == len(jcalls) == 1
    assert tcalls[0][0] == jcalls[0][0] >= 2 * 4
    assert tcalls[0][1] is not None
    assert rt.stats.relax_solves > tcalls[0][1].rounds


INELIGIBLE = {
    "orbital_symmetry": (SOLVE["sym"][0], dict(
        use_symmetry=True, symmetry_mode="orbital"), {}),
    "checkpoint": (cls12, {}, {"checkpoint": True}),
    "rank1": (SOLVE["rank1"][0], {}, {}),
}


@pytest.mark.parametrize("case", sorted(INELIGIBLE))
def test_ineligible_never_calls_turbo(monkeypatch, tmp_path, case):
    build, extra, kw = INELIGIBLE[case]
    calls = spy(monkeypatch, tturbo)
    s = settings(4, "on")
    s = dataclasses.replace(s, **extra)
    if kw.get("checkpoint"):
        kw = {"checkpoint": str(tmp_path / "bb.npz")}
    res = tbb.solve_misdp(problem_from_jax(build()), settings_from_jax(s),
                          device="cpu", **kw)
    assert res.status == SolveStatus.OPTIMAL
    assert calls == []


def test_same_seed_same_tree():
    """Randomized rounding on (one seeded torch.Generator): two runs
    give the same tree, objective and incumbent."""
    jp = jfam.min_k_partition(12, 3, 0.6, seed=1)
    s = settings_from_jax(Settings(ipm=IPM, bb=BBSettings(
        batch_size=8, turbo="on", turbo_rounds=8, heuristic_rand=True),
        seed=3))
    r1, r2 = (tbb.solve_misdp(problem_from_jax(jp), s, device="cpu")
              for _ in range(2))
    assert r1.status == SolveStatus.OPTIMAL
    assert abs(r1.objval - 30.0) <= REL * 30.0
    assert counters(r1.stats) == counters(r2.stats)
    assert r1.objval == r2.objval
    np.testing.assert_array_equal(r1.best_y, r2.best_y)
