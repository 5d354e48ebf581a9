"""The port's branch-and-bound (``core/branchbound.py::solve_misdp``)
against the JAX package's on the CPU.

* Parity: every instance of ``_torch_bbcases.SOLVE`` goes through both
  loops with ``bb.turbo="off"`` (JAX on the CPU would otherwise hand the
  frontier to its device-resident tree after three batches), the
  randomized rounding off (the port draws it from a ``torch.Generator``,
  not from JAX's) and the IPM settings pinned on both sides.  Same status,
  the optimum within 1e-4 relative (bench.py's rule) and the same
  counts: nodes, batches, IPM iterations, heuristic incumbents,
  tightenings and the rest of ``BBStats`` but its timings.  The symmetric
  instance also runs with lexicographic rows and with orbital fixing.
* One solve at full defaults, held to status and optimum only.
* Carried state: ``problem_from_jax`` copies every field; a JAX checkpoint
  resumes in the port to the JAX optimum; the port's own checkpoints
  resume (tests/test_checkpoint.py's two checks, which read an instance
  file that is not in the repository, rebuilt on a generated CLS).
* The probing module's seven options and LP mode, one parity tree each
  on an instance where the option moves its own counters against the
  same tree without it (``test_option_parity``); the root options leave
  turbo's engagement as JAX's.
* The device mesh on one CPU device (no mesh) and a one-process
  multi-host sync hook give JAX's trees (``tests/test_torch_parallel.py``
  and ``tests/test_torch_multihost.py`` hold the mesh and the multi-process
  runs), and ``device=None`` means the card.  ``bb.turbo="auto"`` on the
  CPU runs
  the host loop first (``tests/test_torch_turbo_bb.py`` holds the
  device-resident tree and its engagement to JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_bbcases import (SOLVE, assert_same, obbt_prob,  # noqa: F401
                             torch_one_thread)
from scipsdp_tpu.core.branchbound import solve_misdp as jax_solve_misdp
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.parallel import multihost as jmh
from scipsdp_tpu.utils.config import (BBSettings, IPMSettings, Settings)
from scipsdp_tpu_torch.core import branchbound as tbb
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax
from scipsdp_tpu_torch.parallel import multihost as tmh
from scipsdp_tpu_torch.utils.status import SolveStatus

pytestmark = pytest.mark.usefixtures("torch_one_thread")

IPM = IPMSettings(phase32="off", step_rule="eigh", use_lanes_chol=False,
                  use_df32="off", fused_direction="off")
REL = 1e-4


def settings(batch_size=16, **kw):
    return Settings(ipm=IPM, bb=BBSettings(turbo="off", heuristic_rand=False,
                                           node_limit=200,
                                           batch_size=batch_size), **kw)


def solve_both(jprob, jsettings, **kw):
    """(JAX result, the port's result on the CPU) for one problem."""
    rj = jax_solve_misdp(jprob, jsettings, **kw)
    rt = tbb.solve_misdp(problem_from_jax(jprob), settings_from_jax(jsettings),
                         device="cpu", **kw)
    return rj, rt


def assert_same_optimum(rj, rt):
    assert rt.status.name == rj.status.name
    if rj.objval is None:
        assert rt.objval is None
    else:
        assert abs(rt.objval - rj.objval) <= REL * max(1.0, abs(rj.objval))
        assert rt.best_y.shape == rj.best_y.shape


def counters(stats) -> dict:
    """The tree's counts (nodes, batches, IPM iterations, solver calls,
    penalty and unsolved decisions, heuristic incumbents, tightenings,
    no-goods, orbital fixings, ...): every field but the timings."""
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.name not in ("prop_times", "wall_time", "solve_time")}


SYMMETRY = {"": {}, "lexrows": dict(use_symmetry=True),
            "orbital": dict(use_symmetry=True, symmetry_mode="orbital")}
CASES = [(name, "") for name in sorted(SOLVE)] + [
    ("sym", "lexrows"), ("sym", "orbital")]


@pytest.mark.parametrize("name,sym", CASES)
def test_solve_parity(name, sym):
    build, batch = SOLVE[name]
    rj, rt = solve_both(build(), settings(batch, **SYMMETRY[sym]))
    assert rj.status == rj.status.OPTIMAL
    assert_same_optimum(rj, rt)
    assert counters(rt.stats) == counters(rj.stats)
    assert abs(rt.dual_bound - rj.dual_bound) <= REL * max(
        1.0, abs(rj.dual_bound))


def test_default_settings_solve():
    """Full defaults in both packages (randomized rounding on, turbo
    "auto": the CPU policy of both never hands this small tree over):
    status and optimum only."""
    prob = jfam.cardinality_least_squares(5, 8, 2)
    rj = jax_solve_misdp(prob)
    rt = tbb.solve_misdp(problem_from_jax(prob), device="cpu")
    assert rj.status == rj.status.OPTIMAL
    assert_same_optimum(rj, rt)
    print(f"nodes: jax {rj.stats.nodes}, port {rt.stats.nodes}")


@pytest.mark.parametrize("name", sorted(SOLVE))
def test_problem_from_jax_carries(name):
    """Every field crosses unchanged, as a copy the port may change."""
    jp = SOLVE[name][0]()
    tp = problem_from_jax(jp)
    assert type(tp).__module__ == "scipsdp_tpu_torch.models.problem"
    assert_same(jp, tp)
    tp.lb[:] = -7.0
    assert not np.any(jp.lb == -7.0)


def cls_instance():
    return jfam.cardinality_least_squares(6, 12, 3, seed=1)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """tests/test_checkpoint.py's recipe in the JAX package (node_limit=3,
    batch_size=2, a checkpoint every batch), resumed by the port."""
    prob = cls_instance()
    ck = str(tmp_path / "bb.npz")
    r1 = jax_solve_misdp(prob, Settings(bb=BBSettings(
        node_limit=3, batch_size=2, turbo="off")), checkpoint=ck,
        checkpoint_every=1)
    assert r1.status == r1.status.NODE_LIMIT
    full = jax_solve_misdp(prob, Settings(bb=BBSettings(turbo="off")))
    r2 = tbb.solve_misdp(problem_from_jax(prob), settings_from_jax(
        Settings(bb=BBSettings(batch_size=2))), checkpoint=ck, resume=True,
        device="cpu")
    assert r2.status == SolveStatus.OPTIMAL
    assert abs(r2.objval - full.objval) <= REL * max(1.0, abs(full.objval))
    assert r2.stats.nodes > r1.stats.nodes


def test_checkpoint_resume(tmp_path):
    """A node-limited checkpoint resumes to the optimum."""
    prob = problem_from_jax(cls_instance())
    ck = str(tmp_path / "bb.npz")
    full = tbb.solve_misdp(prob, device="cpu")
    s1 = settings_from_jax(Settings(bb=BBSettings(node_limit=3,
                                                  batch_size=2)))
    r1 = tbb.solve_misdp(prob, s1, checkpoint=ck, checkpoint_every=1,
                         device="cpu")
    assert r1.status == SolveStatus.NODE_LIMIT
    s2 = settings_from_jax(Settings(bb=BBSettings(batch_size=2)))
    r2 = tbb.solve_misdp(prob, s2, checkpoint=ck, resume=True, device="cpu")
    assert r2.status == SolveStatus.OPTIMAL
    assert abs(r2.objval - full.objval) <= REL * max(1.0, abs(full.objval))


def test_resume_finished_checkpoint(tmp_path):
    """A checkpoint written by a finished solve resumes to the same
    objective."""
    prob = problem_from_jax(cls_instance())
    ck = str(tmp_path / "bb.npz")
    r1 = tbb.solve_misdp(prob, checkpoint=ck, checkpoint_every=1,
                         device="cpu")
    assert r1.status == SolveStatus.OPTIMAL
    r2 = tbb.solve_misdp(prob, checkpoint=ck, resume=True, device="cpu")
    assert r2.status == SolveStatus.OPTIMAL
    assert abs(r2.objval - r1.objval) < 1e-9


UNPORTED = {
    "use_mesh": dict(use_mesh=True),
    "sync_hook": dict(),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_paths_raise(case):
    """The two paths that once raised run, counter for counter with JAX:
    ``use_mesh`` on the CPU's one device builds no mesh, the tree JAX
    grows without one; a one-process ``DistributedSync`` hook in both
    packages keeps the loop in lockstep with itself, the same tree."""
    build, batch = SOLVE["conflict"]
    jp = build()
    s = settings(batch)
    hooks = ((jmh.DistributedSync(), tmh.DistributedSync())
             if case == "sync_hook" else (None, None))
    rj = jax_solve_misdp(jp, s, sync_hook=hooks[0])
    rt = tbb.solve_misdp(problem_from_jax(jp), settings_from_jax(
        dataclasses.replace(s, **UNPORTED[case])), sync_hook=hooks[1],
        device="cpu")
    assert rj.status == rj.status.OPTIMAL
    assert_same_optimum(rj, rt)
    assert counters(rt.stats) == counters(rj.stats)
    if case == "sync_hook":
        assert hooks[1].calls == hooks[0].calls > 0


# the opt-in options of the probing module and LP mode: per option the
# tree it runs on, the settings it runs beside (warm starts for the two
# warm-start variants), its own settings, and the counters it moves there
SLATER = tuple(f"slater_{side}{k}" for side in ("", "primal_")
               for k in ("holds", "fails", "undecided"))
OPTIONS = {
    "lp_mode": ("cls", {}, dict(solve_sdps=0), ("sep_rounds", "ncuts")),
    "heuristic_innerlp": ("hetero", {}, dict(heuristic_innerlp=True),
                          ("heur_found",)),
    "analytic_center": ("cls", dict(warmstart=True),
                        dict(warmstartiptype=2), ("ipm_iterations",)),
    "obbt_at_root": ("obbt", {}, dict(obbt_at_root=True),
                     ("redcost_tightenings",)),
    "obbt_freq": ("cls", {}, dict(obbt_freq=2), ("redcost_tightenings",)),
    "rounding_problem": ("cls", dict(warmstart=True),
                         dict(warmstartproject=4), ("ipm_iterations",)),
    "slatercheck": ("cls", {}, dict(slatercheck=1), SLATER),
    "diving_freq": ("cls", {}, dict(diving_freq=2), ("heur_found",)),
}
TREES = {**SOLVE, "obbt": (obbt_prob, 4)}


def option_settings(batch, base, option):
    """The parity settings with ``base`` and ``option`` set (``solve_sdps``
    at the top level, the rest in ``bb``)."""
    kw = {**base, **option}
    top = {k: kw.pop(k) for k in list(kw) if k == "solve_sdps"}
    s = settings(batch, **top)
    return dataclasses.replace(s, bb=dataclasses.replace(s.bb, **kw))


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_option_parity(case):
    """Each option of the probing module, and LP mode, in both host loops:
    the same optimum and every counter equal; and the option acts on that
    tree: the counters it moves differ from the port's tree without it."""
    name, base, option, moved = OPTIONS[case]
    build, batch = TREES[name]
    rj, rt = solve_both(build(), option_settings(batch, base, option))
    assert rj.status == rj.status.OPTIMAL
    assert_same_optimum(rj, rt)
    assert counters(rt.stats) == counters(rj.stats)
    off = tbb.solve_misdp(problem_from_jax(build()),
                          settings_from_jax(option_settings(batch, base, {})),
                          device="cpu")
    assert ([getattr(rt.stats, k) for k in moved]
            != [getattr(off.stats, k) for k in moved])


def test_root_options_keep_turbo_engagement(monkeypatch):
    """The root's inner-LP heuristic, analytic centers and OBBT run before
    turbo engages and leave its engagement as JAX's: with bb.turbo="on"
    both packages hand the tree to solve_turbo at once, with the same
    counters (a chunk holds at most 8 rounds, as turbo parity pins)."""
    from scipsdp_tpu.core import turbo as jturbo
    from scipsdp_tpu_torch.core import turbo as tturbo
    calls = {"jax": [], "port": []}
    for key, mod in (("jax", jturbo), ("port", tturbo)):
        orig = mod.solve_turbo

        def spy(*a, _orig=orig, _key=key, **kw):
            res = _orig(*a, **kw)
            calls[_key].append((kw.get("init_nodes"), res))
            return res

        monkeypatch.setattr(mod, "solve_turbo", spy)
    build, batch = SOLVE["cls"]
    s = settings(batch)
    s = dataclasses.replace(s, bb=dataclasses.replace(
        s.bb, turbo="on", turbo_rounds=8, heuristic_innerlp=True,
        obbt_at_root=True, warmstart=True, warmstartiptype=2))
    rj, rt = solve_both(build(), s)
    assert rj.status == rj.status.OPTIMAL
    assert_same_optimum(rj, rt)
    assert counters(rt.stats) == counters(rj.stats)
    assert len(calls["jax"]) == len(calls["port"]) == 1
    assert calls["port"][0][0] is None and calls["port"][0][1] is not None


def test_turbo_auto_runs_the_host_loop(monkeypatch):
    """bb.turbo="auto" (the default) on the CPU runs the host loop first:
    a tree that never holds 2B open nodes after three batches solves
    there without calling solve_turbo; a larger one hands its frontier
    over after its third batch."""
    from scipsdp_tpu_torch.core import turbo as tturbo
    calls = []
    orig = tturbo.solve_turbo

    def spy(*a, **kw):
        calls.append(len(kw["init_nodes"]) if "init_nodes" in kw else None)
        return orig(*a, **kw)

    monkeypatch.setattr(tturbo, "solve_turbo", spy)
    s = settings_from_jax(Settings(bb=BBSettings(turbo="auto")))
    res = tbb.solve_misdp(problem_from_jax(SOLVE["conflict"][0]()), s,
                          device="cpu")
    assert res.status == SolveStatus.OPTIMAL and res.stats.relax_solves > 0
    assert calls == []
    s = settings_from_jax(Settings(bb=BBSettings(turbo="auto",
                                                 batch_size=4)))
    res = tbb.solve_misdp(problem_from_jax(
        jfam.cardinality_least_squares(12, 24, 4, seed=2)), s, device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    assert len(calls) == 1 and calls[0] >= 8


def test_device_none_means_the_card(monkeypatch):
    """No device means the CUDA card: without one the solve raises, it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbb.solve_misdp(problem_from_jax(SOLVE["conflict"][0]()))


def test_stats_and_result_fields_match():
    """BBStats and BBResult carry the JAX package's fields."""
    from scipsdp_tpu.core import branchbound as jbb
    for jcls, tcls in ((jbb.BBStats, tbb.BBStats),
                       (jbb.BBResult, tbb.BBResult)):
        assert ([f.name for f in dataclasses.fields(jcls)]
                == [f.name for f in dataclasses.fields(tcls)])
