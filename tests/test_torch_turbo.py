"""The port's device-resident branch-and-bound (``core/turbo.py``) against
the JAX package's on the CPU.

Both packages get the same problem (a JAX ``MISDP`` carried over with
``interop.problem_from_jax``) and the same settings, with the IPM pinned
on both sides, the randomized rounding off (the port draws it from a
``torch.Generator``, not from JAX's threefry stream) and at most 8 rounds
a chunk (then both packages run identical chunks, so the width ramp steps
at the same rounds).  ``solve_turbo`` must return every ``TurboResult``
integer field equal and ``inc_val`` and ``dual_bound`` within 1e-6
relative; both bail paths return ``None`` in both.  The tie-order helper
returns exactly ``jax.lax.top_k``'s indices, and ``psd_feasible`` the JAX
closure's flags.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_bbcases import PROBLEMS, indicator_prob, torch_one_thread
from _torch_parity import port_data
from scipsdp_tpu.core import turbo as jturbo
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models.problem import densify as jdensify
from scipsdp_tpu.ops.ipm import build_ipm_data as jbuild
from scipsdp_tpu.utils.config import BBSettings, IPMSettings, Settings
from scipsdp_tpu_torch.core import turbo as tturbo
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax
from scipsdp_tpu_torch.models.problem import densify as tdensify
from scipsdp_tpu_torch.parallel.mesh import make_mesh
from scipsdp_tpu_torch.utils.config import Settings as TorchSettings
from scipsdp_tpu_torch.utils.config import BBSettings as TorchBBSettings
from scipsdp_tpu_torch.utils.config import resolve_backend_autos

pytestmark = pytest.mark.usefixtures("torch_one_thread")

IPM = IPMSettings(phase32="off", step_rule="eigh", use_lanes_chol=False,
                  use_df32="off", fused_direction="off")
REL = 1e-6
INT_FIELDS = ("nodes", "rounds", "iters", "nsolves", "nheur", "ndirect",
              "nunsolved", "hit_node_limit", "hit_time_limit")


def settings(batch_size, **bb):
    return Settings(ipm=IPM, bb=BBSettings(**{
        "heuristic_rand": False, "turbo_rounds": 8, **bb,
        "batch_size": batch_size}))


def turbo_both(jprob, s, rounds=8, **kw):
    """(JAX TurboResult, the port's) from the root box of ``jprob``."""
    jd = jdensify(jprob)
    m = jd.nvars
    rj = jturbo.solve_turbo(jd, jprob, s, np.asarray(jprob.lb[:m]),
                            np.asarray(jprob.ub[:m]), np.inf, None,
                            data=jbuild(jd), rounds_per_dispatch=rounds,
                            **kw)
    tp = problem_from_jax(jprob)
    rt = tturbo.solve_turbo(tdensify(tp), tp, settings_from_jax(s),
                            tp.lb[:m], tp.ub[:m], np.inf, None,
                            rounds_per_dispatch=rounds, device="cpu", **kw)
    return rj, rt


def assert_same_result(rj, rt):
    assert rj is not None and rt is not None
    for f in INT_FIELDS:
        assert getattr(rt, f) == getattr(rj, f), f
    for f in ("inc_val", "dual_bound"):
        a, b = getattr(rt, f), getattr(rj, f)
        assert abs(a - b) <= REL * max(1.0, abs(b)), (f, a, b)
    assert (rt.inc_y is None) == (rj.inc_y is None)


ELIGIBLE_VARIANTS = {
    "default": dict(),
    "turbo_off": dict(turbo="off"),
    "turbo_on": dict(turbo="on"),
    "dfs": dict(node_selection="dfs"),
    "diving": dict(diving_freq=3),
    "rounding_problem": dict(warmstart=True, warmstartproject=4),
    "warmstart": dict(warmstart=True),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_eligible_matches_jax(name):
    """The same predicate over every bbcases problem, each setting
    variant and both relaxation modes."""
    jp = PROBLEMS[name]()
    tp = problem_from_jax(jp)
    jd, td = jdensify(jp), tdensify(tp)
    for variant, bb in ELIGIBLE_VARIANTS.items():
        s = Settings(bb=BBSettings(**bb))
        for lp_mode in (False, True):
            want = jturbo.eligible(jp, jd, s, lp_mode)
            got = tturbo.eligible(tp, td, settings_from_jax(s), lp_mode)
            assert got == want, (variant, lp_mode)


TIES = {
    "issue": (np.array([0, 1, 1, 0, 1, 0, 1, 1, 0, 1], np.int32), 6),
    "free_slots": ((np.arange(40) % 3 != 0).astype(np.int32), 16),
    "bounds": (np.array([-np.inf, 2.0, -1.5, 2.0, -np.inf, -1.5, 0.0,
                         2.0, -np.inf, 0.0]), 8),
    "random": (np.round(np.random.default_rng(3).standard_normal(64), 1),
               24),
}


@pytest.mark.parametrize("case", sorted(TIES))
def test_top_k_indices_match_lax_top_k(case):
    """Selection (negated bounds, invalid slots at -inf) and free slots
    (an int mask) in jax.lax.top_k's order: ties go to the lower index."""
    x, k = TIES[case]
    want = np.asarray(jax.lax.top_k(jax.numpy.asarray(x), k)[1])
    got = tturbo.top_k_indices(torch.as_tensor(x), k).numpy()
    np.testing.assert_array_equal(got, want)


def closure_var(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def jax_psd_feasible(s, integral, chk):
    """JAX's ``psd_feasible``: the closure inside make_round's round."""
    chunk = jturbo.make_round(s, integral, 4, check_feastol=chk)
    round_fn = closure_var(chunk, "round_fn").__wrapped__
    return closure_var(round_fn, "psd_feasible")


@pytest.mark.parametrize("name,dimacs", [("cls", False), ("mkp", False),
                                         ("cls", True)])
def test_psd_feasible_matches_jax(name, dimacs):
    """Relaxation optima (feasible), their roundings, points moved off
    them and random points: the same flags as JAX's closure."""
    jp = {"cls": lambda: jfam.cardinality_least_squares(6, 12, 3, seed=1),
          "mkp": lambda: jfam.min_k_partition(6, 3, 0.6, seed=1)}[name]()
    s = settings(8, usedimacsfeastol=dimacs)
    jd = jdensify(jp)
    jdata = jbuild(jd)
    chk = (s.bb.feastol * (1.0 + float(np.sum(np.abs(jd.obj))))
           if dimacs else None)
    m = jd.nvars
    rng = np.random.default_rng(0)
    # relaxation optima of the root and a few children
    lb = np.tile(jp.lb, (4, 1))
    ub = np.tile(jp.ub, (4, 1))
    ints = np.flatnonzero(jp.integral)
    for i in range(1, 4):
        j = ints[i]
        ub[i, j] = lb[i, j]
    b = np.concatenate([np.tile(jd.obj, (4, 1)), np.zeros((4, 1))], 1)
    zcol = np.zeros((4, 1))
    out = jturbo.ipm_solve(jdata, jax.numpy.asarray(b),
                           jax.numpy.asarray(np.concatenate([lb, zcol], 1)),
                           jax.numpy.asarray(np.concatenate([ub, zcol], 1)),
                           settings=IPM)
    y = np.asarray(out.y)[:, :m]
    pts = np.concatenate([
        y, np.where(jp.integral, np.round(y), y),
        y + 1e-3 * rng.standard_normal(y.shape),
        y - 0.05 * np.abs(y), rng.uniform(jp.lb, np.minimum(jp.ub, 5.0),
                                          (8, m))])
    want = np.asarray(jax_psd_feasible(s, jd.integral, chk)(jdata, pts))
    ts = settings_from_jax(s)
    got = tturbo.psd_feasible(port_data(jdata), torch.as_tensor(pts),
                              chk if dimacs else ts.bb.feastol,
                              ts.bb.feastol, ts.ipm).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def cls12():
    return jfam.cardinality_least_squares(12, 24, 4, seed=2)


def mkp12():
    return jfam.min_k_partition(12, 3, 0.6, seed=1)


def cls18():
    return jfam.cardinality_least_squares(18, 36, 8, seed=2)


SOLVES = {
    # name: (problem, settings, rounds a chunk)
    "cls12_b4": (cls12, settings(4), 8),
    "mkp12_b8_rungs": (mkp12, settings(8), 8),
    "indicator": (indicator_prob, settings(4), 8),
    "dimacs_feastol": (cls12, settings(4, usedimacsfeastol=True), 8),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_solve_turbo_matches_jax(case):
    build, s, rounds = SOLVES[case]
    rj, rt = turbo_both(build(), s, rounds)
    assert_same_result(rj, rt)
    if case == "mkp12_b8_rungs":
        assert rt.nsolves > rt.rounds and rt.nunsolved > 0 and rt.nheur > 0


def test_width_ramp_steps_as_jax(monkeypatch):
    """B = 16, two rounds a chunk: the live frontier outgrows 4 x 8 and
    the width steps from 8 to 16 in the port, at the same chunk as in
    JAX (the counters would differ otherwise)."""
    widths = []
    make_round = tturbo.make_round

    def spy(settings, integral, B, *a, **k):
        widths.append(B)
        return make_round(settings, integral, B, *a, **k)

    monkeypatch.setattr(tturbo, "make_round", spy)
    rj, rt = turbo_both(cls18(), settings(16, turbo_rounds=2), rounds=2)
    assert_same_result(rj, rt)
    assert widths == [8, 16]


def init_boxes(jprob, n):
    """n open nodes that together cover the root box: the first n // 2
    integral variables fixed in turn (z_j = 0 for j < i, z_i = 1)."""
    ints = np.flatnonzero(jprob.integral)
    nodes = []
    for i in range(n):
        lb, ub = jprob.lb.copy(), jprob.ub.copy()
        ub[ints[:i]] = lb[ints[:i]]
        if i < n - 1:
            lb[ints[i]] = ub[ints[i]]
        nodes.append((lb, ub, -np.inf if i % 2 else -1e3))
    return nodes


def test_init_nodes_handoff_matches_jax():
    """A seeded frontier (the deferred-engagement handoff) in place of
    the root box, with an incumbent to beat."""
    jp = cls12()
    nodes = init_boxes(jp, 5)
    rj, rt = turbo_both(jp, settings(4), init_nodes=nodes)
    assert_same_result(rj, rt)
    assert rt.nodes > len(nodes)


def root_copies(jprob, n):
    return [(jprob.lb.copy(), jprob.ub.copy(), -np.inf) for _ in range(n)]


def test_bail_when_init_nodes_exceed_half_the_slab():
    """17 nodes for a slab of 8 B = 32 slots: None before any work."""
    jp = cls12()
    rj, rt = turbo_both(jp, settings(4, turbo_capacity=0),
                        init_nodes=root_copies(jp, 17))
    assert rj is None and rt is None


def test_bail_on_slab_overflow():
    """16 copies of the root box in a slab of 32 slots at B = 4: each
    round takes 4 nodes and places up to 8 children, so the slab fills
    before the tree can close, and both packages hand the tree back."""
    jp = cls12()
    rj, rt = turbo_both(jp, settings(4, turbo_capacity=0),
                        init_nodes=root_copies(jp, 16))
    assert rj is None and rt is None


def test_mkp12_completes_without_bail_at_defaults():
    """tests/test_families.py::test_mkp12_turbo_completes_without_bail
    in the port: default settings on the CPU, B = 8: no bail, the known
    optimum 30.0 (bench.py's 1e-4 relative rule)."""
    tp = problem_from_jax(mkp12())
    dense = tdensify(tp)
    m = dense.nvars
    s = resolve_backend_autos(TorchSettings(bb=TorchBBSettings(batch_size=8)),
                              "cpu")
    res = tturbo.solve_turbo(dense, tp, s, tp.lb[:m], tp.ub[:m], np.inf,
                             None, rounds_per_dispatch=8, device="cpu")
    assert res is not None, "turbo bailed to the host path"
    assert abs(res.inc_val - 30.0) <= 1e-4 * 30.0


def test_device_none_means_the_card(monkeypatch):
    """No data and no device means the CUDA card: without one the solve
    raises, it never falls back to the CPU.  With a mesh the solve runs
    on the mesh's first device (here two CPU entries), the same tree as
    on the CPU without it (B = 8: no width ramp on either side)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp = problem_from_jax(cls12())
    dense = tdensify(tp)
    m = dense.nvars
    s = settings_from_jax(settings(8))
    args = (dense, tp, s, tp.lb[:m], tp.ub[:m], np.inf, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tturbo.solve_turbo(*args)
    want = tturbo.solve_turbo(*args, device="cpu")
    got = tturbo.solve_turbo(*args, mesh=make_mesh(2, device="cpu"))
    assert want is not None and got is not None
    assert got.inc_val == pytest.approx(want.inc_val, rel=1e-9)
    # every field but the floats (and the solves' host wall, a timing)
    same = dict(inc_val=0.0, inc_y=None, dual_bound=0.0, solve_time=0.0)
    assert got._replace(**same) == want._replace(**same)
