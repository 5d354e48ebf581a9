"""The port's tracer (``utils/trace.py``) inside the batched solve, on the
CPU.

* Off, nothing is recorded, and ``ipm_solve`` gives the same outputs bit
  for bit with recording on and off.
* One solve is one ``ipm.solve`` span holding one ``ipm.setup`` and one
  ``ipm.iter`` an iteration (``it`` 0 .. iters-1); the flags are read
  iters + 1 times and the numpy inputs' copies are counted; parents nest
  and every span carries the solve's id.
* A lockstep of two steppers (a mesh of two CPU entries) is one request:
  one ``ipm.solve`` and one flags read an iteration for both; the mesh's
  own copies of its inputs, made before the lockstep, are counted too.
* The spans lie on the profiler's clock once ``offset_ns`` is added.
* ``BBStats.solve_time`` under turbo is the rounds' solve time, not the
  tree's wall.
"""

import numpy as np
import pytest
import torch

from _torch_bbcases import torch_one_thread  # noqa: F401
from scipsdp_tpu_torch.core import branchbound as tbb
from scipsdp_tpu_torch.models import families
from scipsdp_tpu_torch.models.problem import densify
from scipsdp_tpu_torch.ops import ipm
from scipsdp_tpu_torch.parallel import mesh as tmesh
from scipsdp_tpu_torch.utils import trace
from scipsdp_tpu_torch.utils.config import (BBSettings, Settings,
                                            resolve_backend_autos)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

B = 4


@pytest.fixture(scope="module")
def cls():
    """(MISDP, IPMData on the CPU, the CPU's resolved IPM settings) of a
    small CLS instance."""
    prob = families.cardinality_least_squares(5, 8, 2, seed=1)
    data = ipm.build_ipm_data(densify(prob), "cpu")
    return prob, data, resolve_backend_autos(Settings(), "cpu").ipm


def boxes(prob):
    """(b, lb, ub) of B direct-mode boxes as numpy: the root, then one
    binary fixed at 0 or 1 a slot."""
    lb = np.tile(prob.lb, (B, 1))
    ub = np.tile(prob.ub, (B, 1))
    ints = np.flatnonzero(prob.integral)
    for s in range(1, B):
        j = ints[s % len(ints)]
        lb[s, j] = ub[s, j] = float(s % 2)
    zero = np.zeros((B, 1))
    b = np.concatenate([np.tile(prob.obj, (B, 1)), zero], 1)
    return (b, np.concatenate([lb, zero], 1),
            np.concatenate([ub, zero], 1))


def by_name(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_off_records_nothing_and_outputs_are_the_same(cls):
    prob, data, s = cls
    assert trace.span("ipm.solve") is trace.OFF
    assert trace.sync("flags", lambda: 7) == 7
    off = ipm.ipm_solve(data, *boxes(prob), settings=s)
    with trace.recording() as rec:
        on = ipm.ipm_solve(data, *boxes(prob), settings=s)
    assert rec.spans and trace.span("ipm.solve") is trace.OFF
    for a, b in zip(on, off):
        for x, y in zip(a if isinstance(a, tuple) else [a],
                        b if isinstance(b, tuple) else [b]):
            if isinstance(x, torch.Tensor):
                torch.testing.assert_close(x, y, rtol=0, atol=0,
                                           equal_nan=True)
            else:
                assert x == y


def test_span_tree_of_one_solve(cls):
    prob, data, s = cls
    with trace.recording() as rec:
        out = ipm.ipm_solve(data, *boxes(prob), settings=s)
    solve, = by_name(rec, trace.SOLVE)
    setup, = by_name(rec, "ipm.setup")
    iters = by_name(rec, "ipm.iter")
    assert out.iters > 0
    assert [sp.attrs["it"] for sp in iters] == list(range(out.iters))
    assert all(sp.attrs["use32"] is False for sp in iters)
    assert setup.attrs == {"B": B, "buckets": ((1, 9),), "phase32": "off"}
    assert solve.attrs == {"steppers": 1}
    # the flags once before each iteration and once to stop; the numpy
    # b, lb, ub copied in; the CPU's step rule (eigh) and the presolve
    # all-fixed check each read eigvalsh once a call
    assert rec.syncs["flags"] == out.iters + 1
    assert rec.syncs["inputs"] == 3
    assert rec.syncs["eigvalsh"] == out.iters + 1
    syncs = by_name(rec, trace.SYNC)
    assert len(syncs) == sum(rec.syncs.values())
    assert sorted({sp.attrs["site"] for sp in syncs}) == sorted(rec.syncs)
    # nesting: the solve holds the set-up and the iterations; each sync
    # lies inside its parent, and every span belongs to the solve
    spans = {sp.id: sp for sp in rec.spans}
    assert solve.parent is None
    assert setup.parent == solve.id
    assert all(sp.parent == solve.id for sp in iters)
    for sp in rec.spans:
        assert sp.solve == solve.id and sp.end_ns >= sp.start_ns
        if sp.parent is not None:
            up = spans[sp.parent]
            assert up.start_ns <= sp.start_ns <= sp.end_ns <= up.end_ns
    assert setup.end_ns <= iters[0].start_ns
    flags = [sp for sp in syncs if sp.attrs["site"] == "flags"]
    assert all(sp.parent == solve.id for sp in flags)


def test_lockstep_of_two_steppers_is_one_request(cls):
    prob, data, s = cls
    solve = tmesh.sharded_solver(data, s, tmesh.make_mesh(2, device="cpu"))
    with trace.recording() as rec:
        out = solve(*boxes(prob))
    req, = by_name(rec, trace.SOLVE)
    assert req.attrs == {"steppers": 2}
    setups = by_name(rec, "ipm.setup")
    assert [sp.attrs["B"] for sp in setups] == [B // 2, B // 2]
    assert len(by_name(rec, "ipm.iter")) == 2 * out.iters
    assert rec.syncs["flags"] == out.iters + 1
    # each row's b, lb, ub, copied in before the lockstep starts: counted,
    # and outside the request's span; everything else inside it
    assert rec.syncs["inputs"] == 2 * 3
    before = [sp for sp in rec.spans if sp.start_ns < req.start_ns]
    assert [sp.attrs for sp in before] == [{"site": "inputs"}] * 6
    assert all(sp.solve is None for sp in before)
    assert all(sp.solve == req.id for sp in rec.spans if sp not in before)


def test_nested_spans_and_an_exception_close_in_order():
    with trace.recording() as rec:
        with trace.span(trace.SOLVE) as outer:
            left_open = trace.span("ipm.setup")
            with pytest.raises(ValueError):
                with trace.span("ipm.iter", it=0):
                    raise ValueError
        after = trace.span("ipm.iter", it=1)
        after.end()
    assert left_open.end_ns == outer.end_ns
    assert after.parent is None and after.solve is None
    assert [sp.name for sp in rec.spans] == [
        trace.SOLVE, "ipm.setup", "ipm.iter", "ipm.iter"]
    with pytest.raises(RuntimeError):
        with trace.recording():
            with trace.recording():
                pass


def test_spans_lie_on_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("ipm.iter", it=0) as sp:
                with record_function("trace_clock_probe"):
                    torch.ones(16).sum()
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "trace_clock_probe"]
    assert (sp.start_ns + rec.offset_ns <= ev.start_ns()
            <= ev.end_ns() <= sp.end_ns + rec.offset_ns)


def test_turbo_solve_time_is_the_solves_not_the_tree():
    prob = families.cardinality_least_squares(6, 12, 3, seed=1)
    s = Settings(bb=BBSettings(batch_size=8, turbo="on",
                               heuristic_rand=False, node_limit=200))
    res = tbb.solve_misdp(prob, s, device="cpu")
    assert res.stats.relax_solves > 0
    assert 0.0 < res.stats.solve_time < res.stats.wall_time
