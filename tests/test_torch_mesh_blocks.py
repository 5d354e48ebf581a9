"""The port's "blocks" axis over distinct devices against the JAX
package's ("nodes", "blocks") mesh on the CPU.

A split bucket's sub-buckets sit on distinct entries of a mesh row
(``make_mesh(n, device="cpu")``: cpu:0, cpu:1, ..., one CPU to torch), and
``ops/ipm.ipm_steps`` brings their partial sums and W features to the
row's first (home) entry through ``to_device``.  The sums are combined
there in bucket order, so the split over distinct entries computes bit
for bit what the same split over repeated entries computes, and every
cross-device move is counted.  Two problems: the two-block problem of
test_torch_parallel.py, and the truss ``truss_topology(8, 4, seed=1)``
(one bucket of four 5 x 5 blocks, split 2 + 2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bbcases import torch_one_thread  # noqa: F401
from _torch_parity import node_boxes, pinned, port_data
from scipsdp_tpu.core.branchbound import solve_misdp as jax_solve_misdp
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models.problem import densify as jdensify
from scipsdp_tpu.ops import ipm as jipm
from scipsdp_tpu.parallel import mesh as jmesh
from scipsdp_tpu.utils.config import BBSettings, IPMSettings, Settings
from scipsdp_tpu_torch.core import branchbound as tbb
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax
from scipsdp_tpu_torch.ops import ipm as tipm
from scipsdp_tpu_torch.parallel import mesh as tmesh
from scipsdp_tpu_torch.utils.config import IPMSettings as TorchIPMSettings
from test_torch_parallel import (DOBJ_BAR, reorder_moves,  # noqa: F401
                                 two_block_prob)

B = 8
AXES = ("nodes", "blocks")
PROBLEMS = {"two_block": two_block_prob,
            "truss": lambda: jfam.truss_topology(8, 4, seed=1)}
# the port's tiers; JAX runs the refine tier as its CPU tests pin it
# (float64 einsums, no fused kernels: test_torch_ipm_refine.py), held at
# that file's bars (5e-6, iterations within 2)
TIERS = {"f64": pinned("eigh"),
         "refine": dict(phase32="refine", step_rule="probe",
                        use_lanes_chol=False, use_df32="on",
                        fused_direction="on")}
JAX_TIERS = {"f64": pinned("eigh"),
             "refine": dict(TIERS["refine"], use_df32="off",
                            fused_direction="off")}
BARS = {"f64": (DOBJ_BAR, 0), "refine": (5e-6, 2)}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def case(request):
    prob = PROBLEMS[request.param]()
    jdata = jipm.build_ipm_data(jdensify(prob))
    return request.param, prob, jdata, port_data(jdata)


def test_split_buckets_placed(case):
    """The truss's four blocks are one bucket, split 2 + 2 over a row;
    the two-block problem's bucket 1 + 1."""
    name, _, _, tdata = case
    solver = tmesh.ShardedIPM(tdata, tmesh.make_mesh(8, AXES, device="cpu"))
    per = 2 if name == "truss" else 1
    assert [a.shape[0] for a in tdata.A] == [2 * per]
    assert [a.shape[0] for a in solver.shards[0].A] == [per, per]
    assert solver.shards[1].places == (torch.device("cpu", 2),
                                       torch.device("cpu", 3))
    assert solver.shards[1].device == torch.device("cpu", 2)


def _fields_equal(a, b):
    for name in tipm.SolveOutput._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, tuple):
            assert len(x) == len(y)
            assert all(torch.equal(u, v) for u, v in zip(x, y)), name
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_distinct_equals_repeated_and_jax(case, tier,
                                          torch_one_thread):  # noqa: F811
    """A (4, 2) mesh of distinct CPU entries against the same split over
    repeated entries, cold and with warm starts (warm_X and the analytic
    centres of ip_point go to their sub-bucket's entry): every output
    equal bit for bit.  The cold solve against JAX's sharded_solver on
    its (4, 2) mesh: statuses equal, iterations and dobj within the
    tier's bars."""
    name, prob, jdata, tdata = case
    s = TorchIPMSettings(**TIERS[tier])
    b, lb, ub = node_boxes(prob, B, seed=2)
    distinct = tmesh.sharded_solver(tdata, s,
                                    tmesh.make_mesh(8, AXES, device="cpu"))
    repeated = tmesh.sharded_solver(tdata, s, tmesh.make_mesh(
        8, AXES, devices=["cpu"] * 8))
    cold = distinct(b, lb, ub)
    _fields_equal(cold, repeated(b, lb, ub))
    rng = np.random.default_rng(1)
    extra = dict(warm_y=cold.y.numpy()[::-1].copy(),
                 warm_mask=np.arange(B) % 3 != 0,
                 warm_X=tuple(x.numpy()[::-1].copy() for x in cold.X),
                 gaptol_vec=np.linspace(1e-6, 1e-5, B),
                 ip_point=(cold.y[0].numpy(), [x[0].numpy() + 0.1 * np.eye(
                     x.shape[-1]) * rng.random() for x in cold.X]))
    _fields_equal(distinct.func(tdata, b, lb, ub, settings=s, **extra),
                  repeated.func(tdata, b, lb, ub, settings=s, **extra))
    jout = jmesh.sharded_solver(jdata, IPMSettings(**JAX_TIERS[tier]),
                                jmesh.make_mesh(8, AXES))(
        jnp.asarray(b), jnp.asarray(lb), jnp.asarray(ub))
    bar, iters_tol = BARS[tier]
    np.testing.assert_array_equal(cold.status.numpy(),
                                  np.asarray(jout.status))
    assert abs(cold.iters - int(jout.iters)) <= iters_tol
    jd = np.asarray(jout.dobj)
    assert np.all(np.abs(cold.dobj.numpy() - jd) <= bar * (1 + abs(jd)))


# ipm_steps' moves an iteration for ONE bucket away from home in the
# float64 tier with the eigh rule: the W features, and per Newton
# direction (predictor, corrector) the rhs sum home and dy into the
# bucket (4); the affine step lengths home, the affine step into the
# bucket and its gap home (3); sigma*mu into the bucket (1); the step
# lengths home (1); the NaN check home, the steps and the active mask into
# the bucket (3); evaluate: y into the bucket, A*X, the gap, <C, X> and the
# residual's max home (5)
MOVES_PER_ITERATION = 1 + 4 + 3 + 1 + 1 + 3 + 5


@pytest.mark.parametrize("rows", [1, 2])
def test_moves_per_iteration(case, rows, monkeypatch,
                             torch_one_thread):  # noqa: F811
    """Rows of [cpu:2i, cpu:2i+1], each with one sub-bucket away from
    home: every iteration moves MOVES_PER_ITERATION tensors a row through
    ``to_device`` and the rows' flags once each, and the outputs equal
    the unsplit ipm_solve's (float64 tier: the reorder is bit-neutral on
    these inputs, or reorder_moves' tests would say otherwise)."""
    _, prob, _, tdata = case
    s = TorchIPMSettings(**pinned("eigh"))
    b, lb, ub = node_boxes(prob, B, seed=4)
    solve = tmesh.sharded_solver(tdata, s,
                                 tmesh.make_mesh(2 * rows, AXES, device="cpu"))
    moved, reads = [], []
    orig_move, orig_lockstep = tipm.to_device, tmesh.lockstep

    def spy_move(x, d):
        moved.append((tuple(x.shape), x.dtype.itemsize))
        return orig_move(x, d)

    def spy_lockstep(steppers, combine):
        def counted(flags):
            reads.append(len(moved))
            return combine(flags)
        return orig_lockstep(steppers, counted)

    monkeypatch.setattr(tipm, "to_device", spy_move)
    monkeypatch.setattr(tmesh, "to_device", spy_move)
    monkeypatch.setattr(tmesh, "lockstep", spy_lockstep)
    out = solve(b, lb, ub)
    assert len(reads) == out.iters + 1
    assert np.all(np.diff(reads) == rows * (MOVES_PER_ITERATION + 1))
    ref = tipm.ipm_solve(tdata, b, lb, ub, settings=s)
    assert (out.iters, out.f64_iters) == (ref.iters, ref.f64_iters)
    assert torch.equal(out.status, ref.status)
    torch.testing.assert_close(out.dobj, ref.dobj, rtol=0,
                               atol=1e-12 * (1 + ref.dobj.abs().max()))


def _truss():
    return jfam.truss_topology(8, 4, seed=1)


# (instance, mesh_devices): (1, 2) and (2, 2) meshes, the host loop; the
# two-block problem at 4 and turbo over the blocks axis are in
# test_torch_parallel.py::test_bb_mesh_matches_jax
BB_BLOCKS = [(two_block_prob, 2), (_truss, 2), (_truss, 4)]


@pytest.mark.parametrize("make,ndev", BB_BLOCKS, ids=[
    f"{'truss' if f is _truss else 'two_block'}-{n}" for f, n in BB_BLOCKS])
def test_bb_blocks_over_distinct_devices(make, ndev, monkeypatch, request,
                                         torch_one_thread):  # noqa: F811
    """solve_misdp(use_mesh=True, mesh_devices=n) in both packages, the
    port's solver on the CPU as if on n cards (``torch.cuda.device_count``
    answering n): ("nodes", "blocks") meshes whose rows hold distinct
    entries.  Every BBStats counter equal.  The two-block tree's IPM
    iterations equal JAX's less the moves of the port's split sums
    (``reorder_moves``: none here).  The truss tree's rung rounds (a
    penalty rung after a direct solve) hold a slot that stalls: stall
    detection reads a merit that makes no progress, so the batch's
    iteration count may differ by up to 2 a rung round, between JAX's
    own split and unsplit solves as well
    (tests/test_torch_turbo_bb.py::test_turbo_on_with_a_stalled_slot); a
    reordered sum there can move the count either way, so the reversal
    rule of ``reorder_moves`` does not apply."""
    moves = (request.getfixturevalue("reorder_moves")
             if make is two_block_prob else None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: ndev)
    jp = make()
    s = Settings(use_mesh=True, mesh_devices=ndev, bb=BBSettings(
        batch_size=8, turbo="off", heuristic_rand=False),
        ipm=IPMSettings(**pinned("eigh")))
    jr = jax_solve_misdp(jp, s)
    tr = tbb.solve_misdp(problem_from_jax(jp), settings_from_jax(s),
                         device="cpu")
    assert tr.status.name == jr.status.name == "OPTIMAL"
    assert abs(tr.objval - jr.objval) <= 1e-6 * (1 + abs(jr.objval))
    skip = ("wall_time", "solve_time", "prop_times", "ipm_iterations")
    ja, ta = dataclasses.asdict(jr.stats), dataclasses.asdict(tr.stats)
    assert {k: ta[k] for k in ja if k not in skip} == \
        {k: v for k, v in ja.items() if k not in skip}
    diff = ta["ipm_iterations"] - ja["ipm_iterations"]
    if moves is None:
        rung_rounds = ja["solver_calls"] - ja["relax_solves"]
        assert rung_rounds > 0
        assert abs(diff) <= 2 * rung_rounds
    else:
        assert moves == [0] * ja["relax_solves"]
        assert diff == sum(moves)
