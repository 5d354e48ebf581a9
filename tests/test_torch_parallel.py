"""The port's device mesh (``scipsdp_tpu_torch/parallel/mesh.py``) against
the JAX package's on the CPU.

JAX runs its mesh over the 8 virtual CPU devices ``conftest.py`` gives it;
the port's mesh is a list of CPU entries (``make_mesh(..., device="cpu")``),
so both run the sharded code path on one CPU.  The sharded solve is held to
JAX's ``sharded_solver`` (statuses and iterations equal, dobj within
DOBJ_BAR) and to the port's own unsharded ``ipm_solve`` (equal iterations
in float64 and in the refine tier: the shards run in lockstep), and the
branch-and-bound with ``use_mesh`` to JAX's counter for counter.
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
from scipsdp_tpu.models.problem import (LinearConstraints, MISDP, SDPBlock,
                                        densify as jdensify)
from scipsdp_tpu.ops import ipm as jipm
from scipsdp_tpu.parallel import mesh as jmesh
from scipsdp_tpu.utils.config import BBSettings, IPMSettings, Settings
from scipsdp_tpu_torch.core import branchbound as tbb
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax
from scipsdp_tpu_torch.models.problem import densify as tdensify
from scipsdp_tpu_torch.ops import ipm as tipm
from scipsdp_tpu_torch.parallel import mesh as tmesh
from scipsdp_tpu_torch.utils.config import IPMSettings as TorchIPMSettings

DOBJ_BAR = 1e-7          # relative to 1 + |dobj| (ROADMAP's bar)
B = 8


def two_block_prob(m: int = 6, n: int = 4, seed: int = 3) -> MISDP:
    """min c.y over binary y with two n x n blocks
    Z_k(y) = 2 I + sum_j A_kj y_j >= 0 (A_kj symmetric, entries 0.4 N(0,
    1)): one bucket of two blocks, which a blocks axis of 2 splits."""
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(2):
        var, row, col, val = [], [], [], []
        for j in range(m):
            a = 0.4 * rng.normal(size=(n, n))
            a = a + a.T
            for r in range(n):
                for c in range(r + 1):
                    var.append(j)
                    row.append(r)
                    col.append(c)
                    val.append(a[r, c])
        blocks.append(SDPBlock(size=n, var=var, row=row, col=col, val=val,
                               const_row=list(range(n)),
                               const_col=list(range(n)),
                               const_val=[-2.0] * n))
    return MISDP(nvars=m, obj=rng.normal(size=m), lb=np.zeros(m),
                 ub=np.ones(m), integral=np.ones(m, bool), blocks=blocks,
                 lp=LinearConstraints.empty(), name="two_block")


@pytest.fixture(scope="module")
def two_block():
    prob = two_block_prob()
    jdata = jipm.build_ipm_data(jdensify(prob))
    return prob, jdata, port_data(jdata)


MESHES = {"4x2": (4, ("nodes", "blocks")), "8": (8, ("nodes",))}


@pytest.mark.parametrize("n,axes", [(8, ("nodes",)), (4, ("nodes",)),
                                    (8, ("nodes", "blocks")),
                                    (6, ("nodes", "blocks")),
                                    (3, ("nodes", "blocks"))])
def test_make_mesh_and_plans_equal_jax(two_block, n, axes):
    """The same axis layout as JAX's make_mesh, and per bucket the same
    choice of split or replicated as JAX's data_sharding, on the two-block
    problem (its one bucket splits) and on the 12 + 2 x 2 heterogeneous
    one (one bucket of one block, one of two)."""
    from test_buckets import _hetero_prob
    jm = jmesh.make_mesh(n, axes)
    tm = tmesh.make_mesh(n, axes, device="cpu")
    assert tm.devices.shape == jm.devices.shape
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    hetero = jipm.build_ipm_data(jdensify(_hetero_prob()))
    for jdata in (two_block[1], hetero):
        want = tuple(s.spec[0] for s in jmesh.data_sharding(jm, jdata).A)
        assert tmesh.data_sharding(tm, port_data(jdata)) == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_solver_matches_jax(two_block, mesh,
                                    torch_one_thread):  # noqa: F811
    """JAX's sharded_solver and the port's on the same mesh layout and
    node boxes: statuses and iterations equal, dobj within DOBJ_BAR, X in
    JAX's bucket layout (the blocks axis splits the port's bucket inside
    the solve only)."""
    prob, jdata, tdata = two_block
    n, axes = MESHES[mesh]
    kw = pinned("eigh")
    b, lb, ub = node_boxes(prob, B, seed=2)
    jout = jmesh.sharded_solver(jdata, IPMSettings(**kw),
                                jmesh.make_mesh(n, axes))(
        jnp.asarray(b), jnp.asarray(lb), jnp.asarray(ub))
    tout = tmesh.sharded_solver(tdata, TorchIPMSettings(**kw),
                                tmesh.make_mesh(n, axes, device="cpu"))(
        b, lb, ub)
    np.testing.assert_array_equal(tout.status.numpy(),
                                  np.asarray(jout.status))
    assert tout.iters == int(jout.iters)
    jd = np.asarray(jout.dobj)
    assert np.all(np.abs(tout.dobj.numpy() - jd) <= DOBJ_BAR * (1 + abs(jd)))
    assert len(tout.X) == len(jout.X)
    for tx, jx in zip(tout.X, jout.X):
        jx = np.asarray(jx)
        assert tx.shape == jx.shape
        np.testing.assert_allclose(tx.numpy(), jx, rtol=0,
                                   atol=1e-5 * (1 + np.abs(jx).max()))


TIERS = {"f64": pinned("eigh"),
         "refine": dict(phase32="refine", step_rule="probe",
                        use_lanes_chol=False, use_df32="on",
                        fused_direction="off")}


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("mesh", sorted(MESHES) + ["2"])
def test_sharded_equals_unsharded(two_block, tier, mesh,
                                  torch_one_thread):  # noqa: F811
    """The port's sharded solve against its own ipm_solve on the same
    boxes, with warm starts and per-node tolerances: equal iterations and
    float64 iterations (one global done flag and tier choice), equal
    statuses, the same bounds and X."""
    prob, _, tdata = two_block
    n, axes = MESHES.get(mesh, (2, ("nodes",)))
    s = TorchIPMSettings(**TIERS[tier])
    b, lb, ub = node_boxes(prob, B, seed=4)
    ref0 = tipm.ipm_solve(tdata, b, lb, ub, settings=s)
    extra = dict(warm_y=ref0.y.numpy()[::-1].copy(),
                 warm_mask=np.arange(B) % 3 != 0,
                 warm_X=tuple(x.numpy()[::-1].copy() for x in ref0.X),
                 gaptol_vec=np.linspace(1e-6, 1e-5, B))
    solve = tmesh.sharded_solver(tdata, s,
                                 tmesh.make_mesh(n, axes, device="cpu"))
    for kw in ({}, extra):
        ref = tipm.ipm_solve(tdata, b, lb, ub, settings=s, **kw)
        out = solve.func(tdata, b, lb, ub, settings=s, **kw)
        assert (out.iters, out.f64_iters) == (ref.iters, ref.f64_iters)
        assert torch.equal(out.status, ref.status)
        torch.testing.assert_close(out.dobj, ref.dobj, rtol=0,
                                   atol=1e-9 * (1 + ref.dobj.abs().max()))
        for ox, rx in zip(out.X, ref.X):
            torch.testing.assert_close(ox, rx, rtol=0,
                                       atol=1e-7 * (1 + rx.abs().max()))


def test_one_flag_read_per_iteration(two_block, monkeypatch,
                                     torch_one_thread):  # noqa: F811
    """Every cross-device move goes through ``to_device``: each iteration
    every shard's flags go to the first device and are read once
    (``lockstep``), and nothing else moves inside the loop."""
    prob, _, tdata = two_block
    s = TorchIPMSettings(**pinned("eigh"))
    b, lb, ub = node_boxes(prob, B, seed=4)
    solve = tmesh.sharded_solver(tdata, s, tmesh.make_mesh(4, device="cpu"))
    moved, reads = [], []
    orig_move, orig_lockstep = tmesh.to_device, tmesh.lockstep

    def spy_lockstep(steppers, combine):
        def counted(flags):
            reads.append(len(moved))
            return combine(flags)
        return orig_lockstep(steppers, counted)

    monkeypatch.setattr(tmesh, "to_device",
                        lambda x, d: moved.append(tuple(x.shape))
                        or orig_move(x, d))
    monkeypatch.setattr(tmesh, "lockstep", spy_lockstep)
    out = solve(b, lb, ub)
    assert len(reads) == out.iters + 1
    # between two reads: the four shards' flags, nothing else
    assert np.all(np.diff(reads) == 4)
    assert all(shape == (1,) for shape in moved[reads[0]:reads[-1] + 4])


def test_raises(monkeypatch):
    """make_mesh on too few cards raises naming the count, with no CPU
    fall-back; a blocks row over distinct devices runs; a batch the nodes
    axis does not divide raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="have 1"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="have 1"):
        tmesh.make_mesh(4, ("nodes", "blocks"), device="cuda")
    tdata = port_data(jipm.build_ipm_data(jdensify(two_block_prob())))
    row = tmesh.make_mesh(axes=("nodes", "blocks"),
                          devices=["cpu:0", "cpu:1"])
    b, lb, ub = node_boxes(two_block_prob(), 4)
    s = TorchIPMSettings(**pinned("eigh"))
    out = tmesh.sharded_solver(tdata, s, row)(b, lb, ub)
    assert tmesh.ShardedIPM(tdata, row).shards[0].places == tuple(
        row.devices[0])
    assert torch.equal(out.status, tipm.ipm_solve(tdata, b, lb, ub,
                                                  settings=s).status)
    solve = tmesh.sharded_solver(tdata, s, tmesh.make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="multiple"):
        solve(b, lb, ub)


def test_misdp_mesh_devices_beyond_the_cards(monkeypatch):
    """use_mesh with mesh_devices above the card count raises ValueError
    before any solve."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    prob = problem_from_jax(two_block_prob())
    with pytest.raises(ValueError, match="have 1"):
        tbb.solve_misdp(prob, settings_from_jax(Settings(
            use_mesh=True, mesh_devices=2)))


def _reversal(data, split):
    """Per bucket, the block order that reverses each split bucket."""
    return [torch.arange(a.shape[0] - 1, -1, -1) if k > 1
            else torch.arange(a.shape[0]) for a, k in zip(data.A, split)]


def _reversed(data, rev):
    """``data`` with each bucket's blocks in the order ``rev``: the same
    problem, its bucket sums taken in another order."""
    return dataclasses.replace(
        data, A=tuple(a[r] for a, r in zip(data.A, rev)),
        C=tuple(c[r] for c, r in zip(data.C, rev)),
        dimmask=tuple(m[r] for m, r in zip(data.dimmask, rev)),
        block_of=tuple((t, int(torch.nonzero(rev[t] == i)))
                       for t, i in data.block_of))


@pytest.fixture
def reorder_moves(monkeypatch):
    """Spies on every sharded solve that splits a bucket and returns the
    list of its iterations less those of the unsplit ipm_solve on the same
    inputs.  A split solve that ends apart from the unsplit one must end
    where the unsplit solve with the bucket's blocks reversed ends: the
    move comes from the order of the bucket's float64 sums alone."""
    moves, orig = [], tmesh.ShardedIPM.__call__

    def spy(self, data, b, lb, ub, Gcut=None, hcut=None, cutvalid=None,
            warm_y=None, warm_mask=None, gaptol_vec=None, warm_X=None,
            ip_point=None, feastol_vec=None, *, settings):
        args = (b, lb, ub, Gcut, hcut, cutvalid, warm_y, warm_mask,
                gaptol_vec, warm_X, ip_point, feastol_vec)
        out = orig(self, data, *args, settings=settings)
        if all(k == 1 for k in self.split):
            return out
        iters = tipm.ipm_solve(data, *args, settings=settings).iters
        if out.iters != iters:
            rev = _reversal(data, self.split)
            if warm_X is not None:
                warm_X = tuple(torch.as_tensor(x)[:, r]
                               for x, r in zip(warm_X, rev))
            if ip_point is not None:
                ip_point = (ip_point[0], [torch.as_tensor(x)[r] for x, r
                                          in zip(ip_point[1], rev)])
            again = tipm.ipm_solve(
                _reversed(data, rev), b, lb, ub, Gcut, hcut, cutvalid,
                warm_y, warm_mask, gaptol_vec, warm_X, ip_point, feastol_vec,
                settings=settings)
            assert again.iters == out.iters, (again.iters, out.iters, iters)
        moves.append(out.iters - iters)
        return out

    monkeypatch.setattr(tmesh.ShardedIPM, "__call__", spy)
    return moves


@pytest.mark.parametrize("turbo", ["off", "on"])
def test_ladder_and_tree_over_blocks_axis(two_block, turbo, reorder_moves,
                                          torch_one_thread):  # noqa: F811
    """The two-block problem over a (2, 2) mesh, whose blocks axis splits
    its bucket: the ladder with the rounding heuristics gives the unsharded
    ladder's results, and solve_misdp(use_mesh=True, mesh_devices=4) the
    tree of the same settings without a mesh, every counter equal; the IPM
    iterations differ by the moves ``reorder_moves`` finds and no more.
    The split sums the bucket's two blocks in two parts.  In turbo's fourth
    round one node's primal X grows tenfold an iteration (3 to 2.4e14, the
    solve FAILED), and the relative difference of that order, under 1e-15
    at the first iteration, grows with it: the split ends the round at 17
    iterations, the unsplit solve at 18, and the unsplit solve with the two
    blocks swapped at 17 as well."""
    from scipsdp_tpu_torch.core.sdpi import SDPInterface
    prob, jdata, _ = two_block
    tp = problem_from_jax(prob)
    s = settings_from_jax(Settings(ipm=IPMSettings(**pinned("eigh")),
                                   bb=BBSettings(batch_size=8, turbo=turbo,
                                                 turbo_rounds=8)))
    dense = tdensify(tp)
    mesh = tmesh.make_mesh(4, ("nodes", "blocks"), device="cpu")
    _, lb, ub = node_boxes(prob, B, seed=5)
    got, want = (SDPInterface(dense, s, mesh=m, device="cpu").solve_batch(
        lb[:, :-1], ub[:, :-1], rounding_seed=0) for m in (mesh, None))
    np.testing.assert_array_equal(got.status, want.status)
    np.testing.assert_allclose(got.objval, want.objval, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.round_feas, want.round_feas)
    assert [x.shape for x in got.X] == [x.shape for x in want.X]
    del reorder_moves[:]
    runs = [tbb.solve_misdp(tp, dataclasses.replace(
        s, use_mesh=um, mesh_devices=4), device="cpu") for um in (True, False)]
    assert runs[0].objval == pytest.approx(runs[1].objval, rel=1e-9)
    skip = ("wall_time", "solve_time", "prop_times", "ipm_iterations")
    got, want = ({k: v for k, v in dataclasses.asdict(r.stats).items()
                  if k not in skip} for r in runs)
    assert got == want
    assert runs[0].stats.ipm_iterations == \
        runs[1].stats.ipm_iterations + sum(reorder_moves)
    assert reorder_moves == ([0] * 3 if turbo == "off"
                             else [0, 0, 0, -1, 0])


def test_turbo_drops_a_mesh_the_batch_does_not_fit(two_block, caplog,
                                                   torch_one_thread):  # noqa: F811
    """solve_turbo with a batch its mesh's nodes axis does not divide
    logs that it drops the mesh and grows the tree without it."""
    from scipsdp_tpu_torch.core import turbo as tturbo
    tp = problem_from_jax(two_block[0])
    dense = tdensify(tp)
    s = settings_from_jax(Settings(ipm=IPMSettings(**pinned("eigh")),
                                   bb=BBSettings(batch_size=8)))
    args = (dense, tp, s, tp.lb, tp.ub, np.inf, None)
    want = tturbo.solve_turbo(*args, device="cpu")
    with caplog.at_level("WARNING", logger=tturbo.__name__):
        got = tturbo.solve_turbo(*args, mesh=tmesh.make_mesh(
            3, device="cpu"))
    assert "not a multiple of the mesh's nodes axis (3)" in caplog.text
    np.testing.assert_array_equal(got.inc_y, want.inc_y)
    # every field but the solves' host wall, a timing
    assert got._replace(inc_y=None, solve_time=0.0) == \
        want._replace(inc_y=None, solve_time=0.0)


def _cls():
    return jfam.cardinality_least_squares(nfeatures=6, nsamples=12, seed=1)


# (instance, mesh_devices, turbo); the one-block CLS keeps the ids it had
BB_MESH = [(_cls, 2, "off"), (_cls, 4, "on"), (_cls, 2, "on"),
           (_cls, 4, "off"), (two_block_prob, 4, "off"),
           (two_block_prob, 4, "on")]


@pytest.mark.parametrize("make,ndev,turbo", BB_MESH, ids=[
    ("" if f is _cls else "two_block-") + f"{n}-{t}" for f, n, t in BB_MESH])
def test_bb_mesh_matches_jax(make, ndev, turbo, reorder_moves,
                             torch_one_thread):  # noqa: F811
    """test_parallel.py's CLS (one block) and the two-block problem
    through solve_misdp(use_mesh=True, mesh_devices=n) in both packages,
    the host loop (turbo="off") and turbo (turbo="on", turbo_rounds=8,
    heuristic_rand=False); four devices make a (2, 2) mesh, whose blocks
    axis splits the two-block bucket, and round the CLS batch of 6 up to
    8.  Every BBStats counter equal; the IPM iterations differ by the
    moves of the port's split sums (``reorder_moves``: one, in the
    two-block turbo tree; JAX's split ends that solve where its unsplit
    solve does)."""
    jp = make()
    batch = 6 if make is _cls else 8
    s = Settings(use_mesh=True, mesh_devices=ndev, bb=BBSettings(
        batch_size=batch, turbo=turbo, turbo_rounds=8, heuristic_rand=False))
    if make is two_block_prob:
        s = dataclasses.replace(s, ipm=IPMSettings(**pinned("eigh")))
    jr = jax_solve_misdp(jp, s)
    tr = tbb.solve_misdp(problem_from_jax(jp), settings_from_jax(s),
                         device="cpu")
    assert tr.status.name == jr.status.name == "OPTIMAL"
    assert abs(tr.objval - jr.objval) <= 1e-6 * (1 + abs(jr.objval))
    skip = ("wall_time", "solve_time", "prop_times", "ipm_iterations")
    ja, ta = dataclasses.asdict(jr.stats), dataclasses.asdict(tr.stats)
    assert {k: ta[k] for k in ja if k not in skip} == \
        {k: v for k, v in ja.items() if k not in skip}
    assert ta["ipm_iterations"] == ja["ipm_iterations"] + sum(reorder_moves)
    assert sum(reorder_moves) == (-1 if make is two_block_prob
                                  and turbo == "on" else 0)
