"""The benchmark's inputs come from their seeds alone."""

import numpy as np
import pytest

from misdp_bench import harness
from misdp_bench.instances import Instance, cls_arrays


def test_instances_repeat_from_their_seed():
    a1, b1 = cls_arrays(16, 42, 4, 6)
    a2, b2 = cls_arrays(16, 42, 4, 6)
    assert np.array_equal(a1, a2) and np.array_equal(b1, b2)
    assert not np.array_equal(b1, cls_arrays(16, 42, 4, 7)[1])


@pytest.mark.parametrize("size", [(10, 20, 3, 1), (16, 42, 4, 5),
                                  (16, 42, 4, 7), (64, 128, 12, 5)])
def test_frozen_generator_matches_the_package(size):
    from scipsdp_tpu_torch.models.families import cardinality_least_squares

    nf, ns, k, seed = size
    cfg = {"nfeatures": nf, "nsamples": ns, "k": k, "M": 10.0, "noise": 0.1}
    mine = Instance(cfg, seed).misdp()
    theirs = cardinality_least_squares(nf, ns, k, seed=seed)
    assert mine.name == theirs.name and mine.nvars == theirs.nvars
    for f in ("obj", "lb", "ub", "integral"):
        assert np.array_equal(getattr(mine, f), getattr(theirs, f))
    for f in ("var", "row", "col", "val", "const_row", "const_col",
              "const_val"):
        assert np.array_equal(getattr(mine.blocks[0], f),
                              getattr(theirs.blocks[0], f))
    for f in ("nrows", "beg", "ind", "val", "lhs", "rhs"):
        assert np.array_equal(np.asarray(getattr(mine.lp, f)),
                              np.asarray(getattr(theirs.lp, f)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_replay_order_is_every_call_each_pass_from_the_seed(seed):
    mod = harness.driver_module("frontier_replay")
    cfg = harness.load_json(harness.BENCH / "configs" / "cls_16.json")
    tr = harness.load_json(harness.BENCH / "traffic" / "frontier_b16.json")
    drv = mod.Driver(cfg, tr, seed, "cpu")
    orders = [drv.pass_order(p) for p in range(3)]
    again = mod.Driver(cfg, tr, seed, "cpu")
    assert all(np.array_equal(o, again.pass_order(p))
               for p, o in enumerate(orders))
    for o in orders:
        assert sorted(o) == list(range(len(tr["solves"])))
    assert not np.array_equal(orders[0], orders[1])
    assert not np.array_equal(orders[0],
                              mod.Driver(cfg, tr, seed + 1, "cpu")
                              .pass_order(0))


def test_replayed_boxes_are_the_recorded_ones():
    """The boxes rebuilt from a recorded call's fixings are those that the
    recorder accepted: the instance's box with the fixed binaries moved,
    dead slots in turbo's conflict box."""
    from misdp_bench.record_frontier import slots_of

    mod = harness.driver_module("frontier_replay")
    cfg = harness.load_json(harness.BENCH / "configs" / "cls_16.json")
    tr = harness.load_json(harness.BENCH / "traffic" / "frontier_b16.json")
    drv = mod.Driver(cfg, tr, 1, "cpu")
    drv.probs = [inst.misdp() for inst in drv.insts]
    for c, (i, fix) in zip(tr["solves"], drv.calls):
        b, lb, ub = drv.request(i, fix)
        assert lb.shape == (c["width"], drv.probs[i].nvars + 1)
        assert slots_of(drv.probs[i], b, lb, ub) == c["slots"]


def test_tree_cycle_order_is_a_permutation_from_the_seed():
    mod = harness.driver_module("tree_cycle")
    cfg = harness.load_json(harness.BENCH / "configs" / "cls_16.json")
    tr = harness.load_json(harness.BENCH / "traffic" / "tree_b16.json")
    orders = {tuple(mod.Driver(cfg, tr, s, "cpu").order) for s in range(12)}
    assert all(sorted(o) == [0, 1, 2] for o in orders)
    assert len(orders) > 1
    assert mod.Driver(cfg, tr, 5, "cpu").order == \
        mod.Driver(cfg, tr, 5, "cpu").order
