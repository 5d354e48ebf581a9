"""The plain reference against brute force."""

import itertools

import numpy as np
import pytest

from misdp_bench.instances import cls_arrays
from misdp_bench.reference import cls_reference as ref


def brute_force(A, b, k):
    best = (float(b @ b), [])
    for r in range(1, k + 1):
        for S in itertools.combinations(range(A.shape[1]), r):
            best = min(best, (ref.rss(A, b, S)[0], list(S)))
    return best


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_best_subset_is_the_brute_force_optimum(seed):
    A, b = cls_arrays(10, 20, 3, seed)
    val, sup, nodes = ref.best_subset(A, b, 3, 10.0)
    bval, bsup = brute_force(A, b, 3)
    assert val == pytest.approx(bval, rel=1e-12, abs=1e-14)
    assert sup == bsup
    assert nodes < sum(1 for r in range(4)
                       for _ in itertools.combinations(range(10), r))


def test_node_value_is_least_squares_on_the_features_left():
    A, b = cls_arrays(64, 128, 12, 5)
    free = ref.node_value(A, b, 12, 10.0, {})
    assert free == pytest.approx(ref.rss(A, b, range(64))[0], rel=1e-14)
    zfix = {3: 0, 17: 1, 40: 0}
    val = ref.node_value(A, b, 12, 10.0, zfix)
    kept = [j for j in range(64) if j not in (3, 40)]
    assert val == pytest.approx(ref.rss(A, b, kept)[0], rel=1e-14)
    assert val >= free
    assert ref.node_value(A, b, 2, 10.0, {0: 1, 1: 1, 2: 1}) is None


def test_node_value_with_k_ones_keeps_only_them():
    A, b = cls_arrays(10, 20, 3, 1)
    val = ref.node_value(A, b, 3, 10.0, {0: 1, 4: 1, 2: 1, 7: 0})
    assert val == pytest.approx(ref.rss(A, b, [0, 2, 4])[0], rel=1e-14)
    assert val == min(brute_force_within(A, b, [0, 2, 4]))


def brute_force_within(A, b, S):
    return [ref.rss(A, b, T)[0] for r in range(len(S) + 1)
            for T in itertools.combinations(S, r)]


def test_node_value_refuses_a_binding_box_or_budget():
    A, b = cls_arrays(10, 20, 3, 1)
    with pytest.raises(ref.Undecided):
        ref.node_value(A, b, 3, 0.05, {0: 1})


def test_incumbent_violation():
    A, b = cls_arrays(10, 20, 3, 1)
    val, sup, _ = ref.best_subset(A, b, 3, 10.0)
    y = np.zeros(21)
    y[sup] = ref.rss(A, b, sup)[1]
    y[[10 + j for j in sup]] = 1.0
    y[20] = val
    assert ref.incumbent_violation(A, b, 3, 10.0, y) < 1e-12
    assert ref.support_value(A, b, 3, 10.0, y[10:20]) == pytest.approx(val)
    bad = y.copy()
    bad[10 + sup[0]] = 0.0          # x_j nonzero with z_j = 0
    assert ref.incumbent_violation(A, b, 3, 10.0, bad) > 1e-3
    bad = y.copy()
    bad[20] = 0.9 * val             # t below the residual
    assert ref.incumbent_violation(A, b, 3, 10.0, bad) > 1e-3
    bad = y.copy()
    bad[10:20] = 1.0                # more than k binaries at 1
    assert ref.incumbent_violation(A, b, 3, 10.0, bad) >= 7
    assert ref.support_value(A, b, 3, 10.0, bad[10:20]) is None


def test_float32_control_moves_the_values():
    A, b = cls_arrays(48, 96, 10, 6)
    v64 = ref.best_subset(A, b, 10, 10.0)[0]
    v32 = ref.best_subset(A, b, 10, 10.0, np.float32)[0]
    assert 1e-8 < abs(v32 - v64) / (1 + v64) < 1e-5
