"""The arithmetic of the metric readers and of the trace reductions."""

import pytest

from misdp_bench import harness, profiling, records


def read(name, rec):
    return harness.read_metrics([{"name": name, "unit": "u"}], rec).get(
        name, {}).get("value")


def test_time_to_opt_weighs_every_instance_the_same():
    trees = [{"instance": 0, "wall_s": 1.0}, {"instance": 0, "wall_s": 3.0},
             {"instance": 0, "wall_s": 2.0}, {"instance": 1, "wall_s": 10.0},
             {"instance": 2, "wall_s": 4.0}, {"instance": 2, "wall_s": 6.0}]
    # instance means 2, 10, 5: their mean, not the mean of the six walls
    assert read("time_to_opt_s", {"trees": trees}) == pytest.approx(17 / 3)
    assert records.per_instance_mean(trees, "wall_s") == pytest.approx(17 / 3)


def test_relax_rate_counts_solved_slots_over_the_window():
    rec = {"window_s": 4.0, "solves": [
        {"solved": 128, "slots": 128, "iters": 18, "wall_s": 2.0},
        {"solved": 126, "slots": 128, "iters": 20, "wall_s": 2.0}]}
    assert read("relax_per_s", rec) == pytest.approx(254 / 4.0)
    assert read("ipm_iters.relax", rec) == pytest.approx(19.0)
    assert read("time_to_opt_s", rec) is None


def test_chol_lanes_bytes_from_its_shape():
    # (B, K, n, n) float32: the lower triangle read, the factor written
    n = 129
    assert profiling.chol_lanes_bytes((128, 10, n, n), 4) == \
        128 * 10 * (n * (n + 1) // 2 + n * n) * 4
    assert profiling.chol_lanes_bytes((3, 5, 5), 8) == 3 * (15 + 25) * 8


def test_chol_roofline_from_bytes_and_kernel_time():
    prof = {"chol_kernels": 4, "chol_kernel_s": 2e-3, "busy_s": 1.0,
            "wall_s": 2.0, "kernels": 100}
    rec = {"solves": [], "profile": prof, "chol_calls": 4,
           "chol_bytes": 3.35e12 * 1e-3}
    assert read("chol_lanes_roofline.relax", rec) == pytest.approx(50.0)
    # a renamed kernel (none found) or a count that differs: nothing
    assert read("chol_lanes_roofline.relax",
                {**rec, "profile": {**prof, "chol_kernels": 0}}) is None
    assert read("chol_lanes_roofline.relax", {**rec, "chol_calls": 5}) is None


def test_idle_and_launches_per_iteration():
    rec = {"trees": [{"instance": 0, "wall_s": 1.0}],
           "profile": {"busy_s": 0.25, "wall_s": 1.0, "kernels": 900},
           "profile_iters": 3}
    assert read("device_idle.tree", rec) == pytest.approx(75.0)
    assert read("launches_per_iter.tree", rec) == pytest.approx(300.0)
    assert read("device_idle.relax", rec) is None
    assert read("device_idle.tree", {"trees": []}) is None


def test_busy_is_the_union_of_device_intervals():
    assert profiling.union_seconds([(0, 10), (5, 20), (30, 40)]) == \
        pytest.approx(30e-6)
    assert profiling.union_seconds([]) == 0.0


def test_idle_gaps_labelled_by_the_innermost_host_event():
    dev = [(0, 10, "k1"), (20, 30, "k2"), (100, 110, "k3")]
    host = [(0, 200, "outer"), (15, 50, "inner")]
    gaps = profiling.idle_gaps(dev, host)
    assert set(gaps) == {"outer", "inner"}
    assert gaps["outer"] == pytest.approx(10e-6)
    assert gaps["inner"] == pytest.approx(70e-6)
    assert profiling.top(gaps, 1)[0][0] == "inner"
