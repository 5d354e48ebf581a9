"""The benchmark's reading of the program's own spans (``spans.py`` and the
five readers): their arithmetic on synthetic records, ``idle_by_span``'s
labels, the span passes on the CPU with the device trace stubbed, and a
program without the tracer (the parent commit's), against which nothing is
run or added and the readers find nothing.  Marked ``chip``: over one pass
on the card the program counts the syncs that CUDA's sync debug mode
sees."""

import collections
import sys

import pytest

from misdp_bench import harness, profiling, spans

NEW = ("program_syncs_per_solve.relax", "sync_wait_ms.relax",
       "solve_setup_ms.relax", "iter_dispatch_ms.relax",
       "idle_in_iter.relax")
MS = 1_000_000        # ns


def read(name, rec):
    return harness.read_metrics([{"name": name, "unit": "u"}], rec).get(
        name, {}).get("value")


def sp(name, start, end, id_, parent, solve, **attrs):
    return {"name": name, "start_ns": start * MS, "end_ns": end * MS,
            "id": id_, "parent": parent, "solve": solve, "attrs": attrs}


# two solves: set-up 4 and 2 ms; three iterations of 10, 10 (3 of it a
# sync inside) and 20 ms; syncs of 1 (input copy), 3, 2, 2 and 1 ms
SPANS = [
    sp("ipm.solve", 0, 40, 0, None, 0, steppers=1),
    sp("ipm.setup", 0, 4, 1, 0, 0),
    sp("ipm.sync", 1, 2, 2, 1, 0, site="inputs"),
    sp("ipm.iter", 5, 15, 3, 0, 0, it=0),
    sp("ipm.sync", 16, 18, 4, 0, 0, site="flags"),
    sp("ipm.iter", 20, 30, 5, 0, 0, it=1),
    sp("ipm.sync", 22, 25, 6, 5, 0, site="eigvalsh"),
    sp("ipm.solve", 50, 80, 7, None, 7, steppers=1),
    sp("ipm.setup", 50, 52, 8, 7, 7),
    sp("ipm.iter", 55, 75, 9, 7, 7, it=0),
    sp("ipm.sync", 76, 78, 10, 7, 7, site="flags"),
]


def test_readers_of_the_span_pass():
    rec = {"spans": SPANS,
           "syncs_by_site": {"inputs": 1, "flags": 2, "eigvalsh": 1},
           "idle_by_span": {"window_s": 0.5, "busy_s": 0.1,
                            "labels": {"ipm.iter": 0.3, "outside": 0.1}}}
    assert read("program_syncs_per_solve.relax", rec) == pytest.approx(2.0)
    assert read("sync_wait_ms.relax", rec) == pytest.approx(8 / 2)
    assert read("solve_setup_ms.relax", rec) == pytest.approx(6 / 2)
    # self times 10, 10 - 3 and 20
    assert spans.self_ns(SPANS)[5] == pytest.approx(7 * MS)
    assert read("iter_dispatch_ms.relax", rec) == pytest.approx(37 / 3)
    assert read("idle_in_iter.relax", rec) == pytest.approx(60.0)


def test_idle_by_span_labels_the_innermost_open_span():
    dev = [(10, 20), (30, 40), (35, 60), (100, 110), (210, 220)]
    progs = [{"name": "ipm.solve", "start_ns": 0, "end_ns": 200},
             {"name": "ipm.iter", "start_ns": 25, "end_ns": 80}]
    got = spans.idle_by_span(dev, progs, 0, 250)
    # [0, 10) and [20, 30) in the solve; [60, 100) began in the
    # iteration; [110, 210) began in the solve; [220, 250) outside
    assert got == pytest.approx({"ipm.solve": 120e-9, "ipm.iter": 40e-9,
                                 spans.OUTSIDE: 30e-9})
    assert sum(got.values()) == pytest.approx(
        (250 - spans.union_ns(dev)) * 1e-9)
    # a window that ends inside a record, one that holds none
    assert spans.idle_by_span(dev, progs, 0, 15) == pytest.approx(
        {"ipm.solve": 10e-9})
    assert spans.idle_by_span([], [], 0, 5) == pytest.approx(
        {spans.OUTSIDE: 5e-9})


@pytest.fixture
def replay():
    """The cell's driver set up on the CPU."""
    cell, cfg, tr = harness.find_cell("cls16.relax.frontier")
    drv = harness.driver_module(tr["kind"]).Driver(cfg, tr, 2**33 + 1,
                                                   "cpu")
    drv.setup()
    return drv


def test_span_passes_on_the_cpu(replay, monkeypatch):
    """Both passes run and are judged; the iterations' spans match the
    solves' iterations; the stubbed device trace's idle is split whole."""
    def one_record_a_ms(fn):
        import time
        t0 = time.perf_counter_ns()
        fn()
        t1 = time.perf_counter_ns()
        off = time.time_ns() - time.perf_counter_ns()
        return ([(t + off, t + off + MS // 4)
                 for t in range(t0 + MS // 2, t1 - MS, MS)], t0, t1)

    monkeypatch.setattr(spans, "device_records", one_record_a_ms)
    first = len(replay.solves)
    out = spans.span_passes(replay)
    npass = len(replay.calls)
    assert len(replay.solves) == first + 2 * npass
    assert len(out["span_solves"]) == npass
    assert spans.count(out["spans"], "ipm.solve") == npass
    assert spans.count(out["spans"], "ipm.iter") == sum(
        s["iters"] for s in out["span_solves"])
    assert out["syncs_by_site"]["inputs"] == 3 * npass
    idle = out["idle_by_span"]
    assert idle["outside_window"] == 0
    assert sum(idle["labels"].values()) == pytest.approx(
        idle["window_s"] - idle["busy_s"], rel=1e-9)
    for name in NEW:
        assert read(name, out) is not None
    attempted, failed, checks = replay.check()
    assert failed == 0 and checks["unsolved"][0] == 0


def test_parent_program_adds_nothing(monkeypatch):
    """Without the program's tracer the span passes run no solve and add
    no key, and the new readers find nothing in the record."""
    import scipsdp_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "scipsdp_tpu_torch.utils.trace", None)
    assert spans.tracer() is None

    class NoPass:
        solves = []

        def run_pass(self):
            raise AssertionError("a pass ran")

    assert spans.span_passes(NoPass()) == {}
    rec = {"setup_s": 1.0, "setup_parts": {}, "window_s": 1.0,
           "solves": [{"wall_s": 0.1, "iters": 10, "slots": 8,
                       "solved": 8}],
           "profile": {"wall_s": 1.0, "busy_s": 0.1, "kernels": 8000},
           "profile_iters": 10, "syncs": 16, "sync_solves": 1}
    for name in NEW:
        assert read(name, rec) is None


@pytest.mark.chip
def test_program_counts_the_syncs_cuda_sees(card):
    """Over one pass of the cell on the card, the program's own count of
    host syncs equals CUDA sync debug mode's (the program's lines)."""
    from scipsdp_tpu_torch.utils import trace

    cell, cfg, tr = harness.find_cell("cls16.relax.frontier")
    drv = harness.driver_module(tr["kind"]).Driver(cfg, tr, 2**33 + 3, card)
    drv.setup()
    with profiling.sync_sites() as sites, trace.recording() as rec:
        drv.run_pass()
    assert sum(rec.syncs.values()) == len(sites), (
        dict(rec.syncs), dict(collections.Counter(sites)))
