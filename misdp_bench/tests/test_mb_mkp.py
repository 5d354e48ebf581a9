"""The min-k-partition cell: its files found by name, a short CPU window of
its driver at small test configurations (built here, not config files)
judged correct, faults planted under the timed path judged not correct,
the program's new span attribute read, and no JAX module loaded."""

import ast
import contextlib
import io
import json
import time
from pathlib import Path

import pytest

from misdp_bench import faults, harness, schur_flops, spans
from misdp_bench.record_frontier_rungs import record
from misdp_bench.tests.test_mb_imports import loaded_after

ROOT = Path(__file__).resolve().parents[2]
CELL = "mkp49.relax.frontier"
OPTIMAL, INFEASIBLE, FAILED = 1, 2, 5      # SolverResultStatus
SEED = 2**31 + 23


def small(rows: int, seeds: list) -> tuple:
    """(cell, config, traffic) of the cell's family on rows x rows tori:
    the configuration's guarantees, the mix recorded here on the CPU at
    the cell's batch size (each tree's first 4 rounds, or its first 2 at
    width 16, as the cell's own)."""
    cfg = harness.load_json(harness.BENCH / "configs" / "mkp_t2g7_k3.json")
    cfg = {**cfg, "rows": rows, "cols": rows, "instance_seeds": seeds}
    with contextlib.redirect_stderr(io.StringIO()):
        solves, _ = record(cfg, 16, "cpu", wide_rounds=2, max_rounds=4)
    traffic = {**harness.load_json(harness.BENCH / "traffic"
                                   / "mkp_frontier_b16.json"),
               "solves": solves}
    cell = {"name": f"mkp{rows * rows}.test", "config": "x",
            "traffic": "y", "chips": 1}
    return cell, cfg, traffic


@pytest.fixture(scope="module")
def torus3():
    return small(3, [1, 2, 3])


@pytest.fixture(scope="module")
def torus4():
    return small(4, [1])


def run(setup, fault=None):
    cell, cfg, traffic = setup
    ctx = (faults.planted("ipm", "ipm_solve", fault) if fault
           else contextlib.nullcontext())
    with ctx:
        out = harness.run_cell(cell, cfg, traffic, SEED, 0.0, False, "cpu",
                               time.perf_counter())
    return harness.result_line(out, {}, False)


def test_the_cell_resolves():
    cell, cfg, traffic = harness.find_cell(CELL)
    assert cell["config"] == cfg["name"] == "mkp_t2g7_k3"
    assert traffic["kind"] == "frontier_rungs"
    assert (harness.BENCH / "drivers" / "frontier_rungs.py").exists()
    rungs = {c["rung"] for c in traffic["solves"]}
    assert rungs == {"direct", "probe", "penalty"}
    n = cfg["rows"] * cfg["cols"]
    assert all(len(c["slots"]) == c["width"] for c in traffic["solves"])
    assert all(t < n * (n - 1) // 2 for c in traffic["solves"]
               for s in c["slots"] if s for t, _ in s)


def test_replayed_calls_are_the_recorded_ones(torus3):
    """The recorder accepts a call only where the traffic driver's
    rebuilding gives it back exactly; a recorded mix replays to the same
    slots."""
    from misdp_bench.record_frontier_rungs import slots_of

    _, cfg, traffic = torus3
    drv = harness.driver_module("frontier_rungs").Driver(cfg, traffic, 1,
                                                         "cpu")
    probs = [inst.misdp() for inst in drv.insts]
    mod = harness.driver_module("frontier_rungs")
    for c, (i, (fix, rung, gamma)) in zip(traffic["solves"], drv.calls):
        req = mod.request(probs[i], fix, rung, gamma)
        assert slots_of(probs[i], *req, mod.request) == (
            c["rung"], c["gamma"], c["slots"])


@pytest.mark.parametrize("setup", ["torus3", "torus4"])
def test_a_short_window_is_correct(setup, request):
    line = run(request.getfixturevalue(setup))
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


# the 3 x 3 trees never put a live slot in a batch's second half, where
# half_of_the_batch answers wrongly: its faults run at 4 x 4
@pytest.mark.parametrize("fault", [faults.state_unchanged,
                                   faults.half_of_the_batch,
                                   faults.alter_first_bound],
                         ids=lambda f: f.__name__)
def test_faults_are_not_correct(torus4, fault):
    assert run(torus4, fault)["correct"] is False


def rung_slots_failed(real):
    """Every probe and penalty slot (the penalty variable free) ends
    FAILED."""
    import torch

    def solve(data, b, lb, ub, *rest, **kw):
        out = real(data, b, lb, ub, *rest, **kw)
        rung = torch.as_tensor(ub[:, -1] > 0, device=out.status.device)
        return out._replace(status=torch.where(rung, FAILED, out.status))
    return solve


def unsolved_reported_infeasible(real):
    """Every slot the solve leaves unsolved is reported INFEASIBLE: a node
    feasible on the boundary only is pruned."""
    import torch

    def solve(*a, **kw):
        out = real(*a, **kw)
        return out._replace(status=torch.where(
            out.status == OPTIMAL, out.status, INFEASIBLE))
    return solve


@pytest.mark.parametrize("fault", [rung_slots_failed,
                                   unsolved_reported_infeasible],
                         ids=lambda f: f.__name__)
def test_wrong_statuses_are_not_correct(torus4, fault):
    line = run(torus4, fault)
    assert line["correct"] is False
    c = line["checks"]["unsolved"]
    assert c["value"] > c["limit"], line["checks"]


def test_schur_flops_from_the_spans():
    def sp(name, id_, solve, **attrs):
        return {"name": name, "id": id_, "solve": solve, "attrs": attrs,
                "start_ns": 0, "end_ns": 1, "parent": None}

    rec_spans = [sp("ipm.solve", 0, 0), sp("ipm.setup", 1, 0, B=8, mp=10),
                 sp("ipm.iter", 2, 0), sp("ipm.iter", 3, 0),
                 sp("ipm.solve", 4, 4), sp("ipm.setup", 5, 4, B=16, mp=4),
                 sp("ipm.iter", 6, 4)]
    want = 2 * 8 * 1000 / 3 + 16 * 64 / 3
    assert schur_flops.iteration_flops(rec_spans) == pytest.approx(want)
    rec = {"spans": rec_spans,
           "idle_by_span": {"busy_s": 2.0, "window_s": 3.0, "labels": {}}}
    got = harness.read_metrics(
        [{"name": "schur_factor_share.mkp", "unit": "%"},
         {"name": "iter_device_ms.mkp", "unit": "ms"}], rec)
    assert got["schur_factor_share.mkp"]["value"] == pytest.approx(
        100 * want / (2.0 * schur_flops.PEAK_F64_FLOPS))
    assert got["iter_device_ms.mkp"]["value"] == pytest.approx(2000 / 3)
    # a program whose set-up spans lack the Schur size (the parent's)
    for s in rec_spans:
        s["attrs"].pop("mp", None)
    assert harness.read_metrics(
        [{"name": "schur_factor_share.mkp", "unit": "%"}], rec) == {}


def test_the_traced_passes_read_the_new_metrics(torus3, monkeypatch):
    """The traffic driver's span passes on the CPU (device trace stubbed)
    give both readers something, the program's set-up spans carrying
    mp."""
    cell, cfg, traffic = torus3

    def one_record(fn):
        t0 = time.perf_counter_ns()
        fn()
        t1 = time.perf_counter_ns()
        off = time.time_ns() - time.perf_counter_ns()
        return [(t0 + off, t0 + off + (t1 - t0) // 2)], t0, t1

    monkeypatch.setattr(spans, "device_records", one_record)
    drv = harness.driver_module("frontier_rungs").Driver(cfg, traffic, 5,
                                                         "cpu")
    drv.setup()
    drv.step()
    out = spans.span_passes(drv)
    setups = [s for s in out["spans"] if s["name"] == "ipm.setup"]
    assert setups and all(s["attrs"]["mp"] == 37 for s in setups)
    got = harness.read_metrics(
        [{"name": "schur_factor_share.mkp", "unit": "%"},
         {"name": "iter_device_ms.mkp", "unit": "ms"}], out)
    assert set(got) == {"schur_factor_share.mkp", "iter_device_ms.mkp"}


def test_reference_imports_neither_the_program_nor_jax():
    path = ROOT / "misdp_bench" / "reference" / "mkp_reference.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "itertools", "numpy", "torch"}
    loaded = loaded_after("import misdp_bench.reference.mkp_reference")
    assert not set(loaded) & {"scipsdp_tpu_torch", "scipsdp_tpu", "jax",
                              "jaxlib", "flax"}


def test_a_cpu_window_loads_no_jax():
    code = (
        "import json, time, contextlib, io\n"
        "from misdp_bench import harness\n"
        "from misdp_bench.tests.test_mb_mkp import small\n"
        "cell, cfg, tr = small(3, [1])\n"
        "out = harness.run_cell(cell, cfg, tr, 1, 0.0, False, 'cpu',\n"
        "                       time.perf_counter())\n"
        "assert harness.result_line(out, {}, False)['correct']\n")
    names = loaded_after(code)
    assert "scipsdp_tpu_torch" in names and "torch" in names
    assert not set(names) & {"scipsdp_tpu", "jax", "jaxlib", "flax"}


def test_the_mix_is_written_one_call_a_line(tmp_path):
    from misdp_bench.record_frontier_rungs import write_mix

    mix = {"kind": "frontier_rungs", "limits": {},
           "solves": [{"instance": 0, "slots": [None]}] * 2}
    write_mix(tmp_path / "m.json", mix)
    text = (tmp_path / "m.json").read_text()
    assert json.loads(text) == mix and text.count("\n") == 8
