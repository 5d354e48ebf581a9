"""A run's last line, its exits without a result, and its check seeing
faults planted under the timed path (``misdp_bench/faults.py``): each
cell at its own configuration and mix, past its look for a card, on the
CPU and, marked ``chip``, on the card."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from misdp_bench import harness
from misdp_bench.faults import FAULTS, run_with_fault
from misdp_bench.tests.conftest import cells

ROOT = Path(__file__).resolve().parents[2]
CELLS = cells()
SEED = 2**31 + 12345


def name(entry):
    return entry["name"] if isinstance(entry, dict) else None


@pytest.mark.parametrize("entry", [c for c, _ in CELLS], ids=name)
def test_sound_run_is_correct_and_keys_are_in_order(entry):
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell, cfg, tr = harness.cell_files(entry)
    wanted = harness.metrics_for(spec, cell["name"], False)
    out = harness.run_cell(cell, cfg, tr, SEED, 0.0, False, "cpu",
                           time.perf_counter())
    line = harness.result_line(out, harness.read_metrics(wanted,
                                                         out["rec"]), False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {m["name"] for m in wanted}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


FAULT_CASES = [(c, f.__name__) for c, kind in CELLS
               for _, _, f in FAULTS[kind]]


@pytest.mark.parametrize("entry,fault", FAULT_CASES, ids=name)
def test_faults_are_not_correct(entry, fault):
    assert run_with_fault(entry, fault, SEED)["correct"] is False


@pytest.mark.chip
@pytest.mark.parametrize("entry,fault", FAULT_CASES, ids=name)
def test_faults_are_not_correct_on_the_card(card, entry, fault):
    assert run_with_fault(entry, fault, SEED, device=card)[
        "correct"] is False


def run_cli(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "misdp_bench/run.py", "--workload",
         CELLS[0][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_enough_cards(card_absent):
    res = run_cli(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "misdp_bench", tmp_path / "misdp_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run_cli(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
