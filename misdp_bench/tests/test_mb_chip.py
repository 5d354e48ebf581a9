"""On the card: a short run of every cell comes out correct, with the
metrics BENCHMARK.json gives it (run on the chip with
``python -m pytest misdp_bench/tests -m chip``)."""

import json
import subprocess
import sys

import pytest

from misdp_bench import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload, trace):
    res = subprocess.run(
        [sys.executable, "misdp_bench/run.py", "--workload", workload,
         "--seed", "4242424242", "--seconds", "5", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in harness.metrics_for(SPEC, workload,
                                                   bool(trace))}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
