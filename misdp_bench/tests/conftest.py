"""Tests of the benchmark harness.  CPU tests run anywhere; tests marked
``chip`` need a CUDA card and skip without one (decided in the ``card``
fixture, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# a cell kept ready for BENCHMARK.json (PERF.md, open questions): its
# files are the harness's and are tested with the listed cells
READY = [{"name": "cls16.tree.b16", "config": "cls_16",
          "traffic": "tree_b16", "chips": 1}]


def cells():
    """Every cell of BENCHMARK.json, and the ready ones, as (entry, traffic
    kind): at the source's sizes the CPU runs each whole in seconds."""
    from misdp_bench import harness

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    return [(w, harness.cell_files(w)[2]["kind"])
            for w in spec["workloads"] + READY]


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
