"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from misdp_bench import harness

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "misdp_bench" / "reference"


def test_names_are_compared_whole():
    assert harness.forbidden_modules(["scipsdp_tpu_torch",
                                      "scipsdp_tpu_torch.ops.ipm"]) == []
    assert harness.forbidden_modules(["scipsdp_tpu.ops.ipm", "numpy"]) == \
        ["scipsdp_tpu"]
    assert harness.forbidden_modules(["jax._src.core", "jaxlib", "flax"]) \
        == ["flax", "jax", "jaxlib"]
    assert harness.forbidden_modules(["jaxtyping", "flaxen"]) == []


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_sources_import_numpy_only(path):
    assert top_level_imports(path) <= {"__future__", "numpy"}


def loaded_after(code: str) -> list:
    """Top-level module names loaded by ``code`` in a fresh interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split"
         "('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    names = loaded_after("import misdp_bench.reference.cls_reference")
    assert not set(names) & {"scipsdp_tpu_torch", "scipsdp_tpu", "jax",
                             "jaxlib", "flax", "torch"}


def test_a_cpu_run_of_each_cell_loads_no_jax():
    code = (
        "import time, torch\n"
        "from misdp_bench import harness\n"
        "from misdp_bench.tests.conftest import cells\n"
        "for w, _ in cells():\n"
        "    cell, cfg, tr = harness.cell_files(w)\n"
        "    harness.run_cell(cell, cfg, tr, 1, 0.0, False, 'cpu',\n"
        "                     time.perf_counter())\n")
    names = loaded_after(code)
    assert "scipsdp_tpu_torch" in names
    assert not set(names) & {"scipsdp_tpu", "jax", "jaxlib", "flax"}
