"""The port's copies of the JAX package's host modules are copies: each
one's source equals its twin's once ``scipsdp_tpu.`` reads
``scipsdp_tpu_torch.`` and the module docstrings are set aside.  The
deliberate differences are listed below, each with its reason, by the
top-level statements they touch; every other statement of those modules
is held to its twin's text.  The C++ sources are the same bytes.
"""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "scipsdp_tpu", REPO / "scipsdp_tpu_torch"

COPIES = [
    "core/branching.py", "core/presolve_sdp.py", "core/propagate.py",
    "core/propredcost.py", "core/quadupgrade.py", "core/rank1.py",
    "core/symmetry.py", "models/families.py", "models/io.py",
    "models/problem.py", "models/reader_cbf.py", "models/reader_cip.py",
    "models/reader_sdpa.py", "models/writers.py", "ops/cmir.py",
    "ops/onevar.py", "utils/paramfile.py", "utils/statistics.py",
    "utils/status.py",
]

# module -> (renames applied to the JAX text, the top-level statements
# that differ or stand in one package only, why)
DELIBERATE = {
    "native/frontier.py": (
        {}, {"import os", "import subprocess", "from pathlib import Path",
             "from scipsdp_tpu_torch.native import build_library",
             "_LIB_PATH", "_SRC_PATH", "get_frontier_lib"},
        "the library is built under build/ by native.build_library, "
        "through a temporary file, not beside the source"),
    "native/__init__.py": (
        {"get_lib": "get_sdpa_lib"},
        {"import hashlib", "from pathlib import Path", "_LIB_PATH",
         "_SRC_PATH", "_build", "library_path", "build_library",
         "get_sdpa_lib"},
        "the same: the SDPA tokenizer and the node store share the build "
        "into build/scipsdp_tpu_torch/native/<hash>/"),
}


def _body(path, renames=None):
    """The source after its module docstring, the JAX package's with its
    imports pointed at the port (and ``renames`` applied)."""
    src = path.read_text()
    if path.is_relative_to(JAX):
        src = src.replace("scipsdp_tpu.", "scipsdp_tpu_torch.")
        for old, new in (renames or {}).items():
            src = re.sub(rf"\b{old}\b", new, src)
    first = ast.parse(src).body[0]
    if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
        src = "\n".join(src.splitlines()[first.end_lineno:])
    return src


def _statements(src):
    """Top-level statement -> its source text."""
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            key = node.name
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            key = ast.unparse(node)
        elif isinstance(node, ast.Assign):
            key = ",".join(ast.unparse(t) for t in node.targets)
        else:
            key = ast.unparse(node)
        out[key] = ast.get_source_segment(src, node)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_module_is_a_copy(rel):
    assert _body(PORT / rel) == _body(JAX / rel)


@pytest.mark.parametrize("rel", sorted(DELIBERATE))
def test_module_differs_only_as_listed(rel):
    renames, differ, _ = DELIBERATE[rel]
    want = _statements(_body(JAX / rel, renames))
    got = _statements(_body(PORT / rel))
    changed = {k for k in want.keys() | got.keys()
               if want.get(k) != got.get(k)}
    assert changed == differ


@pytest.mark.parametrize("name", ["native/sdpa_parse.cpp",
                                  "native/frontier.cpp"])
def test_native_source_is_a_copy(name):
    assert (PORT / name).read_bytes() == (JAX / name).read_bytes()
