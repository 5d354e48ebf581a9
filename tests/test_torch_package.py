"""Package-level checks of scipsdp_tpu_torch: it never loads JAX, and
chip_smoke.py refuses to run without a CUDA device or without the repo."""

import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "scipsdp_tpu_torch"


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _run(code, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "scipsdp_tpu_torch.ops.ipm" in mods and len(mods) >= 12
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'scipsdp_tpu.')) "
            "or m == 'scipsdp_tpu')\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = _run(code, REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_import_sets_no_torch_flags():
    """Importing the package leaves torch's global settings alone."""
    code = ("import torch\n"
            "before = (torch.get_default_dtype(), "
            "torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads())\n"
            "import scipsdp_tpu_torch.ops.ipm, scipsdp_tpu_torch.interop\n"
            "after = (torch.get_default_dtype(), "
            "torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads())\n"
            "assert before == after, (before, after)\n")
    proc = _run(code, REPO)
    assert proc.returncode == 0, proc.stderr


def test_public_names_load_lazily():
    """``import scipsdp_tpu_torch`` loads neither torch nor a submodule;
    each public name loads its module on first use."""
    code = ("import sys\n"
            "import scipsdp_tpu_torch as p\n"
            "heavy = [m for m in sys.modules if m == 'torch' or "
            "m.startswith('scipsdp_tpu_torch.')]\n"
            "assert not heavy, heavy\n"
            "from scipsdp_tpu_torch.core import branchbound\n"
            "from scipsdp_tpu_torch.models import io\n"
            "assert p.solve_misdp is branchbound.solve_misdp\n"
            "assert p.read_problem is io.read_problem\n"
            "assert all(getattr(p, n) is not None for n in p.__all__)\n"
            "assert 'enable_compilation_cache' not in p.__all__\n")
    proc = _run(code, REPO)
    assert proc.returncode == 0, proc.stderr


def _smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_without_cuda():
    proc = _smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
