"""The port's file entry points against the JAX package's: settings files
(``utils/paramfile.py``), the statistics table (``utils/statistics.py``)
and ``python -m scipsdp_tpu_torch`` (``__main__.main``), both CLIs run
in-process on the CPU on the same generated files (``--mesh`` too: the
port's CPU has one device, so no mesh).  Then the port's CLI on its own:
without ``--cpu`` it needs a CUDA card and reads nothing without one.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from _torch_bbcases import torch_one_thread  # noqa: F401 (fixture)
from _torch_filecases import jax_file, problem
from scipsdp_tpu.__main__ import main as jmain
from scipsdp_tpu.core.branchbound import BBStats as JStats
from scipsdp_tpu.core.sdpi import SDPInterface as JIface
from scipsdp_tpu.models.problem import densify as jdensify
from scipsdp_tpu.utils import paramfile as jpf
from scipsdp_tpu.utils.statistics import format_relax_statistics as jformat
from scipsdp_tpu_torch import __main__ as tcli
from scipsdp_tpu_torch.core.branchbound import BBStats as TStats
from scipsdp_tpu_torch.core.sdpi import SDPInterface as TIface
from scipsdp_tpu_torch.interop import problem_from_jax
from scipsdp_tpu_torch.models.problem import densify as tdensify
from scipsdp_tpu_torch.utils import config as tconfig
from scipsdp_tpu_torch.utils import paramfile as tpf
from scipsdp_tpu_torch.utils.statistics import format_relax_statistics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_param_map_names_port_fields():
    """Every setting a .set file can reach is a field of the port's
    settings dataclasses."""
    base = tconfig.Settings()
    for name, spec in tpf._PARAM_MAP.items():
        if spec is None:
            assert name in tpf._BRANCH_PRIO
            continue
        section, field, _ = spec
        owner = getattr(base, section) if section else base
        assert field in {f.name for f in dataclasses.fields(owner)}, name


# per variant: the value written for each type, the diving frequency and
# the four branching priorities
VARIANTS = {
    "true": ({bool: "TRUE", int: "3", float: "0.25", str: "mostinf"}, "5",
             (1e3, 3e6, 50.0, 10.0)),
    "false": ({bool: "FALSE", int: "0", float: "1e-4", str: "objective"},
              "-1", (-5.0, 0.0, 7.0, 2.0)),
    "numeric": ({bool: "2", int: "7", float: "2", str: "mostfrac"}, "0",
                (1.0, 2.0, 3.0, 4e6)),
}


def _settings_file(path, variant):
    """Every _PARAM_MAP key, the four branching priorities, one unknown
    key, a comment and a line without '='."""
    values, diving, prios = VARIANTS[variant]
    lines = ["# generated", "", "display/verblevel = 5", "no assignment"]
    for name, spec in jpf._PARAM_MAP.items():
        if spec is None:
            continue
        typ = spec[2]
        raw = diving if name == "heuristics/sdpfracdiving/freq" else \
            values[typ]
        lines.append(f"{name} = {raw}  # {typ!r}")
    lines += [f"{name} = {p}" for name, p in zip(jpf._BRANCH_PRIO, prios)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_settings_file_same(tmp_path, variant):
    path = _settings_file(tmp_path / "all.set", variant)
    want = dataclasses.asdict(jpf.load_settings_file(path))
    got = dataclasses.asdict(tpf.load_settings_file(path))
    assert got == want
    assert got != dataclasses.asdict(tconfig.Settings())


def _stats(cls):
    """A stats object with every counter set, the optional ones too."""
    vals = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        if f.type == "str":
            vals[f.name] = "orbit search capped at 64"
        elif f.type == "dict":
            vals[f.name] = {"root": 0.125, "child": 1.5}
        elif f.type == "float":
            vals[f.name] = 3.25 + i
        else:
            vals[f.name] = 3 * i + 1
    return cls(**vals)


def test_statistics_same(tmp_path):
    jprob = problem("cls", tmp_path)
    jiface = JIface(jdensify(jprob))
    tiface = TIface(tdensify(problem_from_jax(jprob)), device="cpu")
    for i, name in enumerate(k for k in vars(jiface)
                             if k.startswith("stat_")):
        setattr(jiface, name, 11 + i)
        setattr(tiface, name, 11 + i)
    want = [jformat(_stats(JStats)), jformat(_stats(JStats), jiface)]
    got = [format_relax_statistics(_stats(TStats)),
           format_relax_statistics(_stats(TStats), tiface)]
    assert got == want
    for row in ("multi-host: nodes stolen", "Slater condition (primal",
                "propagation timing", "interface: verify re-solves"):
        assert row in got[1], row


TIME_ROWS = ("relaxation solve time (s)", "wall time (s)")


def _run(main, argv, capsys):
    """(exit code, the result lines, the statistics rows but the time
    rows, every other line) of one in-process CLI run."""
    rc = main(argv)
    out = capsys.readouterr().out.splitlines()
    k = out.index("SDP relaxator statistics:")
    result = [ln for ln in out[:k] if ln.startswith(
        ("SCIP-SDP-TPU status", "objective value", "dual bound", "gap"))]
    stats = [ln for ln in out[k:] if not ln.strip().startswith(TIME_ROWS)]
    other = [ln for ln in out[:k] if ln not in result]
    return rc, result, stats, other


def _both(tmp_path, capsys, *flags, name="cls", fmt=".dat-s"):
    """Both CLIs on the JAX writer's file of ``name``, ``--cpu -q``;
    ``{out}`` in a flag names a file of each run's own."""
    path = jax_file(problem(name, tmp_path), tmp_path, fmt)
    runs = []
    for pkg, main in (("jax", jmain), ("port", tcli.main)):
        argv = [path, "--cpu", "-q"] + [
            f.replace("{out}", str(tmp_path / pkg)) for f in flags]
        runs.append(_run(main, argv, capsys))
    assert runs[0][0] == runs[1][0] == 0
    return runs


def test_cli_same_solve(tmp_path, capsys, torch_one_thread):  # noqa: F811
    """The same tree: the status, objective, bound and gap lines and every
    statistics row but the two time rows; the files --write and
    --write-transformed give, byte for byte."""
    want, got = _both(tmp_path, capsys, "--node-limit", "100", "--write",
                      "{out}.cbf", "--write-transformed", "{out}.t.cbf")
    assert got[1:3] == want[1:3]
    assert want[1][0] == "SCIP-SDP-TPU status : OPTIMAL"
    for ext in (".cbf", ".t.cbf"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes()


def test_cli_slater_lines(tmp_path, capsys, torch_one_thread):  # noqa: F811
    want, got = _both(tmp_path, capsys, "--slater", "--node-limit", "1")
    slater = [ln for ln in want[3] if "Slater condition" in ln]
    assert len(slater) == 2
    assert [ln for ln in got[3] if "Slater condition" in ln] == slater
    assert got[1:3] == want[1:3]


def test_cli_settings_file(tmp_path, capsys, torch_one_thread):  # noqa: F811
    """--settings: a branching priority, warm starts and a node limit."""
    setfile = tmp_path / "tree.set"
    setfile.write_text("branching/sdpmostfrac/priority = 3000000\n"
                       "relaxing/SDP/warmstart = TRUE\n"
                       "limits/nodes = 5\n")
    want, got = _both(tmp_path, capsys, "--settings", str(setfile))
    assert got[1:3] == want[1:3]
    assert want[1][0] == "SCIP-SDP-TPU status : NODE_LIMIT"


def test_cli_lp_approx(tmp_path, capsys, torch_one_thread):  # noqa: F811
    want, got = _both(tmp_path, capsys, "--lp-approx", "--node-limit",
                      "100", name="tt")
    assert got[1:3] == want[1:3]
    assert want[1][0] == "SCIP-SDP-TPU status : OPTIMAL"


def test_cli_mesh_raises(tmp_path, capsys, torch_one_thread):  # noqa: F811
    """``--mesh --cpu``, which once raised, runs: JAX shards over its 8
    virtual CPU devices, the port finds one CPU device and builds no mesh;
    the same status and objective lines."""
    want, got = _both(tmp_path, capsys, "--mesh")
    assert got[1][:2] == want[1][:2]
    assert want[1][0] == "SCIP-SDP-TPU status : OPTIMAL"


def test_cli_needs_a_card_or_cpu(tmp_path, capsys, monkeypatch):
    """Without --cpu and without CUDA: a non-zero exit naming --cpu, and
    the file is never opened (this one does not exist)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "absent.dat-s")
    assert tcli.main([missing, "-q"]) != 0
    err = capsys.readouterr().err
    assert "--cpu" in err and "absent" not in err


def test_module_help():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "scipsdp_tpu_torch",
                           "--help"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--write-transformed" in proc.stdout and "--cpu" in proc.stdout
