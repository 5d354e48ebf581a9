"""The benchmark of ``scipsdp_tpu_torch``, driven by ``BENCHMARK.json``.

A cell (``workloads``) names a configuration and a traffic mix.  Everything
that belongs to one of them sits in a file of its own, found by name:

* ``configs/<config>.json`` — the deployment: the instance family's sizes,
  the instances' generator seeds, the guarantees (precision, tolerances);
* ``traffic/<traffic>.json`` — the mix: its ``kind`` names the general
  driver ``drivers/<kind>.py`` that reads the other parameters;
* ``metrics/<metric>.py`` — one reader per metric, ``read(rec)`` returning
  a number or None (nothing to read: the metric is left out of the line).

A run: the card check, set-up (imports, the CUDA context, the instance,
the solver's data, one warm-up unit at the cell's own shapes), the window
(units back to back for ``--seconds``, the unit in progress finished),
with ``--trace 1`` the traced extras, then the device memory peak is read,
the program's state freed, and the plain reference judges every answer.
The last line of standard output is the result; the compared numbers, each
beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "scipsdp_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``scipsdp_tpu_torch`` is not
    ``scipsdp_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (file names may hold
    dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(kind: str):
    """The general driver of a traffic kind: ``drivers/<kind>.py``."""
    return load_module(BENCH / "drivers" / f"{kind}.py",
                       f"misdp_bench_driver_{kind}")


def cell_of(spec: dict, workload: str) -> tuple:
    """(cell, config, traffic) of ``workload`` from BENCHMARK.json."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    return cell_files(cells[workload])


def find_cell(workload) -> tuple:
    """(cell, config, traffic) of a cell of BENCHMARK.json by name, or of
    a cell entry (a dict with ``name``, ``config`` and ``traffic``)."""
    if isinstance(workload, dict):
        return cell_files(workload)
    return cell_of(load_json(ROOT / "BENCHMARK.json"), workload)


def cell_files(cell: dict) -> tuple:
    """(cell, config, traffic) of a cell entry, its files found by the
    names it gives."""
    cfg = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def metrics_for(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with ``workloads`` only
    in the cells it lists."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(entries: list, rec: dict) -> dict:
    """Run each entry's reader on ``rec``; those that find nothing to read
    are left out."""
    out = {}
    for m in entries:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             f"misdp_bench_metric_{m['name']}")
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: dict, cfg: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             chips: int = 1) -> dict:
    """One run of a cell on ``device``; returns the parts of the result
    (answers judged, record for the readers, device figures)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.zeros(1, device=device)     # the CUDA context
    t_ready = time.perf_counter()
    drv = driver_module(traffic["kind"]).Driver(cfg, traffic, seed, device)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    parts = {"imports_and_context_s": t_ready - t_start, **drv.setup_parts}
    t0 = time.perf_counter()
    while True:
        drv.step()
        window_s = time.perf_counter() - t0
        if window_s >= seconds and drv.window_complete():
            break
    traced = {}
    if trace:
        if cuda:
            from misdp_bench import profiling
            profiling.warm_profiler()
        traced = drv.trace()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": chips, "memory_peak_bytes": peak}
    if trace and "profile" in traced:
        device_info["busy_s"] = traced["profile"]["busy_s"]
        device_info["window_s"] = traced["profile"]["wall_s"]
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    attempted, failed, checks = drv.check()
    rec = {"setup_s": setup_s, "setup_parts": parts, "window_s": window_s,
           **drv.record(), **traced}
    return {"attempted": attempted, "failed": failed, "checks": checks,
            "rec": rec, "device": device_info,
            "breakdown": traced.get("breakdown")}


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def result_line(out: dict, metrics: dict, trace: bool) -> dict:
    """The result object, its keys in the contract's order, the compared
    numbers last."""
    checks = out["checks"]
    ok = all(finite(v) and v <= lim for v, lim in checks.values())
    line = {"correct": bool(ok), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": out["device"]}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(args, t_start: float) -> int:
    import torch

    spec = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = cell_of(spec, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"misdp_bench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, cfg, traffic, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), t_start, chips)
    metrics = read_metrics(metrics_for(spec, cell["name"], bool(args.trace)),
                           out["rec"])
    line = result_line(out, metrics, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"misdp_bench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    rec = out["rec"]
    print("setup " + " ".join(f"{k}={v!r}" for k, v in
                              rec["setup_parts"].items()), file=sys.stderr)
    units = rec.get("solves") or rec.get("trees") or []
    print("unit walls " + " ".join(f"{u['wall_s']:.4f}" for u in units),
          file=sys.stderr)
    for name, c in line["checks"].items():
        verdict = "ok" if finite(c["value"]) and c["value"] <= c["limit"] \
            else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
