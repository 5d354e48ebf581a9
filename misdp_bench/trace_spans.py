"""A traced run of one replay cell with the program's span passes added
(``spans.span_passes``): every per-layer metric ``BENCHMARK.json`` gives
the cell, the five read from the program's spans, and the checks of the
spans themselves.

    python3 misdp_bench/trace_spans.py --workload cls16.relax.frontier \\
        --seed <n> --seconds <s>

from the root of a checkout, on a CUDA card.  The run: set-up, the window
(as ``run.py``), the pass in progress finished so that every later pass
sends each recorded call once; then, before any profiler, passes with the
tracer off and on in turns (what recording costs); the driver's traced
passes (as ``run.py --trace 1``); the span passes; one pass with the tracer
off (the profiler's after-effect on the host); one pass with the tracer
recording in CUDA sync debug mode (the program's count of syncs against
CUDA's, on the same solves).  Every answer is judged.

The last line of standard output is the result line of ``run.py --trace
1`` with the five added to its metrics.  Standard error carries ``idle by
span`` (the device's idle seconds in the profiled span pass by the program
span open when each gap began), ``syncs by site``, ``span clock`` (device
records against the spans' clock), ``span iters``, ``sync check`` and
``pass walls`` lines.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from misdp_bench import harness, profiling, run, spans  # noqa: E402

# the metrics read from the program's spans: (name, unit)
SPAN_METRICS = (("program_syncs_per_solve.relax", "syncs"),
                ("sync_wait_ms.relax", "ms"),
                ("solve_setup_ms.relax", "ms"),
                ("iter_dispatch_ms.relax", "ms"),
                ("idle_in_iter.relax", "%"))


def timed_pass(drv, trace=None) -> tuple:
    """(wall s, the recording or None) of one pass, recording with the
    tracer module ``trace`` when given."""
    if trace is None:
        t0 = time.perf_counter()
        drv.run_pass()
        return time.perf_counter() - t0, None
    with trace.recording() as rec:
        t0 = time.perf_counter()
        drv.run_pass()
        wall = time.perf_counter() - t0
    return wall, rec


def span_metrics(rec) -> dict:
    """The four duration and count metrics of one recording."""
    out = {"spans": spans.span_records(rec),
           "syncs_by_site": dict(rec.syncs)}
    return {n: harness.read_metrics([{"name": n, "unit": u}], out)
            .get(n, {}).get("value") for n, u in SPAN_METRICS[:4]}


def measure(cell, cfg, traffic, seed: int, seconds: float, dev) -> tuple:
    """The run on ``dev``: (result line, the standard error lines)."""
    import torch

    trace = spans.tracer()
    torch.zeros(1, device=dev)
    drv = harness.driver_module(traffic["kind"]).Driver(cfg, traffic, seed,
                                                        dev)
    drv.setup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        drv.step()
        window_s = time.perf_counter() - t0
        if window_s >= seconds and drv.window_complete():
            break
    window_passes = len(drv.solves) / len(drv.calls)
    while drv.pos:
        drv.step()
    # before any profiler: the tracer off and on in turns
    walls = {"off": [], "on": []}
    for _ in range(2):
        walls["off"].append(timed_pass(drv)[0])
        wall, pre = timed_pass(drv, trace)
        walls["on"].append(wall)
    profiling.warm_profiler()
    traced = drv.trace()
    first = len(drv.solves)
    traced.update(spans.span_passes(drv))
    walls["off_after_profiler"] = [timed_pass(drv)[0]]
    first_check = len(drv.solves)
    with profiling.sync_sites() as sites, trace.recording() as rec:
        drv.run_pass()
    check_iters = sum(s["iters"] for s in drv.solves[first_check:])
    peak = torch.cuda.max_memory_allocated(dev)
    drv.release()
    torch.cuda.empty_cache()
    attempted, failed, checks = drv.check()
    rec_all = {"window_s": window_s, **drv.record(), **traced}
    entries = harness.metrics_for(load_spec(), cell["name"], True) + [
        {"name": n, "unit": u} for n, u in SPAN_METRICS]
    line = harness.result_line(
        {"attempted": attempted, "failed": failed, "checks": checks,
         "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                    "count": 1, "memory_peak_bytes": peak,
                    "busy_s": traced["profile"]["busy_s"],
                    "window_s": traced["profile"]["wall_s"]},
         "breakdown": traced["breakdown"]},
        harness.read_metrics(entries, rec_all), True)

    idle = traced["idle_by_span"]
    idle_s = idle["window_s"] - idle["busy_s"]
    notes = [
        f"idle by span {spans.top(idle['labels'])} (idle {idle_s!r} s of "
        f"{idle['window_s']!r} s)",
        f"syncs by site {json.dumps(traced['syncs_by_site'])} over "
        f"{len(traced['span_solves'])} solves",
        f"span clock first_record_after_solve_ns="
        f"{idle['first_record_after_solve_ns']} outside_window="
        f"{idle['outside_window']} of {idle['records']} labels_sum="
        f"{sum(idle['labels'].values())!r} idle_s={idle_s!r}",
        f"span iters {spans.count(traced['spans'], 'ipm.iter')} solves' "
        f"iters {sum(s['iters'] for s in traced['span_solves'])} (solves "
        f"{first}-{first + len(traced['span_solves'])})",
        f"sync check program={sum(rec.syncs.values())} cuda={len(sites)} "
        f"over {len(drv.calls)} solves, {check_iters} iters; program "
        f"{json.dumps(dict(rec.syncs))}",
        f"pass walls window_mean={window_s / window_passes!r} "
        f"{json.dumps(walls)} span_pass={traced['span_pass_s']!r}; "
        f"median off/on {statistics.median(walls['off'])!r}/"
        f"{statistics.median(walls['on'])!r}; before the profiler "
        f"{json.dumps(span_metrics(pre))}"]
    notes += [f"check {name} {c['value']!r} limit {c['limit']!r}"
              for name, c in line["checks"].items()]
    return line, notes


def load_spec() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def main(argv=None) -> int:
    import torch

    args = run.parse(argv)
    cell, cfg, traffic = harness.cell_of(load_spec(), args.workload)
    if not torch.cuda.is_available() or spans.tracer() is None:
        print("trace_spans: needs a CUDA card and the program's tracer",
              file=sys.stderr)
        return 2
    line, notes = measure(cell, cfg, traffic, args.seed, args.seconds,
                          torch.device("cuda", 0))
    print("\n".join(notes), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
