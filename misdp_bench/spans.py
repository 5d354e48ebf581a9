"""The program's own spans and sync counts (``scipsdp_tpu_torch.utils.
trace``), reduced to numbers.

Two passes of a replay driver, after a traced run's other passes
(:func:`span_passes`): one with the tracer recording and no profiler, for
span durations and sync counts; one recording under CUDA activity, for the
device's idle time split by the program span open when each gap began
(:func:`idle_by_span`).  The tracer stamps spans with
``time.perf_counter_ns()`` and gives the offset to ``time.time_ns()``, the
clock of the profiler's raw records, so both lie on one clock here.
Against a program without the tracer the passes are not run and nothing is
added: the readers of these numbers then find nothing.
"""

from __future__ import annotations

import collections
import time

from misdp_bench import profiling

OUTSIDE = "outside"      # the label of idle time with no program span open


def tracer():
    """The program's tracer module, or None where it has none."""
    try:
        from scipsdp_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def span_records(rec) -> list:
    """A recording's spans as plain dicts, their times in ns on the
    profiler's clock (``offset_ns`` added)."""
    off = rec.offset_ns
    return [{"name": s.name, "start_ns": s.start_ns + off,
             "end_ns": s.end_ns + off, "id": s.id, "parent": s.parent,
             "solve": s.solve, "attrs": dict(s.attrs)} for s in rec.spans]


def union_ns(intervals) -> float:
    """Length covered by the union of (start, end) intervals, in their
    unit (``profiling.union_seconds`` reads microseconds)."""
    return profiling.union_seconds(intervals) * 1e6


def self_ns(spans: list) -> dict:
    """Per span id its self time: its duration less the part of it that
    its child spans cover."""
    kids = collections.defaultdict(list)
    for s in spans:
        if s["parent"] is not None:
            kids[s["parent"]].append((s["start_ns"], s["end_ns"]))
    return {s["id"]: s["end_ns"] - s["start_ns"] - union_ns(kids[s["id"]])
            for s in spans}


def total_ns(spans: list, name: str) -> int:
    """Summed duration of the spans called ``name``."""
    return sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["name"] == name)


def count(spans: list, name: str) -> int:
    return sum(s["name"] == name for s in spans)


def clipped(dev: list, t0: int, t1: int) -> list:
    """The parts of device records (start_ns, end_ns) inside [t0, t1]."""
    return [(max(s, t0), min(e, t1)) for s, e in dev if e > t0 and s < t1]


def idle_by_span(dev: list, spans: list, t0: int, t1: int) -> dict:
    """Idle seconds of the device in the window [t0, t1] (ns, the
    profiler's clock): every stretch in which no device record (start_ns,
    end_ns) runs, labelled by the innermost program span open when it
    began, ``outside`` where none is (``profiling.idle_gaps``, with the
    window's edges as empty records).  The labels sum to the window less
    the union of the records inside it."""
    def us(t):
        return (t - t0) * 1e-3
    recs = [(us(s), us(e), "") for s, e in clipped(dev, t0, t1)]
    gaps = profiling.idle_gaps(
        recs + [(0.0, 0.0, ""), (us(t1), us(t1), "")],
        [(us(s["start_ns"]), us(s["end_ns"]), s["name"]) for s in spans])
    if "none" in gaps:
        gaps[OUTSIDE] = gaps.pop("none")
    return dict(gaps)


def device_records(fn) -> tuple:
    """Run ``fn`` once under torch.profiler (CUDA activity only) and read
    the raw device records, as ``profiling.profiled`` does: (records as
    (start_ns, end_ns), t0, t1), t0 and t1 from ``perf_counter_ns`` around
    ``fn`` after the device is idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    dev = [(e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return dev, t0, t1


def span_passes(drv) -> dict:
    """Two more passes of ``drv`` (a replay driver: ``run_pass``,
    ``solves``) with the program's tracer recording: the first without a
    profiler (``spans``, ``span_solves``, ``syncs_by_site``,
    ``span_pass_s``), the second under CUDA activity (``idle_by_span``:
    the window, its busy seconds, the labels, and the first device record
    against the first ``ipm.solve`` span).  Their answers are judged with
    the others.  {} where the program has no tracer."""
    trace = tracer()
    if trace is None:
        return {}
    first = len(drv.solves)
    with trace.recording() as rec:
        t0 = time.perf_counter()
        drv.run_pass()
        wall = time.perf_counter() - t0
    out = {"spans": span_records(rec), "span_pass_s": wall,
           "span_solves": drv.solves[first:],
           "syncs_by_site": dict(rec.syncs)}
    with trace.recording() as rec:
        dev, t0, t1 = device_records(drv.run_pass)
    spans = span_records(rec)
    t0, t1 = t0 + rec.offset_ns, t1 + rec.offset_ns
    solve0 = min((s["start_ns"] for s in spans if s["name"] == trace.SOLVE),
                 default=None)
    lead = (min(s for s, _ in dev) - solve0
            if dev and solve0 is not None else None)
    out["idle_by_span"] = {
        "window_s": (t1 - t0) * 1e-9,
        "busy_s": union_ns(clipped(dev, t0, t1)) * 1e-9,
        "labels": idle_by_span(dev, spans, t0, t1), "records": len(dev),
        "outside_window": sum(s < t0 or e > t1 for s, e in dev),
        "first_record_after_solve_ns": lead}
    return out


def top(labels: dict, k: int = 6) -> str:
    """The k largest labels as ``name=seconds`` words."""
    return " ".join(f"{n}={v:.4f}" for n, v in
                    collections.Counter(labels).most_common(k))
