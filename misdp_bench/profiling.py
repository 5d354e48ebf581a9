"""Reductions from device traces and sync logs to numbers.

Frozen copies of the arithmetic that ``chip_smoke.py`` used on the card
(``kernel_bound``'s byte count of the probe Cholesky, ``sync_sites``,
``device_profile``'s busy time), kept here so that a change to the
program cannot move the yardstick.  Device time comes from the profiler's
kernel and copy records (CUPTI); a busy second is one in which some device
operation ran (the union of their intervals, so overlapping records count
once).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import pathlib
import time
import warnings

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the full 700 W limit
PEAK_BYTES = 3.35e12
# the probe Cholesky's kernels in scipsdp_tpu_torch/csrc/cholesky_lanes.cu
CHOL_LANES_KERNELS = ("cholesky_lanes_kernel", "cholesky_tiny_kernel")
BENCH_DIR = pathlib.Path(__file__).resolve().parent


def chol_lanes_bytes(shape, itemsize: int) -> int:
    """Least bytes of one probe-Cholesky call on a stack of (..., n, n)
    matrices: the lower triangle read once (n(n+1)/2 values a matrix) and
    the whole factor written once."""
    n = shape[-1]
    nmat = 1
    for d in shape[:-2]:
        nmat *= d
    return nmat * (n * (n + 1) // 2 + n * n) * itemsize


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


@contextlib.contextmanager
def sync_sites():
    """The program's host syncs inside the ``with`` block, as
    ``file:line`` strings in the list it yields (filled when the block
    ends), from CUDA sync debug mode; syncs made by the benchmark's own
    files are left out.  Debug mode slows the host: traced runs only."""
    import torch

    sites = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchronizing CUDA operation" not in str(w.message):
            continue
        path = pathlib.Path(w.filename).resolve()
        if BENCH_DIR in path.parents:
            continue
        sites.append(f"{path.name}:{w.lineno}")


class CholSpy:
    """Wraps ``scipsdp_tpu_torch.ops.kernels.cholesky_lanes`` while active
    and adds up the least bytes of every call (traced runs only)."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    @contextlib.contextmanager
    def active(self):
        from scipsdp_tpu_torch.ops import kernels

        inner = kernels.cholesky_lanes

        # the wrapper counts its launches on the function it is called as,
        # and names the kernel by it: the spy takes its name and counter
        @functools.wraps(inner)
        def spy(A, *args, **kw):
            out = inner(A, *args, **kw)
            if A.device.type == "cuda":
                self.calls += 1
                self.bytes += chol_lanes_bytes(A.shape, A.element_size())
            return out

        kernels.cholesky_lanes = spy
        try:
            yield self
        finally:
            kernels.cholesky_lanes = inner
            inner.launches = spy.launches


def profiled(fn, with_cpu: bool = False) -> dict:
    """Run ``fn`` once under torch.profiler (CUDA activity, and CPU ops
    with ``with_cpu``) and reduce the trace: the profiled wall, device busy
    seconds, device operations by name, the probe Cholesky's kernel time
    and count, and the idle gaps between device operations labelled by
    what the host was in when each began."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if with_cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    # the profiler's raw records: building its FunctionEvent tree over a
    # whole B&B tree's ~10^6 records takes minutes, reading them seconds
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
        (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
    by_name = collections.Counter()
    chol_s, chol_n, kernels = 0.0, 0, 0
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-6
        kernels += not name.startswith(("Memcpy", "Memset"))
        if any(k in name for k in CHOL_LANES_KERNELS):
            chol_s += (e - s) * 1e-6
            chol_n += 1
    return {"wall_s": wall, "reduce_s": time.perf_counter() - t1,
            "busy_s": union_seconds((s, e) for s, e, _ in dev),
            "device_ops": len(dev), "kernels": kernels, "by_name": by_name,
            "chol_kernel_s": chol_s, "chol_kernels": chol_n,
            "gaps": idle_gaps(dev, host)}


def warm_profiler() -> None:
    """One short profiled op, so that the profiler's first start-up (CUPTI,
    seconds on the card) falls outside every measured trace."""
    import torch

    profiled(lambda: torch.ones(8, device="cuda").sum())


def idle_gaps(dev, host) -> collections.Counter:
    """Idle seconds between device operations, summed by the host event
    that was running when each gap began (the innermost one, i.e. the one
    that started last among those covering the gap's start; "none" where
    no host event covers it)."""
    dev = sorted(dev)
    host = sorted(host)
    out = collections.Counter()
    end, j, open_ = None, 0, []
    for s, e, _ in dev:
        if end is not None and s > end:
            while j < len(host) and host[j][0] <= end:
                open_.append(host[j])
                j += 1
            open_ = [h for h in open_ if h[1] >= end]
            label = max(open_)[2] if open_ else "none"
            out[label] += (s - end) * 1e-6
        end = e if end is None else max(end, e)
    return out


def top(counter, k: int = 10, width: int = 120) -> list:
    """The k largest entries of a Counter as [[name, seconds], ...], each
    name cut to ``width`` characters (kernel names run to hundreds)."""
    return [[name[:width], float(v)] for name, v in counter.most_common(k)]
