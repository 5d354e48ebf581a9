#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scipsdp_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which raises (and so exits non-zero) when it fails:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; no CUDA device means exit 2 before any work.
2. kernel check: builds ``csrc/cholesky_lanes.cu`` with nvcc, compares the
   kernel with its plain PyTorch version at the solver's shapes (rtol and
   atol 2e-4, the bar of the JAX package's lanes-Cholesky test), checks that
   a non-PD matrix NaNs its own factor only, and times both with CUDA
   events (median of 25 samples of 10 back-to-back calls after warm-up,
   the two versions in turns).
3. main path: batched interior-point relaxation solves through
   ``ipm_solve`` with the device's resolved settings (probe step rule with
   the hand-written probe Cholesky, float64 elsewhere): three requests of
   32 branch-and-bound node boxes on cls_32 (direct, Gamma=1 feasibility
   probe, Gamma=1e3 penalty solve) and one of 8 boxes on cls_64.  The
   kernel launch counter is reset just before and read just after.  Each
   output is checked: children bound no lower than the root, the root's
   dual point feasible by an independent numpy check, and the same solve
   through the plain probe gives the same statuses and bounds.  Then each
   request is timed through both probe routes in turns (6 pairs).  A small
   instance is also held against the same solve on the CPU (the path the
   tests hold against the JAX package).
4. profile: one torch.profiler pass of the direct cls_32 request (device
   busy time, the ten ops and the ten kernels with the most device time),
   and the host syncs of one solve by source line (CUDA sync debug mode).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Float32 matmuls run in
full float32 (TF32 off for matmul and cuDNN).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from scipsdp_tpu_torch import _build
from scipsdp_tpu_torch.models.families import cardinality_least_squares
from scipsdp_tpu_torch.models.problem import densify
from scipsdp_tpu_torch.ops import kernels
from scipsdp_tpu_torch.ops.ipm import build_ipm_data, ipm_solve
from scipsdp_tpu_torch.utils.config import Settings, resolve_backend_autos
from scipsdp_tpu_torch.utils.status import SolverResultStatus

# (leading shape, n) of the matrix stacks the kernel is checked and timed
# at; (32, 10) and (8, 10) are the stacked probe ladders of the main path
# (B slots x 2*5 trials) at cls_32 B=32 and cls_64 B=8
KERNEL_SHAPES = [((3,), 5), ((16,), 43), ((130,), 17), ((1,), 64),
                 ((384,), 65), ((32, 10), 65), ((320,), 97), ((320,), 129),
                 ((8, 10), 129), ((14720,), 10), ((4,), 300)]
MAIN_SHAPE = ((32, 10), 65)
KERNEL_TOL = 2e-4
GAMMA = 1e3
REPS = 25
LAUNCHES = 10
SOLVE_PAIRS = 6


def log(tag: str, **kw) -> None:
    print(json.dumps({"phase": tag, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def spd_stack(rng, N: int, n: int) -> np.ndarray:
    a = rng.standard_normal((N, n, n))
    return np.einsum("bij,bkj->bik", a, a) + n * np.eye(n)


def event_ms(fn, A) -> float:
    """Device time per call over LAUNCHES back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn(A)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def kernel_phase(device) -> dict:
    """Build, check and time cholesky_lanes against its plain version."""
    t0 = time.perf_counter()
    _build.load("cholesky_lanes")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    worst, main_times = 0.0, None
    for lead, n in KERNEL_SHAPES:
        N = int(np.prod(lead))
        A = torch.as_tensor(spd_stack(rng, N, n).reshape(lead + (n, n)),
                            dtype=torch.float32, device=device)
        L = kernels.cholesky_lanes(A)
        Lp = kernels.cholesky_lanes_plain(A)
        torch.cuda.synchronize()
        err = float((L - Lp).abs().max())
        torch.testing.assert_close(L, Lp, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        if not bool((torch.triu(L, diagonal=1) == 0).all()):
            raise AssertionError(f"nonzero above the diagonal at {(N, n)}")
        # one indefinite matrix: NaN in its own factor and nowhere else
        bad = N // 2
        Ab = A.clone()
        Ab.view(N, n, n)[bad] -= 4.0 * n * torch.eye(n, device=device)
        nan_mat = torch.isnan(kernels.cholesky_lanes(Ab)).view(N, -1).any(1)
        torch.cuda.synchronize()
        expect = torch.zeros(N, dtype=torch.bool, device=device)
        expect[bad] = True
        if not bool((nan_mat == expect).all()):
            raise AssertionError(f"NaN pattern wrong at {(N, n)}: "
                                 f"{nan_mat.nonzero().flatten().tolist()}")
        for _ in range(3):
            kernels.cholesky_lanes(A)
            kernels.cholesky_lanes_plain(A)
        ms, plain = [], []
        for _ in range(REPS):
            ms.append(event_ms(kernels.cholesky_lanes, A))
            plain.append(event_ms(kernels.cholesky_lanes_plain, A))
        t, tp = float(np.median(ms)), float(np.median(plain))
        log("kernel", name="cholesky_lanes", shape=list(lead) + [n, n],
            max_abs_err=err, ms=t, plain_ms=tp, nan_own_matrix_only=True)
        worst = max(worst, err)
        if (lead, n) == MAIN_SHAPE:
            main_times = (t, tp)
    log("kernel_build", seconds=build_s,
        log=(_build.library_path("cholesky_lanes").parent
             / "build.log").read_text()[-2000:])
    return {"max_abs_err": worst, "ms": main_times[0],
            "plain_ms": main_times[1]}


def node_boxes(prob, B: int, nfeat: int, rng):
    """Slot 0 is the root box; slots 1.. fix 1-3 binary z variables."""
    lb = np.tile(prob.lb, (B, 1))
    ub = np.tile(prob.ub, (B, 1))
    for s in range(1, B):
        k = int(rng.integers(1, 4))
        zs = nfeat + rng.choice(nfeat, size=k, replace=False)
        vals = rng.integers(0, 2, size=k).astype(float)
        lb[s, zs] = vals
        ub[s, zs] = vals
    return lb, ub


def request(prob, lb, ub, mode: str):
    """(b, lb, ub) with the penalty column for one solve mode."""
    B = lb.shape[0]
    b = np.concatenate([np.tile(prob.obj, (B, 1)), np.zeros((B, 1))], 1)
    lbp = np.concatenate([lb, np.zeros((B, 1))], 1)
    ubp = np.concatenate([ub, np.zeros((B, 1))], 1)
    if mode != "direct":
        ubp[:, -1] = 1e20
    if mode == "probe":
        b[:, :-1] = 0.0
        b[:, -1] = 1.0
    elif mode == "penalty":
        b[:, -1] = GAMMA
    return b, lbp, ubp


def timed(data, req, settings):
    """Wall time of one solve, between two device synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ipm_solve(data, *req, settings=settings)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def dual_violation(dense, y: np.ndarray, lb, ub) -> float:
    """Independent numpy check of a dual point (without the penalty
    variable): worst violation of Z(y) >= 0, G y >= h and the bounds,
    relative to the data scale."""
    scale = 1.0 + max(np.abs(dense.C).max(), np.abs(dense.h).max(initial=0))
    worst = 0.0
    for k in range(dense.nblocks):
        Z = np.einsum("jab,j->ab", dense.A[k], y) - dense.C[k]
        worst = max(worst, -np.linalg.eigvalsh(Z)[0])
    if dense.G.shape[0]:
        worst = max(worst, float(np.max(dense.h - dense.G @ y)))
    worst = max(worst, float(np.max(lb - y)), float(np.max(y - ub)))
    return worst / scale


def check_solve(label, dense, out, ref, req, gaptol, feastol, direct):
    st = out.status.cpu().numpy()
    dobj = out.dobj.cpu().numpy()
    viol = None
    opt = st == int(SolverResultStatus.OPTIMAL)
    if not opt.all():
        raise AssertionError(f"{label}: statuses {collections.Counter(st)}")
    if not np.isfinite(out.y.cpu().numpy()).all():
        raise AssertionError(f"{label}: non-finite y")
    if direct:
        root = dobj[0]
        floor = root - 2 * gaptol * (1 + abs(root))
        if not (dobj >= floor).all():
            raise AssertionError(f"{label}: child bound below root {root}")
        y = out.y[0, :dense.nvars].cpu().numpy()
        viol = dual_violation(dense, y, req[1][0, :-1], req[2][0, :-1])
        if viol > 10 * feastol:
            raise AssertionError(f"{label}: root dual point infeasible "
                                 f"by {viol}")
    st_ref = ref.status.cpu().numpy()
    d_ref = ref.dobj.cpu().numpy()
    if not (st == st_ref).all():
        raise AssertionError(f"{label}: statuses differ from plain probe")
    dev = np.abs(dobj - d_ref) / (1 + np.abs(d_ref))
    if not (dev <= 2 * gaptol).all():
        raise AssertionError(f"{label}: dobj differs from plain probe by "
                             f"{dev.max()}")
    if abs(out.iters - ref.iters) > 3:
        raise AssertionError(f"{label}: {out.iters} vs {ref.iters} iters")
    return float(dev.max()), viol


def main_path(device, settings):
    """Drive the solver's main path once per request (the first solve of
    each, so it includes warm-up); returns the kernel launches made, the
    requests and their outputs."""
    cases = []
    rng = np.random.default_rng(0)
    for label, args, B, modes in (
            ("cls_32", (32, 64, 8), 32, ("direct", "probe", "penalty")),
            ("cls_64", (64, 128, 12), 8, ("direct",))):
        prob = cardinality_least_squares(*args, seed=5)
        dense = densify(prob)
        data = build_ipm_data(dense, device)
        lb, ub = node_boxes(prob, B, args[0], rng)
        for mode in modes:
            cases.append((f"{label}/{mode}", dense, data,
                          request(prob, lb, ub, mode), mode == "direct"))

    kernels.cholesky_lanes.launches = 0
    outs = []
    for label, dense, data, req, direct in cases:
        before = kernels.cholesky_lanes.launches
        outs.append(ipm_solve(data, *req, settings=settings))
        torch.cuda.synchronize()
        if kernels.cholesky_lanes.launches == before:
            raise AssertionError(f"{label}: probe kernel never launched")
    return kernels.cholesky_lanes.launches, cases, outs


def compare_phase(cases, outs, settings) -> None:
    """Check each main-path output, hold it against the same solve through
    the plain probe, and time both routes in turns (kernel first in even
    pairs, plain first in odd ones)."""
    plain = dataclasses.replace(settings, use_lanes_chol=False)
    for (label, dense, data, req, direct), out in zip(cases, outs):
        ref = ipm_solve(data, *req, settings=plain)
        dev, viol = check_solve(label, dense, out, ref, req, settings.gaptol,
                                settings.feastol, direct)
        walls = {"kernel": [], "plain": []}
        for r in range(SOLVE_PAIRS):
            order = ("kernel", "plain") if r % 2 == 0 else ("plain", "kernel")
            for route in order:
                walls[route].append(timed(
                    data, req, settings if route == "kernel" else plain))
        st = collections.Counter(int(s) for s in out.status.cpu().numpy())
        log("solve", request=label, B=int(out.status.shape[0]),
            status={SolverResultStatus(k).name: v for k, v in st.items()},
            iters=out.iters, plain_probe_iters=ref.iters,
            wall_s_median=float(np.median(walls["kernel"])),
            plain_probe_wall_s_median=float(np.median(walls["plain"])),
            kernel_faster_pairs=sum(k < p for k, p in zip(walls["kernel"],
                                                          walls["plain"])),
            wall_s=walls["kernel"], plain_probe_wall_s=walls["plain"],
            max_rel_dobj_vs_plain=dev, root_dobj=float(out.dobj[0]),
            root_dual_violation=viol)


def cpu_reference(device, settings):
    """A small instance on the card against the same solve on the CPU
    with the plain probe (the path the tests hold against JAX)."""
    prob = cardinality_least_squares(8, 16, 3, seed=1)
    dense = densify(prob)
    lb, ub = node_boxes(prob, 8, 8, np.random.default_rng(1))
    req = request(prob, lb, ub, "direct")
    cpu = dataclasses.replace(settings, use_lanes_chol=False)
    ref = ipm_solve(build_ipm_data(dense, "cpu"), *req, settings=cpu)
    out = ipm_solve(build_ipm_data(dense, device), *req, settings=settings)
    st, st_ref = out.status.cpu().numpy(), ref.status.numpy()
    dev = np.abs(out.dobj.cpu().numpy() - ref.dobj.numpy()) \
        / (1 + np.abs(ref.dobj.numpy()))
    if not ((st == st_ref).all() and (dev <= 2 * settings.gaptol).all()):
        raise AssertionError(f"small CLS: card {st} vs cpu {st_ref}, "
                             f"rel dobj {dev.max()}")
    log("cpu_reference", instance="cls_8x16", B=8, iters=out.iters,
        cpu_iters=ref.iters, max_rel_dobj=float(dev.max()))


def profile_phase(case, settings) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, _, data, req, _ = case
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = ipm_solve(data, *req, settings=settings)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    evts = sorted(prof.key_averages(), key=dev_us, reverse=True)
    kern = [e for e in evts if e.device_type == DeviceType.CUDA]
    ops = [e for e in evts if e.device_type != DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern)
    log("profile", request="cls_32/direct", iters=out.iters,
        profiled_wall_s=wall, device_busy_us=busy,
        kernel_launches=sum(e.count for e in kern),
        top_ops=[{"op": e.key, "self_device_us": dev_us(e), "calls": e.count}
                 for e in ops[:10]],
        top_kernels=[{"kernel": e.key[:90], "device_us": dev_us(e),
                      "calls": e.count} for e in kern[:10]])

    # host syncs of one solve (the loop reads the done mask once per
    # iteration)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        out = ipm_solve(data, *req, settings=settings)
        torch.cuda.set_sync_debug_mode("default")
    # each warning points at the Python line that issued the syncing op
    syncs = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    log("syncs", request="cls_32/direct", iters=out.iters, count=len(syncs),
        sites=sorted(collections.Counter(syncs).items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=card)
    settings = resolve_backend_autos(Settings(), device).ipm
    settings = dataclasses.replace(settings, max_iters=100)
    log("settings", step_rule=settings.step_rule,
        use_lanes_chol=settings.use_lanes_chol, phase32=settings.phase32)

    kern = kernel_phase(device)
    launches, cases, outs = main_path(device, settings)
    compare_phase(cases, outs, settings)
    cpu_reference(device, settings)
    profile_phase(cases[0], settings)

    print(json.dumps({"kernels": [{
        "name": "cholesky_lanes", "route": "cuda",
        "source": "scipsdp_tpu_torch/csrc/cholesky_lanes.cu",
        "replaces": "scipsdp_tpu/ops/pallas_kernels.py:337",
        "launches": launches, **kern}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
