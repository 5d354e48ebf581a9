"""Record the batched solves that a real tree sends, its feasibility-probe
and penalty rungs included, and write them as a ``frontier_rungs``
traffic mix.

    python3 misdp_bench/record_frontier_rungs.py --config <name> \\
        --batch-size B --out misdp_bench/traffic/<mix>.json \\
        [--wide-rounds W] [--max-rounds R] [--keep-narrow K] \\
        [--device cuda] [--why TEXT]

Each instance of the configuration is solved by ``scipsdp_tpu_torch.core.
branchbound.solve_misdp`` at default settings but ``batch_size`` (and the
configuration's tolerances), with the device-resident tree engaged
(``core/turbo.py``), while a spy on turbo's ``ipm_solve`` keeps every call:
its width, its rung (``direct``, ``probe``, or ``penalty`` with its Gamma)
and for each slot the binaries its box fixes, or nothing where the slot
is a dead one.  A round is a direct call and the rung calls after it.
Turbo starts narrow and doubles its width up to B as the frontier grows;
the recording of an instance ends once the tree has made W rounds at
width B (``--wide-rounds``, 2 by default), or after R rounds in all
(``--max-rounds``), with its tree, or where turbo hands the tree to the
host loop (too many unsolved relaxations), whichever comes first.  The
mix keeps every round at width B and each instance's first K narrower
rounds (``--keep-narrow``; all by default).  A call that
``drivers/frontier_rungs.py`` does not rebuild exactly (cuts, warm
starts, a bound that is not a 0/1 fixing of a binary, another objective)
stops the recording with an error.  Every call's wall, iterations and
statuses go to standard error.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


class Enough(Exception):
    """The instance's recording has its rounds."""


class HandedOver(Exception):
    """Turbo handed the tree to the host loop."""


def rung_of(prob, b: np.ndarray):
    """(rung, gamma) of a call's objective rows, or None where they are
    not one of turbo's three."""
    m = prob.nvars
    if not (b == b[:1]).all():
        return None
    row = b[0]
    if np.array_equal(row[:m], prob.obj) and row[m] == 0.0:
        return "direct", 0.0
    if not row[:m].any() and row[m] == 1.0:
        return "probe", 0.0
    if np.array_equal(row[:m], prob.obj) and row[m] > 0.0:
        return "penalty", float(row[m])
    return None


def slots_of(prob, b, lb, ub, request) -> tuple:
    """(rung, gamma, slots) of one call: each slot's fixings [[t, v], ...]
    or None for a dead slot; raises where ``request`` (the traffic driver's
    rebuilding) does not give back exactly (b, lb, ub)."""
    got = rung_of(prob, b)
    if got is None:
        raise ValueError("a call whose objective is none of turbo's rungs")
    rung, gamma = got
    fix = fixings_of(prob, lb, ub)
    if fix is None or not all(
            np.array_equal(x, y) for x, y in
            zip(request(prob, fix, rung, gamma), (b, lb, ub))):
        raise ValueError(f"a {rung} call whose boxes are not 0/1 fixings "
                         f"of binaries as turbo builds them")
    slots = [None if (row == -2).all() else
             [[int(t), int(row[t])] for t in np.where(row >= 0)[0]]
             for row in fix]
    return rung, gamma, slots


def fixings_of(prob, lb: np.ndarray, ub: np.ndarray):
    """(width, m) int8 fixings of a call's boxes: -1 where a variable is
    free, its value where its bounds meet at 0 or 1; a dead slot's row
    (some lower bound above its upper bound) all -2.  None where a bound
    meets elsewhere."""
    m = prob.nvars
    fix = np.full((lb.shape[0], m), -1, dtype=np.int8)
    for s, (lo, hi) in enumerate(zip(lb, ub)):
        if np.any(lo > hi):
            fix[s] = -2
            continue
        met = (lo[:m] == hi[:m]) & (prob.lb < prob.ub)
        if not np.all(prob.integral[met]
                      & ((lo[:m][met] == 0) | (lo[:m][met] == 1))):
            return None
        fix[s, met] = lo[:m][met]
    return fix


def record(cfg: dict, batch_size: int, device: str, wide_rounds: int = 2,
           max_rounds: int = None) -> tuple:
    """(solves, trees) of every instance of ``cfg``: the spy's calls as
    {"instance", "width", "rung", "gamma", "slots"} and each recording's
    summary; every call's wall, iterations and statuses on stderr."""
    import torch

    from misdp_bench import harness
    from misdp_bench.instances_mkp import Instance
    from scipsdp_tpu_torch.core import branchbound, turbo
    from scipsdp_tpu_torch.utils.config import (BBSettings, IPMSettings,
                                                Settings)

    request = harness.driver_module("frontier_rungs").request
    g = cfg["guarantees"]
    settings = Settings(
        ipm=dataclasses.replace(IPMSettings(), gaptol=g["gaptol"],
                                feastol=g["feastol"], dtype=g["dtype"]),
        bb=dataclasses.replace(BBSettings(), feastol=g["feastol"],
                               batch_size=batch_size, turbo="on"))
    real_solve, real_turbo = turbo.ipm_solve, turbo.solve_turbo
    solves, trees = [], []
    state = {}

    def spy(data, b, lb, ub, **kw):
        if set(kw) != {"settings"}:
            raise ValueError(f"a call with {sorted(set(kw) - {'settings'})}")
        prob = state["prob"]
        host = [x.cpu().numpy() for x in (b, lb, ub)]
        rung, gamma, slots = slots_of(prob, *host, request)
        B = len(slots)
        if rung == "direct":
            if (state["wide"] == wide_rounds
                    or state["rounds"] == max_rounds):
                raise Enough
            state["rounds"] += 1
            state["wide"] += B == batch_size
        t0 = time.perf_counter()
        out = real_solve(data, b, lb, ub, **kw)
        status = out.status.cpu().numpy()
        wall = time.perf_counter() - t0
        live = [s is not None for s in slots]
        solves.append({"instance": state["i"], "width": B, "rung": rung,
                       "gamma": gamma, "slots": slots})
        print(json.dumps({"instance": state["i"], "rung": rung, "width": B,
                          "live": sum(live), "iters": int(out.iters),
                          "status": dict(collections.Counter(
                              int(x) for x in status[live])),
                          "wall_s": round(wall, 4)}), file=sys.stderr)
        return out

    def whole(*a, **kw):
        res = real_turbo(*a, **kw)
        if res is None:
            raise HandedOver
        return res

    turbo.ipm_solve, turbo.solve_turbo = spy, whole
    try:
        for i, seed in enumerate(cfg["instance_seeds"]):
            state.update(i=i, prob=Instance(cfg, seed).misdp(), rounds=0,
                         wide=0)
            first = len(solves)
            t0 = time.perf_counter()
            try:
                res = branchbound.solve_misdp(state["prob"], settings,
                                              device=torch.device(device))
                ended = res.status.name
            except Enough:
                ended = f"after {state['rounds']} rounds"
            except HandedOver:
                ended = (f"turbo handed the tree to the host loop after "
                         f"{state['rounds']} rounds")
            trees.append({"instance": i, "ended": ended,
                          "rounds": state["rounds"],
                          "wall_s": time.perf_counter() - t0,
                          **summary(solves[first:])})
    finally:
        turbo.ipm_solve, turbo.solve_turbo = real_solve, real_turbo
    return solves, trees


def rounds_of(solves: list) -> list:
    """The calls grouped in rounds: a direct call and the rung calls after
    it."""
    out = []
    for c in solves:
        if c["rung"] == "direct" or not out:
            out.append([])
        out[-1].append(c)
    return out


def trim(solves: list, width: int, keep_narrow: int = None) -> list:
    """``solves`` with each instance's rounds narrower than ``width`` cut
    to its first ``keep_narrow`` (None: all kept); every round at
    ``width`` kept."""
    out, narrow = [], collections.Counter()
    for rnd in rounds_of(solves):
        i = rnd[0]["instance"]
        if rnd[0]["width"] < width:
            narrow[i] += 1
            if keep_narrow is not None and narrow[i] > keep_narrow:
                continue
        out += rnd
    return out


def summary(calls: list) -> dict:
    """Calls, rounds by width and calls by rung of one instance's part of
    a mix."""
    return {"calls": len(calls),
            "rounds_by_width": dict(collections.Counter(
                str(c["width"]) for c in calls if c["rung"] == "direct")),
            "rungs": dict(collections.Counter(c["rung"] for c in calls))}


def write_mix(path: Path, mix: dict) -> None:
    """The mix as JSON, one recorded call a line."""
    lines = [f" {json.dumps(k)}: {json.dumps(v)}" for k, v in mix.items()
             if k != "solves"]
    lines.append(' "solves": [\n' + ",\n".join(
        "  " + json.dumps(c) for c in mix["solves"]) + "\n ]")
    path.write_text("{\n" + ",\n".join(lines) + "\n}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--batch-size", type=int, required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", required=True)
    ap.add_argument("--wide-rounds", type=int, default=2)
    ap.add_argument("--max-rounds", type=int, default=None)
    ap.add_argument("--keep-narrow", type=int, default=None)
    ap.add_argument("--why", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from misdp_bench import harness

    cfg = harness.load_json(harness.BENCH / "configs" / f"{args.config}.json")
    solves, trees = record(cfg, args.batch_size, args.device,
                           args.wide_rounds, args.max_rounds)
    kept = trim(solves, args.batch_size, args.keep_narrow)
    for t in trees:
        t["kept"] = summary([c for c in kept
                             if c["instance"] == t["instance"]])
    mix = {"kind": "frontier_rungs", "why": args.why,
           "recorded": {"config": args.config, "batch_size": args.batch_size,
                        "device": args.device,
                        "wide_rounds": args.wide_rounds,
                        "max_rounds": args.max_rounds,
                        "keep_narrow": args.keep_narrow, "trees": trees},
           "traced_passes": 1, "limits": {}, "solves": kept}
    write_mix(Path(args.out), mix)
    for t in trees:
        print(json.dumps(t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
