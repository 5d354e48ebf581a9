"""Record the batches of node boxes that a real tree hands to the batched
solve, and write them as a ``frontier_replay`` traffic mix.

    python3 misdp_bench/record_frontier.py --config <name> --batch-size B \\
        --out misdp_bench/traffic/<mix>.json [--device cuda]

Each instance of the configuration is solved whole by
``scipsdp_tpu_torch.core.branchbound.solve_misdp`` at default settings but
``batch_size`` (and the configuration's tolerances), with the device-resident
tree engaged (``core/turbo.py``), while a spy on turbo's ``ipm_solve`` keeps
every call: its width, and for each slot the binaries its box fixes, or
nothing where the slot is a dead one (a conflict box the solve's presolve
retires).  The mix keeps the calls in the tree's order, so its depths,
shared branch paths and widths are the tree's own.  A call whose box moves
anything else than a binary, or whose objective is not the direct one,
stops the recording: ``drivers/frontier_replay.py`` rebuilds boxes from
fixings alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def record(cfg: dict, batch_size: int, device: str) -> tuple:
    """(solves, trees) of every instance of ``cfg``: the spy's calls as
    {"instance", "width", "slots"} and each tree's summary."""
    import torch

    from misdp_bench.instances import Instance
    from scipsdp_tpu_torch.core import branchbound, turbo
    from scipsdp_tpu_torch.utils.config import (BBSettings, IPMSettings,
                                                Settings)

    g = cfg["guarantees"]
    settings = Settings(
        ipm=dataclasses.replace(IPMSettings(), gaptol=g["gaptol"],
                                feastol=g["feastol"], dtype=g["dtype"]),
        bb=dataclasses.replace(BBSettings(), feastol=g["feastol"],
                               batch_size=batch_size, turbo="on"))
    calls = []
    real = turbo.ipm_solve

    def spy(data, b, lb, ub, **kw):
        calls.append((b.cpu().numpy(), lb.cpu().numpy(), ub.cpu().numpy()))
        return real(data, b, lb, ub, **kw)

    solves, trees = [], []
    turbo.ipm_solve = spy
    try:
        for i, seed in enumerate(cfg["instance_seeds"]):
            inst = Instance(cfg, seed)
            prob = inst.misdp()
            calls.clear()
            t0 = time.perf_counter()
            res = branchbound.solve_misdp(prob, settings,
                                          device=torch.device(device))
            trees.append({"instance": i, "status": res.status.name,
                          "nodes": int(res.stats.nodes),
                          "ipm_iters": int(res.stats.ipm_iterations),
                          "solves": len(calls),
                          "wall_s": time.perf_counter() - t0})
            for b, lb, ub in calls:
                solves.append({"instance": i, "width": int(lb.shape[0]),
                               "slots": slots_of(prob, b, lb, ub)})
    finally:
        turbo.ipm_solve = real
    return solves, trees


def slots_of(prob, b, lb, ub) -> list:
    """Each slot's fixings [[j, v], ...] (j the feature, v its binary's
    value), or None for a dead slot; raises where a box or the objective
    is not one that fixings rebuild."""
    from misdp_bench.nodes import fixings_of

    fix = fixings_of(prob, b, lb, ub)
    if fix is None:
        raise ValueError("a call that is not a direct solve whose boxes "
                         "move binaries alone")
    return [None if (row == -2).all() else
            [[int(j), int(row[j])] for j in np.where(row >= 0)[0]]
            for row in fix]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--batch-size", type=int, required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", required=True)
    ap.add_argument("--why", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from misdp_bench import harness

    cfg = harness.load_json(harness.BENCH / "configs" / f"{args.config}.json")
    solves, trees = record(cfg, args.batch_size, args.device)
    mix = {"kind": "frontier_replay", "why": args.why,
           "recorded": {"config": args.config, "batch_size": args.batch_size,
                        "device": args.device, "trees": trees},
           "traced_passes": 1, "limits": {}, "solves": solves}
    lines = [f" {json.dumps(k)}: {json.dumps(v)}" for k, v in mix.items()
             if k != "solves"]
    lines.append(' "solves": [\n' + ",\n".join(
        "  " + json.dumps(c) for c in solves) + "\n ]")
    Path(args.out).write_text("{\n" + ",\n".join(lines) + "\n}\n")
    for t in trees:
        print(json.dumps(t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
