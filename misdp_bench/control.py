"""The control of a cell's correctness check: the plain reference, one
precision lower (float32 for the configurations' float64), put in the
program's place on the cell's own inputs and judged by the cell's own
check.  It has to come out not correct; its readings set the upper end of
each limit (PERF.md).  The benchmark's runs never run it.

    python3 misdp_bench/control.py --workload <cell> --seed <n> [<n> ...] \\
        [--seconds S] [--device cuda]

runs the cell's window (past its look for a card) to have the answers a
run judges, the boxes of its solves and the trees of its cycle, then
answers every one of them with the reference in float32 instead, and
prints one JSON line per seed with the program's and the control's
readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def control_checks(workload, seed: int, seconds: float = 0.0,
                   device: str = "cpu", dtype=np.float32) -> dict:
    """The program's checks and the control's (the reference in ``dtype``
    on the same answers) after one window of ``workload`` (a cell of
    BENCHMARK.json by name, or a cell entry)."""
    from misdp_bench import harness

    cell, cfg, traffic = harness.find_cell(workload)
    drv = harness.driver_module(traffic["kind"]).Driver(cfg, traffic, seed,
                                                        device)
    drv.setup()
    t0 = time.perf_counter()
    while True:
        drv.step()
        if time.perf_counter() - t0 >= seconds and drv.window_complete():
            break
    drv.release()
    program = drv.check()
    control = drv.check(drv.control_answers(dtype))

    def checks(got):
        attempted, failed, c = got
        return {"attempted": attempted, "failed": failed,
                "correct": all(v <= lim for v, lim in c.values()),
                "checks": {k: {"value": v, "limit": lim}
                           for k, (v, lim) in c.items()}}

    return {"workload": cell["name"], "seed": seed,
            "dtype": np.dtype(dtype).name, "program": checks(program),
            "control": checks(control)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in args.seed:
        print(json.dumps(control_checks(args.workload, seed, args.seconds,
                                        args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
