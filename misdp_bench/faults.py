"""Faults planted under a cell's timed path, to see its check come out not
correct.  The benchmark's runs never plant them.

    python3 misdp_bench/faults.py --workload <cell> --seed <n> [<n> ...] \\
        [--seconds S] [--device cuda]

runs the cell past its look for a card (harness.run_cell) with each fault
of its kind in place, at the cell's own configuration and mix, and prints
one JSON line per fault and seed with the checks' readings.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def state_unchanged(real):
    """Every batched solve returns its starting point: no iteration."""
    def solve(*a, settings, **kw):
        return real(*a, settings=dataclasses.replace(settings, max_iters=0),
                    **kw)
    return solve


def half_of_the_batch(real):
    """Only the first half of each batch is solved; the other half is
    answered with the first half's statuses and bounds."""
    import torch

    def solve(data, b, lb, ub, *rest, **kw):
        h = b.shape[0] // 2
        out = real(data, b[:h], lb[:h], ub[:h], *rest, **kw)
        return out._replace(status=torch.cat([out.status, out.status]),
                            dobj=torch.cat([out.dobj, out.dobj]))
    return solve


def alter_first_bound(real):
    """The first slot's bound is altered by one part in a thousand where
    it is produced."""
    def solve(*a, **kw):
        out = real(*a, **kw)
        dobj = out.dobj.clone()
        dobj[0] *= 1 + 1e-3
        return out._replace(dobj=dobj)
    return solve


def alter_optimum(real):
    """The tree's optimum is altered by one part in ten thousand."""
    def solve(*a, **kw):
        res = real(*a, **kw)
        res.objval *= 1 + 1e-4
        return res
    return solve


def alter_incumbent(real):
    """The incumbent's largest binary is set to 0."""
    def solve(prob, *a, **kw):
        res = real(prob, *a, **kw)
        n = (prob.nvars - 1) // 2
        y = np.array(res.best_y, dtype=np.float64)
        y[n + int(np.argmax(y[n:2 * n]))] = 0.0
        res.best_y = y
        return res
    return solve


def half_of_each_batch_infeasible(real):
    """Every batched solve (the host loop's and turbo's alike) reports the
    later half of the nodes it solved infeasible: they are pruned
    unsolved."""
    from scipsdp_tpu_torch.utils.status import SolverResultStatus

    opt = int(SolverResultStatus.OPTIMAL)

    def steps(*a, **kw):
        out = yield from real(*a, **kw)
        st = out.status.clone()
        solved = torch_nonzero(st == opt)
        st[solved[(solved.numel() + 1) // 2:]] = int(
            SolverResultStatus.INFEASIBLE)
        return out._replace(status=st)
    return steps


def torch_nonzero(mask):
    import torch

    return torch.nonzero(mask).flatten()


# (module, attribute, fault) by traffic kind
FAULTS = {
    "frontier_replay": [("ipm", "ipm_solve", state_unchanged),
                        ("ipm", "ipm_solve", half_of_the_batch),
                        ("ipm", "ipm_solve", alter_first_bound)],
    "tree_cycle": [("branchbound", "solve_misdp", alter_optimum),
                   ("branchbound", "solve_misdp", alter_incumbent),
                   ("ipm", "ipm_steps", half_of_each_batch_infeasible)],
}


@contextlib.contextmanager
def planted(module: str, attr: str, fault):
    from scipsdp_tpu_torch.core import branchbound
    from scipsdp_tpu_torch.ops import ipm

    mod = {"branchbound": branchbound, "ipm": ipm}[module]
    real = getattr(mod, attr)
    setattr(mod, attr, fault(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def run_with_fault(workload, fault_name: str, seed: int,
                   seconds: float = 0.0, device: str = "cpu") -> dict:
    """The result line of one run of ``workload`` (a cell of
    BENCHMARK.json by name, or a cell entry) with the fault of its kind
    named ``fault_name`` in place."""
    from misdp_bench import harness

    cell, cfg, traffic = harness.find_cell(workload)
    (module, attr, fault), = [f for f in FAULTS[traffic["kind"]]
                              if f[2].__name__ == fault_name]
    with planted(module, attr, fault):
        out = harness.run_cell(cell, cfg, traffic, seed, seconds, False,
                               device, time.perf_counter())
    return harness.result_line(out, {}, False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from misdp_bench import harness

    _, _, traffic = harness.find_cell(args.workload)
    for _, _, fault in FAULTS[traffic["kind"]]:
        for seed in args.seed:
            line = run_with_fault(args.workload, fault.__name__, seed,
                                  args.seconds, args.device)
            print(json.dumps({"workload": args.workload,
                              "fault": fault.__name__, "seed": seed,
                              "correct": line["correct"],
                              "attempted": line["attempted"],
                              "failed": line["failed"],
                              "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
