"""Traffic kind ``frontier_replay``: a real tree's batched solves, replayed
back to back without the tree.

The mix holds the calls that ``core/turbo.py`` made to ``ipm_solve`` in
whole trees of the configuration's instances (``record_frontier.py``):
each call's instance, width and, for every slot, the binaries its box
fixes, or nothing for a dead slot (a conflict box the solve's presolve
retires).  The window replays the whole list again and again, each pass
in an order drawn from ``--seed`` (pass p from the stream ``(seed, p)``),
so every seed sends the same solves in another order; the window ends
with the call in progress when its time runs out, and not before a whole
pass.  Each call is one
``scipsdp_tpu_torch.ops.ipm.ipm_solve`` on the boxes rebuilt from their
fixings, a cold start in the direct mode (penalty variable fixed at 0), as
turbo sends them at default settings.

The answers judged are every live slot's status and bound (its dual
objective), against the exact value of each box after the window
(``misdp_bench/nodes.py``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from misdp_bench import nodes, profiling
from misdp_bench.instances import Instance


def stream(seed: int, i: int) -> np.random.Generator:
    """The generator of pass i under ``seed`` (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence(
        [seed % 2**64, i % 2**64]))


def fixings(slots: list, n: int) -> np.ndarray:
    """(width, n) int8 of a recorded call: -1 where z_j is free, else the
    value it is fixed at; a dead slot's row is all -2."""
    fix = np.full((len(slots), n), -1, dtype=np.int8)
    for s, slot in enumerate(slots):
        if slot is None:
            fix[s] = -2
        else:
            for j, v in slot:
                fix[s, j] = v
    return fix


class Driver:
    """The recorded calls, each pass in an order from the seed."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.insts = [Instance(cfg, s) for s in cfg["instance_seeds"]]
        n = self.insts[0].nfeatures
        self.calls = [(c["instance"], fixings(c["slots"], n))
                      for c in traffic["solves"]]
        self.answers = []          # per solve: instance, fix, status, dobj
        self.solves = []           # per solve: wall, iters, slots, solved
        self.npass = self.pos = 0
        self.order = None

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from scipsdp_tpu_torch.models.problem import densify
        from scipsdp_tpu_torch.ops import ipm
        from scipsdp_tpu_torch.utils.config import (IPMSettings, Settings,
                                                    resolve_backend_autos)

        g = self.cfg["guarantees"]
        t0 = time.perf_counter()
        self.ipm = ipm
        self.probs = [inst.misdp() for inst in self.insts]
        self.data = [ipm.build_ipm_data(densify(p), self.device)
                     for p in self.probs]
        base = Settings(ipm=dataclasses.replace(
            IPMSettings(), gaptol=g["gaptol"], feastol=g["feastol"],
            dtype=g["dtype"]))
        self.settings = resolve_backend_autos(base, self.device).ipm
        t1 = time.perf_counter()
        # the warm-up: one pass in the recorded order, every shape and
        # every count of live slots the window sends
        for i, fix in self.calls:
            self._solve(i, fix, record=False)
        self.setup_parts = {"solver_data_s": t1 - t0,
                            "warmup_pass_s": time.perf_counter() - t1}

    def request(self, i: int, fix: np.ndarray):
        """(b, lb, ub) of the direct solve of every slot's box of instance
        i, with the penalty column; a dead slot gets turbo's conflict box
        (lower bounds 1, upper bounds 0)."""
        prob = self.probs[i]
        B, n = fix.shape
        lb = np.tile(prob.lb, (B, 1))
        ub = np.tile(prob.ub, (B, 1))
        zl, zu = lb[:, n:2 * n], ub[:, n:2 * n]
        fixed = fix >= 0
        zl[fixed] = fix[fixed]
        zu[fixed] = fix[fixed]
        dead = (fix == -2).all(1)
        lb[dead], ub[dead] = 1.0, 0.0
        b = np.concatenate([np.tile(prob.obj, (B, 1)), np.zeros((B, 1))], 1)
        zero = np.zeros((B, 1))
        return (b, np.concatenate([lb, zero], 1),
                np.concatenate([ub, zero], 1))

    def _solve(self, i: int, fix: np.ndarray, record: bool = True) -> None:
        req = self.request(i, fix)
        t0 = time.perf_counter()
        out = self.ipm.ipm_solve(self.data[i], *req, settings=self.settings)
        status = out.status.cpu().numpy()      # the solve's end
        dobj = out.dobj.cpu().numpy()
        wall = time.perf_counter() - t0
        if record:
            live = ~(fix == -2).all(1)
            self.answers.append({"instance": i, "fix": fix[live],
                                 "status": status[live], "dobj": dobj[live]})
            self.solves.append({"wall_s": wall, "iters": int(out.iters),
                                "slots": int(live.sum()),
                                "solved": int((status[live]
                                               == nodes.OPTIMAL).sum())})

    # -- the window --------------------------------------------------------
    def step(self) -> None:
        """The next call of the current pass; a pass's order is drawn when
        it begins."""
        if self.pos == 0:
            self.order = self.pass_order(self.npass)
        self._solve(*self.calls[self.order[self.pos]])
        self.pos += 1
        if self.pos == len(self.calls):
            self.pos, self.npass = 0, self.npass + 1

    def pass_order(self, p: int) -> np.ndarray:
        """The order of the recorded calls in pass p."""
        return stream(self.seed, p).permutation(len(self.calls))

    def run_pass(self) -> None:
        """As many calls as a pass holds."""
        for _ in self.calls:
            self.step()

    def window_complete(self) -> bool:
        """Not before every recorded call has been solved once."""
        return self.npass > 0

    # -- the traced run ----------------------------------------------------
    def trace(self) -> dict:
        """After the window: ``traced_passes`` more passes under the
        profiler (CUDA activity) with the probe Cholesky's bytes counted,
        one in CUDA sync debug mode, one under CPU and CUDA activity for
        the breakdown's idle gaps.  Their answers are judged too."""
        n_traced = int(self.traffic["traced_passes"])
        spy = profiling.CholSpy()
        first = len(self.solves)
        with spy.active():
            prof = profiling.profiled(
                lambda: [self.run_pass() for _ in range(n_traced)])
        iters = sum(s["iters"] for s in self.solves[first:])
        first = len(self.solves)
        with profiling.sync_sites() as sites:
            self.run_pass()
        sync_solves = len(self.solves) - first
        host = profiling.profiled(self.run_pass, with_cpu=True)
        return {"profile": prof, "profile_iters": iters,
                "chol_calls": spy.calls, "chol_bytes": spy.bytes,
                "syncs": len(sites), "sync_solves": sync_solves,
                "breakdown": {"device_ops": profiling.top(prof["by_name"]),
                              "idle_gaps": profiling.top(host["gaps"])}}

    def release(self) -> None:
        self.data = None

    def record(self) -> dict:
        return {"solves": self.solves}

    # -- correctness -------------------------------------------------------
    def control_answers(self, dtype=np.float32) -> list:
        """The reference in ``dtype`` put in the program's place on the
        window's boxes."""
        return nodes.control_answers(self.insts, self.answers, dtype)

    def check(self, answers=None) -> tuple:
        """(attempted, failed, checks) over the live slots.  ``unsolved``:
        slots not decided as the reference decides them (OPTIMAL, or
        infeasible where it finds no point), held at 0.  ``bound_gap``: the
        worst OPTIMAL slot's bound against the exact value, relative to
        1 + |value|, held at the configuration's gaptol, the guarantee it
        states; ``bound_gap_median``: the median slot's, held at
        ``limits`` (set from readings, PERF.md)."""
        answers = self.answers if answers is None else answers
        j = nodes.judge(self.insts, answers,
                        self.cfg["guarantees"]["gaptol"])
        checks = {
            "unsolved": (j["undecided"], 0),
            "bound_gap": (nodes.worst(j["gaps"]),
                          self.cfg["guarantees"]["gaptol"]),
            "bound_gap_median": (nodes.median(j["gaps"]),
                                 self.traffic["limits"]["bound_gap_median"])}
        return j["slots"], j["failed"], checks
