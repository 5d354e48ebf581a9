"""Traffic kind ``frontier_rungs``: a real tree's batched solves with their
feasibility-probe and penalty rungs, replayed back to back without the
tree.

The mix holds the calls that ``core/turbo.py`` made to ``ipm_solve`` in
the first rounds of the configuration's instances' trees
(``record_frontier_rungs.py``): each call's instance, width, rung
(``direct``; ``probe``, Gamma = 1 on the penalty variable and a zero
objective; ``penalty`` at its ``gamma``) and, for every slot, the binaries
its box fixes, or nothing for a dead slot.  The replay is
``frontier_replay``'s: every pass sends each recorded call once in an
order drawn from ``--seed``, cold, one ``scipsdp_tpu_torch.ops.ipm.
ipm_solve`` a call on the boxes rebuilt from their fixings with the rung's
objective and penalty-variable bounds, as turbo sends them; a warm-up pass
in set-up (``frontier_replay``'s); a window of at least one pass.

The answers judged are every live slot's status and bound against the
plain reference on the slot's own box and rung (``misdp_bench/
nodes_mkp.py``).  A traced run's passes are whole passes, and it adds the
program's span passes (``spans.span_passes``).
"""

from __future__ import annotations

import time

import numpy as np

from misdp_bench import harness, nodes_mkp, spans
from misdp_bench.nodes import median, worst
from misdp_bench.instances_mkp import Instance

replay = harness.driver_module("frontier_replay")
PENALTY_UB = 1e20       # turbo's upper bound of the penalty variable


def request(prob, fix: np.ndarray, rung: str, gamma: float) -> tuple:
    """(b, lb, ub) of one call as turbo builds it: the instance's box with
    the fixed binaries moved; the direct rung with the penalty variable
    fixed at 0 and the objective, the probe with a zero objective and 1
    on the penalty variable, the penalty rung with the objective and
    ``gamma`` on it, both with the penalty variable in [0, 1e20]; a dead
    slot gets turbo's conflict box (all lower bounds 1, upper bounds 0,
    the penalty variable's too in the probe and penalty rungs)."""
    B, m = fix.shape
    lb = np.tile(prob.lb, (B, 1))
    ub = np.tile(prob.ub, (B, 1))
    fixed = fix >= 0
    lb[fixed] = fix[fixed]
    ub[fixed] = fix[fixed]
    dead = (fix == -2).all(1)
    lb[dead], ub[dead] = 1.0, 0.0
    zero = np.zeros((B, 1))
    if rung == "direct":
        b = np.concatenate([np.tile(prob.obj, (B, 1)), zero], 1)
        return (b, np.concatenate([lb, zero], 1),
                np.concatenate([ub, zero], 1))
    obj = np.zeros(m) if rung == "probe" else prob.obj
    pen = 1.0 if rung == "probe" else gamma
    b = np.concatenate([np.tile(obj, (B, 1)), np.full((B, 1), pen)], 1)
    rl = np.where(dead[:, None], 1.0, 0.0)
    ru = np.where(dead[:, None], 0.0, PENALTY_UB)
    return b, np.concatenate([lb, rl], 1), np.concatenate([ub, ru], 1)


class Driver(replay.Driver):
    """The recorded calls, each pass in an order from the seed."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.insts = [Instance(cfg, s) for s in cfg["instance_seeds"]]
        m = self.insts[0].nvars
        # (instance, (fixings, rung, gamma)): frontier_replay's set-up and
        # window pass the pair to _solve
        self.calls = [(c["instance"], (replay.fixings(c["slots"], m),
                                       c["rung"], float(c["gamma"])))
                      for c in traffic["solves"]]
        self.answers = []
        self.solves = []
        self.npass = self.pos = 0
        self.order = None

    def _solve(self, i: int, call: tuple, record: bool = True) -> None:
        fix, rung, gamma = call
        req = request(self.probs[i], fix, rung, gamma)
        t0 = time.perf_counter()
        out = self.ipm.ipm_solve(self.data[i], *req, settings=self.settings)
        status = out.status.cpu().numpy()      # the solve's end
        dobj = out.dobj.cpu().numpy()
        wall = time.perf_counter() - t0
        if record:
            live = ~(fix == -2).all(1)
            self.answers.append({"instance": i, "rung": rung,
                                 "gamma": gamma, "fix": fix[live],
                                 "status": status[live],
                                 "dobj": dobj[live]})
            self.solves.append({"wall_s": wall, "iters": int(out.iters),
                                "slots": int(live.sum()),
                                "solved": int((status[live]
                                               == nodes_mkp.OPTIMAL).sum())})

    def trace(self) -> dict:
        """The pass in progress finished, so that every traced pass sends
        each recorded call once; then ``frontier_replay``'s traced passes
        and the program's span passes (nothing against a program without
        the tracer)."""
        while self.pos:
            self.step()
        return {**super().trace(), **spans.span_passes(self)}

    def reference(self):
        """The plain reference for this run's instances, on the run's
        device."""
        if getattr(self, "_ref", None) is None:
            self._ref = nodes_mkp.Reference(self.insts, self.device)
        return self._ref

    def control_answers(self, dtype=np.float32) -> list:
        """The reference in ``dtype`` put in the program's place on the
        window's boxes."""
        import torch

        tdt = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
        return nodes_mkp.control_answers(self.reference(), self.answers,
                                         tdt)

    def check(self, answers=None) -> tuple:
        """(attempted, failed, checks) over the live slots.  ``unsolved``:
        slots whose status breaks their rule (``nodes_mkp.rules``), held
        at 0.  ``bound_gap``: the worst judged OPTIMAL slot's bound against
        the reference's value, relative to 1 + |value|, held at the
        configuration's gaptol, and ``bound_gap_median`` the median's,
        held at ``limits``, both but the penalty slots of boundary boxes;
        ``bound_gap_degenerate``: the worst of those, whose values the
        reference knows to ``DEGENERATE`` only, held at gaptol plus
        that."""
        answers = self.answers if answers is None else answers
        j = nodes_mkp.judge(self.reference(), answers,
                            self.cfg["guarantees"]["gaptol"])
        gaptol = self.cfg["guarantees"]["gaptol"]
        limits = self.traffic["limits"]
        checks = {
            "unsolved": (j["undecided"], 0),
            "bound_gap": (worst(j["gaps"]), gaptol),
            "bound_gap_median": (median(j["gaps"]),
                                 limits["bound_gap_median"]),
            "bound_gap_degenerate": (worst(j["coarse"]),
                                     gaptol + nodes_mkp.ref.DEGENERATE)}
        return j["slots"], j["failed"], checks
