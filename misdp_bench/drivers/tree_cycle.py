"""Traffic kind ``tree_cycle``: whole branch-and-bound solves to a proven
optimum, the configuration's instances in turn, again and again.

Each tree is one ``scipsdp_tpu_torch.core.branchbound.solve_misdp`` call at
default settings but ``batch_size`` (and the configuration's tolerances),
so on the card "auto" engages the device-resident tree (``core/turbo.py``).
``--seed`` sets the order of the cycle and the solver's ``Settings.seed``
(which moves no tree of these instances: the same nodes and iterations on
every seed).  The window ends with the tree in progress when its
time runs out, and not before every instance has been solved once.

The answers judged are every tree's status, optimum, dual bound and
incumbent, against each instance's exact optimum
(``reference/cls_reference.py::best_subset``), and every node relaxation
the trees solved: a spy on turbo's ``ipm_solve`` (and the host loop's,
where the tree runs there) keeps each call's boxes
and each slot's status and bound on the device (a clone, no host read in
the window), and after the window ``misdp_bench/nodes.py`` judges every
live slot of the direct solves against the exact value of its box.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from misdp_bench import nodes, profiling
from misdp_bench.instances import Instance
from misdp_bench.reference import cls_reference


class Driver:
    """The configuration's instances, solved whole in a cycle."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.insts = [Instance(cfg, s) for s in cfg["instance_seeds"]]
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed % 2**64, 0]))
        self.order = [int(i) for i in rng.permutation(len(self.insts))]
        self.answers = []    # per tree: instance, status, objval, bound, y
        self.trees = []      # per tree: instance, wall, nodes, iters
        self.calls = []      # per batched solve: instance, b, lb, ub, out
        self.node_answers = []
        self.rung_calls = 0
        self.ntree = 0

    def setup(self) -> None:
        from scipsdp_tpu_torch.core import branchbound, sdpi, turbo
        from scipsdp_tpu_torch.utils.config import (BBSettings, IPMSettings,
                                                    Settings)

        g = self.cfg["guarantees"]
        t0 = time.perf_counter()
        self.bb = branchbound
        self.probs = [inst.misdp() for inst in self.insts]
        self.settings = Settings(
            ipm=dataclasses.replace(IPMSettings(), gaptol=g["gaptol"],
                                    feastol=g["feastol"], dtype=g["dtype"]),
            bb=dataclasses.replace(BBSettings(), feastol=g["feastol"],
                                   batch_size=int(self.traffic["batch_size"])),
            seed=self.seed % 2**31)
        self.install_spy(turbo, sdpi)
        t1 = time.perf_counter()
        # the warm-up tree: the cell's own path and widths
        self._solve(int(self.traffic["warmup_instance"]), record=False)
        self.setup_parts = {"instances_s": t1 - t0,
                            "warmup_tree_s": time.perf_counter() - t1}

    def install_spy(self, *modules) -> None:
        """Keep every batched solve that ``modules`` make through their
        ``ipm_solve`` (turbo's rounds; the host loop's ladder where the
        tree runs there), its inputs and its statuses and bounds cloned on
        the device, for the check."""
        self.spied = []
        for mod in modules:
            real = mod.ipm_solve

            def spy(data, b, lb, ub, *rest, _real=real, **kw):
                out = _real(data, b, lb, ub, *rest, **kw)
                self.calls.append((self.current, b.clone(), lb.clone(),
                                   ub.clone(), out.status.clone(),
                                   out.dobj.clone()))
                return out

            mod.ipm_solve = spy
            self.spied.append((mod, real))

    def _solve(self, i: int, record: bool = True):
        self.current = i if record else None
        t0 = time.perf_counter()
        res = self.bb.solve_misdp(self.probs[i], self.settings,
                                  device=self.device)
        wall = time.perf_counter() - t0
        if record:
            self.answers.append({
                "instance": i, "status": res.status.name,
                "objval": res.objval, "dual_bound": res.dual_bound,
                "y": None if res.best_y is None else np.asarray(res.best_y)})
            self.trees.append({"instance": i, "wall_s": wall,
                               "nodes": int(res.stats.nodes),
                               "ipm_iters": int(res.stats.ipm_iterations)})
        return res

    def step(self) -> None:
        self._solve(self.order[self.ntree % len(self.order)])
        self.ntree += 1

    def window_complete(self) -> bool:
        return len({t["instance"] for t in self.trees}) == len(self.insts)

    def trace(self) -> dict:
        """After the window: one tree of ``traced_instance`` under the
        profiler with CUDA activity (busy time, launches, idle), then the
        same tree with CPU activity too, for the breakdown's idle gaps by
        host op.  Their answers are judged too."""
        i = int(self.traffic["traced_instance"])
        prof = profiling.profiled(lambda: self._solve(i))
        iters = self.trees[-1]["ipm_iters"]
        host = profiling.profiled(lambda: self._solve(i), with_cpu=True)
        return {"profile": prof, "profile_iters": iters,
                "breakdown": {"device_ops": profiling.top(prof["by_name"]),
                              "idle_gaps": profiling.top(host["gaps"])}}

    def release(self) -> None:
        """Move the kept solves to the host as answers (the direct solves'
        live slots; the rungs' probe and penalty solves are counted, not
        judged), and take the spy off."""
        for mod, real in self.spied:
            mod.ipm_solve = real
        for i, *tensors in self.calls:
            if i is None:
                continue
            b, lb, ub, status, dobj = (t.cpu().numpy() for t in tensors)
            fix = nodes.fixings_of(self.probs[i], b, lb, ub)
            if fix is None:
                self.rung_calls += 1
                continue
            live = ~(fix == -2).all(1)
            self.node_answers.append({"instance": i, "fix": fix[live],
                                      "status": status[live],
                                      "dobj": dobj[live]})
        self.calls = []
        self.probs = None

    def record(self) -> dict:
        return {"trees": self.trees}

    # -- correctness -------------------------------------------------------
    def optima(self, dtype=np.float64) -> dict:
        """Each solved instance's exact optimum (value, support), by the
        reference in ``dtype``."""
        out = {}
        for a in self.answers:
            i = a["instance"]
            if i not in out:
                inst = self.insts[i]
                val, sup, _ = cls_reference.best_subset(
                    inst.A, inst.b, inst.k, inst.M, dtype)
                out[i] = (val, sup)
        return out

    def control_answers(self, dtype=np.float32) -> dict:
        """The reference in ``dtype`` put in the program's place: every
        tree answered with its optimum, support and least-squares point,
        every node of the trees' solves with its exact value."""
        opt = self.optima(dtype)
        out = []
        for a in self.answers:
            inst = self.insts[a["instance"]]
            val, sup = opt[a["instance"]]
            n = inst.nfeatures
            _, x = cls_reference.rss(inst.A, inst.b, sup, dtype)
            y = np.zeros(2 * n + 1, dtype=dtype)
            y[sup] = x
            y[[n + j for j in sup]] = 1
            y[2 * n] = val
            out.append({"instance": a["instance"], "status": "OPTIMAL",
                        "objval": val, "dual_bound": val, "y": y})
        return {"trees": out, "nodes": nodes.control_answers(
            self.insts, self.node_answers, dtype)}

    def check(self, answers=None) -> tuple:
        """(attempted, failed, checks) over the trees and the live slots of
        their direct solves.  ``opt_gap``: the worst of the optimum, the
        dual bound and the exact value of the incumbent's support against
        the exact optimum, relative to 1 + |optimum|; ``incumbent_viol``:
        the incumbent's worst violation of the configuration's constraints;
        ``node_bound_gap``: the worst OPTIMAL node's bound against the
        exact value of its box, relative to 1 + |value|.  These three are
        held at the configuration's gaptol and feastol, the guarantees it
        states.  ``node_bound_gap_median``: the median node's, held at
        ``limits`` (set from readings, PERF.md).  ``not_optimal``: trees
        that did not end OPTIMAL with an incumbent; ``node_unsolved``:
        nodes not decided as the reference decides them; both held at
        0."""
        if answers is None:
            answers = {"trees": self.answers, "nodes": self.node_answers}
        g = self.cfg["guarantees"]
        opt = self.optima()
        gap_w = viol_w = 0.0
        failed = not_opt = 0
        for a in answers["trees"]:
            inst = self.insts[a["instance"]]
            fstar = opt[a["instance"]][0]
            if a["status"] != "OPTIMAL" or a["y"] is None:
                not_opt += 1
                failed += 1
                continue
            n = inst.nfeatures
            sval = cls_reference.support_value(inst.A, inst.b, inst.k,
                                               inst.M, a["y"][n:2 * n])
            terms = [a["objval"], a["dual_bound"],
                     np.inf if sval is None else sval]
            gap = max(abs(float(v) - fstar) for v in terms) / (1 + abs(fstar))
            gap = gap if np.isfinite(gap) else np.inf
            viol = cls_reference.incumbent_violation(inst.A, inst.b, inst.k,
                                                     inst.M, a["y"])
            failed += int(gap > g["gaptol"] or viol > g["feastol"])
            gap_w, viol_w = max(gap_w, gap), max(viol_w, viol)
        j = nodes.judge(self.insts, answers["nodes"], g["gaptol"])
        checks = {"opt_gap": (gap_w, g["gaptol"]),
                  "incumbent_viol": (viol_w, g["feastol"]),
                  "not_optimal": (not_opt, 0),
                  "node_unsolved": (j["undecided"], 0),
                  "node_bound_gap": (nodes.worst(j["gaps"]), g["gaptol"]),
                  "node_bound_gap_median": (
                      nodes.median(j["gaps"]),
                      self.traffic["limits"]["node_bound_gap_median"])}
        return (len(answers["trees"]) + j["slots"], failed + j["failed"],
                checks)
