"""Min-k-partition node relaxations judged one by one: the answers of
batched solves, each live slot's status and bound, against the plain
reference (``reference/mkp_reference.py``) on the slot's box and rung.

An answer is a dict with ``instance`` (an index into the cell's
instances), ``rung`` ("direct", "probe" or "penalty"), ``gamma`` (the
penalty rung's Gamma), ``fix`` ((live slots, m) int8: -1 where y_t is
free, else the value it is fixed at), ``status`` and ``dobj``.

What a slot must give depends on its box, as the reference's phase-1
problem classes it (``mkp_reference.classify``), and on its rung:

* a direct slot: OPTIMAL on a box with an interior point; not OPTIMAL on
  an infeasible box; not INFEASIBLE on a box feasible on the boundary
  only (a feasible node reported infeasible is pruned), where any other
  status passes (the interior-point method has no interior to follow);
* a probe or penalty slot: OPTIMAL, on every box (its problem always has
  an interior point: any y in the box with r large enough), a box
  feasible on the boundary only too, where its optimum has r = 0 on a
  face of the cone, without strict complementarity.

Every OPTIMAL slot's bound is judged against the reference's value of
its own problem: the direct value (a boundary box's from its merged
problem), the probe's max(0, -t), the penalty problem's value; the
penalty problem of a boundary box the reference knows to
``mkp_reference.DEGENERATE`` only, and its slots are judged apart.
"""

from __future__ import annotations

import numpy as np

from misdp_bench.reference import mkp_reference as ref

OPTIMAL = 1             # SolverResultStatus.OPTIMAL
INFEASIBLE = 2          # SolverResultStatus.INFEASIBLE
PRUNED = (2, 6)         # INFEASIBLE, PRESOLVED_INFEASIBLE: the node is cut off


def fixdict(row: np.ndarray) -> dict:
    """{t: v} of one slot's fixings row."""
    return {int(t): int(row[t]) for t in np.where(row >= 0)[0]}


class Reference:
    """The reference's numbers for a cell's instances, each box and
    problem worked out once (boxes repeat every pass)."""

    def __init__(self, insts: list, device="cpu"):
        self.insts = insts
        self.device = device
        self.t = [{} for _ in insts]          # box -> phase-1 t (float64)

    def _t(self, i: int, keys: list) -> None:
        """Phase-1 values of the boxes ``keys`` of instance i."""
        todo = [k for k in dict.fromkeys(keys) if k not in self.t[i]]
        if todo:
            got = ref.phase1(self.insts[i].W, self.insts[i].k,
                             [dict(k) for k in todo], device=self.device)
            self.t[i].update(zip(todo, got))

    def classes(self, answers: list) -> list:
        """Each answer's slots' classes ("interior", "boundary",
        "infeasible"), one list an answer."""
        keys = [[tuple(sorted(fixdict(r).items())) for r in a["fix"]]
                for a in answers]
        for i in range(len(self.insts)):
            self._t(i, [k for a, ks in zip(answers, keys)
                        if a["instance"] == i for k in ks])
        return [[ref.classify(self.t[a["instance"]][k]) for k in ks]
                for a, ks in zip(answers, keys)]

    def values(self, answers: list, want: list, dtype=None,
               strict: bool = True) -> list:
        """The reference's value of every slot where ``want`` (one bool
        array an answer) holds, NaN elsewhere; in ``dtype`` (float64 by
        default) with ``strict`` as ``mkp_reference.ipm`` takes it.  Each
        distinct problem is solved once."""
        import torch

        dtype = torch.float64 if dtype is None else dtype
        cls = self.classes(answers)
        jobs = {}                 # (instance, rung, gamma, box) -> slots
        for a_i, (a, w) in enumerate(zip(answers, want)):
            for s in np.where(w)[0]:
                box = tuple(sorted(fixdict(a["fix"][s]).items()))
                kind = a["rung"]
                if kind != "probe" and cls[a_i][s] == "boundary":
                    kind += "_boundary"
                jobs.setdefault((a["instance"], kind, a["gamma"], box),
                                []).append((a_i, s))
        out = [np.full(a["status"].shape, np.nan) for a in answers]
        groups = {}
        for (i, kind, gamma, box) in jobs:
            groups.setdefault((i, kind, gamma), []).append(box)
        for (i, kind, gamma), boxes in groups.items():
            inst = self.insts[i]
            fixes = [dict(b) for b in boxes]
            if kind == "direct":
                vals = ref.direct_values(inst.W, inst.k, fixes, dtype,
                                         self.device, strict)
            elif kind == "direct_boundary":
                vals = ref.boundary_values(inst.W, inst.k, fixes, dtype,
                                           self.device, strict)
            elif kind == "probe":
                ts = (ref.phase1(inst.W, inst.k, fixes, dtype, self.device,
                                 strict)
                      if dtype != torch.float64 else
                      [self.t[i][b] for b in boxes])
                vals = [max(0.0, -t) for t in ts]
            else:
                vals = ref.penalty_values(inst.W, inst.k, fixes, gamma,
                                          kind == "penalty_boundary", dtype,
                                          self.device, strict)
            for b, v in zip(boxes, vals):
                for a_i, s in jobs[(i, kind, gamma, b)]:
                    out[a_i][s] = v
        return out


def rules(answer: dict, cls: list) -> tuple:
    """(must be OPTIMAL, must not be OPTIMAL, must not be INFEASIBLE) per
    slot of one answer."""
    interior = np.array([c == "interior" for c in cls], dtype=bool)
    infeas = np.array([c == "infeasible" for c in cls], dtype=bool)
    if answer["rung"] == "direct":
        return interior, infeas, ~infeas
    every = np.ones_like(interior)
    return every, ~every, every


def judge(reference: Reference, answers: list, gaptol: float) -> dict:
    """Over every live slot of ``answers``: ``slots``; ``undecided``, the
    slots whose status breaks their rule (:func:`rules`); ``failed``, those
    and the OPTIMAL slots whose gap passes ``gaptol`` (gaptol +
    ``DEGENERATE`` for the coarse ones); ``gaps``, each judged OPTIMAL
    slot's bound against the reference's value, relative to 1 + |value|,
    but the penalty slots of boundary boxes, whose value the reference
    knows to ``DEGENERATE`` only: their gaps are ``coarse``."""
    cls = reference.classes(answers)
    opt = [(a["status"] == OPTIMAL) & ~rules(a, c)[1]
           for a, c in zip(answers, cls)]
    refs = reference.values(answers, opt)
    gaps, coarse = [], []
    undecided = failed = 0
    for a, c, ok, val in zip(answers, cls, opt, refs):
        must, must_not, feasible = rules(a, c)
        is_opt = a["status"] == OPTIMAL
        is_inf = np.isin(a["status"], PRUNED)
        wrong = (must_not & is_opt) | (feasible & is_inf) | (must & ~is_opt)
        gap = np.abs(np.asarray(a["dobj"], np.float64) - val) / (
            1.0 + np.abs(val))
        gap = np.where(np.isfinite(gap), gap, np.inf)
        degenerate = np.array([a["rung"] == "penalty" and x == "boundary"
                               for x in c], dtype=bool)
        undecided += int(wrong.sum())
        limit = np.where(degenerate, gaptol + ref.DEGENERATE, gaptol)
        failed += int((wrong | (ok & (gap > limit))).sum())
        gaps.append(gap[ok & ~degenerate])
        coarse.append(gap[ok & degenerate])

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0)
    return {"slots": sum(a["status"].size for a in answers),
            "undecided": undecided, "failed": failed, "gaps": cat(gaps),
            "coarse": cat(coarse)}


def control_answers(reference: Reference, answers: list, dtype) -> list:
    """The reference in ``dtype`` put in the program's place: the same
    slots, each OPTIMAL at the reference's value in ``dtype`` (run to what
    it reaches), INFEASIBLE on a direct slot of an infeasible box.  The
    classes are the float64 reference's."""
    cls = reference.classes(answers)
    want = [~((a["rung"] == "direct")
              & np.array([x == "infeasible" for x in c], dtype=bool))
            for a, c in zip(answers, cls)]
    vals = reference.values(answers, want, dtype, strict=False)
    return [{**a, "status": np.where(w, OPTIMAL, INFEASIBLE),
             "dobj": np.where(w, v, np.nan)}
            for a, w, v in zip(answers, want, vals)]
