"""Node relaxations judged one by one: the answers of batched solves (each
live slot's status and bound) against the plain reference's exact value of
its box.  Both the replay cell and the tree cell judge their solves here.

An answer is a dict with ``instance`` (an index into the cell's
instances), ``fix`` ((live slots, n) int8: -1 where z_j is free, else the
value it is fixed at), ``status`` and ``dobj`` (one entry a live slot).
"""

from __future__ import annotations

import numpy as np

from misdp_bench.reference import cls_reference

OPTIMAL = 1             # SolverResultStatus.OPTIMAL
INFEASIBLE = (2, 6)     # INFEASIBLE, PRESOLVED_INFEASIBLE


def fixings_of(prob, b, lb, ub):
    """(width, n) int8 fixings of a batched solve's boxes (a dead slot's
    row all -2: a conflict box the solve's presolve retires), or None
    where the call is not a direct solve whose boxes move binaries
    alone."""
    n = (prob.nvars - 1) // 2
    m = prob.nvars
    if not np.array_equal(b[:, :m], np.tile(prob.obj, (b.shape[0], 1))) \
            or np.any(b[:, m] != 0):
        return None
    fix = np.full((lb.shape[0], n), -1, dtype=np.int8)
    for s, (lo, hi) in enumerate(zip(lb, ub)):
        if np.any(lo > hi):
            fix[s] = -2
            continue
        zl, zu = lo[n:2 * n], hi[n:2 * n]
        fixed = zl == zu
        want_l, want_u = prob.lb.copy(), np.minimum(prob.ub, 1e20)
        want_l[n:2 * n] = np.where(fixed, zl, prob.lb[n:2 * n])
        want_u[n:2 * n] = np.where(fixed, zu, prob.ub[n:2 * n])
        if not (np.array_equal(lo[:m], want_l)
                and np.array_equal(np.minimum(hi[:m], 1e20), want_u)
                and lo[m] == 0 and hi[m] == 0
                and np.all((zl[fixed] == 0) | (zl[fixed] == 1))):
            return None
        fix[s, fixed] = zl[fixed]
    return fix


def reference_values(insts: list, answers: list, dtype=np.float64) -> list:
    """The reference's value of every slot of ``answers`` (exact least
    squares in ``dtype``; NaN where the node is infeasible), one array an
    answer."""
    caches = [{} for _ in insts]
    out = []
    for a in answers:
        inst = insts[a["instance"]]
        vals = np.empty(a["fix"].shape[0])
        for s, row in enumerate(a["fix"]):
            zfix = {int(j): int(row[j]) for j in np.where(row >= 0)[0]}
            val = cls_reference.node_value(inst.A, inst.b, inst.k, inst.M,
                                           zfix, dtype,
                                           caches[a["instance"]])
            vals[s] = np.nan if val is None else val
        out.append(vals)
    return out


def control_answers(insts: list, answers: list, dtype=np.float32) -> list:
    """The reference in ``dtype`` put in the program's place: the same
    boxes, each slot OPTIMAL at the reference's value (INFEASIBLE where the
    reference finds no point)."""
    vals = reference_values(insts, answers, dtype)
    return [{"instance": a["instance"], "fix": a["fix"],
             "status": np.where(np.isnan(v), INFEASIBLE[0], OPTIMAL),
             "dobj": v} for a, v in zip(answers, vals)]


def judge(insts: list, answers: list, gaptol: float) -> dict:
    """Over every live slot of ``answers``: ``slots``; ``undecided``, the
    slots whose status is not OPTIMAL, or not infeasible where the
    reference finds the node infeasible; ``failed``, those and the OPTIMAL
    slots whose gap passes ``gaptol``; ``gaps``, each OPTIMAL slot's bound
    against the exact value, relative to 1 + |value|."""
    refs = reference_values(insts, answers)
    gaps, undecided, failed = [], 0, 0
    for a, ref in zip(answers, refs):
        infeas = np.isnan(ref)
        ok = (a["status"] == OPTIMAL) & ~infeas
        right = ok | (infeas & np.isin(a["status"], INFEASIBLE))
        gap = np.abs(np.asarray(a["dobj"], np.float64) - ref) / (
            1.0 + np.abs(ref))
        gap = np.where(np.isfinite(gap), gap, np.inf)
        undecided += int((~right).sum())
        failed += int((~right | (ok & (gap > gaptol))).sum())
        gaps.append(gap[ok])
    gaps = np.concatenate(gaps) if gaps else np.zeros(0)
    return {"slots": sum(a["status"].size for a in answers),
            "undecided": undecided, "failed": failed, "gaps": gaps}


def worst(gaps) -> float:
    return float(gaps.max(initial=0.0))


def median(gaps) -> float:
    return float(np.median(gaps)) if gaps.size else float("inf")
