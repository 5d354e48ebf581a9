"""Plain reference for the CLS cells: exact values from least squares.

A CLS instance (``misdp_bench/instances.py``) is

    min ||A x - b||^2   s.t.  |x_j| <= M z_j,  sum z <= k,  z binary,
                              -M <= x <= M,  t >= 0 (the epigraph variable)

and the solver sees it as the epigraph SDP ``[[I, Ax - b], [(Ax - b)^T, t]]
>= 0`` with big-M rows.  Both sides of the benchmark are handed the same
arrays (A, b, k, M); this module works out what the solver should answer
without any of its code:

* :func:`node_value` — a node relaxation (z in [0, 1] but for the fixed
  ones) is a convex QP whose minimiser, when the least-squares solution on
  the features in play satisfies the big-M budget and the box, is that
  least-squares solution (the features in play: those not fixed at 0, or
  only those fixed at 1 where they fill the budget k).  The function checks the condition and
  raises :class:`Undecided` where it fails, instead of guessing.
* :func:`best_subset` — the proven optimum: an exact branch-and-bound over
  supports whose bound is the least-squares residual on the features not
  excluded (dropping the cardinality and the box only lowers it), leaves
  evaluated exactly.
* :func:`incumbent_violation` / :func:`support_value` — judge an incumbent
  point (x, z, t) as the configuration states it.

Every routine takes ``dtype``: float64 is the reference, float32 its control
(the same arithmetic one precision lower).  Imports numpy only.
"""

from __future__ import annotations

import numpy as np


class Undecided(RuntimeError):
    """The exact shortcut does not apply to this node; the reference does
    not guess."""


def rss(A: np.ndarray, b: np.ndarray, support, dtype=np.float64):
    """(residual ||A_S x - b||^2, x) of least squares on the columns
    ``support``, computed in ``dtype`` (the residual returned as a float)."""
    S = np.asarray(sorted(support), dtype=np.int64)
    As = A[:, S].astype(dtype)
    bd = b.astype(dtype)
    if S.size == 0:
        return float(bd @ bd), np.zeros(0, dtype)
    x = np.linalg.lstsq(As, bd, rcond=None)[0]
    r = bd - As @ x
    return float(r @ r), x


def node_value(A, b, k: int, M: float, zfix: dict, dtype=np.float64,
               cache: dict | None = None):
    """Optimal value of a node relaxation whose binaries ``zfix`` ({feature:
    0 or 1}) are fixed, the others in [0, 1].  None where the node is
    infeasible (more than k binaries at 1).  Where k binaries are fixed at
    1, sum z <= k holds every free binary at 0 and with it its feature; the
    features in play are then those fixed at 1, else those not fixed at 0.
    ``cache`` (a dict the caller keeps) holds the least squares of supports
    already solved.  Raises :class:`Undecided` where the least-squares
    minimiser on the features in play breaks the box or the budget
    sum_{free j} |x_j| / M <= k - (binaries at 1)."""
    ones = sum(1 for v in zfix.values() if v >= 0.5)
    if ones > k:
        return None
    full = ones == k
    S = tuple(j for j in range(A.shape[1])
              if zfix.get(j, 0 if full else 1) >= 0.5)
    key = (S, np.dtype(dtype).name)
    if cache is None or key not in cache:
        got = rss(A, b, S, dtype)
        if cache is None:
            cache = {}
        cache[key] = got
    val, x = cache[key]
    xs = dict(zip(S, np.abs(x.astype(np.float64))))
    budget = sum(v for j, v in xs.items() if j not in zfix) / M
    if max(xs.values(), default=0.0) > M or budget > k - ones:
        raise Undecided(f"least squares breaks the box or the budget "
                        f"(max |x| {max(xs.values()):.3g}, budget "
                        f"{budget:.3g} of {k - ones})")
    return val


def best_subset(A, b, k: int, M: float, dtype=np.float64):
    """(optimum, sorted support, nodes) of min ||A x - b||^2 over supports of
    at most k features with |x| <= M: depth-first branch-and-bound, include
    before exclude, branching on the free feature with the largest
    least-squares coefficient; the greedy forward support seeds the
    incumbent.  Raises :class:`Undecided` if a leaf's least-squares
    solution breaks the box (its value would then not be exact)."""
    p = A.shape[1]

    def leaf(S):
        val, x = rss(A, b, S, dtype)
        if x.size and np.abs(x.astype(np.float64)).max() > M:
            raise Undecided(f"support {sorted(S)} breaks the box")
        return val

    greedy = []
    for _ in range(min(k, p)):
        greedy.append(min((rss(A, b, greedy + [j], dtype)[0], j)
                          for j in range(p) if j not in greedy)[1])
    best, best_s = leaf(greedy), sorted(greedy)
    nodes = 0
    stack = [((), tuple(range(p)))]
    while stack:
        inc, free = stack.pop()
        nodes += 1
        cand = list(inc) + list(free)
        if len(cand) <= k or len(inc) == k:
            S = cand if len(cand) <= k else list(inc)
            val = leaf(S)
            if val < best:
                best, best_s = val, sorted(S)
            continue
        val, x = rss(A, b, cand, dtype)
        if val >= best:
            continue
        coef = dict(zip(sorted(cand), np.abs(x.astype(np.float64))))
        j = max(free, key=lambda q: coef[q])
        rest = tuple(q for q in free if q != j)
        stack.append((inc, rest))           # exclude j
        stack.append((inc + (j,), rest))    # include j, explored first
    return best, best_s, nodes


def support_value(A, b, k: int, M: float, z, dtype=np.float64):
    """Exact value of the support that an incumbent's binaries select
    (z >= 0.5); None where it holds more than k features."""
    S = [j for j in range(A.shape[1]) if z[j] >= 0.5]
    if len(S) > k:
        return None
    val, x = rss(A, b, S, dtype)
    if x.size and np.abs(x.astype(np.float64)).max() > M:
        raise Undecided(f"support {S} breaks the box")
    return val


def incumbent_violation(A, b, k: int, M: float, y) -> float:
    """Worst violation of the configuration's constraints by a point y =
    (x, z, t): z off {0, 1}, sum z over k, |x_j| over M z_j (over M), the
    box, and ||A x - b||^2 over t (relative to 1 + t); all in float64."""
    n = A.shape[1]
    y = np.asarray(y, dtype=np.float64)
    x, z, t = y[:n], y[n:2 * n], float(y[2 * n])
    r = A @ x - b
    parts = [np.abs(z - np.round(z)).max(initial=0.0),
             max(0.0, float(z.sum()) - k),
             (np.maximum(np.abs(x) - M * z, 0.0) / M).max(initial=0.0),
             (np.maximum(np.abs(x) - M, 0.0) / M).max(initial=0.0),
             max(0.0, -min(z.min(initial=0.0), 0.0), float(z.max()) - 1.0),
             max(0.0, float(r @ r) - t) / (1.0 + abs(t)),
             max(0.0, -t)]
    return float(max(parts))
