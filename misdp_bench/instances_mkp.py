"""The benchmark's own generator of min-k-partition instances on toroidal
grids.

``torus_weights`` draws the edge weights of one rows x cols torus from its
generator seed, and ``mkp_misdp`` writes min-k-partition on a weighted
graph in the solver's problem classes, the formulation that
``scipsdp_tpu_torch/models/families.py::min_k_partition`` writes on a
random graph:

    X_ii = 1,  X_ij = -1/(k-1) + (k/(k-1)) y_ij,  X >= 0 (one block),
    y_ij binary for every pair i > j,  min  sum_{ij in E} w_ij y_ij

so y_ij = 1 puts i and j in one part and the objective at a partition is
its intra-part weight.  The weights go to both sides of the benchmark: the
MISDP to the solver, the weights themselves to
``reference/mkp_reference.py``.
"""

from __future__ import annotations

import numpy as np


def torus_edges(rows: int, cols: int) -> list:
    """The edges (i, j), i > j, of the rows x cols toroidal grid, vertex
    r * cols + c, each vertex joined to its right and lower neighbour (with
    wrap-around), in that order."""
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            for u in (r * cols + (c + 1) % cols, ((r + 1) % rows) * cols + c):
                e = (max(u, v), min(u, v))
                if u != v and e not in edges:
                    edges.append(e)
    return edges


def torus_weights(rows: int, cols: int, seed: int) -> np.ndarray:
    """(n, n) symmetric weight matrix of one torus: N(0, 1) on its edges
    (drawn in ``torus_edges`` order), 0 elsewhere."""
    n = rows * cols
    edges = torus_edges(rows, cols)
    w = np.random.default_rng(seed).standard_normal(len(edges))
    W = np.zeros((n, n))
    for (i, j), v in zip(edges, w):
        W[i, j] = W[j, i] = v
    return W


def pairs(n: int) -> list:
    """The variables' pairs (i, j), i > j, in variable order."""
    return [(i, j) for i in range(n) for j in range(i)]


def mkp_misdp(W: np.ndarray, k: int, name: str):
    """The MISDP of min-k-partition on the graph of weights ``W``: one
    n x n block sum_t A_t y_t - A_0 with A_0 = -I - (1/(k-1)) (J - I) on
    the lower triangle and A_t = (k/(k-1)) E_ij; no LP rows."""
    from scipsdp_tpu_torch.models.problem import (MISDP, LinearConstraints,
                                                  SDPBlock)

    n = W.shape[0]
    prs = pairs(n)
    lo = -1.0 / (k - 1)
    scale = 1.0 - lo
    blk = SDPBlock(
        size=n,
        var=list(range(len(prs))), row=[i for i, _ in prs],
        col=[j for _, j in prs], val=[scale] * len(prs),
        const_row=list(range(n)) + [i for i, _ in prs],
        const_col=list(range(n)) + [j for _, j in prs],
        const_val=[-1.0] * n + [-lo] * len(prs))
    m = len(prs)
    obj = np.array([W[i, j] for i, j in prs])
    return MISDP(nvars=m, obj=obj, lb=np.zeros(m), ub=np.ones(m),
                 integral=np.ones(m, dtype=bool), blocks=[blk],
                 lp=LinearConstraints.empty(), name=name)


class Instance:
    """One instance of a configuration: its torus's weights and k; the
    solver's MISDP is made on demand."""

    def __init__(self, cfg: dict, seed: int):
        self.rows, self.cols = int(cfg["rows"]), int(cfg["cols"])
        self.k = int(cfg["k"])
        self.seed = int(seed)
        self.W = torus_weights(self.rows, self.cols, self.seed)
        self.name = f"mkp_t2g{self.rows}x{self.cols}_k{self.k}_{self.seed}"

    @property
    def nvars(self) -> int:
        n = self.W.shape[0]
        return n * (n - 1) // 2

    def misdp(self):
        return mkp_misdp(self.W, self.k, self.name)
