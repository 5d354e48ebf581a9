"""The benchmark's own copy of the CLS instance generator.

``cls_arrays`` draws the data of one instance from its generator seed and
``cls_misdp`` writes it in the solver's problem classes, exactly as
``scipsdp_tpu_torch/models/families.py::cardinality_least_squares`` did
when the benchmark was written (``misdp_bench/tests`` holds the two
equal).  The copy keeps the instances fixed if the package's generator
changes.  The arrays go to both sides of the benchmark: the MISDP to the
solver, the arrays themselves to ``reference/cls_reference.py``.
"""

from __future__ import annotations

import numpy as np


def cls_arrays(nfeatures: int, nsamples: int, k: int, seed: int,
               noise: float = 0.1):
    """(A, b) of one instance: Gaussian A, a planted k-sparse x, b = A x
    plus Gaussian noise of standard deviation ``noise``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nsamples, nfeatures))
    xtrue = np.zeros(nfeatures)
    sup = rng.choice(nfeatures, size=k, replace=False)
    xtrue[sup] = rng.standard_normal(k)
    b = A @ xtrue + noise * rng.standard_normal(nsamples)
    return A, b


def cls_misdp(A: np.ndarray, b: np.ndarray, k: int, M: float, name: str):
    """The MISDP of min ||A x - b||^2, ||x||_0 <= k, |x_i| <= M z_i: the
    epigraph block [[I, A x - b], [(A x - b)^T, t]] >= 0 and the big-M rows.
    Variables x (n), z (n, binary), t."""
    from scipsdp_tpu_torch.models.problem import (INF, MISDP,
                                                  LinearConstraints, SDPBlock)

    nsamples, n = A.shape
    m = 2 * n + 1
    tidx = 2 * n
    size = nsamples + 1
    var_l, row_l, col_l, val_l = [], [], [], []
    crow, ccol, cval = [], [], []
    for i in range(nsamples):
        crow.append(i)
        ccol.append(i)
        cval.append(-1.0)
        for j in range(n):
            if A[i, j] != 0.0:
                var_l.append(j)
                row_l.append(size - 1)
                col_l.append(i)
                val_l.append(A[i, j])
        crow.append(size - 1)
        ccol.append(i)
        cval.append(b[i])
    var_l.append(tidx)
    row_l.append(size - 1)
    col_l.append(size - 1)
    val_l.append(1.0)
    blk = SDPBlock(size=size, var=var_l, row=row_l, col=col_l, val=val_l,
                   const_row=crow, const_col=ccol, const_val=cval)
    rows = []
    for j in range(n):
        rows.append(([j, n + j], [1.0, -M], -INF, 0.0))
        rows.append(([j, n + j], [1.0, M], 0.0, INF))
    rows.append((list(range(n, 2 * n)), [1.0] * n, -INF, float(k)))
    obj = np.zeros(m)
    obj[tidx] = 1.0
    lb = np.concatenate([np.full(n, -M), np.zeros(n), [0.0]])
    ub = np.concatenate([np.full(n, M), np.ones(n), [INF]])
    integral = np.concatenate([np.zeros(n, bool), np.ones(n, bool), [False]])
    return MISDP(nvars=m, obj=obj, lb=lb, ub=ub, integral=integral,
                 blocks=[blk], lp=LinearConstraints.from_rows(rows),
                 name=name)


class Instance:
    """One instance of a configuration: its arrays, k, M and name; the
    solver's MISDP is made on demand."""

    def __init__(self, cfg: dict, seed: int):
        self.k = int(cfg["k"])
        self.M = float(cfg["M"])
        self.seed = int(seed)
        self.A, self.b = cls_arrays(cfg["nfeatures"], cfg["nsamples"],
                                    self.k, self.seed, cfg["noise"])
        self.name = f"cls_{cfg['nfeatures']}x{cfg['nsamples']}_k{self.k}"

    @property
    def nfeatures(self) -> int:
        return self.A.shape[1]

    def misdp(self):
        return cls_misdp(self.A, self.b, self.k, self.M, self.name)
