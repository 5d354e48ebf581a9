"""Benchmark problem-family generators.

The reference ships one instance per family (check/testset/short.test:
truss topology example_TT, cardinality least squares example_CLS,
min-k-partition example_MkP, rank-1 instances).  These generators produce
the same families at arbitrary sizes for scaling studies — the
framework's "model zoo".

All generators return MISDPs in the internal minimization dual form.
"""

from __future__ import annotations

import numpy as np

from scipsdp_tpu_torch.models.problem import (
    INF,
    LinearConstraints,
    MISDP,
    SDPBlock,
)


def cardinality_least_squares(nfeatures: int = 8, nsamples: int = 16,
                              k: int = 4, M: float = 10.0,
                              seed: int = 0) -> MISDP:
    """Cardinality-constrained least squares (example_CLS family):

        min  ||A x - b||^2   s.t.  ||x||_0 <= k,  |x_i| <= M z_i,
        z binary, sum z <= k

    modeled with the epigraph SDP  [[I, Ax - b], [(Ax-b)^T, t]] >= 0 and
    big-M rows — the structure of Gally's CLS instances.
    Variables: x (nfeatures), z (nfeatures, binary), t (epigraph).
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nsamples, nfeatures))
    xtrue = np.zeros(nfeatures)
    sup = rng.choice(nfeatures, size=k, replace=False)
    xtrue[sup] = rng.standard_normal(k)
    bvec = A @ xtrue + 0.1 * rng.standard_normal(nsamples)

    n = nfeatures
    m = 2 * n + 1              # x, z, t
    tidx = 2 * n
    size = nsamples + 1
    var_l, row_l, col_l, val_l = [], [], [], []
    crow, ccol, cval = [], [], []
    # block [[I, r],[r^T, t]], r = A x - b
    for i in range(nsamples):
        crow.append(i)
        ccol.append(i)
        cval.append(-1.0)              # A_0 = -I on the identity part
        for j in range(n):
            if A[i, j] != 0.0:
                var_l.append(j)
                row_l.append(size - 1)
                col_l.append(i)
                val_l.append(A[i, j])
        crow.append(size - 1)
        ccol.append(i)
        cval.append(bvec[i])
    var_l.append(tidx)
    row_l.append(size - 1)
    col_l.append(size - 1)
    val_l.append(1.0)
    blk = SDPBlock(size=size, var=var_l, row=row_l, col=col_l, val=val_l,
                   const_row=crow, const_col=ccol, const_val=cval)

    rows = []
    for j in range(n):
        rows.append(([j, n + j], [1.0, -M], -INF, 0.0))    # x_j <= M z_j
        rows.append(([j, n + j], [1.0, M], 0.0, INF))      # x_j >= -M z_j
    rows.append((list(range(n, 2 * n)), [1.0] * n, -INF, float(k)))

    obj = np.zeros(m)
    obj[tidx] = 1.0
    lb = np.concatenate([np.full(n, -M), np.zeros(n), [0.0]])
    ub = np.concatenate([np.full(n, M), np.ones(n), [INF]])
    integral = np.concatenate([np.zeros(n, bool), np.ones(n, bool), [False]])
    return MISDP(nvars=m, obj=obj, lb=lb, ub=ub, integral=integral,
                 blocks=[blk], lp=LinearConstraints.from_rows(rows),
                 name=f"cls_{nfeatures}x{nsamples}_k{k}")


def min_k_partition(nvertices: int = 8, k: int = 3, density: float = 0.5,
                    seed: int = 0) -> MISDP:
    """Min-k-partition (example_MkP family): partition a weighted graph's
    vertices into k groups minimizing intra-group edge weight.  SDP model
    on X with diag(X) = 1, X_ij >= -1/(k-1), X integer-linked entries.

    Variables: y_ij for i<j (the entries of X's lower triangle, integer in
    the exact model; here the standard relaxation-with-integrality on
    entries scaled to {-1/(k-1), 1})."""
    rng = np.random.default_rng(seed)
    W = np.triu(rng.random((nvertices, nvertices)) < density, 1)
    wts = np.where(W, np.round(rng.random((nvertices, nvertices)) * 9 + 1),
                   0.0)
    pairs = [(i, j) for i in range(nvertices) for j in range(i)]
    idx = {p: t for t, p in enumerate(pairs)}
    m = len(pairs)
    lo = -1.0 / (k - 1)

    var_l, row_l, col_l, val_l = [], [], [], []
    crow, ccol, cval = [], [], []
    for (i, j), t in idx.items():
        var_l.append(t)
        row_l.append(i)
        col_l.append(j)
        val_l.append(1.0)
    for i in range(nvertices):
        crow.append(i)
        ccol.append(i)
        cval.append(-1.0)     # diag fixed to 1
    blk = SDPBlock(size=nvertices, var=var_l, row=row_l, col=col_l,
                   val=val_l, const_row=crow, const_col=ccol,
                   const_val=cval)

    obj = np.zeros(m)
    for (i, j), t in idx.items():
        w = wts[j, i] if j < i else wts[i, j]
        if w:
            # intra-group edges have X_ij = 1: minimize sum w*(X+1/(k-1))
            obj[t] = float(w)
    lb = np.full(m, lo)
    ub = np.ones(m)
    integral = np.ones(m, dtype=bool)  # entries take values in {lo, 1}
    # scale so the two allowed values are integers: substitute
    # y = (X - lo) / (1 - lo) in {0, 1}
    # keep the direct model with integer flag on the scaled variable:
    scale = 1.0 - lo
    blk2 = SDPBlock(
        size=nvertices,
        var=var_l, row=row_l, col=col_l, val=[scale] * len(var_l),
        const_row=list(crow) + [r for r in row_l],
        const_col=list(ccol) + [c for c in col_l],
        const_val=list(cval) + [-lo] * len(var_l),
    )
    obj2 = obj * scale
    return MISDP(nvars=m, obj=obj2, lb=np.zeros(m), ub=np.ones(m),
                 integral=integral, blocks=[blk2],
                 lp=LinearConstraints.empty(),
                 name=f"mkp_{nvertices}_k{k}",
                 objoffset=float(sum(obj * (0.0 - lo) * 0.0)))


def truss_topology(nbars: int = 6, nloads: int = 2, seed: int = 0) -> MISDP:
    """Truss-topology-like family (example_TT): choose integer bar
    areas y_j >= 0 minimizing volume subject to compliance SDPs
    [[c, f^T], [f, sum_j y_j K_j]] >= 0 per load case."""
    rng = np.random.default_rng(seed)
    ndof = max(2, nbars // 2)
    blocks = []
    for L in range(nloads):
        f = rng.standard_normal(ndof)
        var_l, row_l, col_l, val_l = [], [], [], []
        crow, ccol, cval = [], [], []
        size = ndof + 1
        crow.append(0)
        ccol.append(0)
        cval.append(-10.0)     # compliance bound c = 10
        for d in range(ndof):
            crow.append(d + 1)
            ccol.append(0)
            cval.append(-f[d])
        for jbar in range(nbars):
            kvec = rng.standard_normal(ndof)
            K = np.outer(kvec, kvec)
            for a in range(ndof):
                for bb in range(a + 1):
                    if abs(K[a, bb]) > 1e-12:
                        var_l.append(jbar)
                        row_l.append(a + 1)
                        col_l.append(bb + 1)
                        val_l.append(K[a, bb])
        blocks.append(SDPBlock(size=size, var=var_l, row=row_l, col=col_l,
                               val=val_l, const_row=crow, const_col=ccol,
                               const_val=cval))
    obj = np.ones(nbars)       # minimize total volume
    return MISDP(nvars=nbars, obj=obj, lb=np.zeros(nbars),
                 ub=np.full(nbars, 10.0),
                 integral=np.ones(nbars, dtype=bool), blocks=blocks,
                 lp=LinearConstraints.empty(),
                 name=f"tt_{nbars}bars_{nloads}loads")
