"""Eigenvector cutting planes for SDP blocks (PyTorch).

Counterpart of ``scipsdp_tpu/ops/cuts.py``, the batched cut separation of
the reference (cons_sdp.c): ``separateSol``:1612 assembles
Z(y) = sum_j A_j y_j - A_0 per block, computes all eigenvectors with
negative eigenvalues (SCIPlapackComputeEigenvectorsNegative), and for each
eigenvector v emits the linear cut  sum_j (v^T A_j v) y_j >= v^T A_0 v
(``produceCutFromEigenvector``:896, coefficient computation
``multiplyConstraintMatrix``:827).  One batched ``torch.linalg.eigh`` per
size bucket on the data's device yields every cut of every block of every
point at once, and the coefficients are one einsum.  The JAX package runs
XLA's ``eigh`` here, not a kernel of its own.

Also the truncated-power-method sparsification of cuts
(``truncatedPowerMethod``:1140, ``sparsifyCut``:1243): an s-sparse
approximate smallest eigenvector from (shifted) power steps truncated to
the s largest entries, and the host helper that peels disjoint-support
sparse cuts off one block (``addMultipleSparseCuts``:1340).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scipsdp_tpu_torch.ops.ipm import IPMData


class CutBatch(NamedTuple):
    """Per-bucket tuples: element t has shapes (B, K_t, n_t, ...)."""

    coefs: tuple   # per bucket (B, K_t, n_t, mp) coefficients (v^T A_j v)
    rhs: tuple     # per bucket (B, K_t, n_t) right-hand sides (v^T A_0 v)
    valid: tuple   # per bucket (B, K_t, n_t) bool: eigenvalue < -tol
    lam: tuple     # per bucket (B, K_t, n_t) eigenvalues of Z(y)


def separate_eigenvector_cuts(data: IPMData, y, tol: float = 1e-6
                              ) -> CutBatch:
    """All eigenvector cuts violated at points ``y`` (B, m or mp), numpy
    or a tensor; the cuts come back as tensors on ``data``'s device.

    The cut from eigenvector v of block k is valid for every feasible
    point (it is implied by Z_k >= 0); ``valid`` marks those actually
    violated at y (eigenvalue < -tol).  Returned coefficient rows are in
    the extended variable space (mp = m + 1, penalty column = v^T I v = 1).
    """
    y = torch.as_tensor(y, dtype=torch.float64, device=data.device)
    B = y.shape[0]
    mp = data.A[0].shape[1]
    if y.shape[1] == mp - 1:
        y = torch.cat([y, y.new_zeros((B, 1))], dim=1)
    coefs_t, rhs_t, valid_t, lam_t = [], [], [], []
    for t in range(data.nbuckets):
        Z = torch.einsum("kjab,xj->xkab", data.A[t], y) - data.C[t][None]
        # mask padding: large positive diagonal so padded eigenpairs are
        # never selected as negative
        n = Z.shape[-1]
        dm = data.dimmask[t]
        outer = (dm[:, :, None] & dm[:, None, :])[None]
        big = 1.0 + Z.abs().amax(dim=(-1, -2), keepdim=True)
        eye = torch.eye(n, dtype=Z.dtype, device=Z.device)
        lam, V = torch.linalg.eigh(torch.where(outer, Z, big * eye))
        # coefficients: for eigenvector v (column e): v^T A_j v
        coefs = torch.einsum("xkae,kjab,xkbe->xkej", V, data.A[t], V)
        rhs = torch.einsum("xkae,kab,xkbe->xke", V, data.C[t], V)
        realblock = dm.any(dim=1)  # (K_t,)
        coefs_t.append(coefs)
        rhs_t.append(rhs)
        valid_t.append((lam < -tol) & realblock[None, :, None])
        lam_t.append(lam)
    return CutBatch(coefs=tuple(coefs_t), rhs=tuple(rhs_t),
                    valid=tuple(valid_t), lam=tuple(lam_t))


def sparsify_cut_tpower(Zk: torch.Tensor, sparsity: int, iters: int = 20
                        ) -> torch.Tensor:
    """Truncated power method: s-sparse approximate most-negative
    eigenvector of symmetric Zk (n, n) (cons_sdp.c:1140-1338).

    Works on the shifted matrix  sigma*I - Z  so the target eigenvalue is
    the largest; after each power step only the ``sparsity`` largest-
    magnitude entries are kept (every entry tied with the last of them
    too, as ``lax.top_k``'s threshold keeps them in the JAX package).
    """
    n = Zk.shape[-1]
    sigma = Zk.abs().sum()  # upper bound on spectral radius
    Ms = sigma * torch.eye(n, dtype=Zk.dtype, device=Zk.device) - Zk

    def trunc(v):
        av = v.abs()
        thresh = torch.topk(av, sparsity).values[-1]
        v = torch.where(av >= thresh, v, 0.0)
        return v / torch.clamp_min(torch.linalg.norm(v), 1e-30)

    v = trunc(torch.ones((n,), dtype=Zk.dtype, device=Zk.device))
    for _ in range(iters):
        v = trunc(Ms @ v)
    return v


def multiple_sparse_cuts(Zk, sparsity: int, maxncuts: int = -1,
                         tol: float = 1e-6, iters: int = 50):
    """Disjoint-support sparse eigenvector directions of one block
    (addMultipleSparseCuts, cons_sdp.c:1340-1610): repeatedly find an
    s-sparse approximate most-negative eigenvector by the truncated power
    method on the shifted matrix, *exactly* recompute the smallest
    eigenpair of the support submatrix (RECOMPUTESPARSEEV role), emit the
    lifted vector when its Rayleigh quotient is < -tol, then remove the
    support rows/columns and repeat until no negative direction remains.

    Host-side helper (cut generation runs on the host in LP mode);
    returns a list of dense n-vectors with disjoint supports.
    """
    Z = np.asarray(Zk, dtype=np.float64).copy()
    n = Z.shape[-1]
    alive = np.ones(n, dtype=bool)
    out = []
    while (maxncuts < 0 or len(out) < maxncuts) and alive.sum() >= 1:
        idx = np.where(alive)[0]
        sub = Z[np.ix_(idx, idx)]
        s = min(sparsity, len(idx))
        v = sparsify_cut_tpower(torch.from_numpy(sub), s, iters).numpy()
        supp = np.where(np.abs(v) > 1e-12)[0]
        if supp.size == 0:
            break
        # exact smallest eigenpair of the support submatrix
        ssub = sub[np.ix_(supp, supp)]
        lam, V = np.linalg.eigh(ssub)
        if lam[0] >= -tol:
            break
        lifted = np.zeros(n)
        lifted[idx[supp]] = V[:, 0]
        out.append(lifted)
        alive[idx[supp]] = False
    return out
