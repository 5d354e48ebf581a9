"""Rank-1 SDP constraint handling.

The reference models rank-1 constraints (SDPA ``*RANK1`` /
CBF ``PSDVARRANK1``/``PSDCONRANK1``) by requiring every principal 2x2
minor of the (PSD) block matrix to vanish, posed as quadratic constraints
(``addRank1QuadConss``, cons_sdp.c:3490) that SCIP's nonlinear handler
enforces with secant/McCormick linearizations and spatial branching; the
check callback verifies the second-largest eigenvalue is ~0
(``isMatrixRankOne``, cons_sdp.c:733).

Here: feasibility check = batched eigenvalue test; enforcement = locally
valid secant/McCormick cuts on the most violated minor plus spatial
branching on a variable covering it (core/branchbound.py drives both).
For PSD X, rank(X) <= 1  iff all principal 2x2 minors X_ss X_tt - X_st^2
vanish.

numpy only: a copy of the JAX package's ``core/rank1.py``, kept beside it
rather than imported so this package never imports JAX.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from scipsdp_tpu_torch.models.problem import DenseSDPData, INF


def block_value(dense: DenseSDPData, k: int, y: np.ndarray) -> np.ndarray:
    """Z_k(y) over the real dims of block k."""
    nk = int(dense.blocksizes[k])
    A = dense.A[k, :, :nk, :nk]
    C = dense.C[k, :nk, :nk]
    return np.einsum("jab,j->ab", A, y) + 0.0 - C


def rank1_violation(dense: DenseSDPData, y: np.ndarray, tol: float
                    ) -> Optional[Tuple[int, int, int, float]]:
    """Check rank-1 feasibility like the reference (isMatrixRankOne,
    cons_sdp.c:777: second largest eigenvalue ~ 0 within feastol); on
    violation return (block, s, t, minor_viol) for the most violated
    principal 2x2 minor (the branching/cut target, mirroring the largest-
    minimal-eigenvalue minor scan at cons_sdp.c:788-805)."""
    best = None
    for k in range(dense.nblocks):
        if not dense.rank1[k]:
            continue
        M = block_value(dense, k, y)
        nk = M.shape[0]
        if nk < 2:
            continue
        lam = np.linalg.eigvalsh(M)
        if lam[-2] <= tol:        # second largest eigenvalue ~ 0: rank <= 1
            continue
        for s in range(nk):
            for t in range(s + 1, nk):
                viol = abs(M[s, s] * M[t, t] - M[s, t] ** 2)
                if best is None or viol > best[3]:
                    best = (k, s, t, viol)
    return best


def entry_form(dense: DenseSDPData, k: int, s: int, t: int
               ) -> Tuple[np.ndarray, float]:
    """The affine form of entry (s,t) of block k: value = g.y - c."""
    g = dense.A[k, :, s, t].copy()
    c = dense.C[k, s, t]
    return g, c


def _interval(g: np.ndarray, c: float, lb: np.ndarray, ub: np.ndarray
              ) -> Tuple[float, float]:
    lo = -c + np.sum(np.where(g > 0, g * lb, g * ub))
    hi = -c + np.sum(np.where(g > 0, g * ub, g * lb))
    return float(lo), float(hi)


def rank1_cuts(dense: DenseSDPData, k: int, s: int, t: int,
               lb: np.ndarray, ub: np.ndarray) -> List[Tuple[np.ndarray, float]]:
    """Locally valid cuts for the nonconvex side  X_st^2 >= X_ss X_tt.

    With w1 = X_ss, w2 = X_tt, w3 = X_st (affine forms) and finite box
    bounds: the secant overestimates w3^2 on [l3, u3], so
        (l3+u3) w3 - l3 u3  >=  w3^2  >=  w1 w2  >=  McCormick-lower,
    giving linear cuts  (l3+u3) w3 - McCormick_lower(w1, w2) >= l3 u3.
    Returns cuts as (coefficients over y, rhs) for rows  g.y >= rhs.
    """
    g1, c1 = entry_form(dense, k, s, s)
    g2, c2 = entry_form(dense, k, t, t)
    g3, c3 = entry_form(dense, k, s, t)
    l1, u1 = _interval(g1, c1, lb, ub)
    l2, u2 = _interval(g2, c2, lb, ub)
    l3, u3 = _interval(g3, c3, lb, ub)
    # PSD implies diagonal entries >= 0
    l1, l2 = max(l1, 0.0), max(l2, 0.0)
    cuts: List[Tuple[np.ndarray, float]] = []
    if abs(l3) >= INF or abs(u3) >= INF:
        return cuts
    # secant of w3^2:  sec(w3) = (l3+u3) w3 - l3 u3
    sec_g = (l3 + u3) * g3
    sec_c = (l3 + u3) * c3  # value = sec_g.y - sec_c ... w3 = g3.y - c3
    for (a, b_, const) in (
        (l2, l1, l1 * l2),   # w1 w2 >= l2 w1 + l1 w2 - l1 l2
        (u2, u1, u1 * u2),   # w1 w2 >= u2 w1 + u1 w2 - u1 u2
    ):
        if abs(a) >= INF or abs(b_) >= INF:
            continue
        # (l3+u3) w3 - l3 u3 >= a w1 + b w2 - const
        # => (sec_g - a g1 - b g2) . y >= sec_c - a c1 - b c2 - const + l3 u3
        gg = sec_g - a * g1 - b_ * g2
        rhs = sec_c - a * c1 - b_ * c2 - const + l3 * u3
        cuts.append((gg, rhs))
    return cuts


def rank1_project(dense: DenseSDPData, y: np.ndarray) -> np.ndarray:
    """Rank-1 rounding heuristic: for each rank-1 block, replace its value
    M = Z_k(y) by the nearest rank-1 PSD matrix (largest eigenpair) and
    solve back for the variables covering the block by least squares.

    Rationale: interior-point solvers return the analytic center of the
    optimal face (maximal rank), but the face often contains a rank-1
    point of equal objective; this projection recovers it so the B&B can
    accept an incumbent instead of spatially branching forever.  The
    caller must feasibility-check the result (all constraints + rank-1).
    """
    yhat = y.copy()
    for k in range(dense.nblocks):
        if not dense.rank1[k]:
            continue
        nk = int(dense.blocksizes[k])
        M = block_value(dense, k, yhat)
        lam, V = np.linalg.eigh(M)
        M1 = max(lam[-1], 0.0) * np.outer(V[:, -1], V[:, -1])
        A = dense.A[k, :, :nk, :nk]
        covering = np.where(np.abs(A).reshape(A.shape[0], -1).sum(1) > 0)[0]
        if covering.size == 0:
            continue
        # solve  sum_j A_j dy_j = M1 - M  in least squares over block vars
        Amat = A[covering].reshape(covering.size, -1).T
        rhsv = (M1 - M).reshape(-1)
        dy, *_ = np.linalg.lstsq(Amat, rhsv, rcond=None)
        yhat[covering] += dy
    return yhat


def rank1_complete(dense: DenseSDPData, y: np.ndarray, obj: np.ndarray,
                   viol_fn=None, max_enum: int = 10, sweeps: int = 3
                   ) -> np.ndarray:
    """Rank-1 completion heuristic: per rank-1 block, keep the diagonal of
    M = Z_k(y) (often pinned by linear constraints) and build the rank-1
    matrix  u u^T  with  u = s * sqrt(diag)  over sign patterns s, solving
    back for the block's variables by least squares.

    Because linear rows may couple entries *across* blocks, the sign
    patterns are chosen jointly: coordinate descent over blocks minimizing
    (constraint violation, objective) via ``viol_fn(y) -> float`` when
    given, else just the (internal, minimized) objective.

    This recovers rank-1 optima on faces where the IPM's analytic center
    is isotropic and eigenvector projection is uninformative (e.g. blocks
    with fixed diagonal whose free off-diagonals the relaxation leaves 0).
    """
    # per-block candidate variable updates for each sign pattern
    block_cands = []   # (covering, [cand_dy ...])
    yhat = y.copy()
    for k in range(dense.nblocks):
        if not dense.rank1[k]:
            continue
        nk = int(dense.blocksizes[k])
        M = block_value(dense, k, y)
        lam = np.linalg.eigvalsh(M)
        if nk < 2 or lam[-2] <= 1e-9:
            continue
        d = np.sqrt(np.maximum(np.diag(M), 0.0))
        A = dense.A[k, :, :nk, :nk]
        covering = np.where(np.abs(A).reshape(A.shape[0], -1).sum(1) > 0)[0]
        if covering.size == 0:
            continue
        Amat = A[covering].reshape(covering.size, -1).T
        nfree = min(nk - 1, max_enum)
        cands = []
        signs = []
        for bits in range(1 << nfree):
            s = np.ones(nk)
            for t in range(nfree):
                if bits >> t & 1:
                    s[t + 1] = -1.0
            u = s * d
            M1 = np.outer(u, u)
            dy, *_ = np.linalg.lstsq(Amat, (M1 - M).reshape(-1), rcond=None)
            cands.append(dy)
            signs.append(s)
        block_cands.append((covering, cands, k, Amat, signs))

    if not block_cands:
        return yhat

    # initialize every block with its objective-best pattern
    choice = []
    for covering, cands, _k, _Am, _sg in block_cands:
        vals = [float(obj[covering] @ dy) for dy in cands]
        choice.append(int(np.argmin(vals)))

    def assemble(ch):
        out = y.copy()
        for (covering, cands, _k, _Am, _sg), c in zip(block_cands, ch):
            out[covering] = y[covering] + cands[c]
        return out

    def refine(ych, ch, iters=8):
        """Least-squares polish (fixed point): re-complete each block at
        the CURRENT point until the completion residual stops moving —
        the one-shot lstsq at the relaxation point carries an O(feastol)
        residual that shows up as 1e-5-level incumbent error."""
        out = ych.copy()
        for _ in range(iters):
            moved = 0.0
            for (covering, cands, k, Amat, signs), c in zip(block_cands,
                                                            ch):
                M = block_value(dense, k, out)
                d = np.sqrt(np.maximum(np.diag(M), 0.0))
                u = signs[c] * d
                dy, *_ = np.linalg.lstsq(
                    Amat, (np.outer(u, u) - M).reshape(-1), rcond=None)
                out[covering] += dy
                if dy.size:
                    moved = max(moved, float(np.abs(dy).max()))
            if moved < 1e-13:
                break
        return out

    if viol_fn is not None:
        # joint refinement: coordinate descent on (violation, objective)
        def score(ych):
            return (round(float(viol_fn(ych)), 9), float(obj @ ych))
        cur = score(assemble(choice))
        for _ in range(sweeps):
            improved = False
            for bi, (covering, cands, _k, _Am, _sg) in enumerate(
                    block_cands):
                best_c, best_s = choice[bi], cur
                for c in range(len(cands)):
                    if c == choice[bi]:
                        continue
                    trial = list(choice)
                    trial[bi] = c
                    sc = score(assemble(trial))
                    if sc < best_s:
                        best_c, best_s = c, sc
                if best_c != choice[bi]:
                    choice[bi] = best_c
                    cur = best_s
                    improved = True
            if not improved:
                break
        out = assemble(choice)
        polished = refine(out, choice)
        return polished if score(polished) <= score(out) else out
    return refine(assemble(choice), choice)


def eigen_perturbation(dense: DenseSDPData, y: np.ndarray) -> np.ndarray:
    """Objective perturbation direction that rewards concentrating each
    rank-1 block's mass on its current dominant eigenvector.

    The IPM converges to the analytic center of the optimal face (maximal
    rank); minimizing  b - eps*g  with  g_j = sum_k v_k^T A_j^k v_k  over
    an eps-optimal face drives the solution toward an extreme point where
    the blocks are rank-1 (if the face contains one)."""
    g = np.zeros_like(y)
    for k in range(dense.nblocks):
        if not dense.rank1[k]:
            continue
        nk = int(dense.blocksizes[k])
        M = block_value(dense, k, y)
        lam, V = np.linalg.eigh(M)
        v = V[:, -1]
        A = dense.A[k, :, :nk, :nk]
        g += np.einsum("a,jab,b->j", v, A, v)
    return g


def rank1_branch_var(dense: DenseSDPData, k: int, s: int, t: int,
                     y: np.ndarray, lb: np.ndarray, ub: np.ndarray,
                     feastol: float) -> int:
    """Variable for spatial branching: prefer one covering the off-diagonal
    entry (s,t), else the diagonals, that is not (near-)fixed."""
    for (rs, cs) in ((s, t), (s, s), (t, t)):
        g = dense.A[k, :, rs, cs]
        cand = np.where(np.abs(g) > 1e-12)[0]
        for j in cand:
            if ub[j] - lb[j] > feastol:
                return int(j)
    return -1
