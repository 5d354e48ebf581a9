"""Batched dense eigen/linear-algebra helpers (the L0 layer).

PyTorch counterpart of ``scipsdp_tpu/ops/eigen.py``: batched
``torch.linalg`` factorizations over padded dense blocks, with the JAX
package's failure semantics.  ``jnp.linalg.cholesky`` symmetrizes its input
and returns a factor that is NaN on and below the diagonal for a matrix
that is not positive definite, and ``jnp.linalg.eigvalsh`` returns NaN for
a NaN input; the interior-point solver reads those NaNs as "not PSD".
``torch.linalg.cholesky`` raises instead and ``eigvalsh`` may raise on NaN
input, so :func:`cholesky` (``cholesky_ex``, no host sync) and
:func:`eigvalsh` below restore the JAX behaviour.
"""

from __future__ import annotations

import torch

from scipsdp_tpu_torch.utils import trace


def sym(M: torch.Tensor) -> torch.Tensor:
    """Symmetrize the trailing two axes."""
    return 0.5 * (M + M.transpose(-1, -2))


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor of ``sym(A)``; every matrix whose
    factorization fails comes back NaN on and below the diagonal
    (``jnp.linalg.cholesky``)."""
    L, info = torch.linalg.cholesky_ex(sym(A))
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")).tril(), L)


def eigvalsh(M: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric ``M`` (..., n, n); a matrix that
    holds a NaN yields all-NaN eigenvalues instead of a LAPACK error."""
    bad = torch.isnan(M).any(dim=-1).any(dim=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    # eigvalsh checks its result on the host: a sync on the card
    w = trace.sync("eigvalsh", torch.linalg.eigvalsh,
                   torch.where(bad[..., None, None], eye, M))
    return torch.where(bad[..., None], torch.full_like(w, float("nan")), w)


def _tril_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """L^{-1} rhs for lower-triangular L (batch dims broadcast)."""
    return torch.linalg.solve_triangular(L, rhs, upper=False)


def min_eigenvalue(M: torch.Tensor, dimmask: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue over the *real* dimensions of padded blocks.

    ``M``: (..., n, n); ``dimmask``: (..., n) bool.  Padded rows/cols are
    replaced by an identity scaled to a large positive value so they can
    never be the minimum (analog of SCIPlapackComputeIthEigenvalue with
    i = 1, lapack_interface.c:178).
    """
    n = M.shape[-1]
    big = 1.0 + torch.amax(M.abs(), dim=(-1, -2), keepdim=True)
    outer = dimmask[..., :, None] & dimmask[..., None, :]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    Mm = torch.where(outer, M, big * eye)
    return eigvalsh(Mm)[..., 0]


def _step_from_lam_min(lam_min: torch.Tensor) -> torch.Tensor:
    """1 + a*lam_min >= 0  ->  largest a (inf when lam_min >= -1e-14)."""
    safe = lam_min >= -1e-14
    return torch.where(safe, torch.full_like(lam_min, float("inf")),
                       -1.0 / torch.where(safe, -1.0, lam_min))


def _congruence(L: torch.Tensor, dM: torch.Tensor) -> torch.Tensor:
    """Y = L^{-1} dM L^{-T} by two triangular solves (not symmetrized)."""
    W = _tril_solve(L, dM)
    return _tril_solve(L, W.transpose(-1, -2))


def max_step_psd(L: torch.Tensor, dM: torch.Tensor) -> torch.Tensor:
    """Largest alpha with  M + alpha*dM >= 0,  given M = L L^T (Cholesky).

    Returns +inf when dM keeps M PSD for all alpha.  Batched over leading
    axes.
    """
    # Y = L^{-1} dM L^{-T};  M + a dM >= 0  <=>  1 + a*lambda_min(Y) >= 0
    Y = sym(_congruence(L, dM))
    return _step_from_lam_min(eigvalsh(Y)[..., 0])


def _power_step(S: torch.Tensor, iters: int, floor: float) -> torch.Tensor:
    """Shifted power iteration for lambda_max(-Y) given S = -Y; returns the
    step 1/lambda_max (inf when lambda_max <= 1e-12)."""
    n = S.shape[-1]
    # Gershgorin shift makes S + cI PSD so power iteration finds c + lam_max
    c = torch.amax(S.abs().sum(dim=-1), dim=-1)
    Sc = S + c[..., None, None] * torch.eye(n, dtype=S.dtype, device=S.device)
    v = torch.ones(S.shape[:-1], dtype=S.dtype, device=S.device)[..., None] \
        / torch.sqrt(torch.tensor(float(n), dtype=S.dtype, device=S.device))
    for _ in range(iters):
        w = Sc @ v
        v = w / torch.clamp_min(
            torch.linalg.norm(w, dim=(-2, -1), keepdim=True), floor)
    lam = (v * (Sc @ v)).sum(dim=(-2, -1)) - c
    safe = lam <= 1e-12
    return torch.where(safe, torch.full_like(lam, float("inf")),
                       1.0 / torch.where(safe, 1.0, lam))


def max_step_psd_power(L: torch.Tensor, dM: torch.Tensor,
                       iters: int = 16) -> torch.Tensor:
    """Like :func:`max_step_psd` but via shifted power iteration instead of
    a full eigendecomposition.  The estimate can slightly overestimate the
    allowed step, so callers pair it with a Cholesky probe."""
    return _power_step(-sym(_congruence(L, dM)), iters, 1e-300)


def ymat(Linv: torch.Tensor, dM: torch.Tensor) -> torch.Tensor:
    """Congruence transform Y = Linv dM Linv^T used by the PSD max-step
    rules:  M + a dM >= 0  <=>  I + a Y >= 0  when M = L L^T.  Matmul-only:
    the caller supplies the explicit triangular inverse."""
    T = torch.einsum("...ab,...bc->...ac", Linv, dM)
    return sym(torch.einsum("...ac,...dc->...ad", T, Linv))


def max_step_from_ymat(Y: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Largest alpha with  I + alpha*Y >= 0  via shifted power iteration
    (the solve-free core of :func:`max_step_psd_power`)."""
    return _power_step(-Y, iters, 1e-30)


def max_step_eigh_from_ymat(Y: torch.Tensor) -> torch.Tensor:
    """Exact variant of :func:`max_step_from_ymat` (full eigendecomposition)."""
    return _step_from_lam_min(eigvalsh(Y)[..., 0])


def gersh_step_from_ymat(Y: torch.Tensor) -> torch.Tensor:
    """Conservative Gershgorin bound variant (eigh- and iteration-free)."""
    lam_bound = torch.amax(Y.abs().sum(dim=-1), dim=-1)
    return 1.0 / torch.clamp_min(lam_bound, 1e-30)


def max_step_pos(v: torch.Tensor, dv: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Largest alpha with  v + alpha*dv >= 0  elementwise over masked entries.

    ``v`` strictly positive where mask; reduces over the last axis.
    """
    neg = (dv < 0) & mask
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                        torch.full_like(v, float("inf")))
    return torch.amin(ratio, dim=-1)


def spd_inverse(M: torch.Tensor, L: torch.Tensor = None) -> torch.Tensor:
    """Inverse of a symmetric positive definite matrix via Cholesky, with a
    symmetric result.  ``L`` may pass a precomputed Cholesky factor."""
    if L is None:
        L = cholesky(M)
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    W = _tril_solve(L, eye)
    return sym(W.transpose(-1, -2) @ W)


def chol_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = rhs for batched lower-triangular L, rhs (..., n)."""
    y = _tril_solve(L, rhs[..., None])
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0]
