"""One-variable SDP solver.

Port of the reference's special solver for SDPs with a single active
variable (src/sdpi/solveonevarsdp.c: SCIPsolveOneVarSDP:156,
SCIPsolveOneVarSDPDense:370): solve

    min  c * y   s.t.  y * A - A0 >= 0,  lb <= y <= ub

by eigenvalue analysis.  y A - A0 >= 0 defines an interval of feasible y
(possibly empty/half-infinite): with the generalized eigenvalue problem
A0 v = lambda A v restricted to the appropriate subspaces,

  * if A >= 0:  feasible set is  y >= y_min  (y_min = max over constraints)
  * if A <= 0:  y <= y_max
  * indefinite A: an interval [y_min, y_max] (possibly empty)

Implemented robustly by bisection on lambda_min(y A - A0), which is
concave in y — matching the reference's semismooth-Newton robustness goal
with a simpler method suited to batching.

numpy only: a copy of the JAX package's ``ops/onevar.py``, kept
beside it rather than imported so this package never imports JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from scipsdp_tpu_torch.models.problem import INF

# matrices at or above this order use the Lanczos extreme-eigenvalue path
# (arpack_interface.c:237 role: SCIP-SDP calls ARPACK's dsaupd for the
# smallest eigenpair of large one-var matrices instead of full dsyevr)
LANCZOS_SWITCH = 180


def lam_min_lanczos(M: np.ndarray, iters: int = 120, seed: int = 7,
                    restol: float = 1e-8) -> Tuple[float, np.ndarray]:
    """Smallest eigenpair of a symmetric matrix by Lanczos with full
    reorthogonalization (the ARPACK dsaupd role, arpack_interface.c:237).

    The Rayleigh-Ritz value is extracted from the EXACT projection
    T = V^T M V of the orthonormalized basis (reorthogonalization perturbs
    the three-term recurrence, so the recurrence tridiagonal is not the
    true projection), and the Ritz pair is accepted only when its residual
    ||M v - lam v|| passes a tolerance scaled like the feastol checks that
    consume it; otherwise fall back to a dense eigh — Ritz values only
    upper-bound lambda_min, and an overestimate would err exactly in the
    unsafe (infeasible-declared-feasible) direction."""
    n = M.shape[0]
    k = min(iters, n)
    rng = np.random.default_rng(seed)
    V = np.empty((k, n))
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    V[0] = v
    w = M @ v
    alpha0 = v @ w
    w -= alpha0 * v
    used = 1
    for j in range(1, k):
        b = np.linalg.norm(w)
        if b < 1e-13:
            break
        v = w / b
        # full reorthogonalization keeps the basis numerically orthogonal
        v -= V[:j].T @ (V[:j] @ v)
        nv = np.linalg.norm(v)
        if nv < 1e-13:
            break
        v /= nv
        V[j] = v
        w = M @ v
        w -= (v @ w) * v + b * V[j - 1]
        used = j + 1
    Vu = V[:used]
    MV = Vu @ M              # (used, n) rows are (M v_i)^T
    T = MV @ Vu.T            # exact Rayleigh-Ritz projection
    T = 0.5 * (T + T.T)
    evals, evecs = np.linalg.eigh(T)
    lam = float(evals[0])
    vec = Vu.T @ evecs[:, 0]
    vec /= np.linalg.norm(vec)
    resid = float(np.linalg.norm(M @ vec - lam * vec))
    if resid > restol * max(1.0, float(np.abs(MV).max())):
        # unconverged Krylov space (clustered spectrum): exact fallback
        evals, evecs = np.linalg.eigh(M)
        return float(evals[0]), evecs[:, 0]
    return lam, vec


def _lam_min_vec(y: float, A: np.ndarray,
                 C: np.ndarray) -> Tuple[float, np.ndarray]:
    M = y * A - C
    if M.shape[0] >= LANCZOS_SWITCH:
        return lam_min_lanczos(M)
    evals, evecs = np.linalg.eigh(M)
    return float(evals[0]), evecs[:, 0]


def _lam_min(y: float, A: np.ndarray, C: np.ndarray) -> float:
    M = y * A - C
    if M.shape[0] >= LANCZOS_SWITCH:
        return lam_min_lanczos(M)[0]
    return float(np.linalg.eigvalsh(M)[0])


class OneVarCertificate(NamedTuple):
    """Optimality/infeasibility certificate of the one-var solver
    (solveonevarsdp.c:127,156 returns the active eigenvector and uses the
    supergradient of lambda_min in its semismooth Newton).

    * ``eigvec``: minimal eigenvector v of  y* A - C  at the returned y*
      (infeasible: at the concave maximizer) — v^T (y A - C) v >= 0 is the
      supporting linear inequality in y certifying the interval boundary;
    * ``supergrad``: v^T A v, a supergradient of  y -> lambda_min(yA - C)
      at y* (exact gradient when the eigenvalue is simple);
    * ``lam``: lambda_min at y*.
    """

    eigvec: np.ndarray
    supergrad: float
    lam: float


def feasible_interval(A: np.ndarray, C: np.ndarray, lo: float, hi: float,
                      feastol: float = 1e-6, tol: float = 1e-9):
    """Feasible interval of {y in [lo, hi] : y*A - C >= 0} — possibly
    empty (returns None).  lambda_min(yA - C) is concave in y, so the set
    is an interval; endpoints located by bisection against the concave
    maximizer (the interval form of SCIPsolveOneVarSDP, sdpi.c:3301-3381
    intersects these across blocks)."""
    lo_c = max(lo, -1e12)
    hi_c = min(hi, 1e12)
    if lo_c > hi_c:
        return None
    f_lo = _lam_min(lo_c, A, C)
    f_hi = _lam_min(hi_c, A, C)
    if f_lo < -feastol and f_hi < -feastol:
        a, b = lo_c, hi_c
        for _ in range(120):
            m1 = a + 0.382 * (b - a)
            m2 = a + 0.618 * (b - a)
            if _lam_min(m1, A, C) < _lam_min(m2, A, C):
                a = m1
            else:
                b = m2
            if b - a < tol * max(1.0, abs(a)):
                break
        peak = 0.5 * (a + b)
        if _lam_min(peak, A, C) < -feastol:
            return None
    else:
        peak = lo_c if f_lo >= -feastol else hi_c

    def bisect(lo_, hi_, increasing):
        for _ in range(120):
            mid = 0.5 * (lo_ + hi_)
            if _lam_min(mid, A, C) >= -feastol:
                if increasing:
                    hi_ = mid
                else:
                    lo_ = mid
            else:
                if increasing:
                    lo_ = mid
                else:
                    hi_ = mid
            if hi_ - lo_ < tol * max(1.0, abs(hi_)):
                break
        # return the certified-feasible iterate, not the midpoint: the
        # endpoint must satisfy lambda_min >= -feastol so downstream
        # consumers (conflict rows, the one-var fast path) get a point
        # on the feasible side of the relaxed boundary
        return hi_ if increasing else lo_

    left = lo_c if f_lo >= -feastol else bisect(lo_c, peak, True)
    right = hi_c if f_hi >= -feastol else bisect(peak, hi_c, False)
    # report true infinities when the box was unbounded and the end feasible
    if lo <= -INF and f_lo >= -feastol:
        left = -np.inf
    if hi >= INF and f_hi >= -feastol:
        right = np.inf
    return (left, right)


def solve_one_var_sdp(A: np.ndarray, C: np.ndarray, c: float,
                      lb: float, ub: float, feastol: float = 1e-6,
                      tol: float = 1e-9, with_certificate: bool = False):
    """Return (status, y*) with status in {"optimal", "infeasible",
    "unbounded"}.  A, C: (n, n) symmetric; minimize c*y over the feasible
    interval intersected with [lb, ub].

    ``with_certificate=True`` returns (status, y*, OneVarCertificate):
    the active eigenvector + supergradient (solveonevarsdp.c:127,156)."""

    cert_at = [0.0]   # certificate evaluation point for non-finite y

    def ret(status, y):
        if not with_certificate:
            return status, y
        yc = float(y) if np.isfinite(y) else cert_at[0]
        lam, v = _lam_min_vec(yc, A, C)
        return status, y, OneVarCertificate(v, float(v @ A @ v), lam)

    lo = max(lb, -1e12)
    hi = min(ub, 1e12)
    f_lo = _lam_min(lo, A, C)
    f_hi = _lam_min(hi, A, C)
    # lambda_min(y A - C) is concave in y: feasible set is an interval
    if f_lo < -feastol and f_hi < -feastol:
        # check an interior maximizer by golden-section on the concave fn
        a, b = lo, hi
        for _ in range(200):
            m1 = a + 0.382 * (b - a)
            m2 = a + 0.618 * (b - a)
            if _lam_min(m1, A, C) < _lam_min(m2, A, C):
                a = m1
            else:
                b = m2
            if b - a < tol * max(1.0, abs(a)):
                break
        if _lam_min(0.5 * (a + b), A, C) < -feastol:
            cert_at[0] = 0.5 * (a + b)   # maximizer: lam_min < 0 everywhere
            return ret("infeasible", np.nan)
        peak = 0.5 * (a + b)
    else:
        peak = lo if f_lo >= -feastol else hi

    def bisect(lo_, hi_, increasing):
        """Boundary of feasibility between an infeasible and feasible end."""
        for _ in range(200):
            mid = 0.5 * (lo_ + hi_)
            if _lam_min(mid, A, C) >= -feastol:
                if increasing:
                    hi_ = mid
                else:
                    lo_ = mid
            else:
                if increasing:
                    lo_ = mid
                else:
                    hi_ = mid
            if hi_ - lo_ < tol * max(1.0, abs(hi_)):
                break
        # certified-feasible iterate (see feasible_interval.bisect)
        return hi_ if increasing else lo_

    # feasible interval endpoints within [lo, hi]
    left = lo if f_lo >= -feastol else bisect(lo, peak, True)
    right = hi if f_hi >= -feastol else bisect(peak, hi, False)

    if c > 0:
        y = left
    elif c < 0:
        y = right
    else:
        y = peak
    cert_at[0] = float(peak)
    if c < 0 and ub >= INF and f_hi >= -feastol:
        return ret("unbounded", -np.inf)
    if c > 0 and lb <= -INF and f_lo >= -feastol:
        return ret("unbounded", -np.inf)
    return ret("optimal", float(y))
