"""Plain reference for the min-k-partition cells: node relaxations solved
by a dense primal-dual path-following SDP method in plain torch.

An instance (``misdp_bench/instances_mkp.py``) is a weighted graph W on n
vertices and the number of parts k.  With lo = -1/(k-1) and s = k/(k-1),
one variable y_t per pair t = (i, j), i > j, and a penalty variable r,

    Z(y, r) = F0 + sum_t y_t F_t + r I,   F0 = lo J + (1 - lo) I,
                                          F_t = s (E_ij + E_ji),

so Z's diagonal is 1 + r and Z_ij = lo + s y_ij.  A batched solve's call
asks, for each live slot, one of (``rung``):

* ``direct``:  min sum_t W_t y_t        s.t. Z(y, 0) >= 0,  y in the box;
* ``probe``:   min r                    s.t. Z(y, r) >= 0,  y in the box,
               r >= 0;
* ``penalty``: min sum_t W_t y_t + G r  s.t. Z(y, r) >= 0,  y in the box,
               r >= 0 (G the rung's Gamma),

a box fixing some y_t at 0 or 1 and leaving the others in [0, 1].  This
module works these out without any of the solver's code, from W, k, the
box and the rung alone:

* :func:`ipm` — a dense infeasible primal-dual path-following method
  (Mehrotra predictor-corrector, the HKM direction) for batches of
  ``min c^T v  s.t.  F0 + sum_j v_j F_j >= 0,  l <= v <= u,  G v >= h``.
  It keeps each problem's most accurate iterate and raises
  :class:`Undecided` where that one's relative duality gap stays above
  ``ACCEPT`` or its relative residuals above ten times that, rather than
  guess.
* :func:`phase1` — max t s.t. Z(y, 0) >= t I over the box (r free and
  minimised, t = -r): t > 0 for a box whose SDP has an interior point,
  t = 0 for one that is feasible on the boundary only, t < 0 for an
  infeasible one (:func:`classify`; between the bands it raises).  The
  probe's value is max(0, -t).
* :func:`boundary_values` — a boundary box's direct value, from the same
  problem on the face of the PSD cone that holds its feasible set
  (:func:`reduced`): a fixing y_ij = 1 makes vertices i and j one (rows i
  and j of a PSD matrix with unit diagonal are then equal), and k classes
  pairwise fixed at lo have vectors that sum to zero, so one of them is a
  combination of the others.  The reduced problem must have an interior
  point; else it raises.  Its phase-1 problem also classes the boxes
  whose fixings force Z to be singular, exactly (:func:`phase1`).

Every routine takes ``dtype``: float64 is the reference; float32 its
control (the same arithmetic one precision lower), which is run with
``strict=False`` and returns what it reaches.  Imports numpy and torch.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

GAP = 1e-10         # error at which a solve stops: the largest of the
                    # relative duality gap and RESIDUAL times the residuals
RESIDUAL = 0.1      # residuals (relative) are held at ten times the gap's
ACCEPT = 1e-8       # the error a strict solve must reach
DEGENERATE = 1e-5   # the error a strict solve must reach on a penalty
                    # problem of a boundary box (see penalty_values)
MAX_ITERS = 100
STALL = 8           # iterations without a lower error before a solve stops
TAU = (0.9, 0.09)   # fraction to the boundary: 0.9 + 0.09 * the
                    # predictor's shorter step (0.99 once it is whole)
SHIFTS = (1e-15, 1e-12, 1e-9)  # the Jacobi-scaled Schur matrix's diagonal
                    # shift, the least that factors (rounding near the optimum)
REFINE = 5          # refinement passes of the Schur solve against the
                    # unshifted matrix
BACKTRACK = 4       # halvings of a step whose X or Z does not factor
INTERIOR = 1e-4     # phase-1 t above this: an interior point
BOUNDARY = 1e-7     # |t| below this: feasible on the boundary only


class Undecided(RuntimeError):
    """The reference cannot settle this box; it does not guess."""


def pair_index(n: int):
    """(I, J) int64 arrays of the pairs (i, j), i > j, in variable
    order."""
    I = [i for i in range(n) for j in range(i)]
    J = [j for i in range(n) for j in range(i)]
    return np.array(I, dtype=np.int64), np.array(J, dtype=np.int64)


def pair_weights(W: np.ndarray) -> np.ndarray:
    I, J = pair_index(W.shape[0])
    return W[I, J]


class Problem:
    """A batch of B problems  min c^T v  s.t.  F0 + sum_j v_j F_j >= 0,
    l <= v <= u,  G v >= h  sharing F0 (n, n) and F (p, n, n): ``c``,
    ``l``, ``u`` (B, p), +-inf for no bound, l = u for a fixed variable;
    ``G`` (B, q, p) and ``h`` (B, q), q possibly 0."""

    def __init__(self, F0, F, c, l, u, G=None, h=None,
                 dtype=torch.float64, device="cpu"):
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        self.F0, self.F = t(F0), t(F)
        self.n, self.p = self.F0.shape[0], self.F.shape[0]
        self.c, self.l, self.u = t(c), t(l), t(u)
        B = self.c.shape[0]
        self.G = t(np.zeros((B, 0, self.p)) if G is None else G)
        self.h = t(np.zeros((B, 0)) if h is None else h)
        self.fixed = self.l == self.u
        self.lmask = torch.isfinite(self.l) & ~self.fixed
        self.umask = torch.isfinite(self.u) & ~self.fixed
        self.eye = torch.eye(self.n, dtype=dtype, device=device)

    def amap(self, v):
        """sum_j v_j F_j, (B, n, n)."""
        return torch.einsum("xj,jab->xab", v, self.F)

    def adj(self, V):
        """<F_j, V> for every j: (B, p)."""
        return torch.einsum("jab,xab->xj", self.F, V)

    def schur(self, X, Zi):
        """M_ij = <F_i, X F_j Z^{-1}>, (B, p, p) (symmetric)."""
        XFZ = X[:, None] @ self.F[None] @ Zi[:, None]
        return XFZ.flatten(2) @ self.F.flatten(1).T


def _psd_step(L, D):
    """Largest a with L L^T + a D >= 0 (per batch entry; 1e30 where D is
    PSD, 0 where D is not finite), L the Cholesky factor."""
    Li = torch.linalg.solve_triangular(L, torch.eye(
        L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L),
        upper=False)
    E = Li @ D @ Li.transpose(1, 2)
    finite = torch.isfinite(E).flatten(1).all(1)
    E = torch.where(finite[:, None, None], 0.5 * (E + E.transpose(1, 2)),
                    0.0)
    lam = torch.linalg.eigvalsh(E)[:, 0]
    step = torch.where(lam < 0, -1.0 / lam, torch.full_like(lam, 1e30))
    return torch.where(finite, step, 0.0)


def _ratio(x, dx, mask):
    """Largest a with x + a dx >= 0 where ``mask`` (per row)."""
    r = torch.where(mask & (dx < 0), -x / torch.where(dx < 0, dx, -1.0),
                    torch.full_like(x, 1e30))
    big = torch.full((r.shape[0], 1), 1e30, dtype=r.dtype, device=r.device)
    return torch.cat([r, big], 1).amin(1)


def ipm(pr: Problem, strict: bool = True, accept: float = ACCEPT):
    """Solve every problem of ``pr``: (value, v (B, p), error) with
    value = c^T v at each problem's most accurate iterate, the one whose
    error, the largest of its relative duality gap and ``RESIDUAL`` times
    its relative residuals, is least.  A problem stops once its error is under ``GAP``, or after
    ``STALL`` iterations that do not lower it, or when a step cannot be
    computed.  Raises :class:`Undecided` (``strict``) where a problem's
    error stays above ``accept``; with ``strict=False`` returns what each
    reached.  Each iteration works on the problems still running."""
    dt = pr.c.dtype
    B = pr.c.shape[0]
    dev = pr.c.device
    v = torch.where(pr.fixed, pr.l, torch.zeros_like(pr.c))
    two = pr.lmask & pr.umask
    v = torch.where(two, 0.5 * (pr.l + pr.u), v)
    v = torch.where(pr.lmask & ~pr.umask, pr.l + 1.0, v)
    v = torch.where(pr.umask & ~pr.lmask, pr.u - 1.0, v)
    X = (1.0 + pr.c.abs().amax(1))[:, None, None] * pr.eye
    Z = pr.eye.expand(B, pr.n, pr.n).clone()
    xl, xu = pr.lmask.to(dt), pr.umask.to(dt)
    sg = torch.clamp_min((pr.G @ v[:, :, None])[:, :, 0] - pr.h, 1.0)
    xg = torch.ones_like(sg)
    state = [v, Z, X, xl, xu, xg, sg]
    running = torch.ones(B, dtype=torch.bool, device=dev)
    best = torch.full((B,), float("inf"), dtype=dt, device=dev)
    best_v = v.clone()
    stale = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(MAX_ITERS):
        idx = torch.nonzero(running).flatten()
        if idx.numel() == 0:
            break
        err, ok, nxt = _iteration(pr, idx, *(s[idx] for s in state))
        better = err < best[idx]
        best[idx] = torch.where(better, err, best[idx])
        best_v[idx] = torch.where(better[:, None], state[0][idx],
                                  best_v[idx])
        stale[idx] = torch.where(better, 0, stale[idx] + 1)
        go = ok & (best[idx] > GAP) & (stale[idx] < STALL)
        running[idx] = go
        sel = idx[go]
        for s, s_new in zip(state, nxt):
            s[sel] = s_new[go]
    value = (pr.c * best_v).sum(1)
    if strict:
        short = ~(best <= accept)
        if bool(short.any()):
            raise Undecided(
                f"{int(short.sum())} of {B} problems short of a relative "
                f"gap of {accept:g} and residuals of {accept / RESIDUAL:g} "
                f"(worst error "
                f"{float(best.max()):.3g})")
    return value, best_v, best


def _iteration(pr: Problem, idx, v, Z, X, xl, xu, xg, sg):
    """One Mehrotra predictor-corrector step of the problems ``idx`` at
    the iterate (v, Z, X, xl, xu, xg, sg): (the iterate's error, as
    :func:`ipm` takes it; whether the step could be taken; the next
    iterate)."""
    c, l, u = pr.c[idx], pr.l[idx], pr.u[idx]
    lmask, umask, fixed = pr.lmask[idx], pr.umask[idx], pr.fixed[idx]
    G, h = pr.G[idx], pr.h[idx]
    Gt = G.transpose(1, 2)
    free = ~fixed
    dt = c.dtype
    sl = torch.where(lmask, v - l, 1.0)
    su = torch.where(umask, u - v, 1.0)
    Rd = pr.F0 + pr.amap(v) - Z
    rg = (G @ v[:, :, None])[:, :, 0] - h - sg
    AX = pr.adj(X)
    Gx = (Gt @ xg[:, :, None])[:, :, 0]
    rp = torch.where(free, c - AX - Gx - xl + xu, 0.0)
    comp = ((X * Z).sum((1, 2)) + (xl * sl * lmask).sum(1)
            + (xu * su * umask).sum(1) + (xg * sg).sum(1))
    vfix = torch.where(fixed, v, 0.0)
    dobj = (c * v).sum(1)
    # the X-side objective: -<F0, X> + l^T xl - u^T xu + h^T xg and the
    # fixed variables' part of the Lagrangian
    pobj = (-(pr.F0 * X).sum((1, 2))
            + torch.where(lmask, xl * l, 0.0).sum(1)
            - torch.where(umask, xu * u, 0.0).sum(1) + (xg * h).sum(1)
            + ((c - AX - Gx) * vfix).sum(1))
    gap = (dobj - pobj).abs() / (1.0 + dobj.abs())
    pinf = rp.abs().amax(1) / (1.0 + c.abs().amax(1))
    dinf = torch.cat([Rd.flatten(1), rg], 1).abs().amax(1)
    err = torch.maximum(gap, RESIDUAL * torch.maximum(pinf, dinf))
    nu = pr.n + lmask.sum(1) + umask.sum(1) + sg.shape[1]
    mu = comp / nu
    Lz, iz = torch.linalg.cholesky_ex(Z)
    Lx, ix = torch.linalg.cholesky_ex(X)
    ok = (iz == 0) & (ix == 0)
    eye = pr.eye.expand_as(Z)
    # a failed factor is replaced, and its problem stopped
    Lz = torch.where(ok[:, None, None], Lz, eye)
    Lx = torch.where(ok[:, None, None], Lx, eye)
    Zi = torch.cholesky_inverse(Lz)
    M = pr.schur(X, Zi)
    M = M + torch.diag_embed(torch.where(lmask, xl / sl, 0.0)
                             + torch.where(umask, xu / su, 0.0))
    M = M + Gt @ ((xg / sg)[:, :, None] * G)
    fo = free[:, :, None] & free[:, None, :]
    M = torch.where(fo, M, 0.0) + torch.diag_embed(fixed.to(dt))
    # the Schur system is solved Jacobi-scaled, its unit diagonal shifted
    # by the first of SHIFTS that factors, and refined against the
    # unscaled, unshifted matrix
    dsc = torch.rsqrt(torch.clamp_min(torch.diagonal(M, dim1=1, dim2=2),
                                      torch.finfo(dt).tiny))
    Ms = M * dsc[:, :, None] * dsc[:, None, :]
    eye_m = torch.eye(M.shape[-1], dtype=dt, device=M.device)
    Lm = eye_m.expand_as(M).clone()
    todo = ok.clone()
    for shift in SHIFTS:
        L, info = torch.linalg.cholesky_ex(Ms + shift * eye_m)
        got = todo & (info == 0) & torch.isfinite(L).all(2).all(1)
        Lm = torch.where(got[:, None, None], L, Lm)
        todo = todo & ~got
    ok = ok & ~todo

    def msolve(r):
        return dsc[:, :, None] * torch.cholesky_solve(dsc[:, :, None] * r,
                                                      Lm)

    XRZ = X @ Rd @ Zi

    def direction(target, cX, cl, cu, cg):
        """(dv, dZ, dX, dxl, dxu, dxg, dsg) of the HKM system aiming at
        the complementarity ``target`` (per problem), with the second-order
        terms cX (matrix), cl, cu (bounds) and cg (rows)."""
        tg = target[:, None]
        gl = torch.where(lmask, (tg - xl * sl - cl) / sl, 0.0)
        gu = torch.where(umask, (tg - xu * su - cu) / su, 0.0)
        gg = (tg - xg * sg - cg) / sg
        rhs = (pr.adj(target[:, None, None] * Zi - X - cX - XRZ)
               + gl - gu - rp + (Gt @ (gg - xg / sg * rg)[:, :, None])[
                   :, :, 0])
        rhs = torch.where(free, rhs, 0.0)[:, :, None]
        dv = msolve(rhs)
        for _ in range(REFINE):
            dv = dv + msolve(rhs - M @ dv)
        dv = torch.where(free, dv[:, :, 0], 0.0)
        dZ = Rd + pr.amap(dv)
        dX = target[:, None, None] * Zi - X - cX - X @ dZ @ Zi
        dX = 0.5 * (dX + dX.transpose(1, 2))
        dxl = torch.where(lmask, gl - xl / sl * dv, 0.0)
        dxu = torch.where(umask, gu + xu / su * dv, 0.0)
        dsg = (G @ dv[:, :, None])[:, :, 0] + rg
        dxg = gg - xg / sg * dsg
        return dv, dZ, dX, dxl, dxu, dxg, dsg

    rows = torch.ones_like(sg, dtype=torch.bool)

    def steps(d):
        dv, dZ, dX, dxl, dxu, dxg, dsg = d
        ap = torch.minimum(
            _psd_step(Lx, dX),
            torch.minimum(torch.minimum(_ratio(xl, dxl, lmask),
                                        _ratio(xu, dxu, umask)),
                          _ratio(xg, dxg, rows)))
        ad = torch.minimum(
            _psd_step(Lz, dZ),
            torch.minimum(torch.minimum(_ratio(sl, dv, lmask),
                                        _ratio(su, -dv, umask)),
                          _ratio(sg, dsg, rows)))
        return ap, ad

    zl, zg = torch.zeros_like(xl), torch.zeros_like(xg)
    aff = direction(torch.zeros_like(mu), torch.zeros_like(X), zl, zl, zg)
    ap, ad = (torch.clamp(a, max=1.0) for a in steps(aff))
    dv, dZ, dX, dxl, dxu, dxg, dsg = aff
    comp_aff = (((X + ap[:, None, None] * dX)
                 * (Z + ad[:, None, None] * dZ)).sum((1, 2))
                + ((xl + ap[:, None] * dxl) * (sl + ad[:, None] * dv)
                   * lmask).sum(1)
                + ((xu + ap[:, None] * dxu) * (su - ad[:, None] * dv)
                   * umask).sum(1)
                + ((xg + ap[:, None] * dxg)
                   * (sg + ad[:, None] * dsg)).sum(1))
    sigma = torch.clamp(comp_aff / comp, 0.0, 1.0) ** 3
    tau = TAU[0] + TAU[1] * torch.minimum(ap, ad)
    d = direction(sigma * mu, dX @ dZ @ Zi, dxl * dv, -dxu * dv, dxg * dsg)
    ap, ad = (torch.clamp(tau * a, max=1.0) for a in steps(d))
    dv, dZ, dX, dxl, dxu, dxg, dsg = d
    # the step rule's eigenvalues are checked: a step whose X or Z does not
    # factor is halved, up to BACKTRACK times
    for _ in range(BACKTRACK):
        bad = ((torch.linalg.cholesky_ex(X + ap[:, None, None] * dX)[1] != 0)
               | (torch.linalg.cholesky_ex(Z + ad[:, None, None] * dZ)[1]
                  != 0))
        if not bool(bad.any()):
            break
        ap = torch.where(bad, 0.5 * ap, ap)
        ad = torch.where(bad, 0.5 * ad, ad)
    nxt = (v + ad[:, None] * dv, Z + ad[:, None, None] * dZ,
           X + ap[:, None, None] * dX, xl + ap[:, None] * dxl,
           xu + ap[:, None] * dxu, xg + ap[:, None] * dxg,
           sg + ad[:, None] * dsg)
    ok = ok & ~bad & torch.stack([torch.isfinite(s).flatten(1).all(1)
                                  for s in nxt]).all(0)
    return err, ok, nxt


def mkp_data(n: int, k: int):
    """(F0, F) of the pair variables and r on n vertices: F0 = lo J +
    (1 - lo) I, F_t = s (E_ij + E_ji) for each pair, then I."""
    lo, s = -1.0 / (k - 1.0), k / (k - 1.0)
    I, J = pair_index(n)
    F = np.zeros((len(I) + 1, n, n))
    F[np.arange(len(I)), I, J] = s
    F[np.arange(len(I)), J, I] = s
    F[-1] = np.eye(n)
    return lo * np.ones((n, n)) + (1.0 - lo) * np.eye(n), F


def _box_rows(m: int, fixes: list, rmode: str):
    """(l, u) numpy rows of boxes given as {t: 0 or 1} dicts; ``rmode``
    "zero", "nonneg" or "free" for the r column."""
    B = len(fixes)
    l = np.zeros((B, m + 1))
    u = np.ones((B, m + 1))
    for b, fx in enumerate(fixes):
        for t, v in fx.items():
            l[b, t] = u[b, t] = float(v)
    l[:, m] = 0.0 if rmode != "free" else -np.inf
    u[:, m] = 0.0 if rmode == "zero" else np.inf
    return l, u


def solve_boxes(W, k: int, fixes: list, objective: np.ndarray, gamma: float,
                rmode: str, dtype=torch.float64, device="cpu",
                strict: bool = True, chunk: int = 32,
                accept: float = ACCEPT) -> list:
    """Values of min objective^T y + gamma r over the boxes ``fixes`` (a
    list of {t: v} dicts) with r as ``rmode`` says, in chunks of ``chunk``
    problems; one float a box.  ``objective`` is one row, or one a box."""
    n = W.shape[0]
    m = n * (n - 1) // 2
    F0, F = mkp_data(n, k)
    obj = np.broadcast_to(objective, (len(fixes), m))
    out = []
    for a in range(0, len(fixes), chunk):
        part = fixes[a:a + chunk]
        l, u = _box_rows(m, part, rmode)
        c = np.concatenate([obj[a:a + chunk], np.full((len(part), 1), gamma)],
                           1)
        val = ipm(Problem(F0, F, c, l, u, dtype=dtype, device=device),
                  strict, accept)[0]
        out.extend(float(x) for x in val.cpu())
    return out


def phase1(W, k: int, fixes: list, dtype=torch.float64, device="cpu",
           strict: bool = True) -> list:
    """t* = max t s.t. Z(y, 0) >= t I over each box.  A box whose fixings
    force Z to be singular (a pair fixed at 1, or k vertices pairwise
    fixed at 0: :func:`singular`) has t* <= 0; it is feasible, t* = 0,
    where its reduced problem (:func:`reduced_phase1`) has an interior
    point, and infeasible where that problem has none (it raises
    between).  The other boxes, and the infeasible ones, take the phase-1
    problem: min r, r free, over the box."""
    t = [None] * len(fixes)
    sing = [b for b, fx in enumerate(fixes)
            if singular(W.shape[0], k, fx)]
    for b, tr in zip(sing, reduced_phase1(W, k, [fixes[b] for b in sing],
                                          dtype, device, strict)):
        if tr > INTERIOR or (not strict and tr > 0):
            t[b] = 0.0
        elif strict and tr >= -INTERIOR:
            raise Undecided(f"the reduced box's phase-1 value {tr:.3g} "
                            f"is neither clearly interior nor "
                            f"infeasible")
    rest = [b for b in range(len(fixes)) if t[b] is None]
    if rest:
        m = W.shape[0] * (W.shape[0] - 1) // 2
        vals = solve_boxes(W, k, [fixes[b] for b in rest], np.zeros(m), 1.0,
                           "free", dtype, device, strict)
        for b, v in zip(rest, vals):
            t[b] = -v
    return t


def classify(t: float) -> str:
    """"interior", "boundary" or "infeasible" from a phase-1 value; raises
    between the bands."""
    if t > INTERIOR:
        return "interior"
    if t < -INTERIOR:
        return "infeasible"
    if abs(t) <= BOUNDARY:
        return "boundary"
    raise Undecided(f"phase-1 value {t:.3g} is neither clearly interior, "
                    f"clearly infeasible nor on the boundary")


def direct_values(W, k: int, fixes: list, dtype=torch.float64,
                  device="cpu", strict: bool = True) -> list:
    """The direct rung's values of boxes with an interior point."""
    return solve_boxes(W, k, fixes, pair_weights(W), 0.0, "zero", dtype,
                       device, strict)


def penalty_values(W, k: int, fixes: list, gamma: float, boundary: bool,
                   dtype=torch.float64, device="cpu",
                   strict: bool = True) -> list:
    """The penalty rung's values.  On a boundary box its problem is
    degenerate: at a finite Gamma the optimum has r > 0 and tr X = Gamma,
    both multipliers of r's bound near 0, and Z^{-1} near the optimum
    holds entries of 1e14, so the primal side stalls in float64 at an
    error of 1e-8 to 1e-6 (1.01e-6 on the card) while the value settles;
    there a strict solve must reach ``DEGENERATE`` (``boundary``), else
    ``ACCEPT``."""
    return solve_boxes(W, k, fixes, pair_weights(W), gamma, "nonneg",
                       dtype, device, strict,
                       accept=DEGENERATE if boundary else ACCEPT)


def classes(n: int, fix: dict) -> list:
    """The vertices' classes under the fixings y_ij = 1 (the union of the
    pairs fixed at 1): a class index a vertex, classes numbered by their
    least vertex."""
    I, J = pair_index(n)
    parent = list(range(n))

    def root(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for t, v in fix.items():
        if v == 1:
            ra, rb = root(I[t]), root(J[t])
            parent[max(ra, rb)] = min(ra, rb)
    roots = sorted({root(a) for a in range(n)})
    return [roots.index(root(a)) for a in range(n)]


def _relation_basis(q: int, rel: list) -> np.ndarray:
    """(q, d) P with V = P U: every class vector from the d class vectors U
    that the relations sum_{a in S} v_a = 0 leave free (the relations in
    reduced row echelon form, pivot classes eliminated)."""
    R = np.zeros((len(rel), q))
    for r, S in enumerate(rel):
        R[r, list(S)] = 1.0
    pivots, row = [], 0
    for col in range(q):
        if row == R.shape[0]:
            break
        piv = row + int(np.argmax(np.abs(R[row:, col])))
        if abs(R[piv, col]) < 1e-12:
            continue
        R[[row, piv]] = R[[piv, row]]
        R[row] /= R[row, col]
        for r in range(R.shape[0]):
            if r != row:
                R[r] -= R[r, col] * R[row]
        pivots.append(col)
        row += 1
    free = [col for col in range(q) if col not in pivots]
    P = np.zeros((q, len(free)))
    for f, col in enumerate(free):
        P[col, f] = 1.0
    for r, col in enumerate(pivots):
        P[col] = -R[r, free]
    return P


def singular(n: int, k: int, fix: dict) -> bool:
    """Whether the fixings force Z(y, 0) to be singular: a pair at 1 (two
    equal rows), or k vertices pairwise at lo (their rows sum to zero)."""
    if any(v == 1 for v in fix.values()):
        return True
    I, J = pair_index(n)
    zero = {(int(I[t]), int(J[t])) for t, v in fix.items() if v == 0}
    verts = sorted({a for pq in zero for a in pq})
    return any(all((b, a) in zero for a, b in itertools.combinations(S, 2))
               for S in itertools.combinations(verts, k))


def merge(W: np.ndarray, k: int, fix: dict):
    """A box on the classes of its fixings at 1 (:func:`classes`): (Wq,
    fixq, constant, relations) with Wq the summed weights between classes,
    fixq the class pairs' fixings ({t: v} over the q classes' pairs), the
    weight inside the classes, and the sets of k classes pairwise fixed at
    0 (their vectors sum to zero); None where the fixings contradict each
    other (a pair inside a class at 0, a class pair fixed both ways)."""
    n = W.shape[0]
    I, J = pair_index(n)
    of = classes(n, fix)
    q = max(of) + 1
    const = 0.0
    Wq = np.zeros((q, q))
    for a in range(n):
        for b in range(a):
            if of[a] == of[b]:
                const += W[a, b]
            else:
                Wq[of[a], of[b]] += W[a, b]
                Wq[of[b], of[a]] += W[a, b]
    fixed = {}
    for t, v in fix.items():
        ca, cb = of[I[t]], of[J[t]]
        if ca == cb:
            if v == 0:
                return None
            continue
        if fixed.setdefault((max(ca, cb), min(ca, cb)), v) != v:
            return None
    zero = {pq for pq, v in fixed.items() if v == 0}
    rel = [S for S in itertools.combinations(range(q), k)
           if all((b, a) in zero for a, b in itertools.combinations(S, 2))]
    fixq = {a * (a - 1) // 2 + b: v for (a, b), v in fixed.items()}
    return Wq, fixq, const, rel


def reduced(W: np.ndarray, k: int, fix: dict):
    """The direct problem of a box on the face its fixings force:
    (F0, F, c, l, u, G, h, constant) of ``min c^T w + constant  s.t.
    F0 + sum_j w_j F_j >= 0,  l <= w <= u,  G w >= h``; None where the
    fixings contradict each other.

    Vertices joined by fixings at 1 form classes (their vectors are
    equal); k classes pairwise fixed at lo have vectors summing to zero.
    Every class vector is then V = P U from the vectors U of the classes
    these relations leave free (:func:`_relation_basis`), and the problem
    is over X' = U U^T >= 0: each entry (P X' P^T)_ab of a class pair is
    lo + s y_ab, fixed or in [lo, 1], each diagonal entry is 1, and the
    objective sums the weights between classes over their entries (the
    weight inside a class is the constant).  The equalities are solved,
    X' = X0 + sum_j w_j E_j over the upper triangle of X' (each free
    entry its own w where no relation mixes entries), and a constraint on
    one w alone is a bound."""
    got = merge(W, k, fix)
    if got is None:
        return None
    Wq, fixq, const, rel = got
    q = Wq.shape[0]
    lo, s = -1.0 / (k - 1.0), k / (k - 1.0)
    Iq, Jq = pair_index(q)
    fixed = {(int(Iq[t]), int(Jq[t])): v for t, v in fixq.items()}
    P = _relation_basis(q, rel)
    d = P.shape[1]
    tri = [(i, j) for i in range(d) for j in range(i, d)]

    def coef(a, b):
        """Coefficients of (P X' P^T)_ab on X''s upper triangle."""
        return np.array([P[a, i] * P[b, j] + (P[a, j] * P[b, i]
                                              if i != j else 0.0)
                         for i, j in tri])

    eq_A, eq_b, rows = [], [], []
    obj, c0 = np.zeros(len(tri)), 0.0
    for a in range(q):
        eq_A.append(coef(a, a))
        eq_b.append(1.0)
        for b in range(a):
            e = coef(a, b)
            obj += Wq[a, b] / s * e
            c0 -= Wq[a, b] * lo / s
            if (a, b) in fixed:
                eq_A.append(e)
                eq_b.append(lo + s * fixed[(a, b)])
            else:
                rows.append((e, lo, 1.0))        # lo <= entry <= 1
    A_eq, b_eq = np.array(eq_A), np.array(eq_b)
    x0 = np.linalg.lstsq(A_eq, b_eq, rcond=None)[0]
    if np.abs(A_eq @ x0 - b_eq).max() > 1e-9:
        return None
    single = (A_eq != 0).sum(1) == 1
    if single.all():
        # each equality fixes one entry: the others are the parameters
        pinned = np.flatnonzero(np.abs(A_eq).sum(0))
        N = np.eye(len(tri))[:, [j for j in range(len(tri))
                                 if j not in set(pinned)]]
    else:
        _, sv, Vt = np.linalg.svd(A_eq)
        N = Vt[int((sv > 1e-10 * sv.max()).sum()):].T

    def mat(x):
        X = np.zeros((d, d))
        for (i, j), val in zip(tri, x):
            X[i, j] = X[j, i] = val
        return X

    p = N.shape[1]
    F = np.stack([mat(N[:, j]) for j in range(p)] + [np.zeros((d, d))])[:-1]
    l, u = np.full(p, -np.inf), np.full(p, np.inf)
    G, h = [], []
    for e, lo_e, hi_e in rows:
        g, base = e @ N, e @ x0
        nz = np.flatnonzero(np.abs(g) > 1e-12)
        if len(nz) == 1 and g[nz[0]] > 0:
            j = nz[0]
            l[j] = max(l[j], (lo_e - base) / g[j])
            u[j] = min(u[j], (hi_e - base) / g[j])
        else:
            G += [g, -g]
            h += [lo_e - base, base - hi_e]
    G = np.array(G).reshape(len(G), p)
    return (mat(x0), F, obj @ N, l, u, G, np.array(h),
            const + c0 + obj @ x0)


def _reduced_problem(got, objective: bool, dtype, device) -> Problem:
    """The reduced problem of :func:`reduced`'s ``got`` with an r column
    (F = I): its value (r fixed at 0) or, without ``objective``, its
    phase-1 problem (min r, r free)."""
    F0, F, c, l, u, G, h, _ = got
    d, p = F0.shape[0], F.shape[0]
    Fr = np.concatenate([F, np.eye(d)[None]])
    Gr = np.concatenate([G, np.zeros((G.shape[0], 1))], 1)[None]
    if objective:
        cr, lr, ur = np.append(c, 0.0), np.append(l, 0.0), np.append(u, 0.0)
    else:
        cr = np.append(np.zeros(p), 1.0)
        lr, ur = np.append(l, -np.inf), np.append(u, np.inf)
    return Problem(F0, Fr, cr[None], lr[None], ur[None], Gr, h[None],
                   dtype, device)


def _merged_groups(W, k: int, fixes: list) -> tuple:
    """The boxes as their merges (:func:`merge`): those whose merge has no
    relation, grouped by class count q as {q: [(box index, Wq, fixq,
    constant)]} (each group one batch of the q-vertex problem), and the
    others' indices with their merges (None where they contradict)."""
    groups, other = {}, []
    for b, fx in enumerate(fixes):
        got = merge(W, k, fx)
        if got is not None and not got[3]:
            groups.setdefault(got[0].shape[0], []).append((b, *got[:3]))
        else:
            other.append((b, got))
    return groups, other


def reduced_phase1(W, k: int, fixes: list, dtype=torch.float64,
                   device="cpu", strict: bool = True) -> list:
    """Phase-1 values of the boxes' reduced problems (:func:`reduced`);
    -inf where a box's fixings contradict each other.  Boxes that merge
    into the same number of classes with no further relation are one
    batch of the merged graph's phase-1 problem."""
    t = [None] * len(fixes)
    groups, other = _merged_groups(W, k, fixes)
    for q, items in groups.items():
        mq = q * (q - 1) // 2
        vals = (solve_boxes(np.zeros((q, q)), k, [it[2] for it in items],
                            np.zeros(mq), 1.0, "free", dtype, device, strict)
                if q > 1 else [-1.0] * len(items))
        for (b, *_), v in zip(items, vals):
            t[b] = -v
    for b, got in other:
        got = reduced(W, k, fixes[b]) if got is not None else None
        if got is None:
            t[b] = -np.inf
        elif got[1].shape[0] == 0:
            t[b] = float(np.linalg.eigvalsh(got[0])[0])
        else:
            t[b] = -float(ipm(_reduced_problem(got, False, dtype, device),
                              strict)[0][0])
    return t


def boundary_values(W, k: int, fixes: list, dtype=torch.float64,
                    device="cpu", strict: bool = True) -> list:
    """The direct values of boxes feasible on the boundary only, from
    their reduced problems (:func:`reduced`), which must have an interior
    point (phase-1 value above ``INTERIOR``); boxes that merge into the
    same number of classes with no further relation are one batch."""
    if strict:
        for fx, t in zip(fixes, reduced_phase1(W, k, fixes, dtype, device)):
            if t <= INTERIOR:
                raise Undecided(f"the reduced box {fx} is not interior "
                                f"(phase-1 {t:.3g})")
    out = [None] * len(fixes)
    groups, other = _merged_groups(W, k, fixes)
    for q, items in groups.items():
        vals = solve_boxes(np.zeros((q, q)), k, [it[2] for it in items],
                           np.array([pair_weights(it[1]) for it in items]),
                           0.0, "zero", dtype, device, strict)
        for (b, _, _, const), v in zip(items, vals):
            out[b] = const + v
    for b, _ in other:
        got = reduced(W, k, fixes[b])
        if got is None:
            raise Undecided("a boundary box whose fixings contradict")
        out[b] = got[-1] + (float(ipm(_reduced_problem(
            got, True, dtype, device), strict)[0][0])
            if got[1].shape[0] else 0.0)
    return out
