"""MISDP problem data model.

Host-side sparse container (the information content of the reference's
``struct SCIP_SDPi`` problem image, src/sdpi/sdpi.c:216-320 and the
``SCIPsdpiLoadSDP`` contract, sdpi.c:2329-2358) plus the conversion to the
accelerator-friendly *dense padded* form consumed by the batched interior-point
solver (ops/ipm.py).

The canonical problem is the reference's dual form (sdpi.c:37-58):

    min  b^T y
    s.t. sum_j A_j^(k) y_j - A_0^(k)  >= 0   (PSD)   for each SDP block k
         lhs_i <= d_i^T y <= rhs_i                    for each LP row i
         l <= y <= u,   y_j integral for j in I

All matrices are symmetric; sparse triples are stored lower-triangular
(row >= col), matching the reader normalization of reader_sdpa.c /
reader_cbf.c.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

INF = 1e20  # infinity convention (SCIPinfinity default)


def is_inf(x) -> np.ndarray:
    return np.asarray(x) >= INF


def is_neginf(x) -> np.ndarray:
    return np.asarray(x) <= -INF


@dataclasses.dataclass
class SDPBlock:
    """One SDP block  sum_j A_j y_j - A_0 >= 0  in sparse triple form.

    ``var/row/col/val`` hold the variable-coefficient matrices A_j as one
    flat COO list tagged with the (0-based) variable index; ``const_*`` hold
    A_0.  Lower triangle only (row >= col).
    """

    size: int
    var: np.ndarray    # (nnz,) int32, 0-based variable indices
    row: np.ndarray    # (nnz,) int32
    col: np.ndarray    # (nnz,) int32
    val: np.ndarray    # (nnz,) float64
    const_row: np.ndarray
    const_col: np.ndarray
    const_val: np.ndarray
    rank1: bool = False

    def __post_init__(self):
        self.var = np.asarray(self.var, dtype=np.int32)
        self.row = np.asarray(self.row, dtype=np.int32)
        self.col = np.asarray(self.col, dtype=np.int32)
        self.val = np.asarray(self.val, dtype=np.float64)
        self.const_row = np.asarray(self.const_row, dtype=np.int32)
        self.const_col = np.asarray(self.const_col, dtype=np.int32)
        self.const_val = np.asarray(self.const_val, dtype=np.float64)
        # normalize to lower triangle
        r, c = self.row.copy(), self.col.copy()
        swap = r < c
        self.row = np.where(swap, c, r)
        self.col = np.where(swap, r, c)
        r, c = self.const_row.copy(), self.const_col.copy()
        swap = r < c
        self.const_row = np.where(swap, c, r)
        self.const_col = np.where(swap, r, c)

    def dense_coeff(self, nvars: int) -> np.ndarray:
        """Dense (nvars, size, size) symmetric coefficient tensor A_j."""
        A = np.zeros((nvars, self.size, self.size))
        np.add.at(A, (self.var, self.row, self.col), self.val)
        np.add.at(
            A,
            (self.var, self.col, self.row),
            np.where(self.row == self.col, 0.0, self.val),
        )
        return A

    def dense_const(self) -> np.ndarray:
        """Dense (size, size) symmetric constant matrix A_0."""
        C = np.zeros((self.size, self.size))
        np.add.at(C, (self.const_row, self.const_col), self.const_val)
        np.add.at(
            C,
            (self.const_col, self.const_row),
            np.where(self.const_row == self.const_col, 0.0, self.const_val),
        )
        return C


@dataclasses.dataclass
class LinearConstraints:
    """LP rows in CSR-like form  lhs <= D y <= rhs  (sdpi.c:2350-2356)."""

    nrows: int
    beg: np.ndarray    # (nrows+1,) int32 row starts
    ind: np.ndarray    # (nnz,) int32 variable indices
    val: np.ndarray    # (nnz,) float64
    lhs: np.ndarray    # (nrows,) float64, -INF if free
    rhs: np.ndarray    # (nrows,) float64, +INF if free

    def __post_init__(self):
        self.beg = np.asarray(self.beg, dtype=np.int32)
        self.ind = np.asarray(self.ind, dtype=np.int32)
        self.val = np.asarray(self.val, dtype=np.float64)
        self.lhs = np.asarray(self.lhs, dtype=np.float64)
        self.rhs = np.asarray(self.rhs, dtype=np.float64)

    @staticmethod
    def empty() -> "LinearConstraints":
        return LinearConstraints(0, np.zeros(1, np.int32), np.zeros(0, np.int32),
                                 np.zeros(0), np.zeros(0), np.zeros(0))

    @staticmethod
    def from_rows(rows: Sequence[Tuple[Sequence[int], Sequence[float], float, float]]
                  ) -> "LinearConstraints":
        """rows: list of (inds, vals, lhs, rhs)."""
        beg = [0]
        ind: List[int] = []
        val: List[float] = []
        lhs: List[float] = []
        rhs: List[float] = []
        for inds, vals, lo, hi in rows:
            ind.extend(inds)
            val.extend(vals)
            beg.append(len(ind))
            lhs.append(lo)
            rhs.append(hi)
        return LinearConstraints(len(rows), np.array(beg), np.array(ind),
                                 np.array(val), np.array(lhs), np.array(rhs))

    def dense(self, nvars: int) -> np.ndarray:
        D = np.zeros((self.nrows, nvars))
        for i in range(self.nrows):
            sl = slice(self.beg[i], self.beg[i + 1])
            np.add.at(D[i], self.ind[sl], self.val[sl])
        return D


@dataclasses.dataclass
class QuadConstraint:
    """A quadratic constraint  lhs <= l^T y + sum_t q_t y_{r_t} y_{c_t} <= rhs.

    The reference receives these through SCIP's nonlinear handler and can
    upgrade them to a rank-1 SDP constraint (consQuadConsUpgdSdp,
    cons_sdp.c:5636,6106); core/quadupgrade.py performs that lifting here.
    """

    lin_ind: np.ndarray   # (nl,) int32
    lin_val: np.ndarray   # (nl,)
    qrow: np.ndarray      # (nq,) int32 first factor
    qcol: np.ndarray      # (nq,) int32 second factor
    qval: np.ndarray      # (nq,)
    lhs: float
    rhs: float
    name: str = "quad"

    def __post_init__(self):
        self.lin_ind = np.asarray(self.lin_ind, dtype=np.int32)
        self.lin_val = np.asarray(self.lin_val, dtype=np.float64)
        self.qrow = np.asarray(self.qrow, dtype=np.int32)
        self.qcol = np.asarray(self.qcol, dtype=np.int32)
        self.qval = np.asarray(self.qval, dtype=np.float64)


@dataclasses.dataclass
class IndicatorLink:
    """Indicator constraint: binvar = 1  ==>  slackvar = 0.

    The linear row itself (with the slack variable added, coefficient +1)
    lives in ``MISDP.lp``; this mirrors the reference's translation of the
    SDPA indicator extension into SCIPcreateConsIndicatorLinCons
    (reader_sdpa.c:1195-1252).
    """

    binvar: int
    slackvar: int
    row: int


@dataclasses.dataclass
class MISDP:
    """A mixed-integer SDP in the reference dual form (minimization)."""

    nvars: int
    obj: np.ndarray          # (nvars,)  minimize obj @ y (internal form)
    lb: np.ndarray           # (nvars,)
    ub: np.ndarray           # (nvars,)
    integral: np.ndarray     # (nvars,) bool
    blocks: List[SDPBlock]
    lp: LinearConstraints
    indicators: List[IndicatorLink] = dataclasses.field(default_factory=list)
    # propagation-only rows: linear consequences of the SDP blocks added by
    # presolve with the reference's presollinconssparam=0 semantics
    # (cons_sdp.c:146 — "propagate, if solving LPs also separate"): they
    # participate in bound propagation but are NOT part of the SDP-mode
    # relaxation; LP mode folds them into the LP rows
    proprows: Optional[LinearConstraints] = None
    # quadratic constraints (upgraded to a rank-1 SDP block by presolve,
    # core/quadupgrade.py — consQuadConsUpgdSdp role)
    quadcons: List["QuadConstraint"] = dataclasses.field(default_factory=list)
    # bilinear lift structure from the quadratic upgrade: (w, i, j) with
    # variable w standing for y_i * y_j; enforced by McCormick cuts +
    # spatial branching in the B&B loop
    liftinfo: Optional[List[Tuple[int, int, int]]] = None
    # postsolve record of variable eliminations (fix_and_aggregate):
    # (orig_nvars, keep_indices, ops) — ops applied in reverse to map a
    # solution of the reduced problem back to the original variable space
    postsolve: Optional[tuple] = None
    name: str = "misdp"
    varnames: Optional[List[str]] = None
    # objsense/objscale/objoffset map internal min-form values back to the
    # user's original objective: user_obj = objsense * internal + objoffset
    objsense: float = 1.0
    objoffset: float = 0.0

    def __post_init__(self):
        self.obj = np.asarray(self.obj, dtype=np.float64)
        self.lb = np.asarray(self.lb, dtype=np.float64)
        self.ub = np.asarray(self.ub, dtype=np.float64)
        self.integral = np.asarray(self.integral, dtype=bool)
        assert self.obj.shape == (self.nvars,)
        assert self.lb.shape == (self.nvars,)
        assert self.ub.shape == (self.nvars,)

    @property
    def nblocks(self) -> int:
        return len(self.blocks)

    @property
    def nlprows(self) -> int:
        return self.lp.nrows

    def external_objval(self, internal: float) -> float:
        return self.objsense * internal + self.objoffset

    def validate(self) -> None:
        for b in self.blocks:
            assert b.size >= 1
            if len(b.var):
                assert b.var.min() >= 0 and b.var.max() < self.nvars
                assert b.row.min() >= 0 and b.row.max() < b.size
            if len(b.const_row):
                assert b.const_row.min() >= 0 and b.const_row.max() < b.size
        if self.lp.nrows and len(self.lp.ind):
            assert self.lp.ind.min() >= 0 and self.lp.ind.max() < self.nvars


@dataclasses.dataclass
class DenseSDPData:
    """Padded dense device form of one MISDP for the batched IPM.

    All SDP blocks are padded to a common size ``n``; padding dimensions get
    A_j = 0 and A_0 = -I, so the padded slack block S = sum A_j y_j - A_0 has
    ones on the padding diagonal — strictly PSD-preserving and inert
    (contributes nothing to the Schur complement, and X on the padding
    converges to 0 since C = A_0 = -I there pushes it down).  ``dimmask``
    marks real dimensions so mu and convergence checks can ignore padding.
    """

    nvars: int
    nblocks: int
    blocksize: int               # common padded size n (0 if no blocks)
    obj: np.ndarray              # (m,)
    A: np.ndarray                # (K, m, n, n) symmetric coefficient tensors
    C: np.ndarray                # (K, n, n)    constant matrices A_0 (padded -I)
    dimmask: np.ndarray          # (K, n) bool  real dims
    blocksizes: np.ndarray       # (K,) int     real sizes
    # LP rows, all normalized to  G y >= h  (each finite side of a ranged
    # row becomes one >= row, like the back-ends' internal handling)
    G: np.ndarray                # (p, m)
    h: np.ndarray                # (p,)
    row_of_lprow: np.ndarray     # (p,) original LP row index (for duals)
    row_sign: np.ndarray         # (p,) +1 for lhs rows, -1 for rhs rows
    integral: np.ndarray         # (m,) bool
    rank1: np.ndarray            # (K,) bool

    @property
    def nineq(self) -> int:
        return self.G.shape[0]


def densify(problem: MISDP, pad_to: Optional[int] = None) -> DenseSDPData:
    """Convert a sparse MISDP into the padded dense solver form."""
    m = problem.nvars
    K = len(problem.blocks)
    n = max([b.size for b in problem.blocks], default=0)
    if pad_to is not None:
        n = max(n, pad_to)
    A = np.zeros((K, m, n, n))
    C = np.zeros((K, n, n))
    dimmask = np.zeros((K, n), dtype=bool)
    bsizes = np.zeros((K,), dtype=np.int32)
    rank1 = np.zeros((K,), dtype=bool)
    for k, b in enumerate(problem.blocks):
        A[k, :, : b.size, : b.size] = b.dense_coeff(m)
        C[k, : b.size, : b.size] = b.dense_const()
        # padding: A_0 = -I so the slack block gets +1 on the padded diagonal
        for d in range(b.size, n):
            C[k, d, d] = -1.0
        dimmask[k, : b.size] = True
        bsizes[k] = b.size
        rank1[k] = b.rank1

    # LP rows -> G y >= h
    D = problem.lp.dense(m)
    G_rows, h_vals, orig, sign = [], [], [], []
    for i in range(problem.lp.nrows):
        if not is_neginf(problem.lp.lhs[i]):
            G_rows.append(D[i])
            h_vals.append(problem.lp.lhs[i])
            orig.append(i)
            sign.append(1.0)
        if not is_inf(problem.lp.rhs[i]):
            G_rows.append(-D[i])
            h_vals.append(-problem.lp.rhs[i])
            orig.append(i)
            sign.append(-1.0)
    G = np.array(G_rows).reshape(len(G_rows), m) if G_rows else np.zeros((0, m))
    h = np.array(h_vals) if h_vals else np.zeros((0,))

    return DenseSDPData(
        nvars=m,
        nblocks=K,
        blocksize=n,
        obj=problem.obj.copy(),
        A=A,
        C=C,
        dimmask=dimmask,
        blocksizes=bsizes,
        G=G,
        h=h,
        row_of_lprow=np.array(orig, dtype=np.int32),
        row_sign=np.array(sign),
        integral=problem.integral.copy(),
        rank1=rank1,
    )
