"""Shared problems and comparisons of the B&B parity tests
(``test_torch_bbmodules.py``, ``test_torch_branchbound.py``).

Every problem is built as a JAX package ``MISDP`` from numpy and carried
into the port with ``interop.problem_from_jax``; none reads a file.  The
builders of the problems named after a test of the JAX package come from
that test, so both packages are held to the same instance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models.problem import (INF, IndicatorLink,
                                        LinearConstraints, MISDP,
                                        QuadConstraint, SDPBlock)
from test_buckets import _hetero_prob
from test_intree_prop import _prob_matrixview
from test_symmetry import _symmetric_prob


def conflict_prob():
    """test_conflict.py::test_bb_with_conflicts_still_correct's problem:
    min y0 + y1, diag(y) >= 1.5 I, y integer in [0, 3] -> 4 at (2, 2)."""
    blk = SDPBlock(size=2, var=[0, 1], row=[0, 1], col=[0, 1],
                   val=[1.0, 1.0], const_row=[0, 1], const_col=[0, 1],
                   const_val=[1.5, 1.5])
    return MISDP(nvars=2, obj=np.array([1.0, 1.0]), lb=np.zeros(2),
                 ub=np.full(2, 3.0), integral=np.ones(2, bool),
                 blocks=[blk], lp=LinearConstraints.empty(), name="confbb")


def aggsolve_prob():
    """test_presolve.py::test_fix_and_aggregate_solve_parity's "aggsolve":
    a fixed variable and an equality row presolve can aggregate."""
    blk = SDPBlock(size=2, var=[1, 2], row=[0, 1], col=[0, 1],
                   val=[1.0, 1.0], const_row=[0, 1], const_col=[0, 1],
                   const_val=[1.0, 1.0])
    lp = LinearConstraints.from_rows([([1, 2], [1.0, 1.0], 4.0, 4.0)])
    return MISDP(nvars=3, obj=np.array([0.0, 1.0, 2.0]),
                 lb=np.array([1.0, 0.0, 0.0]),
                 ub=np.array([1.0, 10.0, 10.0]),
                 integral=np.array([False, False, True]),
                 blocks=[blk], lp=lp, name="aggsolve")


def quadratic_prob():
    """test_readers.py::test_quadratic_bb_solve's problem: min x + y,
    x*y >= 1 on [0, 2]^2 -> 2 at (1, 1); presolve lifts x*y into a new
    variable under a PSD block, so the tree runs the bilinear-lift
    enforcement (McCormick cuts, spatial branching)."""
    return MISDP(
        nvars=2, obj=np.ones(2), lb=np.zeros(2), ub=np.full(2, 2.0),
        integral=np.zeros(2, bool), blocks=[], lp=LinearConstraints.empty(),
        quadcons=[QuadConstraint(lin_ind=[], lin_val=[], qrow=[0],
                                 qcol=[1], qval=[1.0], lhs=1.0, rhs=1e20)],
        name="qp")


def rank1_prob():
    """A rank-1 block Z = diag(y0, y1, y2) + (E21 + E12) with
    min y1 + y2: the relaxation leaves y0 free inside [0, 1], so its
    interior optimum has rank 2; the rank-1 optimum 2 needs y0 = 0 and
    y1 y2 = 1.  The tree runs the rank-1 check and the perturbed re-solves
    of the extreme-point heuristic."""
    blk = SDPBlock(size=3, var=[0, 1, 2], row=[0, 1, 2], col=[0, 1, 2],
                   val=[1.0, 1.0, 1.0], const_row=[2], const_col=[1],
                   const_val=[-1.0], rank1=True)
    return MISDP(nvars=3, obj=np.array([0.0, 1.0, 1.0]), lb=np.zeros(3),
                 ub=np.array([1.0, 3.0, 3.0]), integral=np.zeros(3, bool),
                 blocks=[blk], lp=LinearConstraints.empty(), name="rank1")


def cyclic_prob():
    """test_symmetry_orbital.py's cyclic-only symmetry (no transposition
    is an automorphism)."""
    rows = [([0, 1], [1.0, 2.0], -INF, 2.0),
            ([1, 2], [1.0, 2.0], -INF, 2.0),
            ([2, 0], [1.0, 2.0], -INF, 2.0)]
    return MISDP(nvars=3, obj=np.array([-1.0, -1.0, -1.0]), lb=np.zeros(3),
                 ub=np.ones(3), integral=np.ones(3, bool), blocks=[],
                 lp=LinearConstraints.from_rows(rows), name="cyc3")


def upper_bound_prob():
    """test_propagate_sdp.py's X = [[y0, y2], [y2, y1]] with y0 + y1 <= 3
    (upper-bound propagation and the trace bound)."""
    blk = SDPBlock(size=2, var=[0, 1, 2], row=[0, 1, 1], col=[0, 1, 0],
                   val=[1.0, 1.0, 1.0], const_row=[], const_col=[],
                   const_val=[])
    lp = LinearConstraints.from_rows([([0, 1], [1.0, 1.0], -INF, 3.0)])
    return MISDP(nvars=3, obj=np.zeros(3), lb=np.full(3, -INF),
                 ub=np.array([8.0, 8.0, INF]), integral=np.zeros(3, bool),
                 blocks=[blk], lp=lp, name="tb")


def minors_prob():
    """test_propagate_sdp.py's 3x3-minor instance."""
    blk = SDPBlock(size=3, var=[0, 1], row=[2, 2], col=[0, 1],
                   val=[1.0, 1.0], const_row=[0, 1, 2, 1],
                   const_col=[0, 1, 2, 0],
                   const_val=[-1.0, -1.0, -1.0, -1.0])
    return MISDP(nvars=2, obj=np.zeros(2), lb=np.array([0.0, 0.2]),
                 ub=np.array([0.5, 1.0]), integral=np.zeros(2, bool),
                 blocks=[blk], lp=LinearConstraints.empty(), name="p3m")


def onevar_bound_prob():
    """test_propagate_sdp.py's one-variable SDP bound instance."""
    blk = SDPBlock(size=2, var=[0, 0, 1], row=[0, 1, 0], col=[0, 1, 0],
                   val=[1.0, 1.0, 1.0], const_row=[0, 1], const_col=[0, 1],
                   const_val=[1.0, 4.0])
    return MISDP(nvars=2, obj=np.zeros(2), lb=np.array([-INF, 0.0]),
                 ub=np.array([10.0, 0.0]), integral=np.zeros(2, bool),
                 blocks=[blk], lp=LinearConstraints.empty(), name="tb1")


def indicator_prob():
    """Indicator links built as tests/test_writers.py builds one
    (``IndicatorLink(binvar, slackvar, row)`` on an LP row), under a PSD
    block instead of its quadratic row: min x0 + 2 x1 - 1.5 z0 - 1.2 z1
    with [[x0, 1], [1, x1]] PSD, x_i + s_i >= 1, z0 + z1 <= 1 and
    z_i = 1 => s_i = 0.  The relaxation takes z fractional or sets a z with
    its slack positive, so the tree branches on fractions and enforces
    the links."""
    blk = SDPBlock(size=2, var=[0, 1], row=[0, 1], col=[0, 1],
                   val=[1.0, 1.0], const_row=[1], const_col=[0],
                   const_val=[-1.0])
    lp = LinearConstraints.from_rows([([0, 4], [1.0, 1.0], 1.0, INF),
                                      ([1, 5], [1.0, 1.0], 1.0, INF),
                                      ([2, 3], [1.0, 1.0], -INF, 1.0)])
    return MISDP(nvars=6, obj=np.array([1.0, 2.0, -1.5, -1.2, 0.0, 0.0]),
                 lb=np.zeros(6), ub=np.array([4.0, 4.0, 1.0, 1.0, 4.0, 4.0]),
                 integral=np.array([False, False, True, True, False, False]),
                 blocks=[blk], lp=lp,
                 indicators=[IndicatorLink(binvar=2, slackvar=4, row=0),
                             IndicatorLink(binvar=3, slackvar=5, row=1)],
                 name="ind")


def obbt_prob():
    """Integers whose relaxation bound only a 4 x 4 eigenvalue shows:
    min -y0 - 2 y1 with 4.5 I - (y0 + y1)(J - I) PSD (so y0 + y1 <= 1.5)
    and y integer in [0, 10].  Propagation reads the 2 x 2 minors
    (y0 + y1 <= 4.5); OBBT over the integers tightens both upper bounds
    to 1.5.  Optimum -2 at (0, 1)."""
    off = [(r, c) for r in range(4) for c in range(r)]
    blk = SDPBlock(size=4, var=[0] * 6 + [1] * 6,
                   row=[r for r, _ in off] * 2, col=[c for _, c in off] * 2,
                   val=[-1.0] * 12, const_row=list(range(4)),
                   const_col=list(range(4)), const_val=[-4.5] * 4)
    return MISDP(nvars=2, obj=np.array([-1.0, -2.0]), lb=np.zeros(2),
                 ub=np.full(2, 10.0), integral=np.ones(2, bool),
                 blocks=[blk], lp=LinearConstraints.empty(), name="obbt4")


@pytest.fixture(scope="module")
def torch_one_thread():
    """torch's CPU ops on one thread while a module runs, the caller's
    count restored after: the trees' tensors are tiny, and the OpenMP
    workers of eager ops spin against the other test processes on the
    machine (one file took 6 minutes beside one other worker, 70 s
    alone)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# the solve instances of the parity tests: (builder, batch_size)
SOLVE = {
    "cls": (lambda: jfam.cardinality_least_squares(5, 8, 2), 16),
    "mkp": (lambda: jfam.min_k_partition(5, 2), 16),
    "tt": (lambda: jfam.truss_topology(4, 1), 16),
    "sym": (_symmetric_prob, 16),
    "conflict": (conflict_prob, 4),
    "hetero": (_hetero_prob, 16),
    "aggsolve": (aggsolve_prob, 16),
    "quadratic": (quadratic_prob, 4),
    "rank1": (rank1_prob, 4),
}

# problems for the module-level comparisons
PROBLEMS = {
    "cls": lambda: jfam.cardinality_least_squares(5, 8, 2),
    "mkp": lambda: jfam.min_k_partition(5, 2),
    "tt": lambda: jfam.truss_topology(4, 1),
    "sym": _symmetric_prob,
    "conflict": conflict_prob,
    "hetero": _hetero_prob,
    "aggsolve": aggsolve_prob,
    "quadratic": quadratic_prob,
    "rank1": rank1_prob,
    "cyclic": cyclic_prob,
    "matrixview": _prob_matrixview,
    "upper_bound": upper_bound_prob,
    "minors": minors_prob,
    "onevar_bound": onevar_bound_prob,
}


def assert_same(a, b, path="value"):
    """``a`` (the JAX package's) and ``b`` (the port's) hold the same
    values exactly: dataclasses of the same name field by field, arrays
    bit for bit (NaN equal to NaN), containers item by item."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"
