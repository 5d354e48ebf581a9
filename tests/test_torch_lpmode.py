"""The port's LP outer-approximation mode (``solve_sdps=0``) against the
JAX package's on the CPU.

Nodes solve LP relaxations on the host simplex (scipy HiGHS) and the SDP
blocks are enforced by eigenvector cuts (``ops/cuts.py``) in a global
pool, with the exact SDP solve of an integral node (``enforcesdp``).  Both
packages run the host loop (``bb.turbo="off"``; LP mode never engages
turbo) with the IPM settings pinned; the LP mode's rounding heuristics
draw from numpy on the host in both, so the randomized one stays on.
Same status, the optimum within 1e-4 relative and every ``BBStats``
counter equal on: tests/test_lpmode.py's ``corr_enforce`` instance
(enforce_after=0, the exact enforcement path; and at the defaults with
one cut a block and disjoint-support sparse cuts), two infeasible
instances (one decided by propagation, one by cuts), and small CLS and
MkP instances in place of test_lp_mode_parity's instance files
(``ncuts > 0``, as there).

Min-k-partition's LP vertices have repeated eigenvalues, and LAPACK builds
split such an eigenspace into different vectors; the cuts differ, and so
do the pool's contents and the tree's counts.  So the MkP tree is held to
every counter with the port's ``torch.linalg.eigh`` answered by the JAX
package's LAPACK (the split is the only difference), and to the optimum
with its own.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bbcases import torch_one_thread  # noqa: F401
from scipsdp_tpu.core.branchbound import solve_misdp as jax_solve_misdp
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models.problem import (LinearConstraints, MISDP, SDPBlock)
from scipsdp_tpu.utils.config import (BBSettings, CutSettings, IPMSettings,
                                      Settings)
from scipsdp_tpu_torch.core import branchbound as tbb
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax

pytestmark = pytest.mark.usefixtures("torch_one_thread")

IPM = IPMSettings(phase32="off", step_rule="eigh", use_lanes_chol=False,
                  use_df32="off", fused_direction="off")
REL = 1e-4


def corr_prob(lp_rows=()):
    """tests/test_lpmode.py::test_lpmode_exact_enforcement_path's
    problem: maximize y0 + y1 over binaries with the correlation matrix
    [[1, y0, 0], [y0, 1, y1], [0, y1, 1]] PSD (y0^2 + y1^2 <= 1): the LP
    optimum (1, 1) violates the SDP, the optimum is -1.  With the row
    y0 + y1 >= 2 no integer point is left."""
    blk = SDPBlock(size=3, var=[0, 1], row=[1, 2], col=[0, 1],
                   val=[1.0, 1.0], const_row=[0, 1, 2], const_col=[0, 1, 2],
                   const_val=[-1.0, -1.0, -1.0])
    lp = (LinearConstraints.from_rows(list(lp_rows)) if lp_rows
          else LinearConstraints.empty())
    return MISDP(nvars=2, obj=np.array([-1.0, -1.0]), lb=np.zeros(2),
                 ub=np.ones(2), integral=np.ones(2, dtype=bool),
                 blocks=[blk], lp=lp, name="corr_enforce")


def settings(batch_size=16, cuts=None, **bb):
    bb = {"turbo": "off", "node_limit": 400, "batch_size": batch_size, **bb}
    return Settings(ipm=IPM, solve_sdps=0, bb=BBSettings(**bb),
                    cuts=cuts or CutSettings())


def counters(stats) -> dict:
    """Every BBStats field but the timings."""
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.name not in ("prop_times", "wall_time", "solve_time")}


def solve_both(jprob, s):
    rj = jax_solve_misdp(jprob, s)
    rt = tbb.solve_misdp(problem_from_jax(jprob), settings_from_jax(s),
                         device="cpu")
    return rj, rt


def assert_same_optimum(rj, rt):
    assert rt.status.name == rj.status.name
    if rj.objval is None:
        assert rt.objval is None
        return
    assert abs(rt.objval - rj.objval) <= REL * max(1.0, abs(rj.objval))
    assert abs(rt.dual_bound - rj.dual_bound) <= REL * max(
        1.0, abs(rj.dual_bound))


def triangle_prob():
    """Z = I + y0 (E01 + E10) + y1 (E12 + E21) - y2 (E02 + E20) PSD over
    binaries with y0 + y1 + y2 >= 2: every pair at 1 (and all three) has
    a negative minor, so no integer point is feasible, while the LP
    relaxation needs cuts and branching to show it."""
    blk = SDPBlock(size=3, var=[0, 1, 2], row=[1, 2, 2], col=[0, 1, 0],
                   val=[1.0, 1.0, -1.0], const_row=[0, 1, 2],
                   const_col=[0, 1, 2], const_val=[-1.0, -1.0, -1.0])
    lp = LinearConstraints.from_rows([([0, 1, 2], [1.0, 1.0, 1.0], 2.0,
                                       1e20)])
    return MISDP(nvars=3, obj=np.array([1.0, 2.0, 3.0]), lb=np.zeros(3),
                 ub=np.ones(3), integral=np.ones(3, dtype=bool),
                 blocks=[blk], lp=lp, name="triangle")


CASES = {   # name: (problem, settings, status, optimum)
    "corr_enforce": (corr_prob, settings(enforcesdp=True, enforce_after=0),
                     "OPTIMAL", -1.0),
    "corr_infeasible": (lambda: corr_prob([([0, 1], [1.0, 1.0], 2.0,
                                            1e20)]),
                        settings(), "INFEASIBLE", None),
    "triangle_infeasible": (triangle_prob, settings(), "INFEASIBLE", None),
    "cls": (lambda: jfam.cardinality_least_squares(5, 8, 2), settings(),
            "OPTIMAL", None),
    "corr_sparse_onecut": (
        corr_prob, settings(cuts=CutSettings(multiplesparsecuts=True,
                                             separateonecut=True,
                                             sparsifytargetsize=2)),
        "OPTIMAL", -1.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lp_mode_parity(name):
    build, s, status, optimum = CASES[name]
    rj, rt = solve_both(build(), s)
    assert rj.status.name == status
    assert_same_optimum(rj, rt)
    assert counters(rt.stats) == counters(rj.stats)
    if optimum is not None:
        assert abs(rt.objval - optimum) <= REL
    if name == "corr_enforce":
        assert rt.stats.nenforce_sdp > 0
    if name.startswith(("cls", "corr_sparse")):
        assert rt.stats.ncuts > 0 and rt.stats.sep_rounds > 0


def jax_lapack_eigh(M):
    """torch.linalg.eigh's contract answered by the JAX package's eigh."""
    lam, V = jnp.linalg.eigh(jnp.asarray(M.numpy()))
    return torch.from_numpy(np.array(lam)), torch.from_numpy(np.array(V))


@pytest.mark.parametrize("split", ["jax_lapack", "own"])
def test_lp_mode_mkp(monkeypatch, split):
    jprob = jfam.min_k_partition(5, 2)
    if split == "jax_lapack":
        monkeypatch.setattr(torch.linalg, "eigh", jax_lapack_eigh)
    rj, rt = solve_both(jprob, settings())
    assert rj.status.name == "OPTIMAL"
    assert_same_optimum(rj, rt)
    assert rt.stats.ncuts > 0
    if split == "jax_lapack":
        assert counters(rt.stats) == counters(rj.stats)


def test_lp_mode_never_engages_turbo(monkeypatch):
    """LP mode runs the host loop under bb.turbo="on" too."""
    from scipsdp_tpu_torch.core import turbo as tturbo
    calls = []
    monkeypatch.setattr(tturbo, "solve_turbo",
                        lambda *a, **kw: calls.append(1))
    s = settings_from_jax(settings(turbo="on"))
    res = tbb.solve_misdp(problem_from_jax(jfam.cardinality_least_squares(
        5, 8, 2)), s, device="cpu")
    assert res.status.name == "OPTIMAL" and calls == []
