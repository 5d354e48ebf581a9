"""Min-k-partition on toroidal grids (the benchmark's ``mkp_t2g7_k3``
family at small sizes): the port's batched solve against the benchmark's
plain reference (``misdp_bench/reference/mkp_reference.py``) on boxes of
each kind and rung, the B&B against brute force, the generator's
objective against the intra-part weight, and the port's float64 Schur
shift against the JAX package's on those boxes."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from _torch_parity import (assert_close_scaled, jax_solve, port_data,
                           torch_solve)
from misdp_bench import harness, nodes_mkp
from misdp_bench.instances_mkp import Instance, pairs, torus_edges
from misdp_bench.reference import mkp_reference as ref
from scipsdp_tpu.models.problem import DenseSDPData as JaxDense
from scipsdp_tpu.ops import ipm as jipm
from scipsdp_tpu_torch.core.branchbound import solve_misdp
from scipsdp_tpu_torch.models.problem import densify
from scipsdp_tpu_torch.ops import ipm
from scipsdp_tpu_torch.utils.config import Settings, resolve_backend_autos
from scipsdp_tpu_torch.utils.status import SolverResultStatus

OPTIMAL = int(SolverResultStatus.OPTIMAL)
GAPTOL = 1e-5


def instance(rows: int, seed: int) -> Instance:
    return Instance({"rows": rows, "cols": rows, "k": 3}, seed)


def boxes(n: int) -> list:
    """Seeded boxes as {t: v}: the root, an edge fixed at 0 and at 1, two
    edges at 0, a conflicting triangle (two pairs at 1, the third at 0)
    and a merge of two vertices with a further pair at 0."""
    idx = {p: t for t, p in enumerate(pairs(n))}
    t10, t21, t20 = idx[(1, 0)], idx[(2, 1)], idx[(2, 0)]
    tn = idx[(n - 1, 0)]
    return [{}, {t10: 0}, {t10: 1}, {t10: 0, tn: 0},
            {t10: 1, t21: 1, t20: 0}, {t10: 1, tn: 0}]


def fix_rows(m: int, fixes: list) -> np.ndarray:
    """(len(fixes), m) int8: -1 where y_t is free, else its fixed value."""
    fix = np.full((len(fixes), m), -1, dtype=np.int8)
    for s, fx in enumerate(fixes):
        for t, v in fx.items():
            fix[s, t] = v
    return fix


@pytest.mark.parametrize("rows", [3, 4])
@pytest.mark.parametrize("rung", ["direct", "probe", "penalty"])
def test_ipm_solve_against_the_reference(rows, rung):
    inst = instance(rows, 11)
    prob = inst.misdp()
    n = rows * rows
    fixes = boxes(n)
    fix = fix_rows(prob.nvars, fixes)
    gamma = 1e3 if rung == "penalty" else 0.0
    request = harness.driver_module("frontier_rungs").request
    data = ipm.build_ipm_data(densify(prob), "cpu")
    settings = resolve_backend_autos(Settings(), "cpu").ipm
    out = ipm.ipm_solve(data, *request(prob, fix, rung, gamma),
                        settings=settings)
    answer = {"instance": 0, "rung": rung, "gamma": gamma, "fix": fix,
              "status": out.status.numpy(), "dobj": out.dobj.numpy()}
    r = nodes_mkp.Reference([inst])
    cls = r.classes([answer])[0]
    assert cls == ["interior", "interior", "boundary", "interior",
                   "infeasible", "boundary"]
    must, must_not, feasible = nodes_mkp.rules(answer, cls)
    is_opt = answer["status"] == OPTIMAL
    is_inf = np.isin(answer["status"], nodes_mkp.PRUNED)
    assert not (must & ~is_opt).any(), answer["status"]
    assert not (must_not & is_opt).any() and not (feasible & is_inf).any()
    val = r.values([answer], [is_opt])[0]
    gap = np.abs(answer["dobj"] - val) / (1 + np.abs(val))
    # an interior box's relaxation value within 1e-6; the probe's and the
    # penalty rung's values carry the penalty variable, resolved to the
    # solver's gaptol against 1 + Gamma, so they are held at gaptol
    interior = np.array([c == "interior" for c in cls])
    if rung == "direct":
        assert (gap[is_opt & interior] <= 1e-6).all(), gap
    assert (gap[is_opt] <= GAPTOL).all(), gap


def brute_force(W: np.ndarray, k: int) -> float:
    """Least intra-part weight over every assignment of the vertices to k
    labels."""
    n = W.shape[0]
    labels = np.array(list(itertools.product(range(k), repeat=n)))
    same = labels[:, :, None] == labels[:, None, :]
    return float((np.triu(W, 1)[None] * same).sum((1, 2)).min())


@pytest.mark.parametrize("seed", [3, 11])
def test_solve_misdp_is_the_brute_force_optimum(seed):
    inst = instance(3, seed)
    res = solve_misdp(inst.misdp(), device="cpu")
    assert res.status.name == "OPTIMAL"
    best = brute_force(inst.W, 3)
    assert res.objval == pytest.approx(best, rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("rows,seed", [(3, 1), (4, 2), (7, 5555)])
def test_objective_at_a_partition_is_its_intra_part_weight(rows, seed):
    inst = instance(rows, seed)
    prob = inst.misdp()
    n = rows * rows
    assert prob.nvars == n * (n - 1) // 2
    assert len(torus_edges(rows, rows)) == 2 * n
    part = np.random.default_rng(seed).integers(0, 3, n)
    y = np.array([float(part[i] == part[j]) for i, j in pairs(n)])
    intra = sum(inst.W[i, j] for i, j in torus_edges(rows, rows)
                if part[i] == part[j])
    assert prob.obj @ y == pytest.approx(intra, abs=1e-12)
    # the partition's X: 1 within a part, -1/2 across, PSD
    dense = densify(prob)
    Z = np.einsum("jab,j->ab", dense.A[0], y) - dense.C[0]
    X = np.where(part[:, None] == part[None, :], 1.0, -0.5)
    np.testing.assert_allclose(Z, X, atol=1e-12)
    assert np.linalg.eigvalsh(Z).min() > -1e-12


def test_reference_schur_is_the_trace_definition():
    """The reference's Schur matrix is <F_i, X F_j Z^-1> term by term."""
    g = torch.Generator().manual_seed(0)
    F0, F = ref.mkp_data(4, 3)
    p = F.shape[0]
    pr = ref.Problem(F0, F, np.zeros((1, p)), np.zeros((1, p)),
                     np.ones((1, p)))
    A = torch.randn(4, 4, generator=g, dtype=torch.float64)
    X = (A @ A.T + torch.eye(4, dtype=torch.float64))[None]
    A = torch.randn(4, 4, generator=g, dtype=torch.float64)
    Zi = torch.linalg.inv(A @ A.T + torch.eye(4, dtype=torch.float64))[None]
    Ft = torch.as_tensor(F)
    want = torch.tensor([[torch.trace(Ft[i] @ X[0] @ Ft[j] @ Zi[0])
                          for j in range(p)] for i in range(p)])
    torch.testing.assert_close(pr.schur(X, Zi)[0], want)


def _solve_boxes(rows: int, rung: str) -> tuple:
    """(the port's answer, the JAX package's) on ``boxes`` of a rows x rows
    torus in one rung, both on the CPU at the port's CPU settings: the JAX
    package shifts the float64 Schur system by the largest entry's
    ``chol_reg * (1 + max|M|)`` on every row in every mode."""
    inst = instance(rows, 11)
    prob = inst.misdp()
    fix = fix_rows(prob.nvars, boxes(rows * rows))
    req = harness.driver_module("frontier_rungs").request(
        prob, fix, rung, 1e3 if rung == "penalty" else 0.0)
    tdense = densify(prob)
    jdata = jipm.build_ipm_data(JaxDense(**{
        f.name: getattr(tdense, f.name)
        for f in dataclasses.fields(tdense)}))
    kw = dataclasses.asdict(resolve_backend_autos(Settings(), "cpu").ipm)
    return (torch_solve(port_data(jdata), *req, kw),
            jax_solve(jdata, *req, kw))


def test_direct_mode_is_the_jax_solve():
    """With the penalty variable fixed (the direct mode) the shift is the
    JAX package's: the same iterations and statuses, the same bounds of
    the solved slots (a box with no interior leaves both where their last
    steps stalled)."""
    port, jax_ = _solve_boxes(4, "direct")
    assert port["iters"] == jax_["iters"]
    np.testing.assert_array_equal(port["status"], jax_["status"])
    opt = jax_["status"] == OPTIMAL
    assert opt.sum() >= 3, jax_["status"]
    assert_close_scaled(port["dobj"][opt], jax_["dobj"][opt], 1e-9, 1e-9,
                        "dobj")


def test_row_shift_solves_the_penalty_rung():
    """Gamma = 1e3 on 4 x 4 boxes: the largest entry's shift (r's bound
    barrier, ~1e17 as r -> 0) stalls the JAX package's primal residual and
    its solves end FAILED; each row's own shift solves every box."""
    port, jax_ = _solve_boxes(4, "penalty")
    assert (port["status"] == OPTIMAL).all(), port["status"]
    assert (jax_["status"] != OPTIMAL).sum() >= 2, jax_["status"]
    assert port["iters"] < jax_["iters"]


@pytest.mark.parametrize("seed", [0, 3])
def test_probe_rung_solves_deep_boxes(seed):
    """The probe rung on 16 deep boxes of a 5 x 5 torus (4-7 random
    fixings), at the CPU's settings: near a box with no interior the
    product with the Schur matrix's explicit inverse leaves a residual
    that each step carries into the primal residual, and one slot of each
    batch stalled with its gap closed until the Schur solve took residual
    passes; every slot ends OPTIMAL at the reference's value."""
    inst = instance(5, 100 + seed)
    prob = inst.misdp()
    rng = np.random.default_rng(seed)
    fix = np.full((16, prob.nvars), -1, dtype=np.int8)
    for s in range(16):
        k = rng.integers(4, 8)
        ts = rng.choice(prob.nvars, k, replace=False)
        fix[s, ts] = rng.integers(0, 2, k)
    req = harness.driver_module("frontier_rungs").request(prob, fix,
                                                          "probe", 0.0)
    settings = resolve_backend_autos(Settings(), "cpu").ipm
    out = ipm.ipm_solve(ipm.build_ipm_data(densify(prob), "cpu"), *req,
                        settings=settings)
    assert (out.status.numpy() == OPTIMAL).all(), out.status
    fixes = [{int(t): int(fix[s, t]) for t in np.where(fix[s] >= 0)[0]}
             for s in range(16)]
    want = np.maximum(0.0, -np.array(ref.phase1(inst.W, 3, fixes)))
    np.testing.assert_allclose(out.dobj.numpy(), want, rtol=0, atol=GAPTOL)


def test_penalty_rung_is_not_stalled_while_it_converges():
    """A penalty call (Gamma = 1e3) of the benchmark's 7 x 7 cell on one
    box with no interior, at the card's step rule: r climbs to ~400 and
    Gamma r inflates |dobj|, so the first iterates' relative gap reads
    0.34 and the converging ones 1.5-36.  A stall merit on that relative
    gap declared the slot FAILED at iteration 17 while its gap fell by a
    third an iteration; on the gap relative to the objective without the
    penalty term it ends OPTIMAL."""
    inst = Instance({"rows": 7, "cols": 7, "k": 3}, 6666)
    prob = inst.misdp()
    fix = fix_rows(prob.nvars, [{623: 0, 659: 0, 665: 1, 855: 0, 939: 1,
                                 945: 1}])
    req = harness.driver_module("frontier_rungs").request(prob, fix,
                                                          "penalty", 1e3)
    settings = dataclasses.replace(
        resolve_backend_autos(Settings(), "cpu").ipm, step_rule="probe")
    out = ipm.ipm_solve(ipm.build_ipm_data(densify(prob), "cpu"), *req,
                        settings=settings)
    assert int(out.status[0]) == OPTIMAL and int(out.iters) < 50


@pytest.mark.parametrize("rung", ["probe", "penalty"])
def test_rungs_agree_with_jax_where_it_converges(rung):
    """Each slot the JAX package solves the port solves too, to a bound
    within gaptol of JAX's; the JAX package never solves one the port
    does not."""
    port, jax_ = _solve_boxes(3, rung)
    conv = jax_["status"] == OPTIMAL
    assert (port["status"][conv] == OPTIMAL).all(), port["status"]
    gap = np.abs(port["dobj"] - jax_["dobj"]) / (1 + np.abs(jax_["dobj"]))
    assert (gap[conv] <= GAPTOL).all(), gap
