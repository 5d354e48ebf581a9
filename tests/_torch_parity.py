"""Shared helpers of the ``test_torch_*`` parity tests.

The same problem, made from a numpy seed, goes through the JAX package and
through the PyTorch port (both on the CPU), with settings pinned
explicitly on both sides: "auto" would resolve differently per backend.
Data crosses between the two frameworks only as numpy arrays.
"""

import dataclasses
import functools

import jax
import numpy as np
import torch

from scipsdp_tpu.core.sdpi import SDPInterface as JaxSDPInterface
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models.problem import densify as jdensify
from scipsdp_tpu.ops import ipm as jipm
from scipsdp_tpu.utils.config import IPMSettings as JaxIPMSettings
from scipsdp_tpu_torch.core.sdpi import SDPInterface as TorchSDPInterface
from scipsdp_tpu_torch.interop import ipm_data_from_numpy, settings_from_jax
from scipsdp_tpu_torch.models.problem import DenseSDPData as TorchDense
from scipsdp_tpu_torch.ops import ipm as tipm
from scipsdp_tpu_torch.utils.config import IPMSettings as TorchIPMSettings

# float32 matmuls in full precision wherever a card is present (the
# default, stated here); the probe trials are this path's one f32 stage
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

INSTANCES = {
    "cls": lambda: jfam.cardinality_least_squares(6, 12, 3, seed=1),
    "tt": lambda: jfam.truss_topology(6, 2, seed=0),
    "mkp": lambda: jfam.min_k_partition(6, 3, 0.6, seed=1),
    # MkP for the refine tier (tests/test_torch_ipm_refine.py says why)
    "mkp_s12": lambda: jfam.min_k_partition(6, 3, 0.6, seed=12),
    "cls_4x8": lambda: jfam.cardinality_least_squares(4, 8, 2, seed=2),
    "cls_32": lambda: jfam.cardinality_least_squares(32, 64, 8, seed=5),
}


def pinned(step_rule: str, **kw) -> dict:
    """The f64 configuration of this slice, with no "auto" left."""
    return dict(phase32="off", step_rule=step_rule, use_lanes_chol=False,
                use_df32="off", fused_direction="off", **kw)


@functools.lru_cache(maxsize=None)
def problem(name: str):
    """(MISDP, JAX IPMData, port IPMData) for a named instance."""
    prob = INSTANCES[name]()
    jdata = jipm.build_ipm_data(jdensify(prob))
    return prob, jdata, port_data(jdata)


def port_data(jdata):
    """The port's IPMData from the JAX IPMData's arrays."""
    return ipm_data_from_numpy(
        [np.asarray(a) for a in jdata.A], [np.asarray(c) for c in jdata.C],
        [np.asarray(d) for d in jdata.dimmask], np.asarray(jdata.G),
        np.asarray(jdata.h), np.asarray(jdata.b_base), jdata.nvars,
        jdata.ndim_sdp, jdata.block_of, device="cpu")


def port_dense(jdense):
    """The port's DenseSDPData with the JAX one's arrays."""
    return TorchDense(**{f.name: getattr(jdense, f.name)
                         for f in dataclasses.fields(jdense)})


def interfaces(jdense, settings, **kw):
    """(JAX SDPInterface, the port's on the CPU) for one DenseSDPData,
    with the same settings (a JAX ``Settings``)."""
    return (JaxSDPInterface(jdense, settings, **kw),
            TorchSDPInterface(port_dense(jdense), settings_from_jax(settings),
                              device="cpu", **kw))


def node_boxes(prob, B: int, seed: int = 0, mode: str = "direct",
               gamma: float = 1e3):
    """(b, lb, ub) of B node boxes with the penalty column: slot 0 is the
    root; slots 1.. tighten 1-3 integral variables to an integer inside
    their box (a branching-down or -up child).  ``mode`` is "direct",
    "probe" (Gamma = 1 feasibility probe) or "penalty" (Gamma = gamma)."""
    rng = np.random.default_rng(seed)
    lb = np.tile(prob.lb, (B, 1))
    ub = np.tile(prob.ub, (B, 1))
    ints = np.flatnonzero(prob.integral)
    for s in range(1, B):
        for j in rng.choice(ints, size=min(len(ints), int(rng.integers(1, 4))),
                            replace=False):
            v = float(rng.integers(int(prob.lb[j]), int(prob.ub[j]) + 1))
            if rng.random() < 0.5:
                ub[s, j] = v
            else:
                lb[s, j] = v
    b = np.concatenate([np.tile(prob.obj, (B, 1)), np.zeros((B, 1))], 1)
    lbp = np.concatenate([lb, np.zeros((B, 1))], 1)
    ubp = np.concatenate([ub, np.zeros((B, 1))], 1)
    if mode != "direct":
        ubp[:, -1] = 1e20
    if mode == "probe":
        b[:, :-1] = 0.0
        b[:, -1] = 1.0
    elif mode == "penalty":
        b[:, -1] = gamma
    return b, lbp, ubp


@functools.lru_cache(maxsize=None)
def _jax_fn(settings_items):
    settings = JaxIPMSettings(**dict(settings_items))
    return jax.jit(functools.partial(jipm.ipm_solve, settings=settings))


def jax_solve(jdata, b, lb, ub, settings_kw: dict, **extra):
    """JAX ipm_solve (jitted) with pinned settings; outputs as numpy."""
    fn = _jax_fn(tuple(sorted(settings_kw.items())))
    out = fn(jdata, b, lb, ub, **extra)
    return jax.tree_util.tree_map(np.asarray, out._asdict())


def torch_solve(tdata, b, lb, ub, settings_kw: dict, **extra):
    """The port's ipm_solve with the same settings; outputs as numpy."""
    out = tipm.ipm_solve(tdata, b, lb, ub,
                         settings=TorchIPMSettings(**settings_kw), **extra)
    res = out._asdict()
    res["X"] = tuple(x.numpy() for x in out.X)
    for k, v in res.items():
        if isinstance(v, torch.Tensor):
            res[k] = v.numpy()
    return res


def assert_close_scaled(a, b, rtol: float, atol_rel: float, what: str):
    """|a - b| <= rtol*|b| + atol_rel*(1 + max|b|)."""
    a, b = np.asarray(a), np.asarray(b)
    atol = atol_rel * (1.0 + (np.max(np.abs(b)) if b.size else 0.0))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)
