"""Parameter bridge between the JAX package and the port.

The JAX package's ``IPMData`` holds the same per-bucket arrays as the
port's; :func:`ipm_data_from_numpy` takes them as numpy arrays (for example
``np.asarray`` of each JAX array) and returns the port's ``IPMData`` on a
torch device, so both solvers can be given exactly the same problem.
:func:`settings_from_jax` does the same for a settings dataclass, and
:func:`problem_from_jax` for a problem (``MISDP``), so a B&B solve or a
checkpoint can be carried across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scipsdp_tpu_torch.models import problem as problem_model
from scipsdp_tpu_torch.ops.ipm import IPMData
from scipsdp_tpu_torch.utils import config


def ipm_data_from_numpy(A, C, dimmask, G, h, b_base, nvars, ndim_sdp,
                        block_of, *, device) -> IPMData:
    """``A``/``C``/``dimmask`` are per-bucket sequences of (K_t, mp, n_t,
    n_t) / (K_t, n_t, n_t) / (K_t, n_t) arrays; ``G`` (p, mp), ``h`` (p,)
    and ``b_base`` (mp,).  Values become float64 tensors on ``device``."""

    def f64(x):
        return torch.as_tensor(np.array(x, dtype=np.float64),
                               dtype=torch.float64, device=device)

    return IPMData(
        A=tuple(f64(a) for a in A),
        C=tuple(f64(c) for c in C),
        dimmask=tuple(torch.as_tensor(np.array(d, dtype=bool),
                                      device=device) for d in dimmask),
        G=f64(G),
        h=f64(h),
        b_base=f64(b_base),
        nvars=int(nvars),
        ndim_sdp=int(ndim_sdp),
        block_of=tuple((int(t), int(k)) for t, k in block_of),
    )


def settings_from_jax(jsettings):
    """The port's settings dataclass of the same name as ``jsettings`` (a
    JAX package ``Settings``, ``IPMSettings``, ``BBSettings``, ...), every
    field copied; nested settings dataclasses are converted too.  Reads
    only the fields, so it needs no import of the JAX package."""
    cls = getattr(config, type(jsettings).__name__)
    vals = {}
    for f in dataclasses.fields(jsettings):
        v = getattr(jsettings, f.name)
        vals[f.name] = (settings_from_jax(v) if dataclasses.is_dataclass(v)
                        else v)
    return cls(**vals)


def _carry(value):
    """``value`` rebuilt from the port's problem model: a dataclass becomes
    the port's class of the same name (fields read by attribute, each
    carried in turn), numpy arrays are copied, lists and tuples are
    carried item by item, and anything else is kept."""
    if dataclasses.is_dataclass(value):
        cls = getattr(problem_model, type(value).__name__)
        return cls(**{f.name: _carry(getattr(value, f.name))
                      for f in dataclasses.fields(value)})
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, (list, tuple)):
        return type(value)(_carry(v) for v in value)
    return value


def problem_from_jax(jprob) -> problem_model.MISDP:
    """The port's ``MISDP`` with every field of ``jprob`` (a JAX package
    ``MISDP``): its blocks, LP and propagation rows, indicators, quadratic
    constraints, lift and postsolve records, copied as numpy, so the port
    may change its own problem without touching ``jprob``.  Reads only the
    fields, so it needs no import of the JAX package."""
    return _carry(jprob)
