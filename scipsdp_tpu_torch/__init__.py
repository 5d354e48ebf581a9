"""scipsdp_tpu_torch — the MISDP solver of ``scipsdp_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

Module names mirror the JAX package so each counterpart is easy to find:

* ``models``  — problem data model, the CLS/MkP/TT family generators, the
                SDPA (.dat-s), CBF and CIP readers (``io.read_problem``)
                and writers (numpy only).
* ``ops``     — batched dense linear algebra (``eigen``), the batched
                interior-point relaxation solver (``ipm``), and the CUDA
                kernels beside their plain PyTorch versions (``kernels``,
                sources in ``csrc/``, built by ``_build`` at first use),
                the eigenvector cuts of LP mode (``cuts``) and the
                one-variable SDP solver (``onevar``, numpy).
* ``core``    — the SDP interface over the batched solver: the recovery
                ladder (``sdpi``) and the batched feasibility check of
                candidate points (``feascheck``); the branch-and-bound
                (``branchbound.solve_misdp``, the device-resident tree
                ``turbo``, ``probing``, presolve and propagation).
* ``native``  — the SDPA tokenizer and the B&B node store in C++, built
                with g++ at first use.
* ``utils``   — settings dataclasses, SCIP-style ``.set`` files
                (``paramfile``), solve statuses and the statistics table.
* ``interop`` — builds the port's solver data and settings from the JAX
                package's arrays and dataclasses, so both solvers can be
                handed the same problem.

``python -m scipsdp_tpu_torch INSTANCE`` solves a problem file on the CUDA
card (``--cpu`` on the CPU).  The public names below are loaded on first
use: importing the package loads nothing heavy, sets no global flag and
never imports JAX.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "Settings": "scipsdp_tpu_torch.utils.config",
    "default_settings": "scipsdp_tpu_torch.utils.config",
    "SolveStatus": "scipsdp_tpu_torch.utils.status",
    "SolverResultStatus": "scipsdp_tpu_torch.utils.status",
    "MISDP": "scipsdp_tpu_torch.models.problem",
    "SDPBlock": "scipsdp_tpu_torch.models.problem",
    "LinearConstraints": "scipsdp_tpu_torch.models.problem",
    "read_problem": "scipsdp_tpu_torch.models.io",
    "solve_misdp": "scipsdp_tpu_torch.core.branchbound",
    "BBResult": "scipsdp_tpu_torch.core.branchbound",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
