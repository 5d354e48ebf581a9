"""scipsdp_tpu_torch — the MISDP solver of ``scipsdp_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

Module names mirror the JAX package so each counterpart is easy to find:

* ``models``  — problem data model and the CLS/MkP/TT family generators
                (numpy only).
* ``ops``     — batched dense linear algebra (``eigen``), the batched
                interior-point relaxation solver (``ipm``), and the CUDA
                kernels beside their plain PyTorch versions (``kernels``,
                sources in ``csrc/``, built by ``_build`` at first use),
                and the one-variable SDP solver (``onevar``, numpy).
* ``core``    — the SDP interface over the batched solver: the recovery
                ladder (``sdpi``) and the batched feasibility check of
                candidate points (``feascheck``).
* ``utils``   — settings dataclasses and solve statuses.
* ``interop`` — builds the port's solver data and settings from the JAX
                package's arrays and dataclasses, so both solvers can be
                handed the same problem.

Importing the package loads nothing heavy, sets no global flag and never
imports JAX.
"""
