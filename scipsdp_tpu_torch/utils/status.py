"""Solve-status lattice.

Reproduces the information content of the reference SDPI status queries
(`SCIPsdpiWasSolved` / `IsAcceptable` / `IsConverged` / primal-dual
feasibility lattice, reference src/sdpi/sdpi.c:3653-4110) as integer enums so
a *vector* of statuses can live on device for a batch of node relaxations.
"""

from __future__ import annotations

import enum


class SolverResultStatus(enum.IntEnum):
    """Per-relaxation outcome of the batched interior-point solve.

    This is the per-instance status the branch-and-bound layer branches on,
    mirroring the outcome classes of ``calcRelax``
    (reference src/scipsdp/relax_sdp.c:4205-4346).
    """

    UNSOLVED = 0          # not attempted / masked-out batch slot
    OPTIMAL = 1           # converged: dual bound + solution valid
    INFEASIBLE = 2        # node relaxation infeasible -> cutoff
    UNBOUNDED = 3         # dual unbounded (objective -> -inf)
    BOUND_ONLY = 4        # not converged, but penalty solve gave a valid lower bound
    FAILED = 5            # no usable information (reference: "unsolved" stat)

    # statuses settled by presolve before the IPM ever runs
    # (reference src/sdpi/sdpi.c:3190-3381)
    PRESOLVED_INFEASIBLE = 6   # bound conflict / fixed point infeasible
    PRESOLVED_OPTIMAL = 7      # all variables fixed & feasible

    # per-solve limit statuses (SCIPsdpiIsIterlimExc / IsTimelimExc,
    # reference src/sdpi/sdpi.c:3653-4110): not usable, but the recovery
    # ladder and the statistics distinguish them from numerical failure
    ITERLIMIT = 8              # IPM hit max_iters without converging
    TIMELIMIT = 9              # per-solve wall-clock budget exhausted


class SolveStatus(enum.IntEnum):
    """Overall MISDP solve status (analog of SCIP's SCIP_STATUS)."""

    UNKNOWN = 0
    OPTIMAL = 1
    INFEASIBLE = 2
    UNBOUNDED = 3
    NODE_LIMIT = 4
    TIME_LIMIT = 5
    GAP_LIMIT = 6


def is_acceptable(status: int) -> bool:
    """Analog of SCIPsdpiIsAcceptable: result is usable for B&B decisions."""
    return status in (
        SolverResultStatus.OPTIMAL,
        SolverResultStatus.INFEASIBLE,
        SolverResultStatus.UNBOUNDED,
        SolverResultStatus.BOUND_ONLY,
        SolverResultStatus.PRESOLVED_INFEASIBLE,
        SolverResultStatus.PRESOLVED_OPTIMAL,
    )


def is_unsolved(status: int) -> bool:
    """No usable bound came out of the solve (ladder keeps escalating)."""
    return status in (
        SolverResultStatus.FAILED,
        SolverResultStatus.ITERLIMIT,
        SolverResultStatus.TIMELIMIT,
        SolverResultStatus.UNSOLVED,
    )


def is_iterlim_exc(status: int) -> bool:
    """Analog of SCIPsdpiIsIterlimExc."""
    return status == SolverResultStatus.ITERLIMIT


def is_timelim_exc(status: int) -> bool:
    """Analog of SCIPsdpiIsTimelimExc."""
    return status == SolverResultStatus.TIMELIMIT
