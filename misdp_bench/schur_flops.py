"""The least float64 work of the batched solve's Newton systems, counted
from the program's spans (``spans.span_passes``).

Every IPM iteration solves, for each of its B instances, one symmetric
positive definite Schur system of order mp (the variables and the penalty
variable).  A direct solve of such a system needs at least its Cholesky
factorisation, counted as mp^3 / 3 floating-point operations, however the
program implements it.  B and mp come from each request's ``ipm.setup``
span; the iterations are its ``ipm.iter`` spans.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: FP64 tensor-core peak at the 700 W limit
PEAK_F64_FLOPS = 67e12


def chol_flops(B: int, mp: int) -> float:
    """B Cholesky factorisations of order mp."""
    return B * mp ** 3 / 3.0


def iteration_flops(spans: list):
    """Summed ``chol_flops`` over the ``ipm.iter`` spans of ``spans`` (dicts
    as ``spans.span_records`` gives them), each with the B and mp of its
    request's ``ipm.setup`` span; None where a request's set-up span lacks
    them (a program whose spans do not carry ``mp``)."""
    setups = {s["solve"]: s["attrs"] for s in spans if s["name"] == "ipm.setup"}
    total = 0.0
    for s in spans:
        if s["name"] != "ipm.iter":
            continue
        attrs = setups.get(s["solve"], {})
        if "B" not in attrs or "mp" not in attrs:
            return None
        total += chol_flops(int(attrs["B"]), int(attrs["mp"]))
    return total
