"""solve_setup_ms.relax: a request's set-up in the span pass (its inputs
on the device, presolve, the start point and its evaluation: the
``ipm.setup`` spans), in ms a solve.  Nothing against a program without
the tracer."""

from misdp_bench import spans


def read(rec):
    if "spans" not in rec:
        return None
    n = spans.count(rec["spans"], "ipm.solve")
    return spans.total_ns(rec["spans"], "ipm.setup") * 1e-6 / n if n else None
