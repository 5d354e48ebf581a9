"""program_syncs_per_solve.relax: host syncs the program counts itself
(``utils/trace.py::sync``, by site) in the span pass, over its
``ipm.solve`` spans: the inside twin of host_syncs_per_solve.relax.
Nothing against a program without the tracer."""

from misdp_bench import spans


def read(rec):
    if "spans" not in rec:
        return None
    n = spans.count(rec["spans"], "ipm.solve")
    return sum(rec["syncs_by_site"].values()) / n if n else None
