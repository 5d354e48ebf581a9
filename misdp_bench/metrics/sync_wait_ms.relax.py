"""sync_wait_ms.relax: the host blocked on the device in the span pass,
in ms a solve: the summed ``ipm.sync`` spans over the ``ipm.solve``
spans.  Nothing against a program without the tracer."""

from misdp_bench import spans


def read(rec):
    if "spans" not in rec:
        return None
    n = spans.count(rec["spans"], "ipm.solve")
    return spans.total_ns(rec["spans"], "ipm.sync") * 1e-6 / n if n else None
