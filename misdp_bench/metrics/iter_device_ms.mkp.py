"""iter_device_ms.mkp: the device's busy time per IPM iteration in the span
passes, in ms: the profiled span pass's busy seconds
(``spans.idle_by_span``) over the ``ipm.iter`` spans of a span pass (both
whole passes of the same calls).  Nothing against a program without the
tracer."""

from misdp_bench import spans


def read(rec):
    idle = rec.get("idle_by_span")
    if "spans" not in rec or not idle:
        return None
    n = spans.count(rec["spans"], "ipm.iter")
    return 1e3 * idle["busy_s"] / n if n else None
