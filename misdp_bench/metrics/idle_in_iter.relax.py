"""idle_in_iter.relax: device idle time that began inside an ``ipm.iter``
span, in % of the profiled span pass's wall (``spans.idle_by_span``): the
idle that a graph of the iteration could remove.  Nothing against a
program without the tracer."""


def read(rec):
    idle = rec.get("idle_by_span")
    if not idle or idle["window_s"] <= 0:
        return None
    return 100.0 * idle["labels"].get("ipm.iter", 0.0) / idle["window_s"]
