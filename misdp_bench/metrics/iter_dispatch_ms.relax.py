"""iter_dispatch_ms.relax: the host issuing one IPM iteration in the span
pass: the mean self time of the ``ipm.iter`` spans (less the syncs inside
them), in ms.  Nothing against a program without the tracer."""

from misdp_bench import spans


def read(rec):
    if "spans" not in rec:
        return None
    own = spans.self_ns(rec["spans"])
    its = [own[s["id"]] for s in rec["spans"] if s["name"] == "ipm.iter"]
    return sum(its) * 1e-6 / len(its) if its else None
