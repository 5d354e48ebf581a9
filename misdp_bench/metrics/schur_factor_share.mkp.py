"""schur_factor_share.mkp: the least float64 work of the span pass's Newton
systems (``schur_flops.iteration_flops``: B mp^3 / 3 an iteration) over
the profiled span pass's busy seconds, as a share of the H100's float64
peak, in %.  Nothing against a program whose spans do not carry the Schur
size."""

from misdp_bench.schur_flops import PEAK_F64_FLOPS, iteration_flops


def read(rec):
    idle = rec.get("idle_by_span")
    if "spans" not in rec or not idle or idle["busy_s"] <= 0:
        return None
    flops = iteration_flops(rec["spans"])
    if not flops:
        return None
    return 100.0 * flops / (idle["busy_s"] * PEAK_F64_FLOPS)
