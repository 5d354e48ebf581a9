"""chol_lanes_roofline.relax: the probe Cholesky (#1, ops/kernels.py::
cholesky_lanes) in the profiled solves, as a share of its memory roofline:
the least bytes of its calls (profiling.chol_lanes_bytes) over the H100's
published 3.35 TB/s, divided by its kernels' device time, in %.  Nothing
where the trace holds no such kernel or not one per call."""

from misdp_bench.profiling import PEAK_BYTES


def read(rec):
    prof = rec.get("profile")
    if "solves" not in rec or not prof or not rec.get("chol_calls"):
        return None
    if prof["chol_kernels"] != rec["chol_calls"] or prof["chol_kernel_s"] <= 0:
        return None
    return 100.0 * rec["chol_bytes"] / PEAK_BYTES / prof["chol_kernel_s"]
