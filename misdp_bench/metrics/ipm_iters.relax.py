"""ipm_iters.relax: IPM iterations a batched solve (SolveOutput.iters),
mean over the run's solves."""


def read(rec):
    if not rec.get("solves"):
        return None
    return sum(s["iters"] for s in rec["solves"]) / len(rec["solves"])
