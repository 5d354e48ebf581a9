"""host_syncs_per_solve.relax: host syncs made by the program (CUDA sync
debug mode, by Python line) over the solves run in that mode."""


def read(rec):
    if "syncs" not in rec or "solves" not in rec:
        return None
    return rec["syncs"] / rec["sync_solves"]
