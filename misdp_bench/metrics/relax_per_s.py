"""relax_per_s: node relaxations solved (OPTIMAL) per second of the
window, over every batched solve the window held."""


def read(rec):
    if "solves" not in rec:
        return None
    return sum(s["solved"] for s in rec["solves"]) / rec["window_s"]
