"""tpot_p95_ms (host clock): nearest-rank p95, over every request completed
inside the window, of (completion - first tokens) / (tokens - 1)."""
from benchmark import window


def read(run):
    v = window.p95(window.tpots(run.records, run.t0, run.t1))
    return None if v is None else 1000.0 * v
