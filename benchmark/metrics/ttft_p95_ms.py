"""ttft_p95_ms (host clock): nearest-rank p95, over every request whose first
tokens arrived inside the window, of send to first tokens."""
from benchmark import window


def read(run):
    v = window.p95(window.ttfts(run.records, run.t0, run.t1))
    return None if v is None else 1000.0 * v
