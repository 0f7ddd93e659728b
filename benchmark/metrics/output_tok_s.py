"""output_tok_s (host clock): every output token delivered to the clients
inside the window, streamed frames counted as they arrive, over the window's
seconds."""
from benchmark import window


def read(run):
    return window.rate(run.records, run.t0, run.t1)
