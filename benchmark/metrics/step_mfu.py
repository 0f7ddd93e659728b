"""step_mfu (host clock and counted work): the model operations that the
forwards from the window's start to the traced span's close needed
(roofline.window_work: target verify, draft levels, prefills, attention over
the live cache) over those seconds times the card's bf16 peak."""
from benchmark.roofline import PEAK, window_work


def read(run):
    return 100.0 * window_work(run)["flops"] / (run.seconds * PEAK["bf16"])
