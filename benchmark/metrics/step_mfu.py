"""step_mfu (host clock and counted work): the model operations that the
forwards from the window's start to the traced span's close needed
(roofline.window_work: target verify, draft levels, prefills, attention over
the live cache) over those seconds times the bf16 peak of the run's cards
(one card's peak times their number)."""
from benchmark.roofline import PEAK, window_work


def read(run):
    return 100.0 * window_work(run)["flops"] / (run.seconds * run.chips * PEAK["bf16"])
