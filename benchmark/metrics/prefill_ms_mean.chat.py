"""prefill_ms_mean.chat (program span): the mean `engine.prefill` span, from
a request's start in the single-request engine to the device sync after its
prefill, over the prefills that ended from the window's start to the traced
span's close."""
from benchmark import spans


def read(run):
    return spans.mean_ms(run, "engine.prefill")
