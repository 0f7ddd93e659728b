"""admit_ms_mean (program span): the mean `serve.admit` span, from the
batcher loop's pop to the segment dispatch that activates the request (its
prefill chunks in between), over the admissions that ended from the window's
start to the traced span's close."""
from benchmark import spans


def read(run):
    return spans.mean_ms(run, "serve.admit")
