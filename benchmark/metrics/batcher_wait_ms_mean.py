"""batcher_wait_ms_mean (program span): the mean `serve.queue` span, from a
request's submit (the scheduler's, where one is in front) to the batcher
loop's pop, over the requests whose wait ended from the window's start to
the traced span's close."""
from benchmark import spans


def read(run):
    return spans.mean_ms(run, "serve.queue")
