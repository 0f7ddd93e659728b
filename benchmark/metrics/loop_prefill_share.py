"""loop_prefill_share (program span): the seconds the serving loop spent in
`serve.prefill_chunk` spans (launching an admission's prefill chunk), from
the window's start to the traced span's close, over those seconds, in %."""
from benchmark import spans


def read(run):
    return spans.share(run, "serve.prefill_chunk")
