"""loop_sync_share (program span): the seconds the serving loop spent in
`serve.sync` spans (waiting for a queued segment's results), from the
window's start to the traced span's close, over those seconds, in %: high
where the loop waits on the card, low where the card waits on the loop."""
from benchmark import spans


def read(run):
    return spans.share(run, "serve.sync")
