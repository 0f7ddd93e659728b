"""accept_per_step.chat (program counter): tokens committed from the window's
start to the traced span's close, over the target's verify steps in that
stretch (the engine's live replays: decode_stats replays less no-op
replays), both read at the stream's frames."""
from benchmark import window


def read(run):
    steps = run.c1["steps"] - run.c0["steps"]
    return window.tokens_in(run.records, run.t0, run.t1) / steps if steps > 0 else None
