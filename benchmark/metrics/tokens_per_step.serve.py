"""tokens_per_step.serve (program counter): tokens delivered from the
window's start to the traced span's close, over the batched engine's steps
dispatched in that stretch (steps_dispatched): slot occupancy times
acceptance."""
from benchmark import window


def read(run):
    steps = run.c1["steps"] - run.c0["steps"]
    return window.tokens_in(run.records, run.t0, run.t1) / steps if steps > 0 else None
