"""step_ms (program counter over the host clock): the seconds over the decode
steps (steps_dispatched, or the static engine's live replays) from the
window's start to the traced span's close, each end where the loop's
counters were read."""


def read(run):
    steps = run.c1["steps"] - run.c0["steps"]
    return 1000.0 * run.seconds / steps if steps > 0 else None
