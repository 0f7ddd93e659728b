"""setup_s (host clock): process start to the load's start: building the
weights on the card, the engine, the nvcc build on a checkout's first run,
and the warm-up of the cell's own shapes and graphs."""


def read(run):
    return run.setup_s
