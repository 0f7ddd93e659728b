"""sched_queue_ms_mean (program counter): the scheduler's queue_seconds over
its requests (Scheduler.snapshot_metrics), both differenced from the
window's start to the traced span's close."""


def read(run):
    n = run.c1["sched_requests"] - run.c0["sched_requests"]
    if n <= 0:
        return None
    return 1000.0 * (run.c1["queue_s"] - run.c0["queue_s"]) / n
