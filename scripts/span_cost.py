#!/usr/bin/env python3
"""Host cost of the program's spans (umbrella_tpu_torch/profiling.py).

    python3 scripts/span_cost.py [--n 200000]

Times `n` empty `profiling.span` blocks and `n` `profiling.record` calls
with no profiler recording; then, under torch.profiler, `n / 10` spans on
the thread that started it (its ranges recorded) and `n / 10` on another
thread (the flag is set process-wide, so each span opens a range there too,
which that profiler does not record). Prints one JSON line: microseconds a
span each way, a bare loop's microseconds, and where a card is there its
name and power limit.
"""
import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def per_call_us(fn, n: int) -> float:
    t = time.perf_counter()
    fn(n)
    return 1e6 * (time.perf_counter() - t) / n


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from umbrella_tpu_torch import profiling

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=200000)
    n = p.parse_args(argv).n

    def bare(k):
        for _ in range(k):
            pass

    def spans(k):
        for _ in range(k):
            with profiling.span("cost.span"):
                pass

    def records(k):
        now = time.time()
        for _ in range(k):
            profiling.record("cost.record", now, now)

    def elsewhere(k, out):
        out.append(per_call_us(spans, k))

    res = dict(n=n, bare_loop_us=per_call_us(bare, n), span_us=per_call_us(spans, n),
               record_us=per_call_us(records, n))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        res["span_profiled_us"] = per_call_us(spans, n // 10)
        out = []
        t = threading.Thread(target=elsewhere, args=(n // 10, out))
        t.start()
        t.join()
        res["span_profiler_on_other_thread_us"] = out[0]
    if torch.cuda.is_available():
        from benchmark.harness import power_limit

        res["device"] = power_limit()
    print(json.dumps(res))
    sys.stdout.flush()
    os._exit(0)  # torch's shutdown can stall after the profiler


if __name__ == "__main__":
    sys.exit(main())
