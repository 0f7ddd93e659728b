#!/usr/bin/env python3
"""Where the card waits, put down to what the serving thread was doing.

    python3 scripts/idle_by_span.py --workload mistral7b_awq.serve32 --seed 7 \
        [--seconds 3] [--lead 15]

Builds one benchmark cell as the benchmark builds it (`benchmark/` imported
unchanged: the configuration from the seed, the engine, the warm-up of its
shapes), runs the cell's closed loop for the mix's ramp plus `--lead`
seconds, then traces `--seconds` of it under torch.profiler with every
thread's host ranges (`profile_all_threads`, where this torch has it). The
program's spans (umbrella_tpu_torch/profiling.py) are read from the trace's
host ranges, and from the span ring for those that began before the
profiler did (the ring's Unix time is the clock of the trace's records; the
JSON gives how far the two readings of one span lie apart). Each stretch of
the traced seconds with no kernel or copy on the card is put down to the
innermost span open when it began ("no span" where none was).

Prints one line a span name (idle seconds, share of the traced seconds,
share of the idle), then one JSON line with those, each span's own seconds
in the traced seconds, whether each `serve.dispatch` began before the first
kernel it launched, and the card's name and power limit. The profiler slows
the loop it traces (every host op of every thread is recorded): read
shares, not times.
"""
import argparse
import bisect
import json
import os
import re
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARK = "idle_by_span"  # the host range of the traced seconds
TIMED = ("serve.dispatch", "serve.sync", "serve.harvest", "serve.stage", "serve.idle",
         "serve.prefill_chunk", "engine.prefill")  # spans timed on one thread


def build_loop(c: dict, seed: int, device):
    """The cell's loop as benchmark/harness.run_cell builds it, warmed up."""
    from benchmark import drive, harness, spec
    from benchmark.traffic import Traffic

    cfg, mix = c["config"], c["mix"]
    keys = mix["engine"]
    built = spec.builder(cfg).build(cfg, seed, device, keys["max_length"])
    growmap, _levels, _size = harness._tree(keys["growmap"])
    eng = drive.make_engine(built, dict(keys, seed=int(seed) % 2 ** 63), growmap)
    loop = drive.LOOPS[mix["loop"]](eng, Traffic(mix, seed, built.vocab), mix)
    loop.warm(seed, built.vocab)
    return loop


def start_profiler(torch, cuda: bool):
    """torch.profiler over every thread where it can; on the card the pads of
    benchmark/trace.py first (the profiler may lose a prefix of a span's
    device records). Returns (profiler, whether it records every thread)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import PAD_LAUNCHES, PAD_ROUNDS, PAD_WAIT_S

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = profile(activities=acts, **kw)
    prof.start()
    if cuda:
        pads = torch.cuda.Stream()
        for _ in range(PAD_ROUNDS):
            with torch.cuda.stream(pads):
                for _ in range(PAD_LAUNCHES):
                    torch.cuda._sleep(1)
            pads.synchronize()
            time.sleep(PAD_WAIT_S)
    return prof, bool(kw)


RUNTIME = re.compile(r"cu[A-Z]|cuda[A-Z]|Activity Buffer|Buffer Flush")


def links(e) -> bool:
    """Whether device records may link to this host event: host ops and
    ranges, not CUDA runtime calls or the profiler's own, whose ids the
    tracer numbers apart (the same number can name both)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in ("cpu_op", "user_annotation")
    return not RUNTIME.match(e.name())


def read_events(prof, torch) -> dict:
    """The trace's records, times in us from its start: device records
    (start, end, linked host correlation id), the program's span ranges and
    the mark (name, start, end), and host events by correlation id."""
    from benchmark.trace import PAD_KERNEL

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    device, ranges, mark, host_by_corr = [], [], None, {}
    for e in result.events():
        name = e.name()
        start, end = (e.start_ns() - t0) / 1000, (e.end_ns() - t0) / 1000
        if e.device_type() == cuda:
            if PAD_KERNEL not in name:
                device.append((start, end, e.linked_correlation_id()))
        elif e.device_type() == cpu:
            if name in TIMED:
                ranges.append((name, start, end))
            elif name == MARK:
                mark = (start, end)
            if links(e):
                host_by_corr[e.correlation_id()] = start
    return dict(t0_ns=t0, device=device, ranges=ranges, mark=mark, host_by_corr=host_by_corr)


def merge(ranges, ring, within_us: float = 1000.0):
    """The profiler's ranges, plus the ring's spans that none of them is (a
    span that began before the profiler started has no range); and, for the
    spans read both ways, how far apart the two starts lie (us)."""
    by_name = {}
    for name, s, _e in ranges:
        by_name.setdefault(name, []).append(s)
    for starts in by_name.values():
        starts.sort()
    merged, apart = list(ranges), []
    for name, s, e in ring:
        starts = by_name.get(name, [])
        i = bisect.bisect_left(starts, s)
        near = min((abs(starts[j] - s) for j in (i - 1, i) if 0 <= j < len(starts)),
                   default=None)
        if near is not None and near <= within_us:
            apart.append(near)
        else:
            merged.append((name, s, e))
    return merged, apart


def busy_union(device, lo, hi):
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e, _c in device if e > lo and s < hi):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_by_span(spans, busy, lo, hi) -> dict:
    """Idle seconds of [lo, hi] (us) by the innermost span open where each
    idle stretch began: {name: [stretches, seconds]}."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out, prev = {}, lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            i = bisect.bisect_right(starts, prev)
            # the span open at `prev` that began last is the innermost
            inner = next((sp[0] for sp in reversed(spans[max(0, i - 64):i]) if sp[2] > prev),
                         "no span")
            row = out.setdefault(inner, [0, 0.0])
            row[0] += 1
            row[1] += (s - prev) / 1e6
        prev = max(prev, e)
    return out


def seconds_in(spans, lo, hi) -> dict:
    out = {}
    for name, s, e in spans:
        if e > lo and s < hi:
            out[name] = out.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
    return out


def dispatch_leads(ranges, device, host_by_corr) -> dict:
    """For each serve.dispatch range, the first kernel it launched (a device
    record whose launching host event lies inside the range) less the
    range's start: all >= 0 where host ranges and device records share a
    clock."""
    disp = sorted((s, e) for n, s, e in ranges if n == "serve.dispatch")
    starts = [s for s, _e in disp]
    first = {}
    for s, _e, corr in device:
        h = host_by_corr.get(corr)
        if h is None:
            continue
        i = bisect.bisect_right(starts, h) - 1
        if i >= 0 and h <= disp[i][1]:
            first[i] = min(first.get(i, s), s)
    leads = [first[i] - disp[i][0] for i in sorted(first)]
    return dict(dispatches=len(disp), with_kernels=len(leads),
                before_first_kernel=sum(x >= 0 for x in leads),
                lead_us_min=min(leads) if leads else None,
                lead_us_median=statistics.median(leads) if leads else None)


def measure(c: dict, seed: int, seconds: float, lead: float, device) -> dict:
    import torch

    from umbrella_tpu_torch import profiling

    cuda = device.type == "cuda"
    loop = build_loop(c, seed, device)
    if cuda:
        from benchmark.trace import warm_up

        warm_up(torch)
        torch.cuda.synchronize(device)
    loop.start()
    time.sleep(float(c["mix"]["ramp_seconds"]) + lead)
    prof, all_threads = start_profiler(torch, cuda)
    from torch.profiler import record_function

    with record_function(MARK):
        time.sleep(seconds)
    # the profiler stops once the loop has stopped, as benchmark/trace.py's
    loop.stop(float(c["mix"]["drain_seconds"]))
    prof.stop()
    ev = read_events(prof, torch)
    lo, hi = ev["mark"]
    ranges = [r for r in ev["ranges"] if r[2] > lo and r[1] < hi]
    found, _dropped = profiling.spans(*((ev["t0_ns"] + x * 1000) / 1e9 for x in (lo, hi)))
    ring = [(s.name, (s.start * 1e9 - ev["t0_ns"]) / 1000, (s.end * 1e9 - ev["t0_ns"]) / 1000)
            for s in found if s.name in TIMED]
    spans, apart = merge(ranges, ring)
    busy = busy_union(ev["device"], lo, hi)
    window_s = (hi - lo) / 1e6
    busy_s = sum(e - s for s, e in busy) / 1e6
    table = idle_by_span(spans, busy, lo, hi)
    res = dict(workload=c["workload"]["name"], seed=seed, window_s=window_s, busy_s=busy_s,
               idle_s=window_s - busy_s, all_threads=all_threads,
               spans_from=dict(profiler=len(ranges), ring_only=len(spans) - len(ranges)),
               ring_vs_profiler_us=dict(spans=len(apart),
                                        max=max(apart) if apart else None,
                                        median=statistics.median(apart) if apart else None),
               idle_by_span={k: dict(stretches=n, seconds=t, share_of_window=t / window_s,
                                     share_of_idle=t / max(window_s - busy_s, 1e-12))
                             for k, (n, t) in sorted(table.items(), key=lambda kv: -kv[1][1])},
               span_seconds=seconds_in(spans, lo, hi),
               dispatch=dispatch_leads(ranges, ev["device"], ev["host_by_corr"]))
    if cuda:
        from benchmark.harness import power_limit

        res["device"] = power_limit()
    return res


def main(argv=None) -> int:
    import torch

    from benchmark import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--lead", type=float, default=15.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("idle_by_span needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = measure(spec.cell(args.workload), args.seed, args.seconds, args.lead, device)
    print(f"{res['workload']}: {res['window_s']:.3f} s traced, {res['idle_s']:.3f} s idle "
          f"({res.get('device', '')})")
    for name, row in res["idle_by_span"].items():
        print(f"  {name:22s} {row['stretches']:6d} stretches {row['seconds']:8.4f} s "
              f"{100 * row['share_of_window']:6.2f}% of window "
              f"{100 * row['share_of_idle']:6.2f}% of idle")
    print(json.dumps(res))
    sys.stdout.flush()
    os._exit(0)  # torch's shutdown can stall with the loop's threads gone


if __name__ == "__main__":
    sys.exit(main())
