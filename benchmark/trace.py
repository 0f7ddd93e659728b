"""The traced span of a `--trace 1` run: torch.profiler over a few seconds of
the measured window, read from its kineto records directly.

Copied from the repository's chip check (`read_trace`, `profile_window`) and
frozen here: torch's own reading (`prof.events()`, a FunctionEvent a record)
costs ~60 us a record on the host, so the records are read from
`kineto_results`. The profiler on the card has been seen to lose a prefix of
a span's device records: a span opens with PAD_ROUNDS rounds of PAD_LAUNCHES
launches of torch's spin kernel on a stream of its own, each round
synchronized on that stream alone and followed by PAD_WAIT_S of host time,
and every time below leaves them out. There is one span a run: the window
cannot be run again, so `pad_kept` (the pad records the trace kept) is
reported instead of a retry.

`open_span` starts the profiler and returns once the span has run, with the
profiler still on; `close_span` stops it and reads the trace. The harness
closes the span only after the loop has stopped, so that the profiler is
never stopped, nor its records read, while the program's threads launch
work (a span stopped and read inside the window, or a second span, hung runs
on an H100; PERF.md, Open questions).
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

PAD_ROUNDS, PAD_LAUNCHES, PAD_WAIT_S = 10, 1000, 0.03
PAD_KERNEL = "spin_kernel"
SPAN = "benchmark_span"  # the host range that marks the traced span
# names torch's profiler drops from its events (torch.autograd.profiler_util._filter_name)
TRACE_DROPPED = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                 "profiler::_record_function_enter_new", "profiler::_record_function_exit",
                 "aten::is_leaf", "aten::output_nr", "aten::_version"}


def read_trace(prof, torch) -> dict:
    """{"device": [(name, start us, end us, card)] of kernels and copies (the
    card the record ran on, as the profiler numbers it), "host": [(start us,
    end us, name)] of host ops and CUDA runtime calls, "pad": records of the
    pad kernel}, times from the trace's start."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    names, device, host, pad = {}, [], [], 0
    for e in result.events():
        raw = e.name()
        if raw in TRACE_DROPPED:
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        start, end = (e.start_ns() - t0) / 1000, (e.end_ns() - t0) / 1000
        if e.device_type() == cuda:
            if PAD_KERNEL in name:
                pad += 1
            else:
                device.append((name, start, end, e.device_index()))
        elif e.device_type() == cpu:
            host.append((start, end, name))
    return dict(device=device, host=host, pad=pad)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def summarize(trace: dict, lo: float, hi: float, cards: int = 1, top: int = 10) -> dict:
    """Busy and idle time of the span [lo, hi] (us) on the run's `cards`
    cards: each card's union of its device records clipped to the span
    (`busy_s_by_card`, in the order of the cards' numbers; a card with no
    record reads 0) and their mean (`busy_s`), each kernel name's device time
    summed over the cards, and the longest gaps in which no card was busy,
    named by the host op that began latest before each gap closed (what the
    host was doing while the devices waited)."""
    dev = [(n, max(s, lo), min(e, hi), c) for n, s, e, c in trace["device"]
           if e > lo and s < hi]
    per_card: Dict[int, List[Tuple[float, float]]] = {}
    for _, s, e, c in dev:
        if e > s:  # on one card every record is that card's, whatever its number
            per_card.setdefault(c if cards > 1 else 0, []).append((s, e))
    by_card = [sum(e - s for s, e in union(per_card[c])) / 1e6 for c in sorted(per_card)]
    by_card += [0.0] * (cards - len(by_card))
    busy = union([(s, e) for _, s, e, _ in dev if e > s])
    by_name: Dict[str, float] = {}
    for n, s, e, _ in dev:
        by_name[n] = by_name.get(n, 0.0) + max(0.0, e - s) / 1e6
    gaps, prev = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host = sorted(h for h in trace["host"] if h[2] != SPAN)
    starts = [h[0] for h in host]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        i = bisect.bisect_right(starts, b) - 1
        label = host[i][2] if i >= 0 else "no host op recorded"
        named.append([f"host in {label}"[:120], (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=sum(by_card) / len(by_card), busy_s_by_card=by_card,
                window_s=(hi - lo) / 1e6, by_name=by_name,
                device_ops=[[n[:120], t] for n, t in ops], idle_gaps=named)


def warm_up(torch) -> None:
    """Start and stop the profiler once on a single kernel, with no other
    work running, so that CUPTI's and kineto's first-use set-up falls in the
    run's set-up and not in the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda._sleep(1)
        torch.cuda.synchronize()


def open_span(torch, seconds: float):
    """Start the profiler, run the pads, then mark `seconds` of whatever the
    process runs (its other threads' work included) as the span. Returns the
    profiler, still recording."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    pads = torch.cuda.Stream()
    for _ in range(PAD_ROUNDS):
        with torch.cuda.stream(pads):
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(1)
        pads.synchronize()
        time.sleep(PAD_WAIT_S)
    with record_function(SPAN):
        time.sleep(seconds)
    return prof


def close_span(prof, torch, cards: int = 1) -> Optional[dict]:
    """Stop the profiler and read its span over the run's `cards` cards:
    summarize()'s dict with "pad_kept", or None where the trace holds no span
    or no device time."""
    prof.stop()
    trace = read_trace(prof, torch)
    spans = [(s, e) for s, e, n in trace["host"] if n == SPAN]
    if not spans:
        return None
    res = summarize(trace, *spans[0], cards=cards)
    res["pad_kept"] = trace["pad"]
    return res if res["busy_s"] > 0 else None
