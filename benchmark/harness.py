"""One run of one cell: build the configuration on the cell's cards from the
seed, warm up the cell's own shapes (set-up), drive the mix's closed loop for
the window, read the metrics, free the program, check the served tokens
against the reference, and return the result's fields. A cell of `chips` N
runs on cuda:0 .. cuda:N-1 (the run's card and the next ones)."""
from __future__ import annotations

import faulthandler
import gc
import json
import os
import subprocess
import sys
import time
import types

from benchmark import check, drive, spec, window
from benchmark.traffic import Traffic

# a traced span's pads start this long, plus the span's own seconds, before
# the window closes: the span ends about a second and a half before it, or
# later where the pads queue behind the program's kernels
SPAN_LEAD_S = 2.0
# a run that has not printed its result this long after its load began (past
# the window, the ramp and the drain) dumps every thread's stack and exits 1
STALL_S = 150.0
FORBIDDEN = {"jax", "jaxlib", "flax", "umbrella_tpu"}  # whole top-level module names
PORT = "umbrella_tpu_torch"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _tree(name: str) -> tuple:
    """(path, level widths, size) of one of the port's shipped trees."""
    import importlib.util

    pkg = os.path.dirname(importlib.util.find_spec(PORT).origin)
    path = os.path.join(pkg, "trees", name)
    tree = spec.load_json(path)
    return path, [len(r) for r in tree["roots"]], int(tree["size"])


def stretch(run, cm: dict):
    """The run as the per-layer metrics read it in a traced run: from the
    window's start to the traced span's close, each end at the instant the
    loop's counters were read (c0, cm), so that counters, records and seconds
    describe the same work, and nothing after the span (the profiler's stop,
    the window's end) moves them."""
    return types.SimpleNamespace(**dict(vars(run), t0=run.c0["at"], t1=cm["at"], c1=cm,
                                        seconds=cm["at"] - run.c0["at"]))


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False, watchdog: bool = False) -> dict:
    import torch

    cfg, mix = c["config"], c["mix"]
    keys = mix["engine"]
    chips = int(c["workload"]["chips"])
    # the cell's cards, cuda:i .. cuda:i+chips-1 from the run's device
    cards = ([torch.device("cuda", (device.index or 0) + i) for i in range(chips)]
             if device.type == "cuda" else [])

    def sync():
        for card in cards:
            torch.cuda.synchronize(card)

    mod = spec.builder(cfg)
    built = mod.build(cfg, seed, device, keys["max_length"])
    sync()
    growmap, levels, size = _tree(keys["growmap"])
    eng = drive.make_engine(built, dict(keys, seed=int(seed) % 2 ** 63), growmap)
    traffic = Traffic(mix, seed, built.vocab)
    loop = drive.LOOPS[mix["loop"]](eng, traffic, mix)
    loop.warm(seed, built.vocab)
    traced = trace and device.type == "cuda"
    if traced:
        from benchmark.trace import warm_up

        warm_up(torch)
    sync()
    t_load = time.time()
    setup_s = t_load - t_start
    if watchdog:
        faulthandler.dump_traceback_later(
            seconds + float(mix["ramp_seconds"]) + float(mix["drain_seconds"]) + STALL_S,
            exit=True)

    loop.start()
    t0 = t_load + float(mix["ramp_seconds"])
    time.sleep(max(0.0, t0 - time.time()))
    t0, c0 = time.time(), loop.counters()
    t1 = t0 + seconds
    prof = cm = None
    if traced:
        from benchmark.trace import open_span

        time.sleep(max(0.0, t1 - SPAN_LEAD_S - float(mix["trace_seconds"]) - time.time()))
        cp = loop.counters()
        prof = open_span(torch, float(mix["trace_seconds"]))
        cm = loop.counters()
    time.sleep(max(0.0, t1 - time.time()))
    c1 = loop.counters()
    loop.stop(float(mix["drain_seconds"]))
    span = None
    if prof is not None:
        from benchmark.trace import close_span

        span = close_span(prof, torch, chips)
    peaks = [torch.cuda.max_memory_allocated(card) for card in cards] or [0]

    run = types.SimpleNamespace(
        seconds=t1 - t0, t0=t0, t1=t1, c0=c0, c1=c1, records=loop.records, mix=mix, cfg=cfg,
        setup_s=setup_s, trace=span, shapes=mod.shapes(cfg), batch=int(keys.get("batch_size", 1)),
        tree_size=size, tree_levels=levels, kv_dtype=keys.get("kv_dtype") or "bf16",
        chunk=512, chips=chips)
    layers = stretch(run, cm) if cm is not None else run
    wanted = c["per_layer"] if trace else c["end_to_end"]
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(layers)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # requests served in the window: tokens arrived in it, or failed in it
    attempted = sum(1 for r in loop.records
                    if r.failed or (r.first is not None and r.first < t1
                                    and (r.done is None or r.done >= t0)))
    failed = sum(r.failed for r in loop.records)

    # the program's state goes before the reference runs
    loop.eng = loop.sched = loop.batcher = None
    del eng
    built.target = built.draft = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    chosen = check.sample(loop.records, int(mix["check_requests"]), seed)
    prompts = {r.index: traffic.request(r.index).prompt for r in chosen}
    found = check.readings(built.reference, chosen, prompts, device, control=control,
                           kv_dtype=keys.get("kv_dtype") or "bf16")
    correct, compared = check.verdict(found, c["limits"])
    if failed:
        correct = False
    res = dict(correct=bool(correct), attempted=attempted, failed=int(failed),
               metrics=metrics, setup_s=setup_s, memory_peak_bytes=int(max(peaks)),
               memory_peak_bytes_by_card=[int(p) for p in peaks], found=found,
               checks=compared, tokens_in_window=window.tokens_in(loop.records, t0, t1))
    if cm is not None:
        # where the per-layer stretch ended, and the steps before the profiler
        # started and while it ran (not compared; for reading the trace)
        res["stretch"] = dict(opened_s=cp["at"] - t0, closed_s=cm["at"] - t0,
                              steps_before=cp["steps"] - c0["steps"],
                              steps_profiled=cm["steps"] - cp["steps"])
    if span is not None:
        res["device_trace"] = dict(busy_s=span["busy_s"], busy_s_by_card=span["busy_s_by_card"],
                                   window_s=span["window_s"],
                                   breakdown=dict(device_ops=span["device_ops"],
                                                  idle_gaps=span["idle_gaps"]),
                                   pad_kept=span["pad_kept"])
    return res


def main(argv=None, t_start=None) -> int:
    import argparse

    t_start = t_start or time.time()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    c = spec.cell(args.workload)

    import torch

    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run_cell(c, args.seed, args.seconds, bool(args.trace), device, t_start,
                   watchdog=True)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=chips,
               memory_peak_bytes=res["memory_peak_bytes"], power_limit=power_limit())
    out = dict(correct=res["correct"], attempted=res["attempted"], failed=res["failed"],
               metrics=res["metrics"], device=dev)
    if args.trace and "device_trace" in res:
        t = res["device_trace"]
        dev.update(busy_s=t["busy_s"], busy_s_by_card=t["busy_s_by_card"],
                   window_s=t["window_s"], pad_kept=t["pad_kept"])
        out["breakdown"] = t["breakdown"]
    out["detail"] = dict(setup_s=res["setup_s"], found=res["found"],
                         memory_peak_bytes_by_card=res["memory_peak_bytes_by_card"],
                         tokens_in_window=res["tokens_in_window"], stretch=res.get("stretch"))
    out["checks"] = res["checks"]
    for name, v in res["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(out))
    return 0
