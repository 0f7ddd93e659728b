"""Serving soak: ContinuousBatcher under concurrent load on one card, the
counterpart of the JAX package's `examples/serve_soak.py`.

The reference serves ONE request at a time through a mutex-guarded worker;
this measures the batched serving story -- B slots decoding in one captured
step, requests admitted continuously -- under an open load of mixed-length
requests, and reports aggregate throughput plus per-request latency
percentiles (the numbers a deployment sets its objectives on).

Random weights => acceptance floor (but for awq8b, whose early-exit draft
shares the target's first layers); throughput is a lower bound, latency
percentiles reflect real scheduling and queueing. One JSON line:

    python -m umbrella_tpu_torch.examples.serve_soak [--batch 8] [--requests 32] [--device cpu]
"""
import argparse
import json
import time

import numpy as np
import torch

from ..config import ModelConfig
from ..models.auto_model import (ModelRuntime, early_exit_runtime, random_awq_runtime,
                                 random_runtime)
from ..quantization.int4f import hybridize_shared_prefix
from ..quantization.loader import quantize_runtime
from ..sequoia import growmap_from_spec
from ..serving.batched_engine import BatchedStaticEngine, ContinuousBatcher
from ..serving.scheduler import make_scheduler
from ..utils import resolve_device
from . import platform

def build_models(model_class: str, max_len: int, device):
    """(target, draft, growmap, kv_dtype, dtype) of a model class:
    awq8b: the flagship composition -- a random AWQ Llama-3.1-8B (tail wo/down
    scales x0.05, first 3 layers and the head Int4F) with its early-exit
    draft of 3 layers, int8 KV, a 2x3 tree; tiny: a 2-layer fp32 pair for a
    CPU smoke of the soak flow; 1b: a bf16 Llama-3.2-1B-width target (16
    layers) with a W4 2-layer draft, a 5x6 tree."""
    dtype = torch.bfloat16
    if model_class == "awq8b":
        awq_cfg = ModelConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            rope_theta=500000.0, max_position_embeddings=max_len,
            tie_word_embeddings=False, eos_token_id=-100)
        EXIT = 3
        target = random_awq_runtime(awq_cfg, max_len, dtype=dtype, seed=2,
                                    quantize_lm_head=True, device=device)
        dl = dict(target.params["layers"])
        for k in ("wo", "down"):
            dl[k] = tuple(q._replace(scales=q.scales * 0.05) if i >= EXIT else q
                          for i, q in enumerate(dl[k]))
        params = hybridize_shared_prefix(dict(target.params, layers=dl), EXIT, refine=0)
        target = ModelRuntime(awq_cfg, params, max_len, dtype=dtype, device=device)
        return target, early_exit_runtime(target, exit_layer=EXIT), growmap_from_spec(2, 3), \
            "int8", dtype
    if model_class == "tiny":
        # CPU smoke of the soak flow itself (metrics plumbing, streaming
        # cadence collection) -- not a perf configuration
        tiny_cfg = ModelConfig(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, max_position_embeddings=max_len,
            tie_word_embeddings=True, eos_token_id=-100)
        dtype = torch.float32
        target = random_runtime(tiny_cfg, max_len, dtype=dtype, seed=0, device=device)
        draft = random_runtime(tiny_cfg, max_len, dtype=dtype, seed=1, device=device)
        return target, draft, growmap_from_spec(3, 4), None, dtype
    target_cfg = ModelConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        rope_theta=500000.0, max_position_embeddings=max_len,
        tie_word_embeddings=True, eos_token_id=-100)
    draft_cfg = ModelConfig(
        vocab_size=128256, hidden_size=768, intermediate_size=3072,
        num_hidden_layers=2, num_attention_heads=12, num_key_value_heads=12,
        rope_theta=500000.0, max_position_embeddings=max_len,
        tie_word_embeddings=True, eos_token_id=-100)
    target = random_runtime(target_cfg, max_len, dtype=dtype, seed=0, device=device)
    draft = quantize_runtime(random_runtime(draft_cfg, max_len, dtype=dtype, seed=1,
                                            device=device),
                             dtype=dtype, quantize_lm_head=True)
    gm = growmap_from_spec(5, 6, acc=[0.55, 0.2, 0.1, 0.06, 0.05, 0.04])
    return target, draft, gm, None, dtype


def soak(eng, requests=32, max_new=128, prompt_min=32, prompt_max=256, mixed_priorities=False,
         no_scheduler=False, serial_loop=False, model_class="1b") -> dict:
    """A warm-up run() of one request a slot, then `requests` requests
    submitted 20 ms apart (open loop) through make_scheduler in front of a
    ContinuousBatcher (or straight into the batcher), every 4th streaming;
    waits for all. Returns the JAX example's result dict."""
    rng = np.random.default_rng(0)
    vmax = min(120000, eng.target_model.cfg.vocab_size - 2)
    eng.run([dict(input_ids=rng.integers(0, vmax, size=100).astype(np.int32)
                  .tolist(), max_new_tokens=16) for _ in range(eng.batch_size)])

    # requests route through the Scheduler (priority queue + metrics) in front
    # of the batcher -- the full serving composition (api/server "scheduler" key)
    batcher = ContinuousBatcher(eng, pipeline=not serial_loop)
    batcher.start()
    sched = None
    if not no_scheduler:
        sched = make_scheduler(batcher=batcher)
        sched.start()
    lat = []
    t0 = time.time()
    futs = []
    frame_times = {}  # request idx -> [wall times of partial frames]
    for i in range(requests):
        n_prompt = int(rng.integers(prompt_min, prompt_max))
        n_new = int(rng.integers(max_new // 2, max_new))
        ts = time.time()
        # uniform priority by default: the latency headline must not embed
        # deliberate inversions; mixed_priorities exercises the per-class
        # metrics + inversion accounting instead
        prio = (1 if (i % 4 == 0) else 5) if mixed_priorities else 1
        # every 4th request streams: frame cadence under load (partials are
        # emitted once per decode segment)
        ft = frame_times[i] = []
        cb = (lambda _t, _p, ft=ft: ft.append(time.time())) if i % 4 == 0 else None
        req_kw = dict(
            input_ids=rng.integers(0, vmax, size=n_prompt).astype(np.int32).tolist(),
            max_new_tokens=n_new)
        if sched is not None:
            fut = sched.submit(priority=prio, stream_cb=cb, **req_kw)
        else:
            fut = batcher.submit(stream_cb=cb, **req_kw)
        futs.append((fut, ts, n_new))
        time.sleep(0.02)  # open-loop-ish arrivals
    total_tokens = 0
    ttfts = []
    outputs = []
    for fut, ts, n_new in futs:
        out = fut.result(timeout=600)
        lat.append(time.time() - ts)
        total_tokens += len(out["generated_tokens"])
        outputs.append(out)
        if out.get("ttft_ms", 0) > 0:
            ttfts.append(out["ttft_ms"])
    wall = time.time() - t0
    gaps = [b - a for ft in frame_times.values() for a, b in zip(ft, ft[1:])]
    sched_metrics = (sched.snapshot_metrics() if sched is not None else
                     {"queue_seconds": 0.0, "requests": 0,
                      "priority_inversions": 0, "by_priority": {}})
    if sched is not None:
        sched.shutdown(wait=False)
    batcher.shutdown()

    lat_ms = np.sort(np.asarray(lat) * 1000)
    return {
        "metric": "serving_soak_aggregate_tokens_per_sec",
        "value": round(total_tokens / wall, 2),
        "unit": "tokens/s",
        "detail": {
            "platform": platform(eng.device),
            "batch_slots": eng.batch_size,
            "requests": requests,
            "total_tokens": total_tokens,
            "wall_s": round(wall, 2),
            "latency_p50_ms": round(float(np.percentile(lat_ms, 50)), 1),
            "latency_p90_ms": round(float(np.percentile(lat_ms, 90)), 1),
            "latency_p99_ms": round(float(np.percentile(lat_ms, 99)), 1),
            # per-request TTFT (submit -> first committed tokens, incl. queue
            # wait) and streaming-frame cadence on the streamed subset -- both
            # segment-quantized (partials are emitted once per segment)
            "ttft_p50_ms": round(float(np.percentile(ttfts, 50)), 1) if ttfts else None,
            "ttft_p99_ms": round(float(np.percentile(ttfts, 99)), 1) if ttfts else None,
            "stream_frame_gap_median_ms": round(
                1000 * float(np.median(gaps)), 1) if gaps else None,
            "stream_frames_per_request": round(
                np.mean([len(v) for v in frame_times.values() if v]), 1)
            if any(frame_times.values()) else None,
            "segment_steps": eng.segment_steps,
            "loop": "serial" if serial_loop else "pipelined",
            "scheduler_queue_seconds_total": round(sched_metrics["queue_seconds"], 2),
            "scheduler_queue_s_mean": round(
                sched_metrics["queue_seconds"] / max(sched_metrics["requests"], 1), 3),
            "priority_inversions": sched_metrics["priority_inversions"],
            "queue_s_mean_by_priority": {
                k: round(v["queue_seconds"] / max(v["requests"], 1), 3)
                for k, v in sched_metrics["by_priority"].items()},
            "prompt_tokens": [prompt_min, prompt_max],
            "model_class": model_class,
            "note": ("8B-AWQ flagship composition, early-exit shared draft, int8 KV, "
                     "2x3 tree" if model_class == "awq8b" else
                     "random weights => acceptance floor; throughput is a lower bound"),
        },
        "outputs": outputs,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--max-new", type=int, default=128)
    p.add_argument("--prompt-min", type=int, default=32)
    p.add_argument("--prompt-max", type=int, default=256)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--mixed-priorities", action="store_true",
                   help="alternate priority 1/5 to exercise per-class metrics "
                        "and inversion accounting under the batcher lookahead")
    p.add_argument("--no-scheduler", action="store_true",
                   help="A/B: submit straight into the ContinuousBatcher "
                        "(isolates the scheduler layer's cost)")
    p.add_argument("--serial-loop", action="store_true",
                   help="A/B: run the serial fetch->harvest->admit->dispatch "
                        "loop instead of the lag-1 pipelined default")
    p.add_argument("--segment-steps", type=int, default=8,
                   help="decode steps fused per dispatch; higher = fewer host "
                        "syncs/admission boundaries, coarser latency")
    p.add_argument("--model-class", choices=["1b", "awq8b", "tiny"], default="1b",
                   help="awq8b = the flagship composition (8B-AWQ damped target "
                        "+ shared early-exit Int4F draft) at the promoted serving "
                        "point: int8 KV, 2x3 tree; tiny = a CPU smoke of the flow")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    target, draft, gm, kv_dtype, dtype = build_models(args.model_class, args.max_len, device)
    eng = BatchedStaticEngine(
        draft_model_name=draft, target_model_name=target, batch_size=args.batch,
        dtype=dtype, growmap=gm, max_length=args.max_len, eos_token_ids=[-100],
        segment_steps=args.segment_steps, kv_dtype=kv_dtype, device=device)
    eng.initialize()
    result = soak(eng, args.requests, args.max_new, args.prompt_min, args.prompt_max,
                  args.mixed_priorities, args.no_scheduler, args.serial_loop, args.model_class)
    outputs = result.pop("outputs")
    print(json.dumps(result))
    return dict(result, outputs=outputs)


if __name__ == "__main__":
    main()
