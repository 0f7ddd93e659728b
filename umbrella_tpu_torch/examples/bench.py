"""Single-step latency micro-bench, the counterpart of the JAX package's
`examples/bench.py`: time one model's forward at a given prefix/decode length.

    python -m umbrella_tpu_torch.examples.bench --model <checkpoint dir> \
        [--offload --num_cache_layers N] [--device cpu]
"""
import argparse
import time

import torch

from ..cuda_graphs import Phase
from ..models.auto_model import AutoModelLM
from ..ops.masks import causal_mask_rows
from ..utils import resolve_device
from . import step_runner, synchronize


def bench_step(runtime, prefix_len=512, decode_len=32, iters=20) -> dict:
    """One forward of decode_len tokens written at slot prefix_len, timed over
    `iters` calls (each waited for); prints the JAX example's line. A resident
    runtime's forward is one CUDA graph replayed on the card, an offload
    runtime's `streamed_forward` runs eagerly, as the engines run them."""
    dev = runtime.device
    kv = runtime.init_kv()
    L = runtime.max_length
    ids = torch.zeros(decode_len, dtype=torch.int32, device=dev)
    start = torch.full((), prefix_len, dtype=torch.int32, device=dev)
    pos = start + torch.arange(decode_len, dtype=torch.int32, device=dev)
    mask = causal_mask_rows(start, decode_len, L, device=dev)

    if runtime.supports_fused_phases:
        phases = [Phase("inputs", dev, lambda: (ids, pos, mask, start), (),
                        ("ids", "pos", "mask", "nn")), *runtime.forward_phases(kv)]
        step = step_runner(phases, dev)
    else:
        def step(n):
            for _ in range(n):
                runtime.streamed_forward(kv, ids, pos, mask, start)
    step(1)
    synchronize(dev)
    t0 = time.time()
    for _ in range(iters):
        step(1)
        synchronize(dev)
    dt = (time.time() - t0) / iters
    print(f"decode step ({decode_len} tokens @ prefix {prefix_len}): "
          f"{1000*dt:.2f} ms  ({decode_len/dt:.1f} tok verified/s)")
    return dict(step_ms=1000 * dt, tok_verified_per_s=decode_len / dt,
                prefix_len=prefix_len, decode_len=decode_len, iters=iters)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="meta-llama/Llama-3.2-1B-Instruct")
    parser.add_argument("--offload", action="store_true")
    parser.add_argument("--max_length", type=int, default=2048)
    parser.add_argument("--prefix_len", type=int, default=512)
    parser.add_argument("--decode_len", type=int, default=32, help="tokens per decode step")
    parser.add_argument("--num_cache_layers", type=int, default=0)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    runtime = AutoModelLM.from_pretrained(
        args.model, offload=args.offload, max_length=args.max_length,
        num_cache_layers=args.num_cache_layers, device=device)
    return bench_step(runtime, args.prefix_len, args.decode_len, args.iters)


if __name__ == "__main__":
    main()
