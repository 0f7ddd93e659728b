"""70B-AWQ-shape measurement on ONE card: per-layer slope timing + extrapolation,
the counterpart of the JAX package's `examples/bench_70b.py`.

    python -m umbrella_tpu_torch.examples.bench_70b [--device cpu]

The north-star workload is Llama3.3-70B-AWQ speculative serving (the
reference's published figure: an L40 at 37-38.5 tok/s with a 1B draft). This
measures what one card measures exactly and extrapolates the rest with stated
assumptions:

1. SLOPE-timed single 70B layer (K=8192, I=28672 W4A16 matmuls + flash
   attention at GQA 64 heads / 8 kv heads, S=128 verify tree): the per-layer
   verify cost. The layer runs n1 and n2 times in a row with a loop-carried
   data dependency, each count captured as one CUDA graph on the card;
   (t2-t1)/(n2-n1) cancels launch and wait overhead.
2. SLOPE-timed W4 lm_head ([8192, 128256]), once per verify step.
3. Extrapolated verify step: n_layers x per-layer + head, at TP=1, TP=4, TP=8.
   TP splits every matmul's FLOPs/bytes evenly (parallel/mesh.py's column/row
   layout); the per-layer collective cost is modeled as 2 all_reduces of the
   [S, H] activations (the port sums them in fp32) over a ring of tp cards,
   2*(N-1)/N * bytes / bw at NVLink 4's 450 GB/s a direction (H100 SXM data
   sheet: 900 GB/s both directions), reported separately so the assumption
   is auditable; and PP=4 with 3 activation hops. `fits_hbm` compares the
   W4 bytes a card with the card's memory. The tok/s projection leaves the
   draft build out: it is not timed here.
4. Offload tier: a pinned-host -> device copy of one W4 layer (PCIe) against
   its compute gives the stream:compute split.

Prints one JSON object.
"""
import argparse
import json
import time

import numpy as np
import torch

from ..config import ModelConfig
from ..cuda_graphs import Phase
from ..models.kv_cache import init_kv_cache
from ..models.llama import StaticModelArgs, llama_layer
from ..ops.masks import tree_mask_rows
from ..ops.rope import rope_params
from ..quantization.awq import AwqTensor, awq_matmul
from ..utils import resolve_device
from . import platform, step_runner, synchronize

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink 4, one direction (data sheet: 900 GB/s total)
PSUM_ELEM_BYTES = 4  # parallel/collectives.all_reduce sums in fp32
BASELINE_L40_TOK_S = 37.0  # the reference's published L40 figure (70B AWQ, 1B draft)


def awq_weight(rng, k_dim, n_dim, group_size, dtype, device) -> AwqTensor:
    """A random split-halves W4 tensor (uniform nibbles, scales U(0.001,
    0.01), integer zeros 0..15), drawn from numpy `rng` in the JAX example's
    order: w8, scales, zeros."""
    G = k_dim // group_size
    w8 = rng.integers(0, 256, (k_dim // 2, n_dim), dtype=np.uint8).view(np.int8)
    scales = rng.uniform(0.001, 0.01, (G, n_dim)).astype(np.float32)
    zeros = rng.integers(0, 16, (G, n_dim)).astype(np.float32)
    return AwqTensor(w8=torch.from_numpy(w8).to(device),
                     scales=torch.from_numpy(scales).to(device=device, dtype=dtype),
                     zeros=torch.from_numpy(zeros).to(device=device, dtype=dtype))


def build_layer(hidden_size=8192, intermediate_size=28672, head_dim=128, num_heads=64,
                num_kv_heads=8, vocab_size=128256, tree_size=128, kv_len=2048,
                group_size=128, num_nodes=1024, dtype=torch.bfloat16, device="cpu"):
    """One decoder layer's W4 weights and its verify inputs, drawn from
    np.random.default_rng(0) in the JAX example's order (wqkv, wo, gate_up,
    down, then x0 [S, H]): a dict with cfg, args, lw, kv, mask, pos,
    num_nodes, x0, rope and the rng (the head is drawn from it next)."""
    dev = torch.device(device)
    H, I, D, S, L = hidden_size, intermediate_size, head_dim, tree_size, kv_len
    cfg = ModelConfig(
        vocab_size=vocab_size, hidden_size=H, intermediate_size=I, num_hidden_layers=1,
        num_attention_heads=num_heads, num_key_value_heads=num_kv_heads, head_dim=D,
        rope_theta=500000.0, max_position_embeddings=L, tie_word_embeddings=False,
        eos_token_id=-100)
    rng = np.random.default_rng(0)
    Hq, KV = num_heads * D, num_kv_heads * D

    def q(k_dim, n_dim):
        return awq_weight(rng, k_dim, n_dim, group_size, dtype, dev)

    lw = {"input_norm": torch.ones(H, dtype=dtype, device=dev),
          "post_norm": torch.ones(H, dtype=dtype, device=dev)}
    lw.update(wqkv=q(H, Hq + 2 * KV), wo=q(Hq, H), gate_up=q(H, 2 * I), down=q(I, H))
    bitmap = torch.eye(S, dtype=torch.bool, device=dev)
    bitmap[:, 0] = True
    nn = torch.full((), num_nodes, dtype=torch.int32, device=dev)
    x0 = torch.from_numpy(rng.standard_normal((S, H)).astype(np.float32)).to(dev, dtype)
    rp = rope_params(cfg, device=dev)
    return dict(cfg=cfg, args=StaticModelArgs.from_config(cfg, n_layers=1), lw=lw,
                kv=init_kv_cache(cfg, L, dtype, num_layers=1, device=dev),
                mask=tree_mask_rows(nn, bitmap, L), pos=nn + torch.zeros(S, dtype=torch.int32,
                                                                       device=dev),
                num_nodes=nn, x0=x0, rope=(rp["rope_inv_freq"], rp["rope_scale"]), rng=rng)


def layer_output(b: dict, h: torch.Tensor) -> torch.Tensor:
    """The layer on hidden h (its KV written at the tree's slots)."""
    return llama_layer(b["args"], b["lw"], h, b["kv"], 0, b["pos"], b["mask"], b["num_nodes"],
                       *b["rope"])[0]


def reps(fn, x: torch.Tensor, n: int, device: torch.device):
    """`run(k)`: k runs of n calls h = fn(h) from x (one CUDA graph of the n
    calls on the card; eager on the CPU)."""
    def body():
        h = x
        for _ in range(n):
            h = fn(h)
        return h

    return step_runner([Phase(f"reps{n}", device, body, (), ("h",))], device)


def slope_time(make, device, n1=4, n2=20):
    """Seconds per call via the slope method: `make(n)` gives a runner of n
    dependent calls; the best of 3 timed runs of each, (t2-t1)/(n2-n1)."""
    r1, r2 = make(n1), make(n2)

    def run(r):
        synchronize(device)
        t0 = time.time()
        r(1)
        synchronize(device)
        return time.time() - t0

    run(r1)
    run(r2)
    t1 = min(run(r1) for _ in range(3))
    t2 = min(run(r2) for _ in range(3))
    return (t2 - t1) / (n2 - n1)


def extrapolate(layer_s, head_s, w4_layer_bytes, head_bytes, n_layers, tree_size, hidden_size,
                device_bytes=None) -> dict:
    """The verify step at TP 1/4/8 and PP 4 from the per-layer and head
    seconds: compute / tp, plus 2 all_reduces a layer of [S, H] over a ring
    of tp cards at NVLink's rate; PP 4 the whole compute plus 3 hops of [S,
    H]. tok/s at 3 and 5 accepted tokens a step, the draft build left out."""
    w4_total = w4_layer_bytes * n_layers + head_bytes
    psum_bytes = 2 * tree_size * hidden_size * PSUM_ELEM_BYTES
    step = {}

    def fits(k):
        return None if device_bytes is None else bool(w4_total / k < device_bytes)

    for tp in (1, 4, 8):
        compute = (n_layers * layer_s + head_s) / tp
        coll = 0.0 if tp == 1 else n_layers * 2 * (tp - 1) / tp * psum_bytes / NVLINK_BYTES_PER_S
        step[f"tp{tp}"] = {"verify_ms": round(1000 * (compute + coll), 2),
                           "collective_ms": round(1000 * coll, 2), "fits_hbm": fits(tp)}
    hop = 3 * tree_size * hidden_size * 2 / NVLINK_BYTES_PER_S
    step["pp4"] = {"verify_ms": round(1000 * (n_layers * layer_s + head_s + hop), 2),
                   "collective_ms": round(1000 * hop, 3), "fits_hbm": fits(4),
                   "note": "capacity axis: B=1 latency = full-model compute (fill bubble)"}
    for d in step.values():
        for accept in (3, 5):
            d[f"proj_tok_s_accept{accept}"] = (round(accept * 1000 / d["verify_ms"], 1)
                                               if d["verify_ms"] > 0 else None)
    return step


def _nbytes(q: AwqTensor) -> int:
    return sum(t.numel() * t.element_size() for t in q)


def stream_seconds(lw: dict, device: torch.device) -> float:
    """A pinned-host -> device copy of the layer's W4 tensors (w8, scales and
    zeros), the best of 3 (a host copy on the CPU)."""
    host = [t.cpu() for q in lw.values() if isinstance(q, AwqTensor) for t in q]
    if device.type == "cuda":
        host = [t.pin_memory() for t in host]
    best = float("inf")
    for _ in range(3):
        synchronize(device)
        t0 = time.time()
        dev = [t.to(device, non_blocking=True) if device.type == "cuda" else t.clone()
               for t in host]
        synchronize(device)
        best = min(best, time.time() - t0)
        del dev
    return best


def measure(hidden_size=8192, intermediate_size=28672, head_dim=128, num_heads=64,
            num_kv_heads=8, num_layers=80, vocab_size=128256, tree_size=128, kv_len=2048,
            group_size=128, dtype=torch.bfloat16, device="cuda", n1=4, n2=20) -> dict:
    """Run the 70B-shape measurement (Llama-3.x-70B widths by default; any
    smaller widths for a test); returns the result dict (see module doc)."""
    dev = resolve_device(device)
    H, S, V = hidden_size, tree_size, vocab_size
    b = build_layer(H, intermediate_size, head_dim, num_heads, num_kv_heads, V, S, kv_len,
                    group_size, dtype=dtype, device=dev)
    lw, x0 = b["lw"], b["x0"]
    w4_layer_bytes = sum(v.w8.numel() for v in lw.values() if isinstance(v, AwqTensor))

    # loop-carried data dependency; keep magnitude stable
    layer_s = slope_time(lambda n: reps(lambda h: x0 + 0.001 * layer_output(b, h), x0, n, dev),
                         dev, n1, n2)
    head = awq_weight(b["rng"], H, V, group_size, dtype, dev)

    def head_call(h):
        y = awq_matmul(h, head, out_dtype=torch.float32)
        return x0 + 0.0001 * y[:, :H].to(x0.dtype)

    head_s = slope_time(lambda n: reps(head_call, x0, n, dev), dev, n1, n2)

    device_bytes = (torch.cuda.get_device_properties(dev).total_memory
                    if dev.type == "cuda" else None)
    step = extrapolate(layer_s, head_s, w4_layer_bytes, head.w8.numel(), num_layers, S, H,
                       device_bytes=device_bytes)

    # ---- offload tier: one-layer pinned host -> device stream vs compute ----
    stream_s = stream_seconds(lw, dev)
    layer_bytes = sum(_nbytes(q) for q in lw.values() if isinstance(q, AwqTensor))
    offload = {
        "layer_stream_ms_measured": round(1000 * stream_s, 3),
        "link_GBps_measured": round(layer_bytes / stream_s / 1e9, 2),
        "split_measured": "DMA-bound" if stream_s > layer_s else "compute-bound",
        "offload_step_ms_measured_stream": round(
            1000 * (num_layers * max(layer_s, stream_s) + head_s), 1),
    }
    return {
        "metric": "llama70b_awq_shape_per_layer_verify_ms",
        "value": round(1000 * layer_s, 3),
        "unit": "ms/layer (S=128 W4A16 verify, slope-timed)",
        "detail": {
            "platform": platform(dev),
            "lm_head_ms": round(1000 * head_s, 3),
            "w4_layer_MB": round(w4_layer_bytes / 1e6, 1),
            "w4_total_GB": round((w4_layer_bytes * num_layers + head.w8.numel()) / 1e9, 2),
            "device_memory_GB": None if device_bytes is None else round(device_bytes / 1e9, 2),
            "hbm_bound_floor_ms_per_layer": round(1000 * w4_layer_bytes / HBM_BYTES_PER_S, 3),
            "extrapolated_verify_step": step,
            "draft_note": "the tok/s projection leaves the draft build out (not timed here)",
            "offload_tier": offload,
            "baseline_L40_tok_s": BASELINE_L40_TOK_S,
            "baseline_note": "the reference's published L40 figure, not measured here",
        },
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    result = measure(device=resolve_device(args.device))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
