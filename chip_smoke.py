#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (umbrella_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):
  1. build   — compile every kernel in umbrella_tpu_torch/csrc/ with nvcc.
  2. kernels — call each kernel's wrapper at the main path's shapes and hold it
               against its plain PyTorch version on the card; time the kernel,
               the plain version and one PyTorch library call computing the same
               function, and compute the card's bound for the same work.
  3. lossless — full widths, 4 layers, early exit 2, fp32 activations: greedy
               static-tree generate() must equal the port's own greedy
               autoregressive decode for 64 tokens.
  4. main path — the 8B AWQ target (32 layers, damped tail, Int4F shared
               prefix of 3 layers + lm_head) with its early-exit draft, a
               Sequoia 24x6 tree, through AutoEngine.from_config ->
               initialize -> generate(); every kernel must have launched.
  5. report  — one JSON line of kernels, the card's name and power limit, and
               the final {"ok": true, ...} line.

Weights are random (seeded). The script needs CUDA and the repository's
umbrella_tpu_torch package beside it; without either it exits with code 2.
"""
import json
import os
import subprocess
import sys
import time
import traceback

PROMPT_LEN = 128
MAIN_NEW_TOKENS = 256
LOSSLESS_NEW_TOKENS = 64
MAX_LEN = 2048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
CFG_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
              num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
              rope_theta=500000.0, max_position_embeddings=MAX_LEN,
              tie_word_embeddings=False, eos_token_id=-100)
ACC_24x6 = [0.55, 0.2, 0.1, 0.06, 0.05, 0.04]
LAYER_SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "gate_up": (4096, 28672),
                "down": (14336, 4096)}


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def library_ms(torch, fn):
    """cuda_ms of a library call, or None (with the reason printed) where this
    PyTorch build refuses the call at these shapes."""
    try:
        return cuda_ms(torch, fn)
    except RuntimeError as e:
        log(f"[kernels] library call unavailable: {e}")
        return None


def bound(bytes_moved, ops, op_type):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- phase 2


def kernel_checks(torch, dev):
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels.embed_gather import embed_gather, embed_gather_ref
    from umbrella_tpu_torch.ops.kernels.tree_attention import attend_dense, attend_flash
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_dequant_halves_bf16, w4a16_matmul,
                                                      w4a16_matmul_ref)
    from umbrella_tpu_torch.ops.kernels.w4a8f import (quantize_activations_int8, w4a8f_matmul,
                                                      w4a8f_matmul_ref)
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device
    from umbrella_tpu_torch.quantization.int4f import quantize_int4f
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    report = {}

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()

    # -- embed_gather: exact (a copy)
    V, H = CFG_8B["vocab_size"], CFG_8B["hidden_size"]
    embed = randn(V, H, scale=0.02)
    e_max = 0.0
    for S in (1, 24, 127, 128):
        ids = torch.randint(0, V, (S,), generator=gen, device=dev, dtype=torch.int32)
        e, _ = err(embed_gather(embed, ids), embed_gather_ref(embed, ids))
        check(e == 0.0, f"embed_gather S={S}: max abs err {e} (must be exact)")
        e_max = max(e_max, e)
    ids = torch.randint(0, V, (127,), generator=gen, device=dev, dtype=torch.int32)
    by, _ = bound(2 * 127 * H * 2 + 127 * 4, 0, "bf16")
    report["embed_gather"] = dict(
        shape="[128256,4096] bf16, S=127", tolerance="exact", max_abs_err=e_max,
        ms=cuda_ms(torch, lambda: embed_gather(embed, ids)),
        plain_ms=cuda_ms(torch, lambda: embed_gather_ref(embed, ids)),
        library_ms=cuda_ms(torch, lambda: F.embedding(ids, embed)),
        bound_ms=by, bound_by="bytes")
    log(f"[kernels] embed_gather {report['embed_gather']}")
    del embed

    # -- attend_flash: bf16, layered [4, 8, 2048, 128] cache, odd kv_limit
    nH, KVH, D = 32, 8, 128
    kc = randn(4, KVH, MAX_LEN, D)
    vc = randn(4, KVH, MAX_LEN, D)
    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    bitmap = torch.as_tensor(gm.bitmap, device=dev)
    nn = 301  # committed prefix: kv_limit = nn + S is odd for even S
    a_max, a_rel = 0.0, 0.0
    cases = {1: "causal", 24: "causal", gm.size: "tree", 512: "causal"}
    for S, kind in cases.items():
        q = randn(S, nH, D)
        mask = (tree_mask_rows(nn, bitmap, MAX_LEN) if kind == "tree"
                else causal_mask_rows(nn, S, MAX_LEN, device=dev))
        for layer in (0, 3):
            got = attend_flash(q, kc, vc, mask, nn + S, layer)
            ref = attend_dense(q, kc[layer], vc[layer], mask)
            e, m = err(got, ref)
            check(e <= 2e-2 * m, f"attend_flash S={S} layer={layer}: err {e} vs max {m}")
            a_max, a_rel = max(a_max, e), max(a_rel, e / m)
    S = gm.size
    kv_limit = nn + S
    q = randn(S, nH, D)
    mask = tree_mask_rows(nn, bitmap, MAX_LEN)
    qs = q.transpose(0, 1)[None]
    ks, vs = kc[3:4, :, :kv_limit], vc[3:4, :, :kv_limit]
    ms_ = mask[None, None, :, :kv_limit]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=ms_, enable_gqa=True)

    attn_bytes = 2 * S * nH * D * 2 + 2 * kv_limit * KVH * D * 2 + S * kv_limit
    by, bb = bound(attn_bytes, 4 * S * nH * kv_limit * D, "bf16")
    report["attend_flash"] = dict(
        shape=f"q [{S},32,128] bf16 vs [4,8,2048,128] cache, tree mask, kv_limit={kv_limit}",
        tolerance="max abs err <= 2e-2 * max|plain| (bf16 output; p rounded at other points)",
        max_abs_err=a_max, max_rel_err=a_rel,
        ms=cuda_ms(torch, lambda: attend_flash(q, kc, vc, mask, kv_limit, 3)),
        plain_ms=cuda_ms(torch, lambda: attend_dense(q, kc[3], vc[3], mask)),
        library_ms=library_ms(torch, sdpa), bound_ms=by, bound_by=bb)
    log(f"[kernels] attend_flash {report['attend_flash']}")
    del kc, vc

    # -- w4a16_matmul: the four AWQ layer shapes, ragged S; bf16 and fp32 output
    w_max, w_rel, shapes_ms = 0.0, 0.0, {}
    for name, (K, N) in LAYER_SHAPES.items():
        q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
        for S in (1, 24, 127):
            x = randn(S, K)
            for od, tol in ((f32, 1e-4), (bf16, 2 ** -7)):
                got = w4a16_matmul(x, q, out_dtype=od)
                ref = w4a16_matmul_ref(x, q, out_dtype=od)
                e, m = err(got, ref)
                check(e <= tol * m, f"w4a16 {name} S={S} {od}: err {e} vs max {m}")
                w_max, w_rel = max(w_max, e), max(w_rel, e / m)
        # the lossless phase's dtypes: fp32 activations and fp32 scales
        q32 = q._replace(scales=q.scales.float(), zeros=q.zeros.float())
        for S in (1, 127):
            x = randn(S, K, dtype=f32)
            e, m = err(w4a16_matmul(x, q32), w4a16_matmul_ref(x, q32))
            check(e <= 1e-4 * m, f"w4a16 {name} S={S} fp32 x/scales: err {e} vs max {m}")
            w_max, w_rel = max(w_max, e), max(w_rel, e / m)
        del q32
        x = randn(127, K)
        w_deq = _dequant_halves_bf16(q)
        G = K // 128
        by, bb = bound(127 * K * 2 + K // 2 * N + 2 * G * N * 2 + 127 * N * 2,
                       2 * 127 * K * N, "bf16")
        shapes_ms[name] = dict(
            ms=cuda_ms(torch, lambda: w4a16_matmul(x, q)),
            plain_ms=cuda_ms(torch, lambda: w4a16_matmul_ref(x, q), iters=5),
            library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)),
            bound_ms=by, bound_by=bb)
        log(f"[kernels] w4a16_matmul {name} K={K} N={N} S=127 {shapes_ms[name]}")
        del q, w_deq
    report["w4a16_matmul"] = dict(
        shape="x [127,4096] bf16 @ W4 [4096,28672] (gate_up), bf16 out",
        tolerance="max abs err <= 1e-4 * max|plain| (fp32 out), 2**-7 * max|plain| (bf16 out)",
        max_abs_err=w_max, max_rel_err=w_rel, per_shape=shapes_ms, **shapes_ms["gate_up"])

    # -- w4a8f_matmul: layer shapes (bf16 out) and the lm_head (fp32 out)
    f_max, f_rel, shapes_ms = 0.0, 0.0, {}
    for name, (K, N) in dict(LAYER_SHAPES, lm_head=(4096, V)).items():
        od = f32 if name == "lm_head" else bf16
        q = quantize_int4f(torch.randn((K, N), generator=gen, device=dev) * 0.02, refine=0)
        for S in (1, 24, 127):
            x = randn(S, K)
            got = w4a8f_matmul(x, q, out_dtype=od)
            ref = w4a8f_matmul_ref(x, q, out_dtype=od)
            e, m = err(got, ref)
            check(e <= 1e-6 * m, f"w4a8f {name} S={S}: err {e} vs max {m}")
            f_max, f_rel = max(f_max, e), max(f_rel, e / m)
        w32 = q.w8.to(torch.int32)
        w_int8 = torch.cat([(w32 & 0xF) - 8, ((w32 >> 4) & 0xF) - 8]).to(torch.int8)
        del w32
        for S in (24, 127):  # a draft level's rows, and a verify pass's
            x = randn(S, K)
            xq = quantize_activations_int8(x, q.a)[0]
            by, bb = bound(S * K * 2 + K // 2 * N + N * 4 + K * 4 + S * N * od.itemsize,
                           2 * S * K * N, "int8")
            shapes_ms[f"{name} S={S}"] = dict(
                ms=cuda_ms(torch, lambda: w4a8f_matmul(x, q, out_dtype=od)),
                plain_ms=cuda_ms(torch, lambda: w4a8f_matmul_ref(x, q, out_dtype=od), iters=3,
                                 warmup=1),
                library_ms=library_ms(torch, lambda: torch._int_mm(xq, w_int8)),
                bound_ms=by, bound_by=bb)
        log(f"[kernels] w4a8f_matmul {name} K={K} N={N} "
            f"{shapes_ms[f'{name} S=24']} | {shapes_ms[f'{name} S=127']}")
        del q, w_int8
    report["w4a8f_matmul"] = dict(
        shape="x [24,4096] bf16 @ Int4F [4096,128256] (lm_head at a draft level), fp32 out",
        tolerance="max abs err <= 1e-6 * max|plain| (integer part exact, same fp32 epilogue)",
        max_abs_err=f_max, max_rel_err=f_rel, per_shape=shapes_ms, **shapes_ms["lm_head S=24"])
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------- phases 3-4


def build_target(torch, dev, n_layers, exit_layer, dtype):
    """bench.py's primary target: random W4 weights, tail wo/down scales damped
    x0.05, shared prefix (exit_layer layers + lm_head) converted to Int4F."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import (ModelRuntime, early_exit_runtime,
                                                      random_awq_runtime)
    from umbrella_tpu_torch.quantization.int4f import hybridize_shared_prefix

    cfg = ModelConfig(**dict(CFG_8B, num_hidden_layers=n_layers))
    t = random_awq_runtime(cfg, MAX_LEN, dtype=dtype, seed=2, quantize_lm_head=True,
                           device=dev)
    layers = dict(t.params["layers"])
    for k in ("wo", "down"):
        layers[k] = tuple(q._replace(scales=q.scales * 0.05) if i >= exit_layer else q
                          for i, q in enumerate(layers[k]))
    params = hybridize_shared_prefix(dict(t.params, layers=layers), exit_layer, refine=0)
    target = ModelRuntime(cfg, params, MAX_LEN, dtype=dtype, device=dev)
    return target, early_exit_runtime(target, exit_layer=exit_layer)


def make_engine(torch, dev, target, draft, dtype):
    from umbrella_tpu_torch.sequoia import growmap_from_spec
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    eng = AutoEngine.from_config(
        device=dev, engine="static", model=target, draft_model=draft,
        growmap=growmap_from_spec(24, 6, acc=ACC_24x6), max_length=MAX_LEN,
        temperature=0.0, eos_token_ids=[-100], dtype=dtype)
    eng.initialize()
    return eng


def greedy_ar_decode(torch, runtime, prompt, n_new):
    """Plain autoregressive greedy decode with the port's own forward. Returns
    (tokens, gaps): gaps[i] is the top-1 minus top-2 logit at step i."""
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    dev = runtime.device
    kv = runtime.init_kv()
    S = len(prompt)
    logits, kv = runtime.forward(runtime.params, kv, torch.tensor(prompt, device=dev),
                                 torch.arange(S, device=dev),
                                 causal_mask_rows(0, S, MAX_LEN, device=dev), 0)
    row = logits[-1]
    out, gaps = [], []
    for t in range(S, S + n_new):
        top = torch.topk(row, 2)
        out.append(int(top.indices[0]))
        gaps.append(float(top.values[0] - top.values[1]))
        if len(out) == n_new:
            break
        lg, kv = runtime.forward(runtime.params, kv, torch.tensor([out[-1]], device=dev),
                                 torch.tensor([t], device=dev),
                                 causal_mask_rows(t, 1, MAX_LEN, device=dev), t)
        row = lg[0]
    return out, gaps


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def lossless_check(torch, dev, prompt):
    """The first LOSSLESS_NEW_TOKENS tokens must be identical; where the two
    decodes part later (generate() may overshoot by up to a tree path), the AR
    top-1/top-2 logit gap at that step is reported."""
    target, draft = build_target(torch, dev, n_layers=4, exit_layer=2, dtype=torch.float32)
    eng = make_engine(torch, dev, target, draft, torch.float32)
    out = eng.generate(input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS)
    toks = out["generated_tokens"]
    ar, gaps = greedy_ar_decode(torch, target, prompt, len(toks))
    same = first_difference(toks, ar)
    res = dict(tokens=len(toks), identical_prefix=same, avg_accept_tokens=out["avg_accept_tokens"],
               min_ar_gap=min(gaps), gap_at_first_difference=gaps[same] if same < len(toks) else None)
    log(f"[lossless] {json.dumps(res)}")
    check(len(toks) >= LOSSLESS_NEW_TOKENS, "lossless: too few tokens")
    check(same >= LOSSLESS_NEW_TOKENS,
          f"lossless: spec and AR decode differ at token {same}: {toks} vs {ar}")
    return res


def main_path(torch, dev, prompt):
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t0 = time.time()
    target, draft = build_target(torch, dev, n_layers=32, exit_layer=3, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    eng = make_engine(torch, dev, target, draft, torch.bfloat16)
    eng.generate(input_ids=prompt, max_new_tokens=16)  # warm-up

    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    assert eng._prefill(prompt)
    torch.cuda.synchronize()
    ttft_ms = 1000 * (time.time() - t1)
    prefill_counts = launch_counts()
    eng.reset()

    reset_launch_counts()
    out = eng.generate(input_ids=prompt, max_new_tokens=MAIN_NEW_TOKENS)
    counts = launch_counts()
    toks = out["generated_tokens"]
    dec_len = len(toks)
    tpot = out["time_per_output_token"]
    steps = round(dec_len / out["avg_accept_tokens"])
    for name, n in counts.items():
        check(n > 0, f"main path: kernel {name} was never launched")
    per_step = {k: (counts[k] - prefill_counts[k]) / steps for k in counts}
    ar, gaps = greedy_ar_decode(torch, target, prompt, dec_len)
    prefix = first_difference(toks, ar)
    profiled = profile_generate(torch, eng, prompt)
    res = dict(setup_s=setup_s, tokens=dec_len, steps=steps, tok_per_s=1000.0 / tpot,
               decode_step_ms=tpot * dec_len / steps, avg_accept_tokens=out["avg_accept_tokens"],
               ttft_ms_prefill128=ttft_ms, launches=counts, launches_per_step=per_step,
               spec_vs_ar_common_prefix=prefix,
               ar_gap_at_first_difference=gaps[prefix] if prefix < dec_len else None,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30, profile=profiled)
    log(f"[main] {json.dumps(res)}")
    check(all(0 <= t < CFG_8B["vocab_size"] for t in toks), "main path: token out of range")
    return res


def profile_generate(torch, eng, prompt, new_tokens=64):
    """One generate() under torch.profiler: device time by kernel name (summed
    over launches), device busy time and wall time. Returns None where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = eng.generate(input_ids=prompt, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall_ms = 1000 * (time.time() - t0)
    by_name = {}
    for e in prof.key_averages():
        # kernels only: CPU ops repeat the device time of the kernels they launch
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1000.0
    if not by_name:
        log("[profile] the profiler recorded no device time: not measured")
        return None
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # PyTorch ops called from Python (not ops nested inside other ops), and kernels
    host_ops = sum(1 for e in events if e.device_type != cuda and e.cpu_parent is None
                   and e.name.startswith("aten::"))
    kernels = sum(1 for e in events if e.device_type == cuda)
    steps = max(1, round(len(out["generated_tokens"]) / out["avg_accept_tokens"]))
    res = dict(new_tokens=len(out["generated_tokens"]), steps=steps, wall_ms=wall_ms,
               device_busy_ms=busy, device_idle_share=1.0 - busy / wall_ms,
               host_ops_per_step=host_ops / steps, device_kernels_per_step=kernels / steps,
               top_kernels_ms={k[:90]: v for k, v in top})
    log(f"[profile] {json.dumps(res)}")
    return res


# ---------------------------------------------------------------- main

KERNEL_META = {
    "embed_gather": ("umbrella_tpu_torch/csrc/embed_gather.cu",
                     "umbrella_tpu/ops/pallas/embed_gather.py:60"),
    "attend_flash": ("umbrella_tpu_torch/csrc/tree_attention.cu",
                     "umbrella_tpu/ops/pallas/tree_attention.py:361"),
    "w4a16_matmul": ("umbrella_tpu_torch/csrc/w4a16.cu", "umbrella_tpu/ops/pallas/w4a16.py:233"),
    "w4a8f_matmul": ("umbrella_tpu_torch/csrc/w4a8f.cu", "umbrella_tpu/ops/pallas/w4a8f.py:97"),
}


def run(torch):
    import numpy as np

    from umbrella_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    log(f"[card] {torch.cuda.get_device_name(0)}; {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.time()
    build.build_all(verbose=True)
    log(f"[build] {len(build.sources())} kernels in {time.time() - t0:.1f} s")

    t0 = time.time()
    report = kernel_checks(torch, dev)
    log(f"[kernels] checked in {time.time() - t0:.1f} s")

    prompt = np.random.default_rng(0).integers(0, 120000, size=PROMPT_LEN).astype(np.int32)
    t0 = time.time()
    lossless = lossless_check(torch, dev, prompt.tolist())
    log(f"[lossless] done in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.time()
    main = main_path(torch, dev, prompt.tolist())
    log(f"[main] done in {time.time() - t0:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = report[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main["launches"][name], max_abs_err=r["max_abs_err"], matched=True,
            tolerance=r["tolerance"], shape=r["shape"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            launches_per_step=main["launches_per_step"][name]))
    summary = {k: main[k] for k in ("tok_per_s", "decode_step_ms", "avg_accept_tokens",
                                    "ttft_ms_prefill128", "spec_vs_ar_common_prefix")}
    if main["profile"]:
        summary["device_idle_share"] = main["profile"]["device_idle_share"]
    log(f"[summary] {json.dumps(dict(summary, lossless=lossless))}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card[0] if card else "nvidia-smi: no card", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import umbrella_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: umbrella_tpu_torch not found beside this script", file=sys.stderr)
        return 2
    try:
        run(torch)
    except Exception:  # report the failed phase and exit non-zero
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # skip interpreter teardown, which can stall after CUDA work
