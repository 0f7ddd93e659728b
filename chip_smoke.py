#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (umbrella_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero); each prints
lines tagged with its name:
  build            compile every kernel in umbrella_tpu_torch/csrc/ with nvcc.
  kernels          call each kernel's wrapper at the main paths' shapes and hold
                   it against its plain PyTorch version on the card; time the
                   kernel, the plain version and a PyTorch library yardstick,
                   and compute the card's bound for the same work. Includes
                   every check of `w4a16` and of `w4a8`, and the offload
                   configs' shapes: W4A16 at the four 70B layer shapes at
                   S=256 and 257 (the dynamic verify), attention at the 70B
                   257-row verify q [257,64,128] and a 1B draft level
                   q [16,32,64].
  w4a16            (only when named in --phases; part of `kernels`) the W4A16
                   family alone: the plain mode at the four 8B layer shapes,
                   S=1, 24, 48, 127, 160, 224 and 300 (every token width of
                   the kernel), bf16/fp32 x, scales and out, timed at S=24,
                   127 and 224; the group size 32; eye(K) @ W equal to the
                   dequantized weight bit for bit; the fused gate-up-SiLU;
                   the layered mode on 4-layer stacks at each 70B layer shape
                   (split K and not), bit for bit the plain mode on each
                   layer, and an index past the stack must trap (in a child
                   process); row j of S=300 equal to row j at each other row
                   count, bitwise, for plain, layered and fused, bf16 and
                   fp32 x.
  w4a8             (only when named in --phases; part of `kernels`) the int8 W4
                   family (csrc/w4a8.cu) alone: the fused quantizer bit for bit
                   the plain quantizers (Int4F x * a with row sums, AWQ x with
                   sums per group of 128 and 32); w4a8f_matmul at the four 8B
                   layer shapes and the lm_head, bf16 and fp32 out, S=1, 24,
                   48, 127, 160, 224, 300 and 384 (every token width 32-256
                   and a second super-tile); w4a8_matmul at 8B gate_up and
                   down (K split), g128 and g32, bf16 and fp32 x and scales,
                   integer zeros and zeros + 0.5 (the two fix-ups), S=1, 24,
                   48, 127, 160, 224, 300 and 512: both exact against
                   their plain versions (max abs err 0.0), and the rows of
                   every S bit for bit the rows of the largest S; the same
                   for both at K/2 = 160 (a last stage of one k32 step;
                   AWQ g32 and g160); timings.
  attention        (only when named in --phases; part of `kernels`) the
                   attention kernels (csrc/tree_attention.cu) alone: each
                   wrapper at the serving and verify shapes and the 70B verify
                   shape q [127, 64, 128] (groups 8) against its plain version,
                   timed beside SDPA and its bound; fp32 q and head dim 32 take
                   the scalar kernel, bf16 q the tensor-core kernel; for bf16
                   and int8 KV: rows of S=1, 24 and 127 bit for bit the same
                   rows of S=512 (single slot, and one slot through `slots`),
                   each slot of a B=32 launch bit for bit the slot alone, 1e6 /
                   127 past a slot's kv_limit changes nothing, soft cap 30.0,
                   rows with no live slot and kv_limit 0 exactly 0.
  multi-card       the static and the batched engine built on the last card
                   while cuda:0 is current: 16 tokens each must equal the same
                   engines' tokens on cuda:0 (needs a host with 2+ cards; on
                   one card it prints "skipped: 1 card" and passes).
  lossless         full widths, 4 layers, early exit 2, fp32 activations:
                   greedy static-tree generate() must equal the port's own
                   greedy autoregressive decode for 64 tokens.
  lossless-int8    the same on an int8 KV cache (both decodes).
  lossless-w4a8    the same with awq_act="int8" (the W4 layers run W4A8).
  batched-lossless fp32, 4 layers, B=4 slots, 7 requests of staggered prompt
                   lengths: BatchedStaticEngine.run() must give each request
                   the single-slot StaticEngine's tokens (48 or more).
  pp-lossless      full Llama-3.3-70B width, 8 AWQ layers, early-exit draft
                   of 2 layers; the target staged in 4 stages of 2 layers
                   (pipeline_parallel 4) and decoded on the graphed loop:
                   fp32, fp32 with int8 KV, and bf16.
                   generate() must equal the unstaged engine's tokens for 64
                   tokens, and the AR decode's (fp32, bf16), or part from it
                   only at a near tie (int8 KV); the KV rows of the spec and
                   the AR decode are compared layer by layer as the witness.
  dynamic-lossless full widths, 4 layers, early exit 2, fp32: the dynamic engine
                   (the default engine; the shipped offload configs' 16 x 16
                   tree of 24 beams, graphed) and an offload target's
                   pipelined decode over the same weights (2 layers resident,
                   2 streamed from pinned memory; the draft phase and the
                   tail graphed), static 24x6 and dynamic, must each equal
                   the AR decode for 64 tokens.
  offload-lossless full Llama-3.3-70B widths, 6 AWQ layers, bf16: the offload
                   runtime (2 layers resident, 4 streamed) gives the resident
                   forward's logits bit for bit at a 128-token prefill and a
                   257-row dynamic verify, twice in a row; the dynamic engine
                   over it commits the resident engine's tokens, its step
                   graphed and again all eager.
  main             the 8B AWQ target (32 layers, damped tail, Int4F shared
                   prefix of 3 layers + lm_head) with its early-exit draft, a
                   Sequoia 24x6 tree, through AutoEngine.from_config ->
                   initialize -> generate(): graphed (the device-resident
                   decode loop, its step replayed as a CUDA graph) and
                   stepwise (build_tree(); verify(), one host read a step)
                   side by side, each with tok/s, step ms, TTFT and a
                   profile (idle share, host ops a step, replays, no-op
                   replays, capture ms, graph pool GB); equal tokens.
  graph            graphed against stepwise tokens: the static engine on the
                   fp32 lossless model, on the bf16 8B main path (greedy, and
                   stochastic from one seed) and the batched engine at B=32
                   with int8 KV; every replay under
                   torch.cuda.set_sync_debug_mode("error"); a graph captured
                   and replayed in each graphed run; a registered generator
                   draws anew at each replay; a step that reads the host must
                   fail its capture (no stepwise fallback).
  dynamic          the dynamic engine on the 8B target with a random bf16
                   draft at Llama-3.2-1B widths, the 16 x 16 x 24 tree,
                   greedy and stochastic (0.6 / 0.9 / 1.05): graphed and
                   stepwise tokens equal from one seed; tok/s, step ms,
                   accept, a profiled request (host ops a step, idle share,
                   traced launches a step = the captured step's).
  dynamic-pp       the dynamic engine (16 x 16 x 24, greedy, 32 tokens) over
                   an 8B AWQ target staged in 4 stages (pipeline_parallel 4)
                   with the 1B draft: graphed, stepwise and the unstaged
                   target's decode give the same tokens.
  serve            the same models behind engine="batched_static": B=32, int8
                   KV, 2x3 tree, 64 requests through run() and then through the
                   pipelined ContinuousBatcher; tok/s, accept, step ms, TTFT,
                   TPOT, peak memory, launches per step, device idle share;
                   then run() and the profiled segment again with the steps
                   dispatched eagerly (stepwise), the same tokens.
  serve-bf16       B=8, bf16 KV, 3x4 tree, 16 requests through run().
  serve-stochastic B=32 int8 KV at temperature 0.6, top-p 0.9.
  checkpoint       write synthetic checkpoints under build/ (deleted at the
                   end) in the published on-disk formats: an AutoAWQ GEMM
                   Llama-3.1-8B target (two safetensors shards; a second
                   directory over the same files says awq_act "int8") and a
                   bf16 Llama-3.2-1B draft; load both through
                   AutoModelLM.from_pretrained (time, host RSS, device
                   memory); the target's logits must equal the in-memory
                   conversion's bit for bit.
  code-config      configs/code_config_8b_awq_v5e.json as shipped (model,
                   draft_model and growmap_path rewritten; 128 new tokens):
                   greedy 24x6, W4 draft and head from quantize_draft.
  code-config-w4a8 the same on the awq_act "int8" target (w4a8_matmul).
  serve-config     configs/serve_batched_8b_awq_int8kv_v5e.json as shipped:
                   B=32, int8 KV, Int4F draft, 2x3 tree, temperature 0.6.
  pp-config        configs/chat_config_70b_awq_pp4.json as shipped: a random
                   AWQ Llama-3.3-70B at full shape (80 layers) staged in 4
                   stages (one per card on a host with 4, else all on this
                   card), the 8B AutoAWQ directory above as its draft,
                   temperature 0.6, top-p 0.9, repetition penalty 1.05, 24x6
                   tree, max_length 8192; graphed and stepwise from one
                   generator state, the same tokens: TTFT, step ms, tok/s,
                   accept, peak memory, launches per step (320 layered W4A16
                   a step), capture ms, pool GB by card, segments a step,
                   and each loop's decode profiled alone ([pp-profile],
                   [pp-profile-stepwise]; host ops a decode step, graphed
                   under a tenth of stepwise).
  offload-checkpoint the 8B AutoAWQ directory loaded with offload: true and
                   num_cache_layers 16: logits equal the resident load's bit
                   for bit.
  offload-config   configs/greedy_config_v5e.json and chat_config_v5e_16gb.json
                   as shipped (the dynamic engine over a random AWQ
                   Llama-3.3-70B at full widths, 16 layers on the card and the
                   rest streamed from pinned host memory, depth cut only where
                   MemAvailable cannot hold 64 streamed layers; the 1B draft
                   directory above): one request each on the graphed step
                   (TTFT, step ms, tok/s, accept), greedy again all eager
                   (the same tokens), streamed_forward_traced at the 257-row
                   verify (compute and exposed stream ms a layer, H2D GB/s a
                   streamed layer) and each loop's decode profiled alone
                   ([offload-profile], whose host-to-device copies must
                   overlap compute kernels, and [offload-profile-eager]);
                   peak device GB and pinned host GB.
  report           one JSON line of kernels, the card's name and power limit,
                   and the final {"ok": true, ...} line.
The static, dynamic and batched engines decode through CUDA graphs in every
phase (each phase checks it): a step is one graph on one card, one graph a
run of phases on one card for a target staged across cards, and two graphs
around the eager streamed forward for an offload target (its pipelined
loop); a replay adds the captured step's launches to the kernels' counts.
Every kernel must have launched in the phase that its `launches` is read
from; in [main], [serve], [serve-bf16], [code-config], [serve-config] and
[pp-config] (bf16) every attention launch must be the tensor-core kernel's,
in [lossless], [lossless-int8] and [lossless-w4a8] (fp32) the scalar
kernel's. `--phases a,b` runs a subset (no report).

Weights are random (seeded). The script needs CUDA and the repository's
umbrella_tpu_torch package beside it; without either it exits with code 2.
The whole script takes about twelve minutes on one H100 (726 s of command
time on an H100 80GB HBM3 at 700 W with every phase above), the kernels'
build (20-30 s) included; `--phases w4a16` about a minute,
`--phases w4a8` about 45 s, `--phases attention` about a minute.
"""
import bisect
import gc
import json
import os
import subprocess
import sys
import time
import traceback

PROMPT_LEN = 128
MAIN_NEW_TOKENS = 128
LOSSLESS_NEW_TOKENS = 64
BATCHED_LOSSLESS_TOKENS = 48
SERVE_NEW_TOKENS = 160
STOCHASTIC_NEW_TOKENS = 64
SEGMENT_STEPS = 8
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
LAYER_SHAPES_70B = {"wqkv": (8192, 10240), "wo": (8192, 8192), "gate_up": (8192, 57344),
                    "down": (28672, 8192)}
LLAMA3_EOS = [128001, 128008, 128009]
# meta-llama/Llama-3.3-70B-Instruct's config.json: the shapes of the pp4
# config's target (an AutoAWQ g128 checkpoint of it)
CFG_70B = dict(vocab_size=128256, hidden_size=8192, intermediate_size=28672,
               num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
               rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
               rope_scaling=dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                                 original_max_position_embeddings=8192, rope_type="llama3"),
               tie_word_embeddings=False, eos_token_id=LLAMA3_EOS)
PP_STAGES = 4


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3, graph=True):
    """Mean time of fn() in ms. graph=True, how every kernel's `ms` and
    `library_ms` are timed (`timed_by` in the kernels line): `iters` calls
    captured in one CUDA graph and replayed between CUDA events, so the host's
    launch time is not counted (a kernel shorter than its launch would
    otherwise time the host); a call that cannot be captured raises.
    graph=False: CUDA events around `iters` back-to-back calls, which count
    the host's time per call where it is longer than the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not graph:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# how the kernels line's times were taken
TIMED_BY = ("cuda_graph: ms, plain_ms and library_ms are the mean of 20 calls captured in one "
            "CUDA graph, replayed between CUDA events (device time, no host launch cost)")


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


def attention_bound(torch, mask, limits, nH, KVH, D, int8):
    """bound() of masked attention: q [B, S, nH, D] read and out written in
    bf16, each slot's K and V columns below its limit read once (int8 plus an
    fp32 scale a column, or bf16) with their mask bytes; 4 * nH * D operations
    for each live query-key pair (mask true, column below the limit), since a
    causal or tree mask needs only those. mask [B, S, L] or [S, L]; limits
    one int a slot."""
    m = mask.reshape(-1, *mask.shape[-2:])
    B, S, L = m.shape
    below = torch.arange(L, device=m.device) < torch.as_tensor(
        limits, device=m.device).reshape(B, 1, 1)
    pairs = int((m & below).sum())
    cols = float(sum(limits))
    kv_b = 1 + 4 / D if int8 else 2  # bytes per cached value
    return bound(2 * B * S * nH * D * 2 + 2 * cols * KVH * D * kv_b + S * cols,
                 4 * nH * D * pairs, "bf16")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def check_tc_route(counts, tag):
    """Every attention launch of a bf16 path took the tensor-core kernel."""
    n = sum(counts[k] for k in ("attend_flash", "attend_flash_int8", "attend_flash_batched",
                                "attend_flash_batched_int8"))
    check(n > 0 and counts["attend_flash_scalar"] == 0,
          f"{tag}: {counts['attend_flash_scalar']} of {n} attention launches took the scalar "
          f"kernel (bf16 q must take the tensor-core kernel)")


def graph_stats(eng):
    """An engine's CUDA graphs of its decode step: how many steps were
    captured, their replays, capture ms, memory pool GB (in all and by
    device) and segments a step (one graph a run of phases on one device,
    or an eager run; the most of any captured step), and, for the static
    and dynamic engines, the no-op replays and the blocks of replays, each
    one host read."""
    graphs = list(getattr(eng, "_decode_graphs", getattr(eng, "_segment_graphs", {})).values())
    by_device = {}
    for g in graphs:
        for d, n in g.pool_bytes_by_device.items():
            by_device[str(d)] = by_device.get(str(d), 0.0) + n / 2**30
    res = dict(graphs=len(graphs), replays=sum(g.replays for g in graphs),
               capture_ms=sum(g.capture_ms for g in graphs),
               pool_gb=sum(g.pool_bytes for g in graphs) / 2**30, pool_gb_by_device=by_device,
               segments=max((g.segments for g in graphs), default=0))
    if hasattr(eng, "decode_stats"):
        res.update(noop_replays=eng.decode_stats["noop_replays"],
                   blocks=eng.decode_stats["blocks"])
    return res


# an offload target's captured step (JAX's `_offload_step`): the draft phase one
# graph, the streamed forward eager, the tail one graph reading the logits
# from a static buffer: (eager, phases, hops) of each segment
OFFLOAD_PLAN = [(False, ("draft",), ()), (True, ("streamed_forward",), ()),
                (False, ("commit", "compact0", "update"), ("logits",))]


def offload_plan(eng):
    """Every captured step of an engine is the offload plan."""
    return all([(e, n, h) for _, e, n, h in g.plan] == OFFLOAD_PLAN
               for g in eng._decode_graphs.values())


def check_graphed(eng, tag):
    """The engine decoded through captured CUDA graphs (a stepwise run fails)."""
    st = graph_stats(eng)
    check(st["graphs"] > 0 and st["replays"] > 0,
          f"{tag}: no CUDA graph was captured and replayed (the decode ran stepwise): {st}")
    return st


def stepwise(eng):
    """Make an engine take its eager loop, for a comparison with the graphs:
    a static or dynamic engine its stepwise loop (build_tree(); verify(), one
    host read a step), over an offload target its pipelined loop with the
    step's phases run eagerly (`_eager_decode_steps`), a batched engine its
    eager segments; `graphed(eng)` undoes it (call it before dropping an
    offload engine: the bound method would keep the engine in a cycle)."""
    if getattr(eng, "_offload", False):
        eng._run_decode_steps = eng._eager_decode_steps
    elif hasattr(eng, "_decode_graphs"):
        eng._can_decode_fused = lambda: False
    else:
        eng._run_segment = eng._segment_eager
    return eng


def graphed(eng):
    for name in ("_run_decode_steps", "_can_decode_fused", "_run_segment"):
        eng.__dict__.pop(name, None)
    return eng


# ---------------------------------------------------------------- phase 2


def kernel_checks(torch, dev):
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels.embed_gather import embed_gather, embed_gather_ref

    gen, randn, err = kernel_inputs(torch, dev)
    bf16, f32 = torch.bfloat16, torch.float32
    report = {}

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
        bound_ms=by, bound_by="bytes", launch_floor_ms=launch_floor_ms(torch, dev, 127))
    log(f"[kernels] embed_gather {report['embed_gather']}")
    del embed

    report.update(attention_checks(torch, dev, gen, randn, err))

    report.update(w4a8_checks(torch, dev, gen, randn, err))
    report.update(w4a16_checks(torch, dev, gen, randn, err))
    return report


def empty_kernel(torch, dev, S, n=1):
    """A function that launches n times a kernel that does nothing
    (csrc/embed_gather.cu `empty_launch`, `empty_rows`: S blocks of 256
    threads, embed_gather's launch at S rows) on dev's current stream."""
    import ctypes

    from umbrella_tpu_torch.ops.kernels import build

    fn = build.library("embed_gather").empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    anchor = torch.zeros(1, device=dev)

    def launch():
        with build.on_device(anchor) as st:
            for _ in range(n):
                build.check(fn(S, st), "empty_launch")

    return launch


def launch_floor_ms(torch, dev, S):
    """cuda_ms of the empty kernel launched as embed_gather launches at S
    rows, timed as every kernel is: the floor of one launch."""
    return cuda_ms(torch, empty_kernel(torch, dev, S))


def attention_phase(torch, dev):
    """The attention kernels alone (phase `attention`): the cheap loop for them."""
    gen, randn, err = kernel_inputs(torch, dev)
    return attention_checks(torch, dev, gen, randn, err)


def attention_checks(torch, dev, gen, randn, err):
    """The tree_attention family (csrc/tree_attention.cu): attend_flash at the
    verify shape (and the 70B verify shape), the int8 and batched kernels at
    the serving shapes, each against its plain version with timings; then
    the tensor-core kernel's properties: rows bit for bit the same across S
    and B, limit isolation, soft cap, empty rows, and the kernel each dtype
    takes."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels.tree_attention import attend_dense, attend_flash
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    report = {}
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

    by, bb = attention_bound(torch, mask, [kv_limit], nH, KVH, D, False)
    report["attend_flash"] = dict(
        shape=f"q [{S},32,128] bf16 vs [4,8,2048,128] cache, tree mask, kv_limit={kv_limit}",
        tolerance="max abs err <= 2e-2 * max|plain| (bf16 output; p rounded at other points)",
        max_abs_err=a_max, max_rel_err=a_rel,
        ms=cuda_ms(torch, lambda: attend_flash(q, kc, vc, mask, kv_limit, 3)),
        plain_ms=cuda_ms(torch, lambda: attend_dense(q, kc[3], vc[3], mask)),
        library_ms=library_ms(torch, sdpa), bound_ms=by, bound_by=bb)
    log(f"[kernels] attend_flash {report['attend_flash']}")
    del kc, vc
    torch.cuda.empty_cache()
    report["attend_flash"]["per_shape"] = {"70B verify q [127,64,128]": attention_70b_verify(
        torch, dev, randn, err), **attention_dynamic_shapes(torch, dev, randn, err)}
    torch.cuda.empty_cache()
    report.update(attention_int8_and_batched_checks(torch, dev, gen, randn, err))
    report["attend_flash"]["tensor_core_checks"] = attention_tc_checks(torch, dev, gen, randn, err)
    return report


def kernel_inputs(torch, dev):
    """The kernel checks' seeded generator, a randn(*shape, scale, dtype) on the
    card, and err(got, ref) -> (max abs err, max |ref|)."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()

    return gen, randn, err


def w4a16_phase(torch, dev):
    """The W4A16 family alone (phase `w4a16`): the cheap loop for its kernel."""
    gen, randn, err = kernel_inputs(torch, dev)
    return w4a16_checks(torch, dev, gen, randn, err)


def w4a16_checks(torch, dev, gen, randn, err):
    """The W4A16 kernel family (plain, layered, fused gate-up-SiLU), each held
    against its plain version, row invariance bitwise, and timings."""
    report = {}
    report.update(w4a16_plain_checks(torch, dev, gen, randn, err))
    report.update(gate_up_silu_checks(torch, dev, gen, randn, err))
    report.update(layered_kernel_checks(torch, dev, gen, randn, err))
    report["w4a16_matmul"]["row_invariance"] = w4a16_row_invariance(torch, dev, gen, randn)
    return report


def w4a16_bound(K, N, S, out_cols, G):
    """Least time for x [S, K] bf16 @ W4 [K, N] g128 -> [S, out_cols] bf16:
    packed weights, scales and zeros, x and y once; 2*S*K*N bf16 operations."""
    return bound(K // 2 * N + 2 * G * N * 2 + S * K * 2 + S * out_cols * 2, 2 * S * K * N,
                 "bf16")


# row counts that reach every token width the W4A16 kernel has: 32 (S <= 32),
# 64, 128, 192 and 256, and a second super-tile (S > 256)
W4A16_ROWS = (1, 24, 48, 127, 160, 224, 300)


def w4a16_plain_checks(torch, dev, gen, randn, err):
    """w4a16_matmul at the four 8B AWQ layer shapes, at every W4A16_ROWS row
    count, against the plain version with bf16 and fp32 output, and fp32 x
    with fp32 scales (the lossless phases' dtypes); the group size 32 at one
    shape (K split); times at S=24 (a draft level), 127 (a verify pass) and
    224 ([serve]'s rows), by graph replay (`ms`) and by events around
    back-to-back calls (`events_ms`, the host's launch cost included); the
    four 70B layer shapes at S=256 and 257 (the offload configs' verify),
    held and timed too.
    Library yardstick: torch.matmul on the pre-dequantized bf16 weight."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_dequant_halves_bf16, _plan, w4a16_matmul,
                                                      w4a16_matmul_ref)
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device

    bf16, f32 = torch.bfloat16, torch.float32
    w_max, w_rel, shapes_ms = 0.0, 0.0, {}
    for name, (K, N) in LAYER_SHAPES.items():
        q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
        for S in W4A16_ROWS:
            x = randn(S, K)
            for od, tol in ((f32, 1e-4), (bf16, 2 ** -7)):
                got = w4a16_matmul(x, q, out_dtype=od)
                ref = w4a16_matmul_ref(x, q, out_dtype=od)
                e, m = err(got, ref)
                check(e <= tol * m, f"w4a16 {name} S={S} {od}: err {e} vs max {m}")
                w_max, w_rel = max(w_max, e), max(w_rel, e / m)
        q32 = q._replace(scales=q.scales.float(), zeros=q.zeros.float())
        for S in W4A16_ROWS:
            x = randn(S, K, dtype=f32)
            e, m = err(w4a16_matmul(x, q32), w4a16_matmul_ref(x, q32))
            check(e <= 1e-4 * m, f"w4a16 {name} S={S} fp32 x/scales: err {e} vs max {m}")
            w_max, w_rel = max(w_max, e), max(w_rel, e / m)
        del q32
        w_deq = _dequant_halves_bf16(q)
        for S in (24, 127, 224):
            x = randn(S, K)
            by, bb = w4a16_bound(K, N, S, N, K // 128)
            shapes_ms[f"{name} S={S}"] = dict(
                splits=_plan(S, K, N, 1, 128)["splits"],
                ms=cuda_ms(torch, lambda: w4a16_matmul(x, q)),
                events_ms=cuda_ms(torch, lambda: w4a16_matmul(x, q), graph=False),
                plain_ms=cuda_ms(torch, lambda: w4a16_matmul_ref(x, q), iters=5),
                library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)),
                bound_ms=by, bound_by=bb)
            log(f"[kernels] w4a16_matmul {name} K={K} N={N} S={S} {shapes_ms[f'{name} S={S}']}")
        del q, w_deq
    torch.cuda.empty_cache()
    for name, (K, N) in LAYER_SHAPES_70B.items():  # the offload configs' verify: 257 rows
        q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
        w_deq = _dequant_halves_bf16(q)
        for S in (256, 257):
            x = randn(S, K)
            e, m = err(w4a16_matmul(x, q), w4a16_matmul_ref(x, q))
            check(e <= 2 ** -7 * m, f"w4a16 70B {name} S={S}: err {e} vs max {m}")
            w_max, w_rel = max(w_max, e), max(w_rel, e / m)
            by, bb = w4a16_bound(K, N, S, N, K // 128)
            shapes_ms[f"70B {name} S={S}"] = dict(
                splits=_plan(S, K, N, 1, 128)["splits"],
                ms=cuda_ms(torch, lambda: w4a16_matmul(x, q)),
                plain_ms=cuda_ms(torch, lambda: w4a16_matmul_ref(x, q), iters=5),
                library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)),
                bound_ms=by, bound_by=bb)
            log(f"[kernels] w4a16_matmul 70B {name} K={K} N={N} S={S} "
                f"{shapes_ms[f'70B {name} S={S}']}")
        del q, w_deq
    torch.cuda.empty_cache()
    g32 = w4a16_group32_checks(torch, dev, gen, randn, err)
    w_max, w_rel = max(w_max, g32["max_abs_err"]), max(w_rel, g32["max_rel_err"])
    exact = w4a16_dequant_exact(torch, dev, gen)
    return {"w4a16_matmul": dict(
        dequant_bit_exact=exact, group_size_32=g32,
        shape="x [127,4096] bf16 @ W4 [4096,28672] (gate_up), bf16 out",
        tolerance="max abs err <= 1e-4 * max|plain| (fp32 out), 2**-7 * max|plain| (bf16 out)",
        max_abs_err=w_max, max_rel_err=w_rel, per_shape=shapes_ms,
        **shapes_ms["gate_up S=127"])}


def w4a16_group32_checks(torch, dev, gen, randn, err):
    """The group size 32 (a group is half a stage): w4a16_matmul at the 8B wqkv
    shape (K split) and w4a16_gate_up_silu on the same weight as a gate|up
    pair, S=1, 24, 127 and 300, bf16 x with bf16 scales and fp32 x with fp32
    scales, against the plain versions."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_plan, w4a16_gate_up_silu,
                                                      w4a16_gate_up_silu_ref, w4a16_matmul,
                                                      w4a16_matmul_ref)
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device

    bf16, f32 = torch.bfloat16, torch.float32
    K, N = LAYER_SHAPES["wqkv"]
    q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 32, bf16)
    check(q.scales.shape[0] == K // 32, "w4a16 g32: the weight is not in groups of 32")
    forms = {bf16: q, f32: q._replace(scales=q.scales.float(), zeros=q.zeros.float())}
    e_max, e_rel = 0.0, 0.0
    for S in (1, 24, 127, 300):
        for xd, qq in forms.items():
            x = randn(S, K, dtype=xd)
            tol = 2 ** -7 if xd == bf16 else 1e-4
            for form, fn, ref in (("plain", w4a16_matmul, w4a16_matmul_ref),
                                  ("fused", w4a16_gate_up_silu, w4a16_gate_up_silu_ref)):
                e, m = err(fn(x, qq), ref(x, qq))
                check(e <= tol * m, f"w4a16 g32 {form} S={S} {xd}: err {e} vs max {m}")
                e_max, e_rel = max(e_max, e), max(e_rel, e / m)
    held = dict(shape=f"8B wqkv [{K},{N}] g32", splits=_plan(127, K, N, 1, 32)["splits"],
                max_abs_err=e_max, max_rel_err=e_rel)
    log(f"[kernels] w4a16 group size 32 (plain and fused, S=1, 24, 127, 300): {held}")
    return held


def w4a16_dequant_exact(torch, dev, gen):
    """eye(K) @ W through the kernel (fp32 out) equals the plain version's
    dequantized weight bit for bit: with bf16 scales and integer zeros (the
    kernel's packed bf16x2 form), the same in groups of 32, fp32 scales, and
    bf16 scales with zeros off the integers (both the fp32 form) -- at the 8B
    wo shape."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import _dequant_halves_bf16, w4a16_matmul
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device

    K, N = LAYER_SHAPES["wo"]
    q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128,
                             torch.bfloat16)
    eye = torch.eye(K, device=dev, dtype=torch.bfloat16)
    forms = {"bf16 scales, integer zeros": q,
             "bf16 scales, integer zeros, g32": quantize_pack_device(
                 torch.randn((K, N), generator=gen, device=dev) * 0.02, 32, torch.bfloat16),
             "fp32 scales": q._replace(scales=q.scales.float(), zeros=q.zeros.float()),
             "bf16 scales, zeros + 0.5": q._replace(zeros=q.zeros + 0.5)}
    held = {}
    for name, qq in forms.items():
        got = w4a16_matmul(eye, qq, out_dtype=torch.float32)
        held[name] = bool(torch.equal(got, _dequant_halves_bf16(qq).float()))
        check(held[name], f"w4a16 eye(K) @ W ({name}) differs from the dequantized weight")
    log(f"[kernels] w4a16 dequantization bit for bit (eye(K) @ W, 8B wo): {held}")
    return held


def w4a16_row_invariance(torch, dev, gen, randn):
    """Row j of S=300 equals row j at every other W4A16_ROWS count (each token
    width of the kernel), bitwise, for the
    plain mode, the layered mode (layer 1 of a stack of 2) and the fused
    gate-up-SiLU, with bf16 and fp32 x, at the 8B gate_up shape (unsplit) and
    the 70B wo shape (K split; for the fused form a gate|up pair of its
    width)."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import _plan, w4a16_gate_up_silu, w4a16_matmul
    from umbrella_tpu_torch.quantization.awq import AwqTensor, quantize_pack_device

    shapes = {"8B gate_up": LAYER_SHAPES["gate_up"], "70B wo": LAYER_SHAPES_70B["wo"]}
    held = {}
    for name, (K, N) in shapes.items():
        stack = [quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128,
                                      torch.bfloat16) for _ in range(2)]
        stack = AwqTensor(*(torch.stack([q[f] for q in stack]) for f in range(3)))
        plain = AwqTensor(*(t[1] for t in stack))
        idx = torch.tensor(1, dtype=torch.int32, device=dev)
        forms = {"plain": lambda x: w4a16_matmul(x, plain),
                 "layered": lambda x: w4a16_matmul(x, stack, layer_idx=idx),
                 "fused": lambda x: w4a16_gate_up_silu(x, plain)}
        for xd in (torch.bfloat16, torch.float32):
            x = randn(W4A16_ROWS[-1], K, dtype=xd)
            for form, fn in forms.items():
                whole = fn(x)
                for S in W4A16_ROWS[:-1]:
                    check(torch.equal(fn(x[:S].contiguous()), whole[:S]),
                          f"w4a16 {form} {name} {xd}: rows of S={S} differ from S=300's")
        held[name] = dict(splits=_plan(300, K, N, 1, 128)["splits"],
                          fused_splits=_plan(300, K, N // 2, 2, 128)["splits"])
        del stack, plain
        torch.cuda.empty_cache()
    check(any(v["splits"] > 1 for v in held.values()),
          "w4a16 row invariance: no shape splits K")
    rows = f"S={', '.join(map(str, W4A16_ROWS[:-1]))} vs {W4A16_ROWS[-1]}"
    log(f"[kernels] w4a16 row invariance held ({rows}; plain, layered, fused; bf16 and fp32 "
        f"x): {held}")
    return dict(rows=rows, forms=["plain", "layered", "fused"],
                x_dtypes=["bf16", "fp32"], shapes=held)


def gate_up_silu_checks(torch, dev, gen, randn, err):
    """w4a16_gate_up_silu at the 8B gate_up shape [4096, 28672], at every
    W4A16_ROWS row count, bf16 and fp32 x, against its plain version; times at
    S=24, 127 and 224 beside the plain mode's on the same weight (graph
    replay, and `events_ms` by events around back-to-back calls). Library
    yardstick: torch.matmul on the pre-dequantized bf16 weight + F.silu * mul."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_dequant_halves_bf16, w4a16_gate_up_silu,
                                                      w4a16_gate_up_silu_ref, w4a16_matmul)
    from umbrella_tpu_torch.quantization.awq import awq_gate_up_silu, quantize_pack_device

    bf16, f32 = torch.bfloat16, torch.float32
    K, N = LAYER_SHAPES["gate_up"]
    I, G = N // 2, K // 128
    q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
    w_deq = _dequant_halves_bf16(q)
    s_max, s_rel = 0.0, 0.0
    for S in W4A16_ROWS:
        for xd in (bf16, f32):
            x = randn(S, K, dtype=xd)
            e, m = err(w4a16_gate_up_silu(x, q), w4a16_gate_up_silu_ref(x, q))
            tol = 2 ** -7 if xd == bf16 else 1e-4
            check(e <= tol * m, f"w4a16_gate_up_silu S={S} {xd}: err {e} vs max {m}")
            s_max, s_rel = max(s_max, e), max(s_rel, e / m)
    xs = {S: randn(S, K) for S in (24, 127, 224)}
    gs_ms = {}
    for S, x in xs.items():
        def lib():
            gu = torch.matmul(x, w_deq)
            return F.silu(gu[:, :I]) * gu[:, I:]

        by, bb = w4a16_bound(K, N, S, I, G)
        gs_ms[f"S={S}"] = dict(
            ms=cuda_ms(torch, lambda: w4a16_gate_up_silu(x, q)),
            events_ms=cuda_ms(torch, lambda: w4a16_gate_up_silu(x, q), graph=False),
            plain_mode_ms=cuda_ms(torch, lambda: w4a16_matmul(x, q)),
            plain_ms=cuda_ms(torch, lambda: w4a16_gate_up_silu_ref(x, q), iters=5),
            library_ms=cuda_ms(torch, lib), bound_ms=by, bound_by=bb)
    log(f"[kernels] w4a16_gate_up_silu gate_up {gs_ms}")
    # no shipped config reaches the fused form (nor does the JAX package's
    # default): its launches come from awq_gate_up_silu(fused=True), the opt-in
    reset_launch_counts()
    for x in xs.values():
        awq_gate_up_silu(x, q, fused=True)
    torch.cuda.synchronize()
    fused_counts = launch_counts()
    check(fused_counts["w4a16_gate_up_silu"] == len(xs),
          f"awq_gate_up_silu(fused=True) launched {fused_counts['w4a16_gate_up_silu']} kernels")
    del q, w_deq
    torch.cuda.empty_cache()
    return {"w4a16_gate_up_silu": dict(
        shape="x [127,4096] bf16 @ packed W4 gate|up [4096,28672] -> [127,14336] bf16",
        tolerance="max abs err <= 2**-7 * max|plain| (bf16 out), 1e-4 * max|plain| (fp32 x)",
        max_abs_err=s_max, max_rel_err=s_rel, per_shape=gs_ms, launches=fused_counts,
        launches_per_step={"w4a16_gate_up_silu": None}, **gs_ms["S=127"])}


def layered_kernel_checks(torch, dev, gen, randn, err):
    """w4a16_matmul's layered mode on a stack of 4 layers at each of the 70B
    layer shapes (wqkv, wo, gate_up, down; g128), S=127 (a verify pass) and
    S=24 (a draft level): on every layer equal to the plain mode on that layer
    bit for bit, and within 2**-7 x max|y| of the plain version (bf16 out).
    wo and down split K over blocks (partial sums, then a fixed-order
    reduction), wqkv and gate_up do not: both routes are held. An index past
    the stack traps (in a child process: a trap ends the CUDA context). Times
    beside the plain mode's on the same layer; library yardstick: torch.matmul
    on the pre-dequantized bf16 layer; `events_ms` by events around
    back-to-back calls (the host's launch cost included). The reported row is
    gate_up."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_dequant_halves_bf16, _plan, select_layer,
                                                      w4a16_matmul, w4a16_matmul_ref)
    from umbrella_tpu_torch.quantization.awq import AwqTensor, quantize_pack_device

    bf16 = torch.bfloat16
    n = 4
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    e_max, e_rel, per_shape = 0.0, 0.0, {}
    for name, (K, N) in LAYER_SHAPES_70B.items():
        G = K // 128
        splits = _plan(127, K, N, 1, 128)["splits"]
        stacked = [quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02,
                                        128, bf16) for _ in range(n)]
        stacked = AwqTensor(*(torch.stack([q[f] for q in stacked]) for f in range(3)))
        for S in (127, 24):
            x = randn(S, K)
            for i in range(n):
                got = w4a16_matmul(x, stacked, layer_idx=idx[i])
                plain = w4a16_matmul(x, AwqTensor(*(t[i] for t in stacked)))
                check(torch.equal(got, plain), f"w4a16 layered {name} S={S} layer {i}: differs "
                      "from the plain mode on that layer")
                e, m = err(got, w4a16_matmul_ref(x, select_layer(stacked, idx[i])))
                check(e <= 2 ** -7 * m, f"w4a16 layered {name} S={S} layer {i}: err {e} vs "
                      f"max {m}")
                e_max, e_rel = max(e_max, e), max(e_rel, e / m)
            layer2 = AwqTensor(*(t[2] for t in stacked))
            w_deq = _dequant_halves_bf16(layer2)
            by, bb = w4a16_bound(K, N, S, N, G)
            per_shape[f"{name} S={S}"] = dict(
                K=K, N=N, splits=splits,
                ms=cuda_ms(torch, lambda: w4a16_matmul(x, stacked, layer_idx=idx[2])),
                events_ms=cuda_ms(torch, lambda: w4a16_matmul(x, stacked, layer_idx=idx[2]),
                                  graph=False),
                plain_mode_ms=cuda_ms(torch, lambda: w4a16_matmul(x, layer2)),
                plain_ms=cuda_ms(torch,
                                 lambda: w4a16_matmul_ref(x, select_layer(stacked, idx[2])),
                                 iters=5),
                library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)), bound_ms=by,
                bound_by=bb)
            log(f"[kernels] w4a16_matmul_layered {name} 70B S={S} {per_shape[f'{name} S={S}']}")
            del w_deq
        del stacked
        torch.cuda.empty_cache()
    check(any(v["splits"] > 1 for v in per_shape.values())
          and any(v["splits"] == 1 for v in per_shape.values()),
          "w4a16 layered: the 70B shapes no longer cover both the split-K and the unsplit route")
    trapped = layered_index_trap()
    log(f"[kernels] w4a16_matmul_layered index past the stack: {trapped}")
    check(trapped.startswith("trapped"), "w4a16 layered: an index past the stack did not trap")
    return {"w4a16_matmul_layered": dict(
        shape="x [127,8192] bf16 @ layer 2 of a W4 stack [4,8192,57344] (70B gate_up), bf16 out",
        tolerance="equal to the plain mode on the same layer bit for bit, on each of 4 layers "
                  "at all four 70B layer shapes, S=127 and S=24; max abs err <= "
                  "2**-7 * max|plain| (bf16 out)",
        max_abs_err=e_max, max_rel_err=e_rel, bitwise_equal_to_plain_mode=True,
        out_of_range_index=trapped, per_shape=per_shape, **per_shape["gate_up S=127"])}


_TRAP_CHILD = """
import os, sys, torch
sys.path.insert(0, os.getcwd())
from umbrella_tpu_torch.ops.kernels.w4a16 import w4a16_matmul
from umbrella_tpu_torch.quantization.awq import AwqTensor
dev = torch.device("cuda:0")
q = AwqTensor(torch.zeros((2, 128, 256), dtype=torch.int8, device=dev),
              torch.ones((2, 2, 256), device=dev), torch.zeros((2, 2, 256), device=dev))
x = torch.ones((4, 256), device=dev)
try:
    w4a16_matmul(x, q, layer_idx=torch.tensor(2, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    print("ran", flush=True)
except RuntimeError as e:
    print("trapped:", str(e).splitlines()[0], flush=True)
os._exit(0)
"""


def layered_index_trap():
    """Launch the layered kernel with layer index 2 on a stack of 2 in a child
    process; returns what it printed ("trapped: <the CUDA error>" when the
    kernel stopped at the index)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _TRAP_CHILD], cwd=here, capture_output=True,
                         text=True, timeout=300)
    lines = (out.stdout + out.stderr).strip().splitlines()
    return next((ln for ln in lines if ln.startswith(("trapped", "ran"))),
                f"rc {out.returncode}: {lines[-1] if lines else ''}")


def w4a8_phase(torch, dev):
    """The int8 W4 kernels alone (phase `w4a8`): the cheap loop for them."""
    gen, randn, err = kernel_inputs(torch, dev)
    return w4a8_checks(torch, dev, gen, randn, err)


# row counts that reach every token width of the int8 kernel (Int4F 32, 64,
# 128, 192 and 256; AWQ 32 and 64) and its super-tiles; Int4F up to
# INT8_KERNEL_MAX_TOKENS, AWQ up to a 512-token prefill chunk
W4A8F_ROWS = (1, 24, 48, 127, 160, 224, 300, 384)
W4A8_ROWS = (1, 24, 48, 127, 160, 224, 300, 512)


def w4a8_checks(torch, dev, gen, randn, err):
    """The int8 W4 kernel family (csrc/w4a8.cu): the fused quantizer, the Int4F
    and the AWQ products, each held bit for bit against its plain version, rows
    of every S bit for bit the same rows of the largest S, and timings."""
    report = {}
    report.update(w4a8_quantize_checks(torch, dev, gen, randn))
    report.update(w4a8f_checks(torch, dev, gen, randn, err))
    report.update(w4a8_awq_checks(torch, dev, gen, randn, err))
    report["w4a8_matmul"]["ragged_k"] = w4a8_ragged_k_checks(torch, dev, gen, randn, err)
    return report


def w4a8_ragged_k_checks(torch, dev, gen, randn, err):
    """K/2 = 160: the last stage holds one k32 step of two. w4a8f_matmul and
    w4a8_matmul (g32, and g160: groups of 5 steps, which start and end
    half-way through stages) at [320, 256], every row count of W4A8F_ROWS /
    W4A8_ROWS: bit for bit the plain versions, rows of every S equal to the
    largest S's."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import w4a8_matmul, w4a8_matmul_ref
    from umbrella_tpu_torch.ops.kernels.w4a8f import w4a8f_matmul, w4a8f_matmul_ref
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device
    from umbrella_tpu_torch.quantization.int4f import quantize_int4f

    K, N = 320, 256
    w = torch.randn((K, N), generator=gen, device=dev) * 0.02
    cases = {"int4f": (w4a8f_matmul, w4a8f_matmul_ref, quantize_int4f(w, 32, refine=0),
                       W4A8F_ROWS)}
    for gs in (32, 160):
        cases[f"awq g{gs}"] = (w4a8_matmul, w4a8_matmul_ref,
                               quantize_pack_device(w, gs, torch.bfloat16), W4A8_ROWS)
    for name, (fn, ref_fn, q, rows) in cases.items():
        x = randn(rows[-1], K)
        ref, whole = ref_fn(x, q), fn(x, q)
        for S in rows:
            got = whole if S == rows[-1] else fn(x[:S].contiguous(), q)
            check(torch.equal(got, ref[:S]), f"w4a8 ragged K {name} S={S}: max abs err "
                  f"{err(got, ref[:S])[0]} (must be exact)")
            check(torch.equal(got, whole[:S]), f"w4a8 ragged K {name} S={S}: rows differ")
    held = f"[{K},{N}]: {', '.join(cases)} exact and row-invariant"
    log(f"[kernels] w4a8 ragged K/2 (last stage one step): {held}")
    return held


def w4a8_quantize_checks(torch, dev, gen, randn):
    """The fused quantizer (one launch: xq, sx and the row sums) bit for bit
    the plain quantizers: x * a with the whole row's sum (Int4F) and x with
    sums per group of 128 and 32 (AWQ), K = 4096 and 14336, bf16 and fp32 x,
    S = 1, 24, 127 and 384. Timed at the Int4F lm_head's call, x [127, 4096]
    bf16."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import (group_rowsums, quantize_activations_w4a8,
                                                     quantize_rows)
    from umbrella_tpu_torch.ops.kernels.w4a8f import quantize_activations_int8

    held = 0
    for K in (4096, 14336):
        a = torch.rand(K, generator=gen, device=dev) + 0.5
        for S in (1, 24, 127, 384):
            for xd in (torch.bfloat16, torch.float32):
                x = randn(S, K, dtype=xd) * torch.rand(S, 1, generator=gen, device=dev).to(xd) * 8
                xq, sx, rs = quantize_rows(x, a)
                rq, rsx, rrs = quantize_activations_int8(x, a)
                check(torch.equal(xq, rq) and torch.equal(sx, rsx[:, 0]) and torch.equal(rs, rrs),
                      f"w4a8_quantize Int4F K={K} S={S} {xd}: differs from the plain version")
                rq, rsx = quantize_activations_w4a8(x)
                for gs in (128, 32):
                    xq, sx, rs = quantize_rows(x, None, gs)
                    check(torch.equal(xq, rq) and torch.equal(sx, rsx[:, 0])
                          and torch.equal(rs, group_rowsums(rq, gs)),
                          f"w4a8_quantize AWQ g{gs} K={K} S={S} {xd}: differs from the plain "
                          "version")
                held += 3
    S, K = 127, 4096
    x, a = randn(S, K), torch.rand(K, generator=gen, device=dev) + 0.5
    by, bb = bound(S * K * 2 + K * 4 + S * K + S * 4 + S * 4, 0, "int8")
    row = dict(
        shape="x [127,4096] bf16 * a -> xq int8, sx fp32, rowsum int32 (the Int4F lm_head's call)",
        tolerance="bit for bit (xq, sx and the row sums equal the plain quantizer's)",
        max_abs_err=0.0, cases_held=held,
        ms=cuda_ms(torch, lambda: quantize_rows(x, a)),
        events_ms=cuda_ms(torch, lambda: quantize_rows(x, a), graph=False),
        plain_ms=cuda_ms(torch, lambda: quantize_activations_int8(x, a)),
        library_ms=None, bound_ms=by, bound_by=bb)
    log(f"[kernels] w4a8_quantize {row}")
    return {"w4a8_quantize": row}


def w4a8f_checks(torch, dev, gen, randn, err):
    """w4a8f_matmul at the four 8B layer shapes and the lm_head, bf16 x with fp32
    and bf16 output at every W4A8F_ROWS count, and fp32 x at S=1, 127 and 384:
    equal to the plain version bit for bit (exact integer sums, the same fp32
    epilogue), and the rows of every S equal to the same rows of S=384. Times
    at S=24 (a draft level), 127 (a verify pass) and 224 ([serve-config]'s
    rows), by graph replay (`ms`) and by events around back-to-back calls
    (`events_ms`, the host's time per call included). Library yardstick:
    torch._int_mm on the unpacked int8 weight."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import _plan
    from umbrella_tpu_torch.ops.kernels.w4a8f import (quantize_activations_int8, w4a8f_matmul,
                                                      w4a8f_matmul_ref)
    from umbrella_tpu_torch.quantization.int4f import quantize_int4f

    bf16, f32 = torch.bfloat16, torch.float32
    big = W4A8F_ROWS[-1]
    per_shape, splits = {}, {}
    for name, (K, N) in dict(LAYER_SHAPES, lm_head=(4096, CFG_8B["vocab_size"])).items():
        q = quantize_int4f(torch.randn((K, N), generator=gen, device=dev) * 0.02, refine=0)
        splits[name] = _plan(1, K, N)["splits"]
        cases = [(bf16, f32, W4A8F_ROWS), (bf16, bf16, W4A8F_ROWS), (f32, f32, (1, 127, big))]
        for xd, od, rows in cases:
            x = randn(big, K, dtype=xd)
            ref = w4a8f_matmul_ref(x, q, out_dtype=od)
            whole = w4a8f_matmul(x, q, out_dtype=od)
            for S in rows:
                got = whole if S == big else w4a8f_matmul(x[:S].contiguous(), q, out_dtype=od)
                check(torch.equal(got, ref[:S]), f"w4a8f {name} S={S} x {xd} out {od}: max abs "
                      f"err {err(got, ref[:S])[0]} (must be exact)")
                check(torch.equal(got, whole[:S]),
                      f"w4a8f {name} S={S} x {xd} out {od}: rows differ from S={big}'s")
            del ref, whole
        w32 = q.w8.to(torch.int32)
        w_int8 = torch.cat([(w32 & 0xF) - 8, ((w32 >> 4) & 0xF) - 8]).to(torch.int8)
        del w32
        od = f32 if name == "lm_head" else bf16
        for S in (24, 127, 224):
            x = randn(S, K)
            xq = quantize_activations_int8(x, q.a)[0]
            by, bb = bound(S * K * 2 + K // 2 * N + N * 4 + K * 4 + S * N * od.itemsize,
                           2 * S * K * N, "int8")
            per_shape[f"{name} S={S}"] = dict(
                splits=splits[name], token_width=_plan(S, K, N)["token_width"],
                ms=cuda_ms(torch, lambda: w4a8f_matmul(x, q, out_dtype=od)),
                events_ms=cuda_ms(torch, lambda: w4a8f_matmul(x, q, out_dtype=od), graph=False),
                plain_ms=cuda_ms(torch, lambda: w4a8f_matmul_ref(x, q, out_dtype=od), iters=3,
                                 warmup=1),
                library_ms=library_ms(torch, lambda: torch._int_mm(xq, w_int8)),
                bound_ms=by, bound_by=bb)
            log(f"[kernels] w4a8f_matmul {name} K={K} N={N} S={S} {per_shape[f'{name} S={S}']}")
        del q, w_int8
        torch.cuda.empty_cache()
    check(any(v > 1 for v in splits.values()) and any(v == 1 for v in splits.values()),
          "w4a8f: the shapes no longer cover both the split-K and the unsplit route")
    rows = f"S={', '.join(map(str, W4A8F_ROWS))}"
    log(f"[kernels] w4a8f_matmul exact and row-invariant ({rows}; splits {splits})")
    return {"w4a8f_matmul": dict(
        shape="x [24,4096] bf16 @ Int4F [4096,128256] (lm_head at a draft level), fp32 out",
        tolerance=f"bit for bit the plain version (max abs err 0.0) at the 8B layer shapes and "
                  f"the lm_head, {rows}, bf16 and fp32 out; rows of every S equal to S={big}'s",
        max_abs_err=0.0, max_rel_err=0.0, splits_by_shape=splits, row_invariance=rows,
        per_shape=per_shape, **per_shape["lm_head S=24"])}


def w4a8_awq_checks(torch, dev, gen, randn, err):
    """w4a8_matmul at the 8B gate_up shape and the 8B down shape (K split 4
    ways), group sizes 128 and 32, bf16 and fp32 scales, fp32 zeros off the
    integers (the kernel's other fix-up), bf16 and fp32 x (out in x's dtype),
    at every W4A8_ROWS count: equal to the plain version bit for
    bit (exact integer products, the same fp32 fix-up order and split order),
    and the rows of every S equal to the same rows of S=512. Times at gate_up
    g128 S=24 and 127 (graph replay and events), beside w4a16_matmul on the
    same weight. Library yardstick: torch.matmul on the pre-dequantized bf16
    weight."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import _plan, w4a8_matmul, w4a8_matmul_ref
    from umbrella_tpu_torch.ops.kernels.w4a16 import _dequant_halves_bf16, w4a16_matmul
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device

    bf16, f32 = torch.bfloat16, torch.float32
    big = W4A8_ROWS[-1]
    splits, held = {}, 0
    for name in ("gate_up", "down"):
        K, N = LAYER_SHAPES[name]
        for gs in (128, 32):
            qb = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, gs,
                                      bf16)
            splits[f"{name} g{gs}"] = _plan(1, K, N, gs)["splits"]
            # integer zeros go into the weight bytes; zeros off the integers take
            # the kernel's row-sum fix-up
            forms = {"bf16": qb, "fp32": qb._replace(scales=qb.scales.float(),
                                                     zeros=qb.zeros.float()),
                     "fp32, zeros + 0.5,": qb._replace(scales=qb.scales.float(),
                                                       zeros=qb.zeros.float() + 0.5)}
            for sd, q in forms.items():
                for xd in (bf16, f32):
                    x = randn(big, K, dtype=xd)
                    ref = w4a8_matmul_ref(x, q)
                    whole = w4a8_matmul(x, q)
                    for S in W4A8_ROWS:
                        got = whole if S == big else w4a8_matmul(x[:S].contiguous(), q)
                        tag = f"w4a8 {name} g{gs} {sd} scales, x {xd}, S={S}"
                        check(torch.equal(got, ref[:S]),
                              f"{tag}: max abs err {err(got, ref[:S])[0]} (must be exact)")
                        check(torch.equal(got, whole[:S]), f"{tag}: rows differ from S={big}'s")
                        held += 1
                    del ref, whole
            del qb, forms
            torch.cuda.empty_cache()
    check(any(v > 1 for v in splits.values()) and any(v == 1 for v in splits.values()),
          "w4a8: the shapes no longer cover both the split-K and the unsplit route")
    K, N = LAYER_SHAPES["gate_up"]
    G = K // 128
    q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
    w_deq = _dequant_halves_bf16(q)
    w8_ms = {}
    for S in (24, 127):
        x = randn(S, K)
        by, bb = bound(K // 2 * N + 2 * G * N * 2 + S * K * 2 + S * N * 2, 2 * S * K * N, "int8")
        w8_ms[f"S={S}"] = dict(
            token_width=_plan(S, K, N, 128)["token_width"], splits=splits["gate_up g128"],
            ms=cuda_ms(torch, lambda: w4a8_matmul(x, q)),
            events_ms=cuda_ms(torch, lambda: w4a8_matmul(x, q), graph=False),
            plain_ms=cuda_ms(torch, lambda: w4a8_matmul_ref(x, q), iters=3, warmup=1),
            library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)),
            w4a16_ms=cuda_ms(torch, lambda: w4a16_matmul(x, q)),
            bound_ms=by, bound_by=bb)
    log(f"[kernels] w4a8_matmul gate_up {w8_ms}")
    del q, w_deq
    torch.cuda.empty_cache()
    rows = f"S={', '.join(map(str, W4A8_ROWS))}"
    log(f"[kernels] w4a8_matmul exact and row-invariant ({held} cases, {rows}; splits {splits})")
    return {"w4a8_matmul": dict(
        shape="x [127,4096] bf16 @ W4 [4096,28672] g128 (gate_up), int8 activations, bf16 out",
        tolerance=f"bit for bit the plain version (max abs err 0.0) at 8B gate_up and down, "
                  f"g128 and g32, bf16 and fp32 scales and x, integer zeros and zeros + 0.5, "
                  f"{rows}; rows of every S equal to S={big}'s",
        max_abs_err=0.0, max_rel_err=0.0, cases_held=held, splits_by_shape=splits,
        row_invariance=rows, per_shape=w8_ms, **w8_ms["S=127"])}


def attention_int8_and_batched_checks(torch, dev, gen, randn, err):
    """attend_flash_int8, attend_flash_batched and attend_flash_batched_int8 at
    the serving paths' shapes, each against its plain version on the same
    inputs. Library yardstick: F.scaled_dot_product_attention with a bool mask
    over the live columns (one call), after a dequantizing call for int8 KV
    (two calls, timed together)."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.models.kv_cache import _quantize_block
    from umbrella_tpu_torch.ops.kernels.tree_attention import (
        attend_flash_batched, attend_flash_batched_ref, attend_flash_int8, attend_flash_ref)
    from umbrella_tpu_torch.ops.masks import (causal_mask_rows, tree_mask_rows,
                                              tree_mask_rows_batched)
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    nH, KVH, D, L = 32, 8, 128, MAX_LEN
    tol = "max abs err <= 2e-2 * max|plain| (bf16 output; p rounded at other points)"
    report = {}

    def cache(shape, int8):
        """Random K or V at `shape` (+D): bf16, or int8 with fp32 per-row scales."""
        x = randn(*shape, D)
        if not int8:
            return x, None
        q, s = _quantize_block(x)
        return q, s

    def check_pair(name, got, ref):
        e, m = err(got, ref)
        check(e <= 2e-2 * m, f"{name}: err {e} vs max {m}")
        return e, e / m

    def library(q, k, v, ks, vs, mask, live):
        """F.scaled_dot_product_attention over the first `live` columns of one
        layer's per-slot caches [B, KVH, L, D] (dequantized first for int8)."""
        qs = q.transpose(1, 2)
        msk = mask[:, None, :, :live]

        def deq():
            if ks is None:
                return k[:, :, :live], v[:, :, :live]
            return ((k[:, :, :live].float() * ks[:, :, :live, None]).to(q.dtype),
                    (v[:, :, :live].float() * vs[:, :, :live, None]).to(q.dtype))

        def run():
            kd, vd = deq()
            return F.scaled_dot_product_attention(qs, kd, vd, attn_mask=msk, enable_gqa=True)

        return library_ms(torch, run)

    def bound_of(mask, limits, int8):
        return attention_bound(torch, mask, limits, nH, KVH, D, int8)

    # -- attend_flash_int8: single slot, q [127, 32, 128] at kv_limit 428 (row 1's shape)
    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    nn, S = 301, gm.size
    kq, ks = cache((2, KVH, L), True)
    vq, vs = cache((2, KVH, L), True)
    mask = tree_mask_rows(nn, torch.as_tensor(gm.bitmap, device=dev), L)
    a_max, a_rel = 0.0, 0.0
    for S_, msk in ((S, mask), (1, causal_mask_rows(nn, 1, L, device=dev))):
        q = randn(S_, nH, D)
        for layer in (0, 1):
            got = attend_flash_int8(q, kq, vq, ks, vs, msk, nn + S_, layer)
            ref = attend_flash_ref(q, kq[layer], vq[layer], msk, nn + S_,
                                   k_scale=ks[layer], v_scale=vs[layer])
            e, r = check_pair(f"attend_flash_int8 S={S_} layer={layer}", got, ref)
            a_max, a_rel = max(a_max, e), max(a_rel, r)
    q = randn(S, nH, D)
    limit = nn + S
    by, bb = bound_of(mask, [limit], True)
    report["attend_flash_int8"] = dict(
        shape=f"q [{S},32,128] bf16 vs int8 [2,8,2048,128] cache + fp32 scales, tree mask, "
              f"kv_limit={limit}",
        tolerance=tol, max_abs_err=a_max, max_rel_err=a_rel,
        ms=cuda_ms(torch, lambda: attend_flash_int8(q, kq, vq, ks, vs, mask, limit, 1)),
        plain_ms=cuda_ms(torch, lambda: attend_flash_ref(q, kq[1], vq[1], mask, limit,
                                                         k_scale=ks[1], v_scale=vs[1]),
                         graph=False),
        # the plain version copies a host tensor, which a CUDA graph cannot capture
        plain_timed_by="events around 20 back-to-back calls (host time included)",
        library_ms=library(q[None], kq[1][None], vq[1][None], ks[1][None], vs[1][None],
                           mask[None], limit),
        library="dequantize (1 call) + scaled_dot_product_attention (1 call)",
        bound_ms=by, bound_by=bb)
    log(f"[kernels] attend_flash_int8 {report['attend_flash_int8']}")
    del kq, vq, ks, vs

    def batched_case(name, B, Bc, tree, int8, slot_S):
        """Decode shape (B slots, a `tree` growmap per slot, kv limits spread over
        135-300) and the one-slot prefill shape (q [1, slot_S] through `slots`)."""
        g = growmap_from_spec(*tree)
        T = g.size
        kc, ksc = cache((2, Bc, KVH, L), int8)
        vc, vsc = cache((2, Bc, KVH, L), int8)
        limits = torch.randint(135, 301, (B,), generator=gen, device=dev, dtype=torch.int32)
        nn = limits - T
        mask = tree_mask_rows_batched(nn, torch.as_tensor(g.bitmap, device=dev), L)
        q = randn(B, T, nH, D)
        scales = dict(k_scale=ksc, v_scale=vsc) if int8 else {}
        m_max, m_rel = 0.0, 0.0
        for layer in (0, 1):
            got = attend_flash_batched(q, kc, vc, mask, limits, layer, **scales)
            ref = attend_flash_batched_ref(q, kc, vc, mask, limits, layer, **scales)
            e, r = check_pair(f"{name} B={B} layer={layer}", got, ref)
            m_max, m_rel = max(m_max, e), max(m_rel, r)
        # prefill through the slot indirection: q [1, slot_S] into cache row 5
        qp = randn(1, slot_S, nH, D)
        pm = causal_mask_rows(0, slot_S, L, device=dev)[None]
        lim1 = torch.full((1,), slot_S, dtype=torch.int32, device=dev)
        slot = torch.full((1,), 5, dtype=torch.int32, device=dev)
        got = attend_flash_batched(qp, kc, vc, pm, lim1, 1, slots=slot, **scales)
        ref = attend_flash_batched_ref(qp, kc, vc, pm, lim1, 1, slots=slot, **scales)
        e, r = check_pair(f"{name} slots prefill S={slot_S}", got, ref)
        m_max, m_rel = max(m_max, e), max(m_rel, r)

        lims = limits.tolist()
        live = max(lims)
        per_slot = lambda t: None if t is None else t[1]  # noqa: E731
        by, bb = bound_of(mask, lims, int8)
        dec = dict(
            ms=cuda_ms(torch, lambda: attend_flash_batched(q, kc, vc, mask, limits, 1, **scales)),
            plain_ms=cuda_ms(torch, lambda: attend_flash_batched_ref(q, kc, vc, mask, limits, 1,
                                                                     **scales)),
            library_ms=library(q, kc[1], vc[1], per_slot(ksc), per_slot(vsc), mask, live),
            bound_ms=by, bound_by=bb)
        pby, pbb = bound_of(pm, [slot_S], int8)
        pick = (lambda t: None if t is None else t[1, 5:6])  # noqa: E731
        pre = dict(
            ms=cuda_ms(torch, lambda: attend_flash_batched(qp, kc, vc, pm, lim1, 1, slots=slot,
                                                           **scales)),
            plain_ms=cuda_ms(torch, lambda: attend_flash_batched_ref(qp, kc, vc, pm, lim1, 1,
                                                                     slots=slot, **scales)),
            library_ms=library(qp, kc[1, 5:6], vc[1, 5:6], pick(ksc), pick(vsc), pm, slot_S),
            bound_ms=pby, bound_by=pbb)
        kind = "int8 [2,%d,8,2048,128] + fp32 scales" % Bc if int8 else \
            "bf16 [2,%d,8,2048,128]" % Bc
        res = dict(
            shape=f"q [{B},{T},32,128] bf16 vs {kind} cache, {tree[0]}x{tree[1]} tree masks, "
                  f"kv_limits {min(lims)}-{max(lims)}",
            tolerance=tol, max_abs_err=m_max, max_rel_err=m_rel,
            library=("dequantize (1 call) + scaled_dot_product_attention (1 call)" if int8
                     else "scaled_dot_product_attention (1 call), bool mask"),
            per_shape={"decode": dec, f"prefill q [1,{slot_S}] via slots": pre}, **dec)
        log(f"[kernels] {name} {res}")
        return res

    report["attend_flash_batched_int8"] = batched_case(
        "attend_flash_batched_int8", 32, 32, (2, 3), True, 512)
    torch.cuda.empty_cache()
    report["attend_flash_batched"] = batched_case(
        "attend_flash_batched", 8, 8, (3, 4), False, 512)
    torch.cuda.empty_cache()
    return report


def attention_at(torch, dev, randn, err, tag, nH, KVH, D, L, mask, limit):
    """attend_flash at one shape: q [S, nH, D] bf16 against a [2, KVH, L, D]
    bf16 cache (layers 0 and 1 held against the plain version, 2e-2 of its
    max), timed beside its plain version, SDPA and its bound."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels.tree_attention import attend_dense, attend_flash

    S = mask.shape[0]
    kc, vc = randn(2, KVH, L, D), randn(2, KVH, L, D)
    q = randn(S, nH, D)
    e_max, e_rel = 0.0, 0.0
    for layer in (0, 1):
        e, m = err(attend_flash(q, kc, vc, mask, limit, layer),
                   attend_dense(q, kc[layer], vc[layer], mask))
        check(e <= 2e-2 * m, f"attend_flash {tag} layer={layer}: err {e} vs max {m}")
        e_max, e_rel = max(e_max, e), max(e_rel, e / m)
    qs = q.transpose(0, 1)[None]
    ks, vs, ms_ = kc[1:2, :, :limit], vc[1:2, :, :limit], mask[None, None, :, :limit]
    by, bb = attention_bound(torch, mask, [limit], nH, KVH, D, False)
    res = dict(
        shape=f"q [{S},{nH},{D}] bf16 vs [2,{KVH},{L},{D}] cache (groups {nH // KVH}), "
              f"kv_limit={limit}",
        max_abs_err=e_max, max_rel_err=e_rel,
        ms=cuda_ms(torch, lambda: attend_flash(q, kc, vc, mask, limit, 1)),
        plain_ms=cuda_ms(torch, lambda: attend_dense(q, kc[1], vc[1], mask)),
        library_ms=library_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=ms_, enable_gqa=True)),
        bound_ms=by, bound_by=bb)
    log(f"[kernels] attend_flash {tag} {res}")
    return res


def attention_70b_verify(torch, dev, randn, err):
    """attend_flash at the 70B verify shape that [pp-config] runs 80 times a
    step: q [127, 64, 128] against 8 kv heads (groups 8) of a [2, 8, 8192, 128]
    bf16 cache (the pp4 config's max_length), the 24x6 tree mask at kv_limit
    428."""
    from umbrella_tpu_torch.ops.masks import tree_mask_rows
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    nn = 301
    mask = tree_mask_rows(nn, torch.as_tensor(gm.bitmap, device=dev), 8192)
    return attention_at(torch, dev, randn, err, "70B verify", CFG_70B["num_attention_heads"],
                        CFG_70B["num_key_value_heads"], 128, 8192, mask, nn + gm.size)


def attention_dynamic_shapes(torch, dev, randn, err):
    """attend_flash at the offload configs' shapes (max_length 8192, the
    prompt's 128 slots committed): the 70B target's 257-row verify over a
    16 x 16 dynamic tree, q [257, 64, 128], and a 1B draft level of 16 rows
    (level 8 of that tree), q [16, 32, 64] against 8 kv heads of head dim 64."""
    from umbrella_tpu_torch.ops.masks import tree_level_mask_rows, tree_mask_rows

    W, Dp = DYN_TREE["width"], DYN_TREE["depth"]
    bm = dynamic_bitmap(torch, dev, W, Dp, 2)
    nn, T = PROMPT_LEN, W * Dp + 1
    lvl = 8
    start = 1 + (lvl - 1) * W
    return {
        "70B dynamic verify q [257,64,128]": attention_at(
            torch, dev, randn, err, "70B dynamic verify", CFG_70B["num_attention_heads"],
            CFG_70B["num_key_value_heads"], 128, 8192, tree_mask_rows(nn, bm, 8192), nn + T),
        "1B draft level q [16,32,64]": attention_at(
            torch, dev, randn, err, "1B draft level", CFG_1B["num_attention_heads"],
            CFG_1B["num_key_value_heads"], CFG_1B["head_dim"], 8192,
            tree_level_mask_rows(nn, bm, start, W, 8192), nn + start + W)}


def attention_tc_checks(torch, dev, gen, randn, err):
    """What the tensor-core kernel (bf16 q) must hold beyond its tolerance,
    each for bf16 and int8 KV (8B widths, [2, (Bc,) 8, 2048, 128] caches):
    - which kernel: fp32 q and head dim 32 take the scalar kernel, bf16 q at
      head dim 128 the tensor-core kernel;
    - row invariance, bitwise: rows of S = 1, 24 and 127 equal the same rows
      of S = 512 (single slot, and one batched slot through `slots`) under
      the same mask rows and kv_limit; the mask lets even positions see only
      columns < 128, so a short launch skips KV tiles that the long one runs
      for the rows beside them. Each slot's rows of a B=32 decode launch
      equal the slot launched alone through `slots`;
    - limit isolation: 1e6 (bf16) or 127 with scales 1e6 (int8) past a slot's
      kv_limit, and its mask set past the limit, leave the output as it was,
      and so does a mask that starts 1 byte past a 16-byte boundary;
    - soft cap 30.0 at the verify shape (scores reach +-40), and a cache of
      odd length L = 301, within tolerance;
    - empty rows: rows with no live slot, and kv_limit 0, give exactly 0;
    - head dims 64 and 256 (attention_head_dim_checks)."""
    from umbrella_tpu_torch.models.kv_cache import _quantize_block
    from umbrella_tpu_torch.ops.kernels import tree_attention as ta
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows, \
        tree_mask_rows_batched
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    nH, KVH, D, L = 32, 8, 128, MAX_LEN
    held = {}

    def caches(shape, head_dim=D):
        """bf16 K and V at `shape` + (head_dim,), and their int8 forms with fp32
        scales."""
        k, v = randn(*shape, head_dim), randn(*shape, head_dim)
        (kq, ks), (vq, vs) = _quantize_block(k), _quantize_block(v)
        return {"bf16": (k, v, {}), "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}

    def close(name, got, ref):
        e, m = err(got, ref)
        check(e <= 2e-2 * m, f"{name}: err {e} vs max {m}")

    # -- which kernel each dtype takes
    small = torch.randn((2, KVH, 256, D), generator=gen, device=dev)
    q32 = torch.randn((24, nH, D), generator=gen, device=dev)
    m24 = causal_mask_rows(100, 24, 256, device=dev)
    routes = {}
    for name, args in (("fp32 D=128", (q32, small, small)),
                       ("bf16 D=128", (q32.bfloat16(), small.bfloat16(), small.bfloat16())),
                       ("bf16 D=32", (q32[..., :32].bfloat16().contiguous(),
                                      small[..., :32].bfloat16().contiguous(),
                                      small[..., :32].bfloat16().contiguous()))):
        n0, s0 = ta.attend_flash.launches, ta.attend_flash.scalar_launches
        got = ta.attend_flash(*args, m24, 124, 1)
        close(f"route {name}", got, ta.attend_flash_ref(args[0], args[1][1], args[2][1], m24, 124))
        check(ta.attend_flash.launches == n0 + 1, f"route {name}: not counted")
        routes[name] = "scalar" if ta.attend_flash.scalar_launches == s0 + 1 else "tensor-core"
    check(routes == {"fp32 D=128": "scalar", "bf16 D=128": "tensor-core", "bf16 D=32": "scalar"},
          f"kernel routes {routes}")
    held["routes"] = routes
    del small

    # -- single slot: row invariance, soft cap, empty rows, limit isolation
    nn, S_big = 301, 512
    limit = nn + S_big
    band = causal_mask_rows(nn, S_big, L, device=dev)
    band[0::2, 128:] = False
    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    tree = tree_mask_rows(nn, torch.as_tensor(gm.bitmap, device=dev), L)
    T = gm.size
    q = randn(S_big, nH, D)
    for kind, (k, v, sc) in caches((2, KVH, L)).items():
        ref_sc = {n: t[1] for n, t in sc.items()}
        whole = ta.attend_flash(q, k, v, band, limit, 1, **sc)
        close(f"band mask {kind} S={S_big}", whole,
              ta.attend_flash_ref(q, k[1], v[1], band, limit, **ref_sc))
        for S in (1, 24, 127):
            got = ta.attend_flash(q[:S].contiguous(), k, v, band[:S].contiguous(), limit, 1,
                                  **sc)
            check(torch.equal(got, whole[:S]), f"attend_flash {kind}: rows of S={S} differ "
                  f"from S={S_big}'s (max {err(got, whole[:S])[0]})")
        qv = randn(T, nH, D, scale=8.0)  # scores reach +-40: the cap bites
        close(f"soft cap 30 {kind}",
              ta.attend_flash(qv, k, v, tree, nn + T, 1, soft_cap=30.0, **sc),
              ta.attend_flash_ref(qv, k[1], v[1], tree, nn + T, soft_cap=30.0, **ref_sc))
        dead = tree.clone()
        dead[[0, 3, T - 1]] = False
        got = ta.attend_flash(qv, k, v, dead, nn + T, 1, **sc)
        check(torch.count_nonzero(got[[0, 3, T - 1]]) == 0, f"empty rows {kind}: not 0")
        close(f"empty rows {kind}", got, ta.attend_flash_ref(qv, k[1], v[1], dead, nn + T,
                                                             **ref_sc))
        check(torch.count_nonzero(ta.attend_flash(qv, k, v, tree, 0, 1, **sc)) == 0,
              f"kv_limit 0 {kind}: not 0")
        base = ta.attend_flash(qv, k, v, tree, nn + T, 1, **sc)
        k2, v2 = k.clone(), v.clone()
        k2[1, :, nn + T:] = 127 if kind == "int8" else 1e6
        v2[1, :, nn + T:] = 127 if kind == "int8" else 1e6
        sc2 = {n: t.clone() for n, t in sc.items()}
        for t in sc2.values():
            t[1, :, nn + T:] = 1e6
        wide_mask = tree.clone()
        wide_mask[:, nn + T:] = True
        got = ta.attend_flash(qv, k2, v2, wide_mask, nn + T, 1, **sc2)
        check(torch.equal(got, base), f"limit isolation {kind}: output moved (max "
              f"{err(got, base)[0]})")
        # the same mask rows from an address 1 byte past a 16-byte boundary
        flat = torch.zeros(tree.numel() + 16, dtype=torch.bool, device=dev)
        shifted = flat[1:1 + tree.numel()].view(tree.shape)
        shifted.copy_(tree)
        got = ta.attend_flash(qv, k, v, shifted, nn + T, 1, **sc)
        check(torch.equal(got, base), f"misaligned mask {kind}: output moved")
        del k2, v2, sc2
    # an odd cache length: TMA zero-fills past L, and the mask and scale
    # windows start off the rows' 16-byte boundaries
    odd = causal_mask_rows(270, 24, 301, device=dev)
    q_odd = randn(24, nH, D)
    for kind, (k, v, sc) in caches((2, KVH, 301)).items():
        close(f"L=301 {kind}", ta.attend_flash(q_odd, k, v, odd, 294, 1, **sc),
              ta.attend_flash_ref(q_odd, k[1], v[1], odd, 294, **{n: t[1] for n, t in sc.items()}))
    held["single_slot"] = (f"bf16 and int8 KV: rows of S=1, 24, 127 equal S={S_big}'s bitwise "
                           f"(band mask, kv_limit {limit}); soft cap 30 within tolerance; rows "
                           f"with no live slot and kv_limit 0 exactly 0; 1e6 / 127 past the "
                           f"limit (mask set there), and a mask 1 byte off a 16-byte boundary, "
                           f"leave the output bit for bit; L=301 within tolerance")
    torch.cuda.empty_cache()

    # -- batched: a B=32 launch's slots vs each slot alone; prefill rows through slots
    B, g = 32, growmap_from_spec(2, 3)
    T = g.size
    limits = torch.randint(135, 301, (B,), generator=gen, device=dev, dtype=torch.int32)
    mask = tree_mask_rows_batched(limits - T, torch.as_tensor(g.bitmap, device=dev), L)
    q = randn(B, T, nH, D)
    qp = randn(1, S_big, nH, D)
    slot5 = torch.full((1,), 5, dtype=torch.int32, device=dev)
    lim5 = torch.full((1,), limit, dtype=torch.int32, device=dev)
    for kind, (k, v, sc) in caches((2, B, KVH, L)).items():
        whole = ta.attend_flash_batched(q, k, v, mask, limits, 1, **sc)
        close(f"batched {kind}", whole, ta.attend_flash_batched_ref(q, k, v, mask, limits, 1,
                                                                    **sc))
        for b in (0, 5, B - 1):
            one = torch.full((1,), b, dtype=torch.int32, device=dev)
            got = ta.attend_flash_batched(q[b:b + 1].contiguous(), k, v,
                                          mask[b:b + 1].contiguous(), limits[b:b + 1].contiguous(),
                                          1, slots=one, **sc)
            check(torch.equal(got, whole[b:b + 1]), f"batched {kind}: slot {b} alone differs "
                  f"from the B={B} launch (max {err(got, whole[b:b + 1])[0]})")
        pre = ta.attend_flash_batched(qp, k, v, band[None], lim5, 1, slots=slot5, **sc)
        for S in (1, 24, 127):
            got = ta.attend_flash_batched(qp[:, :S].contiguous(), k, v,
                                          band[None, :S].contiguous(), lim5, 1, slots=slot5,
                                          **sc)
            check(torch.equal(got, pre[:, :S]), f"batched {kind}: rows of S={S} differ from "
                  f"S={S_big}'s")
        b = 3
        lim_b = int(limits[b])
        k2, v2 = k.clone(), v.clone()
        k2[1, b, :, lim_b:] = 127 if kind == "int8" else 1e6
        v2[1, b, :, lim_b:] = 127 if kind == "int8" else 1e6
        sc2 = {n: t.clone() for n, t in sc.items()}
        for t in sc2.values():
            t[1, b, :, lim_b:] = 1e6
        wide_mask = mask.clone()
        wide_mask[b, :, lim_b:] = True
        got = ta.attend_flash_batched(q, k2, v2, wide_mask, limits, 1, **sc2)
        check(torch.equal(got, whole), f"batched limit isolation {kind}: output moved")
        del k2, v2, sc2
        zl = limits.clone()
        zl[[2, 7]] = 0
        got = ta.attend_flash_batched(q, k, v, mask, zl, 1, **sc)
        check(torch.count_nonzero(got[[2, 7]]) == 0, f"batched kv_limit 0 {kind}: not 0")
        close(f"batched kv_limit 0 {kind}", got,
              ta.attend_flash_batched_ref(q, k, v, mask, zl, 1, **sc))
        del k, v, sc
        torch.cuda.empty_cache()
    held["batched"] = (f"bf16 and int8 KV: slots 0, 5, {B - 1} of a B={B} decode launch equal "
                       f"each slot alone through slots, bitwise; prefill rows of S=1, 24, 127 "
                       f"equal S={S_big}'s through slots; limit isolation bit for bit; "
                       f"kv_limit 0 slots exactly 0")
    held["head_dims"] = attention_head_dim_checks(torch, dev, gen, randn, err, ta, caches, close)
    log(f"[kernels] attention tensor-core checks held: {json.dumps(held)}")
    return held


def attention_head_dim_checks(torch, dev, gen, randn, err, ta, caches, close):
    """The tensor-core kernel's other head dims, bf16 and int8 KV: D = 64 at
    Llama-3.2-1B's 32/8 heads and D = 256 at Gemma-2-9B's 16/8 (one consumer
    warpgroup, no combine, its own ring depth). Each takes the tensor-core
    kernel; single slot at the verify shape (with and without soft cap 30)
    and a 512-row band mask within tolerance of the plain version, rows of
    S = 1, 24, 127 equal to S = 512's bitwise; batched B = 8 decode within
    tolerance, and slots 0 and 7 alone equal to the launch's rows bitwise.
    `caches(shape, D)` and `close` are attention_tc_checks'."""
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows, \
        tree_mask_rows_batched
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    KVH, L, nn, S_big = 8, MAX_LEN, 301, 512
    limit = nn + S_big
    band = causal_mask_rows(nn, S_big, L, device=dev)
    band[0::2, 128:] = False
    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    tree = tree_mask_rows(nn, torch.as_tensor(gm.bitmap, device=dev), L)
    T = gm.size
    B, g = 8, growmap_from_spec(3, 4)
    limits = torch.randint(135, 301, (B,), generator=gen, device=dev, dtype=torch.int32)
    bmask = tree_mask_rows_batched(limits - g.size, torch.as_tensor(g.bitmap, device=dev), L)
    held = {}
    for D, nH in ((64, 32), (256, 16)):
        q = randn(S_big, nH, D)
        qv = randn(T, nH, D, scale=8.0)  # scores reach +-40: the cap bites
        qb = randn(B, g.size, nH, D)
        for kind, (k, v, sc) in caches((2, KVH, L), D).items():
            ref_sc = {n: t[1] for n, t in sc.items()}
            s0 = ta.attend_flash.scalar_launches + ta.attend_flash_int8.scalar_launches
            whole = ta.attend_flash(q, k, v, band, limit, 1, **sc)
            check(ta.attend_flash.scalar_launches + ta.attend_flash_int8.scalar_launches == s0,
                  f"D={D} {kind}: bf16 q took the scalar kernel")
            close(f"D={D} band mask {kind}", whole,
                  ta.attend_flash_ref(q, k[1], v[1], band, limit, **ref_sc))
            for S in (1, 24, 127):
                got = ta.attend_flash(q[:S].contiguous(), k, v, band[:S].contiguous(), limit, 1,
                                      **sc)
                check(torch.equal(got, whole[:S]), f"D={D} {kind}: rows of S={S} differ from "
                      f"S={S_big}'s (max {err(got, whole[:S])[0]})")
            for cap in (0.0, 30.0):
                close(f"D={D} verify {kind} soft cap {cap}",
                      ta.attend_flash(qv, k, v, tree, nn + T, 1, soft_cap=cap, **sc),
                      ta.attend_flash_ref(qv, k[1], v[1], tree, nn + T, soft_cap=cap, **ref_sc))
            del k, v, sc
            kb, vb, scb = caches((2, B, KVH, L), D)[kind]
            full = ta.attend_flash_batched(qb, kb, vb, bmask, limits, 1, **scb)
            close(f"D={D} batched {kind}", full,
                  ta.attend_flash_batched_ref(qb, kb, vb, bmask, limits, 1, **scb))
            for b in (0, B - 1):
                one = torch.full((1,), b, dtype=torch.int32, device=dev)
                got = ta.attend_flash_batched(qb[b:b + 1].contiguous(), kb, vb,
                                              bmask[b:b + 1].contiguous(),
                                              limits[b:b + 1].contiguous(), 1, slots=one, **scb)
                check(torch.equal(got, full[b:b + 1]), f"D={D} batched {kind}: slot {b} alone "
                      f"differs from the B={B} launch")
            del kb, vb, scb
            torch.cuda.empty_cache()
        held[f"D={D}"] = (f"{nH}/{KVH} heads, bf16 and int8 KV: tensor-core kernel; band mask "
                          f"S={S_big} and verify (soft cap 0 and 30) within tolerance, rows of "
                          f"S=1, 24, 127 equal S={S_big}'s bitwise; B={B} decode within "
                          f"tolerance, slots 0 and {B - 1} alone equal the launch's rows bitwise")
    return held


# ---------------------------------------------------------------- phases 3-4


def build_target(torch, dev, n_layers, exit_layer, dtype, awq_act="bf16"):
    """bench.py's primary target: random W4 weights, tail wo/down scales damped
    x0.05, shared prefix (exit_layer layers + lm_head) converted to Int4F;
    awq_act="int8" runs the W4 layers through W4A8."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import (ModelRuntime, early_exit_runtime,
                                                      random_awq_runtime)
    from umbrella_tpu_torch.quantization.int4f import hybridize_shared_prefix

    cfg = ModelConfig(**dict(CFG_8B, num_hidden_layers=n_layers, awq_act=awq_act))
    t = random_awq_runtime(cfg, MAX_LEN, dtype=dtype, seed=2, quantize_lm_head=True,
                           device=dev)
    params = hybridize_shared_prefix(
        dict(t.params, layers=damp_tail(t.params["layers"], exit_layer)), exit_layer, refine=0)
    target = ModelRuntime(cfg, params, MAX_LEN, dtype=dtype, device=dev)
    return target, early_exit_runtime(target, exit_layer=exit_layer)


def make_engine(torch, dev, target, draft, dtype, kv_dtype=None, tree=None, **kw):
    """The single-slot static engine (Sequoia 24x6 tree unless `tree` is a
    growmap_from_spec spec)."""
    from umbrella_tpu_torch.sequoia import growmap_from_spec
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    gm = growmap_from_spec(24, 6, acc=ACC_24x6) if tree is None else growmap_from_spec(*tree)
    eng = AutoEngine.from_config(
        device=dev, engine="static", model=target, draft_model=draft, growmap=gm,
        max_length=MAX_LEN, temperature=0.0, eos_token_ids=kw.pop("eos_token_ids", [-100]),
        dtype=dtype, kv_dtype=kv_dtype, **kw)
    eng.initialize()
    return eng


def greedy_ar_decode(torch, runtime, prompt, n_new, kv_dtype=None, keep_kv=False):
    """Plain autoregressive greedy decode with the port's own forward (on an
    int8 KV cache for kv_dtype="int8"). Returns (tokens, gaps, runner_ups,
    scales): at step i, the top-1 minus top-2 logit, the top-2 token and the
    row's max |logit|; and the KV cache after the decode, where keep_kv."""
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    dev = runtime.device
    kv = runtime.init_kv(kv_dtype=kv_dtype)
    S = len(prompt)
    logits, kv = runtime.forward(runtime.params, kv, torch.tensor(prompt, device=dev),
                                 torch.arange(S, device=dev),
                                 causal_mask_rows(0, S, MAX_LEN, device=dev), 0)
    row = logits[-1]
    out, gaps, runner_ups, scales = [], [], [], []
    for t in range(S, S + n_new):
        top = torch.topk(row, 2)
        out.append(int(top.indices[0]))
        gaps.append(float(top.values[0] - top.values[1]))
        runner_ups.append(int(top.indices[1]))
        scales.append(float(row.abs().max()))
        if len(out) == n_new:
            break
        lg, kv = runtime.forward(runtime.params, kv, torch.tensor([out[-1]], device=dev),
                                 torch.tensor([t], device=dev),
                                 causal_mask_rows(t, 1, MAX_LEN, device=dev), t)
        row = lg[0]
    return (out, gaps, runner_ups, scales) + ((kv,) if keep_kv else ())


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def lossless_check(torch, dev, prompt, kv_dtype=None, awq_act="bf16"):
    """Static-tree generate() against the port's own AR decode (both on an int8
    KV cache when kv_dtype="int8"). The first LOSSLESS_NEW_TOKENS tokens must
    be identical; where the two decodes part later (generate() may overshoot by
    up to a tree path), the AR top-1/top-2 logit gap at that step is reported.
    Exact equality needs every op but attention to compute a row the same way
    whatever rows share the call (see ops/norms.py); int8 KV rounding and the
    W4A8 layers' int8 activations would turn any last-bit difference into a
    quantum. awq_act="int8": the W4 layers past the Int4F prefix run W4A8."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = ("[lossless-w4a8]" if awq_act == "int8" else
           "[lossless]" if kv_dtype is None else f"[lossless-{kv_dtype}]")
    target, draft = build_target(torch, dev, n_layers=4, exit_layer=2, dtype=torch.float32,
                                 awq_act=awq_act)
    eng = make_engine(torch, dev, target, draft, torch.float32, kv_dtype=kv_dtype)
    reset_launch_counts()
    trace, out = profile_window(  # the kernels' launches traced and held against the counts
        torch, f"{tag[:-1]}-trace]",
        lambda: eng.generate(input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS),
        request_steps)
    counts = launch_counts()
    check(trace is not None, f"{tag} the kernels' launches were not traced")
    graphs = check_graphed(eng, tag)
    toks = out["generated_tokens"]
    ar, gaps, _, _ = greedy_ar_decode(torch, target, prompt, len(toks), kv_dtype=kv_dtype)
    same = first_difference(toks, ar)
    steps = request_steps(out)
    res = dict(tokens=len(toks), identical_prefix=same, avg_accept_tokens=out["avg_accept_tokens"],
               min_ar_gap=min(gaps),
               gap_at_first_difference=gaps[same] if same < len(toks) else None,
               launches=counts, launches_per_step={k: n / steps for k, n in counts.items()},
               launches_traced=trace["launches_traced"], graphs=graphs)
    log(f"{tag} {json.dumps(res)}")
    check(len(toks) >= LOSSLESS_NEW_TOKENS, f"{tag} too few tokens")
    check(same >= LOSSLESS_NEW_TOKENS,
          f"{tag} spec and AR decode differ at token {same}: {toks} vs {ar}")
    attn = "attend_flash_int8" if kv_dtype == "int8" else "attend_flash"
    w4 = "w4a8_matmul" if awq_act == "int8" else "w4a16_matmul"
    for name in (attn, w4, "w4a8f_matmul", "w4a8_quantize", "embed_gather"):
        check(counts[name] > 0, f"{tag} kernel {name} was never launched")
    check(counts["attend_flash_scalar"] == counts[attn], f"{tag}: fp32 q must take the scalar "
          f"attention kernel ({counts['attend_flash_scalar']} of {counts[attn]})")
    return res


def stage_devices(torch, dev):
    """PP_STAGES stage devices: cuda:0..3 on a host with that many cards, else
    every stage on `dev` (shard_runtime_pp takes a device more than once)."""
    if torch.cuda.device_count() >= PP_STAGES:
        return [torch.device("cuda", i) for i in range(PP_STAGES)]
    return [dev] * PP_STAGES


def damp_tail(layers, first):
    """bench.py's damped tail: wo and down scales x0.05 from layer `first` on
    (new per-layer tuples; the packed bytes are shared)."""
    layers = dict(layers)
    for k in ("wo", "down"):
        layers[k] = tuple(q._replace(scales=q.scales * 0.05) if i >= first else q
                          for i, q in enumerate(layers[k]))
    return layers


# where the int8 KV cache lets a spec decode part from the AR decode, the AR
# step must be a near tie: top-1 minus top-2 at most NEAR_TIE x max|logit|
# (about 3x the one parting seen on an H100, a gap of 0.0027 at max|logit|
# 8.05), and the spec decode must have taken the AR's top-2 token
NEAR_TIE = 2 ** -10


def keep_target_kv(eng):
    """A dict that holds a copy of the engine's target KV cache as each
    generate() leaves it (generate() ends with reset(), which zeroes the
    cache in place)."""
    kept, reset = {}, eng.reset

    def copy(kv):
        if hasattr(kv, "stages"):
            return type(kv)(tuple(copy(s) for s in kv.stages))
        return type(kv)(*(None if t is None else t.clone() for t in kv))

    def keep_then_reset():
        kept["kv"] = copy(eng.kv_target)
        reset()

    eng.reset = keep_then_reset
    return kept


def kv_rows(torch, kv, n):
    """(k, v, k_scale, v_scale) at slots [0, n) of every layer of a KV cache
    (a staged cache's stages concatenated over layers, on stage 0's device);
    the scales are None unless the cache is int8."""
    from umbrella_tpu_torch.models.kv_cache import StagedKVCache

    stages = kv.stages if isinstance(kv, StagedKVCache) else (kv,)
    d0 = stages[0].k.device
    return tuple(None if stages[0][f] is None else
                 torch.cat([s[f][:, :, :n].to(d0) for s in stages]) for f in range(4))


def kv_witness(torch, spec, ar, ref=None):
    """How far the spec decode's KV rows lie from the AR decode's (same tokens
    at these slots), layer by layer: the largest difference in int8 codes, or
    relative to the layer's max |row| for a float cache, and whether layer 0
    is bit for bit the same (its rows pass no attention). With `ref` (an fp32
    cache's rows at the same slots), the largest distance of either int8
    cache's dequantized rows from it, in quanta of the row's own scale."""
    out = dict(layer0_equal=all(torch.equal(a[0], b[0]) for a, b in zip(spec, ar)
                                if a is not None))
    if spec[2] is None:
        out["rel_diff"] = [max(float((a[li].float() - b[li].float()).abs().max()
                                     / b[li].float().abs().max()) for a, b in zip(spec[:2], ar[:2]))
                           for li in range(spec[0].shape[0])]
        return out
    out["code_diff"] = [max(int((a[li].int() - b[li].int()).abs().max())
                            for a, b in zip(spec[:2], ar[:2])) for li in range(spec[0].shape[0])]
    out["codes_differing"] = sum(int((a.int() != b.int()).sum()) for a, b in zip(spec[:2], ar[:2]))
    out["codes"] = 2 * spec[0].numel()
    if ref is not None:
        m = ref[0].shape[2]
        out["fp32_slots"] = m
        for tag, rows in (("spec", spec), ("ar", ar)):
            out[f"{tag}_quanta_from_fp32"] = [
                max(float(((c[li, :, :m].float() * s[li, :, :m, None] - r[li]).abs()
                           / s[li, :, :m, None]).max())
                    for c, s, r in ((rows[0], rows[2], ref[0]), (rows[1], rows[3], ref[1])))
                for li in range(spec[0].shape[0])]
    return out


def pp_lossless_check(torch, dev, prompt):
    """Full Llama-3.3-70B width, 8 random AWQ layers (damped tail), W4 head,
    and its early-exit draft of 2 layers. The target is staged by
    shard_runtime_pp over PP_STAGES stages (2 layers each, so the layered index
    takes both values) and run through pipeline_parallel, on the
    device-resident loop (its step captured as CUDA graphs: one on one card,
    one a run of phases on one card across cards). Three cases: fp32
    activations with an fp32 KV cache, fp32 with int8 KV, and bf16 activations
    and KV (the pp4 config's dtype). In each, the staged engine's greedy
    generate() of LOSSLESS_NEW_TOKENS tokens must equal the unstaged engine's
    (the same kernels on the same rows). Against the port's AR decode: fp32
    and bf16 must be identical for LOSSLESS_NEW_TOKENS tokens; int8 KV too,
    or part from it only at a near tie (NEAR_TIE) where the spec decode took
    the AR's top-2. The witness for that rounding: the KV rows both decodes
    wrote over the tokens they share. Layer 0's rows, which no attention
    precedes, must be bit for bit the same (the ops outside attention compute
    a row alike in a verify pass and an AR step); from layer 1 on the rows
    differ by rounding (a verify row reads its ancestors at tree slots, the
    AR row the same keys at contiguous slots, so the attention kernel's block
    sums round differently, and the W4A16 kernel's bf16 rounding of its input
    widens that to bf16 steps), which an int8 row turns into whole quanta:
    fewer, layer by layer, than int8 rounding moves a row from the fp32
    cache's."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import (ModelRuntime, early_exit_runtime,
                                                      random_awq_runtime)
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp

    cfg = ModelConfig(**dict(CFG_70B, num_hidden_layers=8, max_position_embeddings=MAX_LEN))
    P = len(prompt)
    res, fp32_ref = {}, None
    for case, dtype, kv_dtype in (("fp32", torch.float32, None),
                                  ("int8", torch.float32, "int8"),
                                  ("bf16", torch.bfloat16, None)):
        if case != "int8":  # int8 KV reuses the fp32 models
            target = draft = staged = None
            torch.cuda.empty_cache()
            params = random_awq_runtime(cfg, MAX_LEN, dtype=dtype, seed=3,
                                        quantize_lm_head=True, device=dev).params
            params = dict(params, layers=damp_tail(params["layers"], 2))
            target = ModelRuntime(cfg, params, MAX_LEN, dtype=dtype, device=dev)
            draft = early_exit_runtime(target, 2)
            staged = shard_runtime_pp(ModelRuntime(cfg, dict(params), MAX_LEN, dtype=dtype,
                                                   device=dev), stage_devices(torch, dev))
            del params
        eng = make_engine(torch, dev, staged, draft, dtype, kv_dtype=kv_dtype,
                          pipeline_parallel=PP_STAGES)
        kept = keep_target_kv(eng)
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS)
        counts = launch_counts()
        check(eng._can_decode_fused(), "[pp-lossless]: the staged engine does not take the "
              "device-resident loop")
        graphs = check_graphed(eng, f"[pp-lossless] {case}")
        del eng
        toks = out["generated_tokens"]
        unstaged = make_engine(torch, dev, target, draft, dtype, kv_dtype=kv_dtype).generate(
            input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS)["generated_tokens"]
        ar, gaps, runner_ups, scales, ar_kv = greedy_ar_decode(
            torch, target, prompt, len(toks), kv_dtype=kv_dtype, keep_kv=True)
        same, same_ar = first_difference(toks, unstaged), first_difference(toks, ar)
        parted = same_ar < min(len(toks), LOSSLESS_NEW_TOKENS)
        # slots whose token both decodes share (and both wrote the KV of)
        n = P + min(same_ar, len(ar) - 1, len(toks) - 1)
        spec_rows, ar_rows = kv_rows(torch, kept["kv"], n), kv_rows(torch, ar_kv, n)
        del kept, ar_kv
        ref = None
        if case == "int8":  # the fp32-KV decode of the same models, where its tokens agree
            m = min(n, P + first_difference(toks, fp32_ref[0]))
            ref = tuple(t[:, :, :m] for t in fp32_ref[1][:2])
        witness = kv_witness(torch, spec_rows, ar_rows, ref)
        if case == "fp32":
            fp32_ref = (ar, ar_rows)
        del spec_rows, ar_rows, ref
        r = dict(case=case, tokens=len(toks), identical_to_unstaged=same,
                 identical_to_ar=same_ar, avg_accept_tokens=out["avg_accept_tokens"],
                 min_ar_gap=min(gaps), stages=[str(d) for d in staged.stage_devices],
                 kv_slots_compared=n, kv_witness=witness, launches=counts, graphs=graphs)
        if parted:
            r["ar_at_first_difference"] = dict(
                gap=gaps[same_ar], max_abs_logit=scales[same_ar], spec_token=toks[same_ar],
                ar_top1=ar[same_ar], ar_top2=runner_ups[same_ar])
        log(f"[pp-lossless] {json.dumps(r)}")
        tag = f"[pp-lossless] {case}"
        check(len(toks) >= LOSSLESS_NEW_TOKENS, f"{tag}: too few tokens")
        check(same >= LOSSLESS_NEW_TOKENS, f"{tag}: staged {toks} vs unstaged {unstaged}")
        check(witness["layer0_equal"], f"{tag}: layer 0's KV rows differ between the spec and "
              "the AR decode (an op outside attention computes a row differently by batch)")
        if case == "int8":
            check(all(d < q for d, q in zip(witness["code_diff"][1:],
                                            witness["spec_quanta_from_fp32"][1:])),
                  f"{tag}: spec and AR KV rows differ by as much as int8 rows differ from fp32 "
                  f"rows: {witness}")
        near_tie = parted and case == "int8" and toks[same_ar] == runner_ups[same_ar] \
            and gaps[same_ar] <= NEAR_TIE * scales[same_ar]
        check(not parted or near_tie, f"{tag}: staged {toks} vs AR {ar}")
        attn = "attend_flash_int8" if kv_dtype == "int8" else "attend_flash"
        for name in (attn, "w4a16_matmul", "w4a16_matmul_layered", "embed_gather"):
            check(counts[name] > 0, f"{tag}: kernel {name} was never launched")
        res[case] = r
    return res


def build_70b(torch, dev, devices, max_length):
    """A random AWQ Llama-3.3-70B at full shape (80 layers, g128, bf16 scales,
    bf16 embedding and untied head, tail wo/down scales x0.05 from layer 3 on),
    built on `dev` and staged by shard_runtime_pp over `devices`. No reference
    to the per-layer tensors outlives this function's locals, so staging frees
    them as it stacks."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime, random_awq_runtime
    from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp

    cfg = ModelConfig(**CFG_70B)
    params = random_awq_runtime(cfg, max_length, dtype=torch.bfloat16, seed=4,
                                device=dev).params
    rt = ModelRuntime(cfg, dict(params, layers=damp_tail(params["layers"], 3)), max_length,
                      dtype=torch.bfloat16, device=dev)
    del params
    return shard_runtime_pp(rt, devices)


def main_path(torch, dev, prompt, target, draft):
    """The 8B static main path through generate(): graphed (the device-resident
    loop, its step replayed as a CUDA graph) and stepwise (build_tree();
    verify(), one host read a step) side by side on one engine: tok/s, step
    ms and TTFT each, a profiled 64-token request each, the same tokens. The
    kernels' launches are read from the graphed run; in each profiled request
    the kernels the profiler traced must be the wrappers' counts, and the
    graphed request's launches a step, as traced ((traced - prefill) /
    replays), must equal the stepwise loop's as counted and the captured
    step's."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    eng = make_engine(torch, dev, target, draft, torch.bfloat16)
    eng.generate(input_ids=prompt, max_new_tokens=16)  # warm-up: captures the greedy step
    graph = eng._decode_graphs[(True, eng.topk, False)]
    res = {}
    for mode in ("graphed", "stepwise"):
        (graphed if mode == "graphed" else stepwise)(eng)
        reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        assert eng._prefill(prompt)
        torch.cuda.synchronize()
        ttft_ms = 1000 * (time.time() - t1)
        prefill_counts = launch_counts()
        eng.reset()
        reset_launch_counts()
        before = graph_stats(eng)
        out = eng.generate(input_ids=prompt, max_new_tokens=MAIN_NEW_TOKENS)
        counts = launch_counts()
        after = graph_stats(eng)
        toks = out["generated_tokens"]
        steps = round(len(toks) / out["avg_accept_tokens"])
        r = dict(tokens=len(toks), steps=steps, tok_per_s=1000.0 / out["time_per_output_token"],
                 decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
                 avg_accept_tokens=out["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms,
                 replays=after["replays"] - before["replays"],
                 noop_replays=after["noop_replays"] - before["noop_replays"],
                 host_reads=after["blocks"] - before["blocks"] + 1 if mode == "graphed"
                 else steps, launches=counts,
                 prefill_launches=prefill_counts,
                 launches_per_step={k: (counts[k] - prefill_counts[k]) / steps for k in counts})
        before = graph_stats(eng)
        r["profile"], _ = profile_window(
            torch, f"[profile] {mode}", lambda: eng.generate(input_ids=prompt, max_new_tokens=64),
            request_steps)
        after = graph_stats(eng)
        check(r["profile"] is not None, f"[profile] {mode}: the kernels' launches were not "
              "traced (the profiler saw no device time)")
        r["profile"].update(replays=after["replays"] - before["replays"],
                            noop_replays=after["noop_replays"] - before["noop_replays"],
                            capture_ms=graph.capture_ms, graph_pool_gb=after["pool_gb"])
        res[mode] = r
        res.setdefault("tokens", toks)
    graphed(eng)
    g, sw = res["graphed"], res["stepwise"]
    check(g["replays"] >= g["steps"] > 0 and sw["replays"] == 0,
          f"main path: graphed {g['replays']} replays, stepwise {sw['replays']}")
    traced, replays = g["profile"]["launches_traced"], g["profile"]["replays"]
    check(replays > 0, "[profile] graphed: no replay")
    g["launches_traced"] = {k: traced[k] for k in MAIN_KERNELS}
    g["launches_per_step"] = {k: (traced[k] - g["prefill_launches"][k]) / replays
                              for k in MAIN_KERNELS}
    check(all(g["launches_per_step"][k] == sw["launches_per_step"][k] == graph.launches[k]
              for k in MAIN_KERNELS),
          f"main path: launches a step traced in the graphed request {g['launches_per_step']}, "
          f"counted in the stepwise one {sw['launches_per_step']}, captured {graph.launches}")
    check(sw["tokens"] == g["tokens"], "main path: stepwise and graphed decodes differ")
    toks = res.pop("tokens")
    for name in MAIN_KERNELS:
        check(g["launches"][name] > 0, f"main path: kernel {name} was never launched")
    check_tc_route(g["launches"], "main path")
    ar, gaps, _, _ = greedy_ar_decode(torch, target, prompt, len(toks))
    prefix = first_difference(toks, ar)
    res.update(g)  # the graphed run is the main path's result
    res.update(spec_vs_ar_common_prefix=prefix,
               ar_gap_at_first_difference=gaps[prefix] if prefix < len(toks) else None,
               graph=graph_stats(eng), peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"[main] {json.dumps(res)}")
    check(all(0 <= t < CFG_8B["vocab_size"] for t in toks), "main path: token out of range")
    del eng
    return res


GRAPH_NEW_TOKENS = 64


def graph_phase(torch, dev, prompt, target, draft):
    """The decode loops as CUDA graphs against their stepwise forms, on one
    engine each: the static engine on the fp32 lossless model (4 layers) and
    on the bf16 8B main path (generate(), GRAPH_NEW_TOKENS tokens), the
    batched engine at B=32 with int8 KV (32 requests through run()); the
    tokens must be equal, also in a request that follows one stopped by an
    EOS inside a block. Each graphed run must have captured and replayed a
    graph (a silent stepwise run fails), with every replay under
    torch.cuda.set_sync_debug_mode("error"); two replays of a stochastic
    step draw different numbers (the second one's again after a rewind),
    and the stochastic static decode equals the stepwise one for one seed; a
    step that reads the host during its capture must raise, not fall back to
    stepwise."""
    modes = []
    real_replay = torch.cuda.CUDAGraph.replay

    def replay(graph):  # record the sync debug mode every replay runs under
        modes.append(torch.cuda.get_sync_debug_mode())
        return real_replay(graph)

    res = {}
    small, small_draft = build_target(torch, dev, n_layers=4, exit_layer=2, dtype=torch.float32)
    torch.cuda.CUDAGraph.replay = replay
    try:
        res["generator"] = replays_draw_anew(torch, dev)
        for name, (t, d, dtype, sampling) in {
                "static-fp32": (small, small_draft, torch.float32, {}),
                "static-bf16-8b": (target, draft, torch.bfloat16, {}),
                "static-bf16-8b-stochastic": (target, draft, torch.bfloat16,
                                              dict(temperature=0.6, topp=0.9))}.items():
            outs = []
            for mode in ("graphed", "stepwise"):
                eng = make_engine(torch, dev, t, d, dtype, seed=11)
                if mode == "stepwise":
                    stepwise(eng)
                outs.append(eng.generate(input_ids=prompt, max_new_tokens=GRAPH_NEW_TOKENS,
                                         **sampling)["generated_tokens"])
                if mode == "graphed":
                    stats = check_graphed(eng, f"[graph] {name}")
                del eng
            res[name] = dict(tokens=len(outs[0]), equal=outs[0] == outs[1], graphs=stats)
            check(outs[0] == outs[1], f"[graph] {name}: graphed {outs[0]} vs stepwise {outs[1]}")
        res["eos-inside-a-block"] = eos_inside_a_block(torch, dev, prompt, small, small_draft)
        reqs = random_requests(13, 32, 32)
        outs = []
        for mode in ("graphed", "stepwise"):
            eng = batched_engine(torch, dev, target, draft, 32, (2, 3), "int8", torch.bfloat16)
            if mode == "stepwise":
                stepwise(eng)
            outs.append([o["generated_tokens"] for o in eng.run(reqs)])
            if mode == "graphed":
                res["batched-int8-b32"] = dict(graphs=check_graphed(eng, "[graph] batched"))
            del eng
        same = sum(a == b for a, b in zip(*outs))
        res["batched-int8-b32"].update(requests=len(reqs), equal=same)
        check(same == len(reqs), f"[graph] batched: {same} of {len(reqs)} requests equal")
    finally:
        torch.cuda.CUDAGraph.replay = real_replay
    res["replay_sync_debug_modes"] = sorted(set(modes))
    check(modes and set(modes) == {2}, f"[graph] replays ran under sync debug modes {set(modes)}")
    check(res["generator"]["differ"] and res["generator"]["equal_to_eager"]
          and res["generator"]["rewound"],
          f"[graph] replays of a registered generator's draw: {res['generator']}")
    # a host read inside the step fails the capture; nothing runs stepwise instead
    eng = make_engine(torch, dev, small, small_draft, torch.float32)
    build = eng._build

    def build_with_a_host_read(nn, cont=None):
        nn.item()
        return build(nn, cont)

    eng._build = build_with_a_host_read
    try:
        eng.generate(input_ids=prompt, max_new_tokens=8)
        raised = None
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:200]
    res["capture_failure"] = raised
    check(raised is not None and graph_stats(eng)["replays"] == 0,
          "[graph] a step that reads the host was captured or ran stepwise")
    log(f"[graph] {json.dumps(res)}")
    return res


def eos_inside_a_block(torch, dev, prompt, target, draft):
    """Two requests on one engine, the first stopped by an EOS token a few
    steps into a block of replays, so that the block ends in no-op replays
    (they write no committed KV, and their random draws are taken back):
    graphed equal to stepwise in both requests, greedy and stochastic (one
    seed)."""
    res = {}
    for name, sampling in (("greedy", {}), ("stochastic", dict(temperature=0.6, topp=0.9))):
        free = make_engine(torch, dev, target, draft, torch.float32, seed=11).generate(
            input_ids=prompt, max_new_tokens=GRAPH_NEW_TOKENS, **sampling)["generated_tokens"]
        # the latest token new at its index in the first half of the decode
        eos = free[max(i for i in range(1, len(free) // 2 + 1) if free[i] not in free[:i])]
        outs = []
        for mode in ("graphed", "stepwise"):
            eng = make_engine(torch, dev, target, draft, torch.float32, seed=11,
                              eos_token_ids=[eos])
            if mode == "stepwise":
                stepwise(eng)
            outs.append([eng.generate(input_ids=prompt, max_new_tokens=GRAPH_NEW_TOKENS,
                                      **sampling)["generated_tokens"] for _ in range(2)])
            if mode == "graphed":
                noop = eng.decode_stats["noop_replays"]
            del eng
        check(outs[0][0][-1] == eos and noop > 0,
              f"[graph] eos-inside-a-block {name}: the first request did not stop at the EOS "
              f"inside a block ({len(outs[0][0])} tokens, {noop} no-op replays)")
        check(outs[0] == outs[1], f"[graph] eos-inside-a-block {name}: graphed {outs[0]} vs "
              f"stepwise {outs[1]}")
        res[name] = dict(eos_at=len(outs[0][0]) - 1, noop_replays=noop,
                         tokens=[len(o) for o in outs[0]], equal=True)
    return res


def replays_draw_anew(torch, dev):
    """A step that draws from a torch.Generator, captured as the engines
    capture theirs (the generator registered, its state restored after the
    warm-up): two replays draw different numbers, the same numbers as two
    eager calls from the same state, and a replay after rewind(1) draws the
    second replay's numbers again."""
    from umbrella_tpu_torch.cuda_graphs import Phase, StepGraph

    gen = torch.Generator(device=dev).manual_seed(5)
    out = torch.zeros(8, device=dev)

    def step():
        out.copy_(torch.rand(8, generator=gen, device=dev))

    state, eager, got = gen.get_state(), [], []
    for _ in range(2):
        step()
        eager.append(out.clone())
    gen.set_state(state)
    graph = StepGraph.capture([Phase("draw", dev, step)], {}, generators=(gen,))
    for _ in range(2):
        graph.replay(1)
        got.append(out.clone())
    graph.rewind(1)
    graph.replay(1)
    return dict(differ=not torch.equal(got[0], got[1]),
                equal_to_eager=all(torch.equal(a, b) for a, b in zip(got, eager)),
                rewound=torch.equal(out, got[1]))


def request_steps(out):
    """The target steps of a generate() result."""
    return max(1, round(len(out["generated_tokens"]) / out["avg_accept_tokens"]))


# the port's __global__ kernels as the profiler names them, each with the
# counters of every wrapper that launches it: a counted launch is one launch
# of that kernel (split-K sums and the empty kernel are not counted)
TRACED_KERNELS = (
    (("gather_rows",), ("embed_gather",)),
    (("flash_tc_kernel", "flash_attend_kernel"),
     ("attend_flash", "attend_flash_int8", "attend_flash_batched", "attend_flash_batched_int8")),
    (("flash_attend_kernel",), ("attend_flash_scalar",)),
    (("w4a16_kernel",), ("w4a16_matmul", "w4a16_matmul_layered", "w4a16_gate_up_silu")),
    (("w4a8_kernel",), ("w4a8f_matmul", "w4a8_matmul")),
    (("quantize_rows",), ("w4a8_quantize",)),
)


def traced_launches(tag, kernel_counts, counted):
    """Hold the launches of each kernel in the trace (kernel_counts: the
    profiler's kernel names and counts) against the wrappers' counts over the
    same window; return each wrapper's launches as traced, where it was the
    only wrapper of its kernel that the window ran."""
    traced, wrong = {}, []
    for patterns, names in TRACED_KERNELS:
        n = sum(c for k, c in kernel_counts.items() if any(p in k for p in patterns))
        want = sum(counted[name] for name in names)
        if n != want:
            wrong.append(f"{patterns[0]}: traced {n}, counted {want} "
                         f"({ {k: counted[k] for k in names} })")
        for name in names:
            if counted[name] == want:
                traced[name] = n
    if wrong:
        log(f"{tag} kernels traced: {json.dumps({k[:100]: c for k, c in kernel_counts.items()})}")
    check(not wrong, f"{tag}: the profiler's trace and the wrappers' counts differ: {wrong}")
    return traced


# the profiler loses a prefix of a window's device records (on the card, from
# one to ~1,600 kernels, and in two whole-script runs the prefill's kernels
# after 10,000 empty launches made back to back): a window opens with
# PAD_ROUNDS rounds of PAD_LAUNCHES launches of the empty kernel, each round
# synchronized and followed by PAD_WAIT_S of host time, which every count and
# time below leaves out; `pad_traced` says how many of them the trace kept
PAD_ROUNDS, PAD_LAUNCHES, PAD_WAIT_S = 10, 1000, 0.03
PAD_KERNEL = "empty_rows"


def profile_window(torch, tag, fn, count_steps):
    """fn() once under torch.profiler: device time by kernel name (summed over
    launches), device busy and wall time, host ops and kernels per step
    (count_steps(fn's result) steps), and each wrapper's launches as the
    profiler traced them (`launches_traced`; inside CUDA graph replays too),
    which must equal the wrappers' counts over the window (the window
    opens with PAD_ROUNDS x PAD_LAUNCHES empty launches, left out). Returns (the
    profile, or None where the profiler saw no device time; fn's result).
    Host-to-device copies are left out of the device busy time and reported
    apart: their ms, and the ms of them that overlap a kernel."""
    from torch.profiler import ProfilerActivity, profile

    from umbrella_tpu_torch.ops.kernels import launch_counts

    torch.cuda.synchronize()
    before = launch_counts()
    pad = empty_kernel(torch, torch.device("cuda", torch.cuda.current_device()), 1,
                       PAD_LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_ROUNDS):
            pad()
            torch.cuda.synchronize()
            time.sleep(PAD_WAIT_S)
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1000 * (time.time() - t0)
    counted = {k: v - before[k] for k, v in launch_counts().items()}
    by_name, kernel_counts = {}, {}
    averages = prof.key_averages()
    pad_traced = sum(e.count for e in averages if PAD_KERNEL in e.key)
    for e in averages:
        # kernels only: CPU ops repeat the device time of the kernels they launch,
        # and host-to-device copies run on the copy engines (h2d_overlap below)
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or PAD_KERNEL in e.key or e.key.startswith("Memcpy HtoD"):
            continue
        kernel_counts[e.key] = kernel_counts.get(e.key, 0) + e.count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1000.0
    if not by_name:
        log(f"{tag} the profiler recorded no device time: not measured")
        return None, out
    launches = traced_launches(f"{tag} (pad records traced {pad_traced} of "
                               f"{PAD_ROUNDS * PAD_LAUNCHES})", kernel_counts, counted)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # PyTorch ops called from Python (not ops nested inside other ops), and kernels
    host_ops = sum(1 for e in events if e.device_type != cuda and e.cpu_parent is None
                   and e.name.startswith("aten::"))
    kernels = sum(1 for e in events if e.device_type == cuda and PAD_KERNEL not in e.name)
    steps = count_steps(out)
    # the W4A16 family's kernels (w4a16_kernel and w4a16_sum_partials); the
    # int8 W4 family's (w4a8_kernel, w4a8_sum_partials, quantize_rows); the
    # attention kernels (flash_tc_kernel, flash_attend_kernel)
    w4a16 = sum(v for k, v in by_name.items() if "w4a16" in k)
    w4a8 = sum(v for k, v in by_name.items() if "w4a8" in k or "quantize_rows" in k)
    attn = sum(v for k, v in by_name.items() if "flash_tc_kernel" in k
               or "flash_attend_kernel" in k)
    res = dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy,
               device_busy_ms_per_step=busy / steps, w4a16_device_ms_per_step=w4a16 / steps,
               w4a8_device_ms_per_step=w4a8 / steps, attention_device_ms_per_step=attn / steps,
               device_idle_share=1.0 - busy / wall_ms, host_ops_per_step=host_ops / steps,
               device_kernels_per_step=kernels / steps, launches_traced=launches,
               top_kernels_ms={k[:90]: v for k, v in top}, pad_traced=pad_traced,
               **h2d_overlap(prof, torch))
    log(f"{tag} {json.dumps(res)}")
    return res, out


# ---------------------------------------------------------------- phases 5-9: serving


def batched_engine(torch, dev, target, draft, batch, tree, kv_dtype, dtype, **kw):
    from umbrella_tpu_torch.sequoia import growmap_from_spec
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    eng = AutoEngine.from_config(
        device=dev, engine="batched_static", model=target, draft_model=draft, batch_size=batch,
        growmap=growmap_from_spec(*tree), max_length=MAX_LEN, eos_token_ids=[-100],
        segment_steps=SEGMENT_STEPS, kv_dtype=kv_dtype, dtype=dtype, **kw)
    eng.initialize()
    return eng


def random_requests(seed, n, new_tokens, prompt_len=PROMPT_LEN, **sampling):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(input_ids=rng.integers(0, 120000, size=prompt_len).astype(np.int32).tolist(),
                 max_new_tokens=new_tokens, **sampling) for _ in range(n)]


def batched_lossless_check(torch, dev):
    """fp32, 4 layers, B=4 slots, more requests than slots, staggered prompt
    lengths: every request's greedy tokens from BatchedStaticEngine.run() equal
    the single-slot StaticEngine's tokens for the same prompt."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tree = (2, 3)
    target, draft = build_target(torch, dev, n_layers=4, exit_layer=2, dtype=torch.float32)
    reqs = [dict(r, input_ids=r["input_ids"][:PROMPT_LEN - PROMPT_LEN // 8 * i])
            for i, r in enumerate(random_requests(3, 7, BATCHED_LOSSLESS_TOKENS))]
    eng = batched_engine(torch, dev, target, draft, 4, tree, None, torch.float32)
    reset_launch_counts()
    outs = eng.run(reqs)
    counts = launch_counts()
    graphs = check_graphed(eng, "[batched-lossless]")
    del eng
    single = make_engine(torch, dev, target, draft, torch.float32, tree=tree)
    same, vs_ar, gaps, parted = [], [], [], []
    for r, o in zip(reqs, outs):
        want = single.generate(input_ids=r["input_ids"],
                               max_new_tokens=BATCHED_LOSSLESS_TOKENS)["generated_tokens"]
        got = o["generated_tokens"]
        same.append(first_difference(got, want))
        ar, g, _, _ = greedy_ar_decode(torch, target, r["input_ids"], len(got))
        vs_ar.append((first_difference(got, ar), first_difference(want, ar)))
        if same[-1] < BATCHED_LOSSLESS_TOKENS:
            gaps.append(g[same[-1]])
            parted.append(dict(batched=got, single=want, ar=ar))
    res = dict(requests=len(reqs), slots=4, prompt_lens=[len(r["input_ids"]) for r in reqs],
               identical_prefix=same, batched_and_single_vs_ar=vs_ar,
               ar_gaps_where_they_part=gaps,
               avg_accept_tokens=[o["avg_accept_tokens"] for o in outs], launches=counts,
               graphs=graphs)
    log(f"[batched-lossless] {json.dumps(res)}")
    check(min(same) >= BATCHED_LOSSLESS_TOKENS,
          f"[batched-lossless] batched and single-slot tokens differ: {same} {parted}")
    for name in ("attend_flash_batched", "w4a16_matmul", "w4a8f_matmul", "w4a8_quantize",
                 "embed_gather"):
        check(counts[name] > 0, f"[batched-lossless] kernel {name} was never launched")
    return res


MULTI_CARD_TOKENS = 16


def multi_card_phase(torch, dev):
    """The static and the batched engine built on the last card while cuda:0
    is current (4 layers, bf16; the batched engine with int8 KV, B=4): 16
    tokens from each must equal the same engines' tokens on cuda:0, with every
    kernel of the path launched on the last card (the ctypes kernels launch
    on their tensors' card, not the current one). Skipped on one card."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log("[multi-card] skipped: 1 card")
        return dict(skipped="1 card")
    torch.cuda.set_device(0)
    prompt = random_requests(5, 1, MULTI_CARD_TOKENS)[0]["input_ids"]
    reqs = random_requests(6, 4, MULTI_CARD_TOKENS)
    tokens, counts = {}, {}
    for d in (dev, torch.device("cuda", n_cards - 1)):
        target, draft = build_target(torch, d, n_layers=4, exit_layer=2, dtype=torch.bfloat16)
        reset_launch_counts()
        eng = make_engine(torch, d, target, draft, torch.bfloat16)
        static = eng.generate(input_ids=prompt,
                              max_new_tokens=MULTI_CARD_TOKENS)["generated_tokens"]
        del eng
        eng = batched_engine(torch, d, target, draft, 4, (2, 3), "int8", torch.bfloat16)
        batched = [o["generated_tokens"] for o in eng.run(reqs)]
        torch.cuda.synchronize(d)
        check(torch.cuda.current_device() == 0, "[multi-card] an engine changed the current card")
        tokens[str(d)], counts[str(d)] = dict(static=static, batched=batched), launch_counts()
        del eng, target, draft
        torch.cuda.empty_cache()
    first, last = tokens.values()
    res = dict(cards=n_cards, current=0, tokens=tokens, launches=counts)
    log(f"[multi-card] {json.dumps(res)}")
    check(first == last, "[multi-card] the engines on the last card give other tokens than on "
          "cuda:0")
    for name in ("embed_gather", "attend_flash", "attend_flash_batched_int8", "w4a16_matmul",
                 "w4a8f_matmul", "w4a8_quantize"):
        check(list(counts.values())[-1][name] > 0,
              f"[multi-card] kernel {name} never launched on the last card")
    return res


def decode_segment(torch, eng, reqs, tag):
    """Admit B requests, then time one synced segment of SEGMENT_STEPS steps
    at full occupancy (ms per step, kernel launches per step); profile a
    second one."""
    for b, r in enumerate(reqs):
        check(eng.admit(b, r["input_ids"]), "admission failed")
    stop = [int(eng.num_nodes[b]) + 10**6 for b in range(eng.batch_size)]
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    eng.step_many(SEGMENT_STEPS, stop)  # warm
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    steps = eng.step_many(SEGMENT_STEPS, stop)
    ms = 1000 * (time.time() - t0) / SEGMENT_STEPS
    per_step = {k: n / SEGMENT_STEPS for k, n in launch_counts().items()}
    check(int(steps.min()) == SEGMENT_STEPS, "decode segment ran short")
    prof, _ = profile_window(torch, tag, lambda: eng.step_many(SEGMENT_STEPS, stop),
                             lambda _: SEGMENT_STEPS)
    eng.active[:] = False
    return ms, per_step, prof


def pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def serve_phase(torch, dev, target, draft, tag, batch, tree, kv_dtype, n_requests,
                attn_kernel, pipelined=True, stepwise_too=False):
    """bench.py's serving rows: a warm-up run() of B requests, then n_requests
    through run(), then (optionally) all of them submitted at once to the
    pipelined ContinuousBatcher; then one profiled decode segment; all with
    the segment step replayed as a CUDA graph. stepwise_too: run() and the
    profiled segment again with the steps dispatched eagerly, side by side
    (the same tokens)."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher

    torch.cuda.reset_peak_memory_stats(dev)
    eng = batched_engine(torch, dev, target, draft, batch, tree, kv_dtype, torch.bfloat16)
    reqs = random_requests(5, n_requests, SERVE_NEW_TOKENS)
    eng.run(reqs[:batch])  # warm-up
    reset_launch_counts()
    steps0 = eng.steps_dispatched
    torch.cuda.synchronize()
    t0 = time.time()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    steps = eng.steps_dispatched - steps0
    for name in (attn_kernel, "w4a16_matmul", "w4a8f_matmul", "w4a8_quantize", "embed_gather"):
        check(counts[name] > 0, f"{tag} kernel {name} was never launched")
    check_tc_route(counts, tag)
    for r, o in zip(reqs, outs):
        toks = o["generated_tokens"]
        check(r["max_new_tokens"] <= len(toks) <= r["max_new_tokens"] + 1,
              f"{tag} request got {len(toks)} tokens")
        check(all(0 <= t < CFG_8B["vocab_size"] for t in toks), f"{tag} token out of range")
    total = sum(len(o["generated_tokens"]) for o in outs)
    res = dict(batch=batch, tree=f"{tree[0]}x{tree[1]}", kv_dtype=kv_dtype or "bf16",
               requests=n_requests, new_tokens=SERVE_NEW_TOKENS,
               run_tok_per_s=total / wall, run_s=wall, run_steps=steps,
               avg_accept_tokens=sum(o["avg_accept_tokens"] for o in outs) / len(outs),
               run_ttft_ms_p50=pct([o["ttft_ms"] for o in outs], 50),
               run_tpot_ms_p50=pct([o["time_per_output_token"] for o in outs], 50),
               launches=counts)
    if pipelined:
        batcher = ContinuousBatcher(eng)
        batcher.start()
        try:
            t0 = time.time()
            futs = [batcher.submit(**dict(r)) for r in reqs]
            pouts = [f.result(timeout=600) for f in futs]
            pwall = time.time() - t0
        finally:
            batcher.shutdown()
        same = sum(p["generated_tokens"] == o["generated_tokens"] for p, o in zip(pouts, outs))
        res.update(
            pipelined_tok_per_s=sum(len(p["generated_tokens"]) for p in pouts) / pwall,
            pipelined_s=pwall, pipelined_equal_to_run=same,
            ttft_ms_p50=pct([p["ttft_ms"] for p in pouts], 50),
            ttft_ms_p95=pct([p["ttft_ms"] for p in pouts], 95),
            tpot_ms_p50=pct([p["time_per_output_token"] for p in pouts], 50))
    step_ms, per_step, prof = decode_segment(torch, eng, reqs[:batch], f"{tag[:-1]}-profile]")
    check(prof is not None, f"{tag} the kernels' launches were not traced")
    res.update(decode_step_ms=step_ms, launches_per_step=per_step, profile=prof,
               launches_traced=prof["launches_traced"], graphs=check_graphed(eng, tag))
    if stepwise_too:  # the same requests with every segment step dispatched eagerly
        stepwise(eng)
        torch.cuda.synchronize()
        t0 = time.time()
        souts = eng.run(reqs)
        torch.cuda.synchronize()
        swall = time.time() - t0
        sstep_ms, _, sprof = decode_segment(torch, eng, reqs[:batch],
                                            tag=f"{tag[:-1]}-profile stepwise]")
        graphed(eng)
        same = sum(a["generated_tokens"] == b["generated_tokens"] for a, b in zip(souts, outs))
        res["stepwise"] = dict(run_tok_per_s=sum(len(o["generated_tokens"]) for o in souts) / swall,
                               run_s=swall, equal_to_graphed=same, decode_step_ms=sstep_ms,
                               profile=sprof)
        check(same == len(outs), f"{tag} stepwise and graphed segments gave other tokens "
              f"({same} of {len(outs)} requests equal)")
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"{tag} {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


def stochastic_phase(torch, dev, target, draft):
    """B=32 int8 KV at temperature 0.6, top-p 0.9: the stochastic verify branch
    runs, every token is in range and every request finishes its budget."""
    eng = batched_engine(torch, dev, target, draft, 32, (2, 3), "int8", torch.bfloat16)
    reqs = random_requests(7, 32, STOCHASTIC_NEW_TOKENS, temperature=0.6, topp=0.9)
    t0 = time.time()
    outs = eng.run(reqs)
    wall = time.time() - t0
    for o in outs:
        toks = o["generated_tokens"]
        check(STOCHASTIC_NEW_TOKENS <= len(toks) <= STOCHASTIC_NEW_TOKENS + 1,
              f"[serve-stochastic] request got {len(toks)} tokens")
        check(all(0 <= t < CFG_8B["vocab_size"] for t in toks),
              "[serve-stochastic] token out of range")
    res = dict(requests=len(reqs), temperature=0.6, topp=0.9,
               tok_per_s=sum(len(o["generated_tokens"]) for o in outs) / wall,
               avg_accept_tokens=sum(o["avg_accept_tokens"] for o in outs) / len(outs),
               graphs=check_graphed(eng, "[serve-stochastic]"))
    log(f"[serve-stochastic] {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- checkpoints


# config.json of the checkpoints the shipped 8B configs name, as published:
# hugging-quants/Meta-Llama-3.1-8B-Instruct-AWQ-INT4 (AutoAWQ GEMM, fp16) and
# meta-llama/Llama-3.2-1B-Instruct (bf16, tied embeddings)
TARGET_HF_CONFIG = dict(
    architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
    rope_scaling=dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                      original_max_position_embeddings=8192, rope_type="llama3"),
    tie_word_embeddings=False, bos_token_id=128000, eos_token_id=LLAMA3_EOS,
    hidden_act="silu", torch_dtype="float16",
    quantization_config=dict(quant_method="awq", bits=4, group_size=128, version="gemm",
                             zero_point=True))
DRAFT_HF_CONFIG = dict(
    architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=128256, hidden_size=2048,
    intermediate_size=8192, num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    head_dim=64, rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
    rope_scaling=dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                      original_max_position_embeddings=8192, rope_type="llama3"),
    tie_word_embeddings=True, bos_token_id=128000, eos_token_id=LLAMA3_EOS,
    hidden_act="silu", torch_dtype="bfloat16")
CONFIG_NEW_TOKENS = 128
SERVE_CONFIG_REQUESTS = 32
SERVE_CONFIG_NEW_TOKENS = 64
_ST_CODES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16", "int32": "I32",
             "int64": "I64", "int8": "I8", "uint8": "U8"}


def write_safetensors(path, specs):
    """Write a safetensors file. specs: [(name, torch dtype, shape, make)] in
    file order; make() returns that tensor (on any device). Tensors are made
    and written one at a time, so host memory holds one tensor."""
    import math
    import struct

    import torch

    header, off = {}, 0
    for name, dtype, shape, _ in specs:
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        header[name] = dict(dtype=_ST_CODES[str(dtype).split(".")[-1]], shape=list(shape),
                            data_offsets=[off, off + n])
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, dtype, shape, make in specs:
            t = make()
            check(t.dtype == dtype and tuple(t.shape) == tuple(shape), f"{name}: made {t.dtype} "
                  f"{tuple(t.shape)}, declared {dtype} {tuple(shape)}")
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())


def _proj_shapes(hf):
    """(HF projection name, in, out) of one decoder layer."""
    H, I = hf["hidden_size"], hf["intermediate_size"]
    D = hf.get("head_dim") or H // hf["num_attention_heads"]
    Hq, KV = hf["num_attention_heads"] * D, hf["num_key_value_heads"] * D
    return [("self_attn.q_proj", H, Hq), ("self_attn.k_proj", H, KV), ("self_attn.v_proj", H, KV),
            ("self_attn.o_proj", Hq, H), ("mlp.gate_proj", H, I), ("mlp.up_proj", H, I),
            ("mlp.down_proj", I, H)]


def target_specs(torch, dev, gen, hf):
    """AutoAWQ GEMM tensors of the 8B target: random packed words (nibbles
    0..15), zeros 6..9, fp16 scales U(0.0035, 0.005) so weights have std ~0.02;
    from layer 3 on the o_proj/down_proj scales are x0.05 (bench.py's damped
    tail), which keeps the residual stream near the first layers' scale."""
    f16, i32 = torch.float16, torch.int32
    H, V, g = hf["hidden_size"], hf["vocab_size"], hf["quantization_config"]["group_size"]

    def normal(shape, dtype):
        return lambda: (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def ones(n):
        return lambda: torch.ones(n, dtype=f16, device=dev)

    def words(rows, n, lo=0, hi=16):
        def make():
            nib = torch.randint(lo, hi, (rows, n // 8, 8), generator=gen, device=dev)
            w = (nib << (4 * torch.arange(8, device=dev))).sum(-1)
            return (w - ((w >> 31) << 32)).to(i32)  # uint32 bits as int32
        return make

    def scales(rows, n, damp):
        return lambda: ((torch.rand((rows, n), generator=gen, device=dev) * 0.0015 + 0.0035)
                        * damp).to(f16)

    specs = [("model.embed_tokens.weight", f16, (V, H), normal((V, H), f16))]
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs += [(p + "input_layernorm.weight", f16, (H,), ones(H)),
                  (p + "post_attention_layernorm.weight", f16, (H,), ones(H))]
        for name, k, n in _proj_shapes(hf):
            damp = 0.05 if i >= 3 and name in ("self_attn.o_proj", "mlp.down_proj") else 1.0
            specs += [(p + name + ".qweight", i32, (k, n // 8), words(k, n)),
                      (p + name + ".qzeros", i32, (k // g, n // 8), words(k // g, n, 6, 10)),
                      (p + name + ".scales", f16, (k // g, n), scales(k // g, n, damp))]
    specs += [("model.norm.weight", f16, (H,), ones(H)),
              ("lm_head.weight", f16, (V, H), normal((V, H), f16))]
    return specs


def draft_specs(torch, dev, gen, hf):
    """bf16 tensors of the 1B draft: N(0, 0.02) weights, unit norms, tied head."""
    bf16 = torch.bfloat16
    H, V = hf["hidden_size"], hf["vocab_size"]

    def normal(shape):
        return lambda: (torch.randn(shape, generator=gen, device=dev) * 0.02).to(bf16)

    def ones():
        return lambda: torch.ones(H, dtype=bf16, device=dev)

    specs = [("model.embed_tokens.weight", bf16, (V, H), normal((V, H)))]
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs += [(p + "input_layernorm.weight", bf16, (H,), ones()),
                  (p + "post_attention_layernorm.weight", bf16, (H,), ones())]
        specs += [(p + name + ".weight", bf16, (n, k), normal((n, k)))
                  for name, k, n in _proj_shapes(hf)]
    return specs + [("model.norm.weight", bf16, (H,), ones())]


def spec_bytes(torch, specs):
    import math

    return sum(math.prod(s) * torch.empty((), dtype=d).element_size() for _, d, s, _ in specs)


def _write_dir(path, hf, shards):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    for i, specs in enumerate(shards):
        write_safetensors(os.path.join(
            path, f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            if len(shards) > 1 else "model.safetensors"), specs)


def write_checkpoints(torch, dev, root):
    """The target (two shards, as published), a second target directory with
    `"awq_act": "int8"` over the same files, and the draft. If the disk cannot
    hold them, the target's depth is cut (never its width)."""
    import shutil

    free = shutil.disk_usage(root).free
    target_hf = dict(TARGET_HF_CONFIG)
    gen = torch.Generator(device=dev)
    d_bytes = spec_bytes(torch, draft_specs(torch, dev, gen, DRAFT_HF_CONFIG))
    while True:
        t_bytes = spec_bytes(torch, target_specs(torch, dev, gen, target_hf))
        if t_bytes + d_bytes + 2e9 <= free or target_hf["num_hidden_layers"] <= 4:
            break
        target_hf["num_hidden_layers"] -= 4
    log(f"[checkpoint] free disk {free / 1e9:.1f} GB; target {t_bytes / 1e9:.2f} GB at "
        f"{target_hf['num_hidden_layers']} layers, draft {d_bytes / 1e9:.2f} GB")
    check(t_bytes + d_bytes + 2e9 <= free, "[checkpoint] not enough disk even at 4 layers")
    dirs = {k: os.path.join(root, k) for k in ("target", "target-w4a8", "draft")}
    t0 = time.time()
    specs = target_specs(torch, dev, gen.manual_seed(11), target_hf)
    half = 1 + 23 * (target_hf["num_hidden_layers"] // 2)  # embed + half the layers | the rest
    _write_dir(dirs["target"], target_hf, [specs[:half], specs[half:]])
    os.makedirs(dirs["target-w4a8"])
    for f in os.listdir(dirs["target"]):
        if f.endswith(".safetensors"):
            os.symlink(os.path.join(dirs["target"], f), os.path.join(dirs["target-w4a8"], f))
    with open(os.path.join(dirs["target-w4a8"], "config.json"), "w") as f:
        json.dump(dict(target_hf, awq_act="int8"), f, indent=1)
    t_write = time.time() - t0
    t0 = time.time()
    _write_dir(dirs["draft"], DRAFT_HF_CONFIG,
               [draft_specs(torch, dev, gen.manual_seed(12), DRAFT_HF_CONFIG)])
    d_write = time.time() - t0
    torch.cuda.empty_cache()
    return dict(dirs=dirs, target_hf=target_hf, target_gb=t_bytes / 1e9, draft_gb=d_bytes / 1e9,
                target_layers=target_hf["num_hidden_layers"], free_disk_gb=free / 1e9,
                target_write_s=t_write, draft_write_s=d_write)


def _rss_gb():
    """The process's resident set now, from /proc/self/statm (None where absent)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30
    except (OSError, ValueError, IndexError):
        return None


def _timed_load(torch, dev, path, **kw):
    """AutoModelLM.from_pretrained(path), timed, with the host RSS sampled every
    5 ms by a thread during the load (its peak and its rise over the start)."""
    import threading

    from umbrella_tpu_torch.models.auto_model import AutoModelLM

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    rss0, peak, done = _rss_gb(), [_rss_gb() or 0.0], threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], _rss_gb() or 0.0)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.time()
    try:
        rt = AutoModelLM.from_pretrained(path, device=dev, **kw)
        torch.cuda.synchronize()
    finally:
        done.set()
        sampler.join()
    return rt, dict(load_s=time.time() - t0,
                    host_rss_gb_before=rss0, peak_host_rss_gb=peak[0] if rss0 else None,
                    device_gb=(torch.cuda.memory_allocated(dev) - base) / 2**30,
                    peak_device_gb=(torch.cuda.max_memory_allocated(dev) - base) / 2**30)


def checkpoint_phase(torch, dev, ckpt):
    """Load both checkpoints through AutoModelLM.from_pretrained (timed, with
    peak host RSS and device memory); the target's logits for a 16-token
    prompt must equal, bit for bit, those of the same tensors converted in
    memory (regenerated from the seed on the card)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime
    from umbrella_tpu_torch.ops.masks import causal_mask_rows
    from umbrella_tpu_torch.quantization.awq import AwqTensor
    from umbrella_tpu_torch.quantization.loader import awq_params_from_hf_state_dict

    L = 256
    target, t_load = _timed_load(torch, dev, ckpt["dirs"]["target"], max_length=L)
    log(f"[checkpoint] target loaded {t_load}")
    check(isinstance(target.params["layers"]["gate_up"][0], AwqTensor)
          and target.params["lm_head"].dtype == torch.bfloat16 and target.cfg.eos_token_ids ==
          LLAMA3_EOS and target.cfg.rope_scaling["rope_type"] == "llama3",
          "[checkpoint] target loaded in the wrong form")
    ids = torch.arange(100, 116, device=dev)
    pos = torch.arange(16, device=dev)
    mask = causal_mask_rows(0, 16, L, device=dev)

    def logits(rt):
        return rt.forward(rt.params, rt.init_kv(), ids, pos, mask, 0)[0]

    got = logits(target)
    del target
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(11)
    sd = {name: make() for name, _, _, make in target_specs(torch, dev, gen, ckpt["target_hf"])}
    cfg = ModelConfig.from_dict(ckpt["target_hf"])
    mem = ModelRuntime(cfg, awq_params_from_hf_state_dict(sd, cfg, L, device=dev), L, device=dev)
    del sd
    want = logits(mem)
    del mem
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(got).all()), "[checkpoint] target logits not finite")
    check(torch.equal(got, want), "[checkpoint] loaded target's logits differ from the in-memory "
          f"conversion: max abs diff {(got - want).abs().max().item()}")
    draft, d_load = _timed_load(torch, dev, ckpt["dirs"]["draft"], max_length=L)
    log(f"[checkpoint] draft loaded {d_load}")
    hf = DRAFT_HF_CONFIG
    qkv = (hf["num_attention_heads"] + 2 * hf["num_key_value_heads"]) * hf["head_dim"]
    check("lm_head" not in draft.params and draft.args.head_dim == hf["head_dim"]
          and draft.params["layers"]["wqkv"].shape == (hf["num_hidden_layers"],
                                                       hf["hidden_size"], qkv),
          "[checkpoint] draft loaded in the wrong form")
    d_logits = logits(draft)
    check(bool(torch.isfinite(d_logits).all()), "[checkpoint] draft logits not finite")
    del draft
    torch.cuda.empty_cache()
    res = dict({k: v for k, v in ckpt.items() if k not in ("dirs", "target_hf")},
               target=t_load, draft=d_load, logits_equal_in_memory=True)
    log(f"[checkpoint] {json.dumps(res)}")
    return res


def shipped_config(name, ckpt, target="target"):
    """A shipped config file with only model, draft_model and growmap_path
    rewritten (the checkpoints written above; the port's copy of the tree)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", name)) as f:
        cfg = json.load(f)
    tree = os.path.join(here, "umbrella_tpu_torch", "trees", os.path.basename(cfg["growmap_path"]))
    return dict(cfg, model=ckpt["dirs"][target], draft_model=ckpt["dirs"]["draft"],
                growmap_path=tree)


def code_config_phase(torch, dev, ckpt, prompt, tag, target):
    """configs/code_config_8b_awq_v5e.json as shipped (greedy, 24x6 tree, W4
    draft with a W4 head from quantize_draft: true) through AutoEngine ->
    initialize -> generate(); CONFIG_NEW_TOKENS new tokens in place of 512."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.quantization.awq import AwqTensor
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    cfg = shipped_config("code_config_8b_awq_v5e.json", ckpt, target)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    eng = AutoEngine.from_config(device=dev, **cfg)
    eng.initialize()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    w4a8 = target == "target-w4a8"
    check(eng.target_model.args.awq_act_int8 == w4a8, f"{tag} awq_act not taken from config.json")
    check(isinstance(eng.draft_model.params["layers"]["wqkv"][0], AwqTensor)
          and isinstance(eng.draft_model.params["lm_head"], AwqTensor),
          f"{tag} quantize_draft: true did not give a W4 draft and head")
    eng.generate(input_ids=prompt, max_new_tokens=16)  # warm-up
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    check(eng._prefill(prompt), f"{tag} prefill refused")
    torch.cuda.synchronize()
    ttft_ms = 1000 * (time.time() - t1)
    prefill_counts = launch_counts()
    eng.reset()
    reset_launch_counts()
    out = eng.generate(input_ids=prompt, max_new_tokens=CONFIG_NEW_TOKENS)
    counts = launch_counts()
    toks = out["generated_tokens"]
    steps = max(1, round(len(toks) / out["avg_accept_tokens"]))
    eos = set(eng.eos_token_ids)
    check(len(toks) >= CONFIG_NEW_TOKENS or toks[-1] in eos, f"{tag} stopped early: {len(toks)}")
    check(all(0 <= t < 128256 for t in toks), f"{tag} token out of range")
    kernels = ("embed_gather", "attend_flash", "w4a16_matmul") + (
        ("w4a8_matmul", "w4a8_quantize") if w4a8 else ())
    for name in kernels:
        check(counts[name] > 0, f"{tag} kernel {name} was never launched")
    check_tc_route(counts, tag)
    check(w4a8 or counts["w4a8_matmul"] == 0, f"{tag} a W4A16 target ran W4A8")
    graphs = check_graphed(eng, tag)
    (graph,) = eng._decode_graphs.values()
    # a traced request: the captured step's launches against the replays' in the trace
    replays = graph.replays
    trace, _ = profile_window(torch, f"{tag[:-1]}-trace]",
                              lambda: eng.generate(input_ids=prompt, max_new_tokens=32),
                              request_steps)
    check(trace is not None, f"{tag} the kernels' launches were not traced")
    replays = graph.replays - replays
    traced = trace["launches_traced"]
    per_step = {k: (n - prefill_counts[k]) / replays for k, n in traced.items()}
    check(all(per_step[k] == graph.launches[k] for k in per_step),
          f"{tag} launches a step traced {per_step}, captured {graph.launches}")
    res = dict(tokens=len(toks), steps=steps, tok_per_s=1000.0 / out["time_per_output_token"],
               decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
               avg_accept_tokens=out["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms,
               init_s=init_s, launches=counts, launches_per_step=graph.launches,
               launches_traced=traced, launches_per_step_traced=per_step, graphs=graphs,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"{tag} {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


def serve_config_phase(torch, dev, ckpt):
    """configs/serve_batched_8b_awq_int8kv_v5e.json as shipped (B=32, int8 KV,
    Int4F draft, 2x3 tree, temperature 0.6, segment_steps 16): 32 requests of
    PROMPT_LEN random tokens and SERVE_CONFIG_NEW_TOKENS new ones through run()."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.quantization.int4f import Int4FTensor
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    cfg = shipped_config("serve_batched_8b_awq_int8kv_v5e.json", ckpt)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    eng = AutoEngine.from_config(device=dev, **cfg)
    eng.initialize()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    check(eng.kv_target.quantized and isinstance(eng.draft_model.params["lm_head"], Int4FTensor),
          "[serve-config] int8 KV / Int4F draft not set up from the config")
    reqs = random_requests(9, SERVE_CONFIG_REQUESTS, SERVE_CONFIG_NEW_TOKENS)
    eng.run([dict(r, max_new_tokens=8) for r in reqs[:4]])  # warm-up
    reset_launch_counts()
    steps0 = eng.steps_dispatched
    torch.cuda.synchronize()
    t0 = time.time()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    eos = set(eng.eos_token_ids)
    for o in outs:
        toks = o["generated_tokens"]
        check(len(toks) <= SERVE_CONFIG_NEW_TOKENS + 1 and (
            len(toks) >= SERVE_CONFIG_NEW_TOKENS or toks[-1] in eos),
            f"[serve-config] request got {len(toks)} tokens")
        check(all(0 <= t < 128256 for t in toks), "[serve-config] token out of range")
    for name in ("attend_flash_batched_int8", "w4a16_matmul", "w4a8f_matmul", "w4a8_quantize",
                 "embed_gather"):
        check(counts[name] > 0, f"[serve-config] kernel {name} was never launched")
    check_tc_route(counts, "[serve-config]")
    graphs = check_graphed(eng, "[serve-config]")
    steps = eng.steps_dispatched - steps0
    res = dict(batch=eng.batch_size, requests=len(reqs), new_tokens=SERVE_CONFIG_NEW_TOKENS,
               temperature=eng.temperature, init_s=init_s,
               tok_per_s=sum(len(o["generated_tokens"]) for o in outs) / wall, run_s=wall,
               run_steps=steps,
               avg_accept_tokens=sum(o["avg_accept_tokens"] for o in outs) / len(outs),
               ttft_ms_p50=pct([o["ttft_ms"] for o in outs], 50), launches=counts,
               launches_per_step={k: n / max(steps, 1) for k, n in counts.items()},
               graphs=graphs, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"[serve-config] {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


PP_CONFIG_NEW_TOKENS = 64
# the decode-only profiles of [pp-config]: tokens of the graphed and of the stepwise loop
PP_PROFILE_TOKENS, PP_PROFILE_STEPWISE_TOKENS = 8, 3


def decode_profile(torch, eng, prompt, tag, decode):
    """A profile of a decode loop alone: the prompt prefilled outside the
    window, then decode(eng), which returns its steps, profiled (host ops
    and busy ms a step are the decode's); the engine reset after."""
    check(eng._prefill(prompt), f"{tag} prefill refused")
    prof, _ = profile_window(torch, tag, lambda: decode(eng), lambda steps: steps)
    eng.reset()
    check(prof is not None, f"{tag}: the kernels' launches were not traced")
    return prof


def pp_config_phase(torch, dev, ckpt, prompt):
    """configs/chat_config_70b_awq_pp4.json as shipped (pipeline_parallel 4,
    temperature 0.6, top-p 0.9, repetition penalty 1.05, top-k 32, 24x6 tree,
    max_length 8192) through AutoEngine -> initialize -> generate(). `model` is
    build_70b's staged random 70B (4 stages: on cuda:0..3 where there are 4
    cards, else all on this card); `draft_model` is the synthetic
    Meta-Llama-3.1-8B-Instruct-AWQ-INT4 directory written above, the format of
    the config's own draft. TTFT of a PROMPT_LEN prompt, then
    PP_CONFIG_NEW_TOKENS new tokens on the device-resident loop (the step
    captured as CUDA graphs) and again on the stepwise loop from the same
    generator state, which must give the same tokens: step ms, tok/s,
    accept, peak device memory, launches per step, capture ms, graph pool GB
    by device and segments a step. Each loop's decode is profiled alone
    ([pp-profile]: PP_PROFILE_TOKENS tokens graphed; [pp-profile-stepwise]:
    PP_PROFILE_STEPWISE_TOKENS stepwise): host ops a decode step (the
    graphed loop's must be under a tenth of the stepwise loop's), idle share
    and busy ms a step, traced launches equal to the counted ones."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    cards = range(torch.cuda.device_count())
    torch.cuda.synchronize()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    base = sum(torch.cuda.memory_allocated(c) for c in cards)
    t0 = time.time()
    cfg = shipped_config("chat_config_70b_awq_pp4.json", ckpt)
    target = build_70b(torch, dev, stage_devices(torch, dev), cfg["max_length"])
    torch.cuda.synchronize()
    build_s = time.time() - t0
    cfg.update(model=target, draft_model=ckpt["dirs"]["target"])
    del target
    t0 = time.time()
    eng = AutoEngine.from_config(device=dev, **cfg)
    eng.initialize()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    resident_gb = (sum(torch.cuda.memory_allocated(c) for c in cards) - base) / 2**30
    stages = eng.target_model.stage_devices
    check(len(stages) == PP_STAGES and eng.pipeline_parallel == PP_STAGES
          and (eng.temperature, eng.topp, eng.repetition_penalty) == (0.6, 0.9, 1.05),
          "[pp-config] the engine did not take the config as shipped")
    check(eng._can_decode_fused(), "[pp-config] the staged engine does not take the "
          "device-resident loop")
    eng.generate(input_ids=prompt, max_new_tokens=8)  # warm-up: captures the step
    (graph,) = eng._decode_graphs.values()
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    check(eng._prefill(prompt), "[pp-config] prefill refused")
    torch.cuda.synchronize()
    ttft_ms = 1000 * (time.time() - t1)
    prefill_counts = launch_counts()
    eng.reset()
    runs, state, eos = {}, eng._gen.get_state(), set(eng.eos_token_ids)
    for loop in ("graphed", "stepwise"):
        (graphed if loop == "graphed" else stepwise)(eng)
        eng._gen.set_state(state)
        reset_launch_counts()
        replays = graph.replays
        out = eng.generate(input_ids=prompt, max_new_tokens=PP_CONFIG_NEW_TOKENS)
        counts = launch_counts()
        toks = out["generated_tokens"]
        steps = request_steps(out)
        runs[loop] = dict(tokens=len(toks), steps=steps,
                          tok_per_s=1000.0 / out["time_per_output_token"],
                          decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
                          avg_accept_tokens=out["avg_accept_tokens"],
                          replays=graph.replays - replays, launches=counts,
                          launches_per_step={k: (counts[k] - prefill_counts[k]) / steps
                                             for k in counts})
        runs.setdefault("tokens", {})[loop] = toks
        check(len(toks) >= PP_CONFIG_NEW_TOKENS or toks[-1] in eos,
              f"[pp-config] {loop} stopped early: {len(toks)}")
    graphed(eng)
    toks = runs.pop("tokens")
    g, sw = runs["graphed"], runs["stepwise"]
    check(toks["graphed"] == toks["stepwise"],
          f"[pp-config] graphed {toks['graphed']} vs stepwise {toks['stepwise']}")
    check(g["replays"] >= g["steps"] > 0 and sw["replays"] == 0,
          f"[pp-config] graphed {g['replays']} replays, stepwise {sw['replays']}")
    check(all(0 <= t < CFG_70B["vocab_size"] for t in toks["graphed"]),
          "[pp-config] token out of range")
    counts = g["launches"]
    for name in ("embed_gather", "attend_flash", "w4a16_matmul", "w4a16_matmul_layered"):
        check(counts[name] > 0, f"[pp-config] kernel {name} was never launched")
    check_tc_route(counts, "[pp-config]")
    products = 4 * CFG_70B["num_hidden_layers"]
    check(graph.launches["w4a16_matmul_layered"] == products
          and sw["launches_per_step"]["w4a16_matmul_layered"] == products
          and prefill_counts["w4a16_matmul_layered"] == products,
          f"[pp-config] {graph.launches['w4a16_matmul_layered']} layered launches a captured "
          f"step, {sw['launches_per_step']['w4a16_matmul_layered']} a stepwise one, "
          f"{prefill_counts['w4a16_matmul_layered']} in the prefill; want {products}")
    check(all(sw["launches_per_step"][k] == graph.launches[k] for k in graph.launches),
          f"[pp-config] launches a step: stepwise {sw['launches_per_step']}, captured "
          f"{graph.launches}")
    g["profile"] = decode_profile(torch, eng, prompt, "[pp-profile]",
                                  lambda e: e._decode_fused(PP_PROFILE_TOKENS))
    stepwise(eng)
    sw["profile"] = decode_profile(torch, eng, prompt, "[pp-profile-stepwise]",
                                   lambda e: e._decode_stepwise(PP_PROFILE_STEPWISE_TOKENS))
    graphed(eng)
    host_ops = {k: r["profile"]["host_ops_per_step"] for k, r in runs.items()}
    check(10 * host_ops["graphed"] < host_ops["stepwise"],
          f"[pp-config] host ops a decode step, graphed {host_ops['graphed']} against stepwise "
          f"{host_ops['stepwise']}: not under a tenth")
    stats = graph_stats(eng)
    res = dict(stage_devices=[str(d) for d in stages], distinct_cards=len(set(stages)),
               draft_layers=eng.draft_model.args.n_layers, tokens=g["tokens"], steps=g["steps"],
               tok_per_s=g["tok_per_s"], decode_step_ms=g["decode_step_ms"],
               avg_accept_tokens=g["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms,
               build_and_stage_s=build_s, init_s=init_s, resident_gb=resident_gb,
               peak_mem_gb=(sum(torch.cuda.max_memory_allocated(c) for c in cards) - base)
               / 2**30, launches=counts, launches_per_step=graph.launches,
               graphed_equal_stepwise=True, capture_ms=graph.capture_ms,
               pool_gb_by_device=stats["pool_gb_by_device"], segments=graph.segments,
               plan=[(str(d), eager, list(names), list(hops)) for d, eager, names, hops
                     in graph.plan],
               graphed=g, stepwise=sw, profile=g["profile"],
               launches_traced=g["profile"]["launches_traced"])
    log(f"[pp-config] {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- the dynamic engine and offload

# configs/greedy_config_v5e.json's (and chat_config_v5e_16gb.json's) tree: 257 nodes
DYN_TREE = dict(width=16, num_beams=24, depth=16)
DYN_NEW_TOKENS = 32
# meta-llama/Llama-3.2-1B-Instruct's config.json: the offload configs' draft
CFG_1B = {k: v for k, v in DRAFT_HF_CONFIG.items()
          if k not in ("architectures", "hidden_act", "torch_dtype", "bos_token_id")}
OFFLOAD_LOSSLESS_LAYERS, OFFLOAD_LOSSLESS_CACHED = 6, 2
OFFLOAD_CACHED = 16  # the offload configs' num_cache_layers, for the 8B directory
OFFLOAD_NEW_TOKENS = 16
# host memory kept free beside the pinned layers (the process, the draft
# directory's reads, the 8B checkpoint files)
HOST_RESERVE_BYTES = 24 * 2**30


def dynamic_engine(torch, dev, target, draft, dtype, **kw):
    """The dynamic engine (the default: no `engine` key) with the shipped
    configs' 16 x 16 tree of 24 beams."""
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
    from umbrella_tpu_torch.speculation.dynamic_engine import DynamicEngine

    eng = AutoEngine.from_config(
        device=dev, model=target, draft_model=draft, max_length=kw.pop("max_length", MAX_LEN),
        temperature=0.0, eos_token_ids=kw.pop("eos_token_ids", [-100]), dtype=dtype,
        **dict(DYN_TREE, **kw))
    check(isinstance(eng, DynamicEngine), "from_config without an engine key: not dynamic")
    eng.initialize()
    return eng


def dynamic_bitmap(torch, dev, width, depth, seed):
    """The ancestor bitmap of a random dynamic tree as the engine builds one:
    each node of a level under a node of the level before, its row its
    parent's row and itself."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T = width * depth + 1
    bm = np.eye(T, dtype=bool)
    for lvl in range(depth):
        lo, n_prev = (0, 1) if lvl == 0 else (1 + (lvl - 1) * width, width)
        for j in range(width):
            v = 1 + lvl * width + j
            bm[v] |= bm[lo + rng.integers(n_prev)]
    return torch.as_tensor(bm, device=dev)


def dynamic_lossless_check(torch, dev, prompt):
    """fp32, full 8B widths, 4 layers (as [lossless]): dynamic spec decode
    (graphed) and an offload target's pipelined decode (its draft phase and
    tail graphed, the streamed forward eager between them), static (24x6)
    and dynamic, over the same weights (2 layers resident, 2 streamed) must
    each equal the AR decode for LOSSLESS_NEW_TOKENS tokens."""
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[dynamic-lossless]"
    target, draft = build_target(torch, dev, n_layers=4, exit_layer=2, dtype=torch.float32)
    off = OffloadModelRuntime.from_params(target.params, target.cfg, MAX_LEN, dtype=torch.float32,
                                          num_cache_layers=2, device=dev)
    check((off.n_resident, off.n_streamed) == (2, 2), f"{tag} offload split {off.n_resident}")
    res, decodes = {}, {}
    for name, (t, kind) in {"dynamic": (target, "dynamic"), "offload-static": (off, "static"),
                            "offload-dynamic": (off, "dynamic")}.items():
        eng = (dynamic_engine(torch, dev, t, draft, torch.float32) if kind == "dynamic"
               else make_engine(torch, dev, t, draft, torch.float32))
        check(eng._offload == (t is off) and eng._can_decode_fused() == (t is target),
              f"{tag} {name}: wrong decode loop")
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS)
        counts = launch_counts()
        decodes[name] = out["generated_tokens"]
        steps = request_steps(out)
        res[name] = dict(tokens=len(out["generated_tokens"]),
                         avg_accept_tokens=out["avg_accept_tokens"], launches=counts,
                         launches_per_step={k: n / steps for k, n in counts.items()})
        res[name]["graphs"] = check_graphed(eng, f"{tag} {name}")
        check(t is target or offload_plan(eng), f"{tag} {name}: not the offload step's plan")
        for k in ("attend_flash", "w4a16_matmul", "w4a8f_matmul", "embed_gather"):
            check(counts[k] > 0, f"{tag} {name}: kernel {k} was never launched")
        del eng
    n = max(len(v) for v in decodes.values())
    ar, gaps, _, _ = greedy_ar_decode(torch, target, prompt, n)
    for name, toks in decodes.items():
        same = first_difference(toks, ar)
        res[name].update(identical_prefix=same,
                         gap_at_first_difference=gaps[same] if same < len(toks) else None)
        check(len(toks) >= LOSSLESS_NEW_TOKENS and same >= LOSSLESS_NEW_TOKENS,
              f"{tag} {name} and the AR decode differ at token {same}: {toks} vs {ar}")
    log(f"{tag} {json.dumps(res)}")
    res["identical_prefix"] = min(r["identical_prefix"] for r in res.values())
    return res


def build_draft_1b(torch, dev, max_length):
    """A random bf16 draft at Llama-3.2-1B's widths (16 layers, tied head)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import random_runtime

    return random_runtime(ModelConfig(**CFG_1B), max_length, dtype=torch.bfloat16, seed=5,
                          device=dev)


def dynamic_phase(torch, dev, prompt, target, draft):
    """The dynamic engine on the 8B AWQ target (32 layers, resident) with a
    random bf16 1B draft, the shipped configs' tree (16 x 16, 24 beams):
    greedy and stochastic (temperature 0.6, top-p 0.9, repetition penalty
    1.05). Graphed (the step replayed as a CUDA graph) and stepwise decodes
    from one seed give the same tokens; tok/s, step ms, accept; a profiled
    3-token request each (host ops a step, device idle share), whose traced
    launches a step equal the captured step's."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    res = {}
    for mode, sampling in (("greedy", {}), ("stochastic", dict(
            temperature=0.6, topp=0.9, repetition_penalty=1.05))):
        tag = f"[dynamic] {mode}"
        outs, r = {}, {}
        for loop in ("graphed", "stepwise"):
            eng = dynamic_engine(torch, dev, target, draft, torch.bfloat16, seed=11)
            if loop == "stepwise":
                stepwise(eng)
            reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.time()
            check(eng._prefill(prompt), f"{tag} prefill refused")
            torch.cuda.synchronize()
            ttft_ms = 1000 * (time.time() - t1)
            prefill_counts = launch_counts()
            eng.reset()
            reset_launch_counts()
            out = eng.generate(input_ids=prompt, max_new_tokens=DYN_NEW_TOKENS, **sampling)
            counts = launch_counts()
            toks = out["generated_tokens"]
            steps = request_steps(out)
            outs[loop] = toks
            r[loop] = dict(tokens=len(toks), steps=steps,
                           tok_per_s=1000.0 / out["time_per_output_token"],
                           decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
                           avg_accept_tokens=out["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms)
            if loop == "graphed":
                r[loop]["graphs"] = check_graphed(eng, tag)
                (graph,) = eng._decode_graphs.values()
                replays = graph.replays
                # ~21,000 kernels a step: a window of 3 steps keeps the trace small (an
                # 8-step window, ~170,000 kernel records, lost ~100 of them in one run)
                prof, _ = profile_window(torch, f"[dynamic-profile] {mode}", lambda: eng.generate(
                    input_ids=prompt, max_new_tokens=3, **sampling), request_steps)
                check(prof is not None, f"{tag}: the kernels' launches were not traced")
                replays = graph.replays - replays
                per_step = {k: (n - prefill_counts[k]) / replays
                            for k, n in prof["launches_traced"].items()}
                check(all(per_step[k] == graph.launches[k] for k in per_step),
                      f"{tag} launches a step traced {per_step}, captured {graph.launches}")
                r[loop].update(profile=prof, launches=counts, launches_per_step=graph.launches,
                               launches_per_step_traced=per_step, capture_ms=graph.capture_ms)
                for k in MAIN_KERNELS:
                    check(counts[k] > 0, f"{tag}: kernel {k} was never launched")
                check_tc_route(counts, tag)
            del eng
        check(outs["graphed"] == outs["stepwise"],
              f"{tag}: graphed {outs['graphed']} vs stepwise {outs['stepwise']}")
        check(len(outs["graphed"]) >= DYN_NEW_TOKENS
              and all(0 <= t < CFG_8B["vocab_size"] for t in outs["graphed"]),
              f"{tag}: {len(outs['graphed'])} tokens or a token out of range")
        r["graphed_equal_stepwise"] = True
        res[mode] = r
        log(f"{tag} {json.dumps(r)}")
    g = res["greedy"]["graphed"]
    res.update({k: g[k] for k in ("tok_per_s", "decode_step_ms", "avg_accept_tokens",
                                  "launches", "launches_per_step")})
    return res


def dynamic_pp_phase(torch, dev, prompt, draft):
    """The dynamic engine (the shipped offload configs' 16 x 16 tree of 24
    beams, greedy) over the [dynamic] path's 8B AWQ target staged in
    PP_STAGES stages (pipeline_parallel; one card a stage where there are 4,
    else all on this card) with the random 1B draft: DYN_NEW_TOKENS tokens on
    the device-resident loop (graphed), on the stepwise loop, and on the
    unstaged target (graphed), all equal. The target is random_awq_runtime's
    8B with [dynamic]'s damped tail and W4 head, without its Int4F shared
    prefix (staging takes AWQ and dense layers only)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime, random_awq_runtime
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp

    tag = "[dynamic-pp]"
    cfg = ModelConfig(**CFG_8B)
    params = random_awq_runtime(cfg, MAX_LEN, dtype=torch.bfloat16, seed=2,
                                quantize_lm_head=True, device=dev).params
    params = dict(params, layers=damp_tail(params["layers"], 3))
    unstaged = ModelRuntime(cfg, params, MAX_LEN, dtype=torch.bfloat16, device=dev)
    staged = shard_runtime_pp(ModelRuntime(cfg, dict(params), MAX_LEN, dtype=torch.bfloat16,
                                           device=dev), stage_devices(torch, dev))
    del params
    outs, res = {}, {}
    for name, target, loop in (("graphed", staged, graphed), ("stepwise", staged, stepwise),
                               ("unstaged", unstaged, graphed)):
        kw = dict(pipeline_parallel=PP_STAGES) if target is staged else {}
        eng = dynamic_engine(torch, dev, target, draft, torch.bfloat16, seed=11, **kw)
        check(eng._can_decode_fused(), f"{tag} {name}: not on the device-resident loop")
        loop(eng)
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=DYN_NEW_TOKENS)
        counts = launch_counts()
        outs[name] = out["generated_tokens"]
        steps = request_steps(out)
        res[name] = dict(tokens=len(outs[name]), steps=steps,
                         tok_per_s=1000.0 / out["time_per_output_token"],
                         decode_step_ms=out["time_per_output_token"] * len(outs[name]) / steps,
                         avg_accept_tokens=out["avg_accept_tokens"])
        if loop is graphed:
            res[name]["graphs"] = check_graphed(eng, f"{tag} {name}")
            for k in ("embed_gather", "attend_flash", "w4a16_matmul"):
                check(counts[k] > 0, f"{tag} {name}: kernel {k} was never launched")
            check_tc_route(counts, f"{tag} {name}")
        if target is staged:
            check(counts["w4a16_matmul_layered"] > 0, f"{tag} {name}: the layered kernel was "
                  "never launched")
            res[name]["stages"] = [str(d) for d in eng.target_model.stage_devices]
        del eng
    for name in ("stepwise", "unstaged"):
        check(outs[name] == outs["graphed"], f"{tag} graphed {outs['graphed']} vs {name} "
              f"{outs[name]}")
    check(len(outs["graphed"]) >= DYN_NEW_TOKENS
          and all(0 <= t < CFG_8B["vocab_size"] for t in outs["graphed"]),
          f"{tag} {len(outs['graphed'])} tokens or a token out of range")
    res["graphed_equal_stepwise_and_unstaged"] = True
    log(f"{tag} {json.dumps(res)}")
    return res


def offload_lossless_check(torch, dev, prompt):
    """Full Llama-3.3-70B widths, OFFLOAD_LOSSLESS_LAYERS AWQ layers (tail damped
    from layer 2), bf16: the offload runtime over the same weights
    (OFFLOAD_LOSSLESS_CACHED layers resident, the rest streamed) gives the
    resident forward's logits bit for bit at a 128-token prefill and at the
    dynamic tree's 257-row verify, twice in a row; the dynamic engine over
    it (the pipelined loop: its step's draft phase and tail graphed, the
    streamed forward eager between them, and again with the whole step
    eager) commits the resident engine's (graphed) tokens with the target's
    2-layer early-exit draft."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import (ModelRuntime, early_exit_runtime,
                                                      random_awq_runtime)
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows

    tag = "[offload-lossless]"
    cfg = ModelConfig(**dict(CFG_70B, num_hidden_layers=OFFLOAD_LOSSLESS_LAYERS))
    p = random_awq_runtime(cfg, MAX_LEN, dtype=torch.bfloat16, seed=6, device=dev).params
    resident = ModelRuntime(cfg, dict(p, layers=damp_tail(p["layers"], 2)), MAX_LEN,
                            dtype=torch.bfloat16, device=dev)
    del p
    off = OffloadModelRuntime.from_params(resident.params, cfg, MAX_LEN, dtype=torch.bfloat16,
                                          num_cache_layers=OFFLOAD_LOSSLESS_CACHED, device=dev)
    check(all(t.is_pinned() for lw in off.host_layers[OFFLOAD_LOSSLESS_CACHED:]
              for v in lw.values() for t in (v if isinstance(v, tuple) else (v,))),
          f"{tag} streamed layers not in pinned memory")
    T = DYN_TREE["width"] * DYN_TREE["depth"] + 1
    bm = dynamic_bitmap(torch, dev, DYN_TREE["width"], DYN_TREE["depth"], 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {}
    for name, S, offset, mask in (
            ("prefill128", PROMPT_LEN, 0, causal_mask_rows(0, PROMPT_LEN, MAX_LEN, device=dev)),
            ("verify257", T, PROMPT_LEN, tree_mask_rows(PROMPT_LEN, bm, MAX_LEN))):
        ids = torch.randint(0, cfg.vocab_size, (S,), generator=gen, device=dev)
        pos = offset + torch.arange(S, device=dev)
        want, _ = resident.forward(resident.params, resident.init_kv(), ids, pos, mask, offset)
        reset_launch_counts()
        kv = off.init_kv()
        for _ in range(2):
            got, kv = off.streamed_forward(kv, ids, pos, mask,
                                           torch.tensor(offset, dtype=torch.int32, device=dev))
            check(torch.equal(got, want), f"{tag} {name}: streamed logits differ from resident: "
                  f"max abs diff {(got - want).abs().max().item()}")
        counts = launch_counts()
        res[name] = dict(rows=S, bit_equal=True, launches_two_forwards={
            k: counts[k] for k in ("embed_gather", "attend_flash", "w4a16_matmul")})
        check(counts["w4a16_matmul"] > 0 and counts["attend_flash"] > 0,
              f"{tag} {name}: kernels not launched")
    draft = early_exit_runtime(resident, 2)
    toks = {}
    for name, t, loop in (("resident", resident, graphed), ("offload", off, graphed),
                          ("offload-eager", off, stepwise)):
        eng = loop(dynamic_engine(torch, dev, t, draft, torch.bfloat16))
        out = eng.generate(input_ids=prompt, max_new_tokens=32)
        toks[name] = out["generated_tokens"]
        res[f"{name}_decode"] = dict(tokens=len(toks[name]),
                                     avg_accept_tokens=out["avg_accept_tokens"],
                                     ms_per_token=out["time_per_output_token"])
        if loop is graphed:
            res[f"{name}_decode"]["graphs"] = check_graphed(eng, f"{tag} {name}")
            check(t is resident or offload_plan(eng), f"{tag}: not the offload step's plan")
        else:
            check(graph_stats(eng)["graphs"] == 0, f"{tag} {name}: a graph was captured")
        graphed(eng)  # no bound method left to keep the engine in a cycle
        del eng
    same = min(first_difference(toks["resident"], toks[k]) for k in ("offload", "offload-eager"))
    res["decode_identical_prefix"] = same
    log(f"{tag} {json.dumps(res)}")
    check(len(toks["offload"]) >= 32 and toks["offload"] == toks["resident"]
          and toks["offload-eager"] == toks["resident"],
          f"{tag} offload (graphed, eager) and resident decodes differ at token {same}")
    return res


def host_available_bytes():
    """MemAvailable from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def build_offload_70b(torch, dev, max_length, cached):
    """A random AWQ Llama-3.3-70B at full widths (g128, bf16 scales, bf16
    embedding and untied head; tail wo/down scales x0.05 from layer 3 on) as
    an OffloadModelRuntime with `cached` layers on the card: each layer
    is made on the card and a streamed one moved to pinned host memory before
    the next, so the model is never whole on the card. Depth: the 80 layers
    where MemAvailable, less HOST_RESERVE_BYTES, holds the streamed ones;
    fewer otherwise (the cut is reported)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime, map_layer, to_host
    from umbrella_tpu_torch.ops.rope import rope_params
    from umbrella_tpu_torch.quantization.awq import concat_awq, quantize_pack_device

    cfg = ModelConfig(**CFG_70B)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    D = cfg.resolved_head_dim
    Hq, KV = cfg.num_attention_heads * D, cfg.num_key_value_heads * D
    gen = torch.Generator(device=dev).manual_seed(7)

    def q(k_dim, n_dim, scale=1.0):
        parts = [quantize_pack_device(torch.randn((k_dim, min(8192, n_dim - n0)), generator=gen,
                                                  device=dev) * 0.02, 128, dtype=torch.bfloat16)
                 for n0 in range(0, n_dim, 8192)]
        t = parts[0] if len(parts) == 1 else concat_awq(parts)
        return t._replace(scales=t.scales * scale) if scale != 1.0 else t

    shapes = [(H, Hq + 2 * KV), (Hq, H), (H, 2 * I), (I, H)]
    layer_bytes = sum(k // 2 * n + 2 * (k // 128) * n * 2 for k, n in shapes) + 2 * H * 2
    avail = host_available_bytes()
    n_layers = min(cfg.num_hidden_layers,
                   cached + max(0, (avail - HOST_RESERVE_BYTES) // layer_bytes))
    t0 = time.time()
    layers, pin = [], dev.type == "cuda"
    for i in range(n_layers):
        damp = 0.05 if i >= 3 else 1.0
        lw = {"input_norm": torch.ones(H, dtype=torch.bfloat16, device=dev),
              "post_norm": torch.ones(H, dtype=torch.bfloat16, device=dev),
              "wqkv": q(H, Hq + 2 * KV), "wo": q(Hq, H, damp), "gate_up": q(H, 2 * I),
              "down": q(I, H, damp)}
        layers.append(lw if i < cached else map_layer(lambda t: to_host(t, pin), lw))
        del lw
    top = {"embed": (torch.randn((V, H), generator=gen, device=dev) * 0.02).to(torch.bfloat16),
           "lm_head": (torch.randn((H, V), generator=gen, device=dev) * 0.02).to(torch.bfloat16),
           "final_norm": torch.ones(H, dtype=torch.bfloat16, device=dev),
           **rope_params(cfg, device=dev)}
    off = OffloadModelRuntime(cfg, top, layers, max_length, dtype=torch.bfloat16,
                              num_cache_layers=cached, device=dev)
    check(off.streamed_layer_bytes == layer_bytes,
          f"streamed layer {off.streamed_layer_bytes} bytes, expected {layer_bytes}")
    info = dict(n_layers=n_layers, published_layers=cfg.num_hidden_layers,
                n_resident=off.n_resident, n_streamed=off.n_streamed,
                streamed_layer_gb=layer_bytes / 1e9,
                pinned_host_gb=off.n_streamed * layer_bytes / 1e9,
                host_available_gb_before=avail / 1e9, build_s=time.time() - t0)
    return off, info


def h2d_overlap(prof, torch):
    """From a profiler trace: the host-to-device copies' total ms and the ms of
    them that overlap a kernel (any kernel but the pad), and their count."""
    cuda = torch.autograd.DeviceType.CUDA
    h2d, kern = [], []
    for e in prof.events():
        if e.device_type != cuda:
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith("Memcpy HtoD"):
            h2d.append(span)
        elif not e.name.startswith(("Memcpy", "Memset")) and PAD_KERNEL not in e.name:
            kern.append(span)
    union = []
    for s, t in sorted(kern):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t)
        else:
            union.append([s, t])
    starts = [u[0] for u in union]
    overlapped = 0.0
    for s, t in h2d:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(union) and union[i][0] < t:
            overlapped += max(0.0, min(t, union[i][1]) - max(s, union[i][0]))
            i += 1
    return dict(h2d_copies=len(h2d), h2d_ms=sum(t - s for s, t in h2d) / 1000.0,
                h2d_overlapped_ms=overlapped / 1000.0)


def pipelined_steps(eng, max_new_tokens):
    """The offload engine's pipelined loop from its prefilled prompt; returns
    the steps it ran (the committed ones and the one in flight at the stop)."""
    before = eng.decode_stats["replays"]
    eng._decode_offload_pipelined(max_new_tokens)
    return eng.decode_stats["replays"] - before


def offload_config_phase(torch, dev, ckpt, prompt):
    """configs/greedy_config_v5e.json and configs/chat_config_v5e_16gb.json as
    shipped (offload, num_cache_layers 16, dynamic 16 x 16 tree of 24 beams,
    max_length 8192; greedy, and temperature 0.6 / top-p 0.9 / penalty 1.05),
    `model` the random offloaded 70B of build_offload_70b, `draft_model` the
    synthetic Llama-3.2-1B bf16 directory written above, through
    AutoEngine.from_config -> initialize -> generate(): one request of
    OFFLOAD_NEW_TOKENS new tokens each on the captured step (the draft phase
    and the tail as CUDA graphs, the streamed forward eager between them;
    TTFT, step ms, tok/s, accept, capture ms); for the greedy config, the
    same request with the whole step eager (the same tokens, its step ms),
    streamed_forward_traced at the 257-row verify (compute and exposed stream
    ms per layer, H2D GB/s per streamed layer), and 2 tokens of each loop's
    decode profiled alone (host ops a step; [offload-profile], the graphed
    one, whose host-to-device copies must overlap compute kernels, and
    [offload-profile-eager]); peak device GB and pinned host GB."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.ops.masks import tree_mask_rows
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
    from umbrella_tpu_torch.speculation.dynamic_engine import DynamicEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    here = os.path.dirname(os.path.abspath(__file__))
    cfgs = {}
    for name in ("greedy_config_v5e.json", "chat_config_v5e_16gb.json"):
        with open(os.path.join(here, "configs", name)) as f:
            cfgs[name] = json.load(f)
    (cached,) = {c["num_cache_layers"] for c in cfgs.values()}
    (max_length,) = {c["max_length"] for c in cfgs.values()}
    off, info = build_offload_70b(torch, dev, max_length, cached)
    log(f"[offload-config] target {json.dumps(info)}")
    res = dict(target=info)
    for name, cfg in cfgs.items():
        tag = f"[offload-config] {name}"
        eng = AutoEngine.from_config(device=dev, **dict(cfg, model=off,
                                                        draft_model=ckpt["dirs"]["draft"]))
        eng.initialize()
        check(isinstance(eng, DynamicEngine) and eng._offload and eng.tree_size == 257
              and eng.target_model.n_resident == cfg["num_cache_layers"],
              f"{tag}: not a dynamic engine over the offloaded target")
        reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        check(eng._prefill(prompt), f"{tag} prefill refused")
        torch.cuda.synchronize()
        ttft_ms = 1000 * (time.time() - t1)
        prefill_counts = launch_counts()
        eng.reset()
        greedy, use_pen = eng._sampling_mode()
        graph = eng._decode_graph(greedy, eng.topk, use_pen)  # captured before the timed request
        check(offload_plan(eng), f"{tag}: not the offload step's plan: {graph.plan}")
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=OFFLOAD_NEW_TOKENS)
        counts = launch_counts()
        toks = out["generated_tokens"]
        steps = request_steps(out)
        check(len(toks) >= OFFLOAD_NEW_TOKENS or toks[-1] in set(eng.eos_token_ids),
              f"{tag} stopped early: {len(toks)}")
        check(all(0 <= t < CFG_70B["vocab_size"] for t in toks), f"{tag} token out of range")
        for k in ("embed_gather", "attend_flash", "w4a16_matmul"):
            check(counts[k] > 0, f"{tag}: kernel {k} was never launched")
        check_tc_route(counts, tag)
        r = dict(tokens=len(toks), steps=steps, tok_per_s=1000.0 / out["time_per_output_token"],
                 decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
                 avg_accept_tokens=out["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms,
                 temperature=eng.temperature, launches=counts,
                 launches_per_step={k: (n - prefill_counts[k]) / steps
                                    for k, n in counts.items()},
                 graphs=check_graphed(eng, tag), capture_ms=graph.capture_ms,
                 launches_per_step_graphs=graph.launches)
        if name.startswith("greedy"):
            # the verify's streamed forward, layer by layer
            gen = torch.Generator(device=dev).manual_seed(9)
            ids = torch.randint(0, CFG_70B["vocab_size"], (eng.tree_size,), generator=gen,
                                device=dev)
            bm = dynamic_bitmap(torch, dev, eng.tree_width, eng.tree_depth, 1)
            pos = PROMPT_LEN + eng._depth
            mask = tree_mask_rows(PROMPT_LEN, bm, max_length)
            _, _, stats = off.streamed_forward_traced(eng.kv_target, ids, pos, mask, PROMPT_LEN)
            per = stats.pop("per_layer")
            stats.pop("per_layer_head")
            streamed = [p for p in per if "copy_ms" in p]
            resident_rows = [p for p in per if "copy_ms" not in p]
            gbps = [p["h2d_gbps"] for p in streamed if p["h2d_gbps"] is not None] or [None]
            stats.update(
                resident_compute_ms_mean=sum(p["compute_ms"] for p in resident_rows)
                / max(len(resident_rows), 1),
                streamed_compute_ms_mean=sum(p["compute_ms"] for p in streamed)
                / max(len(streamed), 1),
                streamed_exposed_ms_mean=sum(p["stream_exposed_ms"] for p in streamed)
                / max(len(streamed), 1),
                h2d_gbps_min=min(gbps, key=lambda g: g or 0),
                h2d_gbps_max=max(gbps, key=lambda g: g or 0),
                per_layer=[{k: round(v, 4) if isinstance(v, float) else v for k, v in p.items()}
                           for p in per])
            r["traced_forward_verify257"] = stats
            log(f"{tag} streamed_forward_traced {json.dumps(stats)}")
            eng.reset()
            # the same request with the whole step eager (PR 10's loop): the same tokens
            stepwise(eng)
            eager = eng.generate(input_ids=prompt, max_new_tokens=OFFLOAD_NEW_TOKENS)
            check(eager["generated_tokens"] == toks,
                  f"{tag}: graphed {toks} vs eager {eager['generated_tokens']}")
            r["eager"] = dict(decode_step_ms=eager["time_per_output_token"] * len(toks)
                              / request_steps(eager),
                              tok_per_s=1000.0 / eager["time_per_output_token"],
                              equal_to_graphed=True)
            # the decode alone, prefill outside the window: every step run (the
            # in-flight one too)
            r["profile_eager"] = decode_profile(torch, eng, prompt, "[offload-profile-eager]",
                                                lambda e: pipelined_steps(e, 2))
            graphed(eng)
            prof = decode_profile(torch, eng, prompt, "[offload-profile]",
                                  lambda e: pipelined_steps(e, 2))
            r["profile"] = prof
            check(prof["h2d_copies"] > 0 and prof["h2d_overlapped_ms"] > 0,
                  f"{tag}: the streamed layers' copies did not overlap compute kernels: "
                  f"{ {k: prof[k] for k in ('h2d_copies', 'h2d_ms', 'h2d_overlapped_ms')} }")
        res[name] = r
        log(f"{tag} {json.dumps({k: v for k, v in r.items() if not k.startswith('profile')})}")
        del eng
        gc.collect()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    res["pinned_host_gb"] = info["pinned_host_gb"]
    log(f"[offload-config] peak device {res['peak_mem_gb']:.2f} GB, pinned host "
        f"{res['pinned_host_gb']:.2f} GB")
    g = res["greedy_config_v5e.json"]
    res.update(launches=g["launches"], launches_per_step=g["launches_per_step"])
    del off
    return res


def offload_checkpoint_phase(torch, dev, ckpt):
    """The 8B AutoAWQ directory loaded with offload: true, num_cache_layers 16
    (16 layers on the card, 16 streamed from pinned memory; half the layers
    each where [checkpoint] cut the depth): its logits for a PROMPT_LEN prompt
    equal the resident load's bit for bit."""
    from umbrella_tpu_torch.models.auto_model import AutoModelLM
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    L = 256
    path = ckpt["dirs"]["target"]
    cached = min(OFFLOAD_CACHED, ckpt["target_layers"] // 2)
    t0 = time.time()
    off = AutoModelLM.from_pretrained(path, offload=True, num_cache_layers=cached, max_length=L,
                                      device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    check(isinstance(off, OffloadModelRuntime)
          and (off.n_resident, off.n_streamed) == (cached, ckpt["target_layers"] - cached),
          f"[offload-checkpoint] not an offload runtime with {cached} resident layers")
    res_rt = AutoModelLM.from_pretrained(path, max_length=L, device=dev)
    ids = torch.arange(PROMPT_LEN, device=dev) * 7 % res_rt.cfg.vocab_size
    pos = torch.arange(PROMPT_LEN, device=dev)
    mask = causal_mask_rows(0, PROMPT_LEN, L, device=dev)
    want, _ = res_rt.forward(res_rt.params, res_rt.init_kv(), ids, pos, mask, 0)
    got, _ = off.streamed_forward(off.init_kv(), ids, pos, mask, 0)
    check(bool(torch.isfinite(got).all()), "[offload-checkpoint] logits not finite")
    check(torch.equal(got, want), "[offload-checkpoint] offload logits differ from the resident "
          f"load's: max abs diff {(got - want).abs().max().item()}")
    res = dict(load_s=load_s, n_resident=off.n_resident, n_streamed=off.n_streamed,
               pinned_host_gb=off.n_streamed * off.streamed_layer_bytes / 1e9,
               logits_equal_resident=True)
    log(f"[offload-checkpoint] {json.dumps(res)}")
    del off, res_rt
    return res


# ---------------------------------------------------------------- main

KERNEL_META = {
    "embed_gather": ("umbrella_tpu_torch/csrc/embed_gather.cu",
                     "umbrella_tpu/ops/pallas/embed_gather.py:60"),
    # the tree_attention family: each kernel's own pallas_call (attend_flash
    # launches both _flash_kernel and _flash_kernel_q)
    "attend_flash": ("umbrella_tpu_torch/csrc/tree_attention.cu",
                     "umbrella_tpu/ops/pallas/tree_attention.py:449"),
    "attend_flash_int8": ("umbrella_tpu_torch/csrc/tree_attention.cu",
                          "umbrella_tpu/ops/pallas/tree_attention.py:438"),
    "attend_flash_batched": ("umbrella_tpu_torch/csrc/tree_attention.cu",
                             "umbrella_tpu/ops/pallas/tree_attention.py:349"),
    "attend_flash_batched_int8": ("umbrella_tpu_torch/csrc/tree_attention.cu",
                                  "umbrella_tpu/ops/pallas/tree_attention.py:338"),
    "w4a16_matmul": ("umbrella_tpu_torch/csrc/w4a16.cu", "umbrella_tpu/ops/pallas/w4a16.py:233"),
    "w4a8f_matmul": ("umbrella_tpu_torch/csrc/w4a8.cu", "umbrella_tpu/ops/pallas/w4a8f.py:97"),
    "w4a16_gate_up_silu": ("umbrella_tpu_torch/csrc/w4a16.cu",
                           "umbrella_tpu/ops/pallas/w4a16.py:158"),
    "w4a8_matmul": ("umbrella_tpu_torch/csrc/w4a8.cu", "umbrella_tpu/ops/pallas/w4a8.py:85"),
    # the int8 W4 kernels' fused quantizer: the activation quantization that the
    # jitted w4a8f_matmul runs before its pallas_call (w4a8_matmul's at :100-102)
    "w4a8_quantize": ("umbrella_tpu_torch/csrc/w4a8.cu", "umbrella_tpu/ops/pallas/w4a8f.py:105"),
    # w4a16_matmul's layered mode: the same function's scalar-prefetch pallas_call
    "w4a16_matmul_layered": ("umbrella_tpu_torch/csrc/w4a16.cu",
                             "umbrella_tpu/ops/pallas/w4a16.py:303"),
}
# the kernels of the static main path (phase 4)
MAIN_KERNELS = ("embed_gather", "attend_flash", "w4a16_matmul", "w4a8f_matmul", "w4a8_quantize")
# the phase whose run a kernel's `launches` is read from: its main path. No
# shipped config reaches w4a16_gate_up_silu (nor does the JAX package's default
# routing): its launches are awq_gate_up_silu(fused=True)'s, in [kernels]
LAUNCHES_FROM = {"attend_flash_int8": "lossless-int8", "attend_flash_batched": "serve-bf16",
                 "attend_flash_batched_int8": "serve", "w4a8_matmul": "code-config-w4a8",
                 "w4a16_gate_up_silu": "kernels", "w4a16_matmul_layered": "pp-config"}
# the phases of the dynamic engine and the offload tier: each kernel's launches a
# step there (the dynamic main path's from its captured step)
NEW_PATHS = ("dynamic", "offload-config")
# the per-shape timings of the offload configs' shapes ([kernels]): W4A16 at the
# 70B layer shapes at S=256 and 257, attention at the 257-row verify and a 1B level
NEW_SHAPES = ("70B wqkv S=25", "70B wo S=25", "70B gate_up S=25", "70B down S=25",
              "70B dynamic verify", "1B draft level")
# the profiled window of each phase in which the profiler counted the
# kernels' launches (held there against the wrappers' counts)
TRACED_IN = {"main": "[profile] graphed: a 64-token generate()",
             "lossless-int8": "[lossless-int8]: its generate()",
             "serve": "[serve-profile]: one segment of 8 steps",
             "serve-bf16": "[serve-bf16-profile]: one segment of 8 steps",
             "code-config-w4a8": "[code-config-w4a8-trace]: a 32-token generate()",
             "pp-config": "[pp-profile]: 8 tokens of the graphed decode loop (prefill "
                          "outside the window)"}
CHECKPOINT_PHASES = ("checkpoint", "code-config", "code-config-w4a8", "serve-config",
                     "pp-config", "offload-checkpoint", "offload-config")
PHASES = ("kernels", "multi-card", "lossless", "lossless-int8", "lossless-w4a8",
          "batched-lossless", "pp-lossless", "dynamic-lossless", "offload-lossless", "main",
          "graph", "dynamic", "dynamic-pp", "serve", "serve-bf16",
          "serve-stochastic") + CHECKPOINT_PHASES
# phases that run only when named in --phases: `w4a16`, `w4a8` and
# `attention` are subsets of `kernels`
SUBSET_PHASES = ("w4a16", "w4a8", "attention")


def run(torch, phases):
    import numpy as np

    from umbrella_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    log(f"[card] {torch.cuda.get_device_name(0)}; {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t_all = time.time()

    t0 = time.time()
    build.build_all(verbose=True)
    log(f"[build] {len(build.sources())} kernel sources in {time.time() - t0:.1f} s")

    results = {}

    def phase(name, fn, *args):
        if name not in phases:
            return None
        t0 = time.time()
        results[name] = fn(*args)
        log(f"[{name}] done in {time.time() - t0:.1f} s")
        gc.collect()  # engines the phase dropped, with their graphs' memory pools
        torch.cuda.empty_cache()
        return results[name]

    prompt = np.random.default_rng(0).integers(0, 120000, size=PROMPT_LEN).astype(np.int32)
    report = phase("kernels", kernel_checks, torch, dev)
    phase("w4a16", w4a16_phase, torch, dev)
    phase("w4a8", w4a8_phase, torch, dev)
    phase("attention", attention_phase, torch, dev)
    phase("multi-card", multi_card_phase, torch, dev)
    phase("lossless", lossless_check, torch, dev, prompt.tolist())
    phase("lossless-int8", lossless_check, torch, dev, prompt.tolist(), "int8")
    phase("lossless-w4a8", lossless_check, torch, dev, prompt.tolist(), None, "int8")
    phase("batched-lossless", batched_lossless_check, torch, dev)
    phase("pp-lossless", pp_lossless_check, torch, dev, prompt.tolist())
    phase("dynamic-lossless", dynamic_lossless_check, torch, dev, prompt.tolist())
    phase("offload-lossless", offload_lossless_check, torch, dev, prompt.tolist())

    if {"main", "graph", "dynamic", "dynamic-pp", "serve", "serve-bf16",
            "serve-stochastic"} & set(phases):
        t0 = time.time()
        target, draft = build_target(torch, dev, n_layers=32, exit_layer=3, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[setup] 8B target and draft built in {time.time() - t0:.1f} s")
        phase("main", main_path, torch, dev, prompt.tolist(), target, draft)
        phase("graph", graph_phase, torch, dev, prompt.tolist(), target, draft)
        if {"dynamic", "dynamic-pp"} & set(phases):
            draft_1b = build_draft_1b(torch, dev, MAX_LEN)
            phase("dynamic", dynamic_phase, torch, dev, prompt.tolist(), target, draft_1b)
            phase("dynamic-pp", dynamic_pp_phase, torch, dev, prompt.tolist(), draft_1b)
            del draft_1b
        phase("serve", serve_phase, torch, dev, target, draft, "[serve]", 32, (2, 3), "int8",
              64, "attend_flash_batched_int8", True, True)
        phase("serve-bf16", serve_phase, torch, dev, target, draft, "[serve-bf16]", 8, (3, 4),
              None, 16, "attend_flash_batched", False)
        phase("serve-stochastic", stochastic_phase, torch, dev, target, draft)
        del target, draft
        torch.cuda.empty_cache()

    if set(CHECKPOINT_PHASES) & set(phases):
        import shutil
        import tempfile

        os.makedirs(build.BUILD_DIR, exist_ok=True)
        root = tempfile.mkdtemp(prefix="checkpoints-", dir=build.BUILD_DIR)
        try:
            ckpt = write_checkpoints(torch, dev, root)
            phase("checkpoint", checkpoint_phase, torch, dev, ckpt)
            phase("code-config", code_config_phase, torch, dev, ckpt, prompt.tolist(),
                  "[code-config]", "target")
            phase("code-config-w4a8", code_config_phase, torch, dev, ckpt, prompt.tolist(),
                  "[code-config-w4a8]", "target-w4a8")
            phase("serve-config", serve_config_phase, torch, dev, ckpt)
            phase("pp-config", pp_config_phase, torch, dev, ckpt, prompt.tolist())
            phase("offload-checkpoint", offload_checkpoint_phase, torch, dev, ckpt)
            phase("offload-config", offload_config_phase, torch, dev, ckpt, prompt.tolist())
        finally:
            shutil.rmtree(root, ignore_errors=True)

    if set(phases) != set(PHASES):
        log(f"[partial] phases {sorted(phases)} passed in {time.time() - t_all:.1f} s on {card}")
        return
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        src = LAUNCHES_FROM.get(name, "main")
        r = report[name]
        path = r if src == "kernels" else results[src]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path["launches"][name], max_abs_err=r["max_abs_err"], matched=True,
            tolerance=r["tolerance"], shape=r["shape"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            timed_by=TIMED_BY,
            **{k: r[k] for k in ("plain_timed_by", "events_ms", "launch_floor_ms") if k in r},
            launches_per_step=path["launches_per_step"][name],
            launches_from=("kernels: awq_gate_up_silu(fused=True), which no shipped config "
                           "reaches" if src == "kernels" else src),
            launches_traced=(None if src == "kernels" else
                             path["launches_traced"].get(name)),
            launches_traced_in=TRACED_IN.get(src),
            launches_per_step_in={p: results[p]["launches_per_step"][name]
                                  for p in NEW_PATHS if results[p]["launches_per_step"][name]},
            **({"offload_config_shapes": {k: v for k, v in r["per_shape"].items()
                                          if k.startswith(NEW_SHAPES)}}
               if "per_shape" in r else {})))
    main, serve = results["main"], results["serve"]
    summary = {k: main[k] for k in ("tok_per_s", "decode_step_ms", "avg_accept_tokens",
                                    "ttft_ms_prefill128", "spec_vs_ar_common_prefix")}
    if main["profile"]:
        summary["device_idle_share"] = main["profile"]["device_idle_share"]
    summary["serve"] = {k: serve[k] for k in (
        "run_tok_per_s", "pipelined_tok_per_s", "avg_accept_tokens", "decode_step_ms",
        "ttft_ms_p50", "ttft_ms_p95", "tpot_ms_p50", "peak_mem_gb")}
    summary["serve-bf16"] = {k: results["serve-bf16"][k] for k in (
        "run_tok_per_s", "avg_accept_tokens", "decode_step_ms")}

    def idle(prof):
        return prof and {k: prof[k] for k in ("device_idle_share", "host_ops_per_step",
                                              "device_busy_ms_per_step")}

    # graphed (the decode loop's step replayed as a CUDA graph) beside stepwise
    summary["graphed_vs_stepwise"] = {
        "main": {mode: dict({k: main[mode][k] for k in (
            "tok_per_s", "decode_step_ms", "ttft_ms_prefill128", "replays", "noop_replays",
            "host_reads")}, profile=main[mode]["profile"] and dict(
                idle(main[mode]["profile"]), **{k: main[mode]["profile"].get(k) for k in (
                    "replays", "noop_replays", "capture_ms", "graph_pool_gb")}))
            for mode in ("graphed", "stepwise")},
        "serve": {"graphed": dict(run_tok_per_s=serve["run_tok_per_s"],
                                  decode_step_ms=serve["decode_step_ms"],
                                  profile=idle(serve["profile"]), graphs=serve["graphs"]),
                  "stepwise": dict({k: serve["stepwise"][k] for k in (
                      "run_tok_per_s", "decode_step_ms", "equal_to_graphed")},
                      profile=idle(serve["stepwise"]["profile"]))},
        "graph": {k: v for k, v in results["graph"].items()}}
    summary["lossless"] = results["lossless"]["identical_prefix"]
    summary["lossless-int8"] = results["lossless-int8"]["identical_prefix"]
    summary["batched-lossless"] = results["batched-lossless"]["identical_prefix"]
    summary["lossless-w4a8"] = results["lossless-w4a8"]["identical_prefix"]
    summary["checkpoint"] = {k: results["checkpoint"][k] for k in (
        "target_write_s", "draft_write_s", "target", "draft", "target_layers")}
    for name in ("code-config", "code-config-w4a8"):
        summary[name] = {k: results[name][k] for k in (
            "tok_per_s", "decode_step_ms", "avg_accept_tokens", "ttft_ms_prefill128")}
    summary["code-config-w4a8"]["w4a8_launches_per_step"] = \
        results["code-config-w4a8"]["launches_per_step"]["w4a8_matmul"]
    summary["serve-config"] = {k: results["serve-config"][k] for k in (
        "tok_per_s", "avg_accept_tokens", "peak_mem_gb")}
    summary["pp-lossless"] = {kv: (r["identical_to_unstaged"], r["identical_to_ar"])
                              for kv, r in results["pp-lossless"].items()}
    pp = results["pp-config"]
    summary["pp-config"] = {k: pp[k] for k in (
        "tok_per_s", "decode_step_ms", "avg_accept_tokens", "ttft_ms_prefill128",
        "peak_mem_gb", "distinct_cards", "capture_ms", "pool_gb_by_device", "segments")}
    summary["pp-config"]["device_idle_share"] = pp["profile"]["device_idle_share"]
    summary["graphed_vs_stepwise"]["pp-config"] = {
        loop: dict({k: pp[loop][k] for k in ("tok_per_s", "decode_step_ms", "replays")},
                   profile=idle(pp[loop]["profile"])) for loop in ("graphed", "stepwise")}
    # device ms a step in each profile: the attention kernels, W4A16, the int8 W4 family
    profiles = {"profile": main["profile"], "serve-profile": serve["profile"],
                "pp-profile": results["pp-config"]["profile"]}
    summary["device_ms_per_step"] = {
        tag: {k: prof[f"{k}_device_ms_per_step"] for k in ("attention", "w4a16", "w4a8")}
        for tag, prof in profiles.items() if prof}
    dyn = results["dynamic"]
    summary["dynamic"] = {mode: dict({k: dyn[mode]["graphed"][k] for k in (
        "tok_per_s", "decode_step_ms", "avg_accept_tokens", "ttft_ms_prefill128")},
        stepwise_tok_per_s=dyn[mode]["stepwise"]["tok_per_s"],
        graphed_equal_stepwise=dyn[mode]["graphed_equal_stepwise"],
        profile=idle(dyn[mode]["graphed"]["profile"])) for mode in ("greedy", "stochastic")}
    summary["dynamic-pp"] = {k: {m: r[m] for m in ("tok_per_s", "decode_step_ms", "stages")
                                 if m in r}
                             for k, r in results["dynamic-pp"].items() if isinstance(r, dict)}
    summary["dynamic-lossless"] = results["dynamic-lossless"]["identical_prefix"]
    summary["offload-lossless"] = results["offload-lossless"]["decode_identical_prefix"]
    summary["offload-checkpoint"] = results["offload-checkpoint"]["logits_equal_resident"]
    oc = results["offload-config"]
    summary["offload-config"] = dict(
        target=oc["target"], peak_mem_gb=oc["peak_mem_gb"], pinned_host_gb=oc["pinned_host_gb"],
        **{name: {k: oc[name][k] for k in ("tok_per_s", "decode_step_ms", "avg_accept_tokens",
                                           "ttft_ms_prefill128")}
           for name in ("greedy_config_v5e.json", "chat_config_v5e_16gb.json")})
    g = oc["greedy_config_v5e.json"]
    summary["offload-config"]["verify257"] = {k: g["traced_forward_verify257"][k] for k in (
        "compute_ms", "stream_exposed_ms", "stream_ms", "h2d_gbps", "h2d_gbps_min",
        "h2d_gbps_max", "streamed_exposed_ms_mean", "streamed_compute_ms_mean")}
    summary["offload-config"]["profile"] = dict(idle(g["profile"]), **{
        k: g["profile"][k] for k in ("h2d_copies", "h2d_ms", "h2d_overlapped_ms")})
    summary["graphed_vs_stepwise"]["offload-config"] = {
        "graphed": dict(decode_step_ms=g["decode_step_ms"], capture_ms=g["capture_ms"],
                        profile=idle(g["profile"])),
        "eager": dict(decode_step_ms=g["eager"]["decode_step_ms"],
                      profile=idle(g["profile_eager"]))}
    summary["seconds"] = time.time() - t_all
    log(f"[summary] {json.dumps(summary)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card[0] if card else "nvidia-smi: no card", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def main():
    phases = PHASES
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":  # a subset, for debugging
        phases = tuple(sys.argv[2].split(","))
        unknown = set(phases) - set(PHASES) - set(SUBSET_PHASES)
        if unknown:
            print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
            return 2
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
        run(torch, phases)
    except Exception:  # report the failed phase and exit non-zero
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # skip interpreter teardown, which can stall after CUDA work
