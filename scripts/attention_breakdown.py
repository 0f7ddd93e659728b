#!/usr/bin/env python3
"""Where the tensor-core attention kernel's time goes, and how its rounding
depends on where a row's keys sit, on one NVIDIA GPU.

    python3 scripts/attention_breakdown.py

Builds `umbrella_tpu_torch/csrc/tree_attention.cu` and three variants of it,
each changed by a source patch (applied to a copy under build/breakdown/),
and times them at the shapes of `PERF.md`'s kernel table rows 1-4 and the 70B
verify shape, beside the scalar kernel of the same source (the one fp32 q
takes, and bf16 q took before the tensor-core kernel; launched here on bf16
q) and SDPA:
  kernel      the kernel as it is;
  no-softmax  the exponentials, sums and rescales left out (P is the raw
              score): the TMA stream, the live bits and both products;
  no-pv       no P V wgmma (P kept live);
  no-qk       no Q K^T wgmma;
  stream      none of the three: the TMA ring, the live bits and the waits;
  startup     no KV tile at all: the Q tile, the live flags and the output;
  float-max   a float running max (rescales by 2^(m - m'), rounded), the
              earlier form of this kernel: layout check only.
The variants compute wrong results; the kernel and the scalar kernel are
checked against the plain version. Times are chip_smoke.cuda_ms (CUDA-graph
replay), in the order of ROUNDS (kernel first and last).

Then the layout check: each row of a 24x6 verify tree (q [127, 64, 128]
against 8 kv heads, ancestors at tree slots after a prefix of nn slots) is
computed again as an AR step would compute it, one row with the same keys
at contiguous slots, and the bf16 outputs that differ are counted, for the
scalar kernel, the tensor-core kernel and float-max. Prints one JSON line with the
times, the bounds, the counts, and the card's name and power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

from breakdown_build import build_variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SOFTMAX = "        // the online softmax;"
_AFTER_SOFTMAX = "        // P as the A fragments"
_PV = ("        for (int j = 0; j < 4; ++j) wgmma_pv<D>(o, pa[j], "
       "desc_mn128(v_addr + j * 16 * 128));\n")
_NO_PV = ("        for (int j = 0; j < 4; ++j)\n"
          "            if (v_addr == 1) o[j] += __uint_as_float(pa[j][0] ^ pa[j][3]);\n")
_QK = ("            wgmma_qk(sc, desc_sw128(q_addr + (kk / 4) * kBox) + 2 * (kk % 4),\n"
       "                     desc_sw128(k_addr + (kk / 4) * kBox) + 2 * (kk % 4), kk);\n")
_NO_QK = "            if (k_addr == 1) sc[kk] += 1.f;\n"
_TILE0 = "        if (n_tiles > 0) load_tile(0, 0);\n"
_PRODUCER_LOOP = "        for (int t = 0; t < n_tiles; ++t) {\n"
_CONSUMER_LOOP = "    while (t < n_tiles) {\n"
_INT_MAX = [("fmaxf(m[hh], ceilf(mx))", "fmaxf(m[hh], mx)"),
            ("exp2_int(m[hh] - m_new)", "ex2(m[hh] - m_new)"),
            ("exp2_int(m[hh] - mm), a1 = exp2_int(m1 - mm)", "ex2(m[hh] - mm), a1 = ex2(m1 - mm)")]
VARIANTS = ("kernel", "no-softmax", "no-pv", "no-qk", "stream", "startup", "float-max")
ROUNDS = ["kernel", "scalar", "no-softmax", "no-pv", "no-qk", "stream", "startup", "kernel"]


def patched(src, name):
    if name == "kernel":
        return src
    if name in ("no-softmax", "stream"):
        i, j = src.index(_SOFTMAX), src.index(_AFTER_SOFTMAX)
        src = src[:i] + src[j:]
        if name == "no-softmax":
            return src
    patches = {"no-pv": [(_PV, _NO_PV)], "no-qk": [(_QK, _NO_QK)],
               "stream": [(_PV, _NO_PV), (_QK, _NO_QK)],
               "startup": [(_TILE0, ""),
                           (_PRODUCER_LOOP, "        for (int t = 0; false; ++t) {\n"),
                           (_CONSUMER_LOOP, "    while (false) {\n")],
               "float-max": _INT_MAX}[name]
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source no longer has {old!r} once")
        src = src.replace(old, new)
    return src


def use(ta, torch, lib, scalar):
    """Route bf16 q through `lib`'s tensor-core entry point, or (scalar) through
    the scalar kernel's."""
    ta._fn = use.real_fn
    ta._fn.cache_clear()
    real_plan = use.real_plan

    def plan(B, S, H, KVH, L, D, q_dtype, kv_int8):
        if scalar:  # the plan fp32 q gets: the scalar kernel, which takes bf16 too
            return real_plan(B, S, H, KVH, L, D, torch.float32, kv_int8)
        return real_plan(B, S, H, KVH, L, D, q_dtype, kv_int8)

    ta._plan = plan
    if lib is not None:
        real_fn = use.real_fn
        fn = ctypes.CDLL(lib).attend_flash_tc
        fn.argtypes = real_fn("attend_flash_tc").argtypes
        fn.restype = ctypes.c_int
        ta._fn = lambda name: fn if name == "attend_flash_tc" else real_fn(name)


def cases(torch, dev, chip_smoke):
    """name -> (kernel call, plain call, SDPA call or None, bound ms)."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.models.kv_cache import _quantize_block
    from umbrella_tpu_torch.ops.kernels import tree_attention as ta
    from umbrella_tpu_torch.ops.masks import (causal_mask_rows, tree_mask_rows,
                                              tree_mask_rows_batched)
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def sdpa(q, k, v, mask):  # q [B, S, H, D], k/v [B, KVH, live, D], mask [B, S, live]
        return lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                                      attn_mask=mask[:, None], enable_gqa=True)

    def bound(mask, H, limits, int8):
        return chip_smoke.attention_bound(torch, mask, limits, H, 8, 128, int8)[0]

    gm = growmap_from_spec(24, 6, acc=chip_smoke.ACC_24x6)
    out = {}
    for H, L in ((32, 2048), (64, 8192)):
        k, v = randn(2, 8, L, 128), randn(2, 8, L, 128)
        mask = tree_mask_rows(301, torch.as_tensor(gm.bitmap, device=dev), L)
        q = randn(127, H, 128)
        tag = "row 1 verify q [127,32,128]" if H == 32 else "70B verify q [127,64,128]"
        out[tag] = (lambda q=q, k=k, v=v, m=mask, L=L: ta.attend_flash(q, k, v, m, 428, 1),
                    lambda q=q, k=k, v=v, m=mask: ta.attend_flash_ref(q, k[1], v[1], m, 428),
                    sdpa(q[None], k[1:2, :, :428], v[1:2, :, :428], mask[None, :, :428]),
                    bound(mask, H, [428], False))
        if H == 32:
            (kq, ks), (vq, vs) = _quantize_block(k), _quantize_block(v)
            out["row 2 int8 verify"] = (
                lambda q=q, m=mask, kq=kq, vq=vq, ks=ks, vs=vs:
                    ta.attend_flash(q, kq, vq, m, 428, 1, k_scale=ks, v_scale=vs),
                lambda q=q, m=mask, kq=kq, vq=vq, ks=ks, vs=vs:
                    ta.attend_flash_ref(q, kq[1], vq[1], m, 428, k_scale=ks[1], v_scale=vs[1]),
                None, bound(mask, 32, [428], True))
    for B, tree, int8 in ((8, (3, 4), False), (32, (2, 3), True)):
        g = growmap_from_spec(*tree)
        k, v = randn(2, B, 8, 2048, 128), randn(2, B, 8, 2048, 128)
        sc = {}
        if int8:
            (k, ks), (v, vs) = _quantize_block(k), _quantize_block(v)
            sc = dict(k_scale=ks, v_scale=vs)
        limits = torch.randint(135, 301, (B,), generator=gen, device=dev, dtype=torch.int32)
        mask = tree_mask_rows_batched(limits - g.size, torch.as_tensor(g.bitmap, device=dev),
                                      2048)
        q = randn(B, g.size, 32, 128)
        qp = randn(1, 512, 32, 128)
        pm = causal_mask_rows(0, 512, 2048, device=dev)[None]
        lim1 = torch.full((1,), 512, dtype=torch.int32, device=dev)
        slot = torch.full((1,), 5, dtype=torch.int32, device=dev)
        row = "row 4 int8" if int8 else "row 3"
        out[f"{row} decode q [{B},{g.size},32,128]"] = (
            lambda q=q, k=k, v=v, m=mask, li=limits, sc=sc:
                ta.attend_flash_batched(q, k, v, m, li, 1, **sc),
            lambda q=q, k=k, v=v, m=mask, li=limits, sc=sc:
                ta.attend_flash_batched_ref(q, k, v, m, li, 1, **sc),
            None if int8 else sdpa(q, k[1, :, :, :300], v[1, :, :, :300], mask[:, :, :300]),
            bound(mask, 32, limits.tolist(), int8))
        out[f"{row} prefill q [1,512]"] = (
            lambda qp=qp, k=k, v=v, sc=sc, pm=pm, lim1=lim1, slot=slot:
                ta.attend_flash_batched(qp, k, v, pm, lim1, 1, slots=slot, **sc),
            lambda qp=qp, k=k, v=v, sc=sc, pm=pm, lim1=lim1, slot=slot:
                ta.attend_flash_batched_ref(qp, k, v, pm, lim1, 1, slots=slot, **sc),
            None if int8 else sdpa(qp, k[1, 5:6, :, :512], v[1, 5:6, :, :512], pm[:, :, :512]),
            bound(pm, 32, [512], int8))
    return out


def layout_check(torch, dev, ta, chip_smoke, libs):
    """bf16 outputs of the verify rows (tree slots) that differ from the same
    rows computed as AR steps (contiguous slots), per kernel."""
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    gen = torch.Generator(device=dev).manual_seed(7)
    gm = growmap_from_spec(24, 6, acc=chip_smoke.ACC_24x6)
    bm = torch.as_tensor(gm.bitmap, device=dev)
    T, L = gm.size, 2048
    res = {}
    for nn in (150, 301):
        k, v = (torch.randn((1, 8, L, 128), generator=gen, device=dev).bfloat16() for _ in "kv")
        q = torch.randn((T, 64, 128), generator=gen, device=dev).bfloat16()
        tm = tree_mask_rows(nn, bm, L)
        for kind in ("scalar", "tensor-core", "float-max"):
            use(ta, torch, libs.get(kind), kind == "scalar")
            verify = ta.attend_flash(q, k, v, tm, nn + T, 0)
            differ = rows = 0
            for i in range(T):
                anc = torch.nonzero(bm[i]).flatten()
                d = anc.numel()
                ka, va = k.clone(), v.clone()
                ka[0, :, nn:nn + d], va[0, :, nn:nn + d] = k[0, :, nn + anc], v[0, :, nn + anc]
                ar = ta.attend_flash(q[i:i + 1].contiguous(), ka, va,
                                     causal_mask_rows(nn + d - 1, 1, L, device=dev), nn + d, 0)
                n = int((ar[0] != verify[i]).sum())
                differ, rows = differ + n, rows + (n > 0)
            res[f"nn={nn} {kind}"] = dict(outputs_differing=differ, outputs=T * 64 * 128,
                                          rows_differing=rows, rows=T)
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("attention_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from umbrella_tpu_torch.ops.kernels import build
    from umbrella_tpu_torch.ops.kernels import tree_attention as ta

    libs = build_variants(build, "tree_attention.cu",
                          {name: (lambda src, n=name: patched(src, n)) for name in VARIANTS})
    build.build_all()
    use.real_plan, use.real_fn = ta._plan, ta._fn
    dev = torch.device("cuda:0")
    shapes = cases(torch, dev, chip_smoke)
    times = {}
    for name in ROUNDS:
        use(ta, torch, None if name == "scalar" else libs[name], name == "scalar")
        for shape, (fn, ref, _, _) in shapes.items():
            if name in ("kernel", "scalar"):
                got, want = fn(), ref()
                err = (got.float() - want.float()).abs().max().item()
                if err > 2e-2 * want.float().abs().max().item():
                    raise AssertionError(f"{name} {shape}: max abs err {err}")
            times.setdefault(shape, {}).setdefault(name, []).append(chip_smoke.cuda_ms(torch, fn))
    for shape, (_, _, lib, bound_ms) in shapes.items():
        times[shape]["bound"] = bound_ms
        if lib is not None:
            times[shape]["sdpa"] = chip_smoke.cuda_ms(torch, lib)
    layout = layout_check(torch, dev, ta, chip_smoke, {"float-max": libs["float-max"]})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"ms": times, "layout": layout, "card": card.strip().splitlines()}),
          flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)  # skip interpreter teardown, which can stall after CUDA work
