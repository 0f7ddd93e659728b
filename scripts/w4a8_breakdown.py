#!/usr/bin/env python3
"""Where the int8 W4 kernel's time goes (`w4a8f_matmul`, `w4a8_matmul`), on one
NVIDIA GPU.

    python3 scripts/w4a8_breakdown.py

Builds `umbrella_tpu_torch/csrc/w4a8.cu` and four variants of it, each changed
by a source patch (applied to a copy under build/breakdown/), and times all
five on the Int4F lm_head [4096, 128256] (S=24 and S=127), the Int4F 8B
gate_up [4096, 28672] (S=127) and the AWQ 8B gate_up g128 (S=24 and S=127):
  kernel      the kernel as it is (checked against the plain versions);
  no-fold     AWQ only: integer zero points not folded into the fragments at
              any token width (every group takes the row-sum fix-up; also
              checked);
  no-mma      no wgmma (the fragments are kept live): the TMA stream plus the
              shared loads and the fragment forming (and AWQ's fix-ups);
  no-fixup    AWQ only: the group fix-ups left out (ptxas may then drop
              the MMAs too, whose products nothing reads);
  stream      the consumers only wait for each stage and release it: the TMA
              stream alone.
The other variants compute wrong results. Times are chip_smoke.cuda_ms (CUDA-graph
replay), in the order of ROUNDS, the kernel first and last and no-fold second and
second to last, so that a difference can be read against the spread of
their two runs. Prints one JSON
line with each variant's times in ms, the bounds, and the card's name and
power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

from breakdown_build import build_variants, patch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_INT4F_MMA = ("                wgmma_s8<NT>(acc, f[0], d_lo + 2 * j, 1);\n"
              "                wgmma_s8<NT>(acc, f[1], d_hi + 2 * j, 1);\n")
_AWQ_MMA = ("            wgmma_s8<NT>(plo, f[0], d_lo + 2 * j, keep);\n"
            "            wgmma_s8<NT>(phi, f[1], d_hi + 2 * j, keep);\n")
_STAGE = "        mbar_wait(smem_u32(full + s), phase);\n"
VARIANTS = {
    "kernel": [],
    "no-mma": [(_INT4F_MMA, "                acc[j] += f[0][j] ^ f[1][j];\n"),
               (_AWQ_MMA, "            plo[j] += f[0][j] ^ f[1][j] ^ keep;\n")],
    "no-fold": [("constexpr int kFoldMinTokens = 64;", "constexpr int kFoldMinTokens = 512;")],
    "no-fixup": [("    auto fix_up = [&](bool fold) {\n",
                  "    auto fix_up = [&](bool fold) {\n        return;\n")],
    "stream": [(_STAGE, _STAGE + "        if (true) {\n"
                "            if (c > c_begin && lane == 0) mbar_arrive(smem_u32(empty + s_prev));\n"
                "            s_prev = s;\n"
                "            if (++s == stages) s = 0, phase ^= 1;\n"
                "            return;\n"
                "        }\n")],
}
ROUNDS = ["kernel", "no-fold", "no-mma", "no-fixup", "stream", "no-fold", "kernel"]
AWQ_ONLY = ("no-fold", "no-fixup")
CHECKED = ("kernel", "no-fold")
# (name, K, N, S, group size or None for Int4F)
CASES = [("int4f lm_head", 4096, 128256, 24, None), ("int4f lm_head", 4096, 128256, 127, None),
         ("int4f gate_up", 4096, 28672, 127, None), ("awq gate_up g128", 4096, 28672, 24, 128),
         ("awq gate_up g128", 4096, 28672, 127, 128)]


def main():
    import torch

    if not torch.cuda.is_available():
        print("w4a8_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from umbrella_tpu_torch.ops.kernels import build
    from umbrella_tpu_torch.ops.kernels import w4a8 as A
    from umbrella_tpu_torch.ops.kernels import w4a8f as F
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device
    from umbrella_tpu_torch.quantization.int4f import quantize_int4f

    libs = build_variants(build, "w4a8.cu", {
        name: (lambda src, n=name, p=patches: patch(src, n, p))
        for name, patches in VARIANTS.items()})
    build.build_all()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    weights, xs, calls = {}, {}, {}
    for name, K, N, S, gs in CASES:
        if name not in weights:
            w = torch.randn((K, N), generator=gen, device=dev) * 0.02
            weights[name] = (quantize_int4f(w, refine=0) if gs is None
                             else quantize_pack_device(w, gs, torch.bfloat16))
        x = xs.setdefault((K, S), torch.randn((S, K), generator=gen, device=dev)
                          .to(torch.bfloat16))
        q = weights[name]
        calls[f"{name} S={S}"] = (
            (lambda x=x, q=q: F.w4a8f_matmul(x, q, out_dtype=torch.float32),
             lambda x=x, q=q: F.w4a8f_matmul_ref(x, q, out_dtype=torch.float32)) if gs is None
            else (lambda x=x, q=q: A.w4a8_matmul(x, q), lambda x=x, q=q: A.w4a8_matmul_ref(x, q)))
    times = {}
    for variant in ROUNDS:
        build._libs["w4a8"] = ctypes.CDLL(libs[variant])
        A._fn.cache_clear()
        for case, (fn, ref) in calls.items():
            if variant in AWQ_ONLY and case.startswith("int4f"):
                continue
            if variant in CHECKED and not torch.equal(fn(), ref()):
                raise AssertionError(f"{variant} {case}: differs from the plain version")
            times.setdefault(f"{variant} {case}", []).append(chip_smoke.cuda_ms(torch, fn))
    bounds = {}
    for name, K, N, S, gs in CASES:
        scale_bytes = 0 if gs is None else 2 * (K // gs) * N * 2
        out_bytes = S * N * (4 if gs is None else 2)
        bounds[f"{name} S={S}"] = chip_smoke.bound(
            S * K * 2 + K // 2 * N + scale_bytes + out_bytes, 2 * S * K * N, "int8")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"ms": times, "bound_ms": bounds, "card": card.strip().splitlines()}),
          flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)  # skip interpreter teardown, which can stall after CUDA work
