#!/usr/bin/env python3
"""Where the W4A16 kernel's time goes, on one NVIDIA GPU.

    python3 scripts/w4a16_breakdown.py

Builds `umbrella_tpu_torch/csrc/w4a16.cu` and four variants of it, each
changed by a source patch (applied to a copy under build/breakdown/), and
times all five at the 70B gate_up shape (S=127 and S=24) and the 8B gate_up
shape (S=127):
  kernel      the kernel as it is;
  fp32-form   the kernel with its packed bf16x2 dequantization turned off:
              every weight takes the fp32 form (the same bits);
  no-mma      no wgmma (the dequantized fragments are kept live): the TMA
              stream plus the dequantization;
  no-dequant  each fragment made from the raw bytes by one XOR: the TMA
              stream plus the MMA path;
  stream      neither, and no wgmma fence/commit/wait: the TMA stream alone.
The last three compute wrong results; the kernel and fp32-form are checked
against the plain version. Times are chip_smoke.cuda_ms (CUDA-graph replay);
the variants are timed in the order of ROUNDS, kernel and fp32-form twice
(first and last), so that their difference can be read against the spread of
one variant's two runs. Prints one JSON line with each variant's times in
ms, the bounds, and the card's name and power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(8192, 57344, 127), (8192, 57344, 24), (4096, 28672, 127)]

_WGMMA = ("                wgmma_rs<NT>(acc, fb[jj][0], d_lo + k_off);\n"
          "                wgmma_rs<NT>(acc, fb[jj][1], d_hi + k_off);\n")
_NO_WGMMA = ("                if (d_lo == 1) acc[0] += __uint_as_float(fb[jj][0][0] ^ "
             "fb[jj][1][3]);\n")
_DEQUANT = "                if (packed) {\n"
_NO_DEQUANT = ("                if (true) {\n"
               "                    for (int h = 0; h < 2; ++h)\n"
               "                        for (int i = 0; i < 4; ++i)\n"
               "                            fb[jj][h][i] = b[i] ^ (h ? 0x3c003c00u : 0x3c00u);\n"
               "                } else if (packed) {\n")
_SYNC = [("            wgmma_fence();\n", ""),
         ("            wgmma_commit();\n            wgmma_wait<1>();", "")]
VARIANTS = {"kernel": [], "fp32-form": [("        packed = p.s_bf16 != 0;\n",
                                          "        packed = false;\n")],
            "no-mma": [(_WGMMA, _NO_WGMMA)],
            "no-dequant": [(_DEQUANT, _NO_DEQUANT)],
            "stream": [(_WGMMA, _NO_WGMMA), (_DEQUANT, _NO_DEQUANT)] + _SYNC}
ROUNDS = ["kernel", "fp32-form", "no-mma", "no-dequant", "stream", "fp32-form", "kernel"]


def build_variants(build):
    with open(os.path.join(build.CSRC_DIR, "w4a16.cu")) as f:
        src = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "breakdown")
    os.makedirs(out_dir, exist_ok=True)
    procs, libs = {}, {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"w4a16_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out_dir, f"w4a16_{name}.so")
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", libs[name], cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("w4a16_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from umbrella_tpu_torch.ops.kernels import build
    from umbrella_tpu_torch.ops.kernels import w4a16 as W
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device

    libs = build_variants(build)
    build.build_all()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    weights, xs = {}, {}
    for K, N, S in SHAPES:
        if (K, N) not in weights:
            w = torch.randn((K, N), generator=gen, device=dev) * 0.02
            weights[(K, N)] = quantize_pack_device(w, 128, torch.bfloat16)
        xs[(K, S)] = torch.randn((S, K), generator=gen, device=dev).to(torch.bfloat16)
    times = {}
    for name in ROUNDS:
        build._libs["w4a16"] = ctypes.CDLL(libs[name])
        W._fn.cache_clear()
        for K, N, S in SHAPES:
            q, x = weights[(K, N)], xs[(K, S)]
            if name in ("kernel", "fp32-form"):
                y, ref = W.w4a16_matmul(x, q), W.w4a16_matmul_ref(x, q)
                err = (y.float() - ref.float()).abs().max().item()
                if err > 2 ** -7 * ref.float().abs().max().item():
                    raise AssertionError(f"{name} K={K} N={N} S={S}: max abs err {err}")
            times.setdefault(f"{name} K={K} N={N} S={S}", []).append(chip_smoke.cuda_ms(
                torch, lambda: W.w4a16_matmul(x, q)))
    bounds = {f"K={K} N={N} S={S}": chip_smoke.w4a16_bound(K, N, S, N, K // 128)
              for K, N, S in SHAPES}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"ms": times, "bound_ms": bounds, "card": card.strip().splitlines()}),
          flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)  # skip interpreter teardown, which can stall after CUDA work
