"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Every wrapper counts its own launches (`wrapper.launches`) so a run can show
which kernels it went through; `w4a16_matmul` counts its layered mode apart
(`layered_launches`, reported as "w4a16_matmul_layered"); the int8 W4 kernels'
fused quantizer (`w4a8.quantize_rows`) counts as "w4a8_quantize", one launch
beside each `w4a8f_matmul` and `w4a8_matmul` on the card.
"""
from .embed_gather import embed_gather
from .tree_attention import (attend_flash, attend_flash_batched, attend_flash_batched_int8,
                             attend_flash_int8)
from .w4a16 import w4a16_gate_up_silu, w4a16_matmul
from .w4a8 import quantize_rows, w4a8_matmul
from .w4a8f import w4a8f_matmul

KERNELS = {
    "embed_gather": embed_gather,
    "attend_flash": attend_flash,
    "attend_flash_int8": attend_flash_int8,
    "attend_flash_batched": attend_flash_batched,
    "attend_flash_batched_int8": attend_flash_batched_int8,
    "w4a16_matmul": w4a16_matmul,
    "w4a16_gate_up_silu": w4a16_gate_up_silu,
    "w4a8f_matmul": w4a8f_matmul,
    "w4a8_matmul": w4a8_matmul,
    "w4a8_quantize": quantize_rows,
}


def launch_counts() -> dict:
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["w4a16_matmul_layered"] = w4a16_matmul.layered_launches
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    w4a16_matmul.layered_launches = 0
