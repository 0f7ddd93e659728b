"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Every wrapper counts its own launches (`wrapper.launches`) so a run can show
which kernels it went through.
"""
from .embed_gather import embed_gather
from .tree_attention import attend_flash
from .w4a16 import w4a16_matmul
from .w4a8f import w4a8f_matmul

KERNELS = {
    "embed_gather": embed_gather,
    "attend_flash": attend_flash,
    "w4a16_matmul": w4a16_matmul,
    "w4a8f_matmul": w4a8f_matmul,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
