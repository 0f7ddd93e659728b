"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Every wrapper counts its own launches (`wrapper.launches`) so a run can show
which kernels it went through; `w4a16_matmul` counts its layered mode apart
(`layered_launches`, reported as "w4a16_matmul_layered"); the attention
wrappers count their scalar kernel's launches (fp32 q, head dim 32) apart too
(`scalar_launches`, summed as "attend_flash_scalar"); the int8 W4 kernels'
fused quantizer (`w4a8.quantize_rows`) counts as "w4a8_quantize", one launch
beside each `w4a8f_matmul` and `w4a8_matmul` on the card.

A CUDA graph replays its kernels without running the wrappers, so a captured
step's launches are moved off the counters when it is captured (a capture
runs nothing) and added back once for every replay (`counter_values`,
`add_launches`; `cuda_graphs.StepGraph`).
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


ATTENTION = ("attend_flash", "attend_flash_int8", "attend_flash_batched",
             "attend_flash_batched_int8")


def launch_counts() -> dict:
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["w4a16_matmul_layered"] = w4a16_matmul.layered_launches
    counts["attend_flash_scalar"] = sum(KERNELS[n].scalar_launches for n in ATTENTION)
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    w4a16_matmul.layered_launches = 0
    for n in ATTENTION:
        KERNELS[n].scalar_launches = 0


# every counter a launch may add to: each wrapper's own, the layered mode's
# and the attention wrappers' scalar kernel's
_COUNTERS = ([(fn, "launches") for fn in KERNELS.values()]
             + [(w4a16_matmul, "layered_launches")]
             + [(KERNELS[n], "scalar_launches") for n in ATTENTION])


def counter_values() -> list:
    """The current value of every launch counter (for `add_launches`)."""
    return [getattr(fn, attr) for fn, attr in _COUNTERS]


def add_launches(deltas: list, times: int = 1) -> None:
    """Add `times` x deltas (a difference of two `counter_values()`: the
    launches one captured step makes) to the counters; a negative `times`
    takes them off."""
    for (fn, attr), d in zip(_COUNTERS, deltas):
        setattr(fn, attr, getattr(fn, attr) + times * d)
