"""W4A16 matmul over split-halves AWQ weights, and the fused gate-up-SiLU over a
packed gate|up weight: CUDA kernels in `csrc/w4a16.cu` and their plain
versions `w4a16_matmul_ref` and `w4a16_gate_up_silu_ref`.

Replaces `umbrella_tpu/ops/pallas/w4a16.py::w4a16_matmul` (plain and layered
mode) and `::w4a16_gate_up_silu`. Layered mode: the weight is a stack of
layers ([n, K/2, N] packed bytes, [n, G, N] scales and zeros) and the layer is
an int32 tensor on the device, which the kernel reads itself: the host never
reads it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_FLOATS = (torch.float32, torch.bfloat16)


def _dequant_halves_bf16(q) -> torch.Tensor:
    """[K, N] weight as the kernel forms it: (nibble - z) * s in fp32, rounded to bf16."""
    G = q.scales.shape[-2]
    gs = q.k // G
    w32 = q.w8.to(torch.int32)
    nib = torch.cat([w32 & 0xF, (w32 >> 4) & 0xF], dim=-2).float()
    z = torch.repeat_interleave(q.zeros.float(), gs, dim=-2)
    s = torch.repeat_interleave(q.scales.float(), gs, dim=-2)
    return ((nib - z) * s).to(torch.bfloat16)


def select_layer(q, layer_idx: torch.Tensor):
    """Layer `layer_idx` (an int32 tensor of one element) of a stacked AwqTensor,
    selected on the tensors' device without a host read."""
    i = layer_idx.reshape(1).to(torch.long)
    return type(q)(*(t.index_select(0, i)[0] for t in q))


def w4a16_matmul_ref(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """Plain version with the kernel's rounding: x and the dequantized weight in
    bf16, products summed in fp32, output in out_dtype (default x.dtype)."""
    y = x.to(torch.bfloat16).float() @ _dequant_halves_bf16(q).float()
    return y.to(out_dtype or x.dtype)


def w4a16_gate_up_silu_ref(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """Plain version of the fused form, with the kernel's rounding: x and the
    dequantized packed gate|up weight [K, 2I] in bf16, fp32 sums, then
    g * sigmoid(g) * u in fp32, rounded once to out_dtype (default x.dtype)."""
    gu = x.to(torch.bfloat16).float() @ _dequant_halves_bf16(q).float()
    g, u = gu[:, :q.n // 2], gu[:, q.n // 2:]
    return (g * torch.sigmoid(g) * u).to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(build.library("w4a16"), name)
    layered = [ctypes.c_void_p, ctypes.c_int] if name.endswith("_layered") else []
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + layered + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, x: torch.Tensor, q, n_out: int, n_ranges: int, out_dtype,
            layer_idx=None) -> torch.Tensor:
    """Check the operands, allocate the output [S, n_out] and the split-K scratch,
    launch C entry point `name` over `n_ranges` weight column ranges of n_out
    (on the layer `layer_idx` of stacked weights, for the layered entry point)."""
    S, K = x.shape
    K2, N = q.w8.shape[-2:]
    G = q.scales.shape[-2]
    stack = tuple(q.w8.shape[:-2])  # (n_layers,) in layered mode
    if K != 2 * K2 or K % G or K2 % (K // G) or (K // G) % 32:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs w8 {tuple(q.w8.shape)}, "
                         f"{G} groups (K/2 must be a multiple of the group size, and the "
                         "group size of 32)")
    if q.w8.dtype not in (torch.int8, torch.uint8) or q.scales.shape != (*stack, G, N) \
            or q.zeros.shape != (*stack, G, N) or q.zeros.dtype != q.scales.dtype \
            or N != n_ranges * n_out or len(stack) != (layer_idx is not None):
        raise ValueError(f"{name}: malformed AwqTensor")
    if x.dtype not in _FLOATS or q.scales.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"{name}: unsupported dtypes {x.dtype}/{q.scales.dtype}/{out_dtype}")
    for t in (x, q.w8, q.scales, q.zeros):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: inputs must be contiguous on one device")
    layered = ()
    if layer_idx is not None:
        if not isinstance(layer_idx, torch.Tensor) or layer_idx.dtype != torch.int32 \
                or layer_idx.numel() != 1 or layer_idx.device != x.device:
            raise ValueError(f"{name}: layer_idx must be one int32 on {x.device}")
        layered = (build.ptr(layer_idx), stack[0])
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads x in 16-byte vectors
    out = torch.empty((S, n_out), dtype=out_dtype, device=x.device)
    # a block owns one 64-column tile of every range, so the split follows the
    # tiles of one range and K: never S
    splits = build.split_k(-(-n_out // 64), K2 // 32)
    partial = (torch.empty((splits, n_ranges, S, n_out), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    build.check(_fn(name)(build.ptr(x), build.ptr(q.w8), build.ptr(q.scales), build.ptr(q.zeros),
                          build.ptr(out), build.ptr(partial), S, K2, n_out, K // G, splits,
                          int(x.dtype == torch.bfloat16),
                          int(q.scales.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                          *layered, build.stream(x.device)),
                name)
    return out


def w4a16_matmul(x: torch.Tensor, q, out_dtype=None, layer_idx=None) -> torch.Tensor:
    """x [S, K] @ split-halves W4 AwqTensor [K, N] -> [S, N] in out_dtype (default
    x.dtype; fp32 accumulation either way). Layered mode: q is stacked ([n, K/2,
    N] w8, [n, G, N] scales/zeros) and `layer_idx` one int32 on x's device.
    CUDA tensors launch the kernel (counted in `launches`, or `layered_launches`
    in layered mode); CPU tensors take the plain version (on the selected
    layer)."""
    out_dtype = out_dtype or x.dtype
    if (layer_idx is not None) != (q.w8.dim() == 3):
        raise ValueError("w4a16_matmul: layer_idx goes with a stacked [n, K/2, N] weight, "
                         f"got w8 {tuple(q.w8.shape)} and layer_idx {layer_idx}")
    if not x.is_cuda:
        if layer_idx is not None:
            q = select_layer(q, layer_idx)
        return w4a16_matmul_ref(x, q, out_dtype)
    if layer_idx is None:
        out = _launch("w4a16_matmul", x, q, q.n, 1, out_dtype)
        w4a16_matmul.launches += 1
    else:
        out = _launch("w4a16_matmul_layered", x, q, q.n, 1, out_dtype, layer_idx)
        w4a16_matmul.layered_launches += 1
    return out


def w4a16_gate_up_silu(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """silu(x @ W_gate) * (x @ W_up) in one kernel: x [S, K] and a packed gate|up
    AwqTensor [K, 2I] (gate columns first) -> [S, I] in out_dtype (default
    x.dtype). CUDA tensors launch the kernel; CPU tensors take the plain version."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return w4a16_gate_up_silu_ref(x, q, out_dtype)
    if q.n % 2:
        raise ValueError(f"w4a16_gate_up_silu: gate|up width {q.n} is odd")
    out = _launch("w4a16_gate_up_silu", x, q, q.n // 2, 2, out_dtype)
    w4a16_gate_up_silu.launches += 1
    return out


w4a16_matmul.launches = 0
w4a16_matmul.layered_launches = 0
w4a16_gate_up_silu.launches = 0
