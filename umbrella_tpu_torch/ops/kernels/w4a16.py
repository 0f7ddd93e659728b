"""W4A16 matmul over split-halves AWQ weights: CUDA kernel `csrc/w4a16.cu` and
its plain version `w4a16_matmul_ref`.

Replaces `umbrella_tpu/ops/pallas/w4a16.py::w4a16_matmul` (plain mode).
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


def w4a16_matmul_ref(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """Plain version with the kernel's rounding: x and the dequantized weight in
    bf16, products summed in fp32, output in out_dtype (default x.dtype)."""
    y = x.to(torch.bfloat16).float() @ _dequant_halves_bf16(q).float()
    return y.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.library("w4a16").w4a16_matmul
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def w4a16_matmul(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """x [S, K] @ split-halves W4 AwqTensor [K, N] -> [S, N] in out_dtype (default
    x.dtype; fp32 accumulation either way). CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return w4a16_matmul_ref(x, q, out_dtype)
    S, K = x.shape
    K2, N = q.w8.shape
    G = q.scales.shape[0]
    if K != 2 * K2 or K % G or K2 % (K // G) or (K // G) % 32:
        raise ValueError(f"w4a16_matmul: x {tuple(x.shape)} vs w8 {tuple(q.w8.shape)}, "
                         f"{G} groups (K/2 must be a multiple of the group size, and the "
                         "group size of 32)")
    if q.w8.dtype not in (torch.int8, torch.uint8) or q.scales.shape != (G, N) \
            or q.zeros.shape != (G, N) or q.zeros.dtype != q.scales.dtype:
        raise ValueError("w4a16_matmul: malformed AwqTensor")
    if x.dtype not in _FLOATS or q.scales.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"w4a16_matmul: unsupported dtypes {x.dtype}/{q.scales.dtype}/{out_dtype}")
    for t in (x, q.w8, q.scales, q.zeros):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("w4a16_matmul: inputs must be contiguous on one device")
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads x in 16-byte vectors
    out = torch.empty((S, N), dtype=out_dtype, device=x.device)
    splits = build.split_k(-(-N // 64), K2 // 32)
    partial = (torch.empty((splits, S, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    build.check(_fn()(build.ptr(x), build.ptr(q.w8), build.ptr(q.scales), build.ptr(q.zeros),
                      build.ptr(out), build.ptr(partial), S, K2, N, K // G, splits,
                      int(x.dtype == torch.bfloat16),
                      int(q.scales.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                      build.stream(x.device)),
                "w4a16_matmul")
    w4a16_matmul.launches += 1
    return out


w4a16_matmul.launches = 0
