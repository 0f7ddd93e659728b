"""AWQ W4A8 matmul (per-row int8 activations, split-halves 4-bit AWQ weights with
per-group scales and zeros): CUDA kernel `csrc/w4a8.cu` and its plain version
`w4a8_matmul_ref`.

Replaces `umbrella_tpu/ops/pallas/w4a8.py::w4a8_matmul`:

    sx[s] = max(max|x[s, :]|, 1e-8) / 127,   xq = clip(round(x / sx), -127, 127)
    y[s, n] = sx[s] * sum_g s_g[n] * (xq[s, g] . nib_g[:, n] - rowsum_g[s] * z_g[n])

The activation quantization runs as tensor code before the kernel, as in the
JAX package. Every step is per row, so a row's result does not depend on the
rows that share its call (what keeps W4A8 spec decode equal to its AR decode).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_FLOATS = (torch.float32, torch.bfloat16)
CHUNK_ROWS = 32  # packed rows per K chunk of the kernel; a group holds whole chunks


def quantize_activations_w4a8(x: torch.Tensor):
    """(xq int8 [S, K], sx fp32 [S, 1]) for per-row symmetric int8 quantization
    (round half to even, clipped to +-127). The scale is the row max times the
    fp32 reciprocal of 127: XLA compiles the JAX package's `/ 127.0` that way,
    and xq's rounding edges depend on its last bit."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def group_rowsums(xq: torch.Tensor, group_size: int) -> torch.Tensor:
    """int32 [S, K / group_size]: each row's sum of its int8 values per group."""
    S, K = xq.shape
    return xq.reshape(S, K // group_size, group_size).to(torch.int32).sum(dim=-1,
                                                                          dtype=torch.int32)


def kernel_splits(q) -> int:
    """How many blocks share a column tile's K range, in whole packed groups: a
    function of N and K only (see build.split_k), so a row's order of
    operations is the same at any row count."""
    K2, N = q.w8.shape
    G2 = q.scales.shape[0] // 2
    return build.split_k(-(-N // 64), G2, 4, 4 * build.SMS, fill=True)


def w4a8_matmul_ref(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """Plain version with the kernel's order of operations: per packed group
    (the low half's group, then the high half's) an exact integer product (in
    float64, exact here: |p| <= 127 * 15 * group size), the fp32 zero fix-up and
    scale, added to an fp32 sum per split of the groups; the splits' sums added
    in order, times sx, in out_dtype (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    S, K = x.shape
    K2, N = q.w8.shape
    G2 = q.scales.shape[0] // 2
    gs = K2 // G2
    xq, sx = quantize_activations_w4a8(x)
    rs = group_rowsums(xq, gs).float()
    xd = xq.double()
    scales, zeros = q.scales.float(), q.zeros.float()
    splits = kernel_splits(q)
    per = -(-G2 // splits)
    total = None
    for z in range(splits):
        acc = torch.zeros((S, N), dtype=torch.float32, device=x.device)
        for pg in range(z * per, min(G2, (z + 1) * per)):
            rows = slice(pg * gs, (pg + 1) * gs)
            w32 = q.w8[rows].to(torch.int32)
            for half, nib in enumerate((w32 & 0xF, (w32 >> 4) & 0xF)):
                g = half * G2 + pg
                p = (xd[:, half * K2 + pg * gs:half * K2 + (pg + 1) * gs] @ nib.double()).float()
                acc = acc + (p - rs[:, g:g + 1] * zeros[g]) * scales[g]
        total = acc if splits == 1 else (torch.zeros_like(acc) if total is None else total) + acc
    return (total * sx).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.library("w4a8").w4a8_matmul
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def w4a8_matmul(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """x [S, K] @ split-halves W4 AwqTensor [K, N] with int8 activations -> [S, N]
    in out_dtype (default x.dtype). CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return w4a8_matmul_ref(x, q, out_dtype)
    S, K = x.shape
    K2, N = q.w8.shape
    G = q.scales.shape[0]
    if K != 2 * K2 or G % 2 or K % G or (K // G) % CHUNK_ROWS or K2 % (K // G):
        raise ValueError(f"w4a8_matmul: x {tuple(x.shape)} vs w8 {tuple(q.w8.shape)}, "
                         f"{G} groups (K/2 must be a multiple of the group size, and the "
                         f"group size of {CHUNK_ROWS})")
    if q.w8.dtype not in (torch.int8, torch.uint8) or q.scales.shape != (G, N) \
            or q.zeros.shape != (G, N) or q.zeros.dtype != q.scales.dtype:
        raise ValueError("w4a8_matmul: malformed AwqTensor")
    if x.dtype not in _FLOATS or q.scales.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"w4a8_matmul: unsupported dtypes {x.dtype}/{q.scales.dtype}/{out_dtype}")
    for t in (q.w8, q.scales, q.zeros):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("w4a8_matmul: inputs must be contiguous on one device")
    gs = K // G
    xq, sx = quantize_activations_w4a8(x)
    rs = group_rowsums(xq, gs)
    out = torch.empty((S, N), dtype=out_dtype, device=x.device)
    splits = kernel_splits(q)
    partial = (torch.empty((splits, S, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with build.on_device(x) as st:
        build.check(_fn()(build.ptr(xq), build.ptr(sx), build.ptr(rs), build.ptr(q.w8),
                          build.ptr(q.scales), build.ptr(q.zeros), build.ptr(out),
                          build.ptr(partial), S, K2, N, gs, splits,
                          int(q.scales.dtype == torch.bfloat16),
                          int(out_dtype == torch.bfloat16), st),
                    "w4a8_matmul")
    w4a8_matmul.launches += 1
    return out


w4a8_matmul.launches = 0
