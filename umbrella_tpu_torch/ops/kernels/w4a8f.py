"""Int4F matmul (int8 activations, 4-bit weights with factorized scales): CUDA
kernel `csrc/w4a8f.cu` and its plain version `w4a8f_matmul_ref`.

Replaces `umbrella_tpu/ops/pallas/w4a8f.py::w4a8f_matmul`; the plain version is
the counterpart of that module's `w4a8f_matmul_xla` (identical numerics).

    y[s, n] = b[n] * sx[s] * (xq[s, :] @ (q4[:, n] - 8)),  xq = round(x * a / sx)
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build


def quantize_activations_int8(x: torch.Tensor, a: torch.Tensor):
    """(xq int8 [S, K], sx fp32 [S, 1], rowsum int32 [S, 1]) for per-row symmetric
    quantization of x * a (round half to even, clipped to +-127)."""
    xf = x.float() * a[None, :].float()
    sx = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    rsum = xq.to(torch.int32).sum(dim=1, keepdim=True, dtype=torch.int32)
    return xq, sx, rsum


def w4a8f_int_dot(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int32 xq @ (q4 - 8) over split-halves nibbles. Computed in float64,
    which is exact here: |acc| <= 127 * 8 * K < 2**53 (no integer matmul on CUDA)."""
    K2 = w8.shape[0]
    w32 = w8.to(torch.int32)
    lo = ((w32 & 0xF) - 8).double()
    hi = (((w32 >> 4) & 0xF) - 8).double()
    acc = xq[:, :K2].double() @ lo + xq[:, K2:].double() @ hi
    return acc.to(torch.int32)


def w4a8f_matmul_ref(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """Plain version: x [S, K] @ Int4FTensor [K, N] -> [S, N] in out_dtype (default x.dtype)."""
    xq, sx, _ = quantize_activations_int8(x, q.a)
    acc = w4a8f_int_dot(xq, q.w8)
    y = acc.float() * sx * q.b[None, :].float()
    return y.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.library("w4a8f").w4a8f_matmul
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def w4a8f_matmul(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """x [S, K] @ Int4FTensor [K, N] -> [S, N] in out_dtype (default x.dtype).

    The per-row activation quantization runs as tensor code before the kernel,
    as in the JAX package. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return w4a8f_matmul_ref(x, q, out_dtype)
    S, K = x.shape
    K2, N = q.w8.shape
    if K != 2 * K2 or K2 % 32:
        raise ValueError(f"w4a8f_matmul: x {tuple(x.shape)} vs w8 {tuple(q.w8.shape)} "
                         "(K/2 must be a multiple of 32)")
    if q.w8.dtype not in (torch.int8, torch.uint8) or q.a.shape != (K,) or q.b.shape != (N,):
        raise ValueError("w4a8f_matmul: malformed Int4FTensor")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w4a8f_matmul: unsupported out_dtype {out_dtype}")
    b = q.b.float().contiguous()
    if not q.w8.is_contiguous() or q.w8.device != x.device or b.device != x.device:
        raise ValueError("w4a8f_matmul: inputs must be contiguous on one device")
    xq, sx, rsum = quantize_activations_int8(x, q.a)
    out = torch.empty((S, N), dtype=out_dtype, device=x.device)
    splits = build.split_k(-(-N // 64), K2 // 32, 4, 4 * build.SMS, fill=True)
    partial = (torch.empty((splits, S, N), dtype=torch.int32, device=x.device)
               if splits > 1 else None)
    with build.on_device(x) as st:
        build.check(_fn()(build.ptr(xq), build.ptr(sx), build.ptr(rsum), build.ptr(q.w8),
                          build.ptr(b), build.ptr(out), build.ptr(partial), S, K2, N, splits,
                          int(out_dtype == torch.bfloat16), st),
                    "w4a8f_matmul")
    w4a8f_matmul.launches += 1
    return out


w4a8f_matmul.launches = 0
