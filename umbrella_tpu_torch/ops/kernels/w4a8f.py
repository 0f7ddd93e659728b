"""Int4F matmul (int8 activations, 4-bit weights with factorized scales): the
Int4F instantiation of the int8 W4 kernel `csrc/w4a8.cu` and its plain version
`w4a8f_matmul_ref`.

Replaces `umbrella_tpu/ops/pallas/w4a8f.py::w4a8f_matmul`; the plain version is
the counterpart of that module's `w4a8f_matmul_xla` (identical numerics).

    y[s, n] = b[n] * sx[s] * (xq[s, :] @ (q4[:, n] - 8)),  xq = round(x * a / sx)
"""
from __future__ import annotations

import torch

from . import build
from .w4a8 import _FLOATS, _fn, _plan, quantize_rows


def quantize_activations_int8(x: torch.Tensor, a: torch.Tensor):
    """(xq int8 [S, K], sx fp32 [S, 1], rowsum int32 [S, 1]) for per-row symmetric
    quantization of x * a (round half to even, clipped to +-127). The scale is
    the row max times the fp32 reciprocal of 127: the JAX package runs its
    `/ 127.0` only under jit, which XLA compiles that way, and xq's rounding
    edges depend on its last bit."""
    xf = x.float() * a[None, :].float()
    sx = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
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


def _check(x: torch.Tensor, q, out_dtype) -> dict:
    """Check w4a8f_matmul's operands (on any device); returns the launch plan.
    Raises ValueError on what the kernel does not take."""
    S, K = x.shape
    K2, N = q.w8.shape
    if K != 2 * K2:
        raise ValueError(f"w4a8f_matmul: x {tuple(x.shape)} vs w8 {tuple(q.w8.shape)}")
    plan = _plan(S, K, N)
    if q.w8.dtype not in (torch.int8, torch.uint8) or q.a.shape != (K,) or q.b.shape != (N,):
        raise ValueError("w4a8f_matmul: malformed Int4FTensor")
    if x.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"w4a8f_matmul: unsupported dtypes {x.dtype}/{out_dtype}")
    for t in (x, q.w8, q.a, q.b):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("w4a8f_matmul: inputs must be contiguous on one device")
    return plan


def w4a8f_matmul(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """x [S, K] @ Int4FTensor [K, N] -> [S, N] in out_dtype (default x.dtype).

    CUDA tensors launch the fused quantizer (`w4a8.quantize_rows`: xq, sx and
    the row sums of x * a in one launch) and the kernel; CPU tensors take the
    plain version."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return w4a8f_matmul_ref(x, q, out_dtype)
    plan = _check(x, q, out_dtype)
    if q.w8.data_ptr() % 16:
        raise ValueError("w4a8f_matmul: w8 must be 16-byte aligned (TMA)")
    S, K = x.shape
    K2, N = q.w8.shape
    a, b = q.a.float(), q.b.float()
    xq, sx, rsum = quantize_rows(x, a)
    out = torch.empty((S, N), dtype=out_dtype, device=x.device)
    splits = plan["splits"]
    partial = (torch.empty((splits, S, N), dtype=torch.int32, device=x.device)
               if splits > 1 else None)
    with build.on_device(x) as st:
        build.check(_fn("w4a8f_matmul")(build.ptr(xq), build.ptr(sx), build.ptr(rsum),
                                        build.ptr(q.w8), build.ptr(b), build.ptr(out),
                                        build.ptr(partial), S, K2, N, splits,
                                        plan["chunks_per_split"],
                                        int(out_dtype == torch.bfloat16), st),
                    "w4a8f_matmul")
    w4a8f_matmul.launches += 1
    return out


w4a8f_matmul.launches = 0
