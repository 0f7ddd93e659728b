"""AWQ W4A16 weight-only quantization in the split-halves layout.

Layout (as in `umbrella_tpu/quantization/awq.py`):
    w8     int8 [K/2, N]  — low nibble = original row r, high nibble = row r + K/2
    scales [K/g, N]
    zeros  [K/g, N]  (zero-point pre-cast to the scales' dtype)
Then  x @ W == x[:, :K/2] @ deq(lo(w8)) + x[:, K/2:] @ deq(hi(w8)).

Routing mirrors the JAX package: below FP16_MATMUL_HEURISTIC_TOKENS a CUDA input
runs the hand-written W4A16 kernel; above it, and on the CPU, the weight is
dequantized in x.dtype and multiplied with fp32 accumulation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels.w4a16 import w4a16_matmul

# tokens >= this dequantize the weight and run a dense product (awq.py:44 of the
# JAX package; kept because it changes numerics at prefill sizes)
FP16_MATMUL_HEURISTIC_TOKENS = 2048


class AwqTensor(NamedTuple):
    """Split-halves packed W4 linear weight (logical shape [K, N])."""
    w8: torch.Tensor  # int8 [K/2, N]
    scales: torch.Tensor  # [K/g, N]
    zeros: torch.Tensor  # [K/g, N] (same dtype as scales)

    @property
    def k(self) -> int:
        return 2 * self.w8.shape[-2]

    @property
    def n(self) -> int:
        return self.w8.shape[-1]

    @property
    def group_size(self) -> int:
        return self.k // self.scales.shape[-2]


def quantize_matrix(w: np.ndarray, group_size: int = 128):
    """AWQ-style range quantization of [K, N] fp weights (per-group along K).

    Returns (int_weights [K,N] in [0,15], int_zeros [K/g,N], scales [K/g,N])."""
    K, N = w.shape
    if K % group_size:
        raise ValueError(f"K={K} must be a multiple of group_size={group_size}")
    g = w.reshape(K // group_size, group_size, N)
    w_max = g.max(axis=1)
    w_min = g.min(axis=1)
    scales = np.maximum((w_max - w_min) / 15.0, 1e-8)
    zeros = np.clip(np.round(-w_min / scales), 0, 15)
    q = np.clip(np.round(g / scales[:, None, :]) + zeros[:, None, :], 0, 15)
    return (q.reshape(K, N).astype(np.int8), zeros.astype(np.int8),
            scales.astype(np.float32))


def _quantize_pack_body(w: torch.Tensor, group_size: int):
    """Device-side quantize_matrix + split-halves pack -> (w8 int8, scales f32, zeros f32)."""
    K, N = w.shape
    if K % group_size or K % 2:
        raise ValueError(f"K={K} must be even and a multiple of group_size={group_size}")
    g = w.float().reshape(K // group_size, group_size, N)
    w_max = g.amax(dim=1)
    w_min = g.amin(dim=1)
    # times the fp32 reciprocal: XLA compiles the JAX package's `/ 15.0` that way,
    # and the rounding edges below depend on the last bit of the scale
    scales = torch.clamp((w_max - w_min) * (1.0 / 15.0), min=1e-8)
    zeros = torch.clamp(torch.round(-w_min / scales), 0, 15)
    q = torch.clamp(torch.round(g / scales[:, None, :]) + zeros[:, None, :], 0, 15) \
        .to(torch.int32).reshape(K, N)
    w8 = (q[: K // 2] | (q[K // 2:] << 4)).to(torch.uint8).view(torch.int8)
    return w8, scales, zeros


def quantize_pack_device(w: torch.Tensor, group_size: int = 128,
                         dtype=torch.bfloat16) -> AwqTensor:
    """Quantize a dense [K, N] weight to a split-halves AwqTensor on w's device."""
    w8, scales, zeros = _quantize_pack_body(w, group_size)
    return AwqTensor(w8=w8, scales=scales.to(dtype), zeros=zeros.to(dtype))


def dequantize(q: AwqTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequant to [K, N]: (nibble - z) * s with the nibbles in `dtype` (the
    JAX package's promotion rules: a wider scales dtype wins)."""
    g = q.group_size
    w32 = q.w8.to(torch.int32)
    w = torch.cat([(w32 & 0xF).to(dtype), ((w32 >> 4) & 0xF).to(dtype)], dim=-2)
    scales = torch.repeat_interleave(q.scales, g, dim=-2)
    zeros = torch.repeat_interleave(q.zeros, g, dim=-2)
    return (w - zeros) * scales


def awq_matmul(x: torch.Tensor, q: AwqTensor, bias: Optional[torch.Tensor] = None,
               out_dtype=None) -> torch.Tensor:
    """y = x @ W for split-halves W4 weights; x [..., K] -> [..., N] in out_dtype
    (default x.dtype; fp32 accumulation either way)."""
    tokens = int(np.prod(x.shape[:-1]))
    out_dtype = out_dtype or x.dtype
    if x.is_cuda and tokens < FP16_MATMUL_HEURISTIC_TOKENS:
        y = w4a16_matmul(x.reshape(tokens, x.shape[-1]).contiguous(), q, out_dtype=out_dtype)
        y = y.reshape(*x.shape[:-1], q.n)
    else:
        w = dequantize(q, dtype=x.dtype)
        y = (x.float() @ w.float()).to(out_dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def awq_gate_up_silu(x: torch.Tensor, q: AwqTensor, out_dtype=None) -> torch.Tensor:
    """silu(x @ W_gate) * (x @ W_up) for a packed gate_up AwqTensor ([K, 2I], gate
    columns first), composed as one W4A16 product and an elementwise epilogue
    (the JAX package's default; its fused variant is not on the path)."""
    half = q.n // 2
    gu = awq_matmul(x, q, out_dtype=out_dtype)
    return F.silu(gu[..., :half]) * gu[..., half:]


def concat_awq(tensors) -> AwqTensor:
    """Concatenate AwqTensors along the output (N) axis (same K/group_size)."""
    return AwqTensor(
        w8=torch.cat([t.w8 for t in tensors], dim=-1),
        scales=torch.cat([t.scales for t in tensors], dim=-1),
        zeros=torch.cat([t.zeros for t in tensors], dim=-1),
    )
