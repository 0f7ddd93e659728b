"""AWQ W4 weight-only quantization in the split-halves layout.

Checkpoints: the HF AutoAWQ "GEMM" format (`qweight` int32 [K, N/8] nibble-packed
along N in the AWQ interleave order, `qzeros` int32 [K/g, N/8], `scales` fp16
[K/g, N]); dequant w = (int4 - zero) * scale. `awq_from_hf_tensors` repacks it.

Layout (as in `umbrella_tpu/quantization/awq.py`):
    w8     int8 [K/2, N]  — low nibble = original row r, high nibble = row r + K/2
    scales [K/g, N]
    zeros  [K/g, N]  (zero-point pre-cast to the scales' dtype)
Then  x @ W == x[:, :K/2] @ deq(lo(w8)) + x[:, K/2:] @ deq(hi(w8)).

Routing mirrors the JAX package: below FP16_MATMUL_HEURISTIC_TOKENS a CUDA input
runs a hand-written kernel (W4A16, or W4A8 with `act_int8`); above it, and on
the CPU, the weight is dequantized in x.dtype and multiplied with fp32
accumulation. An `AwqLayerView` (one layer of stacked weights, the staged
pipeline's layer blocks) goes to the W4A16 kernel's layered mode; the W4A8 and
dequantize routes select the layer first, on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels.w4a8 import w4a8_matmul
from ..ops.kernels.w4a16 import select_layer, w4a16_gate_up_silu, w4a16_matmul
from ..utils import setup_logger

logger = setup_logger()

AWQ_REVERSE_ORDER = np.array([0, 4, 1, 5, 2, 6, 3, 7])

# tokens >= this dequantize the weight and run a dense product (awq.py:44 of the
# JAX package; kept because it changes numerics at prefill sizes)
FP16_MATMUL_HEURISTIC_TOKENS = 2048


def unpack_awq_numpy(qweight: np.ndarray, qzeros: np.ndarray, bits: int = 4):
    """AutoAWQ GEMM-format unpack -> (int_weights [K, N], int_zeros [K/g, N])."""
    if bits != 4:
        raise ValueError(f"only 4-bit AWQ is supported, got {bits}")
    shifts = np.arange(0, 32, bits, dtype=np.uint32)

    def unpack(packed):
        x = (packed.astype(np.uint32)[:, :, None] >> shifts[None, None, :]) & 0xF
        x = x.reshape(packed.shape[0], -1)
        # undo the AWQ nibble interleave within each group of 8 columns
        idx = (np.arange(x.shape[1]).reshape(-1, 8)[:, AWQ_REVERSE_ORDER]).reshape(-1)
        return x[:, idx].astype(np.int8)

    return unpack(qweight), unpack(qzeros)


def pack_awq_numpy(int_weights: np.ndarray, int_zeros: np.ndarray, bits: int = 4):
    """Inverse of unpack_awq_numpy (tests and synthetic checkpoints)."""
    if bits != 4:
        raise ValueError(f"only 4-bit AWQ is supported, got {bits}")
    awq_order = np.argsort(AWQ_REVERSE_ORDER)  # forward interleave

    def pack(x):
        idx = (np.arange(x.shape[1]).reshape(-1, 8)[:, awq_order]).reshape(-1)
        x = x[:, idx].astype(np.uint32).reshape(x.shape[0], -1, 8)
        shifts = np.arange(0, 32, bits, dtype=np.uint32)
        out = (x << shifts[None, None, :]).sum(-1).astype(np.uint32).view(np.int32)
        return np.ascontiguousarray(out)  # serializers write the raw buffer

    return pack(int_weights), pack(int_zeros)


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


class AwqLayerView(NamedTuple):
    """One layer of a stacked AwqTensor ([n, K/2, N] w8, [n, G, N] scales and
    zeros), addressed by an int32 tensor of one element on the stack's device:
    the layered W4A16 kernel reads the index and the layer in place, so neither
    a per-layer copy nor a host read is made."""
    q: AwqTensor
    layer: torch.Tensor


def has_awq_layers(layers: dict) -> bool:
    """True if any layer entry is quantized (a single AwqTensor or a per-layer
    tuple of AwqTensors)."""
    for v in layers.values():
        if isinstance(v, AwqTensor):
            return True
        if isinstance(v, tuple) and v and isinstance(v[0], AwqTensor):
            return True
    return False


def pack_tpu_layout(int_weights: np.ndarray, int_zeros: np.ndarray, scales: np.ndarray,
                    dtype=torch.bfloat16, device="cpu") -> AwqTensor:
    """[K, N] int4 values (+ per-group zeros/scales) -> split-halves AwqTensor."""
    K = int_weights.shape[0]
    if K % 2:
        raise ValueError(f"K={K} must be even")
    lo = int_weights[: K // 2].astype(np.uint8)
    hi = int_weights[K // 2:].astype(np.uint8)
    w8 = (lo | (hi << 4)).astype(np.uint8).view(np.int8)
    return AwqTensor(
        w8=torch.from_numpy(np.ascontiguousarray(w8)).to(device),
        scales=torch.from_numpy(np.asarray(scales, np.float32)).to(device=device, dtype=dtype),
        zeros=torch.from_numpy(int_zeros.astype(np.float32)).to(device=device, dtype=dtype))


def _unpack_awq_words(packed: torch.Tensor) -> torch.Tensor:
    """int32 [R, N/8] AutoAWQ words -> uint8 [R, N] nibbles in column order:
    column 8w + i is nibble AWQ_REVERSE_ORDER[i] of word w."""
    shifts = torch.as_tensor(4 * AWQ_REVERSE_ORDER, dtype=torch.int32, device=packed.device)
    nib = (packed.to(torch.int32)[:, :, None] >> shifts) & 0xF
    return nib.to(torch.uint8).reshape(packed.shape[0], -1)


def awq_from_hf_tensors(qweight, qzeros, scales, dtype=torch.bfloat16) -> AwqTensor:
    """HF AutoAWQ GEMM tensors -> split-halves AwqTensor, with tensor ops on the
    tensors' own device (bit-identical to the JAX package's C and numpy
    repackers). numpy inputs are taken as CPU tensors."""
    qweight, qzeros, scales = (a if isinstance(a, torch.Tensor)
                               else torch.from_numpy(np.ascontiguousarray(a))
                               for a in (qweight, qzeros, scales))
    w = _unpack_awq_words(qweight)
    K = w.shape[0]
    if K % 2:
        raise ValueError(f"K={K} must be even")
    w8 = (w[: K // 2] | (w[K // 2:] << 4)).view(torch.int8)
    zeros = _unpack_awq_words(qzeros).to(torch.float32).to(dtype)
    return AwqTensor(w8=w8, scales=scales.to(torch.float32).to(dtype), zeros=zeros)


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


def repack_row_shards(q: AwqTensor, m: int) -> AwqTensor:
    """Re-pack the split-halves bytes for a row-parallel (K axis) split over m
    shards: afterwards the m contiguous row blocks of w8 are each the
    split-halves pack of their own K/m logical rows, so that w8's block s,
    with the group rows of block s of scales and zeros, is a self-contained
    AwqTensor of K block s (parallel/mesh.py cuts it so). The whole repacked
    tensor means nothing unsplit. Bit for bit the JAX package's
    `repack_row_shards`, on the tensor's own device."""
    if m == 1:
        return q
    K, N = q.k, q.n
    if K % (2 * m):
        raise ValueError(f"K={K} must be divisible by 2 x the shard count ({2 * m})")
    w8 = q.w8.view(torch.uint8)
    blocks = torch.cat([w8 & 0xF, w8 >> 4], dim=-2).reshape(m, K // m, N)
    half = K // (2 * m)
    repacked = blocks[:, :half] | (blocks[:, half:] << 4)
    return q._replace(w8=repacked.reshape(K // 2, N).view(torch.int8))


def dequantize(q: AwqTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequant to [K, N]: (nibble - z) * s with the nibbles in `dtype` (the
    JAX package's promotion rules: a wider scales dtype wins)."""
    g = q.group_size
    w32 = q.w8.to(torch.int32)
    w = torch.cat([(w32 & 0xF).to(dtype), ((w32 >> 4) & 0xF).to(dtype)], dim=-2)
    scales = torch.repeat_interleave(q.scales, g, dim=-2)
    zeros = torch.repeat_interleave(q.zeros, g, dim=-2)
    return (w - zeros) * scales


def awq_matmul(x: torch.Tensor, q, bias: Optional[torch.Tensor] = None,
               prefer_fused: Optional[bool] = None, out_dtype=None,
               act_int8: bool = False) -> torch.Tensor:
    """y = x @ W for split-halves W4 weights; x [..., K] -> [..., N] in out_dtype
    (default x.dtype; fp32 accumulation either way). `q` is an AwqTensor or an
    AwqLayerView.

    `prefer_fused` (default: a CUDA input below FP16_MATMUL_HEURISTIC_TOKENS)
    picks a kernel -- W4A16 (layered mode for a view), or W4A8 (per-row int8
    activations) with `act_int8` -- over dequantizing the weight for a dense
    product, which stays in x.dtype whatever `act_int8` says. A CPU input given
    prefer_fused=True runs the kernel's plain version."""
    layer_idx = None
    if isinstance(q, AwqLayerView):
        q, layer_idx = q.q, q.layer
    tokens = int(np.prod(x.shape[:-1]))
    out_dtype = out_dtype or x.dtype
    if prefer_fused is None:
        prefer_fused = x.is_cuda and tokens < FP16_MATMUL_HEURISTIC_TOKENS
    if layer_idx is not None and not (prefer_fused and not act_int8):
        q, layer_idx = select_layer(q, layer_idx), None  # W4A8 and dequantize take one layer
    if prefer_fused:
        x2 = x.reshape(tokens, x.shape[-1]).contiguous()
        if act_int8:
            y = w4a8_matmul(x2, q, out_dtype=out_dtype)
        else:
            y = w4a16_matmul(x2, q, out_dtype=out_dtype, layer_idx=layer_idx)
        y = y.reshape(*x.shape[:-1], q.n)
    else:
        w = dequantize(q, dtype=x.dtype)
        y = (x.float() @ w.float()).to(out_dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def awq_gate_up_silu(x: torch.Tensor, q: AwqTensor, out_dtype=None,
                     fused: bool = False) -> torch.Tensor:
    """silu(x @ W_gate) * (x @ W_up) for a packed gate_up AwqTensor ([K, 2I], gate
    columns first; not a view: a staged layer's gate_up goes through awq_matmul,
    as in the JAX package). Default: composed, one W4A16 product and an elementwise
    epilogue (the JAX package's default). `fused=True` runs the one-kernel
    w4a16_gate_up_silu on a CUDA input below FP16_MATMUL_HEURISTIC_TOKENS, and
    otherwise warns and composes, as the JAX package does."""
    tokens = int(np.prod(x.shape[:-1]))
    half = q.n // 2
    if fused:
        if x.is_cuda and tokens < FP16_MATMUL_HEURISTIC_TOKENS:
            y = w4a16_gate_up_silu(x.reshape(tokens, x.shape[-1]).contiguous(), q,
                                   out_dtype=out_dtype)
            return y.reshape(*x.shape[:-1], half)
        logger.warning(
            "awq_gate_up_silu(fused=True) falling back to the composed path "
            "(tokens=%d >= %d or device=%s is not cuda) -- this run does NOT "
            "measure the fused kernel", tokens, FP16_MATMUL_HEURISTIC_TOKENS, x.device)
    gu = awq_matmul(x, q, out_dtype=out_dtype)
    return F.silu(gu[..., :half]) * gu[..., half:]


def concat_awq(tensors) -> AwqTensor:
    """Concatenate AwqTensors along the output (N) axis (same K/group_size)."""
    return AwqTensor(
        w8=torch.cat([t.w8 for t in tensors], dim=-1),
        scales=torch.cat([t.scales for t in tensors], dim=-1),
        zeros=torch.cat([t.zeros for t in tensors], dim=-1),
    )
