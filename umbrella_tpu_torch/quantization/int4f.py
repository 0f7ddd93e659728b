"""Int4F: W4 weights with rank-1 factorized scales, for int8 draft forwards.

    w[k, n]  ~=  a[k] * b[n] * (q4[k, n] - 8),   q4 in [0, 15]

so y = b * ((x * a) @ (q4 - 8)): the row factor premultiplies the activations,
the column factor postmultiplies the output, and the inner sum is one full-K
int8 x int8 dot (ops/kernels/w4a8f.py). Storage keeps the split-halves nibble
packing of AwqTensor. See `umbrella_tpu/quantization/int4f.py` for the fit
(log-space rank-1 row factor, exact-max column factor, optional ALS sweeps).

`int4f_matmul` routes as the JAX package does: above INT8_KERNEL_MAX_TOKENS the
weight is dequantized to bf16 for a dense product; at or below it a CUDA input
runs the hand-written kernel and a CPU input its plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.kernels.w4a8f import w4a8f_matmul, w4a8f_matmul_ref

# token cap of the int8 kernel path (w4a8f.py:185 of the JAX package); kept
# because the dense branch above it has different numerics
INT8_KERNEL_MAX_TOKENS = 384


class Int4FTensor(NamedTuple):
    """Split-halves packed W4 with factorized scales (logical shape [K, N]):
    w8 int8 [K/2, N], a fp32 [K] (expanded per row), b fp32 [N]."""
    w8: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor

    @property
    def k(self) -> int:
        return 2 * self.w8.shape[-2]

    @property
    def n(self) -> int:
        return self.w8.shape[-1]


def _log_row_factor(m: torch.Tensor) -> torch.Tensor:
    """a[g] = exp(mean_n log m[g, n]) for a positive [G, N] magnitude matrix."""
    return torch.exp(torch.log(torch.clamp(m.float(), min=1e-12)).mean(dim=-1))


def _requantize(wf: torch.Tensor, a: torch.Tensor, refine: int = 16) -> Int4FTensor:
    """fp32 [K, N] + row factor a [K] -> Int4FTensor, with `refine` alternating
    least-squares sweeps of the column factor b (a stays fixed)."""
    K, N = wf.shape
    scaled = wf / a[:, None]
    # times the fp32 reciprocal, as XLA compiles the JAX package's `/ 7.5`: each
    # column's largest value lands exactly on the +-7.5 rounding edge
    b = torch.clamp(scaled.abs().amax(dim=0) * (1.0 / 7.5), min=1e-12)  # [N]

    def q_of(b):  # (wf / a) / b, reassociated as XLA compiles it
        return torch.clamp(torch.round(wf / (a[:, None] * b[None, :])), -8, 7)

    a2 = (a * a)[:, None]  # the LS objective is ||w - a b q||^2, weight a^2
    for _ in range(refine):
        q = q_of(b)
        num = (a2 * q * scaled).sum(dim=0)
        den = (a2 * q * q).sum(dim=0)
        # degenerate columns (all-zero w -> q == 0) keep their previous scale
        b_new = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), b)
        b = torch.where(b_new.abs() > 1e-12, b_new, b)
    q4 = (q_of(b) + 8).to(torch.int32)
    w8 = (q4[: K // 2] | (q4[K // 2:] << 4)).to(torch.uint8).view(torch.int8)
    return Int4FTensor(w8=w8, a=a.float(), b=b.float())


def _quantize_dense(w: torch.Tensor, group_size: int, refine: int = 16) -> Int4FTensor:
    K, N = w.shape
    group_size = min(group_size, K)  # tiny matrices: one group per column
    if K % group_size or K % 2:
        raise ValueError(f"K={K} must be even and a multiple of group_size={group_size}")
    wf = w.float()
    m = wf.reshape(K // group_size, group_size, N).abs().amax(dim=1)
    a = torch.repeat_interleave(_log_row_factor(m), group_size)  # [K]
    return _requantize(wf, a, refine=refine)


def quantize_int4f(w, group_size: int = 128, n_chunk: int = 8192,
                   refine: int = 16) -> Int4FTensor:
    """Quantize a dense [K, N] weight or an AwqTensor to Int4F on its device.

    AWQ sources are requantized from their fp32 dequantized values in N-chunks
    (the whole fp32 8B lm_head would be 2.1 GB); the row factor comes from the
    AWQ scale matrix, read whole."""
    from .awq import AwqTensor, dequantize

    if isinstance(w, AwqTensor):
        a = torch.repeat_interleave(_log_row_factor(w.scales), w.group_size)  # [K]
        parts = []
        for n0 in range(0, w.n, n_chunk):
            chunk = AwqTensor(w8=w.w8[:, n0:n0 + n_chunk], scales=w.scales[:, n0:n0 + n_chunk],
                              zeros=w.zeros[:, n0:n0 + n_chunk])
            parts.append(_requantize(dequantize(chunk, dtype=torch.float32), a, refine=refine))
        if len(parts) == 1:
            return parts[0]
        return Int4FTensor(w8=torch.cat([p.w8 for p in parts], dim=1), a=parts[0].a,
                           b=torch.cat([p.b for p in parts], dim=0))
    return _quantize_dense(torch.as_tensor(w), group_size, refine=refine)


def dequantize_int4f(q: Int4FTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequant to [K, N]: (q4 - 8) * a * b in fp32, cast to dtype."""
    w32 = q.w8.to(torch.int32)
    qv = torch.cat([(w32 & 0xF) - 8, ((w32 >> 4) & 0xF) - 8], dim=-2).float()
    return (qv * q.a[:, None] * q.b[None, :]).to(dtype)


def has_int4f_layers(layers: dict) -> bool:
    for v in layers.values():
        if isinstance(v, Int4FTensor):
            return True
        if isinstance(v, tuple) and v and isinstance(v[0], Int4FTensor):
            return True
    return False


def quantize_params_int4f(params: dict, group_size: int = 128,
                          quantize_lm_head: bool = True) -> dict:
    """A llama-family param tree's linear weights (dense stacks or per-layer
    AwqTensor tuples) -> per-layer Int4FTensor tuples; embeddings and norms stay
    fp. A tied head is materialised from embed.T and quantized."""
    src_layers = params["layers"]
    out_layers = dict(src_layers)
    n = src_layers["input_norm"].shape[0]
    for name in ("wq", "wk", "wv", "wo", "gate", "up", "down", "wqkv", "gate_up"):
        if name not in src_layers:
            continue
        v = src_layers[name]
        if isinstance(v, tuple):  # per-layer (maybe mixed with Int4F): convert per element
            out_layers[name] = tuple(
                t if isinstance(t, Int4FTensor) else quantize_int4f(t, group_size) for t in v)
        else:  # stacked dense [n, K, N]
            out_layers[name] = tuple(quantize_int4f(v[i], group_size) for i in range(n))
    out = dict(params)
    out["layers"] = out_layers
    if quantize_lm_head:
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T.contiguous()  # tied: materialise an Int4F head
        if not isinstance(head, Int4FTensor):
            out["lm_head"] = quantize_int4f(head, group_size)
    return out


def quantize_runtime_int4f(runtime, group_size: int = 128, quantize_lm_head: bool = True):
    """Int4F-quantize a loaded ModelRuntime (the draft-side counterpart of
    quantization/loader.quantize_runtime)."""
    from ..models.auto_model import ModelRuntime

    params = quantize_params_int4f(runtime.params, group_size=group_size,
                                   quantize_lm_head=quantize_lm_head)
    return ModelRuntime(runtime.cfg, params, runtime.max_length, dtype=runtime.dtype,
                        family=runtime.family, n_layers=runtime.args.n_layers,
                        model_name=runtime.model_name, device=runtime.device)


def hybridize_shared_prefix(params: dict, n_prefix: int, group_size: int = 128,
                            head: bool = True, refine: int = 16) -> dict:
    """Convert the first n_prefix layers' linears (and the lm_head) of a quantized
    param tree to Int4F, leaving later layers untouched. An early-exit draft
    sliced from the converted target then shares those tensors exactly."""
    src = params["layers"]
    out_layers = dict(src)
    for name in ("wq", "wk", "wv", "wo", "gate", "up", "down", "wqkv", "gate_up"):
        if name not in src:
            continue
        v = src[name]
        if not isinstance(v, tuple):
            raise TypeError("hybridize_shared_prefix expects per-layer tuples")
        out_layers[name] = tuple(
            quantize_int4f(t, group_size, refine=refine)
            if (i < n_prefix and not isinstance(t, Int4FTensor)) else t
            for i, t in enumerate(v))
    out = dict(params)
    out["layers"] = out_layers
    if head:
        h = params.get("lm_head")
        if h is not None and not isinstance(h, Int4FTensor):
            out["lm_head"] = quantize_int4f(h, group_size, refine=refine)
    return out


def int4f_matmul(x: torch.Tensor, q: Int4FTensor, bias=None, out_dtype=None) -> torch.Tensor:
    """x [..., K] -> [..., N]: dense bf16 product above INT8_KERNEL_MAX_TOKENS,
    else the int8 kernel on CUDA or its plain version on the CPU."""
    tokens = int(np.prod(x.shape[:-1]))
    x2 = x.reshape(tokens, x.shape[-1]).contiguous()
    out_dtype = out_dtype or x.dtype
    if tokens > INT8_KERNEL_MAX_TOKENS:
        w = dequantize_int4f(q, dtype=torch.bfloat16)
        y = (x2.to(torch.bfloat16).float() @ w.float()).to(out_dtype)
    elif x.is_cuda:
        y = w4a8f_matmul(x2, q, out_dtype=out_dtype)
    else:
        y = w4a8f_matmul_ref(x2, q, out_dtype=out_dtype)
    y = y.reshape(*x.shape[:-1], q.n)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
