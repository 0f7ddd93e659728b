"""Masked attention over a linear KV cache.

Shapes (batch size 1 engine):
  q:        [S, H, D]
  k_cache:  [KVH, L, D], or the full [n_layers, KVH, L, D] cache + layer_idx
  mask:     [S, L] bool   (True = may attend)
Returns [S, H, D]. `attend_batched` is the multi-slot form over
[n_layers, Bc, KVH, L, D] caches. int8 caches come with fp32 per-slot scales
([(n,) KVH, L], batched [n, Bc, KVH, L]).

Routing mirrors `umbrella_tpu/ops/attention.py` with "the tensor is on CUDA" in
place of "the backend is TPU": on CUDA the flash kernels run (they mask a ragged
last block themselves, so no L % 256 guard), applying int8 scales in score
space; otherwise the dense path, which dequantizes an int8 cache to q's dtype
first, as the JAX package does off the TPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernels.tree_attention import attend_dense, attend_flash, attend_flash_batched

__all__ = ["attend", "attend_batched", "attend_batched_dense", "attend_dense"]


def _dequantize(cache: torch.Tensor, cache_scale: torch.Tensor, dtype) -> torch.Tensor:
    return (cache.float() * cache_scale[..., None]).to(dtype)


def attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           mask: torch.Tensor, kv_limit=None,
           scale: Optional[float] = None, logits_soft_cap: float = 0.0,
           layer_idx: Optional[int] = None, k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-slot attention; `kv_limit` (an int32 [1] device tensor or a host
    int) bounds the slots the flash kernel reads, and the mask alone bounds
    the dense path."""
    layered = k_cache.dim() == 4
    if q.is_cuda and kv_limit is not None:
        if not layered:
            k_cache, v_cache, layer_idx = k_cache[None], v_cache[None], 0
            if k_scale is not None:
                k_scale, v_scale = k_scale[None], v_scale[None]
        return attend_flash(q, k_cache, v_cache, mask, kv_limit, layer_idx, scale=scale,
                            soft_cap=logits_soft_cap, k_scale=k_scale, v_scale=v_scale)
    if layered:
        k_cache, v_cache = k_cache[layer_idx], v_cache[layer_idx]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer_idx], v_scale[layer_idx]
    if k_scale is not None:
        k_cache = _dequantize(k_cache, k_scale, q.dtype)
        v_cache = _dequantize(v_cache, v_scale, q.dtype)
    return attend_dense(q, k_cache, v_cache, mask, scale=scale,
                        logits_soft_cap=logits_soft_cap)


def attend_batched_dense(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         mask: torch.Tensor, scale: Optional[float] = None,
                         logits_soft_cap: float = 0.0) -> torch.Tensor:
    """q [B, S, H, D] against per-slot [B, KVH, L, D] caches under [B, S, L] ->
    [B, S, H, D]: the dense path of the JAX package's `attend_batched`."""
    B, S, H, D = q.shape
    KVH = k_cache.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, S, KVH, H // KVH, D)
    scores = torch.einsum("bskgd,bkld->bkgsl", qg.float(), k_cache.float()) * scale
    if logits_soft_cap and logits_soft_cap > 0.0:
        scores = logits_soft_cap * torch.tanh(scores / logits_soft_cap)
    scores = torch.where(mask[:, None, None], scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgsl,bkld->bskgd", probs.float(), v_cache.float()).to(v_cache.dtype)
    return out.reshape(B, S, H, D)


def attend_batched(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   mask: torch.Tensor, kv_limits: torch.Tensor, layer_idx: int,
                   slots: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None,
                   logits_soft_cap: float = 0.0) -> torch.Tensor:
    """Multi-slot attention: q [B, S, H, D] over the batched layered cache, grid
    row b against cache row slots[b] (default b); kv_limits [B] int32 bounds the
    slots the flash kernel reads. Returns [B, S, H, D]."""
    if q.is_cuda:
        return attend_flash_batched(q, k_cache, v_cache, mask, kv_limits, layer_idx,
                                    slots=slots, scale=scale, soft_cap=logits_soft_cap,
                                    k_scale=k_scale, v_scale=v_scale)
    kl, vl = k_cache[layer_idx], v_cache[layer_idx]
    ksl = vsl = None
    if k_scale is not None:
        ksl, vsl = k_scale[layer_idx], v_scale[layer_idx]
    if slots is not None:
        rows = slots.long()
        kl, vl = kl.index_select(0, rows), vl.index_select(0, rows)
        if ksl is not None:
            ksl, vsl = ksl.index_select(0, rows), vsl.index_select(0, rows)
    if ksl is not None:
        kl, vl = _dequantize(kl, ksl, q.dtype), _dequantize(vl, vsl, q.dtype)
    return attend_batched_dense(q, kl, vl, mask, scale=scale, logits_soft_cap=logits_soft_cap)
