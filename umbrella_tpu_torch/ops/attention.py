"""Masked attention over a linear KV cache.

Shapes (batch size 1 engine):
  q:        [S, H, D]
  k_cache:  [KVH, L, D], or the full [n_layers, KVH, L, D] cache + layer_idx
  mask:     [S, L] bool   (True = may attend)
Returns [S, H, D].

Routing mirrors `umbrella_tpu/ops/attention.attend` with "the tensor is on CUDA"
in place of "the backend is TPU": on CUDA with a `kv_limit` the flash kernel
runs (it masks a ragged last block itself, so no L % 256 guard); otherwise the
dense plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernels.tree_attention import attend_dense, attend_flash

__all__ = ["attend", "attend_dense"]


def attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           mask: torch.Tensor, kv_limit: Optional[int] = None,
           scale: Optional[float] = None, logits_soft_cap: float = 0.0,
           layer_idx: Optional[int] = None) -> torch.Tensor:
    layered = k_cache.dim() == 4
    if q.is_cuda and kv_limit is not None:
        if not layered:
            k_cache, v_cache, layer_idx = k_cache[None], v_cache[None], 0
        return attend_flash(q, k_cache, v_cache, mask, kv_limit, layer_idx, scale=scale,
                            soft_cap=logits_soft_cap)
    if layered:
        k_cache, v_cache = k_cache[layer_idx], v_cache[layer_idx]
    return attend_dense(q, k_cache, v_cache, mask, scale=scale,
                        logits_soft_cap=logits_soft_cap)
