"""Linear KV cache, layout `[num_layers, kv_heads, max_length, head_dim]`.

Counterpart of `umbrella_tpu/models/kv_cache.py`. The JAX cache is functional;
here the buffers are updated in place (slice assignment), which saves a copy of
the cache per step, and the functions return the same cache for symmetry.
Write offsets are clamped so the written window fits the cache, as
`lax.dynamic_update_slice` clamps in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig


class KVCache(NamedTuple):
    k: torch.Tensor  # [layers, kv_heads, max_len, head_dim]
    v: torch.Tensor


def init_kv_cache(cfg: ModelConfig, max_length: int, dtype=torch.bfloat16,
                  num_layers: int | None = None, device="cpu") -> KVCache:
    if dtype in ("int8", torch.int8):
        raise NotImplementedError("int8 KV cache is not ported yet (ROADMAP queue A, item 2)")
    n_layers = num_layers if num_layers is not None else cfg.num_hidden_layers
    shape = (n_layers, cfg.num_key_value_heads, max_length, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _window_start(offset: int, width: int, length: int) -> int:
    return min(max(int(offset), 0), length - width)


def update_layer(kv: KVCache, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor,
                 offset: int) -> KVCache:
    """Write k/v [S, kv_heads, head_dim] at slots [offset, offset + S) of one layer."""
    S = k_new.shape[0]
    start = _window_start(offset, S, kv.k.shape[2])
    kv.k[layer_idx, :, start:start + S] = k_new.transpose(0, 1).to(kv.k.dtype)
    kv.v[layer_idx, :, start:start + S] = v_new.transpose(0, 1).to(kv.v.dtype)
    return kv


def gather_compact(kv: KVCache, local_indices: torch.Tensor, offset: int, accept_len) -> KVCache:
    """Copy accepted tree slots down to the linear prefix; zero the rest of the window.

    `local_indices` [tree_size] are tree-local slot ids; entries at or past
    `accept_len` (an int or a 0-d tensor) are ignored and their destination
    slots are zeroed, as in the JAX package."""
    T = local_indices.shape[0]
    pos = torch.arange(T, device=local_indices.device)
    valid = (pos < accept_len)[None, None, :, None]
    idx = local_indices.long()
    for buf in (kv.k, kv.v):
        start = _window_start(offset, T, buf.shape[2])
        window = buf[:, :, start:start + T]
        picked = window.index_select(2, idx)
        buf[:, :, start:start + T] = torch.where(valid, picked, torch.zeros_like(picked))
    return kv
