"""Linear KV cache, layout `[num_layers, kv_heads, max_length, head_dim]`.

Counterpart of `umbrella_tpu/models/kv_cache.py`. The JAX cache is functional;
here the buffers are updated in place (slice assignment), which saves a copy of
the cache per step, and the functions return the same cache for symmetry.
Write offsets are clamped so the written window fits the cache, as
`lax.dynamic_update_slice` clamps in the JAX package.

int8 mode (`dtype="int8"`): int8 values with one fp32 scale per (layer, head,
slot), `[num_layers, kv_heads, max_length]` with no trailing 1; each written row
is quantized on its own, so a row's bytes do not depend on what else was
written with it.

Offsets are host ints or 0-d device tensors (the device-resident decode
loop's): every write and gather goes through `index_copy_` / `index_select`
over the clamped window's positions (`ops.masks.window_index`), so neither
form reads anything back to the host.

A staged (pipeline-parallel) model keeps one KVCache per stage, over that
stage's layers and on its device (`StagedKVCache`); the stage's layers call
`update_layer` on their own cache with their local layer index, and
`gather_compact` compacts every stage (as phases, one a stage on its device:
`compact_phases`, which the engines' graphed step captures).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import ModelConfig
from ..cuda_graphs import Phase, run_phases
from ..ops.masks import window_index


class KVCache(NamedTuple):
    k: torch.Tensor  # [layers, kv_heads, max_len, head_dim] (int8 when quantized)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [layers, kv_heads, max_len] fp32, int8 mode
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


class StagedKVCache(NamedTuple):
    """The KV caches of a staged model, one KVCache per stage (in stage order)."""
    stages: Tuple[KVCache, ...]


def is_int8(dtype) -> bool:
    return dtype in ("int8", torch.int8)


def init_kv_cache(cfg: ModelConfig, max_length: int, dtype=torch.bfloat16,
                  num_layers: int | None = None, device="cpu") -> KVCache:
    n_layers = num_layers if num_layers is not None else cfg.num_hidden_layers
    shape = (n_layers, cfg.num_key_value_heads, max_length, cfg.resolved_head_dim)
    if is_int8(dtype):
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _quantize_block(x: torch.Tensor):
    """[..., D] fp -> (int8 values [..., D], fp32 per-row scales [...]).

    Bit for bit the JAX package's `_quantize_block` as its engines run it, under
    jit: XLA compiles `amax / 127.0` as `amax * (1 / 127)` and keeps `x / scale`
    a true divide; round half to even, clip to +-127."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax * (1.0 / 127.0), min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def update_layer(kv: KVCache, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor,
                 offset) -> KVCache:
    """Write k/v [S, kv_heads, head_dim] at slots [offset, offset + S) of one layer
    (quantized with their scales in int8 mode); `offset` is a host int or a
    0-d device tensor."""
    idx = window_index(offset, k_new.shape[0], kv.k.shape[2], kv.k.device)
    if kv.quantized:
        for buf, sbuf, new in ((kv.k, kv.k_scale, k_new), (kv.v, kv.v_scale, v_new)):
            q, s = _quantize_block(new)
            buf[layer_idx].index_copy_(1, idx, q.transpose(0, 1))
            sbuf[layer_idx].index_copy_(1, idx, s.transpose(0, 1))
        return kv
    kv.k[layer_idx].index_copy_(1, idx, k_new.transpose(0, 1).to(kv.k.dtype))
    kv.v[layer_idx].index_copy_(1, idx, v_new.transpose(0, 1).to(kv.v.dtype))
    return kv


def compact_phases(kv) -> list:
    """gather_compact as phases (cuda_graphs.Phase) over the step values path
    (the accepted tree-local slots), nn (the offset) and alen (the accept
    length): one phase a cache, a StagedKVCache's stages each on its device."""
    def compact(cache):
        def run(path, nn, alen):
            gather_compact(cache, path, nn, alen)
        return run

    caches = kv.stages if isinstance(kv, StagedKVCache) else (kv,)
    return [Phase(f"compact{s}", cache.k.device, compact(cache), ("path", "nn", "alen"))
            for s, cache in enumerate(caches)]


def gather_compact(kv, local_indices: torch.Tensor, offset, accept_len):
    """Copy accepted tree slots down to the linear prefix; zero the rest of the window.

    `local_indices` [tree_size] are tree-local slot ids; entries at or past
    `accept_len` (an int or a 0-d tensor) are ignored and their destination
    slots are zeroed, as in the JAX package. `offset` is a host int or a 0-d
    device tensor. int8 scales move with their rows. A StagedKVCache is
    compacted stage by stage (compact_phases), the indices, offset and accept
    length copied to each stage's device (no host read)."""
    if isinstance(kv, StagedKVCache):
        run_phases(compact_phases(kv), dict(path=local_indices, nn=offset, alen=accept_len))
        return kv
    T = local_indices.shape[0]
    dst = window_index(offset, T, kv.k.shape[2], local_indices.device)
    src = dst[0] + local_indices.long()
    valid = torch.arange(T, device=local_indices.device) < accept_len
    for buf in kv:
        if buf is None:
            continue
        picked = buf.index_select(2, src)
        keep = valid.reshape(T, *[1] * (buf.dim() - 3))
        buf.index_copy_(2, dst, torch.where(keep, picked, torch.zeros_like(picked)))
    return kv
