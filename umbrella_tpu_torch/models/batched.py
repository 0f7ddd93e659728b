"""Batched (multi-slot) Llama forward and KV cache for continuous batching.

Counterpart of `umbrella_tpu/models/batched.py`, Llama family only (the Gemma2
and MoE batched forms are in ROADMAP queue A, "Gemma2 and MoE"). B request
slots decode in one forward, each with its own committed length and KV window.

KV layout [n_layers, B, kv_heads, L, head_dim] (int8 values with fp32 scales
[n_layers, B, kv_heads, L] when quantized), as in the JAX package. The JAX
package unrolls per-slot writes and compactions into B Python iterations (a
workaround for its TPU runtime); here each is one indexed write or one gather
over all slots, with per-slot offsets as device tensors, so no host read is
taken and the op count does not grow with B. Buffers are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import ModelConfig
from ..ops.attention import attend_batched
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope
from ..ops.select import embed_lookup
from .kv_cache import _quantize_block, is_int8
from .llama import StaticModelArgs, _attn_projections, _linear, _mlp_act, lm_head_logits


class BatchedKVCache(NamedTuple):
    k: torch.Tensor  # [n_layers, B, kv_heads, L, head_dim] (int8 when quantized)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [n_layers, B, kv_heads, L] fp32, int8 mode
    v_scale: Optional[torch.Tensor] = None

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_batched_kv(cfg: ModelConfig, batch: int, max_length: int, dtype=torch.bfloat16,
                    num_layers: Optional[int] = None, device="cpu") -> BatchedKVCache:
    n = num_layers if num_layers is not None else cfg.num_hidden_layers
    shape = (n, batch, cfg.num_key_value_heads, max_length, cfg.resolved_head_dim)
    if is_int8(dtype):
        return BatchedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return BatchedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                          v=torch.zeros(shape, dtype=dtype, device=device))


def _window_cols(offsets: torch.Tensor, width: int, length: int) -> torch.Tensor:
    """[B, width] cache columns of each slot's window: starts clamped to
    [0, length - width], as `lax.dynamic_update_slice` clamps."""
    starts = offsets.long().clamp(0, length - width)
    return starts[:, None] + torch.arange(width, device=offsets.device)[None, :]


def update_layer_batched(kv: BatchedKVCache, layer_idx: int, k_new: torch.Tensor,
                         v_new: torch.Tensor, offsets: torch.Tensor) -> BatchedKVCache:
    """Write k/v [B, S, KVH, D] of every slot at its own offsets[b] (a [B] device
    tensor) in one indexed write per buffer."""
    B, S = k_new.shape[:2]
    cols = _window_cols(offsets, S, kv.k.shape[3])
    rows = torch.arange(B, device=cols.device)[:, None]
    # kv.k[layer][rows, :, cols] is [B, S, KVH, D]: the advanced indices lead
    if kv.quantized:
        for buf, sbuf, new in ((kv.k, kv.k_scale, k_new), (kv.v, kv.v_scale, v_new)):
            q, s = _quantize_block(new)
            buf[layer_idx][rows, :, cols] = q
            sbuf[layer_idx][rows, :, cols] = s
        return kv
    kv.k[layer_idx][rows, :, cols] = k_new.to(kv.k.dtype)
    kv.v[layer_idx][rows, :, cols] = v_new.to(kv.v.dtype)
    return kv


def update_layer_slot(kv: BatchedKVCache, layer_idx: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, slot: int, offset: int) -> BatchedKVCache:
    """Write k/v [S, KVH, D] of ONE slot at `offset` (prefill path; host ints)."""
    S = k_new.shape[0]
    start = min(max(int(offset), 0), kv.k.shape[3] - S)
    win = slice(start, start + S)
    if kv.quantized:
        for buf, sbuf, new in ((kv.k, kv.k_scale, k_new), (kv.v, kv.v_scale, v_new)):
            q, s = _quantize_block(new)
            buf[layer_idx, slot, :, win] = q.transpose(0, 1)
            sbuf[layer_idx, slot, :, win] = s.transpose(0, 1)
        return kv
    kv.k[layer_idx, slot, :, win] = k_new.transpose(0, 1).to(kv.k.dtype)
    kv.v[layer_idx, slot, :, win] = v_new.transpose(0, 1).to(kv.v.dtype)
    return kv


def gather_compact_batched(kv: BatchedKVCache, local_indices: torch.Tensor,
                           offsets: torch.Tensor, accept_lens: torch.Tensor) -> BatchedKVCache:
    """Per-slot KV compaction (see kv_cache.gather_compact), all layers and slots
    at once: slot b's accepted tree slots local_indices[b, :accept_lens[b]] move
    down to its linear prefix at offsets[b]; the rest of its window is zeroed.
    int8 scales move with their rows."""
    B, T = local_indices.shape
    cols = _window_cols(offsets, T, kv.k.shape[3])
    src = cols[:, :1] + local_indices.long()
    rows = torch.arange(B, device=cols.device)[:, None]
    valid = torch.arange(T, device=cols.device)[None, :] < accept_lens[:, None]
    for buf in kv:
        if buf is None:
            continue
        picked = buf[:, rows, :, src]  # [B, T, n_layers, KVH(, D)]
        keep = valid.reshape(B, T, *[1] * (picked.dim() - 2))
        buf[:, rows, :, cols] = torch.where(keep, picked, torch.zeros_like(picked))
    return kv


def _layer_block(args: StaticModelArgs, lw: dict, hidden: torch.Tensor, attend_fn):
    """One decoder layer on hidden [N, H] (N = B * S rows); `attend_fn(q, k, v)`
    writes the layer's KV and returns attention [N, heads * D].

    As in the JAX package's batched forward, `awq_act="int8"` reaches only the
    QKV projection (through _attn_projections): wo, the MLP and down run W4A16
    (ROADMAP queue C)."""
    residual = hidden
    x = rms_norm(hidden, lw["input_norm"], args.rms_eps)
    q, k, v = _attn_projections(args, lw, x)
    hidden = residual + _linear(attend_fn(q, k, v), lw["wo"])
    residual = hidden
    x = rms_norm(hidden, lw["post_norm"], args.rms_eps)
    return residual + _linear(_mlp_act(lw, x), lw["down"])


def _final_logits(params: dict, args: StaticModelArgs, hidden: torch.Tensor) -> torch.Tensor:
    return lm_head_logits(params, rms_norm(hidden, params["final_norm"], args.rms_eps))


def batched_llama_forward(params: dict, args: StaticModelArgs, kv: BatchedKVCache,
                          input_ids: torch.Tensor,  # [B, S]
                          position_ids: torch.Tensor,  # [B, S]
                          attn_mask: torch.Tensor,  # [B, S, L] bool
                          write_offsets: torch.Tensor,  # [B] int32, on the device
                          ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """All-slots forward; returns (fp32 logits [B, S, V], kv updated in place)."""
    B, S = input_ids.shape
    H, KVH, D = args.num_heads, args.num_kv_heads, args.head_dim
    inv_freq, rope_scale = params["rope_inv_freq"], params["rope_scale"]
    kv_limits = (write_offsets + S).to(torch.int32)
    pos = position_ids.reshape(-1)
    hidden = embed_lookup(params["embed"], input_ids.reshape(-1), params["final_norm"].dtype)

    for i in range(args.n_layers):
        def attend_fn(q, k, v, i=i):
            # rope is per row, so the flattened [B * S] rows rotate as vmap would
            q, k = apply_rope(q.reshape(B * S, H, D), k.reshape(B * S, KVH, D),
                              inv_freq, rope_scale, pos)
            update_layer_batched(kv, i, k.reshape(B, S, KVH, D), v.reshape(B, S, KVH, D),
                                 write_offsets)
            out = attend_batched(q.reshape(B, S, H, D).contiguous(), kv.k, kv.v, attn_mask,
                                 kv_limits, i, k_scale=kv.k_scale, v_scale=kv.v_scale)
            return out.reshape(B * S, H * D)

        lw = {k: v[i] for k, v in params["layers"].items()}
        hidden = _layer_block(args, lw, hidden, attend_fn)
    return _final_logits(params, args, hidden).reshape(B, S, -1), kv


def slot_llama_forward(params: dict, args: StaticModelArgs, kv: BatchedKVCache,
                       input_ids: torch.Tensor,  # [S]
                       position_ids: torch.Tensor,  # [S]
                       attn_mask: torch.Tensor,  # [S, L] bool
                       slot: int, write_offset: int) -> Tuple[torch.Tensor, BatchedKVCache]:
    """Single-sequence forward into cache row `slot` (the prefill path); returns
    (fp32 logits [S, V], kv updated in place)."""
    S = input_ids.shape[0]
    H, KVH, D = args.num_heads, args.num_kv_heads, args.head_dim
    inv_freq, rope_scale = params["rope_inv_freq"], params["rope_scale"]
    dev = input_ids.device
    # device-side fills: no host-to-device copy, so nothing waits on the stream
    kv_limits = torch.full((1,), int(write_offset) + S, dtype=torch.int32, device=dev)
    slots = torch.full((1,), int(slot), dtype=torch.int32, device=dev)
    hidden = embed_lookup(params["embed"], input_ids, params["final_norm"].dtype)

    for i in range(args.n_layers):
        def attend_fn(q, k, v, i=i):
            q, k = apply_rope(q.reshape(S, H, D), k.reshape(S, KVH, D), inv_freq, rope_scale,
                              position_ids)
            update_layer_slot(kv, i, k, v.reshape(S, KVH, D), slot, write_offset)
            out = attend_batched(q[None].contiguous(), kv.k, kv.v, attn_mask[None], kv_limits, i,
                                 slots=slots, k_scale=kv.k_scale, v_scale=kv.v_scale)
            return out.reshape(S, H * D)

        lw = {k: v[i] for k, v in params["layers"].items()}
        hidden = _layer_block(args, lw, hidden, attend_fn)
    return _final_logits(params, args, hidden), kv
