"""Batched (multi-slot) Llama forward and KV cache for continuous batching.

Counterpart of `umbrella_tpu/models/batched.py`: the all-slots and single-slot
forwards of the llama, Gemma2 and MoE families (`model_forwards`; a
tensor-parallel runtime's are parallel/mesh.tp_batched_forwards, the JAX
package's `tp_axis` forms, over a ShardedKVCache of one BatchedKVCache a
shard). B request slots decode in one forward, each with its own committed
length and KV window.

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
from .gemma import (GemmaStaticArgs, embed_scaled, gemma2_block, gemma_logits, is_sliding,
                    sliding_mask)
from .kv_cache import ShardedKVCache, _quantize_block, is_int8
from .llama import StaticModelArgs, _attn_projections, _linear, llama_block, lm_head_logits
from .moe import moe_block


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


def init_runtime_batched_kv(runtime, batch: int, max_length: int, dtype):
    """The batched cache of a runtime: one BatchedKVCache on its device, or
    a tensor-parallel runtime's ShardedKVCache (parallel/mesh.py)."""
    if "tp_shards" in runtime.params:
        from ..parallel.mesh import init_sharded_batched_kv

        return init_sharded_batched_kv(runtime, batch, max_length, dtype)
    return init_batched_kv(runtime.cfg, batch, max_length, dtype,
                           num_layers=runtime.args.n_layers, device=runtime.device)


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
    int8 scales move with their rows. A ShardedKVCache is compacted shard by
    shard, the inputs copied to each shard's device."""
    if isinstance(kv, ShardedKVCache):
        for cache in kv.shards:
            dev = cache.k.device
            gather_compact_batched(cache, local_indices.to(dev), offsets.to(dev),
                                   accept_lens.to(dev))
        return kv
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


def _layer_block(args: StaticModelArgs, lw: dict, hidden: torch.Tensor, attend_fn,
                 top_k: int = 0):
    """One llama-family decoder layer on hidden [N, H] (N = B * S rows), or with
    `top_k` > 0 one MoE layer (its MLP models/moe's); `attend_fn(q, k, v)`
    writes the layer's KV and returns attention [N, heads * D].

    As in the JAX package's batched forward, `awq_act="int8"` reaches only the
    QKV projection (through _attn_projections): wo, the MLP and down run W4A16
    (ROADMAP queue C)."""
    if not top_k:
        return llama_block(args, lw, hidden, attend_fn)
    x = rms_norm(hidden, lw["input_norm"], args.rms_eps)
    attn = _linear(attend_fn(*_attn_projections(args, lw, x)), lw["wo"])
    return moe_block(args, lw, hidden, attn, top_k)


def _final_logits(params: dict, args: StaticModelArgs, hidden: torch.Tensor) -> torch.Tensor:
    return lm_head_logits(params, rms_norm(hidden, params["final_norm"], args.rms_eps))


def _attend_all_slots(args, params: dict, kv: BatchedKVCache, i: int, position_ids, mask,
                      write_offsets, kv_limits, scale=None, soft_cap: float = 0.0):
    """attend_fn of layer i over every slot: rope on q/k [B * S, heads * D]
    (per row, so the flattened rows rotate as the JAX package's vmap does),
    the KV write at each slot's offset, then batched attention."""
    B, S = position_ids.shape
    H, KVH, D = args.num_heads, args.num_kv_heads, args.head_dim

    def attend_fn(q, k, v):
        q, k = apply_rope(q.reshape(B * S, H, D), k.reshape(B * S, KVH, D),
                          params["rope_inv_freq"], params["rope_scale"], position_ids.reshape(-1))
        update_layer_batched(kv, i, k.reshape(B, S, KVH, D), v.reshape(B, S, KVH, D),
                             write_offsets)
        out = attend_batched(q.reshape(B, S, H, D).contiguous(), kv.k, kv.v, mask, kv_limits, i,
                             scale=scale, logits_soft_cap=soft_cap, k_scale=kv.k_scale,
                             v_scale=kv.v_scale)
        return out.reshape(B * S, H * D)

    return attend_fn


def _slot_limits(position_ids, slot: int, write_offset: int):
    """int32 [1] kv limit and slot of a single-slot forward, filled on the
    device (no host-to-device copy, so nothing waits on the stream)."""
    dev, S = position_ids.device, position_ids.shape[0]
    return (torch.full((1,), int(write_offset) + S, dtype=torch.int32, device=dev),
            torch.full((1,), int(slot), dtype=torch.int32, device=dev))


def _attend_one_slot(args, params: dict, kv: BatchedKVCache, i: int, position_ids, mask,
                     slot: int, write_offset: int, limits, scale=None, soft_cap: float = 0.0):
    """attend_fn of layer i for one slot's rows [S] (the prefill path);
    `limits` is _slot_limits'."""
    S = position_ids.shape[0]
    H, KVH, D = args.num_heads, args.num_kv_heads, args.head_dim
    kv_limits, slots = limits

    def attend_fn(q, k, v):
        q, k = apply_rope(q.reshape(S, H, D), k.reshape(S, KVH, D), params["rope_inv_freq"],
                          params["rope_scale"], position_ids)
        update_layer_slot(kv, i, k, v.reshape(S, KVH, D), slot, write_offset)
        out = attend_batched(q[None].contiguous(), kv.k, kv.v, mask[None], kv_limits, i,
                             slots=slots, scale=scale, logits_soft_cap=soft_cap,
                             k_scale=kv.k_scale, v_scale=kv.v_scale)
        return out.reshape(S, H * D)

    return attend_fn


def _layers(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def batched_llama_forward(params: dict, args: StaticModelArgs, kv: BatchedKVCache,
                          input_ids: torch.Tensor,  # [B, S]
                          position_ids: torch.Tensor,  # [B, S]
                          attn_mask: torch.Tensor,  # [B, S, L] bool
                          write_offsets: torch.Tensor,  # [B] int32, on the device
                          top_k: int = 0) -> Tuple[torch.Tensor, BatchedKVCache]:
    """All-slots forward; returns (fp32 logits [B, S, V], kv updated in place).
    `top_k` > 0 makes it the MoE family's (batched_moe_forward)."""
    B, S = input_ids.shape
    kv_limits = (write_offsets + S).to(torch.int32)
    hidden = embed_lookup(params["embed"], input_ids.reshape(-1), params["final_norm"].dtype)
    for i in range(args.n_layers):
        attend_fn = _attend_all_slots(args, params, kv, i, position_ids, attn_mask,
                                      write_offsets, kv_limits)
        hidden = _layer_block(args, _layers(params, i), hidden, attend_fn, top_k)
    return _final_logits(params, args, hidden).reshape(B, S, -1), kv


def slot_llama_forward(params: dict, args: StaticModelArgs, kv: BatchedKVCache,
                       input_ids: torch.Tensor,  # [S]
                       position_ids: torch.Tensor,  # [S]
                       attn_mask: torch.Tensor,  # [S, L] bool
                       slot: int, write_offset: int,
                       top_k: int = 0) -> Tuple[torch.Tensor, BatchedKVCache]:
    """Single-sequence forward into cache row `slot` (the prefill path); returns
    (fp32 logits [S, V], kv updated in place). `top_k` > 0 makes it the MoE
    family's (slot_moe_forward)."""
    limits = _slot_limits(position_ids, slot, write_offset)
    hidden = embed_lookup(params["embed"], input_ids, params["final_norm"].dtype)
    for i in range(args.n_layers):
        attend_fn = _attend_one_slot(args, params, kv, i, position_ids, attn_mask, slot,
                                     write_offset, limits)
        hidden = _layer_block(args, _layers(params, i), hidden, attend_fn, top_k)
    return _final_logits(params, args, hidden), kv


def batched_moe_forward(params: dict, args: StaticModelArgs, kv: BatchedKVCache,
                        input_ids, position_ids, attn_mask, write_offsets,
                        top_k: int = 2) -> Tuple[torch.Tensor, BatchedKVCache]:
    """All-slots MoE forward: batched_llama_forward's attention over the batched
    cache and the dense-dispatch top-k MoE MLP (models/moe.py)."""
    return batched_llama_forward(params, args, kv, input_ids, position_ids, attn_mask,
                                 write_offsets, top_k=top_k)


def slot_moe_forward(params: dict, args: StaticModelArgs, kv: BatchedKVCache,
                     input_ids, position_ids, attn_mask, slot: int, write_offset: int,
                     top_k: int = 2) -> Tuple[torch.Tensor, BatchedKVCache]:
    """Single-slot MoE forward (the batched engine's prefill path)."""
    return slot_llama_forward(params, args, kv, input_ids, position_ids, attn_mask, slot,
                              write_offset, top_k=top_k)


def batched_gemma2_forward(params: dict, args: GemmaStaticArgs, kv: BatchedKVCache,
                           input_ids: torch.Tensor,  # [B, S]
                           position_ids: torch.Tensor,  # [B, S]
                           attn_mask: torch.Tensor,  # [B, S, L] bool
                           write_offsets: torch.Tensor,  # [B] int32, on the device
                           ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """All-slots Gemma2 forward (models/gemma.py's layer, each slot's sliding
    window from its own positions); returns (fp32 logits [B, S, V], kv)."""
    B, S = input_ids.shape
    kv_limits = (write_offsets + S).to(torch.int32)
    masks = (attn_mask, sliding_mask(attn_mask, position_ids, args.sliding_window))
    hidden = embed_scaled(params, args, input_ids.reshape(-1))
    for i in range(args.n_layers):
        attend_fn = _attend_all_slots(args, params, kv, i, position_ids, masks[is_sliding(i)],
                                      write_offsets, kv_limits, scale=args.attn_scale,
                                      soft_cap=args.attn_softcap)
        hidden = gemma2_block(args, _layers(params, i), hidden, attend_fn)
    return gemma_logits(params, args, hidden).reshape(B, S, -1), kv


def slot_gemma2_forward(params: dict, args: GemmaStaticArgs, kv: BatchedKVCache,
                        input_ids: torch.Tensor,  # [S]
                        position_ids: torch.Tensor,  # [S]
                        attn_mask: torch.Tensor,  # [S, L] bool
                        slot: int, write_offset: int) -> Tuple[torch.Tensor, BatchedKVCache]:
    """Single-slot Gemma2 forward (the batched engine's prefill path)."""
    limits = _slot_limits(position_ids, slot, write_offset)
    masks = (attn_mask, sliding_mask(attn_mask, position_ids, args.sliding_window))
    hidden = embed_scaled(params, args, input_ids)
    for i in range(args.n_layers):
        attend_fn = _attend_one_slot(args, params, kv, i, position_ids, masks[is_sliding(i)],
                                     slot, write_offset, limits, scale=args.attn_scale,
                                     soft_cap=args.attn_softcap)
        hidden = gemma2_block(args, _layers(params, i), hidden, attend_fn)
    return gemma_logits(params, args, hidden), kv


def model_forwards(runtime):
    """(batched_fwd, slot_fwd) of one runtime, by family:
    batched_fwd(params, kv, ids, pos, mask, offsets) and
    slot_fwd(params, kv, ids, pos, mask, slot, offset). A tensor-parallel
    runtime's are parallel/mesh.tp_batched_forwards; an expert-parallel
    runtime takes the MoE forms as they are."""
    if "tp_shards" in runtime.params:
        from ..parallel.mesh import tp_batched_forwards

        return tp_batched_forwards(runtime)
    args, extra = runtime.args, {}
    if runtime.family == "gemma2":
        args, batched, slot = runtime.gemma_args, batched_gemma2_forward, slot_gemma2_forward
    elif runtime.family == "moe":
        batched, slot = batched_moe_forward, slot_moe_forward
        extra = dict(top_k=runtime.cfg.num_experts_per_tok)
    else:
        batched, slot = batched_llama_forward, slot_llama_forward

    def batched_fwd(params, kv, ids, pos, mask, offsets):
        return batched(params, args, kv, ids, pos, mask, offsets, **extra)

    def slot_fwd(params, kv, ids, pos, mask, slot_index, offset):
        return slot(params, args, kv, ids, pos, mask, slot_index, offset, **extra)

    return batched_fwd, slot_fwd
