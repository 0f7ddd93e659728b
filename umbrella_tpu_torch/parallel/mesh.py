"""Tensor parallelism: a llama-family or Gemma2 model's layers split
Megatron-style over a list of shard devices.

Counterpart of `umbrella_tpu/parallel/mesh.py`. The JAX package shards a
runtime over a device mesh with NamedShardings and runs its forward inside
`shard_map`, with a psum after `wo` and after `down` and an all-gather of the
vocab-sharded logits (`models/llama.py`'s `tp_axis`). Here one process drives
one device per shard, as the pipeline tier does (parallel/pipeline.py): a
device may repeat, so that one card, or the CPU, can hold every shard.

Layout (the JAX package's `llama_param_specs`):
  column  wq / wk / wv / gate / up [n, H, out], bq / bk / bv [n, out], and the
          vocab axis of an untied lm_head [H, V]: shard s holds out-columns
          [s * out / m, (s + 1) * out / m)
  row     wo [n, Hq, H], down [n, I, H]: shard s holds in-rows block s
  else    (the embedding, the norms, the rope tables) replicated: here on the
          first shard's device, which is the runtime's
  KV      one cache a shard over its num_kv_heads / m heads, on its device
          (models/kv_cache.ShardedKVCache)
AWQ entries (per-layer AwqTensor tuples: load with packed=False) shard the
same way on their logical axes: a column shard cuts w8 / scales / zeros on
N; a row shard is repacked first (quantization/awq.repack_row_shards, one
layer at a time, before the bytes move), so that each is a self-contained
AwqTensor over its K block, which needs whole quantization groups a shard.
Packed wqkv / gate_up are refused: their column shards would straddle the
sections.

The forward (`tp_forward`, and `tp_batched_forwards` for the batched
engine's all-slots and single-slot forms, Gemma2's included): the embedding
and each norm run on the first shard's device; each shard runs its column
products, its attention over its own cache (local head counts) and its row
product into an fp32 partial, on its device; `collectives.all_reduce` sums
the partials back on the first device, where the residual add is made
(Gemma2's batched form sums before its post norms, as the JAX package's
does). An untied head's vocab shards are gathered into the full row. A
single-slot Gemma2 forward raises NotImplementedError, as in the JAX
package.

The engines run the forward as one phase of their step (ModelRuntime.
forward_phases): captured in the step's CUDA graph where every shard is on
the runtime's card, run eagerly between the step's graphs where the shards
span cards (a layer crosses cards twice, which would cut a step into
hundreds of graphs) or processes.

Across processes (`shard_runtime(..., span=distributed.span())`, the JAX
package's `make_mesh(model=tp)` over the global device list): the model axis
is m = len(devices) x span.size shards, and process p holds shards
[p * len(devices), (p + 1) * len(devices)) on its own devices. Each process
runs the replicated parts (embedding, norms, head's gather, and its engine's
draft, tree and sampling) itself; the collectives gather every process's
partials over the group and add them in global shard order, so the logits
are the one-process forward's bits on every process.

Training (`shard_train_params`, `gather_train_params`): the dense, unpacked
train tree in the same layout, every shard entry a leaf that requires grad
on its device; training/draft_trainer.train_forward runs it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ..models.gemma import gemma2_block
from ..models.kv_cache import ShardedKVCache, init_kv_cache
from ..models.llama import cache_attend_fn, kv_limit_of, llama_block, lm_head_logits
from ..ops.norms import gemma_rms_norm, rms_norm
from ..ops.select import embed_lookup
from ..quantization.awq import AwqTensor, awq_matmul, repack_row_shards
from ..utils import device_scope
from .collectives import all_gather, all_reduce, broadcast

COL_KEYS = ("wq", "wk", "wv", "gate", "up")
ROW_KEYS = ("wo", "down")
BIAS_KEYS = ("bq", "bk", "bv")


class TPShard(NamedTuple):
    """One shard of a tensor-parallel model, all on `device`."""
    device: torch.device
    layers: dict  # column / row / bias entries: dense [n, ...] or per-layer AwqTensor tuples
    lm_head: Optional[object]  # an untied head's vocab columns [H, V / m], else None
    inv_freq: torch.Tensor  # the rope frequencies


def _awq_layers(v) -> bool:
    return isinstance(v, tuple) and bool(v) and isinstance(v[0], AwqTensor)


def _check_shardable(runtime, m: int) -> None:
    """The JAX package's assertions (heads and kv heads divisible by m, whole
    quantization groups a row shard) and what its layout presumes, as
    ValueErrors."""
    if runtime.family == "moe":
        raise ValueError("an MoE model shards its experts (expert_parallel), not its tensors")
    if runtime.stage_devices is not None or runtime.shard_devices is not None:
        raise ValueError("runtime is already staged or sharded")
    layers, cfg = runtime.params["layers"], runtime.cfg
    if "wqkv" in layers or "gate_up" in layers:
        raise ValueError("packed (wqkv/gate_up) params cannot be tensor-sharded: column shards "
                         "would straddle section boundaries; load with packed=False for TP")
    if cfg.num_attention_heads % m:
        raise ValueError(f"num_attention_heads={cfg.num_attention_heads} must be divisible by "
                         f"tensor_parallel={m}")
    if cfg.num_key_value_heads % m:
        raise ValueError(f"num_key_value_heads={cfg.num_key_value_heads} must be divisible by "
                         f"tensor_parallel={m}")
    for k, v in layers.items():
        if isinstance(v, tuple) and not _awq_layers(v):
            raise ValueError(f"layer entry {k!r}: tensor parallelism takes dense and AWQ layers")
        if k in COL_KEYS + BIAS_KEYS:
            n_out = v[0].n if _awq_layers(v) else v.shape[-1]
            if n_out % m:
                raise ValueError(f"{k}: {n_out} output columns must be divisible by "
                                 f"tensor_parallel={m}")
        if k in ROW_KEYS and _awq_layers(v) and v[0].scales.shape[-2] % m:
            raise ValueError(f"row-parallel {k}: quant-group count ({v[0].scales.shape[-2]}) "
                             f"must be divisible by tensor_parallel={m} so every shard holds "
                             "whole groups")
    head = runtime.params.get("lm_head")
    if head is not None:
        if not isinstance(head, (AwqTensor, torch.Tensor)):
            raise ValueError(f"a {type(head).__name__} lm_head cannot be vocab-sharded")
        n_out = head.n if isinstance(head, AwqTensor) else head.shape[-1]
        if n_out % m:
            raise ValueError(f"lm_head: vocabulary {n_out} must be divisible by "
                             f"tensor_parallel={m}")


def _column(v, m: int, s: int):
    """Shard s of m of an entry's output columns (the last axis)."""
    if isinstance(v, AwqTensor):
        return AwqTensor(*(t[..., s * t.shape[-1] // m:(s + 1) * t.shape[-1] // m] for t in v))
    return v[..., s * v.shape[-1] // m:(s + 1) * v.shape[-1] // m]


def _rows(v, m: int, s: int):
    """Shard s of m of a row-parallel entry's input rows: a dense [n, in, H]
    stack's block of `in`, or a repacked AwqTensor's w8 row block and group
    block."""
    if isinstance(v, AwqTensor):
        return AwqTensor(*(t[s * t.shape[-2] // m:(s + 1) * t.shape[-2] // m] for t in v))
    return v[:, s * v.shape[1] // m:(s + 1) * v.shape[1] // m]


def _piece(key: str, v, m: int, s: int, device):
    piece = _rows(v, m, s) if key in ROW_KEYS else _column(v, m, s)
    if isinstance(piece, AwqTensor):
        return AwqTensor(*(t.contiguous().to(device) for t in piece))
    return piece.contiguous().to(device)


def _replicate(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return type(x)(*(_replicate(t, device) for t in x)) if hasattr(x, "_fields") \
            else tuple(_replicate(t, device) for t in x)
    if isinstance(x, dict):
        return {k: _replicate(v, device) for k, v in x.items()}
    return x


def shard_runtime(runtime, devices: Sequence, span=None):
    """Shard a llama-family or Gemma2 ModelRuntime in place over `devices`, one
    shard per entry (a device may repeat); returns the runtime. With a `span`
    (distributed.ProcessSpan) the shards are this process's block of
    len(devices) x span.size, and params["tp_span"] holds the span.

    Sharding refuses what the layout cannot split (see _check_shardable). AWQ entries
    are cut one layer at a time (row entries repacked first) and each
    per-layer tensor is released as it is cut, so sharding needs one layer's
    entry in extra memory when nothing else holds the runtime's tensors.
    Afterwards params["tp_shards"] holds the shards, params["layers"] the
    replicated entries, `forward` is the sharded forward and `init_kv` gives a
    ShardedKVCache."""
    devices = [torch.device(d) for d in devices]
    first = 0 if span is None else span.rank * len(devices)
    m = len(devices) * (1 if span is None else span.size)
    _check_shardable(runtime, m)
    params = dict(runtime.params)
    runtime.params = params
    layers = dict(params.pop("layers"))
    pieces = [dict() for _ in devices]
    for k in [k for k in layers if k in COL_KEYS + ROW_KEYS + BIAS_KEYS]:
        v = layers.pop(k)
        if not _awq_layers(v):
            for s, dev in enumerate(devices):
                pieces[s][k] = _piece(k, v, m, first + s, dev)
            continue
        # one layer at a time, each released as it is cut (a list, so no
        # loop variable keeps a tensor alive)
        pending, cut = list(v), [[] for _ in devices]
        del v
        for i in range(len(pending)):
            q = repack_row_shards(pending[i], m) if k in ROW_KEYS else pending[i]
            pending[i] = None
            for s, dev in enumerate(devices):
                cut[s].append(_piece(k, q, m, first + s, dev))
            del q
        for s in range(len(devices)):
            pieces[s][k] = tuple(cut[s])
    head = params.pop("lm_head", None)
    heads = [None if head is None else _piece("lm_head", head, m, first + s, dev)
             for s, dev in enumerate(devices)]
    del head
    shards = tuple(TPShard(dev, pieces[s], heads[s], params["rope_inv_freq"].to(dev))
                   for s, dev in enumerate(devices))
    runtime.params = dict(_replicate(dict(params, layers=layers), devices[0]), tp_shards=shards)
    if span is not None:
        runtime.params["tp_span"] = span
    runtime.device = devices[0]
    return runtime


def tp_degree(params: dict) -> int:
    """The model axis's shard count: this process's shards x the processes
    the axis spans."""
    span = params.get("tp_span")
    return len(params["tp_shards"]) * (1 if span is None else span.size)


def shard_train_params(params: dict, devices: Sequence) -> dict:
    """The dense, unpacked train tree (init_llama_params(packed=False), the
    JAX package's `shard_params` over a model axis) split over `devices`:
    new leaves, each requiring grad where its source did. The embedding, the
    norms and the rope entries stay whole on devices[0]; under "tp_shards",
    shard s holds its column, row and bias blocks of every layer (and of an
    untied lm_head) on devices[s]."""
    devices = [torch.device(d) for d in devices]
    m = len(devices)
    layers = params["layers"]
    if "wqkv" in layers or "gate_up" in layers:
        raise ValueError("packed (wqkv/gate_up) params cannot be tensor-sharded: column shards "
                         "would straddle section boundaries; initialise with packed=False")

    from ..training.draft_trainer import new_leaf

    def cut(key, v, s):
        n_out = v.shape[1] if key in ROW_KEYS else v.shape[-1]
        if n_out % m:
            raise ValueError(f"{key}: {n_out} must be divisible by the model axis {m}")
        return new_leaf(_rows(v, m, s) if key in ROW_KEYS else _column(v, m, s), devices[s])

    sharded_keys = [k for k in layers if k in COL_KEYS + ROW_KEYS + BIAS_KEYS]
    out = {k: new_leaf(v, devices[0]) if isinstance(v, torch.Tensor) else v
           for k, v in params.items() if k not in ("layers", "lm_head")}
    out["layers"] = {k: new_leaf(v, devices[0]) for k, v in layers.items()
                     if k not in sharded_keys}
    shards = []
    for s in range(m):
        shard = {"layers": {k: cut(k, layers[k], s) for k in sharded_keys}}
        if "lm_head" in params:
            shard["lm_head"] = cut("lm_head", params["lm_head"], s)
        shards.append(shard)
    out["tp_shards"] = tuple(shards)
    return out


def gather_train_params(sharded: dict, fn=lambda t: t.detach()) -> dict:
    """The unsharded tree of `fn` of each leaf of a shard_train_params tree
    (default: the values; `lambda t: t.grad` gives the gradients), on the
    replicated entries' device: the inverse of shard_train_params."""
    dev0 = sharded["embed"].device
    shards = sharded["tp_shards"]
    out = {k: (fn(v) if isinstance(v, torch.Tensor) else v)
           for k, v in sharded.items() if k not in ("layers", "tp_shards")}
    layers = {k: fn(v) for k, v in sharded["layers"].items()}
    for k in shards[0]["layers"]:
        layers[k] = torch.cat([fn(sh["layers"][k]).to(dev0) for sh in shards],
                              dim=1 if k in ROW_KEYS else -1)
    out["layers"] = layers
    if "lm_head" in shards[0]:
        out["lm_head"] = torch.cat([fn(sh["lm_head"]).to(dev0) for sh in shards], dim=-1)
    return out


def local_args(args, m: int):
    """The static args of one shard: head counts divided by m."""
    return args._replace(num_heads=args.num_heads // m, num_kv_heads=args.num_kv_heads // m)


def _local_config(cfg, m: int):
    """The config of one shard's cache: num_key_value_heads / m heads of the
    model's head dim."""
    return dataclasses.replace(cfg, num_key_value_heads=cfg.num_key_value_heads // m,
                               head_dim=cfg.resolved_head_dim)


def init_sharded_kv(runtime, kv_dtype=None) -> ShardedKVCache:
    """One KVCache a shard, over every layer and the shard's kv heads, on its device."""
    shards = runtime.params["tp_shards"]
    cfg = _local_config(runtime.cfg, tp_degree(runtime.params))
    return ShardedKVCache(tuple(
        init_kv_cache(cfg, runtime.max_length, dtype=kv_dtype or runtime.dtype,
                      num_layers=runtime.args.n_layers, device=sh.device) for sh in shards))


def init_sharded_batched_kv(runtime, batch: int, max_length: int, dtype) -> ShardedKVCache:
    """The batched engine's cache of a sharded target: one BatchedKVCache a
    shard over its kv heads (the JAX package's `batched_kv_specs`: the slot
    axis unsharded), on its device."""
    from ..models.batched import init_batched_kv

    shards = runtime.params["tp_shards"]
    cfg = _local_config(runtime.cfg, tp_degree(runtime.params))
    return ShardedKVCache(tuple(
        init_batched_kv(cfg, batch, max_length, dtype, num_layers=runtime.args.n_layers,
                        device=sh.device) for sh in shards))


# ------------------------------------------------------------------ the forward


def _partial(x: torch.Tensor, w, act_int8: bool = False) -> torch.Tensor:
    """A row shard's product x @ w in fp32: the partial that all_reduce sums
    and rounds once."""
    if isinstance(w, AwqTensor):
        return awq_matmul(x, w, out_dtype=torch.float32, act_int8=act_int8)
    return x.float() @ w.float()


def _tp_row(shards, lws: list, attend_fns: list, act_int8: bool, span=None):
    """The layer bodies' `row(x, inner, key)` over the shards: each shard
    runs inner(lw_s, x, attend_s) -- its column products and, for wo, its
    attention -- and its row product lw_s[key] into an fp32 partial, on its
    device; all_reduce sums the partials on x's device."""
    devices = [sh.device for sh in shards]

    def row(x, inner, key):
        parts = []
        for sh, lw, attend, xs in zip(shards, lws, attend_fns, broadcast(x, devices)):
            with device_scope(sh.device):
                parts.append(_partial(inner(lw, xs, attend), lw[key], act_int8))
        return all_reduce(parts, x.device, x.dtype, span)

    return row


def _tp_layers(gemma: bool, params: dict, largs, hidden, attend_fns_of, act_int8: bool):
    """The decoder layers over the shards; attend_fns_of(i)[s] is shard s's
    attention of layer i (its KV written). `act_int8` reaches wo, the MLP
    and down (the single-slot forward's W4A8); q/k/v follow largs, as
    unsharded."""
    shards = params["tp_shards"]
    for i in range(largs.n_layers):
        lw0 = {k: v[i] for k, v in params["layers"].items()}
        lws = [{k: v[i] for k, v in sh.layers.items()} for sh in shards]
        row = _tp_row(shards, lws, attend_fns_of(i), act_int8, params.get("tp_span"))
        hidden = (gemma2_block(largs, lw0, hidden, None, row=row) if gemma
                  else llama_block(largs, lw0, hidden, None, act_int8, row=row))
    return hidden


def tp_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the normed hidden state: a tied head against the
    replicated embedding, an untied one a vocab shard on each shard's device
    (each upcast there), gathered into the full row."""
    shards = params["tp_shards"]
    if shards[0].lm_head is None:
        return lm_head_logits(params, hidden)
    parts = []
    for sh, x in zip(shards, broadcast(hidden, [sh.device for sh in shards])):
        with device_scope(sh.device):
            parts.append(lm_head_logits({"lm_head": sh.lm_head}, x))
    return all_gather(parts, hidden.device, params.get("tp_span"))


def _tp_head(gemma: bool, params: dict, args, hidden: torch.Tensor) -> torch.Tensor:
    norm = gemma_rms_norm if gemma else rms_norm
    logits = tp_logits(params, norm(hidden, params["final_norm"], args.rms_eps))
    if gemma and args.final_softcap > 0:
        logits = args.final_softcap * torch.tanh(logits / args.final_softcap)
    return logits


def _on_shards(params: dict, masks=(), **values) -> list:
    """Each shard's copy of the step's inputs, one dict a shard; `masks` (a
    tuple) is copied as "masks"."""
    devices = [sh.device for sh in params["tp_shards"]]
    copies = {k: broadcast(v, devices) for k, v in values.items()}
    mask_copies = [broadcast(m, devices) for m in masks]
    return [dict({k: c[s] for k, c in copies.items()}, masks=tuple(c[s] for c in mask_copies))
            for s in range(len(devices))]


def tp_forward(runtime):
    """The engine-contract forward (params, kv, ids, pos, mask, off) -> (fp32
    logits, kv) of a tensor-parallel llama-family runtime (`tp_shard_map_forward`
    of the JAX package); `kv` is its ShardedKVCache, written in place."""
    if runtime.family == "gemma2":
        raise NotImplementedError(
            "single-slot TP gemma2 is not wired (the batched engine's tp_batched_forwards "
            "covers gemma2; use engine 'batched_static' with tensor_parallel for a TP gemma2 "
            "deployment)")
    args = runtime.args
    largs = local_args(args, tp_degree(runtime.params))

    def fwd(params, kv, input_ids, position_ids, attn_mask, write_offset):
        S = input_ids.shape[0]
        shards = params["tp_shards"]
        ins = _on_shards(params, pos=position_ids, mask=attn_mask, nn=write_offset)
        limits = [kv_limit_of(inp["nn"], S, c) for inp, c in zip(ins, kv.shards)]

        def attend_fns(i):
            return [cache_attend_fn(largs, c, i, inp["pos"], inp["mask"], inp["nn"], sh.inv_freq,
                                    params["rope_scale"], lim)
                    for sh, c, inp, lim in zip(shards, kv.shards, ins, limits)]

        hidden = embed_lookup(params["embed"], input_ids, params["final_norm"].dtype)
        hidden = _tp_layers(False, params, largs, hidden, attend_fns, args.awq_act_int8)
        return _tp_head(False, params, args, hidden), kv

    return fwd


def tp_batched_forwards(runtime):
    """(batched_fwd, slot_fwd) of a tensor-parallel llama-family or Gemma2
    runtime, with models/batched.model_forwards' signatures: the JAX
    package's `tp_batched_forwards`. `kv` is the engine's ShardedKVCache of
    BatchedKVCaches. As unsharded, `awq_act="int8"` reaches only q/k/v."""
    from ..models.batched import _attend_all_slots, _attend_one_slot, _slot_limits
    from ..models.gemma import embed_scaled, is_sliding, sliding_mask

    gemma = runtime.family == "gemma2"
    args = runtime.gemma_args if gemma else runtime.args
    largs = local_args(args, tp_degree(runtime.params))
    attn_kw = dict(scale=args.attn_scale, soft_cap=args.attn_softcap) if gemma else {}

    def masks_of(mask, pos):
        """Gemma2's full and sliding masks, or the one mask."""
        return (mask, sliding_mask(mask, pos, args.sliding_window)) if gemma else (mask,)

    def embed(params, ids):
        if gemma:
            return embed_scaled(params, args, ids)
        return embed_lookup(params["embed"], ids, params["final_norm"].dtype)

    def rope(params, sh):
        return {"rope_inv_freq": sh.inv_freq, "rope_scale": params["rope_scale"]}

    def layer_mask(ins, i):
        return ins["masks"][is_sliding(i) if gemma else 0]

    def batched_fwd(params, kv, input_ids, position_ids, attn_mask, write_offsets):
        B, S = input_ids.shape
        shards = params["tp_shards"]
        ins = _on_shards(params, masks_of(attn_mask, position_ids), pos=position_ids,
                         off=write_offsets)
        for inp in ins:
            inp["lim"] = (inp["off"] + S).to(torch.int32)

        def attend_fns(i):
            return [_attend_all_slots(largs, rope(params, sh), c, i, inp["pos"],
                                      layer_mask(inp, i), inp["off"], inp["lim"], **attn_kw)
                    for sh, c, inp in zip(shards, kv.shards, ins)]

        hidden = _tp_layers(gemma, params, largs, embed(params, input_ids.reshape(-1)),
                            attend_fns, False)
        return _tp_head(gemma, params, args, hidden).reshape(B, S, -1), kv

    def slot_fwd(params, kv, input_ids, position_ids, attn_mask, slot, write_offset):
        shards = params["tp_shards"]
        ins = _on_shards(params, masks_of(attn_mask, position_ids), pos=position_ids)
        for inp in ins:
            inp["lim"] = _slot_limits(inp["pos"], slot, write_offset)

        def attend_fns(i):
            return [_attend_one_slot(largs, rope(params, sh), c, i, inp["pos"],
                                     layer_mask(inp, i), slot, write_offset, inp["lim"],
                                     **attn_kw)
                    for sh, c, inp in zip(shards, kv.shards, ins)]

        hidden = _tp_layers(gemma, params, largs, embed(params, input_ids), attend_fns, False)
        return _tp_head(gemma, params, args, hidden), kv

    return batched_fwd, slot_fwd
