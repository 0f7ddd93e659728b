"""Llama-family forward (Llama 2/3.x, Qwen2.5 attention biases, Mistral head_dim).

Counterpart of `umbrella_tpu/models/llama.py`. Quantized layers are per-layer
tuples, so the forward is a plain Python loop over layers; dense layers are
stacked tensors indexed per layer. The KV cache is updated in place.

Param tree (all linear weights stored [in, out]):
  embed [V, H], lm_head [H, V] (absent => tied), final_norm [H],
  rope_inv_freq [D/2] fp32, rope_scale (float),
  layers: input_norm, post_norm [n, H]; wqkv [n, H, Hq+2KV] or wq/wk/wv;
          wo [n, Hq, H]; gate_up [n, H, 2I] or gate/up; down [n, I, H];
          optional bqkv or bq/bk/bv.
  Linear entries may instead be per-layer tuples of AwqTensor / Int4FTensor.
A staged (pipeline-parallel) model keeps each stage's AWQ entries as stacked
AwqTensors and hands a layer its weights as AwqLayerViews
(`split_scan_layers`, `view_scan_layer`; parallel/pipeline.py); the forward
below never does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.attention import attend
from ..ops.kernels.tree_attention import limit_tensor
from ..ops.masks import window_start
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_params
from ..ops.select import embed_lookup
from ..quantization.awq import AwqLayerView, AwqTensor, awq_gate_up_silu, awq_matmul
from ..quantization.int4f import Int4FTensor, int4f_matmul
from .kv_cache import KVCache, update_layer


class StaticModelArgs(NamedTuple):
    num_heads: int
    num_kv_heads: int
    head_dim: int
    hidden_size: int
    rms_eps: float
    n_layers: int
    awq_act_int8: bool = False  # W4A8 opt-in (ModelConfig.awq_act == "int8")

    @classmethod
    def from_config(cls, cfg: ModelConfig, n_layers: Optional[int] = None) -> "StaticModelArgs":
        return cls(
            num_heads=cfg.num_attention_heads,
            num_kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.resolved_head_dim,
            hidden_size=cfg.hidden_size,
            rms_eps=cfg.rms_norm_eps,
            n_layers=n_layers if n_layers is not None else cfg.num_hidden_layers,
            awq_act_int8=getattr(cfg, "awq_act", "bf16") == "int8",
        )


def _linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
            act_int8: bool = False) -> torch.Tensor:
    """Dense or quantized linear: w is a [in, out] tensor, an AwqTensor, an
    AwqLayerView (one layer of stacked W4 weights) or an Int4FTensor;
    `act_int8` routes AWQ weights through W4A8."""
    if isinstance(w, Int4FTensor):
        return int4f_matmul(x, w, b)
    if isinstance(w, (AwqTensor, AwqLayerView)):
        return awq_matmul(x, w, b, act_int8=act_int8)
    y = (x.float() @ w.float()).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def split_scan_layers(layers: dict):
    """Split a layer block into its stacked AwqTensor entries (kept whole, for
    the layered W4A16 kernel) and the rest (indexed per layer)."""
    awq = {k: v for k, v in layers.items() if isinstance(v, AwqTensor)}
    dense = {k: v for k, v in layers.items() if not isinstance(v, AwqTensor)}
    return awq, dense


def view_scan_layer(awq: dict, dense_sliced: dict, layer_idx: torch.Tensor) -> dict:
    """One layer's weights: the dense entries already indexed, and an
    AwqLayerView of each stacked AWQ entry at `layer_idx` (an int32 tensor)."""
    lw = dict(dense_sliced)
    for k, v in awq.items():
        lw[k] = AwqLayerView(v, layer_idx)
    return lw


def _attn_projections(args: StaticModelArgs, lw: dict, hidden):
    Hq = args.num_heads * args.head_dim
    KV = args.num_kv_heads * args.head_dim
    a8 = args.awq_act_int8
    if "wqkv" in lw:
        qkv = _linear(hidden, lw["wqkv"], lw.get("bqkv"), act_int8=a8)
        return qkv[..., :Hq], qkv[..., Hq:Hq + KV], qkv[..., Hq + KV:]
    return (_linear(hidden, lw["wq"], lw.get("bq"), act_int8=a8),
            _linear(hidden, lw["wk"], lw.get("bk"), act_int8=a8),
            _linear(hidden, lw["wv"], lw.get("bv"), act_int8=a8))


def _mlp_gate_up(lw: dict, hidden, act_int8: bool = False):
    if "gate_up" in lw:
        gu = _linear(hidden, lw["gate_up"], act_int8=act_int8)
        half = gu.shape[-1] // 2
        return gu[..., :half], gu[..., half:]
    return (_linear(hidden, lw["gate"], act_int8=act_int8),
            _linear(hidden, lw["up"], act_int8=act_int8))


def _mlp_act(lw: dict, hidden, act_int8: bool = False):
    """silu(gate) * up for the layer's MLP input projection. A packed AWQ
    gate_up goes through awq_gate_up_silu (composed by default), except under
    W4A8, which composes gate/up through W4A8 and then silu * mul."""
    gu = lw.get("gate_up")
    if isinstance(gu, AwqTensor) and not act_int8:
        return awq_gate_up_silu(hidden, gu)
    gate, up = _mlp_gate_up(lw, hidden, act_int8=act_int8)
    return F.silu(gate) * up


def kv_limit_of(write_offset, S: int, kv: KVCache) -> torch.Tensor:
    """int32 [1] on the cache's device: the slots a forward of S rows written
    at `write_offset` (a host int or a 0-d device tensor) may read, the
    clamped window's end. A device offset stays on the device."""
    start = window_start(write_offset, S, kv.k.shape[2])
    if isinstance(start, torch.Tensor):
        return (start + S).to(torch.int32).reshape(1)
    return limit_tensor(start + S, kv.k.device)


def cache_attend_fn(args, kv: KVCache, layer_idx: int, position_ids: torch.Tensor,
                    attn_mask: torch.Tensor, write_offset, inv_freq: torch.Tensor, rope_scale,
                    kv_limit: torch.Tensor, scale: Optional[float] = None,
                    soft_cap: float = 0.0):
    """attend_fn(q, k, v) of one layer over a single sequence's rows (each
    [S, heads * D], args' head counts): rope on q and k, the layer's KV
    write at `write_offset` (a host int or a 0-d device tensor), then
    attention bounded by `kv_limit` (kv_limit_of); returns [S, heads * D]."""
    S = position_ids.shape[0]
    H, KVH, D = args.num_heads, args.num_kv_heads, args.head_dim

    def attend_fn(q, k, v):
        q, k = apply_rope(q.reshape(S, H, D), k.reshape(S, KVH, D), inv_freq, rope_scale,
                          position_ids)
        update_layer(kv, layer_idx, k, v.reshape(S, KVH, D), write_offset)
        out = attend(q.contiguous(), kv.k, kv.v, attn_mask, kv_limit=kv_limit, scale=scale,
                     logits_soft_cap=soft_cap, layer_idx=layer_idx, k_scale=kv.k_scale,
                     v_scale=kv.v_scale)
        return out.reshape(S, H * D)

    return attend_fn


def llama_attention(args: StaticModelArgs, lw: dict, hidden: torch.Tensor, kv: KVCache,
                    layer_idx: int, position_ids: torch.Tensor, attn_mask: torch.Tensor,
                    write_offset, inv_freq: torch.Tensor, rope_scale,
                    kv_limit: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, KVCache]:
    """`write_offset` is a host int or a 0-d device tensor; `kv_limit`
    (kv_limit_of, computed here unless the forward passes its own) bounds the
    slots the flash kernel reads."""
    if kv_limit is None:
        kv_limit = kv_limit_of(write_offset, hidden.shape[0], kv)
    attend_fn = cache_attend_fn(args, kv, layer_idx, position_ids, attn_mask, write_offset,
                                inv_freq, rope_scale, kv_limit)
    out = attend_fn(*_attn_projections(args, lw, hidden))
    return _linear(out, lw["wo"], act_int8=args.awq_act_int8), kv


def row_product(lw: dict, attend_fn, act_int8: bool = False):
    """The layer bodies' default `row(x, inner, key)`: inner(lw, x, attend_fn)
    @ lw[key], a row product (wo, down) with what precedes it in the layer,
    over this layer's weights. The tensor-parallel forward passes its own
    (parallel/mesh.py): each shard runs `inner` over its weights and its
    attention, and the partials are summed."""
    def row(x, inner, key):
        return _linear(inner(lw, x, attend_fn), lw[key], act_int8=act_int8)

    return row


def llama_block(args: StaticModelArgs, lw: dict, hidden: torch.Tensor, attend_fn,
                act_int8: bool = False, row=None) -> torch.Tensor:
    """One llama-family decoder layer on hidden [N, H]; `attend_fn(q, k, v)`
    (each [N, heads * D]) writes the layer's KV and returns attention [N,
    heads * D]. `act_int8` reaches wo, the MLP and down (q/k/v follow args);
    `row` computes the two row products (default row_product's)."""
    row = row or row_product(lw, attend_fn, act_int8)
    x = rms_norm(hidden, lw["input_norm"], args.rms_eps)
    hidden = hidden + row(x, lambda lw, x, attend: attend(*_attn_projections(args, lw, x)), "wo")
    x = rms_norm(hidden, lw["post_norm"], args.rms_eps)
    return hidden + row(x, lambda lw, x, attend: _mlp_act(lw, x, act_int8), "down")


def llama_layer(args: StaticModelArgs, lw: dict, hidden: torch.Tensor, kv: KVCache,
                layer_idx: int, position_ids, attn_mask, write_offset, inv_freq,
                rope_scale, kv_limit: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    if kv_limit is None:
        kv_limit = kv_limit_of(write_offset, hidden.shape[0], kv)
    attend_fn = cache_attend_fn(args, kv, layer_idx, position_ids, attn_mask, write_offset,
                                inv_freq, rope_scale, kv_limit)
    return llama_block(args, lw, hidden, attend_fn, args.awq_act_int8), kv


def llama_forward(params: dict, args: StaticModelArgs, kv: KVCache,
                  input_ids: torch.Tensor,  # [S]
                  position_ids: torch.Tensor,  # [S]
                  attn_mask: torch.Tensor,  # [S, L] bool
                  write_offset) -> Tuple[torch.Tensor, KVCache]:
    """Full forward; returns (fp32 logits [S, V], kv updated in place).
    `write_offset` is a host int or a 0-d device tensor (no host read)."""
    layers = params["layers"]
    inv_freq, rope_scale = params["rope_inv_freq"], params["rope_scale"]
    kv_limit = kv_limit_of(write_offset, input_ids.shape[0], kv)
    hidden = embed_lookup(params["embed"], input_ids, params["final_norm"].dtype)
    for i in range(args.n_layers):
        lw = {k: v[i] for k, v in layers.items()}
        hidden, kv = llama_layer(args, lw, hidden, kv, i, position_ids, attn_mask,
                                 write_offset, inv_freq, rope_scale, kv_limit)
    hidden = rms_norm(hidden, params["final_norm"], args.rms_eps)
    return lm_head_logits(params, hidden), kv


def lm_head_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits: tied embedding, dense lm_head, W4 AWQ or Int4F lm_head."""
    lm_head = params.get("lm_head")
    if lm_head is None:
        logits = hidden.float() @ params["embed"].float().T
    elif isinstance(lm_head, Int4FTensor):
        logits = int4f_matmul(hidden, lm_head, out_dtype=torch.float32)
    elif isinstance(lm_head, AwqTensor):
        logits = awq_matmul(hidden, lm_head, out_dtype=torch.float32)
    else:
        logits = hidden.float() @ lm_head.float()
    return logits.float()


def init_llama_params(cfg: ModelConfig, generator: torch.Generator, max_length: int,
                      dtype=torch.bfloat16, n_layers: Optional[int] = None,
                      packed: bool = True, device="cpu") -> dict:
    """Random-init dense params (N(0, 0.02) weights, unit norms)."""
    n = n_layers if n_layers is not None else cfg.num_hidden_layers
    H, D = cfg.hidden_size, cfg.resolved_head_dim
    Hq = cfg.num_attention_heads * D
    KV = cfg.num_key_value_heads * D
    I, V = cfg.intermediate_size, cfg.vocab_size

    def w(shape, scale=0.02):
        return (torch.randn(shape, generator=generator, device=device) * scale).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "input_norm": torch.ones((n, H), dtype=dtype, device=device),
        "post_norm": torch.ones((n, H), dtype=dtype, device=device),
        "wo": w((n, Hq, H)),
        "down": w((n, I, H)),
    }
    if packed:
        layers["wqkv"] = w((n, H, Hq + 2 * KV))
        layers["gate_up"] = w((n, H, 2 * I))
        if cfg.attention_bias:
            layers["bqkv"] = zeros((n, Hq + 2 * KV))
    else:
        layers["wq"] = w((n, H, Hq))
        layers["wk"] = w((n, H, KV))
        layers["wv"] = w((n, H, KV))
        layers["gate"] = w((n, H, I))
        layers["up"] = w((n, H, I))
        if cfg.attention_bias:
            layers["bq"] = zeros((n, Hq))
            layers["bk"] = zeros((n, KV))
            layers["bv"] = zeros((n, KV))
    params = {
        "embed": w((V, H)),
        "final_norm": torch.ones((H,), dtype=dtype, device=device),
        "layers": layers,
        **rope_params(cfg, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((H, V))
    return params
