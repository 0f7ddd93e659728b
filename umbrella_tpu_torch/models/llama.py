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
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.attention import attend
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_params
from ..ops.select import embed_lookup
from ..quantization.awq import AwqTensor, awq_gate_up_silu, awq_matmul
from ..quantization.int4f import Int4FTensor, int4f_matmul
from .kv_cache import KVCache, update_layer


class StaticModelArgs(NamedTuple):
    num_heads: int
    num_kv_heads: int
    head_dim: int
    hidden_size: int
    rms_eps: float
    n_layers: int

    @classmethod
    def from_config(cls, cfg: ModelConfig, n_layers: Optional[int] = None) -> "StaticModelArgs":
        if getattr(cfg, "awq_act", "bf16") == "int8":
            raise NotImplementedError(
                "awq_act='int8' (W4A8) is not ported yet (ROADMAP queue B, kernel w4a8_matmul)")
        return cls(
            num_heads=cfg.num_attention_heads,
            num_kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.resolved_head_dim,
            hidden_size=cfg.hidden_size,
            rms_eps=cfg.rms_norm_eps,
            n_layers=n_layers if n_layers is not None else cfg.num_hidden_layers,
        )


def _linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense or quantized linear: w is a [in, out] tensor, an AwqTensor or an Int4FTensor."""
    if isinstance(w, Int4FTensor):
        return int4f_matmul(x, w, b)
    if isinstance(w, AwqTensor):
        return awq_matmul(x, w, b)
    y = (x.float() @ w.float()).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _attn_projections(args: StaticModelArgs, lw: dict, hidden):
    Hq = args.num_heads * args.head_dim
    KV = args.num_kv_heads * args.head_dim
    if "wqkv" in lw:
        qkv = _linear(hidden, lw["wqkv"], lw.get("bqkv"))
        return qkv[..., :Hq], qkv[..., Hq:Hq + KV], qkv[..., Hq + KV:]
    return (_linear(hidden, lw["wq"], lw.get("bq")),
            _linear(hidden, lw["wk"], lw.get("bk")),
            _linear(hidden, lw["wv"], lw.get("bv")))


def _mlp_gate_up(lw: dict, hidden):
    if "gate_up" in lw:
        gu = _linear(hidden, lw["gate_up"])
        half = gu.shape[-1] // 2
        return gu[..., :half], gu[..., half:]
    return _linear(hidden, lw["gate"]), _linear(hidden, lw["up"])


def _mlp_act(lw: dict, hidden):
    """silu(gate) * up for the layer's MLP input projection."""
    gu = lw.get("gate_up")
    if isinstance(gu, AwqTensor):
        return awq_gate_up_silu(hidden, gu)
    gate, up = _mlp_gate_up(lw, hidden)
    return F.silu(gate) * up


def llama_attention(args: StaticModelArgs, lw: dict, hidden: torch.Tensor, kv: KVCache,
                    layer_idx: int, position_ids: torch.Tensor, attn_mask: torch.Tensor,
                    write_offset: int, inv_freq: torch.Tensor,
                    rope_scale) -> Tuple[torch.Tensor, KVCache]:
    S = hidden.shape[0]
    D = args.head_dim
    q, k, v = _attn_projections(args, lw, hidden)
    q = q.reshape(S, args.num_heads, D)
    k = k.reshape(S, args.num_kv_heads, D)
    v = v.reshape(S, args.num_kv_heads, D)
    q, k = apply_rope(q, k, inv_freq, rope_scale, position_ids)
    kv = update_layer(kv, layer_idx, k, v, write_offset)
    out = attend(q.contiguous(), kv.k, kv.v, attn_mask, kv_limit=write_offset + S,
                 layer_idx=layer_idx)
    return _linear(out.reshape(S, args.num_heads * D), lw["wo"]), kv


def llama_layer(args: StaticModelArgs, lw: dict, hidden: torch.Tensor, kv: KVCache,
                layer_idx: int, position_ids, attn_mask, write_offset, inv_freq,
                rope_scale) -> Tuple[torch.Tensor, KVCache]:
    residual = hidden
    hidden = rms_norm(hidden, lw["input_norm"], args.rms_eps)
    attn_out, kv = llama_attention(args, lw, hidden, kv, layer_idx, position_ids, attn_mask,
                                   write_offset, inv_freq, rope_scale)
    hidden = residual + attn_out
    residual = hidden
    hidden = rms_norm(hidden, lw["post_norm"], args.rms_eps)
    hidden = _linear(_mlp_act(lw, hidden), lw["down"])
    return residual + hidden, kv


def llama_forward(params: dict, args: StaticModelArgs, kv: KVCache,
                  input_ids: torch.Tensor,  # [S]
                  position_ids: torch.Tensor,  # [S]
                  attn_mask: torch.Tensor,  # [S, L] bool
                  write_offset: int) -> Tuple[torch.Tensor, KVCache]:
    """Full forward; returns (fp32 logits [S, V], kv updated in place)."""
    layers = params["layers"]
    inv_freq, rope_scale = params["rope_inv_freq"], params["rope_scale"]
    hidden = embed_lookup(params["embed"], input_ids, params["final_norm"].dtype)
    for i in range(args.n_layers):
        lw = {k: v[i] for k, v in layers.items()}
        hidden, kv = llama_layer(args, lw, hidden, kv, i, position_ids, attn_mask,
                                 write_offset, inv_freq, rope_scale)
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
