"""Gemma2 forward and checkpoint loading.

Counterpart of `umbrella_tpu/models/gemma.py`. The deltas from the llama
family: four RMS norms a layer with (1 + w) scaling, the embedding scaled by
sqrt(hidden_size) rounded to the hidden dtype (HF does the same: in bf16
sqrt(3584) = 59.866 becomes 59.75), attention logits soft-capped inside the
attention kernel and final logits soft-capped in fp32 after the head, a
sliding window on even layers, a gelu-tanh MLP, and HF's
`query_pre_attn_scalar ** -0.5` attention scale (not head_dim ** -0.5).

The sliding window is expressed in slot space, as in the JAX package: a row
at position p may read cache slot c when c > p - window (committed slot ==
position; tree offsets are below the window). Linear weights are stacked
[n_layers, in, out] tensors; the dense products go through llama._linear.
The tensor-parallel form (the JAX package's `tp_axis`, batched engine only)
is parallel/mesh.tp_batched_forwards.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.norms import gemma_rms_norm
from ..ops.rope import rope_params
from ..ops.select import embed_lookup
from .kv_cache import KVCache
from .llama import _linear, cache_attend_fn, kv_limit_of, row_product


class GemmaStaticArgs(NamedTuple):
    num_heads: int
    num_kv_heads: int
    head_dim: int
    hidden_size: int
    rms_eps: float
    n_layers: int
    attn_scale: float
    attn_softcap: float
    final_softcap: float
    sliding_window: int

    @classmethod
    def from_config(cls, cfg: ModelConfig, n_layers: Optional[int] = None) -> "GemmaStaticArgs":
        qpas = cfg.query_pre_attn_scalar or cfg.resolved_head_dim
        return cls(
            num_heads=cfg.num_attention_heads,
            num_kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.resolved_head_dim,
            hidden_size=cfg.hidden_size,
            rms_eps=cfg.rms_norm_eps,
            n_layers=n_layers if n_layers is not None else cfg.num_hidden_layers,
            attn_scale=float(qpas) ** -0.5,
            attn_softcap=float(cfg.attn_logit_softcapping or 0.0),
            final_softcap=float(cfg.final_logit_softcapping or 0.0),
            sliding_window=int(cfg.sliding_window or 0),
        )


def is_sliding(layer_idx: int) -> bool:
    """Even layers attend through the sliding window."""
    return layer_idx % 2 == 0


def sliding_mask(attn_mask: torch.Tensor, position_ids: torch.Tensor, window: int) -> torch.Tensor:
    """attn_mask [..., S, L] restricted to slots c > position - window
    (position_ids [..., S])."""
    cols = torch.arange(attn_mask.shape[-1], device=attn_mask.device)
    return attn_mask & (cols > position_ids[..., None] - max(window, 1))


def embed_scaled(params: dict, args: GemmaStaticArgs, input_ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows [N, H] times sqrt(hidden_size), the factor rounded to
    the hidden dtype first."""
    hidden = embed_lookup(params["embed"], input_ids, params["final_norm"].dtype)
    return hidden * torch.tensor(args.hidden_size ** 0.5, dtype=hidden.dtype)


def gemma2_block(args: GemmaStaticArgs, lw: dict, hidden: torch.Tensor, attend_fn,
                 row=None) -> torch.Tensor:
    """One decoder layer on hidden [N, H]; `attend_fn(q, k, v)` (each [N, heads
    * D]) writes the layer's KV and returns attention [N, heads * D]; `row`
    computes the two row products (default llama.row_product's), each summed
    before its post norm."""
    eps = args.rms_eps
    row = row or row_product(lw, attend_fn)
    x = gemma_rms_norm(hidden, lw["input_norm"], eps)
    attn = row(x, lambda lw, x, attend: attend(_linear(x, lw["wq"]), _linear(x, lw["wk"]),
                                               _linear(x, lw["wv"])), "wo")
    hidden = hidden + gemma_rms_norm(attn, lw["post_attn_norm"], eps)
    x = gemma_rms_norm(hidden, lw["pre_ff_norm"], eps)
    mlp = row(x, lambda lw, x, attend: F.gelu(_linear(x, lw["gate"]), approximate="tanh")
              * _linear(x, lw["up"]), "down")
    return hidden + gemma_rms_norm(mlp, lw["post_ff_norm"], eps)


def gemma_logits(params: dict, args: GemmaStaticArgs, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm, the tied (embed.T) or dense head in fp32, then the final soft cap."""
    hidden = gemma_rms_norm(hidden, params["final_norm"], args.rms_eps)
    head = params.get("lm_head")
    if head is None:
        logits = hidden.float() @ params["embed"].float().T
    else:
        logits = hidden.float() @ head.float()
    if args.final_softcap > 0:
        logits = args.final_softcap * torch.tanh(logits / args.final_softcap)
    return logits


def gemma2_forward(params: dict, args: GemmaStaticArgs, kv: KVCache,
                   input_ids: torch.Tensor,  # [S]
                   position_ids: torch.Tensor,  # [S]
                   attn_mask: torch.Tensor,  # [S, L] bool
                   write_offset) -> Tuple[torch.Tensor, KVCache]:
    """Full forward; returns (fp32 logits [S, V], kv updated in place).
    `write_offset` is a host int or a 0-d device tensor (no host read)."""
    kv_limit = kv_limit_of(write_offset, input_ids.shape[0], kv)
    masks = (attn_mask, sliding_mask(attn_mask, position_ids, args.sliding_window))
    hidden = embed_scaled(params, args, input_ids)
    for i in range(args.n_layers):
        attend_fn = cache_attend_fn(args, kv, i, position_ids, masks[is_sliding(i)],
                                    write_offset, params["rope_inv_freq"], params["rope_scale"],
                                    kv_limit, scale=args.attn_scale, soft_cap=args.attn_softcap)
        lw = {k: v[i] for k, v in params["layers"].items()}
        hidden = gemma2_block(args, lw, hidden, attend_fn)
    return gemma_logits(params, args, hidden), kv


def gemma_params_from_hf_state_dict(sd, cfg: ModelConfig, max_length: int,
                                    dtype=torch.bfloat16, n_layers: Optional[int] = None,
                                    device="cpu") -> dict:
    """The Gemma2 param tree from HF tensors (a SafetensorsReader or a dict of
    tensors or numpy arrays), built on `device`."""
    from .weights import fetch, stack_layers

    n = n_layers if n_layers is not None else cfg.num_hidden_layers
    P = "model.layers.{}."

    def get(name):
        return fetch(sd, name, device, torch.float32).to(dtype)

    def linear(name):
        return stack_layers(n, lambda i: get((P + name).format(i)).T)

    def vec(name):
        return stack_layers(n, lambda i: get((P + name).format(i)))

    layers = {
        "input_norm": vec("input_layernorm.weight"),
        "post_attn_norm": vec("post_attention_layernorm.weight"),
        "pre_ff_norm": vec("pre_feedforward_layernorm.weight"),
        "post_ff_norm": vec("post_feedforward_layernorm.weight"),
        "wq": linear("self_attn.q_proj.weight"),
        "wk": linear("self_attn.k_proj.weight"),
        "wv": linear("self_attn.v_proj.weight"),
        "wo": linear("self_attn.o_proj.weight"),
        "gate": linear("mlp.gate_proj.weight"),
        "up": linear("mlp.up_proj.weight"),
        "down": linear("mlp.down_proj.weight"),
    }
    params = {
        "embed": get("model.embed_tokens.weight").contiguous(),
        "final_norm": get("model.norm.weight"),
        "layers": layers,
        **rope_params(cfg, device=device),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = get("lm_head.weight").T.contiguous()
    return params


def load_gemma_params(path: str, cfg: ModelConfig, max_length: int, dtype=torch.bfloat16,
                      n_layers: Optional[int] = None, device="cpu") -> dict:
    """The Gemma2 param tree from an HF checkpoint directory."""
    from .weights import read_state_dict

    with read_state_dict(path) as sd:
        return gemma_params_from_hf_state_dict(sd, cfg, max_length, dtype, n_layers=n_layers,
                                               device=device)
