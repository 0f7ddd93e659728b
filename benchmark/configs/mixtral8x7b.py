"""Builder of `mixtral8x7b.json`: a bf16 Mixtral target (stacked experts, the
port's MoE layout) and its bf16 Mistral-7B draft, made on the card from the
seed and handed to the port as its param trees; the reference reads the
same tensors. Its parts (`attention`, `target`, `draft`, `reference`) also
build `mixtral8x7b_ep4.json`, whose experts lie on other cards."""
from __future__ import annotations

import types

import torch

from benchmark.reference import Linear


def _normal(gen, dev, shape, std):
    """bf16 N(0, std) of `shape`, drawn a leading index at a time (the fp32
    draw of a whole expert stack would not fit beside the model)."""
    out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=gen, device=dev) * std
    return out


def _glorot(gen, dev, shape):
    return _normal(gen, dev, shape, (2.0 / (shape[-2] + shape[-1])) ** 0.5)


def attention(cfg: dict, gen, device) -> dict:
    """The stacked layers' norms, attention products and router, drawn from
    `gen` on `device` (the layer keys before the experts')."""
    n, H, E = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["num_local_experts"]
    D = H // cfg["num_attention_heads"]
    Hq, KV = cfg["num_attention_heads"] * D, cfg["num_key_value_heads"] * D
    ones = torch.ones((n, H), dtype=torch.bfloat16, device=device)
    return {"input_norm": ones, "post_norm": ones.clone(),
            "wq": _glorot(gen, device, (n, H, Hq)), "wk": _glorot(gen, device, (n, H, KV)),
            "wv": _glorot(gen, device, (n, H, KV)), "wo": _glorot(gen, device, (n, Hq, H)),
            "router": _glorot(gen, device, (n, H, E))}


def target(cfg: dict, gen, device, layers: dict, max_length: int):
    """(params, the port's MoE runtime): the embedding and head drawn from
    `gen` after the layers, over `layers` (experts stacked or sharded)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.moe import moe_runtime
    from umbrella_tpu_torch.ops.rope import rope_params

    H, V = cfg["hidden_size"], cfg["vocab_size"]
    mcfg = ModelConfig.from_dict({k: v for k, v in cfg.items() if k not in ("bench", "draft")})
    params = {"embed": _normal(gen, device, (V, H), cfg["bench"]["embed_std"]),
              "final_norm": torch.ones(H, dtype=torch.bfloat16, device=device),
              "layers": layers, "lm_head": _glorot(gen, device, (H, V)),
              **rope_params(mcfg, device=device)}
    return params, moe_runtime(mcfg, params, max_length, dtype=torch.bfloat16,
                               top_k=cfg["num_experts_per_tok"], device=device)


def draft(cfg: dict, gen, device, max_length: int):
    """The bf16 Mistral-7B draft runtime, N(0, draft_std), drawn from `gen`."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime
    from umbrella_tpu_torch.ops.rope import rope_params

    d = cfg["draft"]
    dn, dH, dI, dV = (d["num_hidden_layers"], d["hidden_size"], d["intermediate_size"],
                      d["vocab_size"])
    dD = d["head_dim"]
    dq, dkv = d["num_attention_heads"] * dD, d["num_key_value_heads"] * dD
    std = cfg["bench"]["draft_std"]
    dones = torch.ones((dn, dH), dtype=torch.bfloat16, device=device)
    dcfg = ModelConfig.from_dict({k: v for k, v in d.items() if k != "source"})
    dparams = {"embed": _normal(gen, device, (dV, dH), std),
               "final_norm": torch.ones(dH, dtype=torch.bfloat16, device=device),
               "layers": {"input_norm": dones, "post_norm": dones.clone(),
                          "wqkv": _normal(gen, device, (dn, dH, dq + 2 * dkv), std),
                          "wo": _normal(gen, device, (dn, dq, dH), std),
                          "gate_up": _normal(gen, device, (dn, dH, 2 * dI), std),
                          "down": _normal(gen, device, (dn, dI, dH), std)},
               "lm_head": _normal(gen, device, (dH, dV), std),
               **rope_params(dcfg, device=device)}
    return ModelRuntime(dcfg, dparams, max_length, dtype=torch.bfloat16, family="mistral",
                        device=device)


def reference(cfg: dict, params: dict, experts: list) -> dict:
    """The reference's view of the target's tensors; `experts[i]` is layer
    i's (gate, up, down)."""
    layers = params["layers"]
    ref_layers = [{"input_norm": layers["input_norm"][i], "post_norm": layers["post_norm"][i],
                   "qkv": Linear(dense=[layers["wq"][i], layers["wk"][i], layers["wv"][i]]),
                   "wo": Linear(dense=[layers["wo"][i]]), "router": layers["router"][i],
                   "experts": experts[i]}
                  for i in range(cfg["num_hidden_layers"])]
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "head": Linear(dense=[params["lm_head"]]), "layers": ref_layers,
            "heads": cfg["num_attention_heads"], "kv_heads": cfg["num_key_value_heads"],
            "head_dim": cfg["hidden_size"] // cfg["num_attention_heads"],
            "eps": cfg["rms_norm_eps"], "theta": cfg["rope_theta"],
            "top_k": cfg["num_experts_per_tok"]}


def build(cfg: dict, seed: int, device, max_length: int):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n, H, I, E = (cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"],
                  cfg["num_local_experts"])
    layers = attention(cfg, gen, device)
    layers.update(expert_gate=_glorot(gen, device, (n, E, H, I)),
                  expert_up=_glorot(gen, device, (n, E, H, I)),
                  expert_down=_glorot(gen, device, (n, E, I, H)))
    params, tgt = target(cfg, gen, device, layers, max_length)
    experts = [(layers["expert_gate"][i], layers["expert_up"][i], layers["expert_down"][i])
               for i in range(n)]
    return types.SimpleNamespace(target=tgt, draft=draft(cfg, gen, device, max_length),
                                 reference=reference(cfg, params, experts),
                                 vocab=cfg["vocab_size"])


def shapes(cfg: dict):
    """(target, draft) shapes for the work counts (no W4 products)."""
    from benchmark.roofline import Shapes

    return Shapes.from_config(cfg), Shapes.from_config(cfg["draft"])
