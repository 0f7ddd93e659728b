"""Builder of `mistral7b_awq.json`: the AutoAWQ tensors of Mistral-7B made on
the card from the seed, handed to the port through its AutoAWQ state-dict
reader, and composed as the flagship: the first `exit_layer` layers and the
W4 head converted to Int4F by the port, and an early-exit draft of them.
The same tensors go to the reference (`reference_model`)."""
from __future__ import annotations

import types

import torch

from benchmark.reference import Linear

PROJ = (("self_attn", "q_proj"), ("self_attn", "k_proj"), ("self_attn", "v_proj"),
        ("self_attn", "o_proj"), ("mlp", "gate_proj"), ("mlp", "up_proj"), ("mlp", "down_proj"))


def _awq(gen, dev, K, N, g, scale, sigma):
    """Random AutoAWQ GEMM tensors of a [K, N] product: int32 words of eight
    uniform codes, zero points 7 or 8, fp16 scales scale x exp(sigma N(0,1))."""
    words = torch.randint(-2 ** 31, 2 ** 31, (K, N // 8), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    zeros = 7 + torch.randint(0, 2, (K // g, N // 8, 8), generator=gen, device=dev,
                              dtype=torch.int64)
    zwords = (zeros << (4 * torch.arange(8, device=dev))).sum(-1)
    zwords = torch.where(zwords >= 2 ** 31, zwords - 2 ** 32, zwords).to(torch.int32)
    scales = (scale * torch.exp(sigma * torch.randn((K // g, N), generator=gen, device=dev))
              ).to(torch.float16)
    return words, zwords, scales


def shapes_of(cfg: dict):
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    D = cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * D, cfg["num_key_value_heads"] * D
    return {"q_proj": (H, q), "k_proj": (H, kv), "v_proj": (H, kv), "o_proj": (q, H),
            "gate_proj": (H, I), "up_proj": (H, I), "down_proj": (I, H)}


def build(cfg: dict, seed: int, device, max_length: int):
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime, early_exit_runtime
    from umbrella_tpu_torch.quantization.awq import awq_from_hf_tensors
    from umbrella_tpu_torch.quantization.int4f import hybridize_shared_prefix
    from umbrella_tpu_torch.quantization.loader import awq_params_from_hf_state_dict

    b = cfg["bench"]
    g, n, exit_layer = b["group_size"], cfg["num_hidden_layers"], b["exit_layer"]
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = shapes_of(cfg)
    sd = {"model.embed_tokens.weight": (torch.randn((V, H), generator=gen, device=device)
                                        * b["embed_std"]).to(torch.bfloat16),
          "model.norm.weight": torch.ones(H, dtype=torch.bfloat16, device=device)}
    layers = []
    for i in range(n):
        p = f"model.layers.{i}."
        lw = {}
        for part, name in PROJ:
            damp = b["tail_damp"] if i >= exit_layer and name in ("o_proj", "down_proj") else 1.0
            t = _awq(gen, device, *shapes[name], g, b["scale_base"] * damp, b["scale_sigma"])
            for key, v in zip(("qweight", "qzeros", "scales"), t):
                sd[f"{p}{part}.{name}.{key}"] = v
            lw[name] = t
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[p + norm + ".weight"] = torch.ones(H, dtype=torch.bfloat16, device=device)
        kw = dict(int4f=i < exit_layer, scale_dtype=torch.bfloat16)
        layers.append({"input_norm": sd[p + "input_layernorm.weight"],
                       "post_norm": sd[p + "post_attention_layernorm.weight"],
                       "qkv": Linear(awq=[lw["q_proj"], lw["k_proj"], lw["v_proj"]], **kw),
                       "wo": Linear(awq=[lw["o_proj"]], **kw),
                       "gate_up": Linear(awq=[lw["gate_proj"], lw["up_proj"]], **kw),
                       "down": Linear(awq=[lw["down_proj"]], **kw)})
    head = _awq(gen, device, H, V, g, b["scale_base"], b["scale_sigma"])

    mcfg = ModelConfig.from_dict({k: v for k, v in cfg.items() if k != "bench"})
    params = awq_params_from_hf_state_dict(sd, mcfg, max_length, torch.bfloat16, device=device)
    params["lm_head"] = awq_from_hf_tensors(*head, dtype=torch.bfloat16)
    params = hybridize_shared_prefix(params, exit_layer, refine=0)
    target = ModelRuntime(mcfg, params, max_length, dtype=torch.bfloat16, family="mistral",
                          device=device)
    draft = early_exit_runtime(target, exit_layer)
    reference = {"embed": sd["model.embed_tokens.weight"], "final_norm": sd["model.norm.weight"],
                 "head": Linear(awq=[head], int4f=True, scale_dtype=torch.bfloat16),
                 "layers": layers,
                 "heads": cfg["num_attention_heads"], "kv_heads": cfg["num_key_value_heads"],
                 "head_dim": cfg["head_dim"], "eps": cfg["rms_norm_eps"],
                 "theta": cfg["rope_theta"], "top_k": 0}
    return types.SimpleNamespace(target=target, draft=draft, reference=reference, vocab=V)


def shapes(cfg: dict):
    """(target, draft) shapes for the work counts: the target's layers from
    `exit_layer` on run W4A16; the early-exit draft is its first layers (Int4F)."""
    import dataclasses

    from benchmark.roofline import Shapes

    exit_layer = cfg["bench"]["exit_layer"]
    target = Shapes.from_config(cfg, w4_from=exit_layer)
    return target, dataclasses.replace(target, layers=exit_layer, w4_layers=())
