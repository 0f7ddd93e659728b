"""AWQ checkpoint -> quantized llama-family runtime, and in-process W4 quantization.

Counterpart of `umbrella_tpu/quantization/loader.py`. Reads HF AutoAWQ "GEMM"
checkpoints into the param tree of models/weights.py with linear weights as
per-layer tuples of split-halves AwqTensors (QKV and gate|up concatenated
along N when packed); embeddings, norms and lm_head stay fp. `quantize_params`
W4-quantizes an fp param tree on its device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..models.weights import SafetensorsReader, _load_state_dict, fetch, trim_vocab_rows
from ..ops.rope import rope_params
from .awq import awq_from_hf_tensors, concat_awq, quantize_pack_device


def awq_params_from_hf_state_dict(sd, cfg: ModelConfig, max_length: int,
                                  dtype=torch.bfloat16, n_layers: Optional[int] = None,
                                  packed: bool = True, device="cpu") -> dict:
    n = n_layers if n_layers is not None else cfg.num_hidden_layers
    P = "model."

    def fp(name):
        return fetch(sd, name, device, torch.float32).to(dtype)

    def q_one(i, fmt):
        base = fmt.format(i)
        return awq_from_hf_tensors(fetch(sd, base + ".qweight", device),
                                   fetch(sd, base + ".qzeros", device),
                                   fetch(sd, base + ".scales", device), dtype=dtype)

    def q_linear(fmt):
        return tuple(q_one(i, fmt) for i in range(n))

    def q_packed(fmts):
        return tuple(concat_awq([q_one(i, f) for f in fmts]) for i in range(n))

    def stack_vec(fmt):
        return torch.stack([fp(fmt.format(i)) for i in range(n)])

    def stack_vec_packed(fmts):
        return torch.stack([torch.cat([fp(f.format(i)) for f in fmts], dim=-1)
                            for i in range(n)])

    layers = {
        "input_norm": stack_vec(P + "layers.{}.input_layernorm.weight"),
        "post_norm": stack_vec(P + "layers.{}.post_attention_layernorm.weight"),
        "wo": q_linear(P + "layers.{}.self_attn.o_proj"),
        "down": q_linear(P + "layers.{}.mlp.down_proj"),
    }
    qkv_fmts = [P + "layers.{}.self_attn.%s_proj" % c for c in "qkv"]
    gu_fmts = [P + "layers.{}.mlp.gate_proj", P + "layers.{}.mlp.up_proj"]
    has_bias = P + "layers.0.self_attn.q_proj.bias" in sd
    if packed:
        layers["wqkv"] = q_packed(qkv_fmts)
        layers["gate_up"] = q_packed(gu_fmts)
        if has_bias:
            layers["bqkv"] = stack_vec_packed([f + ".bias" for f in qkv_fmts])
    else:
        layers["wq"], layers["wk"], layers["wv"] = (q_linear(f) for f in qkv_fmts)
        layers["gate"], layers["up"] = (q_linear(f) for f in gu_fmts)
        if has_bias:
            layers["bq"], layers["bk"], layers["bv"] = (stack_vec(f + ".bias") for f in qkv_fmts)

    params = {
        "embed": trim_vocab_rows(fp(P + "embed_tokens.weight"), cfg.vocab_size).contiguous(),
        "final_norm": fp(P + "norm.weight"),
        "layers": layers,
        **rope_params(cfg, device=device),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = trim_vocab_rows(fp("lm_head.weight"), cfg.vocab_size).T.contiguous()
    return params


def load_awq_runtime(path: str, cfg: ModelConfig, max_length: int, dtype=torch.bfloat16,
                     family: str = "llama", n_layers: Optional[int] = None,
                     offload: bool = False, num_cache_layers: int = 0, packed: bool = True,
                     device="cuda"):
    """An AutoAWQ directory as a ModelRuntime on `device`, or with `offload` as an
    OffloadModelRuntime: layer by layer, `num_cache_layers` of them on the
    device and the rest in host memory."""
    from ..models.auto_model import ModelRuntime
    from ..utils import resolve_device

    device = resolve_device(device)
    sd = _load_state_dict(path)
    try:
        if offload:
            from ..offload.streaming import OffloadModelRuntime

            return OffloadModelRuntime.from_state_dict(
                sd, cfg, max_length, dtype=dtype, family=family, n_layers=n_layers,
                num_cache_layers=num_cache_layers, quantized=True, model_name=path,
                device=device)
        params = awq_params_from_hf_state_dict(sd, cfg, max_length, dtype, n_layers=n_layers,
                                               packed=packed, device=device)
    finally:
        if isinstance(sd, SafetensorsReader):
            sd.close()
    return ModelRuntime(cfg, params, max_length, dtype=dtype, family=family,
                        n_layers=n_layers, model_name=path, device=device)


def quantize_params(params: dict, group_size: int = 128, dtype=torch.bfloat16,
                    quantize_lm_head: bool = False) -> dict:
    """AWQ-quantize an fp llama-family param tree on its device (linear weights,
    packed or unpacked layouts). `quantize_lm_head` also W4-quantizes the head;
    a tied head is materialised from embed.T."""
    out_layers = dict(params["layers"])
    n = params["layers"]["input_norm"].shape[0]
    for name in ("wq", "wk", "wv", "wo", "gate", "up", "down", "wqkv", "gate_up"):
        if name in params["layers"]:
            stacked = params["layers"][name]
            out_layers[name] = tuple(quantize_pack_device(stacked[i], group_size, dtype=dtype)
                                     for i in range(n))
    out = dict(params)
    out["layers"] = out_layers
    if quantize_lm_head:
        head = params["lm_head"] if "lm_head" in params else params["embed"].T.contiguous()
        out["lm_head"] = quantize_pack_device(head, group_size, dtype=dtype)
    return out


def quantize_runtime(runtime, group_size: int = 128, dtype=torch.bfloat16,
                     quantize_lm_head: bool = False):
    """W4-quantize a loaded ModelRuntime's fp weights (e.g. a draft, which reads
    all its weights once per tree level)."""
    from ..models.auto_model import ModelRuntime

    params = quantize_params(runtime.params, group_size=group_size, dtype=dtype,
                             quantize_lm_head=quantize_lm_head)
    return ModelRuntime(runtime.cfg, params, runtime.max_length, dtype=dtype,
                        family=runtime.family, n_layers=runtime.args.n_layers,
                        model_name=runtime.model_name, device=runtime.device)
