"""Runtime construction for the llama family.

Counterpart of `umbrella_tpu/models/auto_model.py` (ModelRuntime, early-exit
drafts, random runtimes). Loading HF checkpoints (`AutoModelLM.from_pretrained`)
and the Gemma2 / MoE families come in later slices (ROADMAP queue A).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import ModelConfig
from ..utils import resolve_device
from .kv_cache import KVCache, init_kv_cache
from .llama import StaticModelArgs, init_llama_params, llama_forward

LLAMA_FAMILIES = ("llama", "qwen2", "mistral")


class ModelRuntime:
    """A model: config + param tree + forward.

    `forward(params, kv, input_ids, position_ids, attn_mask, write_offset)` returns
    (fp32 logits, kv) and updates the KV cache the caller owns in place. The
    params must already live on `device` (see models/convert.py or the random
    constructors below)."""

    def __init__(self, cfg: ModelConfig, params: dict, max_length: int,
                 dtype=torch.bfloat16, family: str = "llama", n_layers: Optional[int] = None,
                 model_name: str = "", device="cuda"):
        if family not in LLAMA_FAMILIES:
            raise NotImplementedError(
                f"model family '{family}' is not ported yet (ROADMAP queue A, item 11)")
        self.cfg = cfg
        self.params = params
        self.max_length = max_length
        self.dtype = dtype
        self.family = family
        self.model_name = model_name
        self.device = resolve_device(device)
        self.args = StaticModelArgs.from_config(cfg, n_layers=n_layers)

    @property
    def forward(self) -> Callable:
        args = self.args

        def fwd(params, kv, input_ids, position_ids, attn_mask, write_offset):
            return llama_forward(params, args, kv, input_ids, position_ids, attn_mask,
                                 write_offset)

        return fwd

    def init_kv(self, kv_dtype=None) -> KVCache:
        return init_kv_cache(self.cfg, self.max_length, dtype=kv_dtype or self.dtype,
                             num_layers=self.args.n_layers, device=self.device)

    @property
    def eos_ids(self):
        return self.cfg.eos_token_ids


def early_exit_runtime(runtime: ModelRuntime, exit_layer: int) -> ModelRuntime:
    """Early-exit draft sharing the target's weights: its first `exit_layer`
    decoder layers plus the target's own final norm and lm_head (no copies)."""
    layers = {k: v[:exit_layer] for k, v in runtime.params["layers"].items()}
    params = dict(runtime.params, layers=layers)
    return ModelRuntime(runtime.cfg, params, runtime.max_length, dtype=runtime.dtype,
                        family=runtime.family, n_layers=exit_layer,
                        model_name=runtime.model_name, device=runtime.device)


def random_runtime(cfg: ModelConfig, max_length: int = 128, dtype=torch.float32, seed: int = 0,
                   n_layers: Optional[int] = None, device="cuda") -> ModelRuntime:
    """Random dense model for tests and benchmarks without checkpoints."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_llama_params(cfg, gen, max_length, dtype, n_layers=n_layers, device=device)
    return ModelRuntime(cfg, params, max_length, dtype=dtype, n_layers=n_layers, device=device)


def random_awq_runtime(cfg: ModelConfig, max_length: int = 128, dtype=torch.bfloat16,
                       seed: int = 0, group_size: int = 128, n_layers: Optional[int] = None,
                       quantize_lm_head: bool = False, device="cuda") -> ModelRuntime:
    """Random W4-quantized model at any shape, built on `device`.

    Each AwqTensor AWQ-quantizes an N(0, 0.02) matrix generated in 8192-column
    chunks (the fp32 8B head would be 2.1 GB whole), so scales and zeros have a
    real checkpoint's structure (the JAX package's "gaussian" mode). Random
    numbers come from a torch.Generator seeded with `seed`; they are not JAX's."""
    from ..ops.rope import rope_params
    from ..quantization.awq import concat_awq, quantize_pack_device

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = n_layers if n_layers is not None else cfg.num_hidden_layers
    H, D = cfg.hidden_size, cfg.resolved_head_dim
    Hq = cfg.num_attention_heads * D
    KV = cfg.num_key_value_heads * D
    I, V = cfg.intermediate_size, cfg.vocab_size

    def q_one(k_dim, n_dim):
        n_chunk = 8192
        parts = [quantize_pack_device(
            torch.randn((k_dim, min(n_chunk, n_dim - n0)), generator=gen, device=device) * 0.02,
            group_size, dtype=dtype) for n0 in range(0, n_dim, n_chunk)]
        return parts[0] if len(parts) == 1 else concat_awq(parts)

    def dense(shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    layers = {
        "input_norm": torch.ones((n, H), dtype=dtype, device=device),
        "post_norm": torch.ones((n, H), dtype=dtype, device=device),
        "wqkv": tuple(q_one(H, Hq + 2 * KV) for _ in range(n)),
        "wo": tuple(q_one(Hq, H) for _ in range(n)),
        "gate_up": tuple(q_one(H, 2 * I) for _ in range(n)),
        "down": tuple(q_one(I, H) for _ in range(n)),
    }
    params = {
        "embed": dense((V, H)),
        "final_norm": torch.ones((H,), dtype=dtype, device=device),
        "layers": layers,
        **rope_params(cfg, device=device),
    }
    if quantize_lm_head:
        params["lm_head"] = q_one(H, V)
    elif not cfg.tie_word_embeddings:
        params["lm_head"] = dense((H, V))
    return ModelRuntime(cfg, params, max_length, dtype=dtype, n_layers=n_layers, device=device)
