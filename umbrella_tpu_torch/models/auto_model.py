"""Model registry and runtime construction for the llama family.

Counterpart of `umbrella_tpu/models/auto_model.py`: ModelRuntime, loading a
checkpoint directory (`AutoModelLM.from_pretrained`: HF fp or AutoAWQ
safetensors / .bin), early-exit drafts and random runtimes. The family is
resolved from the checkpoint's `model_type` as in the JAX package; Gemma2 and
MoE resolve but are not ported (ROADMAP queue A, "Gemma2 and MoE").
`offload=True` loads an OffloadModelRuntime (offload/streaming.py) layer by
layer instead, its first `num_cache_layers` layers on the device.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import ModelConfig
from ..cuda_graphs import Phase
from ..utils import resolve_device
from .kv_cache import KVCache, init_kv_cache
from .llama import StaticModelArgs, init_llama_params, llama_forward
from .weights import load_llama_params

LLAMA_FAMILIES = ("llama", "qwen2", "mistral")

# Qwen2.5 serving vocab (checkpoints pad the embedding past it)
QWEN25_VOCAB = 151936

# known model ids (the JAX package's table, for names without a config model_type)
_KNOWN_FAMILIES = {
    "llama": [
        "meta-llama/Llama-3.3-70B-Instruct", "meta-llama/Llama-3.1-70B-Instruct",
        "meta-llama/Llama-3.1-8B-Instruct", "meta-llama/Meta-Llama-3-70B-Instruct",
        "meta-llama/Meta-Llama-3-8B-Instruct", "meta-llama/Llama-3.2-1B-Instruct",
        "meta-llama/Llama-3.2-3B-Instruct", "Felladrin/Llama-68M-Chat-v1",
        "facebook/layerskip-llama3.2-1B", "Zhuominc/Llama-3-330M",
        "Zhuominc/Coder-670M", "Zhuominc/Coder-400M", "Zhuominc/Coder-400M-IT",
        "Zhuominc/FastCode-500M", "InfiniAILab/CodeDrafter-500M",
        "ibnzterrell/Meta-Llama-3.3-70B-Instruct-AWQ-INT4",
        "lambdalabs/Llama-3.3-70B-Instruct-AWQ-4bit",
        "casperhansen/llama-3.3-70b-instruct-awq",
        "hugging-quants/Meta-Llama-3.1-70B-Instruct-AWQ-INT4",
        "hugging-quants/Meta-Llama-3.1-8B-Instruct-AWQ-INT4",
        "casperhansen/deepseek-r1-distill-llama-70b-awq",
    ],
    "qwen2": ["Qwen/Qwen2.5", "Qwen/QwQ", "KirillR/QwQ-32B-Preview-AWQ",
              "casperhansen/deepseek-r1-distill-qwen-32b-awq"],
    "mistral": ["mistralai/Mistral", "mistralai/Ministral",
                "solidrust/Mistral-7B-Instruct-v0.3-AWQ",
                "stelterlab/Mistral-Small-24B-Instruct-2501-AWQ",
                "PyrTools/Ministral-8B-Instruct-2410-AWQ"],
    "gemma2": ["google/gemma-2"],
    "moe": ["mistralai/Mixtral"],
}


def resolve_family(model_name: str, cfg: Optional[ModelConfig] = None) -> str:
    if cfg is not None and cfg.model_type:
        mt = cfg.model_type.lower()
        if "mixtral" in mt:
            return "moe"
        if (cfg.num_local_experts or 0) > 0:
            raise ValueError(
                f"unsupported MoE variant model_type={cfg.model_type!r} "
                f"(num_local_experts={cfg.num_local_experts}): only "
                "Mixtral-format checkpoints (block_sparse_moe.* expert "
                "tensors) are loadable as family 'moe'")
        for key, family in (("gemma2", "gemma2"), ("qwen", "qwen2"), ("mistral", "mistral"),
                            ("llama", "llama")):
            if key in mt:
                return family
    for family, prefixes in _KNOWN_FAMILIES.items():
        if any(model_name.startswith(p) for p in prefixes):
            return family
    return "llama"


def _check_family(family: str) -> None:
    if family not in LLAMA_FAMILIES:
        raise NotImplementedError(
            f"model family '{family}' is not ported yet (ROADMAP queue A, Gemma2 and MoE)")


class ModelRuntime:
    """A model: config + param tree + forward.

    `forward(params, kv, input_ids, position_ids, attn_mask, write_offset)` returns
    (fp32 logits, kv) and updates the KV cache the caller owns in place. The
    params must already live on `device` (see models/convert.py or the random
    constructors below). A runtime staged by parallel.pipeline.shard_runtime_pp
    holds its layer blocks in params["stages"]; its forward and init_kv follow
    the stages."""

    def __init__(self, cfg: ModelConfig, params: dict, max_length: int,
                 dtype=torch.bfloat16, family: str = "llama", n_layers: Optional[int] = None,
                 model_name: str = "", device="cuda"):
        _check_family(family)
        self.cfg = cfg
        self.params = params
        self.max_length = max_length
        self.dtype = dtype
        self.family = family
        self.model_name = model_name
        self.device = resolve_device(device)
        self.args = StaticModelArgs.from_config(cfg, n_layers=n_layers)

    @property
    def stage_devices(self):
        """The device of each pipeline stage, or None for an unstaged runtime."""
        stages = self.params.get("stages")
        return None if stages is None else tuple(s.device for s in stages)

    @property
    def supports_fused_phases(self) -> bool:
        """Whether the engines may run this model inside the device-resident
        decode loop (CUDA graphs on the card): true for every resident
        runtime, a staged one included, as in the JAX package."""
        return True

    @property
    def forward(self) -> Callable:
        if self.stage_devices is not None:
            from ..parallel.pipeline import pp_forward

            return pp_forward(self)
        args = self.args

        def fwd(params, kv, input_ids, position_ids, attn_mask, write_offset):
            return llama_forward(params, args, kv, input_ids, position_ids, attn_mask,
                                 write_offset)

        return fwd

    def forward_phases(self, kv) -> list:
        """The forward over `kv` (written in place) as phases of a step
        (cuda_graphs.Phase): the step values ids, pos, mask and nn (the write
        offset) -> logits. One phase on the runtime's device, or a staged
        runtime's embedding, stages and head (parallel.pipeline.pp_phases)."""
        if self.stage_devices is not None:
            from ..parallel.pipeline import pp_phases

            return pp_phases(self.args, self.params, kv)
        fwd = self.forward

        def forward(ids, pos, mask, nn):
            return fwd(self.params, kv, ids, pos, mask, nn)[0]

        return [Phase("forward", self.device, forward, ("ids", "pos", "mask", "nn"), ("logits",))]

    def init_kv(self, kv_dtype=None) -> KVCache:
        if self.stage_devices is not None:
            from ..parallel.pipeline import init_staged_kv

            return init_staged_kv(self, kv_dtype)
        return init_kv_cache(self.cfg, self.max_length, dtype=kv_dtype or self.dtype,
                             num_layers=self.args.n_layers, device=self.device)

    @property
    def eos_ids(self):
        return self.cfg.eos_token_ids


class AutoModelLM:
    """Loads a checkpoint directory into a ModelRuntime on `device`."""

    @classmethod
    def from_pretrained(cls, model_name: str, offload: bool = False, max_length: int = 8192,
                        dtype=torch.bfloat16, exit_layer: int = -1, num_cache_layers: int = 0,
                        packed: bool = True, device="cuda", **kwargs) -> ModelRuntime:
        """`model_name` is a checkpoint directory (config.json + *.safetensors or
        pytorch_model*.bin); an AWQ `quantization_config` selects the AWQ
        loader. exit_layer > 0 loads only the first exit_layer decoder layers.
        packed=False keeps q/k/v and gate/up separate. offload=True returns an
        OffloadModelRuntime (packed layout) with `num_cache_layers` layers on
        the device and the rest in host memory. Other keyword arguments (an
        engine's config) are ignored, as in the JAX package."""
        from ..utils import resolve_device

        device = resolve_device(device)
        cfg = ModelConfig.from_pretrained(model_name)
        family = resolve_family(model_name, cfg)
        _check_family(family)
        if family == "qwen2":
            # Qwen2.5 checkpoints pad the embedding; serve the real vocab so
            # draft and target token ids align
            cfg.vocab_size = min(cfg.vocab_size, QWEN25_VOCAB)
        n_layers = exit_layer if (exit_layer and exit_layer > 0) else None
        if cfg.quantization and cfg.quantization.get("method") == "awq":
            from ..quantization.loader import load_awq_runtime

            return load_awq_runtime(model_name, cfg, max_length=max_length, dtype=dtype,
                                    family=family, n_layers=n_layers, offload=offload,
                                    num_cache_layers=num_cache_layers, packed=packed,
                                    device=device)
        if offload:
            from ..offload.streaming import OffloadModelRuntime

            return OffloadModelRuntime.load(model_name, cfg, max_length=max_length, dtype=dtype,
                                            family=family, n_layers=n_layers,
                                            num_cache_layers=num_cache_layers, device=device)
        params = load_llama_params(model_name, cfg, max_length, dtype, n_layers=n_layers,
                                   packed=packed, device=device)
        return ModelRuntime(cfg, params, max_length, dtype=dtype, family=family,
                            n_layers=n_layers, model_name=model_name, device=device)


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
