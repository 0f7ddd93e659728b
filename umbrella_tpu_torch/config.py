"""Model architecture configuration (HF `config.json`-compatible).

Counterpart of `umbrella_tpu/config.py`. Loading a config from a checkpoint
(`from_pretrained`) arrives with the HF loaders in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


@dataclasses.dataclass
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None  # explicit override (Mistral-style); else hidden/heads
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2.5: bias on q/k/v projections
    mlp_bias: bool = False
    hidden_act: str = "silu"
    eos_token_id: Any = 2
    bos_token_id: Any = 1
    rope_scaling: Optional[dict] = None  # HF llama3-style dict or None
    model_type: str = "llama"

    # MoE (Mixtral-style) extras
    num_local_experts: Optional[int] = None
    num_experts_per_tok: int = 2

    # Gemma2 extras
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    sliding_window: Optional[int] = None

    # Quantization (populated when loading AWQ checkpoints)
    quantization: Optional[dict] = None  # {"method": "awq", "bits": 4, "group_size": 128}
    # Activation dtype for AWQ matmuls: "bf16" (W4A16). "int8" (W4A8) is not ported yet.
    awq_act: str = "bf16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def eos_token_ids(self) -> List[int]:
        eid = self.eos_token_id
        if eid is None:
            return []
        return list(eid) if isinstance(eid, (list, tuple)) else [int(eid)]

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in fields}
        quant_cfg = d.get("quantization_config")
        if quant_cfg and quant_cfg.get("quant_method") == "awq":
            known["quantization"] = {
                "method": "awq",
                "bits": quant_cfg.get("bits", 4),
                "group_size": quant_cfg.get("group_size", 128),
                "version": quant_cfg.get("version", "gemm"),
            }
        return cls(**known)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
