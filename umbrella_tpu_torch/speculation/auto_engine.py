"""Engine dispatch from a config dict, with the JAX package's key allowlist.

`from_config` validates config keys against the selected engine's consumed-key
allowlist (as `umbrella_tpu/speculation/auto_engine.py` does), so a typo'd or
unsupported key raises instead of being ignored. The dynamic engine is the
default, as in the JAX package; the static and the batched
(continuous-batching) engines are the others.
"""
from __future__ import annotations

from ..serving.batched_engine import BatchedStaticEngine
from .dynamic_engine import DynamicEngine
from .static_engine import StaticEngine

_APP_KEYS = frozenset({"template", "generation_length", "max_turns", "scheduler"})
_MODEL_KEYS = frozenset({"offload", "exit_layer", "num_cache_layers", "quantize_draft"})
_COMMON_KEYS = frozenset({
    "max_length", "stop_distance", "safe_buffer", "temperature", "topp",
    "repetition_penalty", "topk", "tokenizer", "eos_token_ids", "seed",
    "kv_dtype", "draft_topk_recall", "dtype",
})

_ENGINE_CONFIG_KEYS = {
    "static": _COMMON_KEYS | _MODEL_KEYS | _APP_KEYS | {
        "growmap_path", "growmap", "tensor_parallel", "pipeline_parallel",
        "expert_parallel"},
    "dynamic": _COMMON_KEYS | _MODEL_KEYS | _APP_KEYS | {
        "width", "num_beams", "depth", "tensor_parallel", "pipeline_parallel",
        "expert_parallel"},
    # batched: no offload and no pipeline_parallel (BatchedStaticEngine raises
    # for both; listed so the error names them as unsupported, not unknown)
    "batched_static": (_COMMON_KEYS - {"stop_distance"}) | _APP_KEYS | {
        "growmap_path", "growmap", "batch_size", "segment_steps",
        "prefill_chunks_per_segment", "tensor_parallel", "pipeline_parallel",
        "expert_parallel", "offload", "exit_layer", "num_cache_layers",
        "quantize_draft"},
}

class AutoEngine:
    _ENGINE_MAPPING = {"static": StaticEngine, "dynamic": DynamicEngine,
                       "batched_static": BatchedStaticEngine}

    @classmethod
    def _resolve(cls, engine_name: str):
        if engine_name not in cls._ENGINE_MAPPING:
            raise ValueError(
                f"Engine type '{engine_name}' is not supported. Supported types: "
                f"{list(cls._ENGINE_MAPPING)}")
        return cls._ENGINE_MAPPING[engine_name]

    @classmethod
    def from_config(cls, device="cuda", **kwargs):
        """Build an engine (call its `initialize()` next). `model` and
        `draft_model` are ModelRuntimes or checkpoint directories (loaded by
        `initialize()` through AutoModelLM.from_pretrained); the engine runs on
        `device` (the GPU by default)."""
        engine_name = kwargs.pop("engine", "dynamic")
        engine_class = cls._resolve(engine_name)
        draft_model = kwargs.pop("draft_model", None)
        target_model = kwargs.pop("model", None)
        if draft_model is None or target_model is None:
            raise ValueError("from_config needs both 'model' and 'draft_model'")
        unknown = sorted(set(kwargs) - _ENGINE_CONFIG_KEYS[engine_name])
        if unknown:
            raise ValueError(
                f"config key(s) {unknown} are not consumed by engine "
                f"'{engine_name}' (allowed: {sorted(_ENGINE_CONFIG_KEYS[engine_name])})")
        return engine_class(draft_model_name=draft_model, target_model_name=target_model,
                            device=device, **kwargs)
