"""Carry weights and KV state from numpy (e.g. the JAX package's trees after
`jax.tree_util.tree_map(np.asarray, ...)`) into the port's tensors, and the
JAX package's offload runtime (its top params and host layers) into the
port's.

Quantized leaves are recognised by their fields, not their types: an object with
`w8`/`scales`/`zeros` becomes an AwqTensor, one with `w8`/`a`/`b` an Int4FTensor.
`w8` is kept bit for bit (int8, split-halves nibbles). bfloat16 arrays (numpy's
ml_dtypes extension type) are reinterpreted bit for bit as torch.bfloat16.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ModelConfig
from ..quantization.awq import AwqTensor
from ..quantization.int4f import Int4FTensor
from .batched import BatchedKVCache
from .kv_cache import KVCache

# entries that stay fp32 whatever dtype the rest of the tree is cast to
_FP32_KEYS = frozenset({"rope_inv_freq"})


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy array (bf16 included) -> contiguous tensor on device; floating
    arrays are cast to `dtype` when it is given."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device).contiguous()


def _convert(x, device, dtype):
    if all(hasattr(x, f) for f in ("w8", "scales", "zeros")):
        w8 = to_tensor(x.w8, device)
        if w8.dtype == torch.uint8:
            w8 = w8.view(torch.int8)
        if w8.dtype != torch.int8:
            raise TypeError(f"AWQ w8 must be int8 or uint8, got {w8.dtype}")
        return AwqTensor(w8=w8, scales=to_tensor(x.scales, device, dtype),
                         zeros=to_tensor(x.zeros, device, dtype))
    if all(hasattr(x, f) for f in ("w8", "a", "b")):
        w8 = to_tensor(x.w8, device)
        if w8.dtype == torch.uint8:
            w8 = w8.view(torch.int8)
        return Int4FTensor(w8=w8, a=to_tensor(x.a, device, torch.float32),
                           b=to_tensor(x.b, device, torch.float32))
    if isinstance(x, dict):
        return {k: (to_tensor(v, device, torch.float32) if k in _FP32_KEYS
                    else _convert(v, device, dtype)) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_convert(v, device, dtype) for v in x)
    if isinstance(x, (float, int, np.floating, np.integer)) or np.ndim(x) == 0:
        return float(np.asarray(x, dtype=np.float32))
    return to_tensor(x, device, dtype)


def params_from_numpy(params: dict, device="cpu", dtype=None) -> dict:
    """The JAX package's param tree (numpy leaves) -> the port's tree with the
    same keys: the llama families', Gemma2's (four norms a layer, separate
    q/k/v and gate/up) and MoE's (router and stacked experts). Scalars
    (rope_scale) become Python floats."""
    return _convert(params, torch.device(device), dtype)


def trainable_params(params: dict, device=None) -> dict:
    """A port param tree (a fresh one from an init, or params_from_numpy's)
    as train params: every floating tensor a leaf that requires grad (copied
    to `device` when one is given), and `rope_scale` a trainable 0-d fp32
    tensor on the tree's device. The JAX package's train step
    differentiates its whole params pytree, rope leaves included (ROADMAP C)."""
    dev = torch.device(device) if device is not None else params["embed"].device

    def leaf(v):
        if isinstance(v, dict):
            return {k: leaf(x) for k, x in v.items()}
        if not isinstance(v, torch.Tensor):
            v = torch.tensor(float(v), dtype=torch.float32)
        return v.detach().to(dev).clone().requires_grad_(v.is_floating_point())

    return leaf(params)


def train_params_from_numpy(params: dict, device="cpu", dtype=None) -> dict:
    """The JAX package's train params (numpy leaves, e.g. init_llama_params'
    or a TrainState's params) -> the port's trainable leaves on `device`."""
    return trainable_params(params_from_numpy(params, device, dtype))


def serving_params(params: dict) -> dict:
    """Train params as the engines take them: detached tensors (the engines
    run no autograd) and `rope_scale` a Python float again."""
    out = {k: (serving_params(v) if isinstance(v, dict) else v.detach())
           for k, v in params.items()}
    if "rope_scale" in out:
        out["rope_scale"] = float(out["rope_scale"])
    return out


def config_from(cfg) -> ModelConfig:
    """The port's ModelConfig with every field that `cfg` (the JAX package's
    ModelConfig, or any object with those attribute names) has: the Gemma2
    soft caps, scalar and window and the MoE expert counts included."""
    return ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)
                          if hasattr(cfg, f.name)})


def runtime_from_numpy(params: dict, cfg, max_length: int, family: str = "llama",
                       dtype=torch.float32, n_layers=None, device="cpu"):
    """A ModelRuntime of `family` over the JAX package's params (numpy leaves)
    and config, on `device`."""
    from .auto_model import ModelRuntime

    return ModelRuntime(config_from(cfg), params_from_numpy(params, device), max_length,
                        dtype=dtype, family=family, n_layers=n_layers, device=device)


def offload_runtime_from_numpy(top: dict, host_layers, cfg, max_length: int,
                               dtype=torch.float32, num_cache_layers: int = 0, device="cpu"):
    """The JAX package's OffloadModelRuntime, as its `top` params and its
    per-layer `host_layers` (numpy leaves), -> the port's OffloadModelRuntime
    over the same weights, `num_cache_layers` of them on `device`."""
    from ..offload.streaming import OffloadModelRuntime

    device = torch.device(device)
    return OffloadModelRuntime(cfg, params_from_numpy(top, device),
                               [params_from_numpy(lw, device) for lw in host_layers],
                               max_length, dtype=dtype, num_cache_layers=num_cache_layers,
                               device=device)


def kv_from_numpy(kv, device="cpu"):
    """A KVCache-like object with numpy `k`/`v` -> the port's cache: a KVCache for
    [layers, KVH, L, D] buffers, a BatchedKVCache for batched [layers, B, KVH, L, D]
    ones. int8 caches carry their fp32 `k_scale`/`v_scale` across too."""
    device = torch.device(device)
    k = to_tensor(kv.k, device)
    cls = BatchedKVCache if k.dim() == 5 else KVCache
    if getattr(kv, "k_scale", None) is None:
        return cls(k=k, v=to_tensor(kv.v, device))
    return cls(k=k, v=to_tensor(kv.v, device), k_scale=to_tensor(kv.k_scale, device),
               v_scale=to_tensor(kv.v_scale, device))
