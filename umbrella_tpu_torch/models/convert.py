"""Carry weights and KV state from numpy (e.g. the JAX package's trees after
`jax.tree_util.tree_map(np.asarray, ...)`) into the port's tensors.

Quantized leaves are recognised by their fields, not their types: an object with
`w8`/`scales`/`zeros` becomes an AwqTensor, one with `w8`/`a`/`b` an Int4FTensor.
`w8` is kept bit for bit (int8, split-halves nibbles). bfloat16 arrays (numpy's
ml_dtypes extension type) are reinterpreted bit for bit as torch.bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from ..quantization.awq import AwqTensor
from ..quantization.int4f import Int4FTensor
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
    """The JAX package's llama param tree (numpy leaves) -> the port's tree with
    the same keys. Scalars (rope_scale) become Python floats."""
    return _convert(params, torch.device(device), dtype)


def kv_from_numpy(kv, device="cpu") -> KVCache:
    """A KVCache-like object with numpy `k`/`v` [layers, KVH, L, D] -> KVCache."""
    if getattr(kv, "k_scale", None) is not None:
        raise NotImplementedError("int8 KV cache is not ported yet (ROADMAP queue A, item 2)")
    device = torch.device(device)
    return KVCache(k=to_tensor(kv.k, device), v=to_tensor(kv.v, device))
