"""Masked flash attention over the layered linear KV cache: CUDA kernel
`csrc/tree_attention.cu` and its plain version `attend_dense`.

Replaces `umbrella_tpu/ops/pallas/tree_attention.py::attend_flash` (the
non-quantized, layered form).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import build

SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)


def attend_dense(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 mask: torch.Tensor, scale: Optional[float] = None,
                 logits_soft_cap: float = 0.0) -> torch.Tensor:
    """Plain version: q [S, H, D] against one layer's [KVH, L, D] cache under a
    bool [S, L] mask -> [S, H, D] (fp32 scores and softmax, probs in v.dtype)."""
    S, H, D = q.shape
    KVH = k_cache.shape[0]
    groups = H // KVH
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(S, KVH, groups, D)
    scores = torch.einsum("skgd,kld->kgsl", qg.float(), k_cache.float()) * scale
    if logits_soft_cap and logits_soft_cap > 0.0:
        scores = logits_soft_cap * torch.tanh(scores / logits_soft_cap)
    scores = torch.where(mask[None, None], scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("kgsl,kld->skgd", probs.float(), v_cache.float()).to(v_cache.dtype)
    return out.reshape(S, H, D)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.library("tree_attention").attend_flash
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def attend_flash(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 mask: torch.Tensor, kv_limit: int, layer_idx: int,
                 scale: Optional[float] = None, soft_cap: float = 0.0) -> torch.Tensor:
    """q [S, H, D] against layer `layer_idx` of [n_layers, KVH, L, D] caches under a
    bool [S, L] mask, reading only slots below `kv_limit` -> [S, H, D] in q.dtype.

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return attend_dense(q, k_cache[layer_idx], v_cache[layer_idx], mask, scale=scale,
                            logits_soft_cap=soft_cap)
    S, H, D = q.shape
    n_layers, KVH, L, Dk = k_cache.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attend_flash: unsupported dtype {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("attend_flash: q, k_cache and v_cache must share one dtype")
    if Dk != D or v_cache.shape != k_cache.shape or H % KVH:
        raise ValueError(f"attend_flash: shapes q {tuple(q.shape)} k {tuple(k_cache.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"attend_flash: head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if mask.shape != (S, L) or mask.dtype != torch.bool:
        raise ValueError(f"attend_flash: mask must be bool [{S}, {L}]")
    if not 0 <= layer_idx < n_layers:
        raise ValueError(f"attend_flash: layer_idx {layer_idx} out of range")
    for t in (q, k_cache, v_cache, mask):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError("attend_flash: inputs must be contiguous on one device")
    out = torch.empty_like(q)
    build.check(_fn()(build.ptr(q), build.ptr(k_cache), build.ptr(v_cache), build.ptr(mask),
                      build.ptr(out), S, H, KVH, L, D, int(layer_idx), int(kv_limit),
                      float(scale), float(soft_cap), int(q.dtype == torch.bfloat16),
                      build.stream(q.device)),
                "attend_flash")
    attend_flash.launches += 1
    return out


attend_flash.launches = 0
