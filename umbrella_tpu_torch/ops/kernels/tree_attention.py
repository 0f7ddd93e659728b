"""Masked flash attention over the layered linear KV cache: the CUDA kernel family
`csrc/tree_attention.cu` and its plain versions.

Four wrappers, one per TPU kernel of `umbrella_tpu/ops/pallas/tree_attention.py`,
each counting its own launches:

  attend_flash               `_flash_kernel`     q [S, H, D], bf16/fp32 KV
  attend_flash_int8          `_flash_kernel_q`   q [S, H, D], int8 KV + fp32 scales
  attend_flash_batched       `_flash_kernel_b`   q [B, S, H, D], B cache slots
  attend_flash_batched_int8  `_flash_kernel_bq`  q [B, S, H, D], int8 KV

`attend_flash` and `attend_flash_batched` take optional `k_scale`/`v_scale` and
hand int8 caches to their int8 wrapper. CUDA tensors launch the kernel; CPU
tensors take the plain version. The plain versions compute what the kernel
computes: slots at or past a slot's kv_limit and masked slots add nothing (a
row with no live slot is 0), int8 scales act in score space, and P.V runs on
probabilities rounded to q's dtype (times the v scale for int8 KV).
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
    """q [S, H, D] against one layer's [KVH, L, D] cache under a bool [S, L] mask
    -> [S, H, D] (fp32 scores and softmax, probs in v.dtype); the JAX package's
    `attend_dense`."""
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


def _live(mask: torch.Tensor, kv_limits: torch.Tensor) -> torch.Tensor:
    """mask [..., S, L] & (slot < kv_limit of its row's cache slot)."""
    cols = torch.arange(mask.shape[-1], device=mask.device)
    return mask & (cols < kv_limits.to(mask.device)[..., None, None])


def _batched_ref_core(q, k, v, live, scale, soft_cap, ks=None, vs=None) -> torch.Tensor:
    """q [B, S, H, D] against per-slot [B, KVH, L, D] caches; live [B, S, L]."""
    B, S, H, D = q.shape
    KVH = k.shape[1]
    qg = q.reshape(B, S, KVH, H // KVH, D)
    scores = torch.einsum("bskgd,bkld->bkgsl", qg.float(), k.float()) * scale
    if ks is not None:
        scores = scores * ks.float()[:, :, None, None, :]
    if soft_cap and soft_cap > 0.0:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    scores = torch.where(live[:, None, None], scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        probs = probs * vs.float()[:, :, None, None, :]
    probs = probs.to(q.dtype)
    out = torch.einsum("bkgsl,bkld->bskgd", probs.float(), v.float()).reshape(B, S, H, D)
    out = torch.where(live.any(-1)[:, :, None, None], out, 0.0)
    return out.to(q.dtype)


def attend_flash_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     mask: torch.Tensor, kv_limit, scale: Optional[float] = None,
                     soft_cap: float = 0.0, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the single-slot kernels: q [S, H, D] against one layer's
    [KVH, L, D] cache (int8 with [KVH, L] scales, or q's dtype) under [S, L]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    live = _live(mask, torch.as_tensor(kv_limit))
    if k_scale is None:
        out = attend_dense(q, k_cache, v_cache, live, scale=scale, logits_soft_cap=soft_cap)
        return torch.where(live.any(-1)[:, None, None], out, torch.zeros_like(out))
    return _batched_ref_core(q[None], k_cache[None], v_cache[None], live[None], scale,
                             soft_cap, k_scale[None], v_scale[None])[0]


def attend_flash_batched_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             mask: torch.Tensor, kv_limits: torch.Tensor, layer_idx: int,
                             slots: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None, soft_cap: float = 0.0,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the batched kernels: q [B, S, H, D] against layer
    `layer_idx` of [n, Bc, KVH, L, D] caches, grid row b reading cache row
    slots[b] (default b) and slots below kv_limits[b]."""
    B = q.shape[0]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    rows = (slots.long() if slots is not None
            else torch.arange(B, device=k_cache.device))
    pick = (lambda t: None if t is None else t[layer_idx].index_select(0, rows))
    return _batched_ref_core(q, pick(k_cache), pick(v_cache), _live(mask, kv_limits), scale,
                             soft_cap, pick(k_scale), pick(v_scale))


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.library("tree_attention").attend_flash
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(what: str, q, k_cache, v_cache, mask, k_scale, v_scale, kv_limits, slots,
            kv_limit: int, layer_idx: int, scale, soft_cap: float) -> torch.Tensor:
    """Check the inputs and launch the kernel: q [B, S, H, D], caches
    [n, Bc, KVH, L, D], mask [B, S, L], scales [n, Bc, KVH, L]; or the
    single-slot forms without B and Bc (B = Bc = 1, taken from the shapes, so
    no view is made on the host). Returns out shaped like q."""
    single = q.dim() == 3
    B, S, H, D = (1, *q.shape) if single else q.shape
    if single:
        n_layers, KVH, L, Dk = k_cache.shape
        Bc = 1
    else:
        n_layers, Bc, KVH, L, Dk = k_cache.shape
    quant = k_scale is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: unsupported dtype {q.dtype}")
    kv_dtype = torch.int8 if quant else q.dtype
    if k_cache.dtype != kv_dtype or v_cache.dtype != kv_dtype:
        raise ValueError(f"{what}: caches must be {kv_dtype} for q {q.dtype}")
    if Dk != D or v_cache.shape != k_cache.shape or H % KVH:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k {tuple(k_cache.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if mask.shape != ((S, L) if single else (B, S, L)) or mask.dtype != torch.bool:
        raise ValueError(f"{what}: mask must be bool [{B}, {S}, {L}]")
    if not 0 <= layer_idx < n_layers:
        raise ValueError(f"{what}: layer_idx {layer_idx} out of range")
    tensors = [q, k_cache, v_cache, mask]
    if quant:
        for s in (k_scale, v_scale):
            if s is None or s.shape != k_cache.shape[:-1] or s.dtype != torch.float32:
                raise ValueError(f"{what}: scales must be fp32 {tuple(k_cache.shape[:-1])}")
        tensors += [k_scale, v_scale]
    for t in (kv_limits, slots):
        if t is not None:
            if t.shape != (B,) or t.dtype != torch.int32:
                raise ValueError(f"{what}: kv_limits/slots must be int32 [{B}]")
            tensors.append(t)
    for t in tensors:
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{what}: inputs must be contiguous on one device")
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: q and the caches must be 16-byte aligned")
    out = torch.empty_like(q)
    with build.on_device(q) as st:
        build.check(_fn()(build.ptr(q), build.ptr(k_cache), build.ptr(v_cache), build.ptr(k_scale),
                          build.ptr(v_scale), build.ptr(mask), build.ptr(kv_limits),
                          build.ptr(slots), build.ptr(out), B, S, H, KVH, L, D, Bc,
                          int(layer_idx), int(kv_limit), float(scale), float(soft_cap),
                          int(q.dtype == torch.bfloat16), int(quant), st),
                    what)
    return out


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def attend_flash(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 mask: torch.Tensor, kv_limit: int, layer_idx: int,
                 scale: Optional[float] = None, soft_cap: float = 0.0,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [S, H, D] against layer `layer_idx` of [n_layers, KVH, L, D] caches under a
    bool [S, L] mask, reading only slots below the host int `kv_limit` ->
    [S, H, D] in q.dtype. With `k_scale`/`v_scale` ([n_layers, KVH, L] fp32) the
    caches are int8 and `attend_flash_int8` runs."""
    if k_scale is not None:
        return attend_flash_int8(q, k_cache, v_cache, k_scale, v_scale, mask, kv_limit,
                                 layer_idx, scale=scale, soft_cap=soft_cap)
    scale = _scale(q, scale)
    if not q.is_cuda:
        return attend_flash_ref(q, k_cache[layer_idx], v_cache[layer_idx], mask, kv_limit,
                                scale=scale, soft_cap=soft_cap)
    out = _launch("attend_flash", q, k_cache, v_cache, mask, None, None, None, None,
                  int(kv_limit), layer_idx, scale, soft_cap)
    attend_flash.launches += 1
    return out


def attend_flash_int8(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor, mask: torch.Tensor,
                      kv_limit: int, layer_idx: int, scale: Optional[float] = None,
                      soft_cap: float = 0.0) -> torch.Tensor:
    """attend_flash over int8 [n_layers, KVH, L, D] caches with fp32 per-slot
    scales [n_layers, KVH, L], applied in score space."""
    scale = _scale(q, scale)
    if not q.is_cuda:
        return attend_flash_ref(q, k_cache[layer_idx], v_cache[layer_idx], mask, kv_limit,
                                scale=scale, soft_cap=soft_cap, k_scale=k_scale[layer_idx],
                                v_scale=v_scale[layer_idx])
    out = _launch("attend_flash_int8", q, k_cache, v_cache, mask, k_scale, v_scale, None, None,
                  int(kv_limit), layer_idx, scale, soft_cap)
    attend_flash_int8.launches += 1
    return out


def attend_flash_batched(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         mask: torch.Tensor, kv_limits: torch.Tensor, layer_idx: int,
                         slots: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                         soft_cap: float = 0.0, k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, S, H, D] against layer `layer_idx` of [n_layers, Bc, KVH, L, D] caches
    under a bool [B, S, L] mask. Grid row b reads cache row slots[b] (default b)
    below kv_limits[b]; both are int32 [B] tensors on q's device, read by the
    kernel itself (no host read). With scales ([n_layers, Bc, KVH, L] fp32) the
    caches are int8 and `attend_flash_batched_int8` runs."""
    if k_scale is not None:
        return attend_flash_batched_int8(q, k_cache, v_cache, k_scale, v_scale, mask,
                                         kv_limits, layer_idx, slots=slots, scale=scale,
                                         soft_cap=soft_cap)
    scale = _scale(q, scale)
    if not q.is_cuda:
        return attend_flash_batched_ref(q, k_cache, v_cache, mask, kv_limits, layer_idx,
                                        slots=slots, scale=scale, soft_cap=soft_cap)
    out = _launch("attend_flash_batched", q, k_cache, v_cache, mask, None, None, kv_limits,
                  slots, 0, layer_idx, scale, soft_cap)
    attend_flash_batched.launches += 1
    return out


def attend_flash_batched_int8(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                              k_scale: torch.Tensor, v_scale: torch.Tensor, mask: torch.Tensor,
                              kv_limits: torch.Tensor, layer_idx: int,
                              slots: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None,
                              soft_cap: float = 0.0) -> torch.Tensor:
    """attend_flash_batched over int8 caches with fp32 scales [n_layers, Bc, KVH, L]."""
    scale = _scale(q, scale)
    if not q.is_cuda:
        return attend_flash_batched_ref(q, k_cache, v_cache, mask, kv_limits, layer_idx,
                                        slots=slots, scale=scale, soft_cap=soft_cap,
                                        k_scale=k_scale, v_scale=v_scale)
    out = _launch("attend_flash_batched_int8", q, k_cache, v_cache, mask, k_scale, v_scale,
                  kv_limits, slots, 0, layer_idx, scale, soft_cap)
    attend_flash_batched_int8.launches += 1
    return out


attend_flash.launches = 0
attend_flash_int8.launches = 0
attend_flash_batched.launches = 0
attend_flash_batched_int8.launches = 0
