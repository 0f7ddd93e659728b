"""Masked flash attention over the layered linear KV cache: the CUDA kernel family
`csrc/tree_attention.cu` and its plain versions.

Four wrappers, one per TPU kernel of `umbrella_tpu/ops/pallas/tree_attention.py`,
each counting its own launches:

  attend_flash               `_flash_kernel`     q [S, H, D], bf16/fp32 KV
  attend_flash_int8          `_flash_kernel_q`   q [S, H, D], int8 KV + fp32 scales
  attend_flash_batched       `_flash_kernel_b`   q [B, S, H, D], B cache slots
  attend_flash_batched_int8  `_flash_kernel_bq`  q [B, S, H, D], int8 KV

`attend_flash` and `attend_flash_batched` take optional `k_scale`/`v_scale` and
hand int8 caches to their int8 wrapper. CUDA tensors launch a kernel, chosen
by `_plan` from q's dtype and the head dim before the launch (never as a
fallback): bf16 q at head dim 64, 128 or 256 takes the tensor-core kernel
(TMA + wgmma), fp32 q and head dim 32 the scalar kernel; a failed launch
raises. CPU tensors take the plain version. The plain versions compute what the kernel
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
    [KVH, L, D] cache (int8 with [KVH, L] scales, or q's dtype) under [S, L];
    kv_limit is an int32 [1] tensor (or a host int)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    live = _live(mask, torch.as_tensor(kv_limit).reshape(()))
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


# The tensor-core kernel (bf16 q, head dim 64 / 128 / 256): 64 grouped query
# rows a block, 64 kv slots a tile, a TMA ring of `stages` K/V tiles, two
# consumer warpgroups at D <= 128 (the second takes the odd KV tiles; one
# warpgroup at D = 256), one block a SM. The scalar kernel (fp32 q, or head
# dim 32): 32 rows a block, 32 slots a block, no ring.
TC_HEAD_DIMS = (64, 128, 256)
_TC_ROWS, _TC_KV, _TC_MAX_STAGES = 64, 64, 4
_SCALAR_ROWS, _SCALAR_KV = 32, 32
_SMEM_MAX = 232448  # bytes of shared memory a block may use on an H100
# ring stages by (head dim, int8 KV): the most that fit beside the rest
_TC_STAGES = {(64, False): 4, (128, False): 4, (256, False): 2,
              (64, True): 4, (128, True): 4, (256, True): 3}


def _tc_groups(D: int) -> int:
    """Consumer warpgroups of a tensor-core block (csrc TcShape::kGroups)."""
    return 2 if D <= 128 else 1


def _tc_smem(D: int, int8: bool, stages: int, L: int) -> int:
    """Shared memory of one tensor-core block (csrc TcSmem::bytes): alignment
    slack, Q, the ring (K and V, and 8 KB of mask windows, 9 KB with the int8
    scales), the widened int8 K and V of each consumer warpgroup, the
    barriers, a live flag a KV tile."""
    tile = _TC_KV * D * 2
    stage = 2 * _TC_KV * D + 9216 if int8 else 2 * tile + 8192
    return (1024 + _TC_ROWS * D * 2 + stages * stage + (2 * tile * _tc_groups(D) if int8 else 0)
            + 16 * _TC_MAX_STAGES + -(-L // _TC_KV))


def _plan(B: int, S: int, H: int, KVH: int, L: int, D: int, q_dtype, kv_int8: bool) -> dict:
    """The launch plan: which kernel, its rows a block, kv slots a tile, ring
    stages, consumer warpgroups, grid (kv heads, row tiles, B) and shared
    memory. Nothing splits the KV range, and everything but the grid's row
    tiles and B comes from D, the dtypes and L, never from S or B, so a row's
    summation order is the same in every launch. The tensor-core kernel is
    launched with the plan's stages, row tiles, warpgroups and shared memory
    and refuses them unless they are its own."""
    groups = H // KVH
    if q_dtype == torch.bfloat16 and D in TC_HEAD_DIMS:
        stages = _TC_STAGES[(D, kv_int8)]
        smem = _tc_smem(D, kv_int8, stages, L)
        if smem > _SMEM_MAX:
            raise ValueError(f"tree_attention: L={L} needs {smem} bytes of shared memory")
        return dict(kernel="tc", rows=_TC_ROWS, kv_tile=_TC_KV, stages=stages,
                    warpgroups=_tc_groups(D), grid=(KVH, -(-S * groups // _TC_ROWS), B),
                    smem=smem)
    return dict(kernel="scalar", rows=_SCALAR_ROWS, kv_tile=_SCALAR_KV, stages=1,
                warpgroups=None, grid=(KVH, -(-S * groups // _SCALAR_ROWS), B), smem=None)


def _check(what: str, q, k_cache, v_cache, mask, k_scale, v_scale, kv_limits, slots,
           layer_idx: int) -> dict:
    """Check the operands (on any device): q [B, S, H, D], caches
    [n, Bc, KVH, L, D], mask [B, S, L], scales [n, Bc, KVH, L]; or the
    single-slot forms without B and Bc (B = Bc = 1). Returns the launch plan
    with the shape; raises ValueError on what the kernels do not take."""
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
    aligned = [q, k_cache, v_cache]
    if quant:
        for t in (k_scale, v_scale):
            if t is None or t.shape != k_cache.shape[:-1] or t.dtype != torch.float32:
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
    plan = _plan(B, S, H, KVH, L, D, q.dtype, quant)
    if plan["kernel"] == "tc" and quant:  # TMA reads the scales too
        aligned += [k_scale, v_scale]
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: q, the caches and the scales must be 16-byte aligned")
    return dict(plan, B=B, S=S, H=H, KVH=KVH, L=L, D=D, Bc=Bc, n_layers=n_layers)


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(build.library("tree_attention"), name)
    # attend_flash: ..., kv_limit, scale, soft_cap, q_bf16, kv_int8, stream;
    # attend_flash_tc: ..., n_layers, layer, kv_limit, scale, soft_cap, kv_int8,
    # then the plan (stages, row tiles, warpgroups, smem), stream. The scalar
    # kv_limit is read only without the kv_limits pointer, which _launch
    # always passes, so it is 0.
    ints, plan = (9, 0) if name == "attend_flash" else (10, 3)
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * ints
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_int] * plan + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def limit_tensor(kv_limit, device) -> torch.Tensor:
    """A single-slot kv_limit as the int32 [1] tensor the kernels read: a
    tensor is taken as it is, a host int is filled in on the device (a fill
    kernel, no host-to-device copy)."""
    if isinstance(kv_limit, torch.Tensor):
        return kv_limit
    return torch.full((1,), int(kv_limit), dtype=torch.int32, device=device)


def _launch(wrapper, q, k_cache, v_cache, mask, k_scale, v_scale, kv_limits, slots,
            layer_idx: int, scale, soft_cap: float) -> torch.Tensor:
    """Check the inputs and launch the plan's kernel, which reads each grid
    row's limit from `kv_limits` (int32 [B] on the device; [1] for the
    single-slot wrappers); count the launch on `wrapper` (and on its
    `scalar_launches` for the scalar kernel). Returns out shaped like q."""
    what = wrapper.__name__
    pl = _check(what, q, k_cache, v_cache, mask, k_scale, v_scale, kv_limits, slots,
                layer_idx)
    quant = int(k_scale is not None)
    out = torch.empty_like(q)
    ptrs = [build.ptr(t) for t in (q, k_cache, v_cache, k_scale, v_scale, mask, kv_limits,
                                   slots, out)]
    dims = [pl["B"], pl["S"], pl["H"], pl["KVH"], pl["L"], pl["D"], pl["Bc"]]
    with build.on_device(q) as st:
        if pl["kernel"] == "tc":
            code = _fn("attend_flash_tc")(*ptrs, *dims, pl["n_layers"], int(layer_idx), 0,
                                          float(scale), float(soft_cap), quant,
                                          pl["stages"], pl["grid"][1], pl["warpgroups"],
                                          pl["smem"], st)
        else:
            code = _fn("attend_flash")(*ptrs, *dims, int(layer_idx), 0,
                                       float(scale), float(soft_cap),
                                       int(q.dtype == torch.bfloat16), quant, st)
        build.check(code, what)
    wrapper.launches += 1
    if pl["kernel"] == "scalar":
        wrapper.scalar_launches += 1
    return out


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def attend_flash(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 mask: torch.Tensor, kv_limit, layer_idx: int,
                 scale: Optional[float] = None, soft_cap: float = 0.0,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [S, H, D] against layer `layer_idx` of [n_layers, KVH, L, D] caches under a
    bool [S, L] mask, reading only slots below `kv_limit` -> [S, H, D] in
    q.dtype. kv_limit is an int32 [1] tensor on q's device, which the kernel
    reads itself (no host read, so a CUDA graph can replay the launch with a
    new limit), or a host int (`limit_tensor`). With `k_scale`/`v_scale`
    ([n_layers, KVH, L] fp32) the caches are int8 and `attend_flash_int8`
    runs."""
    if k_scale is not None:
        return attend_flash_int8(q, k_cache, v_cache, k_scale, v_scale, mask, kv_limit,
                                 layer_idx, scale=scale, soft_cap=soft_cap)
    scale = _scale(q, scale)
    if not q.is_cuda:
        return attend_flash_ref(q, k_cache[layer_idx], v_cache[layer_idx], mask, kv_limit,
                                scale=scale, soft_cap=soft_cap)
    return _launch(attend_flash, q, k_cache, v_cache, mask, None, None,
                   limit_tensor(kv_limit, q.device), None, layer_idx, scale, soft_cap)


def attend_flash_int8(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor, mask: torch.Tensor,
                      kv_limit, layer_idx: int, scale: Optional[float] = None,
                      soft_cap: float = 0.0) -> torch.Tensor:
    """attend_flash over int8 [n_layers, KVH, L, D] caches with fp32 per-slot
    scales [n_layers, KVH, L], applied in score space."""
    scale = _scale(q, scale)
    if not q.is_cuda:
        return attend_flash_ref(q, k_cache[layer_idx], v_cache[layer_idx], mask, kv_limit,
                                scale=scale, soft_cap=soft_cap, k_scale=k_scale[layer_idx],
                                v_scale=v_scale[layer_idx])
    return _launch(attend_flash_int8, q, k_cache, v_cache, mask, k_scale, v_scale,
                   limit_tensor(kv_limit, q.device), None, layer_idx, scale, soft_cap)


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
    return _launch(attend_flash_batched, q, k_cache, v_cache, mask, None, None, kv_limits,
                   slots, layer_idx, scale, soft_cap)


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
    return _launch(attend_flash_batched_int8, q, k_cache, v_cache, mask, k_scale, v_scale,
                   kv_limits, slots, layer_idx, scale, soft_cap)


for _w in (attend_flash, attend_flash_int8, attend_flash_batched, attend_flash_batched_int8):
    _w.launches = 0  # every launch of the wrapper
    _w.scalar_launches = 0  # ... of them, the scalar kernel's (fp32 q, or head dim 32)
