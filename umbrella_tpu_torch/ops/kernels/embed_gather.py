"""Embedding row gather: CUDA kernel `csrc/embed_gather.cu` and its plain version.

Replaces `umbrella_tpu/ops/pallas/embed_gather.py::embed_gather`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build


def embed_gather_ref(embed: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """Plain version: embed[input_ids], [V, H] x [S] -> [S, H]."""
    return embed[input_ids.long()]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.library("embed_gather").embed_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def embed_gather(embed: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """embed[input_ids]; [V, H] x [S] int -> [S, H] in embed.dtype.

    A CUDA table launches the kernel (ids outside [0, V) give zero rows); a CPU
    table takes the plain version."""
    if not embed.is_cuda:
        return embed_gather_ref(embed, input_ids)
    if embed.dim() != 2 or not embed.is_contiguous():
        raise ValueError("embed_gather: embed must be a contiguous [V, H] tensor")
    if input_ids.dim() != 1 or input_ids.device != embed.device:
        raise ValueError("embed_gather: input_ids must be [S] on the table's device")
    ids = input_ids.to(torch.int32).contiguous()
    S = ids.shape[0]
    V, H = embed.shape
    out = torch.empty((S, H), dtype=embed.dtype, device=embed.device)
    with build.on_device(embed) as st:
        build.check(_fn()(build.ptr(embed), build.ptr(ids), build.ptr(out), S, V,
                          H * embed.element_size(), st),
                    "embed_gather")
    embed_gather.launches += 1
    return out


embed_gather.launches = 0
