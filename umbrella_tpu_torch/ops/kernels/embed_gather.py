"""Embedding row gather: CUDA kernel `csrc/embed_gather.cu` and its plain version.

Replaces `umbrella_tpu/ops/pallas/embed_gather.py::embed_gather`.

`embed_gather_trainable` is the same gather under autograd (the training
forwards' lookup): its forward is the kernel, its backward scatter-adds the
output's gradient into a [V, H] fp32 buffer (repeated ids summed) and casts
it once to the table's dtype. The JAX package has no backward kernel (its
gradient of the lookup is XLA's transpose), so the backward is plain torch:
`index_put_(accumulate=True)`, which sums a row's repeats in the order of
their positions, so a step's gradient is the same bits every run (CUDA's
`index_add_` adds them with atomics, in whatever order they land).
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


def embed_gather_backward(grad_out: torch.Tensor, input_ids: torch.Tensor, V: int,
                          dtype) -> torch.Tensor:
    """The table's gradient of embed[input_ids]: grad_out [S, H] added into a
    zero [V, H] fp32 buffer at the rows input_ids (repeats summed in position
    order), cast once to `dtype`."""
    grad = torch.zeros((V, grad_out.shape[-1]), dtype=torch.float32, device=grad_out.device)
    grad.index_put_((input_ids.long(),), grad_out.float(), accumulate=True)
    return grad.to(dtype)


class _EmbedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, embed, input_ids):
        ctx.save_for_backward(input_ids)
        ctx.V, ctx.dtype = embed.shape[0], embed.dtype
        return embed_gather(embed, input_ids)

    @staticmethod
    def backward(ctx, grad_out):
        (input_ids,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        return embed_gather_backward(grad_out, input_ids, ctx.V, ctx.dtype), None


def embed_gather_trainable(embed: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """embed_gather with a gradient for `embed`: the kernel forward on a CUDA
    table (the plain version on a CPU one), the scatter-add backward."""
    return _EmbedGather.apply(embed, input_ids)
