"""The collectives of the tensor-, sequence- and expert-parallel forwards.

The JAX package's `lax.psum` and tiled `lax.all_gather` run inside a
`shard_map`, on every device of the mesh at once. Here one process drives a
list of shard devices (a device may repeat: one card, or the CPU, can hold
every shard), and keeps the values that JAX holds replicated -- the residual
stream, the norms, the gathered logits -- on the first shard's device. So
each collective gathers onto one device, and `broadcast` hands a shard its
input: between two cards a peer copy (over NVLink on an H100 host), on one
card nothing at all. These move the same bytes as a psum that leaves the
sum everywhere.

`all_reduce` sums the partials in shard order, in fp32, and rounds once to
the hidden dtype. Two reasons: the sum is then the same bits whichever
devices hold the shards (one card or four), so a four-card decode can be
held to the one-card tokens exactly; and a sum rounded to bf16 after each
add would part from the unsharded product, which rounds once, further than
this one does. Nothing here falls back to another path: a failed copy raises.

Where the model axis spans processes (parallel/distributed.py), this
process's shards are a block of the axis: `all_reduce` and `all_gather` take
a `span` (distributed.ProcessSpan) and first gather every process's parts
over the process group, then add or join them in global shard order, so a
decode over two processes gives the one-process decode's bits.

Training (training/draft_trainer.py's tensor- and sequence-parallel forward)
differentiates through these. Their backward passes are deterministic, so
four cards give one card's gradients bit for bit:
  replicate       copies of x a device; backward: the copies' gradients
                  summed in device order in fp32 and rounded once on x's
                  device (the dual of all_reduce)
  reduce_scatter  the sum of the shards' fp32 partials, chunk c of the
                  sequence axis on devices[c] (Megatron SP after a row
                  product); backward: each chunk's gradient gathered back
                  onto each partial's device
  all_gather_seq  the sequence chunks joined on every device (SP before the
                  column products); backward: reduce_scatter of the
                  gradients, in fp32, rounded once
So a sequence-parallel layer sums the same fp32 values in the same order as
the tensor-parallel one (reduce_scatter's chunk c is all_reduce's rows of
chunk c), and gives its logits and gradients bit for bit.
A gradient that comes back from another card arrives through one of these
Functions, whose backward runs on the source's device: autograd never adds a
gradient made on another card's stream into a leaf's accumulator.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def broadcast(x, devices: Sequence[torch.device]) -> list:
    """`x` on each device of `devices`: one copy a device other than x's own
    (the same tensor where a device repeats); a value that is not a tensor
    (a host int offset) as it is."""
    if not isinstance(x, torch.Tensor):
        return [x] * len(devices)
    copies = {x.device: x}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = x.to(d, non_blocking=True)
        out.append(copies[d])
    return out


def all_reduce(partials: List[torch.Tensor], device: torch.device, dtype,
               span=None) -> torch.Tensor:
    """The sum of the shards' partials (`lax.psum`) on `device`: gathered
    there, added in shard order in fp32, rounded once to `dtype`. With a
    `span`, every process's partials in global shard order."""
    if span is not None:
        partials = span.gather(partials, device)
    total = partials[0].to(device, non_blocking=True).float()
    for p in partials[1:]:
        total = total + p.to(device, non_blocking=True).float()
    return total.to(dtype)


def all_gather(parts: List[torch.Tensor], device: torch.device, span=None) -> torch.Tensor:
    """The shards' parts concatenated on their last axis (the tiled
    `lax.all_gather` of a vocab-sharded head's logits), on `device`; with a
    `span`, every process's parts in global shard order."""
    if span is not None:
        parts = span.gather(parts, device)
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=-1)


# ------------------------------------------------------------------ training


def _copy(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.view_as(x) if x.device == device else x.to(device, non_blocking=True)


def _sum_once(grads, device, dtype):
    """Gradients summed in order in fp32 on `device`, rounded once (None
    where every gradient is None)."""
    live = [g for g in grads if g is not None]
    return all_reduce(live, device, dtype) if live else None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.device, ctx.dtype = x.device, x.dtype
        return tuple(_copy(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return _sum_once(grads, ctx.device, ctx.dtype), None


def replicate(x: torch.Tensor, devices: Sequence[torch.device]) -> tuple:
    """x on each device of `devices` (a view where it is x's own), for a
    forward that autograd runs back through: the copies' gradients are
    summed in device order in fp32 and rounded once onto x."""
    return _Replicate.apply(x, tuple(devices))


def _seq_chunks(x: torch.Tensor, m: int) -> tuple:
    S = x.shape[1]
    if S % m:
        raise ValueError(f"sequence length {S} must split evenly over {m} shards")
    return x.split(S // m, dim=1)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dtype, *parts):
        ctx.part_devices = [p.device for p in parts]
        ctx.part_dtypes = [p.dtype for p in parts]
        chunks = [_seq_chunks(p, len(devices)) for p in parts]
        return tuple(all_reduce([c[i] for c in chunks], d, dtype) for i, d in enumerate(devices))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(
            torch.cat([g.to(d, non_blocking=True) for g in grads], dim=1).to(dt)
            for d, dt in zip(ctx.part_devices, ctx.part_dtypes))


def reduce_scatter(parts: List[torch.Tensor], devices: Sequence[torch.device], dtype) -> tuple:
    """The sum of the shards' partials [B, S, ...] split on the sequence
    axis: chunk c (S / m rows of each sequence) on devices[c], each element
    summed in shard order in fp32 and rounded once to `dtype` (all_reduce,
    a chunk at a time)."""
    return _ReduceScatter.apply(tuple(devices), dtype, *parts)


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *chunks):
        ctx.chunk_devices = [c.device for c in chunks]
        ctx.dtype = chunks[0].dtype
        return tuple(torch.cat([_copy(c, d) for c in chunks], dim=1) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g in grads if g is not None]
        split = [_seq_chunks(g, len(ctx.chunk_devices)) for g in live]
        return (None,) + tuple(all_reduce([s[i] for s in split], d, ctx.dtype)
                               for i, d in enumerate(ctx.chunk_devices))


def all_gather_seq(chunks: List[torch.Tensor], devices: Sequence[torch.device]) -> tuple:
    """The sequence chunks [B, S / m, ...] joined into [B, S, ...] on each
    device of `devices`; the gradients summed back onto each chunk in device
    order, in fp32, rounded once."""
    return _AllGatherSeq.apply(tuple(devices), *chunks)


def split_seq(x: torch.Tensor, devices: Sequence[torch.device]) -> list:
    """x [B, S, ...] cut into len(devices) chunks on the sequence axis, chunk
    c on devices[c] (its gradient joins the chunks' again)."""
    return [c.to(d, non_blocking=True) for c, d in zip(_seq_chunks(x, len(devices)), devices)]
