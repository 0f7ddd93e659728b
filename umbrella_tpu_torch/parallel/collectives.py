"""The collectives of the tensor- and expert-parallel forwards.

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


def all_reduce(partials: List[torch.Tensor], device: torch.device, dtype) -> torch.Tensor:
    """The sum of the shards' partials (`lax.psum`) on `device`: gathered
    there, added in shard order in fp32, rounded once to `dtype`."""
    total = partials[0].to(device, non_blocking=True).float()
    for p in partials[1:]:
        total = total + p.to(device, non_blocking=True).float()
    return total.to(dtype)


def all_gather(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The shards' parts concatenated on their last axis (the tiled
    `lax.all_gather` of a vocab-sharded head's logits), on `device`."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=-1)
