"""Embedding lookup.

The JAX package replaces gathers with one-hot selects, a workaround for its TPU
runtime; here indexing is native. On a CUDA table the lookup is the hand-written
gather kernel (the port of the Pallas `embed_gather`); on the CPU it is row
indexing.
"""
from __future__ import annotations

import torch

from .kernels.embed_gather import embed_gather


def embed_lookup(embed: torch.Tensor, input_ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """embed[input_ids] cast to dtype (default embed.dtype); [V, H] x [S] -> [S, H]."""
    dtype = dtype or embed.dtype
    if embed.is_cuda:
        return embed_gather(embed, input_ids).to(dtype)
    return embed[input_ids.long()].to(dtype)
