"""Embedding lookup.

The JAX package replaces gathers with one-hot selects, a workaround for its TPU
runtime; here indexing is native. The lookup is the gather kernel (the port of
the Pallas `embed_gather`) on a CUDA table, its plain version (row indexing)
on a CPU one, under autograd either way (`embed_gather_trainable`): a table
that requires grad gets its gradient from the same backward on both.
"""
from __future__ import annotations

import torch

from .kernels.embed_gather import embed_gather_trainable


def embed_lookup(embed: torch.Tensor, input_ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """embed[input_ids] cast to dtype (default embed.dtype); [V, H] x [S] -> [S, H]."""
    return embed_gather_trainable(embed, input_ids).to(dtype or embed.dtype)
