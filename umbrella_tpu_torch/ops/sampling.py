"""Greedy sampling and draft top-k expansion.

Counterparts of `greedy_sample` and `draft_topk` in `umbrella_tpu/ops/sampling.py`.
The stochastic samplers (top-k/top-p, repetition penalty) come with ROADMAP
queue A item 7.
"""
from __future__ import annotations

import torch


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax (first index among ties)."""
    return torch.argmax(logits, dim=-1)


def draft_topk(logits: torch.Tensor, k: int, recall: float = 1.0):
    """(values, indices) of the exact per-row top-k, sorted in descending order.

    The JAX package maps recall < 1 to `lax.approx_max_k`, which has no torch
    counterpart; the exact top-k is used for every recall. That changes draft
    proposals only, never committed tokens."""
    del recall
    return torch.topk(logits, k, dim=-1, largest=True, sorted=True)
