"""Sampling primitives: greedy, draft top-k expansion, and the stochastic
verify-time samplers.

Counterparts of `umbrella_tpu/ops/sampling.py`. Where the JAX package threads a
`jax.random` key, these take an explicit `torch.Generator` on the logits'
device; the two give different random numbers for one seed, so stochastic
results are compared as distributions, not token by token. Temperature, top-p,
the penalty and the valid length may be Python numbers or device tensors; the
engines' steps pass their persistent device scalars (`torch.as_tensor` of a
tensor on its own device is the tensor itself, so a step copies nothing from
the host and a CUDA graph replays it with new values).
"""
from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


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


def apply_repetition_penalty(logits: torch.Tensor, prev_tokens: torch.Tensor, valid_len,
                             penalty) -> torch.Tensor:
    """HF-style penalty: the logits of tokens seen in prev_tokens[..., :valid_len]
    are divided by `penalty` where positive, multiplied where negative.

    logits [..., S, V] fp32, prev_tokens [..., P]; valid_len and penalty are
    scalars or tensors of the leading shape (one per slot)."""
    vocab = logits.shape[-1]
    pos = torch.arange(prev_tokens.shape[-1], device=prev_tokens.device)
    valid_len = torch.as_tensor(valid_len, device=prev_tokens.device)
    ids = torch.where(pos < valid_len[..., None], prev_tokens.long(), vocab)
    seen = torch.zeros((*prev_tokens.shape[:-1], vocab + 1), dtype=torch.bool,
                       device=logits.device)
    seen.scatter_(-1, ids, True)
    penalty = torch.as_tensor(penalty, dtype=logits.dtype, device=logits.device)[..., None, None]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen[..., None, :vocab], penalized, logits)


def _nucleus_keep(sorted_probs: torch.Tensor, top_p) -> torch.Tensor:
    """Keep sorted index i iff the mass before it is below top_p (the first
    entry always stays)."""
    return (torch.cumsum(sorted_probs, dim=-1) - sorted_probs) < top_p


def _renorm_from_sorted(probs: torch.Tensor, top: torch.Tensor, top_p) -> torch.Tensor:
    keep = _nucleus_keep(top, top_p)
    thresh = torch.where(keep, top, torch.inf).amin(dim=-1, keepdim=True)
    kept = torch.where(probs >= thresh, probs, 0.0)
    return kept / kept.sum(dim=-1, keepdim=True)


def top_p_renorm_probs(probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """Zero the tail outside the top-p nucleus (the smallest set of tokens whose
    mass exceeds top_p, the argmax always kept) and renormalize."""
    return _renorm_from_sorted(probs, torch.sort(probs, dim=-1, descending=True).values, top_p)


def top_p_renorm_after_topk(probs: torch.Tensor, top_p, k: int) -> torch.Tensor:
    """top_p_renorm_probs for distributions with at most k nonzero entries (after
    a top-k filter): the threshold needs only the k largest probabilities."""
    return _renorm_from_sorted(probs, torch.topk(probs, k, dim=-1).values, top_p)


def sample_top_k_top_p_rows(generator: torch.Generator, logits: torch.Tensor, temperature,
                            topk: int, topp) -> torch.Tensor:
    """One token per row of logits [R, V] from the top-k, top-p distribution at
    `temperature` (each a scalar or [R]).

    One exact top-k over the vocabulary; the temperature softmax, the nucleus
    and a Gumbel-max draw then run on the [R, k] values, and the token is read
    from the top-k indices. The distribution equals softmax over the kept set.
    Random numbers come from `generator` (on the logits' device): no host read."""
    dev = logits.device
    t = torch.as_tensor(temperature, dtype=torch.float32, device=dev).reshape(-1, 1)
    p = torch.as_tensor(topp, dtype=torch.float32, device=dev).reshape(-1, 1)
    vals, idx = torch.topk(logits, topk, dim=-1)  # sorted descending
    probs = torch.softmax(vals / t, dim=-1)
    keep = _nucleus_keep(probs, p)
    logp = torch.where(keep, torch.log(probs + 1e-20), NEG_INF)
    u = torch.rand(logp.shape, generator=generator, device=dev, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    j = torch.argmax(logp + gumbel, dim=-1, keepdim=True)
    return torch.gather(idx, -1, j)[..., 0].to(torch.int32)


def find_first_in_set(tokens: torch.Tensor, eos_ids: torch.Tensor, valid_len) -> torch.Tensor:
    """Index of the first of tokens[:valid_len] that is in eos_ids, else -1 (a
    0-d device tensor)."""
    n = tokens.shape[0]
    pos = torch.arange(n, device=tokens.device)
    is_eos = torch.isin(tokens, eos_ids) & (pos < valid_len)
    first = torch.where(is_eos, pos, n).amin()
    return torch.where(first == n, -1, first)
