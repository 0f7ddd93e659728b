"""Verify-phase math: Sequoia token-match acceptance (greedy branch).

Counterpart of `umbrella_tpu/speculation/verify.py`, with native gathers where
the JAX package uses one-hot selects. Everything stays on the device; the engine
reads (accept_len, eos_found, block) back once per step.
"""
from __future__ import annotations

import torch

from ..models.kv_cache import gather_compact
from ..ops import sampling as S


def accept_and_commit(ids, sampled, old_block, bitmap, parents, node_in_path, eos_arr):
    """Accept rule batched over a leading [B] axis.

    ids [B, T] speculated tree tokens, sampled [B, T] target samples, old_block
    [B, T+1] current token rows at the tree window, bitmap [T, T] bool ancestor
    closure incl. self, parents [T], node_in_path [T] (depth + 1), eos_arr [E].

    Node v is accepted iff its token matches the target sample at its parent,
    for v and every ancestor. Returns (block [B, T+1], path [B, T], alen [B],
    eos_found [B]): accepted tokens then the bonus token then the old tail; the
    sorted accepted path padded with T-1; the EOS-clamped accept length."""
    B, T = ids.shape
    dev = ids.device
    sam_par = sampled[:, parents.long()]
    accept = sam_par == ids
    accept[:, 0] = True
    anc = (bitmap[None, :, :] & accept[:, None, :]).sum(dim=2)
    path_ok = anc == node_in_path[None, :].to(anc.dtype)
    alen0 = path_ok.sum(dim=1)
    iota = torch.arange(T, device=dev)
    path = torch.sort(torch.where(path_ok, iota[None, :], T), dim=1).values
    path = torch.clamp(path, 0, T - 1)
    last = torch.where(path_ok, iota[None, :], -1).amax(dim=1)
    bonus = torch.gather(sampled, 1, last.clamp(min=0)[:, None])  # node 0 is always on the path
    acc_tokens = torch.gather(ids, 1, path)

    bidx = torch.arange(T + 1, device=dev)[None, :]
    acc_pad = torch.cat([acc_tokens, acc_tokens[:, -1:]], dim=1)
    block = torch.where(bidx < alen0[:, None], acc_pad,
                        torch.where(bidx == alen0[:, None], bonus, old_block))

    is_eos = torch.isin(block, eos_arr) & (bidx < (alen0 + 1)[:, None])
    first = torch.where(is_eos, bidx, T + 1).amin(dim=1)
    eos_found = first <= T
    alen = torch.where(eos_found, first, alen0)
    return block.to(torch.int32), path, alen.to(torch.int32), eos_found


def verify_tail(logits, kv_t, kv_d, tokens, num_nodes: int, bitmap, parents, node_in_path,
                eos_arr, *, tree_size: int):
    """Greedy-sample the target logits over the tree, run the accept rule, write
    accepted + bonus tokens into `tokens`, and compact both KV caches in place.
    Returns (accept_len, eos_found, block[tree_size + 1]) as device tensors."""
    ids = tokens[num_nodes:num_nodes + tree_size]
    sampled = S.greedy_sample(logits).to(torch.int32)
    old_block = tokens[num_nodes:num_nodes + tree_size + 1]
    block, path, accept_len, eos_found = accept_and_commit(
        ids[None], sampled[None], old_block[None], bitmap, parents, node_in_path, eos_arr)
    block, path = block[0], path[0]
    accept_len, eos_found = accept_len[0], eos_found[0]
    tokens[num_nodes:num_nodes + tree_size + 1] = block
    gather_compact(kv_t, path, num_nodes, accept_len)
    gather_compact(kv_d, path, num_nodes, accept_len)
    return accept_len, eos_found, block
