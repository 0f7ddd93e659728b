"""Verify-phase math: Sequoia token-match acceptance, greedy or stochastic.

Counterpart of `umbrella_tpu/speculation/verify.py`, with native gathers where
the JAX package uses one-hot selects and a `torch.Generator` where it threads a
`jax.random` key. Everything stays on the device: the stepwise loop reads
(accept_len, eos_found, block) back once per step, the device-resident loop
(`verify_commit` gated on its continue flag, `gated_stop`) carries num_nodes
and the stop flag on the device.
"""
from __future__ import annotations

import torch

from ..models.kv_cache import gather_compact
from ..ops import sampling as S
from ..ops.masks import read_window, write_window


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


def verify_commit(logits, tokens, num_nodes, bitmap, parents, node_in_path, eos_arr, *,
                  tree_size: int, greedy: bool = True, use_pen: bool = False, generator=None,
                  temperature=1.0, topp=1.0, penalty=1.0, topk: int = 32, cont=None):
    """Sample the target logits over the tree (argmax if `greedy`, else top-k /
    top-p at `temperature` from `generator`; with `use_pen`, after the
    repetition penalty over tokens[:num_nodes + 1]), run the accept rule and
    write accepted + bonus tokens into `tokens`. `num_nodes` is a host int or
    a 0-d device tensor; the sampling parameters are floats or device
    scalars. With `cont` (a 0-d bool device tensor) the commit is gated:
    where it is false the step accepts nothing and tokens keep their values.
    Returns (accept_len, eos_found, block[tree_size + 1], path) as device
    tensors: `path` and `accept_len` are what the KV caches' compaction
    (gather_compact) takes."""
    T = tree_size
    ids = read_window(tokens, num_nodes, T)
    if use_pen:
        logits = S.apply_repetition_penalty(logits, tokens, num_nodes + 1, penalty)
    if greedy:
        sampled = S.greedy_sample(logits).to(torch.int32)
    else:
        sampled = S.sample_top_k_top_p_rows(generator, logits, temperature, topk, topp)
    old_block = read_window(tokens, num_nodes, T + 1)
    block, path, accept_len, eos_found = accept_and_commit(
        ids[None], sampled[None], old_block[None], bitmap, parents, node_in_path, eos_arr)
    block, path = block[0], path[0]
    accept_len, eos_found = accept_len[0], eos_found[0]
    if cont is not None:
        accept_len = torch.where(cont, accept_len, 0)
    write_window(tokens, num_nodes, block, gate=cont)
    return accept_len, eos_found, block, path


def verify_tail(logits, kv_t, kv_d, tokens, num_nodes, bitmap, parents, node_in_path,
                eos_arr, **kw):
    """verify_commit, then both KV caches compacted in place (with `cont`
    false only the KV window past num_nodes is rewritten: zeroed). Returns
    (accept_len, eos_found, block[tree_size + 1]) as device tensors."""
    accept_len, eos_found, block, path = verify_commit(
        logits, tokens, num_nodes, bitmap, parents, node_in_path, eos_arr, **kw)
    gather_compact(kv_t, path, num_nodes, accept_len)
    gather_compact(kv_d, path, num_nodes, accept_len)
    return accept_len, eos_found, block


def gated_stop(num_nodes, cont, accept_len, eos_found, start, max_new, cap: int):
    """The device-resident loop's stop rule, as the JAX package's
    `gated_tail_fn` (speculation/static_engine.py) folds it into the gated
    step: num_nodes advances by the (gated) accept length, and the continue
    flag stays set unless the step found EOS, spent the token budget
    `max_new` counted from `start`, or passed the context cap. All but `cap`
    are 0-d device tensors. Returns (nn_out, cont_out)."""
    nn_out = num_nodes + accept_len
    cont_out = cont & ~eos_found & ((nn_out - start) < max_new) & (nn_out <= cap)
    return nn_out, cont_out
