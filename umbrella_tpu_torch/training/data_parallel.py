"""Data-parallel training: replicas of the train params, the batch split
evenly between them; each replica on one device, or tensor-parallel over a
row of devices (a (data, model) grid); the data axis may span processes.

The JAX package shards the batch P("data") over its mesh and lets GSPMD sum
the gradients (`draft/train_draft.py --dp`, and `make_mesh(model=m,
data=d)` under `make_train_step` for the grid). Here one process drives the
replicas of its rows. A row is one device (a replica of the plain train
tree) or m devices (a replica sharded by parallel/mesh.shard_train_params,
whose forward runs the model axis; training/draft_trainer.py); a device may
repeat, so one card, or the CPU, can hold several replicas or shards. The
params and the optimizer live on the first row (`state.params`). Each step
every replica runs the forward and backward of its rows of the batch over
its own copy of the params; each leaf's gradients are summed onto the
first row's leaf in fp32, in replica order, with
`parallel/collectives.all_reduce`; one AdamW update runs there, and the new
params are copied back to each other replica. Each replica's loss is
weighted by its share of the batch's targets (its masked-in targets under
`loss_mask`), so the summed gradient is the whole batch's.

Across processes (`span`, parallel/distributed.span(): the JAX worker's
data parallelism over DCN), every process takes the same global batch and
holds the replicas of its rows, global replicas [rank x rows, (rank + 1) x
rows); the sums gather every replica's gradient over the process group and
add them in global replica order, so every process makes the same update,
and the one-process grid's, bit for bit.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..models.llama import StaticModelArgs
from ..parallel.collectives import all_reduce
from .draft_trainer import (Optimizer, TrainState, causal_lm_loss, map_params, new_leaf,
                            optimizer_update, param_leaves)


def _weights(input_ids: torch.Tensor, loss_mask, dp: int) -> list:
    """Each replica's share of the batch's loss: its rows' share of the
    targets, or of the masked-in targets (at least one, as the loss's own
    denominator)."""
    if loss_mask is None:
        return [1.0 / dp] * dp
    per = [float(m[:, 1:].sum()) for m in loss_mask.chunk(dp)]
    total = max(sum(per), 1.0)
    return [max(n, 1.0) / total for n in per]


def _row(entry) -> list:
    """A grid row's devices: one device, or a sequence of them."""
    if isinstance(entry, (list, tuple)):
        return [torch.device(d) for d in entry]
    return [torch.device(entry)]


def place_params(params: dict, row: Sequence[torch.device]) -> dict:
    """A new replica of `params` (new leaves) on a row of devices: shard s of
    a tensor-parallel tree's "tp_shards", or of a block of shards such as
    models/moe.ShardedExperts (its device field updated), on row[s];
    everything else on row[0]."""
    def to(d):
        return lambda t: new_leaf(t, d)

    out = {}
    for k, v in params.items():
        if k == "tp_shards":
            out[k] = tuple(map_params(to(d), sh) for sh, d in zip(v, row))
        elif isinstance(v, dict):
            out[k] = place_params(v, row)
        elif hasattr(v, "shards"):
            out[k] = type(v)(map_params(to(d), sh)._replace(device=d)
                             for sh, d in zip(v.shards, row))
        else:
            out[k] = map_params(to(row[0]), v)
    return out


def update_from_replicas(state: TrainState, grads: list, replicas: Sequence[dict], loss,
                         span=None):
    """One optimizer update of `state.params` from the replicas' gradients
    (`grads[r]`: replica r's, one a leaf in param_leaves order), each leaf's
    summed onto the master's device in replica order in fp32 (every
    process's replicas in global order with a `span`); the new params are
    copied into `replicas` (the ones other than the master)."""
    master = list(param_leaves(state.params))
    with torch.no_grad():
        for j, p in enumerate(master):
            p.grad = all_reduce([g[j] for g in grads], p.device, p.dtype, span)
    state, loss = optimizer_update(state, loss)
    with torch.no_grad():
        for tree in replicas:
            for r, p in zip(param_leaves(tree), master):
                r.copy_(p)
    return state, loss


def make_dp_train_step(args: StaticModelArgs, optimizer: Optimizer, devices: Sequence,
                       sequence_parallel: bool = False, span=None):
    """train_step(state, input_ids [B, S], loss_mask=None) -> (state, loss)
    over one replica a row of `devices` (a row: a device, or the devices of
    a tensor-parallel replica), times span.size processes with a `span`;
    `state.params` lives on the first row, B must divide evenly."""
    del optimizer  # the state carries the built optimizer
    rows = [_row(e) for e in devices]
    n_local = len(rows)
    procs, rank = (1, 0) if span is None else (span.size, span.rank)
    replicas = {}  # local row index -> the replica's params on it (a row unlike the first)

    def replica(params, r):
        if rows[r] == rows[0]:  # the same devices hold the same values: share them
            return params
        if r not in replicas:
            replicas[r] = place_params(params, rows[r])
        return replicas[r]

    def train_step(state: TrainState, input_ids, loss_mask=None):
        dp = n_local * procs
        if input_ids.shape[0] % dp:
            raise ValueError(f"batch {input_ids.shape[0]} must split evenly over dp={dp} "
                             "replicas")
        mine = slice(rank * n_local, (rank + 1) * n_local)
        ids_rows = input_ids.chunk(dp)[mine]
        masks = loss_mask.chunk(dp)[mine] if loss_mask is not None else [None] * n_local
        weights = _weights(input_ids, loss_mask, dp)[mine]
        # every replica's params and rows on its devices before any replica
        # computes: a copy between cards waits for the source card's queued work
        inputs = [(replica(state.params, r), ids.to(row[0]),
                   None if mask is None else mask.to(row[0]))
                  for r, (row, ids, mask) in enumerate(zip(rows, ids_rows, masks))]
        grads, losses = [], []
        for (params, ids, mask), w in zip(inputs, weights):
            loss = w * causal_lm_loss(params, args, ids, mask, sequence_parallel)
            grads.append(torch.autograd.grad(loss, list(param_leaves(params))))
            losses.append(loss.detach())
        return update_from_replicas(state, grads, list(replicas.values()),
                                    all_reduce(losses, rows[0][0], torch.float32, span), span)

    return train_step
