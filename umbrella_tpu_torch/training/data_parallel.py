"""Data-parallel training: replicas of the train params over a list of
devices, the batch split evenly between them.

The JAX package shards the batch P("data") over its mesh and lets GSPMD sum
the gradients (`draft/train_draft.py --dp`). Here one process drives one
replica per entry of `devices` (a device may repeat: one card, or the CPU,
can hold several replicas). The params and the optimizer live on the first
device. Each step every replica runs the forward and backward of its rows
over its own copy of the params; the gradients are summed onto the first
device in fp32, in device order, with `parallel/collectives.all_reduce`; one
AdamW update runs there, and the new params are copied back to each other
device's replica. Each replica's loss is weighted by its share of the
batch's targets (its masked-in targets under `loss_mask`), so the summed
gradient is the whole batch's.

Only the data axis is ported: tensor- and sequence-parallel training over a
model axis are ROADMAP A.5's next step.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..models.llama import StaticModelArgs
from ..parallel.collectives import all_reduce, broadcast
from .draft_trainer import (Optimizer, TrainState, causal_lm_loss, map_params,
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


def make_dp_train_step(args: StaticModelArgs, optimizer: Optimizer, devices: Sequence,
                       sequence_parallel: bool = False):
    """train_step(state, input_ids [B, S], loss_mask=None) -> (state, loss)
    over len(devices) replicas; `state.params` lives on devices[0], B must
    divide evenly."""
    del optimizer  # the state carries the built optimizer
    devices = [torch.device(d) for d in devices]
    replicas = {}  # device other than devices[0] -> the replica's params on it

    def replica(params, device):
        if device == devices[0]:
            return params
        if device not in replicas:
            replicas[device] = map_params(
                lambda t: broadcast(t.detach(), [device])[0].clone().requires_grad_(
                    t.requires_grad), params)
        return replicas[device]

    def train_step(state: TrainState, input_ids, loss_mask=None):
        dp = len(devices)
        if input_ids.shape[0] % dp:
            raise ValueError(f"batch {input_ids.shape[0]} must split evenly over dp={dp} "
                             "replicas")
        masks = loss_mask.chunk(dp) if loss_mask is not None else [None] * dp
        # every replica's params and rows on its device before any replica
        # computes: a copy between cards waits for the source card's queued work
        inputs = [(replica(state.params, dev), ids.to(dev),
                   None if mask is None else mask.to(dev))
                  for dev, ids, mask in zip(devices, input_ids.chunk(dp), masks)]
        grads, losses = [], []
        for (params, ids, mask), w in zip(inputs, _weights(input_ids, loss_mask, dp)):
            loss = w * causal_lm_loss(params, args, ids, mask, sequence_parallel)
            leaves = list(param_leaves(params))
            grads.append(torch.autograd.grad(loss, leaves))
            losses.append(loss.detach())
        master = list(param_leaves(state.params))
        with torch.no_grad():
            for j, p in enumerate(master):
                p.grad = all_reduce([g[j] for g in grads], devices[0], p.dtype)
        state, loss = optimizer_update(state, all_reduce(losses, devices[0], torch.float32))
        with torch.no_grad():
            for params in replicas.values():
                for r, p in zip(param_leaves(params), master):
                    r.copy_(p)
        return state, loss

    return train_step
