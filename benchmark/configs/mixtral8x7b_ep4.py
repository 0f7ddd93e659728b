"""Builder of `mixtral8x7b_ep4.json`: the bf16 Mixtral target at all its
layers with its experts split over `expert_parallel` cards, as the port's
`shard_runtime_ep` lays them out (card s holds experts s * E / m ..
(s + 1) * E / m - 1 of every layer; the rest of the target, the draft and
both caches on the run's card). Each card's experts are drawn there from a
generator of its own, seeded from the run's seed: the whole stack does not
fit one card. The port gets a `moe_runtime` whose layers hold
`expert_shards`; the reference reads the same tensors, each expert where it
lies. On the CPU every shard is the CPU."""
from __future__ import annotations

import types

import numpy as np
import torch

from benchmark.configs import mixtral8x7b
from benchmark.configs.mixtral8x7b import _glorot

shapes = mixtral8x7b.shapes


def shard_devices(device, m: int) -> list:
    """cuda:i .. cuda:i+m-1 from the run's cuda:i, or the CPU m times."""
    if device.type != "cuda":
        return [device] * m
    return [torch.device("cuda", (device.index or 0) + s) for s in range(m)]


def build(cfg: dict, seed: int, device, max_length: int):
    from umbrella_tpu_torch.models.moe import ExpertShard, ShardedExperts

    m = cfg["bench"]["expert_parallel"]
    n, H, I, E = (cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"],
                  cfg["num_local_experts"])
    per = E // m
    gen = torch.Generator(device=device).manual_seed(int(seed))
    layers = mixtral8x7b.attention(cfg, gen, device)
    shards = []
    for s, d in enumerate(shard_devices(device, m)):
        g = torch.Generator(device=d).manual_seed(
            int(np.random.SeedSequence([int(seed), 1, s]).generate_state(1)[0]))
        shards.append(ExpertShard(d, _glorot(g, d, (n, per, H, I)), _glorot(g, d, (n, per, H, I)),
                                  _glorot(g, d, (n, per, I, H))))
    layers["expert_shards"] = ShardedExperts(shards)
    params, tgt = mixtral8x7b.target(cfg, gen, device, layers, max_length)

    def of_layer(i, field):  # layer i's experts in expert order, each on its card
        return [getattr(sh, field)[i, j] for sh in shards for j in range(per)]

    experts = [tuple(of_layer(i, f) for f in ("gate", "up", "down")) for i in range(n)]
    return types.SimpleNamespace(target=tgt, draft=mixtral8x7b.draft(cfg, gen, device, max_length),
                                 reference=mixtral8x7b.reference(cfg, params, experts),
                                 vocab=cfg["vocab_size"])
