"""Mixture-of-experts (Mixtral-style) llama variant.

Counterpart of `umbrella_tpu/models/moe.py`. Experts are stacked per layer:
router [n, H, E], expert_gate / expert_up [n, E, H, I], expert_down
[n, E, I, H]. Routing is top-k softmax gating with a dense one-hot combine, as
in the JAX package: every expert computes every token and the combine weights
zero the pairs that were not routed. Attention is the llama KV-cache path
(llama.llama_attention: the flash kernel, rope, in-place cache writes).

Numerics follow the JAX package: the router product is fp32; the top-k takes
ties by the lower expert index (a stable descending sort; `torch.topk` on CUDA
promises no order among equal values); the top-k weights are normalised by
max(sum, 1e-9) and the one-hot combine is built in x's dtype; the expert
products run in the params' dtype (in bf16 their outputs are bf16), not
through llama._linear's fp32 upcast, which at Mixtral widths would copy every
expert of a layer to fp32 on every forward.

Expert parallelism (`shard_runtime_ep`, the JAX package's `moe_param_specs`
/ `shard_params_ep` / `shard_runtime_ep`): each shard device holds E / m
experts of expert_gate / up / down, under the layer key "expert_shards"
(ShardedExperts). The JAX package partitions its per-expert einsums with
GSPMD and inserts one psum for the combine; here `experts` runs each
shard's experts over every token on its device (dense dispatch, as
unsharded) and combines them with parallel/collectives.all_reduce. The
attention, the router, the norms and the KV cache stay on the first shard's
device, which is the runtime's (GSPMD computes them replicated: the same
values). Every forward of the family takes a sharded runtime as it is.

Training (`_moe_layer`, `moe_train_forward`, `make_moe_train_step`): the
training path's dense attention (training/draft_trainer.py) and the same
routing; the gradient reaches the router through the softmax and the
normalised top-k weights, not through the one-hot (nor the aux loss's
routed fractions), as in the JAX package. Expert-parallel training
(`shard_params_ep` over a train tree, the JAX package's `shard_params_ep`):
each ExpertShard's stacks are leaves that require grad on its device
(`param_leaves` and `map_params` walk ShardedExperts' shards), and
`combine` runs back through parallel/collectives.replicate and all_reduce,
so a shard's gradients are made on its own card and the shared input's are
summed in shard order. A data axis (`moe_grid_forward`, and
`make_moe_train_step(devices=rows)`; the JAX package's (data, expert) mesh
with the batch sharded on 'data'): the batch's rows are split over replicas,
each on its row of devices (EP-sharded over it, or whole on one device); the
logits are gathered on the first row, and the aux loss is the whole batch's,
each layer's routing sums added over the replicas in order before its
product (a mean of per-replica aux losses would not be it).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.norms import rms_norm
from ..ops.rope import rope_params
from ..ops.select import embed_lookup
from ..training.draft_trainer import (_batched_attention, causal_mask, embed_batch, head_logits,
                                      lm_loss, map_params, new_leaf, optimizer_update,
                                      param_leaves)
from ..utils import device_scope, resolve_device
from .kv_cache import KVCache
from .llama import StaticModelArgs, kv_limit_of, llama_attention, lm_head_logits


def init_moe_llama_params(cfg: ModelConfig, generator: torch.Generator, n_experts: int,
                          dtype=torch.float32, device="cpu") -> dict:
    """Random params (Glorot-normal weights, unit norms), built on `device`.
    Random numbers come from `generator`; they are not JAX's."""
    n = cfg.num_hidden_layers
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    D = cfg.resolved_head_dim
    Hq = cfg.num_attention_heads * D
    KV = cfg.num_key_value_heads * D
    E = n_experts

    def init(*shape):
        std = (2.0 / (shape[-2] + shape[-1])) ** 0.5
        if len(shape) < 3:
            return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)
        # one matrix at a time: an fp32 layer of Mixtral experts would be 1.9 GB
        out = torch.empty(shape, dtype=dtype, device=device)
        for idx in itertools.product(*map(range, shape[:-2])):
            out[idx] = torch.randn(shape[-2:], generator=generator, device=device) * std
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "input_norm": ones(n, H), "post_norm": ones(n, H),
        "wq": init(n, H, Hq), "wk": init(n, H, KV), "wv": init(n, H, KV), "wo": init(n, Hq, H),
        "router": init(n, H, E),
        "expert_gate": init(n, E, H, I), "expert_up": init(n, E, H, I),
        "expert_down": init(n, E, I, H),
    }
    params = {"embed": init(V, H), "final_norm": ones(H), "layers": layers,
              **rope_params(cfg, device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init(H, V)
    return params


def top_k_lowest_index(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, equal values
    taken in index order (`lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(lw: dict, x: torch.Tensor, top_k: int):
    """Router probabilities [..., E] (fp32) and the dense combine weights
    [..., E] in x.dtype (the normalised top-k weights, zero elsewhere)."""
    router = lw["router"]
    E = router.shape[-1]
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_vals, top_idx = top_k_lowest_index(probs, top_k)
    top_vals = top_vals / torch.clamp(top_vals.sum(dim=-1, keepdim=True), min=1e-9)
    onehot = (top_idx[..., None] == torch.arange(E, device=x.device)).to(x.dtype)
    return probs, onehot, (onehot * top_vals[..., None].to(x.dtype)).sum(dim=-2)


class ExpertShard(NamedTuple):
    """One expert-parallel shard's experts, on `device`: a block of E / m
    consecutive experts ([n, E / m, H, I] gate and up, [n, E / m, I, H] down;
    one layer's when indexed)."""
    device: torch.device
    gate: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor


class ShardedExperts:
    """A layer block's experts split over shard devices, in expert order
    (the layer key "expert_shards" of an expert-parallel runtime). Indexing
    by a layer, or a slice of layers, indexes every shard's stacks, so the
    forwards' `{k: v[i] for k, v in layers.items()}` gives a layer its
    experts on every shard."""

    def __init__(self, shards: Sequence[ExpertShard]):
        self.shards = tuple(shards)

    def __getitem__(self, i) -> "ShardedExperts":
        return ShardedExperts(ExpertShard(s.device, s.gate[i], s.up[i], s.down[i])
                              for s in self.shards)

    @property
    def devices(self) -> tuple:
        return tuple(s.device for s in self.shards)

    def combine(self, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """`experts` of one layer over its shards: each shard's experts over
        every row of x [N, H] and their weighted sum in fp32 ([N, E] weights,
        the shard's block of columns), on the shard's device; the partials
        summed on x's device in shard order and rounded once to x.dtype."""
        from ..parallel.collectives import all_reduce, broadcast, replicate

        # under autograd, copies whose gradients add up in shard order
        copy = replicate if torch.is_grad_enabled() else broadcast
        parts, first = [], 0
        for sh, xs, ws in zip(self.shards, copy(x, self.devices), copy(weights, self.devices)):
            n = sh.gate.shape[0]
            with device_scope(sh.device):
                g = torch.matmul(xs[None], sh.gate)  # [E / m, N, H]
                y = torch.matmul(F.silu(g) * torch.matmul(xs[None], sh.up), sh.down)
                parts.append(torch.einsum("enh,ne->nh", y.float(),
                                          ws[:, first:first + n].float()))
            first += n
        return all_reduce(parts, x.device, x.dtype)


def experts(lw: dict, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_e weights[..., e] * down_e(silu(gate_e(x)) * up_e(x)) over every
    expert, x [..., H] in the params' dtype -> [..., H]. An expert-parallel
    layer's experts run on their shards (ShardedExperts.combine)."""
    shape = x.shape
    sharded = lw.get("expert_shards")
    if sharded is not None:
        return sharded.combine(x.reshape(-1, shape[-1]),
                               weights.reshape(-1, weights.shape[-1])).reshape(shape)
    xf = x.reshape(1, -1, shape[-1])
    g = torch.matmul(xf, lw["expert_gate"])  # [E, N, I]
    u = torch.matmul(xf, lw["expert_up"])
    y = torch.matmul(F.silu(g) * u, lw["expert_down"])  # [E, N, H]
    w = weights.reshape(-1, weights.shape[-1]).to(y.dtype)  # [N, E]
    return torch.einsum("enh,ne->nh", y, w).reshape(shape)


def _routing_sums(probs: torch.Tensor, onehot: torch.Tensor) -> tuple:
    """(how many of the rows' top-k picks went to each expert, each expert's
    router probability summed over the rows): two fp32 [E]."""
    E = probs.shape[-1]
    return (onehot.sum(dim=-2).float().reshape(-1, E).sum(dim=0),
            probs.reshape(-1, E).sum(dim=0))


def _aux_of(sums, n_rows: int) -> torch.Tensor:
    """The Switch-style aux loss of one layer from its routing sums over
    n_rows rows: E * sum_e (fraction routed to e * mean prob of e)."""
    routed, prob = sums
    return routed.shape[0] * ((routed / n_rows) * (prob / n_rows)).sum()


def _moe_mlp_sums(lw: dict, x: torch.Tensor, top_k: int):
    """(dense-dispatch top-k MoE of x [..., H], the routing sums)."""
    probs, onehot, weights = route(lw, x, top_k)
    return experts(lw, x, weights), _routing_sums(probs, onehot)


def moe_mlp(lw: dict, x: torch.Tensor, top_k: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch top-k MoE over x [B, S, H]. Returns (out, aux_loss), the
    aux loss Switch-style: E * sum_e (fraction routed to e * mean prob of e)."""
    out, sums = _moe_mlp_sums(lw, x, top_k)
    return out, _aux_of(sums, x.shape[0] * x.shape[1])


def moe_block(args: StaticModelArgs, lw: dict, hidden: torch.Tensor, attend_out, top_k: int):
    """The residual MoE half of a layer: hidden + attention, then + moe_mlp."""
    hidden = hidden + attend_out
    x = rms_norm(hidden, lw["post_norm"], args.rms_eps)
    return hidden + experts(lw, x, route(lw, x, top_k)[2])


def moe_decode_forward(params: dict, args: StaticModelArgs, kv: KVCache,
                       input_ids: torch.Tensor,  # [S]
                       position_ids: torch.Tensor,  # [S]
                       attn_mask: torch.Tensor,  # [S, L] bool
                       write_offset, top_k: int = 2) -> Tuple[torch.Tensor, KVCache]:
    """The engines' forward for the MoE family: (fp32 logits [S, V], kv updated
    in place). `write_offset` is a host int or a 0-d device tensor."""
    inv_freq, rope_scale = params["rope_inv_freq"], params["rope_scale"]
    kv_limit = kv_limit_of(write_offset, input_ids.shape[0], kv)
    hidden = embed_lookup(params["embed"], input_ids, params["final_norm"].dtype)
    for i in range(args.n_layers):
        lw = {k: v[i] for k, v in params["layers"].items()}
        x = rms_norm(hidden, lw["input_norm"], args.rms_eps)
        attn_out, kv = llama_attention(args, lw, x, kv, i, position_ids, attn_mask,
                                       write_offset, inv_freq, rope_scale, kv_limit)
        hidden = moe_block(args, lw, hidden, attn_out, top_k)
    hidden = rms_norm(hidden, params["final_norm"], args.rms_eps)
    return lm_head_logits(params, hidden), kv


def moe_params_from_hf_state_dict(sd, cfg: ModelConfig, dtype=torch.float32,
                                  n_layers: Optional[int] = None, device="cpu") -> dict:
    """The stacked MoE tree from HF Mixtral tensors: per-expert
    `block_sparse_moe.experts.{e}.w{1,2,3}.weight` [out, in] stack to
    [layer, E, in, out], the router `block_sparse_moe.gate.weight` [E, H] to
    [layer, H, E]. Each tensor is cast on `device`."""
    from .weights import fetch, stack_layers, trim_vocab_rows

    n = n_layers if n_layers is not None else cfg.num_hidden_layers
    E = cfg.num_local_experts
    if not E:
        raise ValueError("MoE checkpoint requires num_local_experts in config.json")
    P = "model.layers.{}."

    def get(name):
        return fetch(sd, name, device, torch.float32).to(dtype)

    def linear(name):
        return stack_layers(n, lambda i: get((P + name).format(i)).T)

    def vec(name):
        return stack_layers(n, lambda i: get((P + name).format(i)))

    def expert_stack(w):
        return stack_layers(n, lambda i: stack_layers(
            E, lambda e: get((P + f"block_sparse_moe.experts.{e}.{w}.weight").format(i)).T))

    layers = {
        "input_norm": vec("input_layernorm.weight"),
        "post_norm": vec("post_attention_layernorm.weight"),
        "wq": linear("self_attn.q_proj.weight"),
        "wk": linear("self_attn.k_proj.weight"),
        "wv": linear("self_attn.v_proj.weight"),
        "wo": linear("self_attn.o_proj.weight"),
        "router": linear("block_sparse_moe.gate.weight"),
        "expert_gate": expert_stack("w1"),
        "expert_down": expert_stack("w2"),
        "expert_up": expert_stack("w3"),
    }
    params = {
        "embed": trim_vocab_rows(get("model.embed_tokens.weight"), cfg.vocab_size).contiguous(),
        "final_norm": get("model.norm.weight"),
        "layers": layers,
        **rope_params(cfg, device=device),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = trim_vocab_rows(get("lm_head.weight"), cfg.vocab_size).T.contiguous()
    return params


def load_moe_params(path: str, cfg: ModelConfig, dtype=torch.float32, n_layers=None,
                    device="cpu") -> dict:
    """HF Mixtral-format checkpoint directory -> the stacked MoE tree on `device`."""
    from .weights import read_state_dict

    with read_state_dict(path) as sd:
        return moe_params_from_hf_state_dict(sd, cfg, dtype, n_layers=n_layers, device=device)


def shard_runtime_ep(runtime, devices: Sequence):
    """Expert-shard an MoE runtime in place over `devices`, one shard per
    entry (a device may repeat); returns the runtime. Shard s holds experts
    [s * E / m, (s + 1) * E / m) of every layer on devices[s] (a view where
    that is the runtime's own device); everything else moves to devices[0],
    which becomes the runtime's device."""
    devices = [torch.device(d) for d in devices]
    if runtime.family != "moe":
        raise ValueError("expert_parallel requires an MoE (mixtral-family) runtime; got family "
                         f"'{runtime.family}'")
    if runtime.shard_devices is not None:
        raise ValueError(f"runtime is already sharded over {runtime.shard_devices}")
    layers = dict(runtime.params["layers"])
    E, m = layers["expert_gate"].shape[1], len(devices)
    if E % m:
        raise ValueError(f"num_local_experts={E} must be divisible by expert_parallel={m}")
    stacks = [layers.pop(k) for k in ("expert_gate", "expert_up", "expert_down")]
    per = E // m
    shards = [ExpertShard(d, *(t[:, s * per:(s + 1) * per].to(d) for t in stacks))
              for s, d in enumerate(devices)]
    del stacks
    params = {k: (v.to(devices[0]) if isinstance(v, torch.Tensor) else v)
              for k, v in runtime.params.items() if k != "layers"}
    params["layers"] = {k: v.to(devices[0]) for k, v in layers.items()}
    params["layers"]["expert_shards"] = ShardedExperts(shards)
    runtime.params = params
    runtime.device = devices[0]
    return runtime


def moe_runtime(cfg: ModelConfig, params: dict, max_length: int, dtype=torch.float32,
                top_k: int = 2, device="cuda"):
    """ModelRuntime of the MoE family over `params` (already on `device`),
    routing `top_k` experts a token (the runtime's config says so)."""
    from .auto_model import ModelRuntime

    if top_k != cfg.num_experts_per_tok:
        cfg = dataclasses.replace(cfg, num_experts_per_tok=top_k)
    return ModelRuntime(cfg, params, max_length, dtype=dtype, family="moe",
                        n_layers=params["layers"]["router"].shape[0],
                        device=resolve_device(device))


def _moe_layer(args: StaticModelArgs, lw: dict, hidden, inv_freq, rope_scale, positions, mask,
               top_k: int):
    """One MoE layer over [B, S, H] without a KV cache: (hidden, the routing
    sums)."""
    hidden = _batched_attention(args, lw, hidden, inv_freq, rope_scale, positions, mask)
    mlp, sums = _moe_mlp_sums(lw, rms_norm(hidden, lw["post_norm"], args.rms_eps), top_k)
    return hidden + mlp, sums


def _moe_forward_sums(params: dict, args: StaticModelArgs, input_ids: torch.Tensor, top_k: int):
    """(fp32 logits [B, S, V], each layer's routing sums)."""
    S = input_ids.shape[1]
    hidden = embed_batch(params, input_ids)
    positions = torch.arange(S, device=hidden.device)
    mask = causal_mask(S, hidden.device)
    layers = params["layers"]
    sums = []
    for i in range(layers["input_norm"].shape[0]):
        lw = {k: v[i] for k, v in layers.items()}
        hidden, layer_sums = _moe_layer(args, lw, hidden, params["rope_inv_freq"],
                                        params["rope_scale"], positions, mask, top_k)
        sums.append(layer_sums)
    return head_logits(params, args, hidden), sums


def _aux_loss(sums: list, n_rows: int, device) -> torch.Tensor:
    """The layers' aux losses summed in layer order, / n_layers."""
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for layer_sums in sums:
        aux = aux + _aux_of(layer_sums, n_rows)
    return aux / len(sums)


def moe_train_forward(params: dict, args: StaticModelArgs, input_ids: torch.Tensor,
                      top_k: int = 2):
    """Causal forward over [B, S] -> (fp32 logits [B, S, V], the aux loss
    summed over layers / n_layers)."""
    logits, sums = _moe_forward_sums(params, args, input_ids, top_k)
    return logits, _aux_loss(sums, input_ids.numel(), logits.device)


def moe_grid_forward(replicas: Sequence[dict], args: StaticModelArgs, input_ids: torch.Tensor,
                     top_k: int = 2):
    """moe_train_forward with a data axis: input_ids' rows split evenly over
    `replicas` (train trees, each on its own devices), each running its
    rows. Returns (the logits [B, S, V] on the first replica's device, the
    aux loss of the whole batch: each layer's routing sums added over the
    replicas in order, in fp32)."""
    from ..parallel.collectives import all_reduce

    dp = len(replicas)
    if input_ids.shape[0] % dp:
        raise ValueError(f"batch {input_ids.shape[0]} must split evenly over dp={dp} replicas")
    outs = [_moe_forward_sums(p, args, ids.to(p["embed"].device), top_k)
            for p, ids in zip(replicas, input_ids.chunk(dp))]
    dev0 = outs[0][0].device
    logits = torch.cat([o[0].to(dev0) for o in outs])
    sums = [tuple(all_reduce([o[1][i][j] for o in outs], dev0, torch.float32) for j in (0, 1))
            for i in range(len(outs[0][1]))]
    return logits, _aux_loss(sums, input_ids.numel(), dev0)


def shard_params_ep(params: dict, devices: Sequence) -> dict:
    """A train tree (init_moe_llama_params', leaves that may require grad)
    expert-sharded over `devices`, one shard an entry (a device may repeat;
    the JAX package's P('expert') on the expert axis): new leaves, shard s's
    block of E / m experts of every layer on devices[s] under the layer key
    "expert_shards", everything else on devices[0]."""
    devices = [torch.device(d) for d in devices]
    layers = params["layers"]
    E, m = layers["expert_gate"].shape[1], len(devices)
    if E % m:
        raise ValueError(f"{E} experts must be divisible by the expert axis {m}")
    per = E // m
    keys = ("expert_gate", "expert_up", "expert_down")
    out = {k: map_params(lambda t: new_leaf(t, devices[0]), v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = {k: new_leaf(v, devices[0]) for k, v in layers.items() if k not in keys}
    out["layers"]["expert_shards"] = ShardedExperts(
        ExpertShard(d, *(new_leaf(layers[k][:, s * per:(s + 1) * per], d) for k in keys))
        for s, d in enumerate(devices))
    return out


def gather_params_ep(params: dict, fn=lambda t: t.detach()) -> dict:
    """The unsharded tree of `fn` of each leaf of a shard_params_ep tree (the
    values; `lambda t: t.grad` gives the gradients) on the first shard's
    device: the inverse of shard_params_ep."""
    layers = dict(params["layers"])
    shards = layers.pop("expert_shards").shards
    dev0 = params["embed"].device
    out = map_params(fn, {k: v for k, v in params.items() if k != "layers"})
    out["layers"] = map_params(fn, layers)
    for k, field in (("expert_gate", "gate"), ("expert_up", "up"), ("expert_down", "down")):
        out["layers"][k] = torch.cat([fn(getattr(sh, field)).to(dev0) for sh in shards], dim=1)
    return out


def make_moe_train_step(args: StaticModelArgs, optimizer, top_k: int = 2,
                        aux_weight: float = 0.01, devices: Optional[Sequence] = None):
    """train_step(state, input_ids) -> (state, loss): the mean next-token NLL
    plus aux_weight x the aux loss, one AdamW update in place. With
    `devices` (rows: a device, or the devices of an expert-sharded replica;
    `state.params` on the first) the batch is split over one replica a row
    (moe_grid_forward), each leaf's gradients summed onto the first row's in
    replica order in fp32, and the new params copied back to the others."""
    del optimizer  # the state carries the built optimizer
    from ..training.data_parallel import _row, place_params, update_from_replicas

    rows = None if devices is None else [_row(r) for r in devices]
    replicas = []

    def train_step(state, input_ids):
        if rows is None:
            logits, aux = moe_train_forward(state.params, args, input_ids, top_k=top_k)
            loss = lm_loss(logits, input_ids) + aux_weight * aux
            loss.backward()
            return optimizer_update(state, loss)
        if not replicas:
            replicas.extend(place_params(state.params, row) for row in rows[1:])
        trees = [state.params] + replicas
        logits, aux = moe_grid_forward(trees, args, input_ids, top_k)
        loss = lm_loss(logits, input_ids.to(logits.device)) + aux_weight * aux
        n = len(list(param_leaves(state.params)))
        grads = torch.autograd.grad(loss, [p for t in trees for p in param_leaves(t)])
        return update_from_replicas(state, [grads[r * n:(r + 1) * n] for r in range(len(trees))],
                                    replicas, loss.detach())

    return train_step
