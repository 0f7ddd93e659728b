"""Draft-model training: the causal-LM train step over the llama-family param
tree that the engines serve, so that a trained draft drops straight into them.

Counterpart of `umbrella_tpu/training/draft_trainer.py`. The JAX package
vmaps its layer over the batch and scans it over the stacked layers; here the
layer takes [B, S, H] as it is (the port's projections, norms and rope
broadcast over a leading batch axis) and a Python loop indexes the stacks.
Attention is dense (two einsums, the scores in fp32), as in the JAX package.

Tensor- and sequence-parallel training (`train_forward` over a tree from
parallel/mesh.shard_train_params, the JAX package's params sharded over a
'model' mesh axis): each shard runs its column products and its local heads'
attention on its own device; each row product (wo, down) is an fp32 partial
that parallel/collectives sums in shard order on the first shard's device,
where the norms and the residual stream stay; an untied head is
vocab-sharded and its logits gathered. `sequence_parallel=True` is the
Megatron SP layout on top: after each row product a reduce-scatter leaves
S / m rows of each sequence on each shard's device, the norms and the
residual run on those rows, and an all-gather brings whole sequences back
before the column products. Its sums are the tensor-parallel forward's, in
the same order, and `rms_norm` is row-invariant, so in fp32 both give the
same loss and gradients bit for bit; for that the norm weights' gradients
are summed over every row at once (`_ExpandRows`), as the tensor-parallel
norm sums them, not as per-shard partial sums. Autograd runs back through
the collectives (their backward passes are deterministic: four cards give
one card's bits).

Params are the tree of `llama.init_llama_params` with every floating leaf a
tensor that requires grad (`models/convert.trainable_params`): the JAX
package's `make_train_step` differentiates its whole params pytree, so
`rope_inv_freq` and `rope_scale` (a 0-d fp32 tensor here) are trained too, and
take AdamW's weight decay like every other leaf. The port mirrors that
(ROADMAP C).

The optimizer is `torch.optim.AdamW` under a `LambdaLR` that follows
`optax.warmup_cosine_decay_schedule(0, lr, warmup, total)`: the rate is 0.0 at
count 0, so the first update changes nothing; betas (0.9, 0.95), eps 1e-8,
weight decay 0.01 on every leaf; the moment buffers take each parameter's
dtype, as optax's do.
"""
from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.llama import StaticModelArgs, _attn_projections, _linear, _mlp_gate_up
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope
from ..ops.select import embed_lookup
from ..parallel.collectives import (all_gather, all_gather_seq, all_reduce, reduce_scatter,
                                    replicate, split_seq)
from ..utils import device_scope


def param_leaves(params) -> Iterator[torch.Tensor]:
    """Every tensor of a param tree (dicts, tuples, lists, and a block of
    shards such as models/moe.ShardedExperts, through its `shards`), in a
    fixed order: dict insertion order, depth first."""
    if isinstance(params, torch.Tensor):
        yield params
    elif isinstance(params, dict):
        for v in params.values():
            yield from param_leaves(v)
    elif isinstance(params, (tuple, list)):
        for v in params:
            yield from param_leaves(v)
    elif hasattr(params, "shards"):
        yield from param_leaves(params.shards)


def map_params(fn, params):
    """The tree with `fn` applied to each tensor (other values, a shard's
    device among them, as they are)."""
    if isinstance(params, torch.Tensor):
        return fn(params)
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, tuple) and hasattr(params, "_fields"):  # a NamedTuple
        return type(params)(*(map_params(fn, v) for v in params))
    if isinstance(params, (tuple, list)):
        return type(params)(map_params(fn, v) for v in params)
    if hasattr(params, "shards"):
        return type(params)(map_params(fn, params.shards))
    return params


def new_leaf(t: torch.Tensor, device) -> torch.Tensor:
    """A new leaf: t's values in fresh contiguous memory on `device`,
    requiring grad where t does."""
    return t.detach().to(device).clone(memory_format=torch.contiguous_format).requires_grad_(
        t.requires_grad)


def causal_mask(S: int, device) -> torch.Tensor:
    """[S, S] bool, True where key position <= query position."""
    return torch.ones((S, S), dtype=torch.bool, device=device).tril()


def _attention_heads(args: StaticModelArgs, lw: dict, x, inv_freq, rope_scale, positions,
                     mask):
    """softmax(q k^T / sqrt(D)) v of the normed x [B, S, H] over args' heads,
    the scores in fp32: [B, S, num_heads * D], before wo."""
    B, S, _ = x.shape
    D, KVH = args.head_dim, args.num_kv_heads
    q, k, v = _attn_projections(args, lw, x)
    q, k = apply_rope(q.reshape(B, S, args.num_heads, D), k.reshape(B, S, KVH, D),
                      inv_freq, rope_scale, positions)
    v = v.reshape(B, S, KVH, D)
    qg = q.reshape(B, S, KVH, args.num_heads // KVH, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / (D ** 0.5)
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, args.num_heads * D)


def _batched_attention(args: StaticModelArgs, lw: dict, hidden, inv_freq, rope_scale,
                       positions, mask):
    """The attention half of a layer over [B, S, H] without a KV cache:
    hidden + wo(softmax(q k^T / sqrt(D)) v)."""
    x = rms_norm(hidden, lw["input_norm"], args.rms_eps)
    return hidden + _linear(_attention_heads(args, lw, x, inv_freq, rope_scale, positions, mask),
                            lw["wo"])


def _batched_layer(args: StaticModelArgs, lw: dict, hidden, inv_freq, rope_scale, positions,
                   mask):
    """One layer over [B, S, H] without a KV cache (the training path)."""
    hidden = _batched_attention(args, lw, hidden, inv_freq, rope_scale, positions, mask)
    x = rms_norm(hidden, lw["post_norm"], args.rms_eps)
    gate, up = _mlp_gate_up(lw, x)
    return hidden + _linear(F.silu(gate) * up, lw["down"])


def embed_batch(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] ids -> [B, S, H] rows of the embedding in the norms' dtype (one
    flat lookup: the kernel, with its gradient, on a CUDA table)."""
    return embed_lookup(params["embed"], input_ids.reshape(-1),
                        params["final_norm"].dtype).reshape(*input_ids.shape, -1)


def head_logits(params: dict, args: StaticModelArgs, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm and head -> fp32 logits: the tied embedding, or lm_head."""
    hidden = rms_norm(hidden, params["final_norm"], args.rms_eps)
    head = params.get("lm_head")
    if head is None:
        return hidden.float() @ params["embed"].float().T
    return hidden.float() @ head.float()


class _ExpandRows(torch.autograd.Function):
    """A norm weight w [H] as a [B, S / m, H] view on each sequence chunk's
    device; backward: the chunks' gradients joined on w's device and summed
    over every row at once (`sum_to_size`, the reduction autograd makes for
    the tensor-parallel norm's broadcast weight), not per chunk."""

    @staticmethod
    def forward(ctx, w, shapes, devices):
        ctx.device, ctx.size = w.device, w.shape
        return tuple((w if d == w.device else w.to(d)).expand(shape)
                     for shape, d in zip(shapes, devices))

    @staticmethod
    def backward(ctx, *grads):
        full = torch.cat([g.to(ctx.device) for g in grads], dim=1)
        return full.sum_to_size(ctx.size), None, None


def _shard_device(shard: dict) -> torch.device:
    return next(iter(shard["layers"].values())).device


def _per_device(devices, make) -> list:
    """make(d) for each device, made once a distinct device."""
    made = {}
    for d in devices:
        if d not in made:
            made[d] = make(d)
    return [made[d] for d in devices]


def _tp_train_forward(params: dict, args: StaticModelArgs, input_ids: torch.Tensor,
                      sequence_parallel: bool) -> torch.Tensor:
    """train_forward over parallel/mesh.shard_train_params' tree (see the
    module docstring)."""
    shards = params["tp_shards"]
    m = len(shards)
    if args.num_heads % m or args.num_kv_heads % m:
        raise ValueError(f"{args.num_heads} heads and {args.num_kv_heads} kv heads must be "
                         f"divisible by the model axis {m}")
    largs = args._replace(num_heads=args.num_heads // m, num_kv_heads=args.num_kv_heads // m)
    devices = [_shard_device(sh) for sh in shards]
    S, eps = input_ids.shape[1], args.rms_eps
    hidden = embed_batch(params, input_ids)
    dev0, dtype = hidden.device, hidden.dtype
    positions = _per_device(devices, lambda d: torch.arange(S, device=d))
    masks = _per_device(devices, lambda d: causal_mask(S, d))
    inv_freqs = replicate(params["rope_inv_freq"], devices)
    scale = params["rope_scale"]
    scales = replicate(scale, devices) if isinstance(scale, torch.Tensor) else [scale] * m

    def attention(s, lw, x):
        heads = _attention_heads(largs, lw, x, inv_freqs[s], scales[s], positions[s], masks[s])
        return heads.float() @ lw["wo"].float()

    def mlp(s, lw, x):
        gate, up = _mlp_gate_up(lw, x)
        return (F.silu(gate) * up).float() @ lw["down"].float()

    def partials(part, lws, xs):
        out = []
        for s, (lw, x) in enumerate(zip(lws, xs)):
            with device_scope(devices[s]):
                out.append(part(s, lw, x))
        return out

    layers = params["layers"]
    rows = split_seq(hidden, devices) if sequence_parallel else None
    for i in range(layers["input_norm"].shape[0]):
        lws = [{k: v[i] for k, v in sh["layers"].items()} for sh in shards]
        for norm, part in (("input_norm", attention), ("post_norm", mlp)):
            w = layers[norm][i]
            if sequence_parallel:
                ws = _ExpandRows.apply(w.float(), tuple(r.shape for r in rows), tuple(devices))
                xs = all_gather_seq([rms_norm(r, wc, eps) for r, wc in zip(rows, ws)], devices)
                sums = reduce_scatter(partials(part, lws, xs), devices, dtype)
                rows = [r + a for r, a in zip(rows, sums)]
            else:
                xs = replicate(rms_norm(hidden, w, eps), devices)
                hidden = hidden + all_reduce(partials(part, lws, xs), dev0, dtype)
    if sequence_parallel:
        hidden = torch.cat([r.to(dev0) for r in rows], dim=1)
    if "lm_head" not in shards[0]:
        return head_logits(params, args, hidden)
    xs = replicate(rms_norm(hidden, params["final_norm"], eps), devices)
    parts = []
    for s, (sh, x) in enumerate(zip(shards, xs)):
        with device_scope(devices[s]):
            parts.append(x.float() @ sh["lm_head"].float())
    return all_gather(parts, dev0)


def train_forward(params: dict, args: StaticModelArgs, input_ids: torch.Tensor,
                  sequence_parallel: bool = False) -> torch.Tensor:
    """Causal forward over [B, S] -> fp32 logits [B, S, V] (no cache), on
    the embedding's device.

    Over a tensor-parallel tree (parallel/mesh.shard_train_params), the
    model axis's forward; `sequence_parallel` splits the sequence over that
    axis between the row and the column products. Without a model axis that
    split is the identity, as GSPMD makes it, so both values give the same
    logits."""
    if "tp_shards" in params:
        return _tp_train_forward(params, args, input_ids, sequence_parallel)
    S = input_ids.shape[1]
    hidden = embed_batch(params, input_ids)
    positions = torch.arange(S, device=hidden.device)
    mask = causal_mask(S, hidden.device)
    layers = params["layers"]
    for i in range(layers["input_norm"].shape[0]):
        lw = {k: v[i] for k, v in layers.items()}
        hidden = _batched_layer(args, lw, hidden, params["rope_inv_freq"], params["rope_scale"],
                                positions, mask)
    return head_logits(params, args, hidden)


def lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token NLL of fp32 logits [B, S, V] against input_ids[:, 1:]: the
    mean, or under `loss_mask` [B, S] the mean over masked-in targets."""
    V = logits.shape[-1]
    nll = F.cross_entropy(logits[:, :-1].reshape(-1, V), input_ids[:, 1:].reshape(-1).long(),
                          reduction="none")
    if loss_mask is None:
        return nll.mean()
    m = loss_mask[:, 1:].reshape(-1).to(nll.device, torch.float32)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def causal_lm_loss(params, args, input_ids, loss_mask=None, sequence_parallel=False):
    logits = train_forward(params, args, input_ids, sequence_parallel=sequence_parallel)
    return lm_loss(logits, input_ids, loss_mask)


BETAS, EPS = (0.9, 0.95), 1e-8  # the JAX package's optax.adamw b1, b2 and eps


class Optimizer(NamedTuple):
    """The settings of `optax.adamw(warmup_cosine_decay_schedule(...))`; the
    torch optimizer over a param tree comes from `build`."""
    lr: float
    total_steps: int
    warmup: int
    weight_decay: float

    def schedule(self, count: int) -> float:
        """The learning rate of update `count` (0-based): linear from 0 to lr
        over `warmup` counts, then a cosine to 0 at `total_steps`."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        decay = self.total_steps - self.warmup
        t = min(count - self.warmup, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    def build(self, params: dict):
        """(torch.optim.AdamW over every leaf of `params`, its LambdaLR)."""
        opt = torch.optim.AdamW(list(param_leaves(params)), lr=self.lr, betas=BETAS, eps=EPS,
                                weight_decay=self.weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda c: self.schedule(c) / self.lr if self.lr else 0.0)


class TrainState(NamedTuple):
    params: dict
    opt_state: tuple  # (torch.optim.AdamW, LambdaLR)
    step: int


def make_optimizer(lr: float = 3e-4, total_steps: int = 10000, warmup: int = 200,
                   weight_decay: float = 0.01) -> Optimizer:
    warmup = min(warmup, max(total_steps // 10, 1))
    if total_steps - warmup <= 0:
        raise ValueError(f"total_steps ({total_steps}) must exceed the warmup ({warmup})")
    return Optimizer(lr, total_steps, warmup, weight_decay)


def optimizer_update(state: TrainState, loss: torch.Tensor) -> TrainState:
    """One optimizer update from the gradients in the leaves' `.grad`; they
    are cleared for the next step."""
    opt, sched = state.opt_state
    opt.step()
    sched.step()
    opt.zero_grad(set_to_none=True)
    return TrainState(state.params, state.opt_state, state.step + 1), loss.detach()


def make_train_step(args: StaticModelArgs, optimizer: Optimizer, sequence_parallel: bool = False):
    """train_step(state, input_ids [B, S], loss_mask=None) -> (state, loss):
    the loss and its gradient over every leaf, then one AdamW update of the
    params in place."""
    del optimizer  # the state carries the built optimizer

    def train_step(state: TrainState, input_ids, loss_mask=None):
        loss = causal_lm_loss(state.params, args, input_ids, loss_mask, sequence_parallel)
        loss.backward()
        return optimizer_update(state, loss)

    return train_step


def init_train_state(params: dict, optimizer: Optimizer) -> TrainState:
    return TrainState(params, optimizer.build(params), 0)
