"""Draft-model training: the causal-LM train step over the llama-family param
tree that the engines serve, so that a trained draft drops straight into them.

Counterpart of `umbrella_tpu/training/draft_trainer.py`. The JAX package
vmaps its layer over the batch and scans it over the stacked layers; here the
layer takes [B, S, H] as it is (the port's projections, norms and rope
broadcast over a leading batch axis) and a Python loop indexes the stacks.
Attention is dense (two einsums, the scores in fp32), as in the JAX package.

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


def param_leaves(params) -> Iterator[torch.Tensor]:
    """Every tensor of a param tree (dicts, tuples, lists), in a fixed order:
    dict insertion order, depth first."""
    if isinstance(params, torch.Tensor):
        yield params
    elif isinstance(params, dict):
        for v in params.values():
            yield from param_leaves(v)
    elif isinstance(params, (tuple, list)):
        for v in params:
            yield from param_leaves(v)


def map_params(fn, params):
    """The tree with `fn` applied to each tensor (other values as they are)."""
    if isinstance(params, torch.Tensor):
        return fn(params)
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(map_params(fn, v) for v in params)
    return params


def causal_mask(S: int, device) -> torch.Tensor:
    """[S, S] bool, True where key position <= query position."""
    return torch.ones((S, S), dtype=torch.bool, device=device).tril()


def _batched_attention(args: StaticModelArgs, lw: dict, hidden, inv_freq, rope_scale,
                       positions, mask):
    """The attention half of a layer over [B, S, H] without a KV cache:
    hidden + wo(softmax(q k^T / sqrt(D)) v), the scores in fp32."""
    B, S, _ = hidden.shape
    D, KVH = args.head_dim, args.num_kv_heads
    x = rms_norm(hidden, lw["input_norm"], args.rms_eps)
    q, k, v = _attn_projections(args, lw, x)
    q, k = apply_rope(q.reshape(B, S, args.num_heads, D), k.reshape(B, S, KVH, D),
                      inv_freq, rope_scale, positions)
    v = v.reshape(B, S, KVH, D)
    qg = q.reshape(B, S, KVH, args.num_heads // KVH, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / (D ** 0.5)
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, args.num_heads * D)
    return hidden + _linear(out, lw["wo"])


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


def train_forward(params: dict, args: StaticModelArgs, input_ids: torch.Tensor,
                  sequence_parallel: bool = False) -> torch.Tensor:
    """Causal forward over [B, S] -> fp32 logits [B, S, V] (no cache).

    `sequence_parallel` splits the sequence over the JAX package's 'model'
    mesh axis between attention blocks; without a model axis (the only
    layout here: ROADMAP A.5 queues TP/SP training) that constraint is the
    identity, as GSPMD makes it, so both values give the same logits."""
    del sequence_parallel
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
