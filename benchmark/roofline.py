"""The yardstick: the card's peaks, the bound of a piece of work, and the
operations and bytes that a model's forwards need, worked out from the
configuration's shapes and the counts of forwards and tokens. Never from a
kernel's launch arguments: a later change that fuses or replaces a kernel is
held to the same work.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at the
card's full 700 W; the run records the card's power limit beside them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(bytes_moved: float, ops: float, op_type: str = "bf16") -> Tuple[float, str]:
    """(least seconds, what bounds them): the larger of bytes over the HBM rate
    and operations over the peak of `op_type`."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK[op_type]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass(frozen=True)
class Shapes:
    """One model's shapes, as its configuration file states them."""
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    experts: int = 0  # 0: a dense MLP
    top_k: int = 0
    group_size: int = 128  # of the W4 products
    w4_layers: Tuple[int, ...] = ()  # layers whose products run as W4A16 (AWQ)

    @classmethod
    def from_config(cls, c: dict, w4_from: int = -1) -> "Shapes":
        n = c["num_hidden_layers"]
        return cls(hidden=c["hidden_size"], intermediate=c["intermediate_size"], layers=n,
                   heads=c["num_attention_heads"], kv_heads=c["num_key_value_heads"],
                   head_dim=c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"],
                   vocab=c["vocab_size"], experts=c.get("num_local_experts") or 0,
                   top_k=c.get("num_experts_per_tok") or 0,
                   w4_layers=tuple(range(w4_from, n)) if w4_from >= 0 else ())

    def products(self) -> Dict[str, Tuple[int, int]]:
        """The [K, N] of each dense or W4 product of one layer (experts apart)."""
        H, D = self.hidden, self.head_dim
        qkv = (self.heads + 2 * self.kv_heads) * D
        out = {"wqkv": (H, qkv), "wo": (self.heads * D, H)}
        if not self.experts:
            out["gate_up"] = (H, 2 * self.intermediate)
            out["down"] = (self.intermediate, H)
        return out

    def layer_macs(self) -> int:
        """Multiply-adds a token needs in one layer's products: attention
        projections, and the MLP or the router and top_k experts."""
        macs = sum(k * n for k, n in self.products().values())
        if self.experts:
            macs += self.hidden * self.experts + self.top_k * 3 * self.hidden * self.intermediate
        return macs

    def forward_flops(self, rows: int, pairs: float) -> float:
        """Operations of one forward over `rows` tokens whose attention covers
        `pairs` live query-key pairs a layer: 2 per multiply-add in every layer
        and the head, 4 * heads * head_dim per pair."""
        return (2.0 * rows * (self.layers * self.layer_macs() + self.hidden * self.vocab)
                + 4.0 * self.heads * self.head_dim * pairs * self.layers)

    def w4a16_work(self, rows: int) -> Tuple[float, float]:
        """(bytes, operations) of the W4A16 products of one forward over `rows`
        tokens: each packed int4 weight, its bf16 scales and zeros, the bf16
        rows in and out, read or written once."""
        by = ops = 0.0
        for k, n in self.products().values():
            by += k * n / 2 + 2 * (k // self.group_size) * n * 2 + rows * (k + n) * 2
            ops += 2.0 * rows * k * n
        m = len(self.w4_layers)
        return by * m, ops * m

    def attention_work(self, rows: int, columns: float, pairs: float,
                       kv_bytes_per_value: float) -> Tuple[float, float]:
        """(bytes, operations) of masked attention in every layer of one
        forward: bf16 queries in and outputs out, each live cached column's K
        and V read once, 4 * heads * head_dim operations a live pair."""
        q_out = 2 * rows * self.heads * self.head_dim * 2
        kv = 2 * columns * self.kv_heads * self.head_dim * kv_bytes_per_value
        return ((q_out + kv) * self.layers,
                4.0 * self.heads * self.head_dim * pairs * self.layers)


def kv_bytes_per_value(kv_dtype: str, head_dim: int) -> float:
    """int8 values carry an fp32 scale a row of head_dim; bf16 values 2 bytes."""
    return 1 + 4 / head_dim if kv_dtype == "int8" else 2.0


def draft_level_rows(level_widths: List[int]) -> List[int]:
    """Rows of each draft forward of one step of a static tree with these
    level widths: the deferred leaf level runs no forward, and level 0 runs
    the last two committed tokens."""
    if len(level_widths) < 2:
        return list(level_widths)
    return [2] + list(level_widths[1:-1])


def window_work(run) -> dict:
    """Operations and least times of what the window's forwards needed, from
    the shapes and the counted steps and tokens:

    - decode steps (the engine's counters): each runs the target over B x T
      tree rows and the draft's level forwards over B x their rows;
    - prefills: every prompt whose first tokens came inside the window, through
      target and draft, in chunks of `chunk` tokens, the head on its last row;
    - attention over the live cache: the window's token-seconds of context
      (window.context_seconds) times the steps a second give the context
      columns that a step's slots attend, in each forward.

    Returns flops (all products and attention), w4a16_s and attention_s (the
    sum of each forward's bound), and the counts they came from."""
    from benchmark import window

    tgt, dft = run.shapes
    t0, t1 = run.t0, run.t1
    secs = t1 - t0
    steps = run.c1["steps"] - run.c0["steps"]
    B, T = run.batch, run.tree_size
    levels = draft_level_rows(run.tree_levels)
    ctx = window.context_seconds(run.records, t0, t1) * steps / secs if secs > 0 else 0.0
    bpv = kv_bytes_per_value(run.kv_dtype, tgt.head_dim)

    flops = steps * (tgt.forward_flops(B * T, 0)
                     + sum(dft.forward_flops(B * r, 0) for r in levels))
    # attention of the decode: T target rows and each level's rows over the
    # context of every live slot (ctx sums it over slots and steps)
    pairs_t, pairs_d = T * ctx, sum(levels) * ctx
    flops += 4.0 * tgt.heads * tgt.head_dim * pairs_t * tgt.layers
    flops += 4.0 * dft.heads * dft.head_dim * pairs_d * dft.layers
    att_b_t, att_o_t = tgt.attention_work(steps * B * T, ctx, pairs_t, bpv)
    att_b_d, att_o_d = dft.attention_work(steps * B * sum(levels), ctx * len(levels), pairs_d, bpv)
    attention_s = bound(att_b_t + att_b_d, att_o_t + att_o_d)[0]
    w4a16_s = steps * bound(*tgt.w4a16_work(B * T))[0] if tgt.w4_layers else 0.0

    prompts = window.prompts_started(run.records, t0, t1)
    pf_b = pf_o = 0.0
    for P in prompts:
        pairs = P * (P + 1) / 2
        for m in (tgt, dft):
            flops += m.forward_flops(P, pairs) - 2.0 * (P - 1) * m.hidden * m.vocab
        off = 0
        while off < P:
            c = min(run.chunk, P - off)
            if tgt.w4_layers:
                w4a16_s += bound(*tgt.w4a16_work(c))[0]
            for m in (tgt, dft):
                cb, co = m.attention_work(c, off + c, c * off + c * (c + 1) / 2, bpv)
                pf_b, pf_o = pf_b + cb, pf_o + co
            off += c
    attention_s += bound(pf_b, pf_o)[0]
    return dict(flops=flops, w4a16_s=w4a16_s, attention_s=attention_s, steps=steps,
                prefill_tokens=sum(prompts), context_columns=ctx)
