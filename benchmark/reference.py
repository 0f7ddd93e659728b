"""The plain reference: a float32 forward of the llama-family and Mixtral
architectures in plain PyTorch, over the raw tensors that the benchmark made
(AutoAWQ GEMM words, fp16 scales, bf16 matrices). It imports nothing of the
program under test and works out again, from those tensors, everything the
program derives from them: AWQ dequantization, and the Int4F fit of the
layers and the head that the composition converts.

One forward runs a batch of whole sequences (prompt and served tokens) layer
by layer, so that one layer's float32 weights are made once. TF32 is off.

`low=True` is the control: the model computed one step down the precision
ladder from what the configuration states for each part, with a per-row
scale: float8 e4m3 for bf16 (bf16 weights, each output column scaled, the
embedding rows, activations entering W4A16 and bf16 products, a bf16
cache), int4 for int8 (the activations of the Int4F W4A8 products, an int8
cache), bf16 for the float32 router; the int4 AWQ and Int4F weights stay.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

# AutoAWQ GEMM packing: column 8w + i of a row is nibble AWQ_NIBBLE[i] of word w
AWQ_NIBBLE = (0, 4, 1, 5, 2, 6, 3, 7)
FP8_MAX = 448.0
# a row's router decision is a tie where its top-k-th and next router logits
# lie within this share of its largest |router logit|: a last-bit difference
# before the router (bf16 against float32) may swap the experts there
ROUTER_TIE = 2.0 ** -7


def unpack_awq(words: torch.Tensor) -> torch.Tensor:
    """int32 [R, C/8] AutoAWQ words -> float32 [R, C] 4-bit codes."""
    shifts = torch.tensor([4 * j for j in AWQ_NIBBLE], dtype=torch.int32, device=words.device)
    codes = (words.to(torch.int32)[:, :, None] >> shifts) & 0xF
    return codes.reshape(words.shape[0], -1).float()


def dequant_awq(qweight, qzeros, scales) -> torch.Tensor:
    """float32 [K, N]: (code - zero) * scale, a zero and a scale per group of
    K / groups rows."""
    q = unpack_awq(qweight)
    g = q.shape[0] // scales.shape[0]
    z = unpack_awq(qzeros).repeat_interleave(g, dim=0)
    s = scales.float().repeat_interleave(g, dim=0)
    return (q - z) * s


def int4f_fit(w: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The Int4F form of an AWQ weight, worked out again (float32 [K, N]):
    w ~ a[k] b[n] (q4 - 8), q4 in [0, 15]; a is the geometric mean over the
    columns of each group's AWQ scales, repeated over the group's rows; b the
    column's largest |w / a| over 7.5; no refining sweep."""
    K = w.shape[0]
    g = K // scales.shape[0]
    a = torch.exp(torch.log(scales.float().clamp(min=1e-12)).mean(dim=-1))
    a = a.repeat_interleave(g)
    b = ((w / a[:, None]).abs().amax(dim=0) * (1.0 / 7.5)).clamp(min=1e-12)
    q = torch.clamp(torch.round(w / (a[:, None] * b[None, :])), -8, 7)
    return q * a[:, None] * b[None, :]


def low_precision(x: torch.Tensor, kind: str = "fp8") -> torch.Tensor:
    """x rounded, with a per-row scale, to float8 e4m3 ("fp8") or to the
    integers -7..7 ("int4"); "bf16" rounds it to bfloat16 (the control)."""
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    top = FP8_MAX if kind == "fp8" else 7.0
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / top
    if kind == "fp8":
        return (x / s).to(torch.float8_e4m3fn).float() * s
    return torch.clamp(torch.round(x / s), -7, 7) * s


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """HF rotary embedding (halves rotated) of x [T, heads, D] at positions
    0..T-1, angles in float64."""
    T, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    half = D // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def attention(q, k, v, heads: int, kv_heads: int, D: int, low) -> torch.Tensor:
    """Causal GQA attention of one sequence: q [T, heads*D], k and v
    [T, kv_heads*D] -> [T, heads*D], in float32, a query block at a time."""
    T = q.shape[0]
    q = q.reshape(T, heads, D)
    k = k.reshape(T, kv_heads, D)
    v = v.reshape(T, kv_heads, D)
    if low:
        k, v = low_precision(k, low), low_precision(v, low)
    rep = heads // kv_heads
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # [heads, T, D]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty(T, heads, D, dtype=torch.float32, device=q.device)
    block = 512
    for s in range(0, T, block):
        e = min(T, s + block)
        qb = q[s:e].transpose(0, 1)  # [heads, b, D]
        scores = qb @ k[:, :e].transpose(1, 2) * D ** -0.5
        causal = torch.arange(e, device=q.device)[None, :] > torch.arange(s, e, device=q.device)[:, None]
        scores.masked_fill_(causal[None], float("-inf"))
        out[s:e] = (torch.softmax(scores, dim=-1) @ v[:, :e]).transpose(0, 1)
    return out.reshape(T, heads * D)


class Linear:
    """One product of the reference: bf16 [K, N] matrices, or AWQ tensors, each
    a list of parts concatenated along N (q|k|v, gate|up), the AWQ ones
    optionally refit as Int4F over the concatenation. `scale_dtype`: the
    dtype the model is served in, which holds the AWQ scales (None: as the
    checkpoint stores them)."""

    def __init__(self, dense: Sequence[torch.Tensor] = (), awq: Sequence[tuple] = (),
                 int4f: bool = False, scale_dtype=None):
        self.dense, self.int4f = list(dense), int4f
        self.low = "int4" if int4f else "fp8"  # the control's activations
        self.awq = [(q, z, s if scale_dtype is None else s.to(scale_dtype)) for q, z, s in awq]

    def weight(self, low: bool = False) -> torch.Tensor:
        """float32 [K, N]; with `low`, bf16 matrices rounded to float8."""
        if self.dense:
            w = torch.cat([w.float() for w in self.dense], dim=1)
            return low_precision(w.T).T if low else w
        w = torch.cat([dequant_awq(*t) for t in self.awq], dim=1)
        if self.int4f:
            w = int4f_fit(w, torch.cat([t[2] for t in self.awq], dim=1))
        return w


def matmul(x: torch.Tensor, w: torch.Tensor, low) -> torch.Tensor:
    """x @ w, x first rounded to `low` (a low_precision kind) unless it is None."""
    return (low_precision(x, low) if low else x) @ w


def forward(model: dict, sequences: List[torch.Tensor], low: bool = False,
            kv_dtype: str = "bf16", ties: Optional[List[torch.Tensor]] = None
            ) -> List[torch.Tensor]:
    """float32 logits [T, V] of each sequence (int64 ids on the card); with
    `low`, the control, its cache one step below `kv_dtype`. Where `ties` is
    a list, it receives a bool [T] a sequence: rows whose router decision is
    a tie (ROUTER_TIE) in some layer (all false for a dense model).

    `model`: {"embed": bf16 [V, H], "final_norm": [H], "head": Linear,
    "layers": [{"input_norm", "post_norm", "qkv": Linear, "wo": Linear, and
    "gate_up", "down": Linear (dense MLP) or "router": [H, E] and
    "experts": (gate [E, H, I], up [E, H, I], down [E, I, H]), each a stack
    or a list of the E experts' matrices, which may lie on other cards)}],
    "heads", "kv_heads", "head_dim", "eps", "theta", "top_k"}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, D = model["embed"].shape[1], model["head_dim"]
    heads, kvh, eps = model["heads"], model["kv_heads"], model["eps"]
    def lo(lin):
        return lin.low if low else None

    kv_low = ("int4" if kv_dtype == "int8" else "fp8") if low else None
    hs = [model["embed"][s].float() for s in sequences]
    if low:
        hs = [low_precision(h) for h in hs]
    tie = [torch.zeros(len(s), dtype=torch.bool, device=s.device) for s in sequences]
    for lw in model["layers"]:
        w_qkv, w_o = lw["qkv"].weight(low), lw["wo"].weight(low)
        for i, h in enumerate(hs):
            x = rms_norm(h, lw["input_norm"], eps)
            qkv = matmul(x, w_qkv, lo(lw["qkv"]))
            q, k, v = qkv.split([heads * D, kvh * D, kvh * D], dim=-1)
            q = rope(q.reshape(-1, heads, D), model["theta"]).reshape(-1, heads * D)
            k = rope(k.reshape(-1, kvh, D), model["theta"]).reshape(-1, kvh * D)
            hs[i] = h + matmul(attention(q, k, v, heads, kvh, D, kv_low), w_o, lo(lw["wo"]))
        del w_qkv, w_o
        if "router" in lw:
            for i, h in enumerate(hs):
                out, t = moe(lw, rms_norm(h, lw["post_norm"], eps), model["top_k"], low)
                hs[i], tie[i] = h + out, tie[i] | t
        else:
            w_gu, w_d = lw["gate_up"].weight(low), lw["down"].weight(low)
            inter = w_d.shape[0]
            for i, h in enumerate(hs):
                gu = matmul(rms_norm(h, lw["post_norm"], eps), w_gu, lo(lw["gate_up"]))
                act = torch.nn.functional.silu(gu[:, :inter]) * gu[:, inter:]
                hs[i] = h + matmul(act, w_d, lo(lw["down"]))
            del w_gu, w_d
    if ties is not None:
        ties.extend(tie)
    w_head = model["head"].weight(low)
    return [matmul(rms_norm(h, model["final_norm"], eps), w_head, lo(model["head"]))
            for h in hs]


def moe(lw: dict, x: torch.Tensor, top_k: int, low: bool):
    """Top-k softmax routing, the k weights renormalised to sum 1, and the
    chosen experts' SiLU MLPs, one expert's float32 weights at a time,
    brought to x's card (the control: a bf16 router, float8 expert inputs).
    Returns (output, the rows whose decision is a tie)."""
    logits = matmul(x, lw["router"].float(), "bf16" if low else None)
    top = logits.topk(top_k + 1, dim=-1).values
    tie = (top[:, top_k - 1] - top[:, top_k]) <= ROUTER_TIE * logits.abs().amax(dim=-1)
    probs = torch.softmax(logits, dim=-1)
    low = "fp8" if low else None
    vals, idx = torch.topk(probs, top_k, dim=-1)
    vals = vals / vals.sum(dim=-1, keepdim=True)
    gate, up, down = lw["experts"]
    out = torch.zeros_like(x)
    for e in range(len(gate)):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        ge, ue, de = (Linear(dense=[w[e].to(x.device)]).weight(low is not None)
                      for w in (gate, up, down))
        g = matmul(xe, ge, low)
        u = matmul(xe, ue, low)
        y = matmul(torch.nn.functional.silu(g) * u, de, low)
        out.index_add_(0, rows, y * vals[rows, slot][:, None])
    return out, tie


def served_gaps(logits: torch.Tensor, prompt_len: int, served: Sequence[int]) -> torch.Tensor:
    """For each served token, how far its reference logit lies below the
    reference's best at that position (0 where it is the best)."""
    rows = logits[prompt_len - 1:prompt_len - 1 + len(served)]
    tok = torch.as_tensor(list(served), device=rows.device, dtype=torch.long)
    return rows.max(dim=-1).values - rows.gather(1, tok[:, None])[:, 0]


def control_gaps(ref: torch.Tensor, low: torch.Tensor, prompt_len: int, n: int) -> torch.Tensor:
    """At each of the n served positions, the reference's gap of the token that
    the low-precision forward puts first."""
    r = ref[prompt_len - 1:prompt_len - 1 + n]
    pick = low[prompt_len - 1:prompt_len - 1 + n].argmax(dim=-1)
    return r.max(dim=-1).values - r.gather(1, pick[:, None])[:, 0]
