"""Host-memory weight streaming ("offload") runtime.

Counterpart of `umbrella_tpu/offload/streaming.py` (`OffloadModelRuntime`): the
target's first `num_cache_layers` layers stay on the device; the others live
in host memory (pinned on the card, plain tensors on the CPU) and are copied
to the device layer by layer while the layer before computes.

The stream is the reference's mechanism (SURVEY.md 2.11-2.12) without its
per-layer synchronize:
- two persistent device buffers with a streamed layer's structure, allocated
  once (so the caching allocator never hands their memory to another stream);
- a side copy stream: streamed layer j goes into buffer j % 2 with
  `copy_(..., non_blocking=True)` from pinned memory, issued before the layer
  before it is launched (the first two at the start of the forward);
- events order the two streams: a copy into a buffer waits for the compute
  of the layer that last read it (`_free`), and a layer's compute waits for
  its copy (`_ready`). The host waits on nothing.
The layers run through the port's own `llama_layer` and the head through
`lm_head_logits`, so a streamed forward launches the resident forward's
kernels at its shapes in its order, and its logits equal a resident
forward's of the same weights bit for bit.

The engines call `streamed_forward`: this runtime does not support the fused
phases (one captured dispatch a step), as in the JAX package. Its forward is
one eager phase of the engines' step (`forward_phases`): the graphed step
replays the draft build as one CUDA graph, runs the streamed forward, and
replays the verify tail as another (JAX's `_offload_step`: `_build_tree_jit`,
`streamed_forward`, the gated tail).
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from ..config import ModelConfig
from ..cuda_graphs import Phase
from ..models.kv_cache import KVCache, init_kv_cache
from ..models.llama import StaticModelArgs, kv_limit_of, llama_layer, lm_head_logits
from ..models.weights import fetch, read_state_dict, trim_vocab_rows
from ..ops.norms import rms_norm
from ..ops.rope import rope_params
from ..ops.select import embed_lookup
from ..quantization.awq import awq_from_hf_tensors, concat_awq
from ..utils import resolve_device


def map_layer(fn, lw: dict) -> dict:
    """fn applied to every tensor of a layer's weights (AwqTensor fields too)."""
    return {k: type(v)(*(fn(t) for t in v)) if isinstance(v, tuple) else fn(v)
            for k, v in lw.items()}


def layer_tensors(lw: dict) -> list:
    return [t for v in lw.values() for t in (v if isinstance(v, tuple) else (v,))]


def to_host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of t of its own: pinned (for asynchronous copies to the card)
    where `pin`; pinning raises where it fails."""
    if not pin:
        return t.detach().to("cpu", copy=True).contiguous()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _fp_layer_from_sd(sd, i: int, dtype, device) -> dict:
    """Layer i of an HF fp checkpoint in the packed layout, on `device`
    (as models/weights.params_from_hf_state_dict builds it)."""
    P = f"model.layers.{i}."

    def get(name):
        return fetch(sd, P + name, device, torch.float32).to(dtype)

    def cat_t(names):
        return torch.cat([get(n).T for n in names], dim=-1).contiguous()

    d = {
        "input_norm": get("input_layernorm.weight"),
        "post_norm": get("post_attention_layernorm.weight"),
        "wqkv": cat_t([f"self_attn.{c}_proj.weight" for c in "qkv"]),
        "wo": get("self_attn.o_proj.weight").T.contiguous(),
        "gate_up": cat_t(["mlp.gate_proj.weight", "mlp.up_proj.weight"]),
        "down": get("mlp.down_proj.weight").T.contiguous(),
    }
    if P + "self_attn.q_proj.bias" in sd:
        d["bqkv"] = torch.cat([get(f"self_attn.{c}_proj.bias") for c in "qkv"], dim=-1)
    return d


def _awq_layer_from_sd(sd, i: int, dtype, device) -> dict:
    """Layer i of an HF AutoAWQ checkpoint in the packed layout, on `device`
    (as quantization/loader.awq_params_from_hf_state_dict builds it: norms and
    biases in `dtype`)."""
    P = f"model.layers.{i}."

    def fp(name):
        return fetch(sd, P + name, device, torch.float32).to(dtype)

    def q(base):
        return awq_from_hf_tensors(fetch(sd, P + base + ".qweight", device),
                                   fetch(sd, P + base + ".qzeros", device),
                                   fetch(sd, P + base + ".scales", device), dtype=dtype)

    d = {
        "input_norm": fp("input_layernorm.weight"),
        "post_norm": fp("post_attention_layernorm.weight"),
        "wqkv": concat_awq([q(f"self_attn.{c}_proj") for c in "qkv"]),
        "wo": q("self_attn.o_proj"),
        "gate_up": concat_awq([q("mlp.gate_proj"), q("mlp.up_proj")]),
        "down": q("mlp.down_proj"),
    }
    if P + "self_attn.q_proj.bias" in sd:
        d["bqkv"] = torch.cat([fp(f"self_attn.{c}_proj.bias") for c in "qkv"], dim=-1)
    return d


class _Clock:
    """Timestamps: CUDA events on a stream of the card, else the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self, stream=None):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1000.0 * (b - a)


class OffloadModelRuntime:
    """A llama-family model whose layers past `num_cache_layers` stream from
    host memory; the engines call `streamed_forward`."""

    supports_fused_phases = False

    def __init__(self, cfg: ModelConfig, top_params: dict, host_layers: List[dict],
                 max_length: int, dtype=torch.bfloat16, family: str = "llama",
                 num_cache_layers: int = 0, model_name: str = "", device="cuda"):
        from ..models.auto_model import LLAMA_FAMILIES, _check_family

        _check_family(family, LLAMA_FAMILIES, "the offload tier")
        self.cfg, self.max_length, self.dtype = cfg, max_length, dtype
        self.family, self.model_name = family, model_name
        self.num_cache_layers = num_cache_layers
        self.device = dev = resolve_device(device)
        self.n_layers = n = len(host_layers)
        self.args = StaticModelArgs.from_config(cfg, n_layers=n)
        self.top = top_params
        R = min(num_cache_layers, n)
        self.n_resident = R
        # the first R layers on the device (ref llama.py:184-185); the rest in host memory
        self.resident = [map_layer(lambda t: t.to(dev), host_layers[i]) for i in range(R)]
        pin = dev.type == "cuda"
        self.host_layers: List[Optional[dict]] = [None] * R
        for lw in host_layers[R:]:
            if pin and not all(t.is_pinned() for t in layer_tensors(lw)):
                lw = map_layer(lambda t: t if t.is_pinned() else to_host(t, True), lw)
            self.host_layers.append(lw)
        self.n_streamed = n - R
        self._buffers, self.streamed_layer_bytes = [], 0
        if self.n_streamed:
            first = self.host_layers[R]
            shapes = [(t.shape, t.dtype) for t in layer_tensors(first)]
            for lw in self.host_layers[R:]:
                if [(t.shape, t.dtype) for t in layer_tensors(lw)] != shapes:
                    raise ValueError("streamed layers must share one structure and shape")
            self._buffers = [map_layer(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                                       first) for _ in range(2)]
            self.streamed_layer_bytes = sum(t.numel() * t.element_size()
                                            for t in layer_tensors(first))
        if pin:
            self._copy_stream = torch.cuda.Stream(dev)
            self._ready = [torch.cuda.Event() for _ in range(2)]
            self._free = [torch.cuda.Event() for _ in range(2)]
        self._free_recorded = [False, False]

    # ---------------------------------------------------------------- loading

    @classmethod
    def load(cls, path: str, cfg: ModelConfig, max_length: int, dtype=torch.bfloat16,
             family: str = "llama", n_layers: Optional[int] = None, num_cache_layers: int = 0,
             device="cuda") -> "OffloadModelRuntime":
        """An HF fp checkpoint directory, layer by layer."""
        with read_state_dict(path) as sd:
            return cls.from_state_dict(sd, cfg, max_length, dtype, family=family,
                                       n_layers=n_layers, num_cache_layers=num_cache_layers,
                                       quantized=False, model_name=path, device=device)

    @classmethod
    def from_state_dict(cls, sd, cfg: ModelConfig, max_length: int, dtype=torch.bfloat16,
                        family: str = "llama", n_layers: Optional[int] = None,
                        num_cache_layers: int = 0, quantized: bool = False,
                        model_name: str = "", device="cuda") -> "OffloadModelRuntime":
        """fp or AutoAWQ (`quantized`) HF tensors. Each layer is converted on
        the device and a streamed one moved to host memory before the next is
        read, so the whole model is never on the device."""
        dev = resolve_device(device)
        n = n_layers if n_layers is not None else cfg.num_hidden_layers
        layer_fn = _awq_layer_from_sd if quantized else _fp_layer_from_sd
        pin = dev.type == "cuda"
        layers = []
        for i in range(n):
            lw = layer_fn(sd, i, dtype, dev)
            layers.append(lw if i < num_cache_layers else map_layer(lambda t: to_host(t, pin), lw))
            del lw

        def top_get(name):
            return fetch(sd, name, dev, torch.float32).to(dtype)

        top = {"embed": trim_vocab_rows(top_get("model.embed_tokens.weight"),
                                        cfg.vocab_size).contiguous(),
               "final_norm": top_get("model.norm.weight"),
               **rope_params(cfg, device=dev)}
        if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
            top["lm_head"] = trim_vocab_rows(top_get("lm_head.weight"),
                                             cfg.vocab_size).T.contiguous()
        return cls(cfg, top, layers, max_length, dtype=dtype, family=family,
                   num_cache_layers=num_cache_layers, model_name=model_name, device=dev)

    @classmethod
    def from_params(cls, params: dict, cfg: ModelConfig, max_length: int, dtype=torch.bfloat16,
                    family: str = "llama", num_cache_layers: int = 0,
                    device="cuda") -> "OffloadModelRuntime":
        """From a resident param tree (stacked dense entries, per-layer AwqTensor
        tuples) on `device`, for tests and benchmarks. The layers are copied."""
        dev = resolve_device(device)
        layers = params["layers"]
        n = int(layers["input_norm"].shape[0])
        pin = dev.type == "cuda"
        per_layer = []
        for i in range(n):
            lw = {k: v[i] for k, v in layers.items()}
            per_layer.append(map_layer(lambda t: t.to(dev, copy=True).contiguous(), lw)
                             if i < num_cache_layers else map_layer(lambda t: to_host(t, pin), lw))
        top = {k: v for k, v in params.items() if k != "layers"}
        return cls(cfg, top, per_layer, max_length, dtype=dtype, family=family,
                   num_cache_layers=num_cache_layers, device=dev)

    # ---------------------------------------------------------------- streaming

    def _issue_copy(self, j: int, clock=None, copies=None) -> None:
        """Streamed layer j into buffer j % 2, on the side stream, after the
        compute that last read that buffer."""
        b = j % 2
        pairs = zip(layer_tensors(self._buffers[b]),
                    layer_tensors(self.host_layers[self.n_resident + j]))
        if self.device.type != "cuda":
            t0 = clock.mark() if clock else None
            for dst, src in pairs:
                dst.copy_(src)
            if clock:
                copies.append((t0, clock.mark()))
            return
        s = self._copy_stream
        if self._free_recorded[b]:
            s.wait_event(self._free[b])
        with torch.cuda.stream(s):
            t0 = clock.mark(s) if clock else None
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
            if clock:
                copies.append((t0, clock.mark(s)))
            self._ready[b].record(s)

    def _acquire(self, j: int) -> dict:
        """Streamed layer j's weights, the compute stream ordered after its copy."""
        b = j % 2
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_event(self._ready[b])
        return self._buffers[b]

    def _release(self, j: int) -> None:
        """Layer j's compute is the last reader of its buffer until the next copy."""
        b = j % 2
        if self.device.type == "cuda":
            self._free[b].record(torch.cuda.current_stream(self.device))
        self._free_recorded[b] = True

    def _forward(self, kv: KVCache, input_ids, position_ids, attn_mask, write_offset,
                 clock: Optional[_Clock] = None):
        """The layer loop; with `clock`, returns per-layer marks too."""
        top, args = self.top, self.args
        R, n = self.n_resident, self.n_layers
        kv_limit = kv_limit_of(write_offset, input_ids.shape[0], kv)
        hidden = embed_lookup(top["embed"], input_ids, top["final_norm"].dtype)
        issued, marks, copies = 0, [], []
        prev_end = clock.mark() if clock else None
        for i in range(n):
            j = i - R
            # copies run as far ahead as the two buffers allow: j + 1 before layer j
            while issued < self.n_streamed and issued <= max(j, 0) + 1:
                self._issue_copy(issued, clock, copies)
                issued += 1
            lw = self.resident[i] if j < 0 else self._acquire(j)
            start = clock.mark() if clock else None
            hidden, kv = llama_layer(args, lw, hidden, kv, i, position_ids, attn_mask,
                                     write_offset, top["rope_inv_freq"], top["rope_scale"],
                                     kv_limit)
            if j >= 0:
                self._release(j)
            if clock:
                end = clock.mark()
                marks.append((prev_end, start, end))
                prev_end = end
        hidden = rms_norm(hidden, top["final_norm"], args.rms_eps)
        logits = lm_head_logits(top, hidden)
        return (logits, kv) if clock is None else (logits, kv, marks, copies)

    def streamed_forward(self, kv: KVCache, input_ids, position_ids, attn_mask,
                         write_offset):
        """The ModelRuntime.forward contract without params: (fp32 logits
        [S, V], kv updated in place). `write_offset` is a host int or a 0-d
        device tensor. Nothing here waits for the device."""
        return self._forward(kv, input_ids, position_ids, attn_mask, write_offset)

    def streamed_forward_traced(self, kv: KVCache, input_ids, position_ids, attn_mask,
                                write_offset):
        """streamed_forward with per-layer accounting: (logits, kv, stats).
        Per layer, on the compute stream: compute ms, and the exposed stream
        ms (from the end of the layer before to the start of this one: the
        wait for this layer's copy); per streamed layer, its copy's ms on the
        copy stream and its host-to-device GB/s. CUDA events on the card (the
        host waits once, at the end), the host clock on the CPU (where the
        copies are synchronous and wholly exposed, and no GB/s is given)."""
        clock = _Clock(self.device)
        logits, kv, marks, copies = self._forward(kv, input_ids, position_ids, attn_mask,
                                                  write_offset, clock)
        if clock.cuda:
            clock.mark().synchronize()
        per_layer = []
        for i, (prev_end, start, end) in enumerate(marks):
            row = dict(layer=i, compute_ms=clock.ms(start, end),
                       stream_exposed_ms=clock.ms(prev_end, start))
            j = i - self.n_resident
            if j >= 0:
                copy_ms = clock.ms(*copies[j])
                row.update(copy_ms=copy_ms, h2d_gbps=(
                    self.streamed_layer_bytes / copy_ms / 1e6 if clock.cuda else None))
            per_layer.append(row)
        compute = sum(r["compute_ms"] for r in per_layer)
        exposed = sum(r["stream_exposed_ms"] for r in per_layer)
        stream = sum(r.get("copy_ms", 0.0) for r in per_layer)
        n_streamed = max(self.n_streamed, 1)
        stats = dict(
            n_layers=self.n_layers, n_resident=self.n_resident, n_streamed=self.n_streamed,
            streamed_layer_bytes=self.streamed_layer_bytes, compute_ms=compute,
            stream_exposed_ms=exposed, stream_ms=stream,
            overlap="compute-bound" if exposed < 0.1 * compute else "DMA-bound",
            exposed_ms_per_streamed_layer=exposed / n_streamed,
            h2d_gbps=(self.n_streamed * self.streamed_layer_bytes / stream / 1e6
                      if clock.cuda and stream > 0 else None),
            timed_by="cuda_events" if clock.cuda else "host_clock",
            per_layer=per_layer, per_layer_head=per_layer[:4])
        return logits, kv, stats

    # ------------------------------------------------------- the runtime contract

    def forward_phases(self, kv: KVCache) -> list:
        """streamed_forward over `kv` as one eager phase of a step
        (cuda_graphs.Phase): the step values ids, pos, mask and nn (the write
        offset) -> logits. A graphed step runs it between its graphs' replays,
        its side stream and events as they are."""
        def forward(ids, pos, mask, nn):
            return self.streamed_forward(kv, ids, pos, mask, nn)[0]

        return [Phase("streamed_forward", self.device, forward, ("ids", "pos", "mask", "nn"),
                      ("logits",), eager=True)]

    @property
    def forward(self):
        raise RuntimeError("offload runtime has no fused forward; use streamed_forward")

    def init_kv(self, kv_dtype=None) -> KVCache:
        return init_kv_cache(self.cfg, self.max_length, dtype=kv_dtype or self.dtype,
                             num_layers=self.n_layers, device=self.device)

    @property
    def eos_ids(self):
        return self.cfg.eos_token_ids
