"""Shared engine machinery: prefill/append chunking, the decode loops, request API.

Counterpart of `umbrella_tpu/speculation/engine_common.py`. Two decode loops:

- The device-resident loop (`_decode_fused`; `generate` and, in segments of
  `stream_segment` tokens, `speculative_decoding`), the counterpart of the
  JAX package's one-dispatch `decode_loop_fn`. num_nodes, the continue flag,
  the step count and the stop rule (EOS, token budget, context cap) live on
  the device; a step is a gated build + verify + commit that is a no-op once
  the request has stopped. The step is a list of phases (`_step_phases`,
  cuda_graphs.Phase). On the card it is captured once per sampling mode as
  CUDA graphs, one a run of phases on one device (one graph for a resident
  target, or a target staged on one card; a target staged over several
  cards cuts the step at each change of card), and replayed in blocks of
  ceil(room / max_step_advance) replays, room being what is left of the
  budget or of the context, so that only EOS can turn a replay into a no-op;
  the host reads (nn, cont, steps) once a block and the token row once at
  the end. On the CPU the same step runs eagerly (the plain version).
- The stepwise loop (`build_tree(); verify()`, one host read a step), which
  the card's checks compare the graphs against; no engine takes it by
  itself on the card.

Buffers the graphs read stay where they are: prefill, append and reset
write `tokens` and both KV caches in place.

Below temperature 0.05 the verify is greedy; above it, it samples top-k/top-p
from a torch.Generator seeded with `seed` on the engine's device (the JAX
package's `_key`), with the repetition penalty when it is set. The first token
after a prefill is the target's argmax either way, as in the JAX package.

`pipeline_parallel: N` stages the target over N devices (parallel/pipeline.py),
`tensor_parallel: N` shards it Megatron-style (parallel/mesh.py; the target
loaded with packed=False) and `expert_parallel: N` shards an MoE target's
experts (models/moe.shard_runtime_ep; an MoE draft's too): over cuda:i ..
cuda:i+N-1 from the engine's cuda:i, one card a stage or shard, raising a
ValueError when there are fewer; on the CPU every stage or shard is the CPU.
Under a process group (parallel/distributed.py), `tensor_parallel: N` spans
the processes: each holds N / P shards and runs everything else itself, as
the JAX package's engines do under `make_mesh(model=tp)` over the global
device list; the target's forward then runs eagerly between the step's
graphs, its collectives over the group.
A target the caller staged or sharded already (which may put several on one
card) keeps its stages or shards. The three are mutually exclusive. A dense
draft stays whole on the engine's device (the JAX package's replicated
draft).

`offload: true` loads the target as an OffloadModelRuntime (offload/
streaming.py: the first `num_cache_layers` layers on the device, the rest
streamed from pinned host memory), exclusive with every parallel mode as in
the JAX package. Its forward is `streamed_forward` in prefill and verify, and
its decode loop is the pipelined one (`_decode_offload_pipelined`): the host
issues step k+1 while the device runs step k, with num_nodes and the continue
flag on the device, and reads each step's (accept_len, cont, block) back
from pinned memory behind that step's event, one step behind. On the card
the step is the same captured step: the draft phase and the tail each a
graph, the streamed forward run eagerly between them.

The step machinery here is shared by the static and the dynamic engine; each
supplies `_build(nn, cont)` (the draft phase) and the tree's device buffers
`_bitmap`, `_parents`, `_depth` and `_node_in_path`, with `tree_size` and
`max_step_advance` (the most one step commits).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Union

import numpy as np
import torch

from .. import profiling
from ..cuda_graphs import Phase, StepGraph, run_phases
from ..models.auto_model import AutoModelLM, ModelRuntime
from ..models.kv_cache import compact_phases, gather_compact, kv_parts
from ..offload.streaming import OffloadModelRuntime
from ..parallel import distributed
from ..parallel.mesh import shard_runtime, tp_degree
from ..ops.masks import causal_mask_rows, read_window, tree_mask_rows
from ..utils import TextColors, resolve_device, setup_logger
from .base import BaseEngine
from .spec_utils import is_sentence_complete_regex, next_bucket
from .verify import gated_stop, verify_commit, verify_tail

logger = setup_logger()

PREFILL_BUCKETS = (32, 64, 128, 256, 512)
PREFILL_CHUNK = 512

def load_runtime(spec, max_length: int, dtype, device: torch.device, config: dict,
                 packed: bool = True, offload: bool = False):
    """A checkpoint directory -> AutoModelLM.from_pretrained with the engine's
    config (exit_layer, num_cache_layers and the rest; keys it does not use are
    ignored) and `offload` (an OffloadModelRuntime where true); a runtime is
    taken as it is and must live on `device`."""
    if isinstance(spec, str):
        kw = {k: v for k, v in config.items() if k != "offload"}
        return AutoModelLM.from_pretrained(spec, offload=offload, max_length=max_length,
                                           dtype=dtype, packed=packed, device=device, **kw)
    if spec.device != device:
        raise ValueError(f"model on {spec.device}, engine on {device}")
    return spec


def split_devices(target, device: torch.device, pipeline: int = 0, tensor: int = 0,
                  expert: int = 0):
    """The devices to stage or shard `target` over (a checkpoint path or a
    runtime) for the engine's parallel keys: one card each from the engine's
    card on, a ValueError if there are fewer (nothing puts every shard on one
    card unasked), or the CPU n times. None where there is nothing to do or
    the runtime is staged or sharded already (its count must match).

    Under a process group of P processes (parallel/distributed.initialize),
    `tensor_parallel: N` spans the processes: this process takes N / P
    shards. Stages and expert shards stay in one process, as the JAX
    package's pipeline stays on one host: those keys raise there."""
    n = max(pipeline, tensor, expert)
    if n <= 1:
        return None
    key = "pipeline_parallel" if pipeline > 1 else \
        "tensor_parallel" if tensor > 1 else "expert_parallel"
    span = distributed.span()
    if span is not None:
        if tensor <= 1:
            raise ValueError(f"{key}={n} with {span.size} processes: stages and expert shards "
                             "live in one process; span processes with tensor_parallel (and "
                             "the data axis of training)")
        if n % span.size:
            raise ValueError(f"tensor_parallel={n} must split evenly over {span.size} processes")
    if isinstance(target, ModelRuntime):
        have = target.stage_devices if pipeline > 1 else target.shard_devices
        if have is not None:
            count = tp_degree(target.params) if "tp_shards" in target.params else len(have)
            if count != n:
                parts = "staged in {} stages" if pipeline > 1 else "sharded in {} shards"
                raise ValueError(f"target is {parts.format(count)}, {key}={n}")
            return None
    if span is not None:
        n //= span.size
    if device.type != "cuda":
        return [device] * n
    first, count = device.index, torch.cuda.device_count()
    if first + n > count:
        raise ValueError(
            f"{key}={n} needs {n} CUDA devices from {device}, have {count}; to put several "
            "shards or stages on one card, shard or stage the target yourself "
            "(parallel.mesh.shard_runtime, models.moe.shard_runtime_ep, "
            "parallel.pipeline.shard_runtime_pp)")
    return [torch.device("cuda", first + i) for i in range(n)]


def shard_models(target, draft, devices, pipeline: int = 0, tensor: int = 0,
                 expert: int = 0) -> None:
    """Stage or shard the loaded target in place over `devices`
    (split_devices'; None keeps it as the caller staged or sharded it). For
    expert_parallel, an MoE draft is expert-sharded too, over the target's
    shard devices; a dense draft stays whole."""
    if expert > 1 and target.family != "moe":
        raise ValueError("expert_parallel requires an MoE (mixtral-family) target; got family "
                         f"'{target.family}'")
    if devices is not None:
        if pipeline > 1:
            from ..parallel.pipeline import shard_runtime_pp

            shard_runtime_pp(target, devices)
        elif tensor > 1:
            shard_runtime(target, devices, span=distributed.span())
        else:
            from ..models.moe import shard_runtime_ep

            shard_runtime_ep(target, devices)
    if expert > 1 and draft.family == "moe" and draft.shard_devices is None:
        from ..models.moe import shard_runtime_ep

        shard_runtime_ep(draft, target.shard_devices)


def quantize_draft_runtime(draft: ModelRuntime, mode, dtype) -> ModelRuntime:
    """The engines' `quantize_draft`: "int4f" requantizes the draft to Int4F
    (head included); any other true value W4-quantizes an fp draft and its head
    (tied heads from embed.T). Drafts already in that form stay as they are."""
    if not mode:
        return draft
    if draft.family in ("gemma2", "moe"):
        raise ValueError(f"quantize_draft is not supported for {draft.family} drafts")
    if mode == "int4f":
        from ..quantization.int4f import has_int4f_layers, quantize_runtime_int4f

        if has_int4f_layers(draft.params["layers"]):
            return draft
        return quantize_runtime_int4f(draft)
    from ..quantization.awq import has_awq_layers
    from ..quantization.loader import quantize_runtime

    if has_awq_layers(draft.params["layers"]):
        return draft
    return quantize_runtime(draft, dtype=dtype, quantize_lm_head=True)


def target_vocab_cap(draft: ModelRuntime, target: ModelRuntime):
    """The target's vocabulary size where the draft's is wider, else None.

    Such a draft (Mistral-7B-v0.3, V = 32768, drafting for Mixtral-8x7B,
    V = 32000) puts ids at or past the target's V in the tree the target
    verifies. The engines clamp them to the target's last row before its
    embedding (`clamp_draft_ids`), as the JAX package's lookup off the TPU
    does (`lax.dynamic_slice`); the target samples below its V, so it never
    accepts them. The embedding itself stays strict."""
    V = target.cfg.vocab_size
    return V if draft.cfg.vocab_size > V else None


def clamp_draft_ids(ids: torch.Tensor, cap) -> torch.Tensor:
    """Tree ids for the target's forward, clamped below `cap`
    (target_vocab_cap's) where it is set."""
    return ids if cap is None else ids.clamp(max=cap - 1)


def load_tokenizer(path):
    """The tokenizer of a checkpoint directory that ships one (through
    transformers, imported only then), else None: generate() then returns
    token ids and no text."""
    if not isinstance(path, str) or not any(
            os.path.exists(os.path.join(path, f)) for f in ("tokenizer.json",
                                                            "tokenizer_config.json")):
        return None
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SpecEngineBase(BaseEngine):
    """Common state, the step and the loops; subclasses implement initialize
    and `_build` (see the module docstring)."""

    ban_eos_at_prefill = False  # the dynamic engine bans EOS as the first token

    def __init__(self, draft_model_name: Union[str, ModelRuntime],
                 target_model_name: Union[str, ModelRuntime], dtype=torch.bfloat16,
                 device="cuda", **kwargs) -> None:
        self.draft_model_name = draft_model_name
        self.target_model_name = target_model_name
        self.dtype = dtype
        self.device = resolve_device(device)
        self.max_length = kwargs.pop("max_length", 8192)
        self.stop_distance = kwargs.pop("stop_distance", 32)
        self.safe_buffer = kwargs.pop("safe_buffer", 64)
        self.temperature = kwargs.pop("temperature", 0.0)
        self.topp = kwargs.pop("topp", 0.9)
        self.repetition_penalty = kwargs.pop("repetition_penalty", 1.0)
        self.topk = kwargs.pop("topk", 32)
        self.tokenizer = kwargs.pop("tokenizer", None)
        self.eos_token_ids = kwargs.pop("eos_token_ids", None)
        self.seed = kwargs.pop("seed", 0)
        self.kv_dtype = kwargs.pop("kv_dtype", None)  # None => model dtype
        # kept for config parity; the exact top-k serves every recall (ops/sampling)
        self.draft_topk_recall = float(kwargs.pop("draft_topk_recall", 0.99))
        # pipeline_parallel: N stages the TARGET's layer blocks over N devices;
        # tensor_parallel: N shards its tensors; expert_parallel: N its experts
        self.pipeline_parallel = int(kwargs.pop("pipeline_parallel", 0) or 0)
        self.tensor_parallel = int(kwargs.pop("tensor_parallel", 0) or 0)
        self.expert_parallel = int(kwargs.pop("expert_parallel", 0) or 0)
        parallel = [self.tensor_parallel, self.pipeline_parallel, self.expert_parallel]
        if sum(int(n > 1) for n in parallel) > 1:
            raise ValueError("tensor_parallel / pipeline_parallel / expert_parallel are "
                             "mutually exclusive")
        if kwargs.get("offload") and max(parallel) > 1:
            raise ValueError("tensor_parallel / pipeline_parallel / expert_parallel and "
                             "offload are mutually exclusive: they shard or stage resident "
                             "weights, offload streams them from host memory")
        self.config = kwargs

    # ------------------------------------------------------------ model setup

    def _load_model(self, spec, offload: bool = False, packed: bool = True) -> ModelRuntime:
        return load_runtime(spec, self.max_length, self.dtype, self.device, self.config,
                            packed=packed, offload=offload)

    def _init_models_and_state(self):
        target = self.target_model_name
        split = dict(pipeline=self.pipeline_parallel, tensor=self.tensor_parallel,
                     expert=self.expert_parallel)
        devices = split_devices(target, self.device, **split)
        self.draft_model = quantize_draft_runtime(self._load_model(self.draft_model_name),
                                                  self.config.get("quantize_draft"), self.dtype)
        self.target_model = self._load_model(target, offload=bool(self.config.get("offload")),
                                             packed=self.tensor_parallel <= 1)
        self._offload = isinstance(self.target_model, OffloadModelRuntime)
        self._vocab_cap = target_vocab_cap(self.draft_model, self.target_model)
        shard_models(self.target_model, self.draft_model, devices, **split)
        if self.tokenizer is None:
            self.tokenizer = load_tokenizer(self.target_model_name)
        if self.eos_token_ids is None:
            self.eos_token_ids = self.target_model.eos_ids or [-1]
        dev = self.device
        self._eos_arr = torch.tensor(self.eos_token_ids, dtype=torch.int32, device=dev)
        self.tokens_host = np.zeros(self.max_length, np.int32)
        # tokens, both caches and the loop state below are allocated once and
        # written in place from here on: a captured CUDA graph holds their addresses
        self.tokens = torch.zeros(self.max_length, dtype=torch.int32, device=dev)
        self.kv_draft = self.draft_model.init_kv(kv_dtype=self.kv_dtype)
        self.kv_target = self.target_model.init_kv(kv_dtype=self.kv_dtype)
        self.num_nodes = 0
        self._gen = torch.Generator(device=dev).manual_seed(self.seed)
        # the device-resident loop's state (0-d; cont and eos bool, the rest int32)
        self._loop = {k: torch.zeros((), dtype=torch.bool if k in ("cont", "eos") else torch.int32,
                                     device=dev)
                      for k in ("nn", "cont", "start", "max_new", "steps", "eos")}
        self._sampling = {k: torch.zeros((), dtype=torch.float32, device=dev)
                          for k in ("temperature", "topp", "penalty")}
        self._graph_pools = {}  # device -> the graph pool of this engine's graphs there
        self._decode_graphs = {}  # (greedy, topk, use_pen) -> StepGraph, as _decode_loop_cache
        # device-resident loop counters: replays (steps run, live or not),
        # no-op replays (run after a stop inside a block) and blocks (one host read each)
        self.decode_stats = dict(replays=0, noop_replays=0, blocks=0)
        self._last_eos_stop = False

    # ------------------------------------------------------------ prefill

    def _prefill_chunk(self, start: int, bucket: int, n_valid: int, emit: bool):
        """Forward tokens[start : start+bucket] through both models (causal); if
        `emit`, write the target's argmax after row n_valid-1 at tokens[start+n_valid]
        and return it as a device scalar."""
        L = self.max_length
        ids = self.tokens[start:start + bucket]
        pos = torch.arange(start, start + bucket, device=self.device)
        mask = causal_mask_rows(start, bucket, L, device=self.device)
        _, self.kv_draft = self.draft_model.forward(
            self.draft_model.params, self.kv_draft, ids, pos, mask, start)
        logits = self._target_forward(ids, pos, mask, start)
        if not emit:
            return None
        row = logits[n_valid - 1]
        if self.ban_eos_at_prefill:
            vocab = torch.arange(row.shape[0], device=row.device)
            row = row.masked_fill(torch.isin(vocab, self._eos_arr), -torch.inf)
        next_tok = torch.argmax(row).to(torch.int32)
        self.tokens[start + n_valid] = next_tok
        return next_tok

    def _target_forward(self, ids, pos, mask, offset):
        """The target's fp32 logits over ids (its KV cache written in place):
        `streamed_forward` for an offload target, else its forward."""
        if self._offload:
            logits, _ = self.target_model.streamed_forward(self.kv_target, ids, pos, mask,
                                                           offset)
        else:
            logits, _ = self.target_model.forward(self.target_model.params, self.kv_target,
                                                  ids, pos, mask, offset)
        return logits

    def _run_prefix(self, start: int, n_valid: int):
        """Forward tokens[start : start+n_valid] through both models in bucketed
        chunks, emitting the next token at tokens[start+n_valid]."""
        next_tok = None
        off = 0
        while off < n_valid:
            rem = n_valid - off
            bucket = PREFILL_CHUNK if rem > PREFILL_CHUNK else next_bucket(rem, PREFILL_BUCKETS)
            bucket = self._clamp_bucket(start + off, bucket)
            emit = rem <= bucket
            nt = self._prefill_chunk(start + off, bucket, rem if emit else bucket, emit)
            if emit:
                next_tok = nt
            off += min(rem, bucket)
        return next_tok

    def prefill(self, text: str):
        ids = self.tokenizer.encode(text)
        return self._prefill(np.asarray(ids, np.int32))

    def append(self, text: str):
        ids = self.tokenizer.encode(text)
        return self._append(np.asarray(ids[1:], np.int32))

    def _prefill(self, input_ids) -> bool:
        input_ids = np.asarray(input_ids, np.int32).reshape(-1)
        prefix_len = len(input_ids)
        if prefix_len >= self.max_length - 2 * self.safe_buffer:
            return False
        self.tokens_host[:prefix_len] = input_ids
        self.tokens.copy_(torch.from_numpy(self.tokens_host))
        next_tok = self._run_prefix(0, prefix_len)
        self.num_nodes = prefix_len
        self.tokens_host[prefix_len] = int(next_tok)
        return True

    def _append(self, input_ids) -> bool:
        input_ids = np.asarray(input_ids, np.int32).reshape(-1)
        append_len = len(input_ids)
        if append_len + self.num_nodes >= self.max_length - 2 * self.safe_buffer:
            return False
        start = self.num_nodes
        # tokens[start] already holds last iteration's trailing token
        self.tokens_host[start + 1:start + 1 + append_len] = input_ids
        self.tokens.copy_(torch.from_numpy(self.tokens_host))
        n_valid = append_len + 1
        next_tok = self._run_prefix(start, n_valid)
        self.num_nodes = start + n_valid
        self.tokens_host[self.num_nodes] = int(next_tok)
        return True

    # ------------------------------------------------------------ host helpers

    def _commit_verify_result(self, accept_len, eos_found, block) -> bool:
        """Read one step's result back (the step's single host sync), advance
        num_nodes and the host token copy; return the continue flag."""
        out = torch.cat([accept_len.reshape(1).to(torch.int32),
                         eos_found.reshape(1).to(torch.int32), block.to(torch.int32)]).cpu()
        out = out.numpy()
        accept_len, eos_found, block = int(out[0]), bool(out[1]), out[2:]
        old = self.num_nodes
        self.num_nodes = old + accept_len
        end = min(old + len(block), self.max_length)
        self.tokens_host[old:end] = block[:end - old]
        return not eos_found

    def _decode_words(self, generated_ids):
        if self.tokenizer is None:
            return [str(t) for t in generated_ids] or [""]
        return (self.tokenizer.decode(
            generated_ids, skip_special_tokens=True,
            clean_up_tokenization_spaces=False).strip().split(" "))

    def validate_status(self) -> bool:
        return self.num_nodes <= (self.max_length - self.safe_buffer)

    def _clamp_bucket(self, chunk_start: int, bucket: int) -> int:
        """Shrink a padded prefill bucket that would extend past max_length."""
        while chunk_start + bucket > self.max_length and bucket > PREFILL_BUCKETS[0]:
            bucket = PREFILL_BUCKETS[PREFILL_BUCKETS.index(bucket) - 1]
        if chunk_start + bucket > self.max_length:
            raise RuntimeError("prefill chunk exceeds the cache")
        return bucket

    def update_generation_args(self, **generation_args):
        self.temperature = generation_args.pop("temperature", self.temperature)
        self.topp = generation_args.pop("topp", self.topp)
        self.repetition_penalty = generation_args.pop("repetition_penalty",
                                                      self.repetition_penalty)
        self.topk = generation_args.pop("topk", self.topk)

    def reset(self):
        """Back to an empty context, every buffer zeroed in place."""
        self.num_nodes = 0
        self.tokens_host[:] = 0
        self.tokens.zero_()
        for kv in (self.kv_draft, self.kv_target):
            for cache in kv_parts(kv):
                for buf in cache:
                    if buf is not None:
                        buf.zero_()

    # ------------------------------------------------------------ decode loops

    # streamed decode advances in device-resident segments of this many tokens
    # (one host read a block of replays, as the JAX package's segments)
    stream_segment = 32

    def _sampling_mode(self):
        """(greedy, use_pen) for the current generation args; fills the
        persistent device scalars that a step reads them from."""
        for k, v in (("temperature", max(self.temperature, 1e-3)), ("topp", self.topp),
                     ("penalty", self.repetition_penalty)):
            self._sampling[k].fill_(float(v))
        return self.temperature < 0.05, abs(self.repetition_penalty - 1.0) > 0.01

    # ------------------------------------------------------------ the step

    def _target_logits(self, nn):
        ids = clamp_draft_ids(read_window(self.tokens, nn, self.tree_size), self._vocab_cap)
        pos = nn + self._depth
        mask = tree_mask_rows(nn, self._bitmap, self.max_length)
        return self._target_forward(ids, pos, mask, nn)

    def _tail_kw(self, greedy: bool, use_pen: bool) -> dict:
        s = self._sampling
        return dict(tree_size=self.tree_size, greedy=greedy, use_pen=use_pen,
                    generator=self._gen, temperature=s["temperature"], topp=s["topp"],
                    penalty=s["penalty"], topk=self.topk)

    def build_tree(self):
        """The stepwise loop's draft phase at the host num_nodes."""
        self._build(self.num_nodes)

    def verify(self) -> bool:
        """The stepwise loop's verify phase: target forward over the tree
        (streamed for an offload target), sampling (greedy below temperature
        0.05), accept rule, commit, and the step's one host read; returns the
        continue flag."""
        nn = self.num_nodes
        greedy, use_pen = self._sampling_mode()
        accept_len, eos_found, block = verify_tail(
            self._target_logits(nn), self.kv_target, self.kv_draft, self.tokens, nn,
            self._bitmap, self._parents, self._node_in_path, self._eos_arr,
            **self._tail_kw(greedy, use_pen))
        return self._commit_verify_result(accept_len, eos_found, block)

    def _step_phases(self, greedy: bool, use_pen: bool) -> list:
        """One step of the device-resident loop as phases (cuda_graphs.Phase)
        on the engine's persistent state (`_loop`: nn, cont, start, max_new,
        steps, eos; 0-d device tensors), updated in place: the draft build
        and the target's inputs (`draft`); the target's forward phases (one;
        a staged target's embedding, stages and head; an offload target's
        eager streamed forward); sampling, the accept rule, the gated token
        commit and the draft KV's compaction (`commit`); the target KV's
        (a phase a stage, each on its device); the stop rule and the state's
        update (`update`), which packs the step's (accept_len, cont, block)
        as `result`. A no-op where cont is false. No host read."""
        dev, st, T = self.device, self._loop, self.tree_size
        cap = self.max_length - self.safe_buffer
        kw = self._tail_kw(greedy, use_pen)

        def draft():
            nn, cont = st["nn"], st["cont"]
            self._build(nn, cont)
            ids = clamp_draft_ids(read_window(self.tokens, nn, T), self._vocab_cap)
            return (nn, cont, ids, nn + self._depth,
                    tree_mask_rows(nn, self._bitmap, self.max_length))

        def commit(logits, nn, cont):
            alen, eos, block, path = verify_commit(
                logits, self.tokens, nn, self._bitmap, self._parents, self._node_in_path,
                self._eos_arr, cont=cont, **kw)
            gather_compact(self.kv_draft, path, nn, alen)
            return alen, eos, block, path

        def update(nn, cont, alen, eos, block):
            nn_out, cont_out = gated_stop(nn, cont, alen, eos, st["start"], st["max_new"], cap)
            st["steps"].add_(cont.to(torch.int32))
            st["eos"].copy_(torch.where(cont, eos, st["eos"]))
            st["nn"].copy_(nn_out)
            st["cont"].copy_(cont_out)
            return torch.cat([alen.reshape(1), cont_out.reshape(1).to(torch.int32), block])

        return ([Phase("draft", dev, draft, (), ("nn", "cont", "ids", "pos", "mask"),
                       eager=self.draft_model.spans_cards)]
                + self.target_model.forward_phases(self.kv_target)
                + [Phase("commit", dev, commit, ("logits", "nn", "cont"),
                         ("alen", "eos", "block", "path"))]
                + compact_phases(self.kv_target)
                + [Phase("update", dev, update, ("nn", "cont", "alen", "eos", "block"),
                         ("result",))])

    def _decode_step(self, greedy: bool, use_pen: bool) -> torch.Tensor:
        """One step of the device-resident loop run eagerly (its phases in
        order); returns the step's `result`: int32 [accept_len, cont, block]."""
        return run_phases(self._step_phases(greedy, use_pen))["result"]

    def _decode_graph(self, greedy: bool, topk: int, use_pen: bool) -> StepGraph:
        """The captured step for one sampling mode, cached as the JAX
        package's `_decode_loop_cache` is (warmed up as a no-op step): one
        graph a run of phases on one device, an offload target's streamed
        forward run eagerly between two."""
        key = (greedy, topk, use_pen)
        if key not in self._decode_graphs:
            self._decode_graphs[key] = StepGraph.capture(
                self._step_phases(greedy, use_pen), self._graph_pools,
                generators=(self._gen,), idle=self._stopped)
        return self._decode_graphs[key]

    @contextlib.contextmanager
    def _stopped(self):
        """The continue flag off for the block (a step is a no-op), then back."""
        cont = self._loop["cont"].clone()
        self._loop["cont"].fill_(False)
        try:
            yield
        finally:
            self._loop["cont"].copy_(cont)

    def _run_decode_steps(self, n: int, greedy: bool, use_pen: bool) -> torch.Tensor:
        """n steps of the device-resident loop: graph replays on the card, the
        same step run eagerly on the CPU (the plain version). Returns the
        last step's `result`."""
        if self.device.type == "cuda":
            graph = self._decode_graph(greedy, self.topk, use_pen)
            graph.replay(n)
            return graph.output("result")
        return self._eager_decode_steps(n, greedy, use_pen)

    def _eager_decode_steps(self, n: int, greedy: bool, use_pen: bool) -> torch.Tensor:
        """n steps run eagerly, the generator's state kept before each (for
        `_rewind_decode_steps`); returns the last step's `result`."""
        self._gen_states = []
        for _ in range(n):
            self._gen_states.append(self._gen.get_state())
            result = self._decode_step(greedy, use_pen)
        return result

    def _rewind_decode_steps(self, n: int, greedy: bool, use_pen: bool) -> None:
        """Take back the random draws of the last block's n trailing no-op
        steps: the next request draws what it would after the stepwise loop
        (or the JAX package's loop, which exits at once)."""
        if self.device.type == "cuda":
            self._decode_graph(greedy, self.topk, use_pen).rewind(n)
        else:
            self._gen.set_state(self._gen_states[-n])

    def _can_decode_fused(self) -> bool:
        return self.target_model.supports_fused_phases and self.draft_model.supports_fused_phases

    def _decode_fused(self, max_new_tokens: int) -> int:
        """The device-resident decode loop from num_nodes on, for up to
        `max_new_tokens` tokens (the counterpart of the JAX package's
        `_decode_fused`). Replays the step in blocks and reads (nn, cont,
        steps, eos) back after each; syncs the host token row once at the end.
        Returns max(steps, 1); sets self._last_eos_stop."""
        greedy, use_pen = self._sampling_mode()
        st, start = self._loop, self.num_nodes
        cap = self.max_length - self.safe_buffer
        cont = max_new_tokens > 0 and start <= cap  # the while_loop's first test
        for k, v in (("nn", start), ("start", start), ("max_new", max_new_tokens), ("steps", 0),
                     ("cont", cont), ("eos", False)):
            st[k].fill_(v)
        nn, steps, eos = start, 0, False
        while cont:
            room = min(start + max_new_tokens - nn, cap + 1 - nn)
            n = -(-room // self.max_step_advance)
            self._run_decode_steps(n, greedy, use_pen)
            before = steps
            nn, cont, steps, eos = (int(x) for x in torch.stack(
                [st["nn"], st["cont"].int(), st["steps"], st["eos"].int()]).cpu())
            noop = n - (steps - before)
            if noop:
                self._rewind_decode_steps(noop, greedy, use_pen)
            self.decode_stats["replays"] += n
            self.decode_stats["noop_replays"] += noop
            self.decode_stats["blocks"] += 1
        self.tokens_host[:] = self.tokens.cpu().numpy()
        self.num_nodes = nn
        self._last_eos_stop = bool(eos)
        return max(steps, 1)

    def _decode_offload_pipelined(self, max_new_tokens: int, host_stop=None) -> int:
        """The decode loop of an offload target (the JAX package's
        `_decode_offload_pipelined`) run to its end: `_offload_steps`, with
        host_stop(committed tokens) asked after each step whether to stop
        early. Returns the committed steps."""
        steps = 0
        for alen in self._offload_steps(max_new_tokens):
            steps += 1
            if host_stop is not None and host_stop(alen):
                break
        return steps

    def _offload_steps(self, max_new_tokens: int):
        """The pipelined loop of an offload target as a generator: steps on the
        device-resident state (on the card the captured step: the draft
        phase's graph, the streamed forward run eagerly, the tail's graph, as
        JAX's `_offload_step`), the host one step ahead of the device, so
        that step k+1's layer streams and launches overlap step k's tail.
        Each step's (accept_len, cont, block) go to a pinned host buffer with
        a non-blocking copy behind an event; the host waits on the event of
        the step before, never on the device as a whole. Yields each committed
        step's accept length, the host token row already synced; ends where
        the device stopped. The caller may stop at any yield: the step in
        flight then is a gated no-op or left uncommitted (its draws are not
        taken back, as in JAX's loop)."""
        greedy, use_pen = self._sampling_mode()
        st, start = self._loop, self.num_nodes
        for k, v in (("nn", start), ("start", start), ("max_new", max_new_tokens), ("steps", 0),
                     ("cont", True), ("eos", False)):
            st[k].fill_(v)
        cuda = self.device.type == "cuda"
        host = [torch.empty(self.tree_size + 3, dtype=torch.int32, pin_memory=cuda)
                for _ in range(2)]
        pending, k = None, 0
        while True:
            out = self._run_decode_steps(1, greedy, use_pen)
            self.decode_stats["replays"] += 1
            buf = host[k % 2]
            buf.copy_(out, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            if pending is not None:
                alen, cont = self._commit_pending(pending)
                yield alen
                if not cont:
                    return
            pending, k = (buf, event), k + 1

    def _commit_pending(self, pending):
        """Read one finished step's (accept_len, cont, block) from its pinned
        buffer (waiting on that step's event only) and sync the host token
        row. Returns (accept_len, cont)."""
        buf, event = pending
        if event is not None:
            event.synchronize()
        out = buf.numpy()
        alen, cont, block = int(out[0]), bool(out[1]), out[2:]
        old = self.num_nodes
        self.num_nodes = old + alen
        end = min(old + len(block), self.max_length)
        self.tokens_host[old:end] = block[:end - old]
        self._last_eos_stop = not cont
        return alen, cont

    def _decode_stepwise(self, max_new_tokens: int) -> int:
        """The stepwise loop: build_tree(); verify() with a host read each step."""
        steps, decode, start = 0, True, self.num_nodes
        while decode and (self.num_nodes - start) < max_new_tokens and self.validate_status():
            self.build_tree()
            decode = self.verify()
            steps += 1
        return steps

    def _decode_segments(self, max_new_tokens: int):
        """The streaming loop shared by speculative_decoding and
        generate_stream, as a generator: after every commit (a segment of
        `stream_segment` tokens on the device-resident loop, a step on the
        pipelined and the stepwise loops) it yields (words, steps): the text
        decoded so far split on spaces (`_decode_words`) and the large-model
        steps so far. It stops at EOS, the context cap, `max_new_tokens`, or
        at the end of a sentence once `max_new_tokens - stop_distance` tokens
        are committed."""
        start, steps, generated_ids = self.num_nodes, 0, []

        def commit(begin):
            generated_ids.extend(self.tokens_host[begin:self.num_nodes].tolist())
            words = self._decode_words(generated_ids)
            done = (is_sentence_complete_regex(words[-1])
                    and self.num_nodes - start >= max_new_tokens - self.stop_distance) \
                or self.num_nodes - start >= max_new_tokens
            return words, done

        if not self._can_decode_fused() and self._offload:
            # the pipelined loop: each commit streams while the next step is
            # already in flight on the device
            for alen in self._offload_steps(max_new_tokens):
                steps += 1
                words, done = commit(self.num_nodes - alen)
                yield words, steps
                if done:
                    return
            return
        fused, decode = self._can_decode_fused(), True
        while decode and self.validate_status():
            begin = self.num_nodes
            if fused:
                seg = min(self.stream_segment, max(max_new_tokens - (self.num_nodes - start), 1))
                steps += self._decode_fused(seg)
                decode = not self._last_eos_stop
            else:
                self.build_tree()
                decode = self.verify()
                steps += 1
            words, done = commit(begin)
            yield words, steps
            decode = decode and not done

    @staticmethod
    def _perf_log(dec_len: int, steps: int, elapsed: float) -> str:
        return "Output Tokens {} | Avg Accept Tokens {:.2f} | TPOT {:.2f} ms ".format(
            dec_len, dec_len / max(steps, 1), 1000 * elapsed / dec_len)

    def speculative_decoding(self, max_new_tokens: int = 128):
        """Streaming decode: prints words as they commit; returns
        (dec_len, elapsed seconds, large-model steps)."""
        max_new_tokens = max(max_new_tokens, self.stop_distance)
        _sync(self.device)
        t1, start = time.time(), self.num_nodes
        pos, words, steps = 0, [""], 0
        for words, steps in self._decode_segments(max_new_tokens):
            now = len(words) - 1
            if now > pos:
                print(" ".join(words[pos:now]), end=" ", flush=True)
                pos = now
        print(" ".join(words[pos:]), flush=True)
        _sync(self.device)
        dec_len, elapsed = self.num_nodes - start + 1, time.time() - t1
        logger.info(TextColors.colorize(
            "Avg Accept Tokens {:.2f} | TPOT {:.2f} ms ".format(
                dec_len / max(steps, 1), 1000 * elapsed / dec_len), "magenta"))
        return dec_len, elapsed, steps

    def generate_stream(self, **api_args):
        """Streaming generation for one request (the JAX package's
        `generate_stream`): yields (partial_text, perf_log) each time a commit
        completes new words, then the final (text, perf_log); the engine is
        reset afterwards. The budget is max(max_new_tokens, stop_distance)
        and the loop stops at the end of a sentence within stop_distance of
        it. A request that cannot start yields one frame, "Exceeding reserved
        allowed context length" twice."""
        self.update_generation_args(**api_args)
        ok, _ = self._prefill_request(api_args)
        if not ok:
            msg = "Exceeding reserved allowed context length"
            yield msg, msg
            return
        try:
            max_new_tokens = max(api_args.get("max_new_tokens", 128), self.stop_distance)
            t1, start = time.time(), self.num_nodes
            pos, words, steps, text = 0, [""], 0, ""
            for words, steps in self._decode_segments(max_new_tokens):
                now = len(words) - 1
                if now > pos:
                    text += " ".join(words[pos:now]) + " "
                    pos = now
                    yield text, self._perf_log(self.num_nodes - start + 1, steps,
                                               time.time() - t1)
            text += " ".join(words[pos:])
            perf_log = self._perf_log(self.num_nodes - start + 1, steps, time.time() - t1)
            yield text, perf_log
            logger.info(TextColors.colorize(perf_log, "magenta"))
        finally:
            self.reset()

    def _prefill_request(self, api_args):
        """_start_request, then a wait for the device: the `engine.prefill`
        span (profiling.py)."""
        with profiling.span("engine.prefill"):
            ok, early = self._start_request(api_args)
            if ok:
                _sync(self.device)
        return ok, early

    def _start_request(self, api_args):
        input_ids = api_args.get("input_ids", None)
        max_new_tokens = api_args.get("max_new_tokens", 128)
        empty = dict(generated_text="", generated_tokens=[], avg_accept_tokens=0,
                     time_per_output_token=0)
        if input_ids is None:
            context = api_args.get("context", None)
            if context is None or len(context) == 0 or max_new_tokens == 0:
                api_args.update(empty)
                return False, api_args
            success = self.prefill(context)
        else:
            if len(input_ids) == 0 or max_new_tokens == 0:
                api_args.update(empty)
                return False, api_args
            success = self._prefill(np.asarray(input_ids, np.int32))
        if not success:
            api_args.update(empty)
            self.reset()
            return False, api_args
        return True, None

    def generate(self, **api_args):
        """Generation for one request (greedy below temperature 0.05). Returns api_args with
        generated_text, generated_tokens, avg_accept_tokens and
        time_per_output_token (ms); the engine is reset afterwards."""
        self.update_generation_args(**api_args)
        ok, early = self._prefill_request(api_args)
        if not ok:
            return early
        max_new_tokens = api_args.get("max_new_tokens", 128)
        t1 = time.time()
        start = self.num_nodes
        if self._can_decode_fused():
            steps = self._decode_fused(max_new_tokens)
        elif self._offload:
            steps = self._decode_offload_pipelined(max_new_tokens)
        else:
            steps = self._decode_stepwise(max_new_tokens)
        _sync(self.device)
        t2 = time.time()

        dec_len = self.num_nodes - start + 1
        out_tokens = self.tokens_host[start:self.num_nodes + 1].tolist()
        api_args["generated_text"] = (self.tokenizer.decode(
            out_tokens, skip_special_tokens=True, clean_up_tokenization_spaces=False)
            if self.tokenizer else "")
        api_args["generated_tokens"] = out_tokens
        api_args["avg_accept_tokens"] = dec_len / max(steps, 1)
        api_args["time_per_output_token"] = 1000 * (t2 - t1) / dec_len
        self.reset()
        return api_args
