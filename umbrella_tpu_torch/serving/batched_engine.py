"""Multi-slot speculative decoding with continuous batching.

Counterpart of `umbrella_tpu/serving/batched_engine.py`. B request slots decode
in one batched step over a shared static Sequoia tree, each slot with its own
committed length; requests are admitted into free slots between steps
(chunked prefill) and released when they finish. Per-slot temperature, top-p
and repetition penalty are vectors, so greedy and stochastic slots share a step.

Slot lifecycle: admit (chunked prefill into a free slot) -> batched decode steps
(an inactive slot's accept length is forced to 0, so it commits nothing and all
its writes land at or past its num_nodes) -> finish (EOS, budget or context
cap) -> slot released, the next queued request admitted.

Where the JAX package jits a `lax.while_loop` segment, `step_many_async`
replays one captured step n_steps times: `_segment_step` (`_step_body` plus
the active/steps update) is captured as a CUDA graph per (use_pen,
all_greedy) on the card, and runs eagerly on the CPU (the plain version,
`_segment_eager`, which the card's checks also compare against). The step
reads nothing back to the host: per-slot stopping (EOS, budget, context cap)
stays on the device, in persistent buffers (nn, active, stop_at, the step
counts and the per-slot temperature / top-p / penalty vectors) that every
segment refills in place through pinned memory and non-blocking copies, so a
dispatched segment runs while the host goes on. Each segment's results are
copied back the same way behind a CUDA event; `sync_segment` waits on that
event only, so it does not wait for a segment dispatched after it. The JAX
loop also exits early once every slot is done; that needs a host read per
step, so it is dropped here: a segment always runs its n_steps, and steps
after every slot is done change no committed token or KV row. The serial
`step_many` clips n_steps to the largest remaining token budget of its
active slots, which bounds those idle steps. `step()` reads back every step
by contract and stays eager.

Tensor and expert parallelism and the Gemma2/MoE batched forwards are not
ported (ROADMAP queue A, "tensor and expert parallelism" and "Gemma2 and
MoE"); nor is the request scheduler (ROADMAP queue A, "API, scheduler").
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional, Union

import numpy as np
import torch

from ..cuda_graphs import Phase, StepGraph
from ..models.auto_model import ModelRuntime
from ..models.batched import (batched_llama_forward, gather_compact_batched, init_batched_kv,
                              slot_llama_forward)
from ..ops import sampling as S
from ..ops.masks import (causal_mask_rows, causal_mask_rows_batched,
                         tree_level_mask_rows_batched, tree_mask_rows_batched)
from ..speculation.engine_common import load_runtime, load_tokenizer, quantize_draft_runtime
from ..speculation.spec_utils import next_bucket
from ..speculation.tree import GrowMap
from ..speculation.verify import accept_and_commit
from ..utils import resolve_device, setup_logger

logger = setup_logger()

PREFILL_BUCKETS = (32, 64, 128, 256, 512)

_NOT_PORTED = {
    "tensor_parallel": "ROADMAP queue A, tensor and expert parallelism",
    "expert_parallel": "ROADMAP queue A, tensor and expert parallelism",
}


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> a tensor of its own on `device`. On CUDA the copy goes through
    pinned memory and does not block: a blocking host-to-device copy waits for
    every kernel already queued, which would end the pipelined loop's overlap."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def _fill(buf: torch.Tensor, a: np.ndarray) -> None:
    """Copy numpy `a` into the device buffer `buf` in place (through pinned
    memory, not blocking, on CUDA; see _to_device)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if buf.device.type == "cuda":
        buf.copy_(t.pin_memory(), non_blocking=True)
    else:
        buf.copy_(t)


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Start copying `t` into host memory; valid once the stream reaches the
    copy (see BatchedStaticEngine.sync_segment)."""
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _vec(v, default, B: int) -> np.ndarray:
    """A scalar or per-slot sampling parameter as a float32 [B] vector."""
    x = np.asarray(default if v is None else v, np.float32)
    return np.broadcast_to(x, (B,)).copy()


class BatchedStaticEngine:
    """B-slot static-tree speculative decoder over batched KV caches."""

    def __init__(self, draft_model_name: Union[str, ModelRuntime],
                 target_model_name: Union[str, ModelRuntime], batch_size: int = 4,
                 dtype=torch.bfloat16, device="cuda", **kwargs):
        growmap_path = kwargs.pop("growmap_path", None)
        growmap_obj = kwargs.pop("growmap", None)
        if growmap_path is None and growmap_obj is None:
            raise ValueError("Please specify growmap path (or growmap object) for static trees")
        self.growmap_path, self.growmap_obj = growmap_path, growmap_obj
        self.draft_model_name = draft_model_name
        self.target_model_name = target_model_name
        self.batch_size = batch_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self.max_length = kwargs.pop("max_length", 4096)
        self.safe_buffer = kwargs.pop("safe_buffer", 64)
        self.topk = kwargs.pop("topk", 32)  # top-k width of the stochastic verify sampler
        # decode steps per segment: the host syncs once per segment (admission points)
        self.segment_steps = kwargs.pop("segment_steps", 8)
        # prefill chunks the serving loop may run per segment boundary while
        # other slots decode (see ContinuousBatcher.admission_budget)
        self.prefill_chunks_per_segment = int(kwargs.pop("prefill_chunks_per_segment", 1))
        self.tokenizer = kwargs.pop("tokenizer", None)
        self.eos_token_ids = kwargs.pop("eos_token_ids", None)
        self.seed = kwargs.pop("seed", 0)
        # default per-request sampling params (requests may override per slot)
        self.temperature = kwargs.pop("temperature", 0.0)
        self.topp = kwargs.pop("topp", 0.9)
        self.repetition_penalty = kwargs.pop("repetition_penalty", 1.0)
        # kept for config parity; the exact top-k serves every recall (ops/sampling)
        self.draft_topk_recall = float(kwargs.pop("draft_topk_recall", 0.99))
        # None => model dtype; "int8" halves KV traffic (per-slot-scaled int8
        # values, read as int8 by the batched flash kernel)
        self.kv_dtype = kwargs.pop("kv_dtype", None)
        self.quantize_draft = kwargs.pop("quantize_draft", False)
        if int(kwargs.pop("pipeline_parallel", 0) or 0) > 1:
            raise ValueError("BatchedStaticEngine does not support pipeline_parallel")
        if kwargs.pop("offload", False):
            raise ValueError("BatchedStaticEngine requires resident models (no offload)")
        for key, item in _NOT_PORTED.items():
            value = kwargs.pop(key, None)
            if value and not (key.endswith("_parallel") and int(value) <= 1):
                raise NotImplementedError(f"'{key}' is not ported yet ({item})")
        self.config = kwargs

    # ------------------------------------------------------------------ setup

    def _load(self, spec) -> ModelRuntime:
        return load_runtime(spec, self.max_length, self.dtype, self.device, self.config)

    def initialize(self):
        if self.growmap_obj is not None:
            gm = self.growmap_obj if isinstance(self.growmap_obj, GrowMap) \
                else GrowMap.from_dict(self.growmap_obj)
        else:
            gm = GrowMap.from_json(self.growmap_path)
        gm.validate()
        self.growmap = gm
        self.tree_size = gm.size
        # the stop margin must cover a whole tree write
        self.safe_buffer = max(self.safe_buffer, self.tree_size + 1)

        self.draft_model = self._load(self.draft_model_name)
        self.target_model = self._load(self.target_model_name)
        if not all(isinstance(m, ModelRuntime) for m in (self.draft_model, self.target_model)):
            raise ValueError("the batched engine requires resident (non-offload) models")
        self.draft_model = quantize_draft_runtime(self.draft_model, self.quantize_draft,
                                                  self.dtype)
        if self.tokenizer is None:
            self.tokenizer = load_tokenizer(self.target_model_name)
        if self.eos_token_ids is None:
            self.eos_token_ids = self.target_model.eos_ids or [-1]

        B, L, dev = self.batch_size, self.max_length, self.device
        # column L is a sink for window writes that run past the end of a row
        self.tokens = torch.zeros((B, L + 1), dtype=torch.int32, device=dev)
        self.tokens_host = np.zeros((B, L), np.int32)
        self.num_nodes = np.zeros(B, np.int64)
        self.active = np.zeros(B, bool)
        kv_dt = self.kv_dtype or self.dtype
        self.kv_draft = init_batched_kv(self.draft_model.cfg, B, L, kv_dt,
                                        num_layers=self.draft_model.args.n_layers, device=dev)
        self.kv_target = init_batched_kv(self.target_model.cfg, B, L, kv_dt,
                                         num_layers=self.target_model.args.n_layers, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(int(self.seed))

        self._levels = []
        for lvl in range(gm.num_levels):
            last = lvl == gm.num_levels - 1
            self._levels.append(dict(
                start=gm.level_start(lvl), n=len(gm.roots[lvl]),
                topk=0 if last else gm.level_topk(lvl),
                depth=torch.as_tensor(gm.depth[gm.level_nodes(lvl)], device=dev).to(torch.int32),
                gather=None if last else torch.as_tensor(gm.level_gather_indices(lvl),
                                                         device=dev).long()))
        # deferred-leaf build (as in the static engine): the last level's forward
        # is skipped, and level 0 re-runs the last two committed slots causally
        self._defer_leaf = gm.num_levels >= 2
        self._bitmap = torch.as_tensor(gm.bitmap, device=dev)
        self._depth = torch.as_tensor(gm.depth, device=dev).to(torch.int32)
        self._parents = torch.as_tensor(gm.parents, device=dev).long()
        self._node_in_path = torch.as_tensor(gm.node_in_path, device=dev).long()
        self._eos = torch.as_tensor(np.asarray(self.eos_token_ids, np.int32), device=dev)
        # the segment's persistent inputs and state (a captured graph holds
        # their addresses): refilled in place before each segment
        self._seg = dict(nn=torch.zeros(B, dtype=torch.int32, device=dev),
                         active=torch.zeros(B, dtype=torch.bool, device=dev),
                         stop=torch.zeros(B, dtype=torch.int32, device=dev),
                         steps=torch.zeros(B, dtype=torch.int32, device=dev),
                         **{k: torch.zeros(B, dtype=torch.float32, device=dev)
                            for k in ("tv", "pv", "rv")})
        self._dev_nn = None  # the device-carried nn/active (async segments), when valid
        self._dev_active = None
        self.steps_dispatched = 0  # decode steps queued so far (all slots at once)
        self._graph_pools = {}  # device -> the graph pool of this engine's graphs
        self._segment_graphs = {}  # (use_pen, all_greedy) -> StepGraph

    # ------------------------------------------------------------------ token rows

    def _row_cols(self, starts: torch.Tensor, n: int) -> torch.Tensor:
        return starts.long()[:, None] + torch.arange(n, device=self.device)[None, :]

    def _slice_rows(self, starts: torch.Tensor, n: int) -> torch.Tensor:
        """[B, n]: tokens[b, starts[b] : starts[b] + n]; columns past the row read 0."""
        cols = self._row_cols(starts, n)
        L = self.max_length
        vals = torch.gather(self.tokens, 1, cols.clamp(0, L))
        return torch.where(cols < L, vals, 0)

    def _write_rows(self, rows: torch.Tensor, starts: torch.Tensor) -> None:
        """tokens[b, starts[b] : starts[b] + n] = rows[b]; columns past the row are
        dropped (written to the sink column)."""
        cols = self._row_cols(starts, rows.shape[1])
        L = self.max_length
        self.tokens.scatter_(1, torch.where(cols < L, cols, L), rows.to(torch.int32))

    # ------------------------------------------------------------------ one step

    def _draft_forward(self, ids, pos, mask, offsets):
        m = self.draft_model
        return batched_llama_forward(m.params, m.args, self.kv_draft, ids, pos, mask,
                                     offsets)[0]

    def _build_tree(self, nn: torch.Tensor) -> None:
        """Draft forwards level by level; writes each level's children into tokens."""
        L = self.max_length
        n_levels = len(self._levels)
        for lvl, lv in enumerate(self._levels):
            if self._defer_leaf and lvl == n_levels - 1:
                continue  # leaf KV deferred to the next step's level 0
            n = lv["n"]
            if self._defer_leaf and lvl == 0:
                # never-admitted slots have nn == 0: clamp so they attend a live row
                starts = (nn - 1).clamp(min=0)
                ids = self._slice_rows(starts, 2)
                pos = self._row_cols(starts, 2)
                logits = self._draft_forward(ids, pos, causal_mask_rows_batched(starts, 2, L),
                                             starts)[:, 1:2]  # expansion from the root row
            else:
                starts = nn + lv["start"]
                ids = self._slice_rows(starts, n)
                pos = nn[:, None] + lv["depth"][None, :]
                mask = tree_level_mask_rows_batched(nn, self._bitmap, lv["start"], n, L)
                logits = self._draft_forward(ids, pos, mask, starts)
            if lv["topk"] > 0:
                cand = S.draft_topk(logits.reshape(-1, logits.shape[-1]), lv["topk"],
                                    self.draft_topk_recall)[1].reshape(nn.shape[0], -1)
                self._write_rows(cand[:, lv["gather"]], nn + lv["start"] + n)

    def _step_body(self, nn: torch.Tensor, active: torch.Tensor, tv: torch.Tensor,
                   pv: torch.Tensor, rv: torch.Tensor, use_pen: bool, all_greedy: bool):
        """One batched build + verify + commit on device tensors (nn [B] int32,
        active [B] bool); no host read. Returns (nn + alen, alen, block, eos)."""
        B, T, L = self.batch_size, self.tree_size, self.max_length
        cap = L - self.safe_buffer
        self._build_tree(nn)
        ids = self._slice_rows(nn, T)
        pos = nn[:, None] + self._depth[None, :]
        mask = tree_mask_rows_batched(nn, self._bitmap, L)
        m = self.target_model
        logits, _ = batched_llama_forward(m.params, m.args, self.kv_target, ids, pos, mask, nn)
        if use_pen:
            logits = S.apply_repetition_penalty(logits, self.tokens[:, :L], nn + 1, rv)
        sampled = torch.argmax(logits, dim=-1).to(torch.int32)
        if not all_greedy:
            # one [B*T, V] top-k, then a k-wide softmax / nucleus / Gumbel draw
            stoch = S.sample_top_k_top_p_rows(
                self._gen, logits.reshape(B * T, -1),
                tv.clamp(min=1e-3)[:, None].expand(B, T).reshape(-1), self.topk,
                pv[:, None].expand(B, T).reshape(-1)).reshape(B, T)
            sampled = torch.where((tv < 0.05)[:, None], sampled, stoch)
        old_block = self._slice_rows(nn, T + 1)
        block, path, alen, eos = accept_and_commit(ids, sampled, old_block, self._bitmap,
                                                   self._parents, self._node_in_path, self._eos)
        # inactive slots commit nothing; slots at the context cap freeze
        alen = torch.where(active & (nn + alen <= cap), alen, 0).to(torch.int32)
        eos = eos & active
        self._write_rows(block, nn)
        gather_compact_batched(self.kv_target, path, nn, alen)
        gather_compact_batched(self.kv_draft, path, nn, alen)
        return nn + alen, alen, block, eos

    def _sampling_inputs(self, temperature, topp, penalty):
        """Per-slot (tv, pv, rv) float32 [B] vectors on the host, use_pen, all_greedy."""
        B = self.batch_size
        tv = _vec(temperature, self.temperature, B)
        pv = _vec(topp, self.topp, B)
        rv = _vec(penalty, self.repetition_penalty, B)
        # |p - 1|: penalties below 1 (encourage repetition) are valid too
        use_pen = bool(np.any(np.abs(rv - 1.0) > 0.01))
        all_greedy = bool(np.all(tv < 0.05))
        return tv, pv, rv, use_pen, all_greedy

    def _segment_step(self, use_pen: bool, all_greedy: bool) -> None:
        """One step of a segment on the persistent buffers, updated in place:
        _step_body, then the step counts and the active flags (a slot stops
        on EOS, at its stop_at, and within one tree of the context cap: past
        it the step gates the accept length to 0 and the slot would idle
        forever). No host read."""
        sg, T = self._seg, self.tree_size
        cap = self.max_length - self.safe_buffer
        nn, active = sg["nn"], sg["active"]
        nn_new, _, _, eos = self._step_body(nn, active, sg["tv"], sg["pv"], sg["rv"], use_pen,
                                            all_greedy)
        sg["steps"].add_(active.to(torch.int32))
        active.copy_(active & ~eos & (nn_new < sg["stop"]) & (nn_new + T + 1 <= cap))
        nn.copy_(nn_new)

    def _run_segment(self, n_steps: int, use_pen: bool, all_greedy: bool) -> None:
        """n_steps segment steps: graph replays on the card, eager on the CPU."""
        run = self._segment_graphed if self.device.type == "cuda" else self._segment_eager
        run(n_steps, use_pen, all_greedy)

    def _segment_eager(self, n_steps: int, use_pen: bool, all_greedy: bool) -> None:
        for _ in range(n_steps):
            self._segment_step(use_pen, all_greedy)

    def _segment_graphed(self, n_steps: int, use_pen: bool, all_greedy: bool) -> None:
        """n_steps replays of the captured segment step (captured at its
        mode's first use, warmed up with every slot inactive, which writes
        only scratch rows)."""
        key = (use_pen, all_greedy)
        if key not in self._segment_graphs:
            step = Phase("segment_step", self.device,
                         lambda: self._segment_step(use_pen, all_greedy))
            self._segment_graphs[key] = StepGraph.capture(
                [step], self._graph_pools, generators=(self._gen,), idle=self._all_inactive)
        self._segment_graphs[key].replay(n_steps)

    @contextlib.contextmanager
    def _all_inactive(self):
        """Every slot inactive for the block (a step is a no-op), then back."""
        active = self._seg["active"].clone()
        self._seg["active"].zero_()
        try:
            yield
        finally:
            self._seg["active"].copy_(active)

    # ------------------------------------------------------------------ slots

    def free_slots(self) -> List[int]:
        return [b for b in range(self.batch_size) if not self.active[b]]

    def begin_admission(self, slot: int, input_ids) -> Optional[dict]:
        """Stage a chunked prefill into `slot` (the slot stays inactive until
        every chunk has run). Returns a resumable admission state for
        `advance_admission`, or None if the request cannot fit."""
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        n = len(ids)
        if n == 0 or n >= self.max_length - 2 * self.safe_buffer:
            return None
        # Point the slot's scratch region past the incoming prompt at once:
        # decode steps run between this admission's chunks still write the
        # inactive slot's tree/KV scratch at rows >= num_nodes[slot], so those
        # writes never touch rows the chunked prefill has already written (row
        # n-1 is rewritten by the final chunk, rows >= n by the first step).
        self.num_nodes[slot] = n
        return {"slot": slot, "ids": ids, "off": 0, "failed": False}

    def _prefill_chunk(self, slot: int, start: int, prompt: np.ndarray, n_valid: int,
                       emit: bool):
        """Forward tokens[slot, start : start + bucket] (the padded prompt chunk)
        through both models into the slot's cache rows; if `emit`, write the
        target's argmax after row n_valid - 1 at tokens[slot, start + n_valid]."""
        bucket = len(prompt)
        dev, L = self.device, self.max_length
        self.tokens[slot, start:start + bucket] = _to_device(prompt, dev)
        ids = self.tokens[slot, start:start + bucket]
        pos = torch.arange(start, start + bucket, device=dev)
        mask = causal_mask_rows(start, bucket, L, device=dev)
        d, t = self.draft_model, self.target_model
        slot_llama_forward(d.params, d.args, self.kv_draft, ids, pos, mask, slot, start)
        logits, _ = slot_llama_forward(t.params, t.args, self.kv_target, ids, pos, mask, slot,
                                       start)
        if not emit:
            return None
        next_tok = torch.argmax(logits[n_valid - 1]).to(torch.int32)
        self.tokens[slot, start + n_valid] = next_tok
        return next_tok

    def advance_admission(self, st: dict, max_chunks: int = 1 << 30, fetch: bool = True) -> bool:
        """Run up to `max_chunks` prefill chunks of a staged admission; returns
        True when the admission is finished (check st["failed"]). On the final
        chunk the slot's bookkeeping is committed and, with `fetch`, the slot
        activates and its first token is read to the host. fetch=False (the
        pipelined loop) reads nothing back: the chunks queue behind the
        in-flight segment and the token reaches tokens_host with the next sync."""
        ids, slot = st["ids"], st["slot"]
        n = len(ids)
        CH = PREFILL_BUCKETS[-1]
        for _ in range(max_chunks):
            off = st["off"]
            rem = n - off
            bucket = CH if rem > CH else next_bucket(rem, PREFILL_BUCKETS)
            # never let a padded chunk extend past the cache end
            while off + bucket > self.max_length and bucket > PREFILL_BUCKETS[0]:
                bucket = PREFILL_BUCKETS[PREFILL_BUCKETS.index(bucket) - 1]
            if off + bucket > self.max_length:
                st["failed"] = True
                return True
            emit = rem <= bucket
            prompt = np.zeros(bucket, np.int32)
            prompt[:min(rem, bucket)] = ids[off:off + min(rem, bucket)]
            next_tok = self._prefill_chunk(slot, off, prompt, rem if emit else bucket, emit)
            st["off"] = off + min(rem, bucket)
            if st["off"] >= n:
                if fetch:
                    self.tokens_host[slot, :n] = ids
                    self.tokens_host[slot, n] = int(next_tok)
                    self.active[slot] = True
                self.num_nodes[slot] = n
                return True
        return False

    def admit(self, slot: int, input_ids) -> bool:
        """Synchronous whole-prompt admission; returns False if it cannot fit."""
        st = self.begin_admission(slot, input_ids)
        if st is None:
            return False
        self.advance_admission(st)
        return not st["failed"]

    def release(self, slot: int):
        self.active[slot] = False

    # ------------------------------------------------------------------ decoding

    def step(self, temperature=None, topp=None, penalty=None) -> dict:
        """One batched build + verify step over all slots, synced. Returns
        {slot: (accept_len, eos_found)} for the active slots."""
        B, T, dev = self.batch_size, self.tree_size, self.device
        tv, pv, rv, use_pen, all_greedy = self._sampling_inputs(temperature, topp, penalty)
        nn = _to_device(self.num_nodes.astype(np.int32), dev)
        active = _to_device(self.active, dev)
        _, alen, block, eos = self._step_body(nn, active, _to_device(tv, dev), _to_device(pv, dev),
                                              _to_device(rv, dev), use_pen, all_greedy)
        out = torch.cat([alen[:, None], eos[:, None].to(torch.int32), block], dim=1).cpu().numpy()
        results = {}
        for b in range(B):
            if not self.active[b]:
                continue
            old, a = int(self.num_nodes[b]), int(out[b, 0])
            end = min(old + T + 1, self.max_length)
            self.tokens_host[b, old:end] = out[b, 2:2 + end - old]
            self.num_nodes[b] = old + a
            results[b] = (a, bool(out[b, 1]))
        self._dev_nn = self._dev_active = None  # host mirrors authoritative
        return results

    def step_many_async(self, n_steps: int, stop_at, temperature=None, topp=None, penalty=None,
                        set_nn=None, activate=None) -> dict:
        """Queue `n_steps` batched decode steps without reading anything back (the
        pipelined serving loop's primitive). nn/active are carried on the
        device: the first call seeds them from the host mirrors, later calls
        chain on the previous segment's outputs.

        set_nn: {slot: length} re-points a freed slot's scratch region at a
        staged admission's prompt length; activate: slots whose chunked prefill
        completed, which join decoding in this segment. Returns a handle for
        `sync_segment`."""
        B, dev, sg = self.batch_size, self.device, self._seg
        tv, pv, rv, use_pen, all_greedy = self._sampling_inputs(temperature, topp, penalty)
        if self._dev_nn is None:
            _fill(sg["nn"], self.num_nodes.astype(np.int32))
            _fill(sg["active"], self.active)
            self._dev_nn, self._dev_active = sg["nn"], sg["active"]
        if set_nn or activate:
            mask = np.zeros(B, bool)
            val = np.zeros(B, np.int32)
            act = np.zeros(B, bool)
            for s, n in (set_nn or {}).items():
                mask[s], val[s] = True, n
            for s in (activate or ()):
                act[s] = True
            sg["nn"].copy_(torch.where(_to_device(mask, dev), _to_device(val, dev), sg["nn"]))
            sg["active"].logical_or_(_to_device(act, dev))
        for k, v in (("stop", np.asarray(stop_at, np.int32)), ("tv", tv), ("pv", pv), ("rv", rv)):
            _fill(sg[k], v)
        sg["steps"].zero_()
        self.steps_dispatched += int(n_steps)
        self._run_segment(int(n_steps), use_pen, all_greedy)
        meta = _to_host_async(torch.stack([sg["nn"], sg["active"].to(torch.int32), sg["steps"]]))
        tokens = _to_host_async(self.tokens[:, :self.max_length])
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))  # this engine's card, not the current one
        return dict(meta=meta, tokens=tokens, event=event)

    def sync_segment(self, handle: dict) -> np.ndarray:
        """Wait for a queued segment's results (segments queued after it keep
        running) and update the host mirrors wholesale. Returns per-slot
        active-step counts."""
        if handle["event"] is not None:
            handle["event"].synchronize()
        meta = handle["meta"].numpy()
        self.tokens_host = handle["tokens"].numpy().copy()
        self.num_nodes = meta[0].astype(np.int64)
        self.active = meta[1].astype(bool)
        return meta[2].copy()

    def step_many(self, n_steps: int, stop_at, temperature=None, topp=None,
                  penalty=None) -> np.ndarray:
        """Run up to `n_steps` batched decode steps and sync once.

        stop_at[b] is the absolute committed length at which slot b stops
        (admission length + its token budget); EOS, budget and context cap
        stop slots on the device. An active slot commits at least one token a
        step, so no slot is active past max(stop_at - num_nodes) steps: the
        segment is clipped there. Returns per-slot active-step counts."""
        stop = np.asarray(stop_at, np.int64)
        left = stop[self.active] - self.num_nodes[self.active]
        n_steps = min(int(n_steps), int(left.max(initial=0)))
        if n_steps <= 0:
            return np.zeros(self.batch_size, np.int32)
        handle = self.step_many_async(n_steps, stop_at, temperature, topp, penalty)
        steps = self.sync_segment(handle)
        # serial callers mutate the host mirrors between segments (admit writes
        # num_nodes): drop the device-carried state so the next call re-seeds
        self._dev_nn = self._dev_active = None
        return steps

    # ------------------------------------------------------------------ serving loop

    def run(self, requests: List[dict], segment_steps: Optional[int] = None) -> List[dict]:
        """Continuous batching over a request list. Each request: {input_ids,
        max_new_tokens, temperature?, topp?, repetition_penalty?}. Returns
        per-request result dicts in input order; the host syncs once per
        segment of `segment_steps` steps."""
        seg = segment_steps or self.segment_steps
        queue = deque(enumerate(requests))
        st = _SlotTracker(self)
        results = [None] * len(requests)
        t0 = time.time()
        total_steps = 0

        def admit_from_queue():
            for b in self.free_slots():
                if not queue:
                    break
                idx, req = queue.popleft()
                if not st.try_admit(b, idx, req):
                    results[idx] = dict(_EMPTY_RESULT)

        admit_from_queue()
        while any(self.active):
            tv, pv, rv = st.sampling_vectors()
            steps_seg = self.step_many(seg, st.stop_at, tv, pv, rv)
            total_steps += int(steps_seg.max(initial=0))
            for _b, idx, result in st.harvest(steps_seg):
                results[idx] = result
            admit_from_queue()
        elapsed = time.time() - t0
        total_tokens = sum(len(r["generated_tokens"]) for r in results if r)
        logger.info("continuous batching: %d requests, %d steps, %.1f tok/s", len(requests),
                    total_steps, total_tokens / max(elapsed, 1e-9))
        return results


_EMPTY_RESULT = dict(generated_text="", generated_tokens=[], avg_accept_tokens=0,
                     time_per_output_token=0, ttft_ms=0)


def _resolve(fut: Future, result) -> None:
    """Set a future's result unless it is already resolved (shutdown may have
    failed it while the loop was still running)."""
    try:
        fut.set_result(result)
    except InvalidStateError:
        pass


class _SlotTracker:
    """Slot bookkeeping shared by BatchedStaticEngine.run and
    ContinuousBatcher's loops: admission, per-slot sampling vectors and
    budget-clamped harvest, in one implementation.

    `lock` guards slot_req and pending, which the serving loop changes and
    ContinuousBatcher.shutdown reads from another thread (`futures()`)."""

    def __init__(self, eng: BatchedStaticEngine):
        self.eng = eng
        self.lock = threading.Lock()
        self.slot_req = {}    # slot -> (tag, request); tag is caller-defined
        self.slot_start = {}  # slot -> committed length at admission
        self.slot_steps = {}
        self.max_new = {}
        self.stop_at = np.full(eng.batch_size, 1 << 30, np.int32)
        self.pending = {}     # slot -> (admission state, tag, request)
        self.emitted = {}     # slot -> tokens already sent to its stream_cb
        self._rr_last = -1    # round-robin pointer over pending admissions
        self.submit_t = {}    # request arrival (req _submit_time, else admission)
        self.decode_t0 = {}   # prefill done / decode start
        self.first_tok_t = {}  # first sync at which committed tokens were seen

    def futures(self) -> list:
        """Tags of every in-flight and staged request, read consistently."""
        with self.lock:
            return ([tag for tag, _req in self.slot_req.values()]
                    + [tag for _st, tag, _req in self.pending.values()])

    def extract_ids(self, req):
        ids = req.get("input_ids")
        if ids is None and self.eng.tokenizer is not None:
            ids = self.eng.tokenizer.encode(req.get("context", ""))
        if ids is None:
            return None
        ids = np.asarray(ids, np.int32).reshape(-1)
        return ids if ids.size else None

    def _register(self, slot: int, tag, req, start: int):
        """Start a slot's request; `start` is its prompt length (the engine's
        num_nodes mirror lags one segment in the pipelined loop)."""
        now = time.time()
        with self.lock:
            self.slot_req[slot] = (tag, req)
        self.slot_start[slot] = int(start)
        self.slot_steps[slot] = 0
        self.submit_t[slot] = float(req.get("_submit_time") or now)
        self.decode_t0[slot] = now
        self.first_tok_t[slot] = None
        self.max_new[slot] = int(req.get("max_new_tokens", 128))
        self.stop_at[slot] = self.slot_start[slot] + self.max_new[slot]

    def try_admit(self, slot: int, tag, req) -> bool:
        """Synchronous whole-prompt admission (run()'s path)."""
        ids = self.extract_ids(req)
        st = None if ids is None else self.eng.begin_admission(slot, ids)
        if st is None:
            return False
        self.eng.advance_admission(st)
        if st["failed"]:
            return False
        self._register(slot, tag, req, start=len(st["ids"]))
        return True

    def occupied(self):
        """Slots that must not take a new request (decoding or mid-admission)."""
        return set(self.slot_req) | set(self.pending)

    def begin_admit(self, slot: int, tag, req) -> bool:
        """Stage an admission for chunk-at-a-time progress (the serving loop's path)."""
        ids = self.extract_ids(req)
        st = None if ids is None else self.eng.begin_admission(slot, ids)
        if st is None:
            return False
        with self.lock:
            self.pending[slot] = (st, tag, req)
        return True

    def advance_admissions(self, max_chunks: int, fetch: bool = True):
        """Advance pending admissions by up to max_chunks prefill chunks in all,
        round-robin over slots so one long prompt cannot starve the rest.
        Returns [(slot, tag, ok)] for admissions that completed."""
        done = []
        budget = max_chunks
        order = sorted(self.pending)
        order = [s for s in order if s > self._rr_last] + [s for s in order if s <= self._rr_last]
        for slot in order:
            if budget <= 0:
                break
            st, tag, req = self.pending[slot]
            budget -= 1
            self._rr_last = slot
            if not self.eng.advance_admission(st, max_chunks=1, fetch=fetch):
                continue
            with self.lock:
                del self.pending[slot]
            if st["failed"]:
                done.append((slot, tag, False))
            else:
                self._register(slot, tag, req, start=len(st["ids"]))
                done.append((slot, tag, True))
        return done

    def emit_partials(self):
        """Send newly committed text to each streaming request's stream_cb as
        (partial_text_so_far, perf_log) frames."""
        eng = self.eng
        for b, (_tag, req) in list(self.slot_req.items()):
            cb = req.get("stream_cb")
            if cb is None or self.slot_steps[b] == 0:
                # slot_steps == 0: in the pipelined loop the mirrors may still
                # show the slot's previous occupant until its first active
                # segment has synced
                continue
            end = min(int(eng.num_nodes[b]), self.slot_start[b] + self.max_new[b])
            ntok = end - self.slot_start[b]
            if ntok <= self.emitted.get(b, 0):
                continue
            self.emitted[b] = ntok
            toks = eng.tokens_host[b, self.slot_start[b]:end].tolist()
            text = (eng.tokenizer.decode(toks, skip_special_tokens=True,
                                         clean_up_tokenization_spaces=False)
                    if eng.tokenizer else "")
            perf = "Output Tokens {} | Avg Accept Tokens {:.2f} ".format(
                ntok, ntok / max(self.slot_steps[b], 1))
            try:
                cb(text, perf)
            except Exception:  # a broken client must not stop the batch
                logger.exception("stream_cb failed")

    def sampling_vectors(self):
        eng = self.eng
        B = eng.batch_size
        # inactive slots get greedy / no-penalty placeholders, so an all-greedy
        # batch keeps the greedy-only step
        tv = np.zeros(B, np.float32)
        pv = np.full(B, eng.topp, np.float32)
        rv = np.ones(B, np.float32)
        for b, (_, req) in self.slot_req.items():
            tv[b] = req.get("temperature", eng.temperature)
            pv[b] = req.get("topp", eng.topp)
            rv[b] = req.get("repetition_penalty", eng.repetition_penalty)
        return tv, pv, rv

    def harvest(self, steps_seg):
        """[(slot, tag, result)] for slots that finished this segment; releases
        them. Output is clamped to the request budget (an accepted path can
        overshoot stop_at by up to tree_size tokens): a client gets at most
        max_new_tokens + 1 tokens. `time_per_output_token` is this request's
        decode wall time over its token count; `ttft_ms` the wall time from
        submission to the first sync that showed committed tokens."""
        eng = self.eng
        now = time.time()
        done = []
        for b in list(self.slot_req):
            self.slot_steps[b] += int(steps_seg[b])
            if (self.first_tok_t.get(b) is None and self.slot_steps[b] > 0
                    and int(eng.num_nodes[b]) > self.slot_start[b]):
                self.first_tok_t[b] = now
            if eng.active[b]:
                continue  # still decoding
            if self.slot_steps[b] == 0:
                # pipelined loop: the synced segment predates this slot's first
                # active segment (its activation rides the next dispatch)
                continue
            tag, req = self.slot_req[b]
            end = min(int(eng.num_nodes[b]), self.slot_start[b] + self.max_new[b])
            toks = eng.tokens_host[b, self.slot_start[b]:end + 1].tolist()
            text = (eng.tokenizer.decode(toks, skip_special_tokens=True,
                                         clean_up_tokenization_spaces=False)
                    if eng.tokenizer else "")
            t_first = self.first_tok_t.get(b) or now
            done.append((b, tag, dict(
                generated_text=text, generated_tokens=toks,
                avg_accept_tokens=len(toks) / max(self.slot_steps[b], 1),
                time_per_output_token=1000.0 * (now - self.decode_t0[b]) / max(len(toks), 1),
                ttft_ms=1000.0 * (t_first - self.submit_t[b]))))
            eng.release(b)
            self.emitted.pop(b, None)
            with self.lock:
                del self.slot_req[b]
            del (self.slot_start[b], self.slot_steps[b], self.max_new[b], self.submit_t[b],
                 self.decode_t0[b], self.first_tok_t[b])
        return done


class _ShutdownError(RuntimeError):
    """Raised into futures the ContinuousBatcher could not finish before
    shutdown (unlike a loop crash, start() clears it so a restarted batcher
    accepts work again)."""


class ContinuousBatcher:
    """Thread-safe submit() -> Future over a BatchedStaticEngine: one background
    thread admits queued requests into free slots and steps the engine while
    any slot is active.

    pipeline=True (default) runs the lag-1 pipelined loop: segment i+1 is queued
    on the device before segment i's results are read, so host bookkeeping
    (result copy, harvest, tokenizer decode, admission staging) and prefill
    chunks overlap device decoding. pipeline=False runs the serial loop (sync,
    harvest, admit, dispatch), kept as the reference the pipelined loop must
    match token for token."""

    def __init__(self, engine: BatchedStaticEngine, pipeline: bool = True):
        self.engine = engine
        self.pipeline = pipeline
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._crashed: Optional[BaseException] = None
        self._st: Optional[_SlotTracker] = None

    def start(self):
        """Start (or, after a shutdown, restart) the serving loop. Refuses while
        a previous loop thread still runs (a shutdown whose join timed out):
        two loops must never step one engine."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("ContinuousBatcher: the previous serving loop is still running")
        self._stop.clear()
        if isinstance(self._crashed, _ShutdownError):
            self._crashed = None
        target = self._loop_pipelined if self.pipeline else self._loop
        self._thread = threading.Thread(target=functools.partial(self._guarded, target),
                                        daemon=True)
        self._thread.start()

    def _fail(self, futs, err: BaseException) -> None:
        for fut in futs:
            if isinstance(fut, Future) and not fut.done():
                try:
                    fut.set_exception(err)
                except InvalidStateError:
                    pass  # resolved concurrently

    def _guarded(self, loop):
        """If the loop thread dies, every in-flight and queued request gets the
        exception at once, and later submits fail fast."""
        try:
            loop()
        except BaseException as e:  # noqa: B036 -- deliver even SystemExit
            logger.exception("serving loop crashed; failing in-flight requests")
            futs = self._st.futures() if self._st is not None else []
            with self._lock:
                # flag first, under the lock: nothing can enqueue after this drain
                self._crashed = e
                while self._queue:
                    futs.append(self._queue.popleft()[1])
            self._fail(futs, e)
            raise

    def submit(self, **request) -> Future:
        fut: Future = Future()
        # arrival stamp for the TTFT contract
        request.setdefault("_submit_time", time.time())
        with self._lock:
            if self._crashed is not None:
                fut.set_exception(self._crashed)
                return fut
            self._queue.append((request, fut))
        self._wake.set()
        return fut

    def shutdown(self, timeout: float = 10.0):
        """Stop the loop and fail every request it did not finish (in-flight
        slots, staged admissions, queued requests); later submits fail fast
        until start(). Safe while the loop is still running (a join that timed
        out): the tracker is read under its lock, and the loop tolerates
        futures already failed here."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        err = _ShutdownError("ContinuousBatcher shut down before completing this request")
        futs = self._st.futures() if self._st is not None else []
        with self._lock:
            if self._crashed is None:
                self._crashed = err
            while self._queue:
                futs.append(self._queue.popleft()[1])
        self._fail(futs, err)

    @staticmethod
    def admission_budget(any_active: bool, pending_slots: int, per_boundary: int) -> int:
        """Prefill chunks the loop may run at one segment boundary: unlimited when
        nothing decodes, else one per pending admission (at least per_boundary),
        so freed slots refill at the rate they free up while a long prompt still
        admits a chunk at a time."""
        if not any_active:
            return 1 << 30
        return max(per_boundary, pending_slots)

    def _pop_request(self):
        """Pop one queued (req, fut) under the lock; admission itself runs
        outside it, so submit() never waits for device work."""
        with self._lock:
            if not self._queue:
                return None
            return self._queue.popleft()

    def _reset_engine(self, eng):
        # the engine goes back reusable: serial callers seed from the host
        # mirrors, and aborted requests' slots are freed
        eng._dev_nn = eng._dev_active = None
        eng.active[:] = False

    def _loop(self):
        eng = self.engine
        st = self._st = _SlotTracker(eng)
        per_boundary = max(1, int(eng.prefill_chunks_per_segment))
        try:
            self._run_serial(eng, st, per_boundary)
        finally:
            self._reset_engine(eng)

    def _run_serial(self, eng, st, per_boundary):
        while not self._stop.is_set():
            occupied = st.occupied()
            for b in range(eng.batch_size):
                if b in occupied:
                    continue
                item = self._pop_request()
                if item is None:
                    break
                req, fut = item
                if not st.begin_admit(b, fut, req):
                    _resolve(fut, dict(_EMPTY_RESULT))
            budget = self.admission_budget(bool(any(eng.active)), len(st.pending), per_boundary)
            for _slot, fut, ok in st.advance_admissions(budget):
                if not ok:
                    _resolve(fut, dict(_EMPTY_RESULT))
            if not any(eng.active):
                if not st.pending:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            tv, pv, rv = st.sampling_vectors()
            steps_seg = eng.step_many(eng.segment_steps, st.stop_at, tv, pv, rv)
            for _b, fut, result in st.harvest(steps_seg):
                _resolve(fut, result)
            st.emit_partials()

    def _loop_pipelined(self):
        """Lag-1 pipelined serving loop. Per iteration i:

          1. queue segment i (chained on segment i-1's device state plus any
             prefill chunks queued last iteration: no host round trip),
          2. sync segment i-1 (the copy overlaps segment i), harvest finished
             requests, emit stream frames,
          3. stage admissions into slots the just-synced segment freed (their
             scratch guard rides the next dispatch as set_nn),
          4. advance pending admissions' prefill chunks without reading back:
             they queue behind segment i; completed ones activate in i+1.

        The price is one segment of re-admission lag; _SlotTracker's
        slot_steps == 0 guards cover the mirrors' one-segment staleness."""
        eng = self.engine
        st = self._st = _SlotTracker(eng)
        per_boundary = max(1, int(eng.prefill_chunks_per_segment))
        self._inflight = None
        try:
            self._run_pipelined(eng, st, per_boundary)
        finally:
            if self._inflight is not None:
                try:
                    eng.sync_segment(self._inflight)
                except Exception:
                    logger.exception("final segment sync failed")
            self._inflight = None
            self._reset_engine(eng)

    def _run_pipelined(self, eng, st, per_boundary):
        inflight = None       # handle of the segment queued last iteration
        act_inflight = False  # did activations ride it?
        set_nn = {}           # staged admission guards for the next dispatch
        activate = []         # completed admissions riding the next dispatch
        while not self._stop.is_set():
            # 1. queue segment i if any slot is known active, activations wait,
            # or the in-flight segment carried activations (the mirror cannot
            # know yet); a stale mirror costs at most one idle segment
            dispatched = bool(any(eng.active)) or bool(activate) or act_inflight
            handle = None
            if dispatched:
                tv, pv, rv = st.sampling_vectors()
                handle = eng.step_many_async(eng.segment_steps, st.stop_at, tv, pv, rv,
                                             set_nn=set_nn, activate=activate)
                act_inflight = bool(activate)
                set_nn, activate = {}, []
            else:
                act_inflight = False
            # 2. lag-1 sync of segment i-1 while segment i runs
            if inflight is not None:
                steps_seg = eng.sync_segment(inflight)
                for _b, fut, result in st.harvest(steps_seg):
                    _resolve(fut, result)
                st.emit_partials()
            inflight = self._inflight = handle
            # 3. stage admissions into free slots
            occupied = st.occupied()
            for b in range(eng.batch_size):
                if b in occupied or eng.active[b]:
                    continue
                item = self._pop_request()
                if item is None:
                    break
                req, fut = item
                if not st.begin_admit(b, fut, req):
                    _resolve(fut, dict(_EMPTY_RESULT))
                    continue
                set_nn[b] = len(st.pending[b][0]["ids"])
            # 4. prefill chunks queue behind the in-flight segment
            budget = self.admission_budget(dispatched or bool(any(eng.active)),
                                           len(st.pending), per_boundary)
            for slot, fut, ok in st.advance_admissions(budget, fetch=False):
                if not ok:
                    _resolve(fut, dict(_EMPTY_RESULT))
                else:
                    activate.append(slot)
            if inflight is None and not st.pending and not activate and not any(eng.active):
                self._wake.wait(timeout=0.05)
                self._wake.clear()
