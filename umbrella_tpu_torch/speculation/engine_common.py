"""Shared engine machinery: prefill/append chunking, the decode loop, request API.

Counterpart of `umbrella_tpu/speculation/engine_common.py`. PyTorch runs
eagerly, so the decode loop is plain Python: `build_tree(); verify()` per step,
with one device-to-host read per step (accept length, EOS flag and the committed
block). A CUDA-graph version of the JAX package's one-dispatch decode loop is
later work (ROADMAP queue A).

Greedy decoding only: temperature >= 0.05 or a repetition penalty raises
NotImplementedError (ROADMAP queue A, item 7).
"""
from __future__ import annotations

import time
from typing import Union

import numpy as np
import torch

from ..models.auto_model import ModelRuntime
from ..ops.masks import causal_mask_rows
from ..utils import TextColors, resolve_device, setup_logger
from .base import BaseEngine
from .spec_utils import is_sentence_complete_regex, next_bucket

logger = setup_logger()

PREFILL_BUCKETS = (32, 64, 128, 256, 512)
PREFILL_CHUNK = 512

_NOT_PORTED = {
    "offload": "ROADMAP queue A, item 12",
    "tensor_parallel": "ROADMAP queue A, item 13",
    "pipeline_parallel": "ROADMAP queue A, item 13",
    "expert_parallel": "ROADMAP queue A, item 13",
    "quantize_draft": "ROADMAP queue A, items 5-6 (quantize_runtime)",
    "num_cache_layers": "ROADMAP queue A, item 12",
    "exit_layer": "ROADMAP queue A, item 3 (HF loaders)",
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SpecEngineBase(BaseEngine):
    """Common state + loops; subclasses implement initialize/build_tree/verify."""

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
        for key, item in _NOT_PORTED.items():
            if kwargs.get(key):
                raise NotImplementedError(f"'{key}' is not ported yet ({item})")
        self.config = kwargs
        self._check_greedy()

    def _check_greedy(self):
        if self.temperature >= 0.05:
            raise NotImplementedError(
                f"temperature={self.temperature}: stochastic sampling is not ported yet "
                "(ROADMAP queue A, item 7); use temperature < 0.05 (greedy)")
        if abs(self.repetition_penalty - 1.0) > 0.01:
            raise NotImplementedError(
                f"repetition_penalty={self.repetition_penalty} is not ported yet "
                "(ROADMAP queue A, item 7)")

    # ------------------------------------------------------------ model setup

    def _load_model(self, spec) -> ModelRuntime:
        if isinstance(spec, str):
            raise NotImplementedError(
                f"loading '{spec}' needs the HF loaders, not ported yet (ROADMAP queue A, "
                "item 3); pass a ModelRuntime")
        if spec.device != self.device:
            raise ValueError(f"model on {spec.device}, engine on {self.device}")
        return spec

    def _init_models_and_state(self):
        self.draft_model = self._load_model(self.draft_model_name)
        self.target_model = self._load_model(self.target_model_name)
        if self.eos_token_ids is None:
            self.eos_token_ids = self.target_model.eos_ids or [-1]
        self._eos_arr = torch.tensor(self.eos_token_ids, dtype=torch.int32, device=self.device)
        self.tokens_host = np.zeros(self.max_length, np.int32)
        self.tokens = torch.zeros(self.max_length, dtype=torch.int32, device=self.device)
        self.kv_draft = self.draft_model.init_kv(kv_dtype=self.kv_dtype)
        self.kv_target = self.target_model.init_kv(kv_dtype=self.kv_dtype)
        self.num_nodes = 0

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
        logits, self.kv_target = self.target_model.forward(
            self.target_model.params, self.kv_target, ids, pos, mask, start)
        if not emit:
            return None
        next_tok = torch.argmax(logits[n_valid - 1]).to(torch.int32)
        self.tokens[start + n_valid] = next_tok
        return next_tok

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
        self.tokens = torch.from_numpy(self.tokens_host.copy()).to(self.device)
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
        self.tokens = torch.from_numpy(self.tokens_host.copy()).to(self.device)
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
        self._check_greedy()

    def reset(self):
        self.num_nodes = 0
        self.tokens_host[:] = 0
        self.tokens = torch.zeros(self.max_length, dtype=torch.int32, device=self.device)
        self.kv_draft = self.draft_model.init_kv(kv_dtype=self.kv_dtype)
        self.kv_target = self.target_model.init_kv(kv_dtype=self.kv_dtype)

    # ------------------------------------------------------------ decode loops

    def speculative_decoding(self, max_new_tokens: int = 128):
        """Streaming decode: prints words as they commit; returns
        (dec_len, elapsed seconds, large-model steps)."""
        max_new_tokens = max(max_new_tokens, self.stop_distance)
        _sync(self.device)
        t1 = time.time()
        steps = 0
        decode = True
        start = self.num_nodes
        generated_ids = []
        pos = 0
        words = [""]
        while decode and self.validate_status():
            begin = self.num_nodes
            self.build_tree()
            decode = self.verify()
            steps += 1
            generated_ids.extend(self.tokens_host[begin:self.num_nodes].tolist())
            words = self._decode_words(generated_ids)
            now = len(words) - 1
            if now > pos:
                print(" ".join(words[pos:now]), end=" ", flush=True)
                pos = now
            if (is_sentence_complete_regex(words[-1])
                    and (self.num_nodes - start >= max_new_tokens - self.stop_distance)) \
                    or (self.num_nodes - start >= max_new_tokens):
                decode = False
        _sync(self.device)
        elapsed = time.time() - t1
        print(" ".join(words[pos:]), flush=True)
        dec_len = self.num_nodes - start + 1
        logger.info(TextColors.colorize(
            "Avg Accept Tokens {:.2f} | TPOT {:.2f} ms ".format(
                dec_len / max(steps, 1), 1000 * elapsed / dec_len), "magenta"))
        return dec_len, elapsed, steps

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
        """Greedy generation for one request. Returns api_args with
        generated_text, generated_tokens, avg_accept_tokens and
        time_per_output_token (ms); the engine is reset afterwards."""
        self.update_generation_args(**api_args)
        ok, early = self._start_request(api_args)
        if not ok:
            return early
        max_new_tokens = api_args.get("max_new_tokens", 128)
        _sync(self.device)
        t1 = time.time()
        steps = 0
        decode = True
        start = self.num_nodes
        while decode and (self.num_nodes - start) < max_new_tokens and self.validate_status():
            self.build_tree()
            decode = self.verify()
            steps += 1
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
