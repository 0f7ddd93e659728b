"""Static-tree speculation engine (Sequoia growmap trees).

Counterpart of `umbrella_tpu/speculation/static_engine.py`. A step is the
draft's level forwards and top-k expansion (`_build`), the target's forward
over the whole tree, the accept rule and the compaction of both KV caches
(`_verify`), at a committed length `nn` that is a host int (the stepwise
loop: `build_tree()`; `verify()`, one host read a step) or a 0-d device
tensor (the device-resident loop: `_decode_step`, the counterpart of
`decode_loop_fn`'s body with `gated_tail_fn`'s gated commit, replayed as a
CUDA graph on the card; see engine_common._decode_fused).

Deferred-leaf build (as in the JAX package): the last level's forward would only
write draft KV for leaves of which at most one is ever read, on the next step.
So it is skipped, and level 0 re-runs the last two committed slots [nn-1, nn]
causally: slot nn-1 is an already-drafted node (recompute is identical) or the
accepted leaf whose KV was skipped; slot nn is the bonus token.
"""
from __future__ import annotations

import contextlib

import torch

from ..cuda_graphs import StepGraph
from ..ops.masks import (causal_mask_rows, read_window, tree_level_mask_rows, tree_mask_rows,
                         write_window)
from ..ops.sampling import draft_topk
from ..utils import TextColors, setup_logger
from .engine_common import SpecEngineBase
from .tree import GrowMap
from .verify import gated_verify_tail, verify_tail

logger = setup_logger()


class StaticEngine(SpecEngineBase):
    def __init__(self, draft_model_name, target_model_name, dtype=torch.bfloat16,
                 device="cuda", **kwargs) -> None:
        growmap_path = kwargs.pop("growmap_path", None)
        growmap_obj = kwargs.pop("growmap", None)
        if growmap_path is None and growmap_obj is None:
            raise ValueError("Please specify growmap path (or growmap object) for static trees")
        super().__init__(draft_model_name, target_model_name, dtype, device, **kwargs)
        self.growmap_path = growmap_path
        self.growmap_obj = growmap_obj

    def initialize(self):
        if self.growmap_obj is not None:
            gm = self.growmap_obj if isinstance(self.growmap_obj, GrowMap) \
                else GrowMap.from_dict(self.growmap_obj)
        else:
            gm = GrowMap.from_json(self.growmap_path)
        gm.validate()
        self.growmap = gm
        self.tree_size = gm.size
        self.tree_depth = gm.num_levels
        # the verify block writes [num_nodes, num_nodes + tree_size + 1)
        self.safe_buffer = max(self.safe_buffer, self.tree_size + 1)
        logger.info(TextColors.colorize(
            f"Tree Size {self.tree_size - 1} | Tree Depth {self.tree_depth - 1}", "magenta"))
        self._init_models_and_state()
        self._build_tree_consts()

    def _build_tree_consts(self):
        gm, dev = self.growmap, self.device
        self._levels = []
        for lvl in range(gm.num_levels):
            last = lvl == gm.num_levels - 1
            self._levels.append(dict(
                start=gm.level_start(lvl),
                n=len(gm.roots[lvl]),
                topk=0 if last else gm.level_topk(lvl),
                depth=torch.as_tensor(gm.depth[gm.level_nodes(lvl)], device=dev).long(),
                gather=None if last else torch.as_tensor(gm.level_gather_indices(lvl),
                                                         device=dev).long(),
            ))
        self._bitmap = torch.as_tensor(gm.bitmap, device=dev)
        self._depth = torch.as_tensor(gm.depth, device=dev).long()
        self._parents = torch.as_tensor(gm.parents, device=dev).long()
        self._node_in_path = torch.as_tensor(gm.node_in_path, device=dev).long()
        self._defer_leaf = gm.num_levels >= 2
        # the most one step commits: accept_and_commit accepts a root-to-node
        # path (node_in_path = depth + 1 nodes), so at most the tree's level count
        self.max_step_advance = int(gm.node_in_path.max())
        self._decode_graphs = {}  # (greedy, topk, use_pen) -> StepGraph, as _decode_loop_cache

    # -------------------------------------------------------------- decode phases

    def _build(self, nn, cont=None):
        """Draft forwards level by level at committed length `nn` (a host int or
        a 0-d device tensor); writes each level's children into tokens (kept
        where the 0-d bool `cont` is false)."""
        L = self.max_length
        d_fwd, pd = self.draft_model.forward, self.draft_model.params
        n_levels = len(self._levels)
        for lvl, lv in enumerate(self._levels):
            if self._defer_leaf and lvl == n_levels - 1:
                continue  # leaf KV deferred to the next step's level 0
            if self._defer_leaf and lvl == 0:
                # a no-op step (cont false) runs this forward one slot later, past
                # the committed prefix, so that it rewrites no committed draft KV
                lo = nn - 1 if cont is None else torch.where(cont, nn - 1, nn)
                ids = read_window(self.tokens, lo, 2)
                pos = lo + torch.arange(2, device=self.device)
                mask = causal_mask_rows(lo, 2, L, device=self.device)
                logits, _ = d_fwd(pd, self.kv_draft, ids, pos, mask, lo)
                logits = logits[1:2]  # expansion samples from the root row
            else:
                ids = read_window(self.tokens, nn + lv["start"], lv["n"])
                pos = nn + lv["depth"]
                mask = tree_level_mask_rows(nn, self._bitmap, lv["start"], lv["n"], L)
                logits, _ = d_fwd(pd, self.kv_draft, ids, pos, mask, nn + lv["start"])
            if lv["topk"] > 0:
                cand = draft_topk(logits, lv["topk"], self.draft_topk_recall)[1].reshape(-1)
                write_window(self.tokens, nn + lv["start"] + lv["n"], cand[lv["gather"]], cont)

    def _target_logits(self, nn):
        ids = read_window(self.tokens, nn, self.tree_size)
        pos = nn + self._depth
        mask = tree_mask_rows(nn, self._bitmap, self.max_length)
        logits, _ = self.target_model.forward(self.target_model.params, self.kv_target, ids,
                                              pos, mask, nn)
        return logits

    def _tail_kw(self, greedy: bool, use_pen: bool) -> dict:
        s = self._sampling
        return dict(tree_size=self.tree_size, greedy=greedy, use_pen=use_pen,
                    generator=self._gen, temperature=s["temperature"], topp=s["topp"],
                    penalty=s["penalty"], topk=self.topk)

    def build_tree(self):
        """The stepwise loop's draft phase at the host num_nodes."""
        self._build(self.num_nodes)

    def verify(self) -> bool:
        """The stepwise loop's verify phase: target forward over the tree,
        sampling (greedy below temperature 0.05), accept rule, commit, and the
        step's one host read; returns the continue flag."""
        nn = self.num_nodes
        greedy, use_pen = self._sampling_mode()
        accept_len, eos_found, block = verify_tail(
            self._target_logits(nn), self.kv_target, self.kv_draft, self.tokens, nn,
            self._bitmap, self._parents, self._node_in_path, self._eos_arr,
            **self._tail_kw(greedy, use_pen))
        return self._commit_verify_result(accept_len, eos_found, block)

    def _decode_step(self, greedy: bool, use_pen: bool):
        """One step of the device-resident loop on the engine's persistent
        state (`_loop`: nn, cont, start, max_new, steps, eos; 0-d device
        tensors), updated in place: build, verify and the gated commit
        (a no-op where cont is false). No host read."""
        st = self._loop
        nn, cont = st["nn"], st["cont"]
        self._build(nn, cont)
        nn_out, cont_out, _, eos, _ = gated_verify_tail(
            self._target_logits(nn), self.kv_target, self.kv_draft, self.tokens, nn, cont,
            st["start"], st["max_new"], self.max_length - self.safe_buffer, self._bitmap,
            self._parents, self._node_in_path, self._eos_arr, **self._tail_kw(greedy, use_pen))
        st["steps"].add_(cont.to(torch.int32))
        st["eos"].copy_(torch.where(cont, eos, st["eos"]))
        st["nn"].copy_(nn_out)
        st["cont"].copy_(cont_out)

    def _decode_graph(self, greedy: bool, topk: int, use_pen: bool) -> StepGraph:
        """The captured `_decode_step` for one sampling mode, cached as the JAX
        package's `_decode_loop_cache` is (warmed up as a no-op step)."""
        key = (greedy, topk, use_pen)
        if key not in self._decode_graphs:
            self._decode_graphs[key] = StepGraph.capture(
                lambda: self._decode_step(greedy, use_pen), self.device, self._graph_pool,
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

    def _run_decode_steps(self, n: int, greedy: bool, use_pen: bool) -> None:
        """n steps of the device-resident loop: graph replays on the card, the
        same step run eagerly on the CPU (the plain version)."""
        if self.device.type == "cuda":
            self._decode_graph(greedy, self.topk, use_pen).replay(n)
        else:
            self._gen_states = []
            for _ in range(n):
                self._gen_states.append(self._gen.get_state())
                self._decode_step(greedy, use_pen)

    def _rewind_decode_steps(self, n: int, greedy: bool, use_pen: bool) -> None:
        """Take back the random draws of the last block's n trailing no-op
        steps: the next request draws what it would after the stepwise loop
        (or the JAX package's loop, which exits at once)."""
        if self.device.type == "cuda":
            self._decode_graph(greedy, self.topk, use_pen).rewind(n)
        else:
            self._gen.set_state(self._gen_states[-n])
