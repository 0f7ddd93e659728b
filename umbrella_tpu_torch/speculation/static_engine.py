"""Static-tree speculation engine (Sequoia growmap trees).

Counterpart of `umbrella_tpu/speculation/static_engine.py`. A step is the
draft's level forwards and top-k expansion (`_build`), the target's forward
over the whole tree, the accept rule and the compaction of both KV caches
(`verify`), at a committed length `nn` that is a host int (the stepwise
loop: `build_tree()`; `verify()`, one host read a step) or a 0-d device
tensor (the device-resident loop: `_decode_step`, the counterpart of
`decode_loop_fn`'s body with `gated_tail_fn`'s gated commit, replayed as
CUDA graphs on the card; or, over an offload target, `_offload_step`'s
counterpart in the pipelined loop, its streamed forward eager between two
graphs). This module holds the growmap's
constants and `_build`; the step, the graphs and the loops are shared with
the dynamic engine (engine_common.py).

Deferred-leaf build (as in the JAX package): the last level's forward would only
write draft KV for leaves of which at most one is ever read, on the next step.
So it is skipped, and level 0 re-runs the last two committed slots [nn-1, nn]
causally: slot nn-1 is an already-drafted node (recompute is identical) or the
accepted leaf whose KV was skipped; slot nn is the bonus token.
"""
from __future__ import annotations

import torch

from ..ops.masks import causal_mask_rows, read_window, tree_level_mask_rows, write_window
from ..ops.sampling import draft_topk
from ..utils import TextColors, setup_logger
from .engine_common import SpecEngineBase
from .tree import GrowMap

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
