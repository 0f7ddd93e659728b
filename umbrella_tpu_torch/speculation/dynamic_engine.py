"""Dynamic beam-tree speculation engine.

Counterpart of `umbrella_tpu/speculation/dynamic_engine.py` (`DynamicEngine`):
the tree is grown online, level by level. Each frontier node proposes its
draft's top `num_beams` tokens, scored by log(softmax(top values) + 1e-4)
plus its own score (cumulative draft log-probability), and the global top
`width` of the `width x num_beams` candidates become the next level. A tree
of `depth` levels has `width * depth + 1` nodes (the root first, then each
level's `width` nodes in rank order).

`_build` is the JAX package's `build_tree_fn`: depth draft forwards, level 0
re-running the last two committed slots causally (the deferred leaf, as in
the static engine), each later level forwarding `width` rows under the
ancestor mask built so far. The tree's bitmap (ancestors and self),
parents and scores are persistent device buffers rebuilt in place at every
step: row 0, parent 0 and score 0 are the root's and never change, and
every other entry is written before it is read in the same step. A node's
bitmap row is its parent's row gathered by index, or'd with its own slot
(JAX multiplies by a one-hot matrix). The candidates' top `width` is a
stable descending sort: among equal scores the lower candidate index comes
first, as with `lax.top_k`, and `log(p + 1e-4)` makes equal scores common
(every p far below 1e-4 gives the same fp32 value).

The verify, the device-resident step (`_decode_step`, captured and replayed
as CUDA graphs on the card), the stepwise loop and the pipelined loop over
an offload target are the static engine's (engine_common.py), over this
engine's buffers. The first token after a prefill is the target's argmax
with the EOS ids banned (`ban_eos_at_prefill`), as in the JAX package.
"""
from __future__ import annotations

import torch

from ..ops.masks import causal_mask_rows, read_window, tree_level_mask_rows, write_window
from ..ops.sampling import draft_topk
from ..utils import TextColors, setup_logger
from .engine_common import SpecEngineBase

logger = setup_logger()


def expand_level(top_vals: torch.Tensor, top_idx: torch.Tensor, hist: torch.Tensor,
                 width: int):
    """One level's selection: candidates (row r, beam b) score
    hist[r] + log(softmax(top_vals[r])[b] + 1e-4); returns (scores, tokens,
    rows) of the top `width`, ties to the lower candidate index r * B + b."""
    step_scores = torch.log(torch.softmax(top_vals, dim=-1) + 1e-4)
    cand = (hist[:, None] + step_scores).reshape(-1)
    order = torch.sort(cand, descending=True, stable=True)
    sel = order.indices[:width]
    return order.values[:width], top_idx.reshape(-1)[sel], sel // top_vals.shape[-1]


class DynamicEngine(SpecEngineBase):
    ban_eos_at_prefill = True  # the reference bans EOS as the first generated token

    def __init__(self, draft_model_name, target_model_name, dtype=torch.bfloat16,
                 device="cuda", **kwargs) -> None:
        num_beams = kwargs.pop("num_beams", 24)
        width = kwargs.pop("width", 16)
        depth = kwargs.pop("depth", 24)
        if num_beams < width:
            raise ValueError(f"num_beams={num_beams} must be at least width={width}")
        super().__init__(draft_model_name, target_model_name, dtype, device, **kwargs)
        self.num_beams = num_beams
        self.tree_width = width
        self.tree_depth = depth
        self.tree_size = width * depth + 1

    def initialize(self):
        # the verify block writes [num_nodes, num_nodes + tree_size + 1)
        self.safe_buffer = max(self.safe_buffer, self.tree_size + 1)
        logger.info(TextColors.colorize(
            "Tree Size {} | Tree Depth {} | Tree Width {}".format(
                self.tree_size - 1, self.tree_depth, self.tree_width), "magenta"))
        self._init_models_and_state()
        self._build_tree_consts()

    def _build_tree_consts(self):
        W, D, T, dev = self.tree_width, self.tree_depth, self.tree_size, self.device
        # node depth: [0, W ones, W twos, ...]
        self._depth = torch.cat([torch.zeros(1, dtype=torch.long),
                                 torch.arange(1, D + 1).repeat_interleave(W)]).to(dev)
        self._node_in_path = self._depth + 1
        self._eye = torch.eye(T, dtype=torch.bool, device=dev)
        # the tree built by the last _build, read by the verify
        self._bitmap = self._eye.clone()
        self._parents = torch.zeros(T, dtype=torch.long, device=dev)
        self._score = torch.zeros(T, dtype=torch.float32, device=dev)
        # a step commits a root-to-node path: at most depth + 1 tokens
        self.max_step_advance = D + 1

    def _build(self, nn, cont=None):
        """The draft's depth forwards at committed length `nn` (a host int or a
        0-d device tensor), the tree's tokens written after nn (kept where the
        0-d bool `cont` is false) and its bitmap, parents and scores rebuilt."""
        W, B, L = self.tree_width, self.num_beams, self.max_length
        d_fwd, pd = self.draft_model.forward, self.draft_model.params
        lvl_start = 0
        for step in range(self.tree_depth):
            if step == 0:
                # a no-op step (cont false) runs this forward one slot later, past
                # the committed prefix, so that it rewrites no committed draft KV
                lo = nn - 1 if cont is None else torch.where(cont, nn - 1, nn)
                ids = read_window(self.tokens, lo, 2)
                pos = lo + torch.arange(2, device=self.device)
                mask = causal_mask_rows(lo, 2, L, device=self.device)
                logits, _ = d_fwd(pd, self.kv_draft, ids, pos, mask, lo)
                logits, rows = logits[1:2], 1  # expansion scores from the root row
            else:
                ids = read_window(self.tokens, nn + lvl_start, W)
                pos = nn + self._depth[lvl_start:lvl_start + W]
                mask = tree_level_mask_rows(nn, self._bitmap, lvl_start, W, L)
                logits, _ = d_fwd(pd, self.kv_draft, ids, pos, mask, nn + lvl_start)
                rows = W
            top_vals, top_idx = draft_topk(logits, B, self.draft_topk_recall)
            score, tokens, parent = expand_level(
                top_vals, top_idx, self._score[lvl_start:lvl_start + rows], W)
            new = slice(lvl_start + rows, lvl_start + rows + W)
            write_window(self.tokens, nn + new.start, tokens, cont)
            parent = parent + lvl_start
            self._score[new].copy_(score)
            self._parents[new].copy_(parent)
            self._bitmap[new].copy_(self._bitmap.index_select(0, parent) | self._eye[new])
            lvl_start = new.start
