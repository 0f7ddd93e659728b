"""Attention mask rows, built per call from scalars and the tree bitmap.

KV slot layout (one linear cache per model):
  slots [0, num_nodes)                    committed prefix (always visible)
  slots [num_nodes, num_nodes+tree_size)  current speculation tree (ancestor-visible)

The tree window is placed at column `num_nodes` with the start clamped so the
window fits the row, as `lax.dynamic_update_slice` does in the JAX package.
"""
import torch


def causal_mask_rows(q_start: int, q_len: int, kv_len: int, device="cpu") -> torch.Tensor:
    """Bool [q_len, kv_len]: row i may attend slot j iff j <= q_start + i."""
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(kv_len, device=device)[None, :]
    return cols <= (rows + q_start)


def _place_tree_rows(num_nodes: int, rows: torch.Tensor, kv_len: int) -> torch.Tensor:
    n_rows, width = rows.shape
    out = torch.arange(kv_len, device=rows.device)[None, :].expand(n_rows, kv_len) < num_nodes
    out = out.clone()
    start = min(max(int(num_nodes), 0), kv_len - width)
    out[:, start:start + width] |= rows
    return out


def tree_mask_rows(num_nodes: int, tree_bitmap: torch.Tensor, kv_len: int) -> torch.Tensor:
    """Bool [tree_size, kv_len] for a full-tree (verify) pass: node i sees every
    committed slot (< num_nodes) and the tree slots of its ancestors and itself."""
    return _place_tree_rows(num_nodes, tree_bitmap, kv_len)


def tree_level_mask_rows(num_nodes: int, tree_bitmap: torch.Tensor, row_start: int,
                         n_rows: int, kv_len: int) -> torch.Tensor:
    """Bool [n_rows, kv_len] for one draft tree level (nodes row_start..row_start+n)."""
    return _place_tree_rows(num_nodes, tree_bitmap[row_start:row_start + n_rows], kv_len)
