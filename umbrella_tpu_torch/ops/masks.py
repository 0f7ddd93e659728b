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


def causal_mask_rows_batched(q_starts: torch.Tensor, q_len: int, kv_len: int) -> torch.Tensor:
    """Bool [B, q_len, kv_len]: row (b, i) may attend slot j iff j <= q_starts[b] + i."""
    rows = torch.arange(q_len, device=q_starts.device)[None, :, None]
    cols = torch.arange(kv_len, device=q_starts.device)[None, None, :]
    return cols <= rows + q_starts.long()[:, None, None]


def _tree_rows_batched(num_nodes: torch.Tensor, rows: torch.Tensor, kv_len: int) -> torch.Tensor:
    """[B, R, kv_len]: slot j is visible to row r of slot b iff j < num_nodes[b], or
    j lies in the tree window and rows[r, j - num_nodes[b]] is set. The window
    is not shifted to fit the row (as in the JAX package's one-hot placement,
    columns past kv_len are dropped)."""
    width = rows.shape[1]
    cols = torch.arange(kv_len, device=num_nodes.device)[None, None, :]
    rel = cols - num_nodes.long()[:, None, None]  # [B, 1, kv_len]
    in_tree = (rel >= 0) & (rel < width)
    r = torch.arange(rows.shape[0], device=rows.device)[None, :, None]
    return (rel < 0) | (in_tree & rows[r, rel.clamp(0, width - 1)])


def tree_mask_rows_batched(num_nodes: torch.Tensor, tree_bitmap: torch.Tensor,
                           kv_len: int) -> torch.Tensor:
    """Bool [B, tree_size, kv_len]: per-slot verify masks for committed lengths
    num_nodes [B] (a device tensor: no host read)."""
    return _tree_rows_batched(num_nodes, tree_bitmap, kv_len)


def tree_level_mask_rows_batched(num_nodes: torch.Tensor, tree_bitmap: torch.Tensor,
                                 row_start: int, n_rows: int, kv_len: int) -> torch.Tensor:
    """Bool [B, n_rows, kv_len] draft-level masks for all slots at once."""
    return _tree_rows_batched(num_nodes, tree_bitmap[row_start:row_start + n_rows], kv_len)
