"""Attention mask rows, built per call from scalars and the tree bitmap, and
the windows of a linear token row or KV cache that a step reads and writes.

KV slot layout (one linear cache per model):
  slots [0, num_nodes)                    committed prefix (always visible)
  slots [num_nodes, num_nodes+tree_size)  current speculation tree (ancestor-visible)

`num_nodes` and every window offset is a host int or a 0-d device tensor (the
device-resident decode loop's; nothing here reads it back to the host). A
window's start is clamped so the window fits its row, as
`lax.dynamic_slice` / `lax.dynamic_update_slice` clamp in the JAX package.
"""
import torch


def window_start(offset, width: int, length: int):
    """Start of a `width`-wide window at `offset` in a row of `length`, clamped
    into [0, length - width]: a host int for a host int, a device tensor for a
    device tensor."""
    if isinstance(offset, torch.Tensor):
        return offset.clamp(0, length - width)
    return min(max(int(offset), 0), length - width)


def window_index(offset, width: int, length: int, device) -> torch.Tensor:
    """int64 [width]: the positions of the clamped window at `offset`."""
    return window_start(offset, width, length) + torch.arange(width, device=device)


def read_window(row: torch.Tensor, offset, width: int) -> torch.Tensor:
    """row[start : start + width] of a 1-D row, the start clamped."""
    return row.index_select(0, window_index(offset, width, row.shape[0], row.device))


def write_window(row: torch.Tensor, offset, values: torch.Tensor, gate=None) -> None:
    """row[start : start + len(values)] = values in place, the start clamped;
    with a bool `gate` (0-d device tensor) the window keeps its values where
    the gate is false."""
    idx = window_index(offset, values.shape[0], row.shape[0], row.device)
    values = values.to(row.dtype)
    if gate is not None:
        values = torch.where(gate, values, row.index_select(0, idx))
    row.index_copy_(0, idx, values)


def causal_mask_rows(q_start, q_len: int, kv_len: int, device="cpu") -> torch.Tensor:
    """Bool [q_len, kv_len]: row i may attend slot j iff j <= q_start + i."""
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(kv_len, device=device)[None, :]
    return cols <= (rows + q_start)


def _place_tree_rows(num_nodes, rows: torch.Tensor, kv_len: int) -> torch.Tensor:
    """[n_rows, kv_len]: the committed slots (< num_nodes), or'd with `rows`
    placed at the clamped window start."""
    width = rows.shape[1]
    cols = torch.arange(kv_len, device=rows.device)
    rel = cols - window_start(num_nodes, width, kv_len)
    in_window = (rel >= 0) & (rel < width)
    placed = rows[:, rel.clamp(0, width - 1)] & in_window[None, :]
    return (cols < num_nodes)[None, :] | placed


def tree_mask_rows(num_nodes, tree_bitmap: torch.Tensor, kv_len: int) -> torch.Tensor:
    """Bool [tree_size, kv_len] for a full-tree (verify) pass: node i sees every
    committed slot (< num_nodes) and the tree slots of its ancestors and itself."""
    return _place_tree_rows(num_nodes, tree_bitmap, kv_len)


def tree_level_mask_rows(num_nodes, tree_bitmap: torch.Tensor, row_start: int,
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
