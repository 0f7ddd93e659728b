"""AWQ W4A8 matmul (per-row int8 activations, split-halves 4-bit AWQ weights with
per-group scales and zeros): CUDA kernel `csrc/w4a8.cu` and its plain version
`w4a8_matmul_ref`; and what the int8 W4 kernels share with the Int4F one
(`w4a8f.py`): the launch plan `_plan` and the fused per-row quantizer
`quantize_rows`.

Replaces `umbrella_tpu/ops/pallas/w4a8.py::w4a8_matmul`:

    sx[s] = max(max|x[s, :]|, 1e-8) / 127,   xq = clip(round(x / sx), -127, 127)
    y[s, n] = sx[s] * sum_g s_g[n] * (xq[s, g] . nib_g[:, n] - rowsum_g[s] * z_g[n])

On the card the activation quantization is one kernel launch (`quantize_rows`:
xq, sx and the row sums per group), then the matmul. Every step is per row, so
a row's result does not depend on the rows that share its call (what keeps W4A8
spec decode equal to its AR decode).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_FLOATS = (torch.float32, torch.bfloat16)
STEP_ROWS = 32  # packed rows of one k32 wgmma step; a group holds whole steps
_STAGE_ROWS = 64  # packed rows a stage of the kernel's ring (two steps)
_BLOCK_COLS = 128  # weight columns a block
# tokens a block in one pass (super-tiles above): Int4F keeps one int32 sum a
# token and column, AWQ two int32 products and an fp32 sum
_MAX_TOK = {"int4f": 256, "awq": 64}


def quantize_activations_w4a8(x: torch.Tensor):
    """(xq int8 [S, K], sx fp32 [S, 1]) for per-row symmetric int8 quantization
    (round half to even, clipped to +-127). The scale is the row max times the
    fp32 reciprocal of 127: XLA compiles the JAX package's `/ 127.0` that way,
    and xq's rounding edges depend on its last bit."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def group_rowsums(xq: torch.Tensor, group_size: int) -> torch.Tensor:
    """int32 [S, K / group_size]: each row's sum of its int8 values per group."""
    S, K = xq.shape
    return xq.reshape(S, K // group_size, group_size).to(torch.int32).sum(dim=-1,
                                                                          dtype=torch.int32)


def _plan(S: int, K: int, N: int, group_size=None) -> dict:
    """The int8 kernel's launch plan for x [S, K] @ W4 [K, N]; group_size None
    is Int4F (one sum over all of K), else AWQ's group size. Token width: S
    rounded up to 32 (S <= 32) or to 64, at most 256 (Int4F) or 64 (AWQ);
    super-tiles of that many rows beyond; column tiles of 128; splits of K
    from the column tiles and the stages of 64 packed rows only
    (build.split_k: one block a SM, at least 8 stages a split), each split
    whole stages and, for AWQ, whole groups. Nothing but the token width and
    the super-tiles depends on S, so a row's order of operations is the same
    in every batch. Raises ValueError for a shape the kernel does not take."""
    K2 = K // 2
    if K <= 0 or K % (2 * STEP_ROWS):
        raise ValueError(f"w4a8: K={K} must be a multiple of {2 * STEP_ROWS}")
    if N <= 0 or N % 16:
        raise ValueError(f"w4a8: N={N} must be a multiple of 16 (TMA row strides)")
    if group_size is not None and (group_size <= 0 or group_size % STEP_ROWS
                                   or K2 % group_size):
        raise ValueError(f"w4a8: group size {group_size} must be a multiple of {STEP_ROWS} "
                         f"that divides K/2={K2}")
    n_chunks = -(-K2 // _STAGE_ROWS)
    col_tiles = -(-N // _BLOCK_COLS)
    per = -(-n_chunks // build.split_k(col_tiles, n_chunks, 8, build.SMS))
    if group_size is not None:  # whole groups: steps a split a multiple of lcm(2, spg)
        spg = group_size // STEP_ROWS
        unit = spg if spg % 2 == 0 else 2 * spg
        per = -(-2 * per // unit) * unit // 2
    max_tok = _MAX_TOK["int4f" if group_size is None else "awq"]
    rows = min(S, max_tok)
    return dict(token_width=32 if rows <= 32 else 64 * -(-rows // 64),
                super_tiles=-(-S // max_tok), col_tiles=col_tiles,
                splits=-(-n_chunks // per), chunks_per_split=per)


def w4a8_matmul_ref(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """Plain version with the kernel's order of operations: per packed group
    (the low half's group, then the high half's) an exact integer product (in
    float64, exact here: |p| <= 127 * 15 * group size), the fp32 zero fix-up and
    scale, added to an fp32 sum per split of the groups; the splits' sums added
    in order, times sx, in out_dtype (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    S, K = x.shape
    K2, N = q.w8.shape
    G2 = q.scales.shape[0] // 2
    gs = K2 // G2
    xq, sx = quantize_activations_w4a8(x)
    rs = group_rowsums(xq, gs).float()
    xd = xq.double()
    scales, zeros = q.scales.float(), q.zeros.float()
    plan = _plan(1, K, N, gs)
    per = plan["chunks_per_split"] * 2 * STEP_ROWS // gs  # groups a split
    total = None
    for z in range(plan["splits"]):
        acc = torch.zeros((S, N), dtype=torch.float32, device=x.device)
        for pg in range(z * per, min(G2, (z + 1) * per)):
            rows = slice(pg * gs, (pg + 1) * gs)
            w32 = q.w8[rows].to(torch.int32)
            for half, nib in enumerate((w32 & 0xF, (w32 >> 4) & 0xF)):
                g = half * G2 + pg
                p = (xd[:, half * K2 + pg * gs:half * K2 + (pg + 1) * gs] @ nib.double()).float()
                acc = acc + (p - rs[:, g:g + 1] * zeros[g]) * scales[g]
        total = acc if plan["splits"] == 1 else (
            torch.zeros_like(acc) if total is None else total) + acc
    return (total * sx).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(build.library("w4a8"), name)
    n_ptr, n_int = {"w4a8_quantize": (5, 4), "w4a8f_matmul": (7, 6),
                    "w4a8_matmul": (8, 8)}[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_rows(x: torch.Tensor, a=None, group_size=None):
    """The fused quantizer, one launch on a CUDA x [S, K] (fp32 or bf16,
    contiguous): (xq int8 [S, K], sx fp32 [S], row sums int32 [S, K /
    group_size]) of x, or of x * a with the fp32 row factor a [K] (Int4F;
    group_size None: one sum a row). Bit for bit quantize_activations_w4a8 /
    w4a8f.quantize_activations_int8 and group_rowsums. Counted in `launches`."""
    S, K = x.shape
    gs = K if group_size is None else group_size
    if x.dtype not in _FLOATS or not x.is_contiguous() or K % 64 or gs <= 0 or gs % 32 \
            or K % gs:
        raise ValueError(f"quantize_rows: x {tuple(x.shape)} {x.dtype} (contiguous fp32 or "
                         f"bf16, K a multiple of 64) and group size {gs}")
    if a is not None and (a.dtype != torch.float32 or a.shape != (K,) or not a.is_contiguous()
                          or a.device != x.device):
        raise ValueError("quantize_rows: a must be a contiguous fp32 [K] on x's device")
    xq = torch.empty((S, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((S,), dtype=torch.float32, device=x.device)
    rs = torch.empty((S, K // gs), dtype=torch.int32, device=x.device)
    with build.on_device(x) as st:
        build.check(_fn("w4a8_quantize")(build.ptr(x), build.ptr(a), build.ptr(xq),
                                         build.ptr(sx), build.ptr(rs), S, K, gs,
                                         int(x.dtype == torch.bfloat16), st),
                    "w4a8_quantize")
    quantize_rows.launches += 1
    return xq, sx, rs


def _check(x: torch.Tensor, q, out_dtype) -> dict:
    """Check w4a8_matmul's operands (on any device); returns the launch plan
    (with the group size). Raises ValueError on what the kernel does not take."""
    S, K = x.shape
    K2, N = q.w8.shape
    G = q.scales.shape[0]
    if K != 2 * K2 or G % 2 or K % G:
        raise ValueError(f"w4a8_matmul: x {tuple(x.shape)} vs w8 {tuple(q.w8.shape)}, "
                         f"{G} groups")
    plan = _plan(S, K, N, K // G)
    if q.w8.dtype not in (torch.int8, torch.uint8) or q.scales.shape != (G, N) \
            or q.zeros.shape != (G, N) or q.zeros.dtype != q.scales.dtype:
        raise ValueError("w4a8_matmul: malformed AwqTensor")
    if x.dtype not in _FLOATS or q.scales.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"w4a8_matmul: unsupported dtypes {x.dtype}/{q.scales.dtype}/{out_dtype}")
    for t in (x, q.w8, q.scales, q.zeros):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("w4a8_matmul: inputs must be contiguous on one device")
    return dict(plan, group_size=K // G)


def w4a8_matmul(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """x [S, K] @ split-halves W4 AwqTensor [K, N] with int8 activations -> [S, N]
    in out_dtype (default x.dtype). CUDA tensors launch the quantizer and the
    kernel; CPU tensors take the plain version."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return w4a8_matmul_ref(x, q, out_dtype)
    plan = _check(x, q, out_dtype)
    if (q.w8.data_ptr() | q.scales.data_ptr() | q.zeros.data_ptr()) % 16:
        raise ValueError("w4a8_matmul: w8, scales and zeros must be 16-byte aligned (TMA)")
    S, K = x.shape
    K2, N = q.w8.shape
    gs = plan["group_size"]
    xq, sx, rs = quantize_rows(x, None, gs)
    out = torch.empty((S, N), dtype=out_dtype, device=x.device)
    splits = plan["splits"]
    partial = (torch.empty((splits, S, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with build.on_device(x) as st:
        build.check(_fn("w4a8_matmul")(build.ptr(xq), build.ptr(sx), build.ptr(rs),
                                       build.ptr(q.w8), build.ptr(q.scales), build.ptr(q.zeros),
                                       build.ptr(out), build.ptr(partial), S, K2, N, gs, splits,
                                       plan["chunks_per_split"],
                                       int(q.scales.dtype == torch.bfloat16),
                                       int(out_dtype == torch.bfloat16), st),
                    "w4a8_matmul")
    w4a8_matmul.launches += 1
    return out


quantize_rows.launches = 0
w4a8_matmul.launches = 0
