"""W4A16 matmul over split-halves AWQ weights, and the fused gate-up-SiLU over a
packed gate|up weight: CUDA kernels in `csrc/w4a16.cu` and their plain
versions `w4a16_matmul_ref` and `w4a16_gate_up_silu_ref`.

Replaces `umbrella_tpu/ops/pallas/w4a16.py::w4a16_matmul` (plain and layered
mode) and `::w4a16_gate_up_silu`. Layered mode: the weight is a stack of
layers ([n, K/2, N] packed bytes, [n, G, N] scales and zeros) and the layer is
an int32 tensor on the device, which the kernel reads itself: the host never
reads it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_FLOATS = (torch.float32, torch.bfloat16)


def _dequant_halves_bf16(q) -> torch.Tensor:
    """[K, N] weight as the kernel forms it: (nibble - z) * s in fp32, rounded to bf16."""
    G = q.scales.shape[-2]
    gs = q.k // G
    w32 = q.w8.to(torch.int32)
    nib = torch.cat([w32 & 0xF, (w32 >> 4) & 0xF], dim=-2).float()
    z = torch.repeat_interleave(q.zeros.float(), gs, dim=-2)
    s = torch.repeat_interleave(q.scales.float(), gs, dim=-2)
    return ((nib - z) * s).to(torch.bfloat16)


def select_layer(q, layer_idx: torch.Tensor):
    """Layer `layer_idx` (an int32 tensor of one element) of a stacked AwqTensor,
    selected on the tensors' device without a host read."""
    i = layer_idx.reshape(1).to(torch.long)
    return type(q)(*(t.index_select(0, i)[0] for t in q))


def w4a16_matmul_ref(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """Plain version with the kernel's rounding: x and the dequantized weight in
    bf16, products summed in fp32, output in out_dtype (default x.dtype)."""
    y = x.to(torch.bfloat16).float() @ _dequant_halves_bf16(q).float()
    return y.to(out_dtype or x.dtype)


def w4a16_gate_up_silu_ref(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """Plain version of the fused form, with the kernel's rounding: x and the
    dequantized packed gate|up weight [K, 2I] in bf16, fp32 sums, then
    g * sigmoid(g) * u in fp32, rounded once to out_dtype (default x.dtype)."""
    gu = x.to(torch.bfloat16).float() @ _dequant_halves_bf16(q).float()
    g, u = gu[:, :q.n // 2], gu[:, q.n // 2:]
    return (g * torch.sigmoid(g) * u).to(out_dtype or x.dtype)


# the kernel's tiles: a stage holds 64 packed rows (a quantization group is
# half a stage or whole stages); a consumer warpgroup owns 64 weight columns (a
# block two: 128 columns of one range, or 64 of each of the gate and up
# ranges); a block takes up to 4 token tiles of 64 (256 rows) in one wgmma on
# each dequantized fragment
_ROWS, _COLS, _TOK, _MAX_TT = 64, 64, 64, 4


def _plan(S: int, K: int, N: int, n_ranges: int, group_size: int) -> dict:
    """The kernel's launch plan for x [S, K] times `n_ranges` weight column
    ranges of width N (1: plain, 2: fused gate|up): token tiles of 64 per block
    (ceil(min(S, 256) / 64)) and the width of the block's one wgmma a fragment
    (32 for S <= 32, else 64 per tile), super-tiles of 256 rows, column tiles,
    and splits of K (build.split_k: one block a SM, at least 8 stages a
    split). Column tiles and splits depend on N and K only -- never on S -- so
    a row's summation order is the same in every batch. Raises ValueError for
    a shape the kernel does not take (TMA needs 16-byte row strides; K/2 is
    whole stages, and a group is half a stage or whole stages)."""
    if (group_size != _ROWS // 2 and (group_size <= 0 or group_size % _ROWS)) \
            or K % (2 * group_size) or K % (2 * _ROWS):
        raise ValueError(f"w4a16: K={K} must be a multiple of {2 * _ROWS} and of 2 x group "
                         f"size, and the group size ({group_size}) {_ROWS // 2} or a multiple "
                         f"of {_ROWS}")
    if N <= 0 or (n_ranges * N) % 16:
        raise ValueError(f"w4a16: weight width {n_ranges * N} must be a multiple of 16")
    col_tiles = -(-N // (_COLS * (2 if n_ranges == 1 else 1)))
    splits = build.split_k(col_tiles, K // 2 // _ROWS, 8, build.SMS)
    rows = min(S, _MAX_TT * _TOK)
    tiles = -(-rows // _TOK)
    return dict(token_tiles=tiles, token_width=32 if rows <= 32 else _TOK * tiles,
                super_tiles=-(-S // (_MAX_TT * _TOK)), col_tiles=col_tiles, splits=splits)


def _check(name: str, x: torch.Tensor, q, n_out: int, n_ranges: int, out_dtype,
           layer_idx=None) -> dict:
    """Check the operands of C entry point `name` (on any device); returns the
    launch plan. Raises ValueError on what the kernel does not take."""
    S, K = x.shape
    K2, N = q.w8.shape[-2:]
    G = q.scales.shape[-2]
    stack = tuple(q.w8.shape[:-2])  # (n_layers,) in layered mode
    if K != 2 * K2 or K % G:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs w8 {tuple(q.w8.shape)}, {G} groups")
    if q.w8.dtype not in (torch.int8, torch.uint8) or q.scales.shape != (*stack, G, N) \
            or q.zeros.shape != (*stack, G, N) or q.zeros.dtype != q.scales.dtype \
            or N != n_ranges * n_out or len(stack) != (layer_idx is not None):
        raise ValueError(f"{name}: malformed AwqTensor")
    if x.dtype not in _FLOATS or q.scales.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"{name}: unsupported dtypes {x.dtype}/{q.scales.dtype}/{out_dtype}")
    for t in (x, q.w8, q.scales, q.zeros):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: inputs must be contiguous on one device")
    if layer_idx is not None and (not isinstance(layer_idx, torch.Tensor)
                                  or layer_idx.dtype != torch.int32
                                  or layer_idx.numel() != 1 or layer_idx.device != x.device):
        raise ValueError(f"{name}: layer_idx must be one int32 on {x.device}")
    return _plan(S, K, n_out, n_ranges, K // G)


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(build.library("w4a16"), name)
    layered = [ctypes.c_void_p, ctypes.c_int] if name.endswith("_layered") else []
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + layered + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, x: torch.Tensor, q, n_out: int, n_ranges: int, out_dtype,
            layer_idx=None) -> torch.Tensor:
    """Check the operands, allocate the output [S, n_out] and the split-K scratch,
    launch C entry point `name` over `n_ranges` weight column ranges of n_out
    (on the layer `layer_idx` of stacked weights, for the layered entry point)."""
    plan = _check(name, x, q, n_out, n_ranges, out_dtype, layer_idx)
    if q.w8.data_ptr() % 16:
        raise ValueError(f"{name}: w8 must be 16-byte aligned (TMA)")
    S, K = x.shape
    G = q.scales.shape[-2]
    # the kernel takes bf16 x: fp32 x is rounded once here, as the plain version does
    x = x.to(torch.bfloat16)
    if x.data_ptr() % 16:
        x = x.clone()  # TMA reads x from a 16-byte aligned base
    out = torch.empty((S, n_out), dtype=out_dtype, device=x.device)
    splits = plan["splits"]
    partial = (torch.empty((splits, n_ranges, S, n_out), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    layered = () if layer_idx is None else (build.ptr(layer_idx), q.w8.shape[0])
    with build.on_device(x) as st:
        build.check(_fn(name)(build.ptr(x), build.ptr(q.w8), build.ptr(q.scales),
                              build.ptr(q.zeros), build.ptr(out), build.ptr(partial), S, K // 2,
                              n_out, K // G, splits, 1, int(q.scales.dtype == torch.bfloat16),
                              int(out_dtype == torch.bfloat16), *layered, st),
                    name)
    return out


def w4a16_matmul(x: torch.Tensor, q, out_dtype=None, layer_idx=None) -> torch.Tensor:
    """x [S, K] @ split-halves W4 AwqTensor [K, N] -> [S, N] in out_dtype (default
    x.dtype; fp32 accumulation either way). Layered mode: q is stacked ([n, K/2,
    N] w8, [n, G, N] scales/zeros) and `layer_idx` one int32 on x's device.
    CUDA tensors launch the kernel (counted in `launches`, or `layered_launches`
    in layered mode); CPU tensors take the plain version (on the selected
    layer)."""
    out_dtype = out_dtype or x.dtype
    if (layer_idx is not None) != (q.w8.dim() == 3):
        raise ValueError("w4a16_matmul: layer_idx goes with a stacked [n, K/2, N] weight, "
                         f"got w8 {tuple(q.w8.shape)} and layer_idx {layer_idx}")
    if not x.is_cuda:
        if layer_idx is not None:
            q = select_layer(q, layer_idx)
        return w4a16_matmul_ref(x, q, out_dtype)
    if layer_idx is None:
        out = _launch("w4a16_matmul", x, q, q.n, 1, out_dtype)
        w4a16_matmul.launches += 1
    else:
        out = _launch("w4a16_matmul_layered", x, q, q.n, 1, out_dtype, layer_idx)
        w4a16_matmul.layered_launches += 1
    return out


def w4a16_gate_up_silu(x: torch.Tensor, q, out_dtype=None) -> torch.Tensor:
    """silu(x @ W_gate) * (x @ W_up) in one kernel: x [S, K] and a packed gate|up
    AwqTensor [K, 2I] (gate columns first) -> [S, I] in out_dtype (default
    x.dtype). CUDA tensors launch the kernel; CPU tensors take the plain version."""
    out_dtype = out_dtype or x.dtype
    if q.n % 2:
        raise ValueError(f"w4a16_gate_up_silu: gate|up width {q.n} is odd")
    if not x.is_cuda:
        return w4a16_gate_up_silu_ref(x, q, out_dtype)
    out = _launch("w4a16_gate_up_silu", x, q, q.n // 2, 2, out_dtype)
    w4a16_gate_up_silu.launches += 1
    return out


w4a16_matmul.launches = 0
w4a16_matmul.layered_launches = 0
w4a16_gate_up_silu.launches = 0
