"""Plain versions of the PyTorch port's CUDA kernels vs the JAX package's Pallas
kernels run in interpret mode on the CPU.

The CUDA kernels themselves run only on a GPU (chip_smoke.py holds each one
against the plain version checked here). Inputs are made with numpy from a seed
and handed to both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.ops.pallas.embed_gather import embed_gather as jax_embed_gather
from umbrella_tpu.ops.pallas.tree_attention import attend_flash as jax_attend_flash
from umbrella_tpu.ops.pallas.tree_attention import \
    attend_flash_batched as jax_attend_flash_batched
from umbrella_tpu.ops.pallas.w4a16 import w4a16_matmul as jax_w4a16_matmul
from umbrella_tpu.ops.pallas.w4a8f import quantize_activations_int8 as jax_quantize_act
from umbrella_tpu.ops.pallas.w4a8f import w4a8f_matmul as jax_w4a8f_matmul
from umbrella_tpu.quantization.awq import AwqTensor as JaxAwqTensor
from umbrella_tpu.quantization.int4f import quantize_int4f as jax_quantize_int4f
from umbrella_tpu_torch.models.convert import params_from_numpy, to_tensor
from umbrella_tpu_torch.ops.kernels.embed_gather import embed_gather, embed_gather_ref
from umbrella_tpu_torch.ops.kernels.tree_attention import (
    attend_dense, attend_flash, attend_flash_batched, attend_flash_batched_int8,
    attend_flash_batched_ref, attend_flash_int8, attend_flash_ref)
from umbrella_tpu_torch.ops.kernels.w4a16 import w4a16_matmul, w4a16_matmul_ref
from umbrella_tpu_torch.ops.kernels.w4a8f import (quantize_activations_int8, w4a8f_int_dot,
                                                  w4a8f_matmul, w4a8f_matmul_ref)
from umbrella_tpu_torch.ops.masks import causal_mask_rows

SIZES = [1, 5, 24]


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


@pytest.mark.parametrize("S", SIZES)
def test_attend_dense_matches_pallas_flash(S):
    """Tolerance: max abs err <= 1e-4 * max|y| (fp32; only the summation order
    and the online-softmax rescaling differ)."""
    rng = np.random.default_rng(100 + S)
    n_layers, KVH, H, D, L, layer, kv_limit = 2, 2, 4, 32, 256, 1, 131
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k = rng.standard_normal((n_layers, KVH, L, D)).astype(np.float32)
    v = rng.standard_normal((n_layers, KVH, L, D)).astype(np.float32)
    mask = np.asarray(causal_mask_rows(kv_limit - S, S, L))
    want = np.asarray(jax_attend_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.int32(kv_limit), block_k=128, interpret=True, layer_idx=jnp.int32(layer)))
    qt, kt, vt, mt = _t(q), _t(k), _t(v), torch.as_tensor(mask)
    got = attend_dense(qt, kt[layer], vt[layer], mt).numpy()
    tol = 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(attend_flash(qt, kt, vt, mt, kv_limit, layer).numpy(), got)


def _awq_numpy(rng, K, N, group_size):
    G = K // group_size
    return JaxAwqTensor(
        w8=jnp.asarray(rng.integers(0, 256, (K // 2, N), dtype=np.uint8).view(np.int8)),
        scales=jnp.asarray(rng.uniform(0.001, 0.01, (G, N)).astype(np.float32))
        .astype(jnp.bfloat16),
        zeros=jnp.asarray(rng.integers(0, 16, (G, N)).astype(np.float32)).astype(jnp.bfloat16))


@pytest.mark.parametrize("S", SIZES)
def test_w4a16_ref_matches_pallas_kernel(S):
    """Tolerance: max abs err <= 1e-4 * max|y| (both round x and the dequantized
    weight to bf16 and accumulate in fp32; only the summation order differs)."""
    rng = np.random.default_rng(200 + S)
    jq = _awq_numpy(rng, 256, 256, 64)
    x = rng.standard_normal((S, 256)).astype(np.float32)
    want = np.asarray(jax_w4a16_matmul(jnp.asarray(x), jq, interpret=True,
                                       out_dtype=jnp.float32))
    q = params_from_numpy({"q": jq})["q"]
    got = w4a16_matmul_ref(_t(x), q, out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(w4a16_matmul(_t(x), q, out_dtype=torch.float32).numpy(), got)


@pytest.mark.parametrize("S", SIZES)
def test_w4a8f_ref_matches_pallas_kernel(S):
    """Tolerance: the int8 activations, their scales and the int32 dot are exact;
    the fp32 output is within 1e-6 relative."""
    rng = np.random.default_rng(300 + S)
    w = rng.standard_normal((256, 256)).astype(np.float32) * 0.05
    jq = jax_quantize_int4f(w, group_size=64)
    x = rng.standard_normal((S, 256)).astype(np.float32)
    want = np.asarray(jax_w4a8f_matmul(jnp.asarray(x), jq, interpret=True,
                                       out_dtype=jnp.float32))
    q = params_from_numpy({"q": jq})["q"]
    xq, sx, rsum = quantize_activations_int8(_t(x), q.a)
    jxq, jsx, jrsum = (np.asarray(a) for a in jax_quantize_act(jnp.asarray(x), jq.a))
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(sx.numpy(), jsx)
    np.testing.assert_array_equal(rsum.numpy(), jrsum)
    w8 = np.asarray(jq.w8).view(np.uint8).astype(np.int64)
    q4 = np.concatenate([w8 & 0xF, w8 >> 4]) - 8
    np.testing.assert_array_equal(w4a8f_int_dot(xq, q.w8).numpy(),
                                  jxq.astype(np.int64) @ q4)
    got = w4a8f_matmul_ref(_t(x), q, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(w4a8f_matmul(_t(x), q, out_dtype=torch.float32).numpy(), got)


@pytest.mark.parametrize("S", SIZES)
def test_embed_gather_ref_matches_pallas_kernel(S):
    """Tolerance: exact (a row copy)."""
    rng = np.random.default_rng(400 + S)
    emb = rng.standard_normal((300, 128)).astype(np.float32)  # V % 8 != 0: padded on TPU
    ids = rng.integers(0, 300, S).astype(np.int32)
    want = np.asarray(jax_embed_gather(jnp.asarray(emb), jnp.asarray(ids), interpret=True))
    got = embed_gather_ref(_t(emb), _t(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(embed_gather(_t(emb), _t(ids)).numpy(), got)


# ------------------------------------------------------- int8 and batched attention


def _int8_cache(rng, shape):
    """int8 values and fp32 per-row scales, as models/kv_cache stores them."""
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32))


@pytest.mark.parametrize("S", SIZES)
def test_attend_flash_int8_ref_matches_pallas(S):
    """int8 KV with fp32 scales applied in score space (`_flash_kernel_q`).
    Tolerance: max abs err <= 1e-4 * max|y| (fp32; summation order and the
    online-softmax rescaling differ)."""
    rng = np.random.default_rng(500 + S)
    n_layers, KVH, H, D, L, layer, kv_limit = 2, 2, 4, 32, 256, 1, 131
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k, ks = _int8_cache(rng, (n_layers, KVH, L, D))
    v, vs = _int8_cache(rng, (n_layers, KVH, L, D))
    mask = np.asarray(causal_mask_rows(kv_limit - S, S, L))
    want = np.asarray(jax_attend_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.int32(kv_limit),
        block_k=128, interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        layer_idx=jnp.int32(layer)))
    qt, kt, vt, kst, vst, mt = _t(q), _t(k), _t(v), _t(ks), _t(vs), torch.as_tensor(mask)
    got = attend_flash_ref(qt, kt[layer], vt[layer], mt, kv_limit, k_scale=kst[layer],
                           v_scale=vst[layer]).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # the wrappers take the plain version for CPU tensors
    np.testing.assert_array_equal(
        attend_flash_int8(qt, kt, vt, kst, vst, mt, kv_limit, layer).numpy(), got)
    np.testing.assert_array_equal(
        attend_flash(qt, kt, vt, mt, kv_limit, layer, k_scale=kst, v_scale=vst).numpy(), got)


def _batched_inputs(rng, B, S, H, KVH, D, L, Bc, int8):
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    if int8:
        k, ks = _int8_cache(rng, (2, Bc, KVH, L, D))
        v, vs = _int8_cache(rng, (2, Bc, KVH, L, D))
    else:
        k = rng.standard_normal((2, Bc, KVH, L, D)).astype(np.float32)
        v = rng.standard_normal((2, Bc, KVH, L, D)).astype(np.float32)
        ks = vs = None
    return q, k, v, ks, vs


# case: (B, Bc, int8, slots, soft_cap, garbage past slot 0's limit)
BATCHED_CASES = {
    "per_slot_limits": (4, 4, False, None, 0.0, False),
    "limit_isolation": (2, 2, False, None, 0.0, True),
    "slots_indirection": (1, 4, False, [2], 0.0, False),
    "int8_scales": (3, 3, True, None, 0.0, False),
    "int8_soft_cap": (2, 2, True, None, 30.0, False),
    "int8_slots_indirection": (2, 4, True, [3, 0], 0.0, True),
}


@pytest.mark.parametrize("case", sorted(BATCHED_CASES))
def test_attend_flash_batched_ref_matches_pallas(case):
    """Plain versions of `_flash_kernel_b` / `_flash_kernel_bq` against the
    Pallas kernels in interpret mode, called as tests/test_batched_flash.py
    calls them: per-slot kv limits (the mask is false past each slot's limit,
    as the engine builds it, and every row sees at least one slot), slot
    indirection, int8 scales, soft cap. With `garbage`, slot 0's cache past its
    limit holds 1e6, which must not reach slot 0's output. Tolerance: max abs
    err <= 1e-4 * max|y| (fp32)."""
    B, Bc, int8, slots, cap, garbage = BATCHED_CASES[case]
    rng = np.random.default_rng(600 + sorted(BATCHED_CASES).index(case))
    S, H, KVH, D, L, layer = 8, 4, 2, 64, 256, 1
    q, k, v, ks, vs = _batched_inputs(rng, B, S, H, KVH, D, L, Bc, int8)
    limits = rng.integers(S + 1, L, B).astype(np.int32)
    mask = rng.random((B, S, L)) > 0.4
    for b in range(B):
        mask[b, :, limits[b]:] = False
        mask[b, :, 0] = True
    if garbage:
        row0 = slots[0] if slots else 0
        big = 127 if int8 else 1e6
        k[layer, row0, :, limits[0]:] = big
        v[layer, row0, :, limits[0]:] = big
    jslots = None if slots is None else jnp.asarray(slots, jnp.int32)
    jscales = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = np.asarray(jax_attend_flash_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.asarray(limits),
        jnp.int32(layer), slots=jslots, soft_cap=cap, block_k=128, interpret=True, **jscales))
    tslots = None if slots is None else torch.tensor(slots, dtype=torch.int32)
    tscales = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    args = (_t(q), _t(k), _t(v), torch.as_tensor(mask), _t(limits), layer)
    got = attend_flash_batched_ref(*args, slots=tslots, soft_cap=cap, **tscales).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(
        attend_flash_batched(*args, slots=tslots, soft_cap=cap, **tscales).numpy(), got)
    if int8:
        np.testing.assert_array_equal(attend_flash_batched_int8(
            _t(q), _t(k), _t(v), _t(ks), _t(vs), torch.as_tensor(mask), _t(limits), layer,
            slots=tslots, soft_cap=cap).numpy(), got)
    if garbage:  # slot 0 is blind to its cache past its own limit
        k[layer, :, :, limits[0]:] = 0
        v[layer, :, :, limits[0]:] = 0
        clean = attend_flash_batched_ref(_t(q), _t(k), _t(v), torch.as_tensor(mask),
                                         _t(limits), layer, slots=tslots, soft_cap=cap,
                                         **tscales).numpy()
        np.testing.assert_array_equal(clean[0], got[0])


# ------------------------------------------------------------------ W4A8 and the fused gate-up-SiLU


def _w4a8_case(S, dtype, group_size, K=512, N=256):
    rng = np.random.default_rng(400 + S + group_size)
    jq = _awq_numpy(rng, K, N, group_size)
    x = (rng.standard_normal((S, K)) * rng.uniform(0.01, 30.0, (S, 1))).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    return jq, jx, xt, params_from_numpy({"q": jq})["q"]


@pytest.mark.parametrize("group_size", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 7, 33])
def test_w4a8_ref_matches_pallas_kernel(S, dtype, group_size):
    """The int8 activations and their scales bit for bit equal to the JAX
    package's (its `/ 127.0` compiles to a multiply by the fp32 reciprocal, as
    the port computes it); the fp32 output within 1e-6 * max|y| (exact integer
    products, the fp32 fix-ups summed over groups in another order)."""
    from umbrella_tpu.ops.pallas.w4a8 import w4a8_matmul as jax_w4a8_matmul
    from umbrella_tpu_torch.ops.kernels.w4a8 import (quantize_activations_w4a8, w4a8_matmul,
                                                     w4a8_matmul_ref)

    jq, jx, xt, q = _w4a8_case(S, dtype, group_size)

    @jax.jit
    def jax_quantize(x):  # the JAX kernel's activation quantization (w4a8.py:100-102)
        xf = x.astype(jnp.float32)
        sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True), 1e-8) / 127.0
        return jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8), sx

    jxq, jsx = jax_quantize(jx)
    xq, sx = quantize_activations_w4a8(xt)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    want = np.asarray(jax_w4a8_matmul(jx, jq, interpret=True, out_dtype=jnp.float32))
    got = w4a8_matmul_ref(xt, q, out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(w4a8_matmul(xt, q, out_dtype=torch.float32).numpy(), got)


def test_w4a8_ref_is_row_invariant():
    """Bitwise: each row of a 33-row call equals that row alone, on a matrix
    whose K is split (the kernel's split is a function of N and K only)."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import kernel_splits, w4a8_matmul_ref

    _, _, xt, q = _w4a8_case(33, "bfloat16", 64, K=2048, N=64)
    assert kernel_splits(q) > 1
    whole = w4a8_matmul_ref(xt, q)
    for i in (0, 5, 32):
        assert torch.equal(whole[i:i + 1], w4a8_matmul_ref(xt[i:i + 1], q))


@pytest.mark.parametrize("S", [1, 7])
def test_w4a16_gate_up_silu_ref_matches_pallas_kernel(S):
    """As tests/test_awq.py holds the JAX kernel: the plain version within
    1e-4 * max|y| of JAX's w4a16_gate_up_silu(interpret=True) (both round x
    and the dequantized weight to bf16, sum in fp32 and apply g*sigmoid(g)*u
    to the sums), and within 2e-3 of the fp32 composed product."""
    from umbrella_tpu.ops.pallas.w4a16 import w4a16_gate_up_silu as jax_gate_up_silu
    from umbrella_tpu.quantization.awq import dequantize as jax_dequantize
    from umbrella_tpu_torch.ops.kernels.w4a16 import w4a16_gate_up_silu, w4a16_gate_up_silu_ref

    rng = np.random.default_rng(7)
    H, I, g = 256, 512, 64
    w = rng.standard_normal((H, 2 * I)).astype(np.float32) * 0.05
    jq = _np_tree(jax_pack(w, g))
    x = (rng.standard_normal((S, H)) * 0.1).astype(np.float32)
    want = np.asarray(jax_gate_up_silu(jnp.asarray(x), jq, interpret=True))
    q = params_from_numpy({"q": jq})["q"]
    got = w4a16_gate_up_silu_ref(_t(x), q).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    gu = x @ np.asarray(jax_dequantize(jq, jnp.float32))
    ref = gu[:, :I] / (1 + np.exp(-gu[:, :I])) * gu[:, I:]
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(w4a16_gate_up_silu(_t(x), q).numpy(), got)


def jax_pack(w, g):
    from umbrella_tpu.quantization.awq import pack_tpu_layout, quantize_matrix

    return pack_tpu_layout(*quantize_matrix(w, g), dtype=jnp.float32)


def _np_tree(q):
    return type(q)(*(np.asarray(a) for a in q))


def test_awq_dispatch_rules_on_the_cpu(monkeypatch, caplog):
    """awq_matmul: prefer_fused=None on a CPU tensor dequantizes (act_int8 or
    not, as the JAX package's dequant route ignores it); prefer_fused=True runs
    the kernel's plain version, W4A8 with act_int8. awq_gate_up_silu(fused=True)
    on the CPU warns and composes (the JAX package's rule); fused=False composes."""
    from umbrella_tpu_torch.ops.kernels import w4a8 as w4a8_mod
    from umbrella_tpu_torch.ops.kernels.w4a8 import w4a8_matmul_ref
    from umbrella_tpu_torch.ops.kernels.w4a16 import w4a16_gate_up_silu_ref
    from umbrella_tpu_torch.quantization import awq

    rng = np.random.default_rng(9)
    q = params_from_numpy({"q": _np_tree(jax_pack(
        rng.standard_normal((256, 128)).astype(np.float32) * 0.05, 64))})["q"]
    x = _t(rng.standard_normal((2, 3, 256)).astype(np.float32))
    dense = (x.float() @ awq.dequantize(q, torch.float32)).numpy()
    for a8 in (False, True):
        np.testing.assert_array_equal(awq.awq_matmul(x, q, act_int8=a8).numpy(), dense)
    np.testing.assert_array_equal(
        awq.awq_matmul(x, q, prefer_fused=True, act_int8=True).numpy(),
        w4a8_matmul_ref(x.reshape(6, 256), q).reshape(2, 3, 128).numpy())
    np.testing.assert_array_equal(
        awq.awq_matmul(x, q, prefer_fused=True).numpy(),
        w4a16_matmul_ref(x.reshape(6, 256), q).reshape(2, 3, 128).numpy())
    calls = []
    monkeypatch.setattr(w4a8_mod, "w4a8_matmul_ref",
                        lambda *a, **k: calls.append(1) or w4a8_matmul_ref(*a, **k))
    awq.awq_matmul(x, q, prefer_fused=True, act_int8=True)
    assert calls == [1]
    with caplog.at_level("WARNING", logger="umbrella_tpu_torch"):
        fused = awq.awq_gate_up_silu(x, q, fused=True)
    assert "does NOT measure the fused kernel" in caplog.text
    composed = awq.awq_gate_up_silu(x, q)
    np.testing.assert_array_equal(fused.numpy(), composed.numpy())
    d = dense.reshape(6, 128)
    want = (torch.nn.functional.silu(torch.from_numpy(d[:, :64])) * torch.from_numpy(d[:, 64:]))
    np.testing.assert_array_equal(composed.reshape(6, 64).numpy(), want.numpy())
    assert w4a16_gate_up_silu_ref(x.reshape(6, 256), q).shape == (6, 64)
