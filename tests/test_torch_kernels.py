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
    """Tolerance: the int8 activations, their scales and row sums equal the
    jitted JAX quantizer's, and the int32 dot is exact; the fp32 output is
    within 1e-6 relative."""
    rng = np.random.default_rng(300 + S)
    w = rng.standard_normal((256, 256)).astype(np.float32) * 0.05
    jq = jax_quantize_int4f(w, group_size=64)
    x = rng.standard_normal((S, 256)).astype(np.float32)
    want = np.asarray(jax_w4a8f_matmul(jnp.asarray(x), jq, interpret=True,
                                       out_dtype=jnp.float32))
    q = params_from_numpy({"q": jq})["q"]
    xq, sx, rsum = quantize_activations_int8(_t(x), q.a)
    # jitted, as the JAX package runs it (inside the jitted w4a8f_matmul)
    jxq, jsx, jrsum = (np.asarray(a) for a in jax.jit(jax_quantize_act)(jnp.asarray(x), jq.a))
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int4f_quantizer_matches_jitted_jax_bit_for_bit(seed):
    """The JAX package runs quantize_activations_int8 only under jit, where XLA
    turns `/ 127.0` into a multiply by the fp32 reciprocal; eager JAX divides.
    On rows where the two scales differ in the last bit, the port's quantizer
    must follow the jitted one (sx, xq and the row sums bit for bit)."""
    rng = np.random.default_rng(700 + seed)
    x = (rng.standard_normal((512, 256)) * rng.uniform(0.01, 30.0, (512, 1))).astype(np.float32)
    a = rng.uniform(0.5, 2.0, 256).astype(np.float32)
    jx, ja = jnp.asarray(x), jnp.asarray(a)
    jitted = [np.asarray(t) for t in jax.jit(jax_quantize_act)(jx, ja)]
    eager_sx = np.asarray(jax_quantize_act(jx, ja)[1])
    assert (eager_sx != jitted[1]).any(), "no row where the divide and the reciprocal differ"
    got = quantize_activations_int8(_t(x), _t(a))
    for g, want in zip(got, jitted):
        np.testing.assert_array_equal(g.numpy(), want)


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


@pytest.mark.parametrize("group_size", [32, 64, 128])
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


@pytest.mark.parametrize("group_size", [32, 64, 128])
def test_w4a8_ref_with_split_k_matches_pallas_kernel(group_size):
    """At a shape whose K the kernel splits (whole groups a split, partial fp32
    sums added in split order): the plain version within 1e-6 * max|y| of JAX's
    w4a8_matmul (interpret), which sums all groups in one fp32 accumulator."""
    from umbrella_tpu.ops.pallas.w4a8 import w4a8_matmul as jax_w4a8_matmul
    from umbrella_tpu_torch.ops.kernels.w4a8 import _plan, w4a8_matmul_ref

    jq, jx, xt, q = _w4a8_case(9, "float32", group_size, K=2048, N=128)
    assert _plan(9, 2048, 128, group_size)["splits"] > 1
    want = np.asarray(jax_w4a8_matmul(jx, jq, interpret=True, out_dtype=jnp.float32))
    got = w4a8_matmul_ref(xt, q, out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_w4a8_ref_is_row_invariant():
    """Bitwise: each row of a 33-row call equals that row alone, on a matrix
    whose K is split (the kernel's split is a function of N and K only)."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import _plan, w4a8_matmul_ref

    _, _, xt, q = _w4a8_case(33, "bfloat16", 64, K=2048, N=64)
    assert _plan(33, 2048, 64, 64)["splits"] > 1
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


# ---- the W4A16 kernel's launch plan and operand checks (pure Python: the
# kernel itself runs only on the card, where chip_smoke.py holds it)

# (K, N per range, ranges): the 8B and 70B layer shapes, a fused gate|up pair,
# and a small one
PLAN_SHAPES = [(4096, 6144, 1), (4096, 4096, 1), (4096, 28672, 1), (14336, 4096, 1),
               (8192, 10240, 1), (8192, 8192, 1), (8192, 57344, 1), (28672, 8192, 1),
               (4096, 14336, 2), (8192, 4096, 2), (256, 48, 1)]
PLAN_ROWS = [1, 24, 127, 224, 300, 2047]


@pytest.mark.parametrize("K,N,ranges", PLAN_SHAPES)
def test_w4a16_plan_splits_and_tiles_ignore_the_row_count(K, N, ranges):
    """Column tiles and splits of K come from N and K only: every S gets the
    same summation order per row (row invariance by construction)."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import _plan

    plans = [_plan(S, K, N, ranges, 128) for S in PLAN_ROWS]
    assert len({(p["col_tiles"], p["splits"]) for p in plans}) == 1
    p = plans[0]
    assert p["col_tiles"] == -(-N // (128 if ranges == 1 else 64))
    # one wave of blocks at most, and at least 8 stages of 64 packed rows a split
    assert p["splits"] == 1 or (p["col_tiles"] * p["splits"] <= 132
                                and K // 2 // 64 // p["splits"] >= 8)


@pytest.mark.parametrize("n_col_tiles,n_chunks,min_chunks,blocks",
                         [(64, 64, 8, 132), (448, 64, 8, 132), (96, 64, 4, 528),
                          (2004, 64, 4, 528), (2, 20, 8, 132)])
def test_split_k_policy(n_col_tiles, n_chunks, min_chunks, blocks):
    """build.split_k, the one split policy of the W4 kernels: each split takes
    at least `min_chunks` chunks (unless the K range is not split at all), the
    grid stays within `blocks` blocks, and one more split would not."""
    from umbrella_tpu_torch.ops.kernels import build

    splits = build.split_k(n_col_tiles, n_chunks, min_chunks, blocks)
    assert splits >= 1
    assert splits == 1 or n_chunks // splits >= min_chunks
    assert splits == 1 or n_col_tiles * splits <= blocks
    assert n_col_tiles * (splits + 1) > blocks or n_chunks // (splits + 1) < min_chunks


@pytest.mark.parametrize("S", PLAN_ROWS)
def test_w4a16_plan_token_tiles(S):
    """ceil(min(S, 256) / 64) token tiles a block, in one wgmma of 64 tokens a
    tile (32 for S <= 32); S > 256 takes super-tiles of 256 rows."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import _plan

    p = _plan(S, 4096, 28672, 1, 128)
    assert p["token_tiles"] == -(-min(S, 256) // 64)
    assert p["token_width"] == (32 if S <= 32 else 64 * p["token_tiles"])
    assert p["super_tiles"] == -(-S // 256)


def _cpu_awq(K, N, group_size=128, layers=()):
    from umbrella_tpu_torch.quantization.awq import AwqTensor

    G = K // group_size
    return AwqTensor(torch.zeros((*layers, K // 2, N), dtype=torch.int8),
                     torch.ones((*layers, G, N), dtype=torch.bfloat16),
                     torch.zeros((*layers, G, N), dtype=torch.bfloat16))


@pytest.mark.parametrize("case", ["n_not_16", "k_not_2g", "k_not_128", "group_48", "group_96",
                                  "layer_int64", "layer_other_device", "layer_two_elements"])
def test_w4a16_check_raises_on_what_the_kernel_does_not_take(case):
    """The wrapper's operand checks raise ValueError (never a fallback): N not
    a multiple of 16 (TMA row strides), K not a multiple of 2 x group size or
    of 128 (whole stages of 64 packed rows), a group size other than 32 or a
    multiple of 64 (a stage holds half a group or whole groups), and a layer
    index that is not one int32 on x's device."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import _check

    x = torch.zeros((3, 512), dtype=torch.bfloat16)
    q, n, idx = _cpu_awq(512, 256), 256, None
    if case == "n_not_16":
        q, n = _cpu_awq(512, 200), 200
    elif case == "k_not_2g":
        x, q = torch.zeros((3, 384), dtype=torch.bfloat16), _cpu_awq(384, 256)
    elif case == "k_not_128":
        x, q = torch.zeros((3, 320), dtype=torch.bfloat16), _cpu_awq(320, 256, group_size=32)
    elif case in ("group_48", "group_96"):
        x, q = torch.zeros((3, 384), dtype=torch.bfloat16), _cpu_awq(384, 256, int(case[-2:]))
    else:
        q = _cpu_awq(512, 256, layers=(2,))
        idx = {"layer_int64": torch.tensor(1),
               "layer_other_device": torch.tensor(1, dtype=torch.int32, device="meta"),
               "layer_two_elements": torch.tensor([0, 1], dtype=torch.int32)}[case]
    with pytest.raises(ValueError):
        _check("w4a16_matmul", x, q, n, 1, torch.bfloat16, idx)


@pytest.mark.parametrize("group_size", [32, 64, 128])
def test_w4a16_check_passes_the_shipped_shapes(group_size):
    """The operand checks take an 8B layer shape at the AWQ group sizes, its
    stacked form with an int32 index, and a fused gate|up pair; they return
    the launch plan, whose splits do not depend on the group size."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import _check, _plan

    x = torch.zeros((127, 1024), dtype=torch.float32)
    assert _check("w4a16_matmul", x, _cpu_awq(1024, 768, group_size), 768, 1,
                  torch.float32) == _plan(127, 1024, 768, 1, 128)
    idx = torch.tensor(1, dtype=torch.int32)
    assert _check("w4a16_matmul_layered", x, _cpu_awq(1024, 768, layers=(3,)), 768, 1,
                  torch.bfloat16, idx)["splits"] >= 1
    assert _check("w4a16_gate_up_silu", x, _cpu_awq(1024, 768), 384, 2,
                  torch.bfloat16)["col_tiles"] == 6


def test_w4a16_gate_up_silu_raises_on_an_odd_width():
    """An odd packed gate|up width has no gate/up halves: ValueError on any device."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import w4a16_gate_up_silu

    with pytest.raises(ValueError):
        w4a16_gate_up_silu(torch.zeros((2, 256), dtype=torch.bfloat16), _cpu_awq(256, 251))


def test_launches_enter_the_tensors_card(monkeypatch):
    """build.on_device makes the tensor's card current around a launch and
    hands over that card's current stream, so a kernel on a cuda:1 tensor is
    never launched against the current device (cuda:0)."""
    import contextlib
    import types

    from umbrella_tpu_torch.ops.kernels import build

    entered, asked = [], []

    @contextlib.contextmanager
    def fake_device(dev):
        entered.append(dev)
        yield

    def fake_stream(dev):
        asked.append(dev)
        return types.SimpleNamespace(cuda_stream=4242)

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_stream)
    t = types.SimpleNamespace(device=torch.device("cuda", 1))
    with build.on_device(t) as st:
        assert entered == [torch.device("cuda", 1)]
    assert asked == [torch.device("cuda", 1)] and st.value == 4242


# ---- the int8 W4 kernel's launch plan and operand checks (w4a8f_matmul and
# w4a8_matmul; pure Python: the kernel runs only on the card)

# (K, N): the 8B layer shapes, the 8B lm_head, the 70B layer shapes, the 1B
# draft's, and a small one whose K/2 ends half-way through a stage
INT8_PLAN_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128256),
                    (8192, 10240), (8192, 8192), (8192, 57344), (28672, 8192), (2048, 3072),
                    (8192, 2048), (320, 48)]
INT8_PLAN_ROWS = [1, 24, 48, 127, 160, 224, 300, 384, 512, 2047]


@pytest.mark.parametrize("K,N,group_size", [
    (K, N, g) for K, N in INT8_PLAN_SHAPES for g in (None, 32, 64, 128)
    if g is None or (K // 2) % g == 0])
def test_w4a8_plan_splits_and_tiles_ignore_the_row_count(K, N, group_size):
    """Column tiles and splits of K come from N and K only (the same at every
    S); each split is whole stages of 64 packed rows and, for AWQ, whole
    groups; the splits cover K with none empty; one wave of 132 blocks at most
    and at least 8 stages a split, unless K is not split."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import _plan

    plans = [_plan(S, K, N, group_size) for S in INT8_PLAN_ROWS]
    assert len({(p["col_tiles"], p["splits"], p["chunks_per_split"]) for p in plans}) == 1
    p = plans[0]
    n_chunks = -(-K // 2 // 64)
    assert p["col_tiles"] == -(-N // 128)
    assert (p["splits"] - 1) * p["chunks_per_split"] < n_chunks <= p["splits"] * p["chunks_per_split"]
    if group_size is not None:
        assert (2 * p["chunks_per_split"] * 32) % group_size == 0
    assert p["splits"] == 1 or (p["col_tiles"] * p["splits"] <= 132
                                and p["chunks_per_split"] >= 8)


@pytest.mark.parametrize("S", INT8_PLAN_ROWS)
@pytest.mark.parametrize("group_size", [None, 128])
def test_w4a8_plan_token_tiles(S, group_size):
    """Token width: S rounded up to 32 (S <= 32) or to 64, at most 256 for Int4F
    and 64 for AWQ; super-tiles of that many rows beyond (so the lm_head's 384
    rows take two, an AWQ prefill chunk of 2047 thirty-two)."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import _plan

    cap = 256 if group_size is None else 64
    p = _plan(S, 4096, 28672, group_size)
    rows = min(S, cap)
    assert p["token_width"] == (32 if rows <= 32 else -(-rows // 64) * 64)
    assert p["token_width"] <= cap
    assert p["super_tiles"] == -(-S // cap)


def _cpu_int4f(K, N):
    from umbrella_tpu_torch.quantization.int4f import Int4FTensor

    return Int4FTensor(torch.zeros((K // 2, N), dtype=torch.int8), torch.ones(K),
                       torch.ones(N))


@pytest.mark.parametrize("case", ["k_mismatch", "k_not_64", "n_not_16", "x_fp16", "out_fp16",
                                  "x_strided", "a_length", "w8_int32"])
def test_w4a8f_check_raises_on_what_the_kernel_does_not_take(case):
    """w4a8f_matmul's operand checks raise ValueError (never a fallback): x and
    w8 of different K, K/2 not whole k32 steps, N not a multiple of 16 (TMA row
    strides), fp16 x or output, strided x, a malformed Int4FTensor."""
    from umbrella_tpu_torch.ops.kernels.w4a8f import _check

    x, q, od = torch.zeros((3, 512)), _cpu_int4f(512, 256), torch.float32
    if case == "k_mismatch":
        q = _cpu_int4f(1024, 256)
    elif case == "k_not_64":
        x, q = torch.zeros((3, 480)), _cpu_int4f(480, 256)
    elif case == "n_not_16":
        q = _cpu_int4f(512, 200)
    elif case == "x_fp16":
        x = x.half()
    elif case == "out_fp16":
        od = torch.float16
    elif case == "x_strided":
        x = torch.zeros((512, 3)).t()
    elif case == "a_length":
        q = q._replace(a=torch.ones(256))
    else:
        q = q._replace(w8=q.w8.int())
    with pytest.raises(ValueError):
        _check(x, q, od)


@pytest.mark.parametrize("case", ["groups_odd", "group_48", "k_mismatch",
                                  "n_not_16", "scales_shape", "zeros_dtype", "x_fp16"])
def test_w4a8_check_raises_on_what_the_kernel_does_not_take(case):
    """w4a8_matmul's operand checks raise ValueError: an odd group count (no
    low/high halves, so a group that does not divide K/2), a group size that is
    not whole k32 steps, x and w8 of different K, N not a multiple of 16,
    malformed scales or zeros, fp16 x."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import _check

    x, q, od = torch.zeros((3, 512)), _cpu_awq(512, 256, 64), torch.float32
    if case == "groups_odd":
        x, q = torch.zeros((3, 384)), _cpu_awq(384, 256, 128)
    elif case == "group_48":
        x, q = torch.zeros((3, 384)), _cpu_awq(384, 256, 48)
    elif case == "k_mismatch":
        x = torch.zeros((3, 1024))
    elif case == "n_not_16":
        q = _cpu_awq(512, 200, 64)
    elif case == "scales_shape":
        q = q._replace(scales=q.scales[:, :128])
    elif case == "zeros_dtype":
        q = q._replace(zeros=q.zeros.float())
    else:
        x = x.half()
    with pytest.raises(ValueError):
        _check(x, q, od)


@pytest.mark.parametrize("group_size", [32, 64, 96, 128])
def test_w4a8_check_passes_the_shipped_shapes(group_size):
    """The AWQ group sizes the kernel takes (any whole number of k32 steps that
    divides K/2) pass at an 8B layer shape, with bf16 and fp32 x, and the Int4F
    check passes the lm_head's shape; both return the launch plan."""
    from umbrella_tpu_torch.ops.kernels import w4a8, w4a8f

    K, N = 4608, 4096  # K/2 = 2304: whole groups of 32, 64, 96 and 128
    for xd in (torch.bfloat16, torch.float32):
        x = torch.zeros((127, K), dtype=xd)
        p = w4a8._check(x, _cpu_awq(K, N, group_size), torch.bfloat16)
        assert p["group_size"] == group_size and p["token_width"] == 64
        assert p["super_tiles"] == 2
    p = w4a8f._check(torch.zeros((24, 4096)), _cpu_int4f(4096, 128256), torch.float32)
    assert p == dict(token_width=32, super_tiles=1, col_tiles=1002, splits=1, chunks_per_split=32)


def test_quantize_rows_raises_on_what_the_kernel_does_not_take():
    """The fused quantizer raises before any launch: fp16 or strided x, K not a
    multiple of 64, a group size that is not whole k32 steps, a malformed a."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import quantize_rows

    for x, a, gs in ((torch.zeros((2, 256)).half(), None, None),
                     (torch.zeros((256, 2)).t(), None, None),
                     (torch.zeros((2, 96)), None, None),
                     (torch.zeros((2, 256)), None, 48),
                     (torch.zeros((2, 256)), torch.ones(128), None),
                     (torch.zeros((2, 256)), torch.ones(256, dtype=torch.float64), None)):
        with pytest.raises(ValueError):
            quantize_rows(x, a, gs)
