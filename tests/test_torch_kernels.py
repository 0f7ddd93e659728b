"""Plain versions of the PyTorch port's CUDA kernels vs the JAX package's Pallas
kernels run in interpret mode on the CPU.

The CUDA kernels themselves run only on a GPU (chip_smoke.py holds each one
against the plain version checked here). Inputs are made with numpy from a seed
and handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.ops.pallas.embed_gather import embed_gather as jax_embed_gather
from umbrella_tpu.ops.pallas.tree_attention import attend_flash as jax_attend_flash
from umbrella_tpu.ops.pallas.w4a16 import w4a16_matmul as jax_w4a16_matmul
from umbrella_tpu.ops.pallas.w4a8f import quantize_activations_int8 as jax_quantize_act
from umbrella_tpu.ops.pallas.w4a8f import w4a8f_matmul as jax_w4a8f_matmul
from umbrella_tpu.quantization.awq import AwqTensor as JaxAwqTensor
from umbrella_tpu.quantization.int4f import quantize_int4f as jax_quantize_int4f
from umbrella_tpu_torch.models.convert import params_from_numpy, to_tensor
from umbrella_tpu_torch.ops.kernels.embed_gather import embed_gather, embed_gather_ref
from umbrella_tpu_torch.ops.kernels.tree_attention import attend_dense, attend_flash
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
