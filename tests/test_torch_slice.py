"""The PyTorch port (umbrella_tpu_torch) against the JAX package on the CPU.

Same inputs (numpy, from a seed) or the same weights (the JAX tree carried
across with params_from_numpy) go through both packages; each test states its
tolerance. The last tests hold the whole slice: the static engine's greedy
generate() is token-identical with the JAX StaticEngine and with the port's own
autoregressive decode.
"""
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.models import kv_cache as jax_kv
from umbrella_tpu.models.llama import llama_forward as jax_llama_forward
from umbrella_tpu.ops import masks as jax_masks
from umbrella_tpu.ops import norms as jax_norms
from umbrella_tpu.ops import rope as jax_rope
from umbrella_tpu.ops.pallas.w4a8f import int4f_matmul as jax_int4f_matmul
from umbrella_tpu.ops.select import embed_lookup as jax_embed_lookup
from umbrella_tpu.quantization import awq as jax_awq
from umbrella_tpu.quantization import int4f as jax_int4f
from umbrella_tpu.sequoia import generate_sequoia_tree as jax_generate_sequoia_tree
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.speculation.static_engine import StaticEngine as JaxStaticEngine
from umbrella_tpu.speculation.tree import GrowMap as JaxGrowMap
from umbrella_tpu.speculation.verify import accept_and_commit as jax_accept_and_commit
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.models import auto_model
from umbrella_tpu_torch.models.convert import kv_from_numpy, params_from_numpy
from umbrella_tpu_torch.models.kv_cache import gather_compact, init_kv_cache, update_layer
from umbrella_tpu_torch.models.llama import llama_forward
from umbrella_tpu_torch.ops import masks, norms, rope
from umbrella_tpu_torch.ops.sampling import draft_topk, greedy_sample
from umbrella_tpu_torch.ops.select import embed_lookup
from umbrella_tpu_torch.quantization import awq, int4f
from umbrella_tpu_torch.quantization.awq import AwqTensor
from umbrella_tpu_torch.quantization.int4f import Int4FTensor
from umbrella_tpu_torch.sequoia import generate_sequoia_tree, growmap_from_spec
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
from umbrella_tpu_torch.speculation.static_engine import StaticEngine
from umbrella_tpu_torch.speculation.tree import GrowMap
from umbrella_tpu_torch.speculation.verify import accept_and_commit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 256
CPU = "cpu"
SMALL = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
             max_position_embeddings=MAX_LEN, tie_word_embeddings=False, eos_token_id=-100)
EXIT = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ weights


def _hybrid_params(cfg):
    """tests/test_int4f.py's bench-primary composition: AWQ target, damped tail,
    Int4F shared prefix (EXIT layers + lm_head) converted on the target."""
    t = jax_auto.random_awq_runtime(cfg, MAX_LEN, dtype=jnp.float32, seed=2, group_size=64,
                                    quantize_lm_head=True)
    layers = dict(t.params["layers"])
    for k in ("wo", "down"):
        layers[k] = tuple(q._replace(scales=q.scales * 0.05) if i >= EXIT else q
                          for i, q in enumerate(layers[k]))
    return jax_int4f.hybridize_shared_prefix(dict(t.params, layers=layers), EXIT, group_size=64)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxConfig(**SMALL)
    return {
        "dense": jax_auto.random_runtime(cfg, MAX_LEN, dtype=jnp.float32, seed=0).params,
        "awq": jax_auto.random_awq_runtime(cfg, MAX_LEN, dtype=jnp.float32, seed=1,
                                           group_size=64, quantize_lm_head=True).params,
        "hybrid": _hybrid_params(cfg),
    }


def _leaves_equal(a, b):
    """Bit-level equality of a JAX numpy leaf and a port tensor."""
    a = np.asarray(a)
    t = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
    want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return t.numpy().dtype.itemsize == want.dtype.itemsize and np.array_equal(
        t.numpy().view(want.dtype), want)


def test_params_from_numpy_round_trips_quantized_leaves_bit_for_bit():
    cfg = JaxConfig(**SMALL)
    t = jax_auto.random_awq_runtime(cfg, MAX_LEN, dtype=jnp.bfloat16, seed=3, group_size=64,
                                    quantize_lm_head=True)
    src = _np(jax_int4f.hybridize_shared_prefix(t.params, EXIT, group_size=64))
    got = params_from_numpy(src, CPU)
    assert set(got) == set(src) and set(got["layers"]) == set(src["layers"])
    for name in ("wqkv", "wo", "gate_up", "down"):
        for i, (s, g) in enumerate(zip(src["layers"][name], got["layers"][name])):
            if i < EXIT:
                assert isinstance(g, Int4FTensor)
                assert g.w8.dtype == torch.int8 and g.a.dtype == torch.float32
                assert all(_leaves_equal(getattr(s, f), getattr(g, f)) for f in ("w8", "a", "b"))
            else:
                assert isinstance(g, AwqTensor) and g.scales.dtype == torch.bfloat16
                assert all(_leaves_equal(getattr(s, f), getattr(g, f))
                           for f in ("w8", "scales", "zeros"))
    assert isinstance(got["lm_head"], Int4FTensor)
    assert _leaves_equal(src["lm_head"].w8, got["lm_head"].w8)
    assert _leaves_equal(src["embed"], got["embed"])
    assert got["rope_scale"] == float(src["rope_scale"])
    # nibble layout: low nibble = row r, high nibble = row r + K/2
    j = src["layers"]["wqkv"][EXIT]
    deq = awq.dequantize(got["layers"]["wqkv"][EXIT], dtype=torch.float32).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jax_awq.dequantize(j, dtype=jnp.float32)))


def test_kv_from_numpy_round_trip():
    cfg = JaxConfig(**SMALL)
    rng = np.random.default_rng(0)
    kv = jax_kv.init_kv_cache(cfg, 64, dtype=jnp.float32)
    kv = jax_kv.update_layer(kv, 1, jnp.asarray(rng.standard_normal((3, 2, 32)), jnp.float32),
                             jnp.asarray(rng.standard_normal((3, 2, 32)), jnp.float32), 5)
    got = kv_from_numpy(_np(kv), CPU)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(kv.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(kv.v))


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("which", ["rms_norm", "gemma_rms_norm"])
def test_norms_match(which):
    """Tolerance: 1e-6 relative (fp32 elementwise and one row mean)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    want = np.asarray(getattr(jax_norms, which)(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = getattr(norms, which)(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rope_matches_with_llama3_scaling():
    """inv_freq exact; rotated q/k within 1e-5 abs (fp32 cos/sin of the same angles)."""
    kw = dict(SMALL, rope_theta=500000.0, rope_scaling=dict(
        rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
        original_max_position_embeddings=64))
    jinv, jscale = jax_rope.compute_inv_freq(JaxConfig(**kw))
    inv, scale = rope.compute_inv_freq(ModelConfig(**kw))
    np.testing.assert_array_equal(inv, jinv)
    assert scale == jscale
    rng = np.random.default_rng(2)
    q = rng.standard_normal((6, 4, 32)).astype(np.float32)
    k = rng.standard_normal((6, 2, 32)).astype(np.float32)
    pos = np.array([0, 1, 7, 63, 200, 1000], np.int32)
    jp = jax_rope.rope_params(JaxConfig(**kw))
    pp = rope.rope_params(ModelConfig(**kw))
    jq, jk = jax_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), jp["rope_inv_freq"],
                                 jp["rope_scale"], jnp.asarray(pos))
    pq, pk = rope.apply_rope(_t(q), _t(k), pp["rope_inv_freq"], pp["rope_scale"], _t(pos))
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-5)


@pytest.mark.parametrize("num_nodes", [1, 17, 250])  # 250: the tree window is clamped
def test_masks_match(num_nodes):
    """Exact."""
    gm = jax_growmap_from_spec(3, 4)
    bm = np.asarray(gm.bitmap)
    np.testing.assert_array_equal(
        masks.causal_mask_rows(num_nodes, 5, MAX_LEN).numpy(),
        np.asarray(jax_masks.causal_mask_rows(num_nodes, 5, MAX_LEN)))
    np.testing.assert_array_equal(
        masks.tree_mask_rows(num_nodes, _t(bm), MAX_LEN).numpy(),
        np.asarray(jax_masks.tree_mask_rows(num_nodes, jnp.asarray(bm), MAX_LEN)))
    for lvl in range(gm.num_levels):
        s, n = gm.level_start(lvl), len(gm.roots[lvl])
        np.testing.assert_array_equal(
            masks.tree_level_mask_rows(num_nodes, _t(bm), s, n, MAX_LEN).numpy(),
            np.asarray(jax_masks.tree_level_mask_rows(num_nodes, jnp.asarray(bm), s, n,
                                                      MAX_LEN)))


def test_kv_update_and_gather_compact_match():
    """Exact: slot writes, then compaction with the tail of the window zeroed."""
    cfg = JaxConfig(**SMALL)
    rng = np.random.default_rng(3)
    jkv = jax_kv.init_kv_cache(cfg, 64, dtype=jnp.float32, num_layers=2)
    pkv = init_kv_cache(ModelConfig(**SMALL), 64, dtype=torch.float32, num_layers=2)
    for layer, off in ((0, 3), (1, 10), (1, 60)):  # offset 60 is clamped to fit 6 slots
        kn = rng.standard_normal((6, 2, 32)).astype(np.float32)
        vn = rng.standard_normal((6, 2, 32)).astype(np.float32)
        jkv = jax_kv.update_layer(jkv, layer, jnp.asarray(kn), jnp.asarray(vn), off)
        update_layer(pkv, layer, _t(kn), _t(vn), off)
    idx = np.array([0, 2, 3, 5, 5, 5], np.int32)
    jkv = jax_kv.gather_compact(jkv, jnp.asarray(idx), 8, 4)
    gather_compact(pkv, _t(idx), 8, torch.tensor(4))
    np.testing.assert_array_equal(pkv.k.numpy(), np.asarray(jkv.k))
    np.testing.assert_array_equal(pkv.v.numpy(), np.asarray(jkv.v))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_and_commit_matches(seed):
    """Exact, on draws where samples often agree with the tree and EOS may appear."""
    gm = jax_growmap_from_spec(4, 5)
    T = gm.size
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, (3, T)).astype(np.int32)
    sampled = rng.integers(0, 4, (3, T)).astype(np.int32)
    old = rng.integers(0, 100, (3, T + 1)).astype(np.int32)
    eos = np.array([3], np.int32)
    want = jax_accept_and_commit(jnp.asarray(ids), jnp.asarray(sampled), jnp.asarray(old),
                                 jnp.asarray(gm.bitmap), jnp.asarray(gm.parents),
                                 jnp.asarray(gm.node_in_path), jnp.asarray(eos))
    got = accept_and_commit(_t(ids), _t(sampled), _t(old), _t(gm.bitmap), _t(gm.parents),
                            _t(gm.node_in_path), _t(eos))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sampling_matches():
    """Exact: argmax and the sorted top-k of logits without ties."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 512)).astype(np.float32)
    np.testing.assert_array_equal(greedy_sample(_t(logits)).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1)))
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 6)
    pv, pi = draft_topk(_t(logits), 6, recall=0.99)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_embed_lookup_matches():
    """Exact."""
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((100, 16)).astype(np.float32)
    ids = np.array([3, 99, 0, 3], np.int32)
    np.testing.assert_array_equal(embed_lookup(_t(emb), _t(ids)).numpy(),
                                  np.asarray(jax_embed_lookup(jnp.asarray(emb), jnp.asarray(ids))))


# ------------------------------------------------------------------ quantization


def test_quantize_pack_device_matches_bit_for_bit():
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((256, 384)) * 0.02).astype(np.float32)
    j = jax_awq.quantize_pack_device(jnp.asarray(w), 64, dtype=jnp.float32)
    p = awq.quantize_pack_device(_t(w), 64, dtype=torch.float32)
    np.testing.assert_array_equal(p.w8.numpy(), np.asarray(j.w8))
    np.testing.assert_array_equal(p.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_array_equal(p.zeros.numpy(), np.asarray(j.zeros))
    iw, iz, sc = awq.quantize_matrix(w, 64)
    jw, jz, jsc = jax_awq.quantize_matrix(w, 64)
    assert np.array_equal(iw, jw) and np.array_equal(iz, jz) and np.array_equal(sc, jsc)


@pytest.mark.parametrize("source", ["dense", "awq"])
@pytest.mark.parametrize("refine", [0, 16])
def test_quantize_int4f_matches(source, refine):
    """Row factor a within 1e-6 relative (log/exp/mean round differently).
    refine=0 (the main path's setting): b within 1e-5 relative and fewer than
    0.1% of nibbles differ -- each column's largest value sits exactly on the
    +-7.5-step rounding edge, where an ulp of a decides. refine=16: the ALS
    sweeps are discontinuous (a nibble that flips moves its column's next b by
    up to ~1%), so b must agree within 1e-5 on 90% of columns, fewer than 0.1%
    of nibbles may differ, and the fit's weight error must match JAX's within 1%."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((4096, 64)) * 0.03).astype(np.float32)
    if source == "awq":
        jsrc = jax_awq.quantize_pack_device(jnp.asarray(w), 64, dtype=jnp.float32)
        psrc = params_from_numpy({"q": _np(jsrc)})["q"]
        ref = np.asarray(jax_awq.dequantize(jsrc, dtype=jnp.float32))
    else:
        jsrc, psrc, ref = w, _t(w), w
    j = jax_int4f.quantize_int4f(jsrc, group_size=64, n_chunk=32, refine=refine)
    p = int4f.quantize_int4f(psrc, group_size=64, n_chunk=32, refine=refine)
    np.testing.assert_allclose(p.a.numpy(), np.asarray(j.a), rtol=1e-6)
    b_close = np.abs(p.b.numpy() / np.asarray(j.b) - 1) <= 1e-5
    assert b_close.all() if refine == 0 else b_close.mean() >= 0.9, b_close.mean()
    jw8 = np.asarray(j.w8).view(np.uint8)
    pw8 = p.w8.numpy().view(np.uint8)
    differ = np.count_nonzero((jw8 & 0xF) != (pw8 & 0xF)) + np.count_nonzero((jw8 >> 4) != (pw8 >> 4))
    assert differ < 1e-3 * 2 * jw8.size, differ

    def rel_err(deq):
        return np.sum((deq - ref) ** 2) / np.sum(ref ** 2)

    e_port = rel_err(int4f.dequantize_int4f(p, torch.float32).numpy())
    e_jax = rel_err(np.asarray(jax_int4f.dequantize_int4f(j, jnp.float32)))
    assert abs(e_port - e_jax) <= 0.01 * e_jax, (e_port, e_jax)


def test_int4f_matmul_routing_above_the_token_cap():
    """Above INT8_KERNEL_MAX_TOKENS both take the dequantize-to-bf16 dense path:
    within 1e-5 * max|y| (fp32 sums in another order)."""
    assert int4f.INT8_KERNEL_MAX_TOKENS == 384
    assert awq.FP16_MATMUL_HEURISTIC_TOKENS == jax_awq.FP16_MATMUL_HEURISTIC_TOKENS
    rng = np.random.default_rng(8)
    jq = jax_int4f.quantize_int4f((rng.standard_normal((128, 256)) * 0.03).astype(np.float32),
                                  group_size=64)
    q = params_from_numpy({"q": _np(jq)})["q"]
    for S in (7, 385):
        x = rng.standard_normal((S, 128)).astype(np.float32)
        want = np.asarray(jax_int4f_matmul(jnp.asarray(x), jq, out_dtype=jnp.float32))
        got = int4f.int4f_matmul(_t(x), q, out_dtype=torch.float32).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ------------------------------------------------------------------ trees


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "umbrella_tpu", "trees",
                                                               "*.json"))),
                         ids=os.path.basename)
def test_bundled_growmaps_match(path):
    name = os.path.basename(path)
    j = JaxGrowMap.from_json(path)
    p = GrowMap.from_json(name)  # resolved to the port's own trees/ copy
    assert os.path.exists(os.path.join(REPO, "umbrella_tpu_torch", "trees", name))
    for f in ("bitmap", "depth", "parents", "node_in_path"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f))
    assert (p.roots, p.branches, p.size) == (j.roots, j.branches, j.size)


@pytest.mark.parametrize("spec", [(3, 4, None), (24, 6, [0.55, 0.2, 0.1, 0.06, 0.05, 0.04])])
def test_sequoia_trees_match(spec):
    assert generate_sequoia_tree(*spec) == jax_generate_sequoia_tree(*spec)
    np.testing.assert_array_equal(growmap_from_spec(*spec).bitmap,
                                  jax_growmap_from_spec(*spec).bitmap)


# ------------------------------------------------------------------ model + engine


@pytest.mark.parametrize("kind", ["dense", "awq", "hybrid"])
def test_llama_forward_logits_match(jax_params, kind):
    """fp32 logits within 1e-4 abs; the KV written on both sides within 1e-5."""
    jp = jax_params[kind]
    cfg = JaxConfig(**SMALL)
    jrt = jax_auto.ModelRuntime(cfg, jp, MAX_LEN, dtype=jnp.float32)
    prt = auto_model.ModelRuntime(ModelConfig(**SMALL), params_from_numpy(_np(jp), CPU),
                                  MAX_LEN, dtype=torch.float32, device=CPU)
    ids = np.array([1, 17, 42, 9, 300, 511, 0, 7], np.int32)
    S = len(ids)
    jl, jkv = jax_llama_forward(jp, jrt.args, jrt.init_kv(), jnp.asarray(ids),
                                jnp.arange(S), jax_masks.causal_mask_rows(0, S, MAX_LEN), 0)
    pl, pkv = llama_forward(prt.params, prt.args, prt.init_kv(), _t(ids), torch.arange(S),
                            masks.causal_mask_rows(0, S, MAX_LEN), 0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(pkv.k.numpy(), np.asarray(jkv.k), atol=1e-5)


def _port_ar_decode(runtime, prompt, n_new):
    kv = runtime.init_kv()
    S = len(prompt)
    logits, kv = runtime.forward(runtime.params, kv, torch.tensor(prompt), torch.arange(S),
                                 masks.causal_mask_rows(0, S, MAX_LEN), 0)
    out = [int(torch.argmax(logits[-1]))]
    for t in range(S, S + n_new - 1):
        lg, kv = runtime.forward(runtime.params, kv, torch.tensor([out[-1]]), torch.tensor([t]),
                                 masks.causal_mask_rows(t, 1, MAX_LEN), t)
        out.append(int(torch.argmax(lg[0])))
    return out


def _port_engine(target, draft):
    eng = AutoEngine.from_config(
        device=CPU, engine="static", model=target, draft_model=draft,
        growmap=growmap_from_spec(3, 4), max_length=MAX_LEN, safe_buffer=32,
        eos_token_ids=[-1], dtype=torch.float32)
    eng.initialize()
    return eng


def test_slice_generate_token_identical_with_jax_and_ar(jax_params):
    """The slice as a whole: hybrid AWQ + Int4F target and its early-exit draft,
    carried across from JAX. 48 tokens identical with the JAX StaticEngine (exact
    draft top-k on both sides) and with the port's own greedy AR decode."""
    cfg = JaxConfig(**SMALL)
    jp = jax_params["hybrid"]
    jt = jax_auto.ModelRuntime(cfg, jp, MAX_LEN, dtype=jnp.float32)
    jeng = JaxStaticEngine(
        draft_model_name=jax_auto.early_exit_runtime(jt, exit_layer=EXIT), target_model_name=jt,
        dtype=jnp.float32, growmap=jax_growmap_from_spec(3, 4), max_length=MAX_LEN,
        safe_buffer=32, eos_token_ids=[-1], draft_topk_recall=1.0)
    jeng.initialize()
    prompt = [1, 17, 42, 9]
    want = jeng.generate(input_ids=prompt, max_new_tokens=48)

    pt = auto_model.ModelRuntime(ModelConfig(**SMALL), params_from_numpy(_np(jp), CPU), MAX_LEN,
                                 dtype=torch.float32, device=CPU)
    pd = auto_model.early_exit_runtime(pt, exit_layer=EXIT)
    assert pd.params["lm_head"] is pt.params["lm_head"]
    eng = _port_engine(pt, pd)
    got = eng.generate(input_ids=prompt, max_new_tokens=48)
    toks = got["generated_tokens"]
    assert len(toks) >= 48
    assert toks == want["generated_tokens"]
    assert got["avg_accept_tokens"] == want["avg_accept_tokens"]
    assert toks == _port_ar_decode(pt, prompt, len(toks))
    # the engine resets after generate(); a second request gives the same tokens
    assert eng.generate(input_ids=prompt, max_new_tokens=48)["generated_tokens"] == toks


def test_port_random_awq_runtime_spec_decode_is_lossless():
    """The port's own random constructors (torch.Generator weights) through the same
    composition: greedy spec decode equals the port's greedy AR decode."""
    cfg = ModelConfig(**SMALL)
    t = auto_model.random_awq_runtime(cfg, MAX_LEN, dtype=torch.float32, seed=4, group_size=64,
                                      quantize_lm_head=True, device=CPU)
    params = int4f.hybridize_shared_prefix(t.params, EXIT, group_size=64, refine=0)
    target = auto_model.ModelRuntime(cfg, params, MAX_LEN, dtype=torch.float32, device=CPU)
    eng = _port_engine(target, auto_model.early_exit_runtime(target, EXIT))
    toks = eng.generate(input_ids=[5, 6, 7], max_new_tokens=32)["generated_tokens"]
    assert len(toks) >= 32 and toks == _port_ar_decode(target, [5, 6, 7], len(toks))
    # the streaming loop commits the same tokens
    assert eng._prefill(np.array([5, 6, 7]))
    dec_len, _, steps = eng.speculative_decoding(max_new_tokens=32)
    streamed = eng.tokens_host[3:3 + dec_len].tolist()
    assert dec_len >= 32 and steps >= 1 and streamed == toks[:dec_len]


# ------------------------------------------------------------------ package rules


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import importlib, os, pkgutil, sys\n"
        "import umbrella_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'umbrella_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'umbrella_tpu' or m.startswith('umbrella_tpu.'))\n"
        "print(len(mods), bad, flush=True)\n"
        "os._exit(0)\n")  # skip torch's interpreter teardown
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 25 and bad == "[]", out.stdout


@pytest.mark.parametrize("entry", ["ModelRuntime", "random_runtime", "random_awq_runtime",
                                   "StaticEngine", "AutoEngine.from_config"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**dict(SMALL, num_hidden_layers=1))
    rt = auto_model.random_runtime(cfg, MAX_LEN, device=CPU)
    calls = {
        "ModelRuntime": lambda: auto_model.ModelRuntime(cfg, rt.params, MAX_LEN),
        "random_runtime": lambda: auto_model.random_runtime(cfg, MAX_LEN),
        "random_awq_runtime": lambda: auto_model.random_awq_runtime(cfg, MAX_LEN),
        "StaticEngine": lambda: StaticEngine(rt, rt, growmap=growmap_from_spec(3, 4)),
        "AutoEngine.from_config": lambda: AutoEngine.from_config(
            engine="static", model=rt, draft_model=rt, growmap=growmap_from_spec(3, 4)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_engine_rejects_what_this_slice_does_not_port():
    cfg = ModelConfig(**dict(SMALL, num_hidden_layers=1))
    rt = auto_model.random_runtime(cfg, MAX_LEN, device=CPU)
    base = dict(device=CPU, model=rt, draft_model=rt, growmap=growmap_from_spec(3, 4))
    with pytest.raises(NotImplementedError, match="item 7"):
        AutoEngine.from_config(engine="static", temperature=0.6, **base)
    with pytest.raises(NotImplementedError, match="item 8"):
        AutoEngine.from_config(engine="dynamic", **base)
    with pytest.raises(ValueError, match="not consumed"):
        AutoEngine.from_config(engine="static", tensor_paralel=2, **base)
    eng = AutoEngine.from_config(engine="static", max_length=MAX_LEN, **base)
    eng.initialize()
    with pytest.raises(NotImplementedError, match="item 7"):
        eng.generate(input_ids=[1, 2], max_new_tokens=4, temperature=0.7)
