"""The port's continuous-batching path (int8 KV cache, batched model, stochastic
sampling, BatchedStaticEngine and ContinuousBatcher) against the JAX package on
the CPU.

Inputs are made with numpy from a seed, or weights carried across from the JAX
package with params_from_numpy; each comparison states its tolerance. Greedy
BatchedStaticEngine.run() and the int8-KV StaticEngine are token-identical with
the JAX package's engines; the serving loops are held to run() and to each
other, and the lifecycle tests follow tests/test_pipelined_loop.py.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.models import batched as jax_batched
from umbrella_tpu.models import kv_cache as jax_kv
from umbrella_tpu.ops import masks as jax_masks
from umbrella_tpu.ops import sampling as jax_sampling
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.serving.batched_engine import BatchedStaticEngine as JaxBatchedEngine
from umbrella_tpu.speculation import auto_engine as jax_auto_engine
from umbrella_tpu.speculation.static_engine import StaticEngine as JaxStaticEngine
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.models import auto_model, batched
from umbrella_tpu_torch.models import kv_cache as port_kv
from umbrella_tpu_torch.models.convert import kv_from_numpy, params_from_numpy
from umbrella_tpu_torch.ops import masks, sampling
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.serving.batched_engine import (BatchedStaticEngine, ContinuousBatcher,
                                                       _ShutdownError)
from umbrella_tpu_torch.speculation import auto_engine

# The suite runs in several processes on shared cores: more than one intra-op
# thread per process makes these small CPU ops spin against each other (a
# sub-second test took minutes that way).
torch.set_num_threads(1)

MAX_LEN = 256
CPU = "cpu"
SMALL = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
             max_position_embeddings=MAX_LEN, tie_word_embeddings=False, eos_token_id=-100)
EXIT = 2
TREE = (3, 4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jx(a):
    return jnp.asarray(np.asarray(a))


# ------------------------------------------------------------------ weights and engines


@pytest.fixture(scope="module")
def jax_target():
    """A dense fp32 target; its first EXIT layers are the early-exit draft. The
    tail layers' wo and down are damped x0.05 (bench.py's primary composition),
    so the draft is often right and steps accept several tokens."""
    t = jax_auto.random_runtime(JaxConfig(**SMALL), MAX_LEN, dtype=jnp.float32, seed=0)
    layers = dict(t.params["layers"])
    for k in ("wo", "down"):
        layers[k] = layers[k].at[EXIT:].multiply(0.05)
    return jax_auto.ModelRuntime(JaxConfig(**SMALL), dict(t.params, layers=layers), MAX_LEN,
                                 dtype=jnp.float32)


@pytest.fixture(scope="module")
def port_models(jax_target):
    pt = auto_model.ModelRuntime(ModelConfig(**SMALL), params_from_numpy(_np(jax_target.params)),
                                 MAX_LEN, dtype=torch.float32, device=CPU)
    return pt, auto_model.early_exit_runtime(pt, EXIT)


def _engine(models, batch_size=3, max_length=MAX_LEN, segment_steps=2, **kw):
    target, draft = models
    eng = auto_engine.AutoEngine.from_config(
        device=CPU, engine="batched_static", model=target, draft_model=draft,
        batch_size=batch_size, growmap=growmap_from_spec(*TREE), max_length=max_length,
        safe_buffer=32, eos_token_ids=[-1], dtype=torch.float32, segment_steps=segment_steps,
        **kw)
    eng.initialize()
    return eng


def _requests(n, rng, lo=3, hi=24, max_new=(8, 24)):
    return [dict(input_ids=rng.integers(3, 500, size=int(rng.integers(lo, hi)))
                 .astype(np.int32).tolist(), max_new_tokens=int(rng.integers(*max_new)))
            for _ in range(n)]


def _ar_decode(runtime, prompt, n_new, kv_dtype=None):
    """The port's own greedy autoregressive decode (the oracle)."""
    kv = runtime.init_kv(kv_dtype=kv_dtype)
    S = len(prompt)
    logits, kv = runtime.forward(runtime.params, kv, torch.tensor(prompt), torch.arange(S),
                                 masks.causal_mask_rows(0, S, MAX_LEN), 0)
    out = [int(torch.argmax(logits[-1]))]
    for t in range(S, S + n_new - 1):
        lg, kv = runtime.forward(runtime.params, kv, torch.tensor([out[-1]]), torch.tensor([t]),
                                 masks.causal_mask_rows(t, 1, MAX_LEN), t)
        out.append(int(torch.argmax(lg[0])))
    return out


# ------------------------------------------------------------------ int8 KV cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_block_bit_exact_with_jax(dtype):
    """Exact, against `_quantize_block` as the JAX engines run it (under jit),
    rows of very different magnitude and an all-zero row included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 40, 64)) * rng.uniform(1e-3, 50.0, (3, 2, 40, 1))
    x[0, 0, 0] = 0.0
    jx = jnp.asarray(x, jnp.float32).astype(dtype)
    jq, js = jax.jit(jax_kv._quantize_block)(jx)
    q, s = port_kv._quantize_block(_t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("rows", [1, 7, 28, 127])
def test_rms_norm_is_row_invariant(rows):
    """The mean of squares is the fp64 sum of the fp32 squares, rounded to fp32
    once (exact against numpy), so each row equals that row normed alone, bit
    for bit, whatever the row count (on CUDA an fp32 reduction rounds
    differently for 1, 2-15 and 16+ rows); within 1e-6 of the JAX package's
    rms_norm."""
    from umbrella_tpu.ops import norms as jax_norms
    from umbrella_tpu_torch.ops import norms

    rng = np.random.default_rng(rows)
    x = (rng.standard_normal((rows, 4096)) * rng.uniform(0.1, 30.0, (rows, 1))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 4096).astype(np.float32)
    want = ((x * x).astype(np.float64).sum(-1, keepdims=True) / 4096).astype(np.float32)
    np.testing.assert_array_equal(norms._mean_square(_t(x)).numpy(), want)
    got = norms.rms_norm(_t(x), _t(w), 1e-5)
    for i in range(rows):
        np.testing.assert_array_equal(got[i:i + 1].numpy(),
                                      norms.rms_norm(_t(x[i:i + 1]), _t(w), 1e-5).numpy())
    ref = np.asarray(jax.jit(lambda a, b: jax_norms.rms_norm(a, b, 1e-5))(_jx(x), _jx(w)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_int8_update_layer_and_gather_compact_match():
    """Exact: quantized slot writes with their scales, then compaction of values
    and scales with the tail of the window zeroed (JAX under jit)."""
    cfg = JaxConfig(**SMALL)
    rng = np.random.default_rng(1)
    jkv = jax_kv.init_kv_cache(cfg, 64, dtype="int8", num_layers=2)
    pkv = port_kv.init_kv_cache(ModelConfig(**SMALL), 64, dtype="int8", num_layers=2)
    assert pkv.quantized and pkv.k.dtype == torch.int8 and pkv.k_scale.shape == (2, 2, 64)
    upd = jax.jit(jax_kv.update_layer, static_argnums=1)
    for layer, off in ((0, 3), (1, 10), (1, 60)):  # offset 60 is clamped to fit 6 slots
        kn = rng.standard_normal((6, 2, 32)).astype(np.float32)
        vn = rng.standard_normal((6, 2, 32)).astype(np.float32) * 3
        jkv = upd(jkv, layer, jnp.asarray(kn), jnp.asarray(vn), off)
        port_kv.update_layer(pkv, layer, _t(kn), _t(vn), off)
    idx = np.array([0, 2, 3, 5, 5, 5], np.int32)
    jkv = jax.jit(jax_kv.gather_compact)(jkv, jnp.asarray(idx), 8, 4)
    port_kv.gather_compact(pkv, _t(idx), 8, torch.tensor(4))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(pkv, name).numpy(), np.asarray(getattr(jkv, name)))
    got = kv_from_numpy(_np(jkv))
    assert got.quantized and np.array_equal(got.k_scale.numpy(), np.asarray(jkv.k_scale))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_batched_kv_update_and_compact_match(kv_dtype):
    """Exact: one indexed write for all slots (offsets clamped to fit, as
    dynamic_update_slice clamps), one slot's write, and the per-slot compaction
    equal the JAX package's unrolled versions (under jit)."""
    cfg = JaxConfig(**SMALL)
    rng = np.random.default_rng(2)
    B, S, L, T = 3, 6, 64, 5
    jdt = "int8" if kv_dtype == "int8" else jnp.float32
    jkv = jax_batched.init_batched_kv(cfg, B, L, jdt, num_layers=2)
    pkv = batched.init_batched_kv(ModelConfig(**SMALL), B, L,
                                  "int8" if kv_dtype == "int8" else torch.float32, num_layers=2)
    upd = jax.jit(jax_batched.update_layer_batched, static_argnums=1)
    for layer, offs in ((0, [0, 7, 20]), (1, [3, 61, 30])):  # 61 is clamped to 58
        kn = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
        vn = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
        jkv = upd(jkv, layer, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(offs, jnp.int32))
        batched.update_layer_batched(pkv, layer, _t(kn), _t(vn),
                                     torch.tensor(offs, dtype=torch.int32))
    kn = rng.standard_normal((4, 2, 32)).astype(np.float32)
    jkv = jax.jit(jax_batched.update_layer_slot, static_argnums=1)(
        jkv, 1, jnp.asarray(kn), jnp.asarray(kn * 2), jnp.int32(2), jnp.int32(40))
    batched.update_layer_slot(pkv, 1, _t(kn), _t(kn * 2), 2, 40)
    path = np.array([[0, 1, 3, 4, 4], [0, 2, 4, 4, 4], [0, 1, 2, 3, 4]], np.int32)
    offsets, alens = np.array([2, 59, 40], np.int32), np.array([4, 2, 0], np.int32)
    jkv = jax.jit(jax_batched.gather_compact_batched)(jkv, jnp.asarray(path),
                                                      jnp.asarray(offsets), jnp.asarray(alens))
    batched.gather_compact_batched(pkv, _t(path), _t(offsets), _t(alens))
    for name in ("k", "v", "k_scale", "v_scale"):
        want = getattr(jkv, name)
        if want is None:
            assert getattr(pkv, name) is None
            continue
        np.testing.assert_array_equal(getattr(pkv, name).numpy(), np.asarray(want))
    got = kv_from_numpy(_np(jkv))
    assert isinstance(got, batched.BatchedKVCache) and got.quantized == (kv_dtype == "int8")
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(jkv.k))


@pytest.mark.parametrize("spec", [(2, 3), (3, 4)])
def test_batched_masks_match(spec):
    """Exact, including a slot whose tree window runs past the row's end (250)."""
    gm = jax_growmap_from_spec(*spec)
    bm = np.asarray(gm.bitmap)
    nn = np.array([0, 1, 17, 250], np.int32)
    np.testing.assert_array_equal(
        masks.causal_mask_rows_batched(_t(nn), 5, MAX_LEN).numpy(),
        np.asarray(jax_masks.causal_mask_rows_batched(jnp.asarray(nn), 5, MAX_LEN)))
    np.testing.assert_array_equal(
        masks.tree_mask_rows_batched(_t(nn), _t(bm), MAX_LEN).numpy(),
        np.asarray(jax_masks.tree_mask_rows_batched(jnp.asarray(nn), jnp.asarray(bm), MAX_LEN)))
    for lvl in range(gm.num_levels):
        s, n = gm.level_start(lvl), len(gm.roots[lvl])
        np.testing.assert_array_equal(
            masks.tree_level_mask_rows_batched(_t(nn), _t(bm), s, n, MAX_LEN).numpy(),
            np.asarray(jax_masks.tree_level_mask_rows_batched(jnp.asarray(nn), jnp.asarray(bm),
                                                              s, n, MAX_LEN)))


# ------------------------------------------------------------------ batched model


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("form", ["batched", "slot"])
def test_batched_forwards_match_jax(jax_target, port_models, kv_dtype, form):
    """fp32 logits within 1e-4 abs of the JAX forward (jitted, as its engine runs
    it) on the same weights, for an fp32 and an int8 KV cache; the fp32 cache
    written on both sides within 1e-5, the int8 one within one quantization
    step per value."""
    cfg, args = JaxConfig(**SMALL), jax_target.args
    pt = port_models[0]
    jdt = "int8" if kv_dtype == "int8" else jnp.float32
    pdt = "int8" if kv_dtype == "int8" else torch.float32
    rng = np.random.default_rng(3)
    B, S = 3, 5
    ids = rng.integers(0, 512, (B, S)).astype(np.int32)
    offsets = np.array([0, 7, 3], np.int32)
    pos = offsets[:, None] + np.arange(S)[None, :]
    mask = np.stack([np.asarray(jax_masks.causal_mask_rows(int(o), S, MAX_LEN)) for o in offsets])
    jkv = jax_batched.init_batched_kv(cfg, B, MAX_LEN, jdt)
    pkv = batched.init_batched_kv(ModelConfig(**SMALL), B, MAX_LEN, pdt)
    if form == "batched":
        jl, jkv = jax.jit(lambda p, kv: jax_batched.batched_llama_forward(
            p, args, kv, _jx(ids), _jx(pos), _jx(mask), _jx(offsets)))(jax_target.params, jkv)
        pl, pkv = batched.batched_llama_forward(pt.params, pt.args, pkv, _t(ids), _t(pos),
                                                _t(mask), _t(offsets))
    else:
        jl, jkv = jax.jit(lambda p, kv: jax_batched.slot_llama_forward(
            p, args, kv, _jx(ids[0]), _jx(pos[1]), _jx(mask[1]), jnp.int32(2), jnp.int32(7)))(
            jax_target.params, jkv)
        pl, pkv = batched.slot_llama_forward(pt.params, pt.args, pkv, _t(ids[0]), _t(pos[1]),
                                             _t(mask[1]), 2, 7)
        assert not pkv.k[:, :2].any()  # the other slots' rows are untouched
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    if kv_dtype == "int8":
        assert np.abs(pkv.k.numpy().astype(np.int32) - np.asarray(jkv.k, np.int32)).max() <= 1
        np.testing.assert_allclose(pkv.k_scale.numpy(), np.asarray(jkv.k_scale), rtol=1e-5)
    else:
        np.testing.assert_allclose(pkv.k.numpy(), np.asarray(jkv.k), atol=1e-5)


# ------------------------------------------------------------------ sampling


def test_repetition_penalty_and_renorm_match_jax():
    """apply_repetition_penalty and find_first_in_set exact; the top-p renorms
    within 1e-6 (a sum normalizes them)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 64)).astype(np.float32) * 3
    prev = rng.integers(0, 64, 30).astype(np.int32)
    for pen in (1.3, 0.8):
        np.testing.assert_array_equal(
            sampling.apply_repetition_penalty(_t(logits), _t(prev), 17, pen).numpy(),
            np.asarray(jax_sampling.apply_repetition_penalty(_jx(logits), _jx(prev), 17, pen)))
    # per-slot form: [B, S, V] logits, [B, P] tokens, [B] lengths and penalties
    B = 3
    lb = rng.standard_normal((B, 4, 64)).astype(np.float32)
    pb = rng.integers(0, 64, (B, 30)).astype(np.int32)
    lens, pens = np.array([0, 9, 30], np.int32), np.array([1.0, 1.2, 0.7], np.float32)
    got = sampling.apply_repetition_penalty(_t(lb), _t(pb), _t(lens), _t(pens)).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got[b], np.asarray(jax_sampling.apply_repetition_penalty(
            _jx(lb[b]), _jx(pb[b]), int(lens[b]), float(pens[b]))))
    probs = np.asarray(jax.nn.softmax(_jx(logits), axis=-1))
    np.testing.assert_allclose(sampling.top_p_renorm_probs(_t(probs), 0.8).numpy(),
                               np.asarray(jax_sampling.top_p_renorm_probs(_jx(probs), 0.8)),
                               rtol=1e-6, atol=1e-7)
    topk = np.where(logits >= np.sort(logits, -1)[:, -8:-7], probs, 0.0).astype(np.float32)
    np.testing.assert_allclose(
        sampling.top_p_renorm_after_topk(_t(topk), 0.7, 8).numpy(),
        np.asarray(jax_sampling.top_p_renorm_after_topk(_jx(topk), 0.7, 8)), rtol=1e-6, atol=1e-7)
    toks = np.array([5, 9, 2, 9, 7], np.int32)
    for eos, n in (([9], 5), ([9], 1), ([3], 5), ([7, 2], 5)):
        assert int(sampling.find_first_in_set(_t(toks), _t(np.array(eos, np.int32)), n)) == \
            int(jax_sampling.find_first_in_set(_jx(toks), _jx(np.array(eos, np.int32)), n))


@pytest.mark.parametrize("temperature,topp", [(0.7, 0.8), (1.0, 0.95), (0.4, 1.0)])
def test_sample_top_k_top_p_rows_chi_square(temperature, topp):
    """40,000 draws from one logits row against the exact top-k/top-p
    distribution computed in numpy: no draw leaves the kept set, and a
    chi-square test does not reject (p > 1e-4)."""
    rng = np.random.default_rng(5)
    V, k, R = 64, 8, 40000
    row = (rng.standard_normal(V) * 2).astype(np.float32)
    order = np.argsort(-row)[:k]
    p = np.exp((row[order] - row[order].max()) / temperature)
    p /= p.sum()
    keep = (np.cumsum(p) - p) < topp
    exact = np.where(keep, p, 0.0)
    exact /= exact.sum()
    gen = torch.Generator().manual_seed(11)
    draws = sampling.sample_top_k_top_p_rows(gen, _t(np.tile(row, (R, 1))),
                                             torch.full((R,), temperature), k,
                                             torch.full((R,), topp)).numpy()
    assert draws.dtype == np.int32
    kept = order[keep]
    assert np.isin(draws, kept).all()
    counts = np.array([(draws == t).sum() for t in kept])
    if len(kept) > 1:
        f_exp = exact[keep] / exact[keep].sum() * counts.sum()
        assert stats.chisquare(counts, f_exp).pvalue > 1e-4


# ------------------------------------------------------------------ engines vs JAX


@pytest.fixture(scope="module")
def jax_batched_runs(jax_target):
    """JAX BatchedStaticEngine.run() on 6 requests over 4 slots, fp32 and int8 KV."""
    jd = jax_auto.early_exit_runtime(jax_target, exit_layer=EXIT)
    reqs = _requests(6, np.random.default_rng(6), max_new=(16, 32))
    out = {}
    for kv in (None, "int8"):
        eng = JaxBatchedEngine(
            draft_model_name=jd, target_model_name=jax_target, batch_size=4, dtype=jnp.float32,
            growmap=jax_growmap_from_spec(*TREE), max_length=MAX_LEN, safe_buffer=32,
            eos_token_ids=[-1], draft_topk_recall=1.0, segment_steps=4, kv_dtype=kv)
        eng.initialize()
        out[kv] = eng.run([dict(r) for r in reqs])
    return reqs, out


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_batched_run_token_identical_with_jax(port_models, jax_batched_runs, kv_dtype):
    """Greedy run() over more requests than slots: every request's tokens and
    accept rate equal the JAX BatchedStaticEngine's on the same weights."""
    reqs, want = jax_batched_runs
    eng = _engine(port_models, batch_size=4, segment_steps=4, kv_dtype=kv_dtype)
    assert eng.kv_target.quantized == (kv_dtype == "int8")
    got = eng.run([dict(r) for r in reqs])
    for i, (g, w) in enumerate(zip(got, want[kv_dtype])):
        assert len(g["generated_tokens"]) >= reqs[i]["max_new_tokens"]
        assert g["generated_tokens"] == w["generated_tokens"], i
        assert g["avg_accept_tokens"] == pytest.approx(w["avg_accept_tokens"]), i
    assert max(g["avg_accept_tokens"] for g in got) > 1.5  # the early-exit draft is accepted


def test_static_engine_int8_kv_token_identical_with_jax(jax_target, port_models):
    """kv_dtype="int8" through the single-slot StaticEngine: 40 tokens identical
    with the JAX StaticEngine on the same weights."""
    jeng = JaxStaticEngine(
        draft_model_name=jax_auto.early_exit_runtime(jax_target, exit_layer=EXIT),
        target_model_name=jax_target, dtype=jnp.float32, growmap=jax_growmap_from_spec(*TREE),
        max_length=MAX_LEN, safe_buffer=32, eos_token_ids=[-1], draft_topk_recall=1.0,
        kv_dtype="int8")
    jeng.initialize()
    prompt = [1, 17, 42, 9]
    want = jeng.generate(input_ids=prompt, max_new_tokens=40)
    target, draft = port_models
    eng = auto_engine.AutoEngine.from_config(
        device=CPU, engine="static", model=target, draft_model=draft,
        growmap=growmap_from_spec(*TREE), max_length=MAX_LEN, safe_buffer=32,
        eos_token_ids=[-1], dtype=torch.float32, kv_dtype="int8")
    eng.initialize()
    assert eng.kv_target.quantized
    got = eng.generate(input_ids=prompt, max_new_tokens=40)
    assert len(got["generated_tokens"]) >= 40
    assert got["generated_tokens"] == want["generated_tokens"]
    assert got["avg_accept_tokens"] == want["avg_accept_tokens"]


# ------------------------------------------------------------------ engine paths


def test_batched_greedy_matches_ar_oracle_per_slot(port_models):
    """Three slots with different prompt lengths decode together; every slot
    equals the AR oracle (int8 KV: the oracle decodes on an int8 cache too)."""
    target, _ = port_models
    for kv in (None, "int8"):
        eng = _engine(port_models, batch_size=3, kv_dtype=kv)
        prompts = [[1, 17, 42, 9], [3, 3, 7], [50, 60, 70, 80, 90, 11]]
        starts = []
        for b, p in enumerate(prompts):
            assert eng.admit(b, p)
            starts.append(int(eng.num_nodes[b]))
        for _ in range(5):
            out = eng.step()
            assert set(out) == {0, 1, 2} and all(a >= 1 for a, _ in out.values())
        for b, p in enumerate(prompts):
            produced = eng.tokens_host[b, starts[b]:int(eng.num_nodes[b]) + 1].tolist()
            assert len(produced) >= 6
            assert produced == _ar_decode(target, p, len(produced), kv), (kv, b)


def test_step_many_matches_stepwise_step(port_models):
    """A fused 4-step segment leaves the same tokens and lengths as four step()
    calls, and per-slot budgets stop slots on the device."""
    prompts = [[1, 17, 42, 9], [3, 3, 7]]
    eng_a, eng_b = _engine(port_models, batch_size=2), _engine(port_models, batch_size=2)
    for b, p in enumerate(prompts):
        assert eng_a.admit(b, p) and eng_b.admit(b, p)
    for _ in range(4):
        eng_a.step()
    steps = eng_b.step_many(4, [int(eng_b.num_nodes[b]) + 1000 for b in range(2)])
    assert list(steps) == [4, 4]
    assert list(eng_a.num_nodes) == list(eng_b.num_nodes)
    for b in range(2):
        nn = int(eng_a.num_nodes[b])
        assert eng_a.tokens_host[b, :nn + 1].tolist() == eng_b.tokens_host[b, :nn + 1].tolist()
    eng_c = _engine(port_models, batch_size=2)
    st = []
    for b, p in enumerate(prompts):
        assert eng_c.admit(b, p)
        st.append(int(eng_c.num_nodes[b]))
    eng_c.step_many(6, [st[0] + 2, st[1] + 10 ** 6])
    assert not eng_c.active[0] and eng_c.active[1]
    assert int(eng_c.num_nodes[0]) >= st[0] + 2
    toks = eng_c.tokens_host[0, st[0]:int(eng_c.num_nodes[0]) + 1].tolist()
    assert toks == _ar_decode(port_models[0], prompts[0], len(toks))


def test_mixed_greedy_and_stochastic_slots(port_models):
    """Half the slots sample (temperature, top-p, penalty): the greedy slots stay
    token-identical to the AR oracle and the stochastic ones make progress with
    tokens in range."""
    target, _ = port_models
    eng = _engine(port_models, batch_size=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, rng.integers(2, 7)).tolist() for _ in range(4)]
    starts = []
    for b, p in enumerate(prompts):
        assert eng.admit(b, p)
        starts.append(int(eng.num_nodes[b]))
    tv = np.array([0.0, 0.9, 0.0, 0.7], np.float32)
    for _ in range(4):
        eng.step(temperature=tv, topp=0.9, penalty=[1.0, 1.2, 1.0, 1.1])
    for b in range(4):
        produced = eng.tokens_host[b, starts[b]:int(eng.num_nodes[b]) + 1].tolist()
        assert int(eng.num_nodes[b]) - starts[b] >= 4
        assert all(0 <= t < 512 for t in produced)
        if tv[b] == 0:
            assert produced == _ar_decode(target, prompts[b], len(produced)), b


def _through_batcher(models, pipeline, reqs, stagger=0.0, **engine_kw):
    eng = _engine(models, **engine_kw)
    batcher = ContinuousBatcher(eng, pipeline=pipeline)
    batcher.start()
    try:
        futs = []
        for r in reqs:
            futs.append(batcher.submit(**dict(r)))
            if stagger:
                time.sleep(stagger)
        return [f.result(timeout=120) for f in futs]
    finally:
        batcher.shutdown()


LOOP_CASES = {
    "burst": dict(n=8, seed=11, stagger=0.0, kw={}),
    "staggered": dict(n=6, seed=5, stagger=0.02, kw={}),
    "multichunk_admission": dict(n=3, seed=3, stagger=0.0,
                                 kw=dict(batch_size=2, max_length=1024)),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_pipelined_equals_serial_equals_run(port_models, case):
    """Committed tokens are identical through run(), the serial loop and the
    lag-1 pipelined loop (multichunk: prompts above the 512-token prefill
    bucket admit over several segment boundaries)."""
    c = LOOP_CASES[case]
    rng = np.random.default_rng(c["seed"])
    if case == "multichunk_admission":
        reqs = [dict(input_ids=rng.integers(3, 500, size=n).astype(np.int32).tolist(),
                     max_new_tokens=m) for n, m in ((600, 16), (20, 24), (550, 12))]
    else:
        reqs = _requests(c["n"], rng)
    run = _engine(port_models, **c["kw"]).run([dict(r) for r in reqs])
    serial = _through_batcher(port_models, False, reqs, c["stagger"], **c["kw"])
    pipelined = _through_batcher(port_models, True, reqs, c["stagger"], **c["kw"])
    for i, (r, s, p) in enumerate(zip(run, serial, pipelined)):
        assert r["generated_tokens"] == s["generated_tokens"] == p["generated_tokens"], i
    assert all(p["time_per_output_token"] > 0 and p["ttft_ms"] > 0 for p in pipelined)


# ------------------------------------------------------------------ serving lifecycle


def _fails_with(fut, text, timeout=60):
    with pytest.raises(RuntimeError, match=text):
        fut.result(timeout=timeout)


@pytest.mark.parametrize("pipeline", [True, False])
def test_loop_crash_fails_futures_fast(port_models, pipeline):
    """If the loop thread dies, every in-flight and queued request gets the
    exception at once, and later submits fail fast."""
    eng = _engine(port_models)

    def boom(*a, **k):
        raise RuntimeError("injected failure")

    if pipeline:
        eng.step_many_async = boom
    else:
        eng.step_many = boom
    batcher = ContinuousBatcher(eng, pipeline=pipeline)
    batcher.start()
    try:
        for f in [batcher.submit(input_ids=[3, 1, 4], max_new_tokens=16) for _ in range(5)]:
            _fails_with(f, "injected failure")
        batcher._thread.join(timeout=10)
        t0 = time.time()
        _fails_with(batcher.submit(input_ids=[3, 1, 4], max_new_tokens=8), "injected failure")
        assert time.time() - t0 < 5
    finally:
        batcher.shutdown()


class _FakeTokenizer:
    def encode(self, text):
        return [int(t) for t in text.split()]

    def decode(self, ids, **_):
        return " ".join(str(int(t)) for t in ids)


def test_stream_no_cross_request_leak_on_slot_reuse(port_models):
    """In the pipelined loop a reused slot must never stream its previous
    occupant's tokens: every frame is a prefix of the request's final tokens."""
    eng = _engine(port_models, batch_size=2)
    eng.tokenizer = _FakeTokenizer()
    batcher = ContinuousBatcher(eng, pipeline=True)
    batcher.start()
    try:
        f0 = batcher.submit(input_ids=[7] * 30, max_new_tokens=96)
        batcher.submit(input_ids=[9] * 20, max_new_tokens=8).result(timeout=120)
        frames = []
        r2 = batcher.submit(input_ids=[3, 1, 4], max_new_tokens=40,
                            stream_cb=lambda t, p: frames.append(t)).result(timeout=120)
        f0.result(timeout=120)
    finally:
        batcher.shutdown()
    final = r2["generated_tokens"]
    assert frames
    for t in frames:
        ids = [int(x) for x in t.split()] if t else []
        assert ids == final[:len(ids)]


def test_engine_reusable_after_pipelined_batcher(port_models):
    """The loop drops the device-carried state on exit: a later run() admits
    and decodes from the host mirrors."""
    eng = _engine(port_models)
    batcher = ContinuousBatcher(eng, pipeline=True)
    batcher.start()
    try:
        batcher.submit(input_ids=[5, 2, 8], max_new_tokens=12).result(timeout=120)
    finally:
        batcher.shutdown()
    res = eng.run([dict(input_ids=[1, 2, 3], max_new_tokens=10)])
    assert len(res[0]["generated_tokens"]) >= 10


def test_shutdown_fails_unfinished_futures(port_models):
    """shutdown() resolves every future the loop never finished (in-flight,
    staged, queued) with the shutdown error, and later submits fail fast."""
    eng = _engine(port_models)
    batcher = ContinuousBatcher(eng, pipeline=True)
    batcher.start()
    futs = [batcher.submit(input_ids=[3 + i, 1, 4], max_new_tokens=4096) for i in range(6)]
    time.sleep(0.3)
    batcher.shutdown()
    t0 = time.time()
    for f in futs:
        _fails_with(f, "shut down", timeout=30)
    assert time.time() - t0 < 10
    _fails_with(batcher.submit(input_ids=[1, 2], max_new_tokens=4), "shut down", timeout=30)


def test_batcher_restart_after_clean_shutdown(port_models):
    eng = _engine(port_models)
    batcher = ContinuousBatcher(eng, pipeline=True)
    batcher.start()
    r1 = batcher.submit(input_ids=[5, 2, 8], max_new_tokens=8).result(timeout=120)
    batcher.shutdown()
    batcher.start()
    try:
        r2 = batcher.submit(input_ids=[5, 2, 8], max_new_tokens=8).result(timeout=120)
    finally:
        batcher.shutdown()
    assert r1["generated_tokens"] == r2["generated_tokens"]


def _wedged_batcher(port_models):
    """A pipelined batcher whose loop blocks in its first segment sync until
    `gate` is set, with some requests in slots and the rest queued."""
    eng = _engine(port_models)
    gate, entered = threading.Event(), threading.Event()
    sync = eng.sync_segment

    def wedged_sync(handle):
        entered.set()
        gate.wait(timeout=60)
        return sync(handle)

    eng.sync_segment = wedged_sync
    batcher = ContinuousBatcher(eng, pipeline=True)
    batcher.start()
    futs = [batcher.submit(input_ids=[3 + i, 1, 4], max_new_tokens=2) for i in range(6)]
    assert entered.wait(timeout=60)
    return eng, batcher, gate, futs


def test_shutdown_while_loop_wedged_is_safe(port_models):
    """shutdown() whose join times out (the loop is stuck in a device sync)
    reads the slot tracker under its lock and fails every future; when the loop
    wakes, its harvest meets futures already failed and the loop still ends
    cleanly, leaving the engine reusable."""
    eng, batcher, gate, futs = _wedged_batcher(port_models)
    try:
        batcher.shutdown(timeout=0.2)
        assert batcher._thread.is_alive()
        for f in futs:
            _fails_with(f, "shut down", timeout=5)
    finally:
        gate.set()
    batcher._thread.join(timeout=60)
    assert not batcher._thread.is_alive()
    assert isinstance(batcher._crashed, _ShutdownError)  # the loop did not crash
    assert not eng.active.any() and eng._dev_nn is None


def test_start_refuses_while_previous_loop_alive(port_models):
    """start() raises while the previous loop thread still runs (after a
    shutdown whose join timed out, or without any shutdown): two loops never
    step one engine. Once the old loop has ended, start() serves again."""
    eng, batcher, gate, futs = _wedged_batcher(port_models)
    try:
        with pytest.raises(RuntimeError, match="still running"):
            batcher.start()
        batcher.shutdown(timeout=0.2)
        with pytest.raises(RuntimeError, match="still running"):
            batcher.start()
    finally:
        gate.set()
    batcher._thread.join(timeout=60)
    eng.sync_segment = BatchedStaticEngine.sync_segment.__get__(eng)
    batcher.start()
    try:
        r = batcher.submit(input_ids=[5, 2, 8], max_new_tokens=6).result(timeout=120)
    finally:
        batcher.shutdown()
    assert len(r["generated_tokens"]) >= 6


# ------------------------------------------------------------------ entry point


def test_batched_static_allowlist_and_refusals(port_models):
    """The batched_static key allowlist is the JAX package's; the parallel
    keys refuse what the JAX package refuses (two at once, pipeline
    staging, offload, a packed target for tensor_parallel, a dense one for
    expert_parallel); quantize_draft is taken, and num_cache_layers is
    accepted and unused (resident models), as in the JAX package."""
    assert auto_engine._ENGINE_CONFIG_KEYS["batched_static"] == \
        jax_auto_engine._ENGINE_CONFIG_KEYS["batched_static"]
    target, draft = port_models
    base = dict(device=CPU, engine="batched_static", model=target, draft_model=draft,
                growmap=growmap_from_spec(*TREE), max_length=MAX_LEN)
    assert isinstance(auto_engine.AutoEngine.from_config(**base, batch_size=2, tensor_parallel=1),
                      BatchedStaticEngine)
    with pytest.raises(ValueError, match="not consumed"):
        auto_engine.AutoEngine.from_config(**base, stop_distance=8)
    with pytest.raises(ValueError, match="not consumed"):
        auto_engine.AutoEngine.from_config(**base, batch_sise=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        auto_engine.AutoEngine.from_config(**base, tensor_parallel=2, expert_parallel=2)
    # tensor and expert parallelism are carried (tests/test_torch_tp.py,
    # test_torch_ep.py): a packed target cannot be tensor-sharded, a dense one
    # has no experts
    for key, match in (("tensor_parallel", "packed"), ("expert_parallel", "requires an MoE")):
        eng = auto_engine.AutoEngine.from_config(**base, **{key: 2})
        with pytest.raises(ValueError, match=match):
            eng.initialize()
    with pytest.raises(ValueError, match="pipeline_parallel"):
        auto_engine.AutoEngine.from_config(**base, pipeline_parallel=2)
    with pytest.raises(ValueError, match="resident"):
        auto_engine.AutoEngine.from_config(**base, offload=True)
    assert auto_engine.AutoEngine.from_config(**base, num_cache_layers=2).config == \
        {"num_cache_layers": 2}
    # quantize_draft is ported: initialize() W4-quantizes the fp draft and its head
    eng = auto_engine.AutoEngine.from_config(**base, batch_size=2, quantize_draft=True)
    eng.initialize()
    from umbrella_tpu_torch.quantization.awq import AwqTensor

    assert isinstance(eng.draft_model.params["lm_head"], AwqTensor)
    assert eng.target_model is target


# ------------------------------------------------------------------ W4A8 in the batched forward


def test_batched_forward_w4a8_reaches_only_qkv(monkeypatch):
    """The JAX package's batched forward passes awq_act="int8" only to the QKV
    projection (models/batched.py: _attn_projections gets args, wo / the MLP /
    down call _linear and _mlp_act without act_int8). The port mirrors it: with
    every AWQ product routed to a kernel, only the wqkv products are W4A8 in
    the batched forward, while the single-slot forward runs all four W4A8."""
    from umbrella_tpu_torch.models import llama
    from umbrella_tpu_torch.quantization import awq

    cfg = ModelConfig(**dict(SMALL, awq_act="int8", num_hidden_layers=2))
    rt = auto_model.random_awq_runtime(cfg, MAX_LEN, dtype=torch.float32, seed=6, group_size=64,
                                       device=CPU)
    seen = []
    matmul = awq.awq_matmul

    def record(x, q, b=None, act_int8=False, **kw):
        seen.append((q.n, act_int8))
        return matmul(x, q, b, act_int8=act_int8, prefer_fused=True, **kw)

    monkeypatch.setattr(llama, "awq_matmul", record)
    monkeypatch.setattr(awq, "awq_matmul", record)  # the one awq_gate_up_silu calls
    B, S = 2, 3
    kv = batched.init_batched_kv(cfg, B, MAX_LEN, torch.float32, device=CPU)
    mask = masks.causal_mask_rows_batched(torch.tensor([0, 4]), S, MAX_LEN)
    batched.batched_llama_forward(rt.params, rt.args, kv, torch.arange(6).reshape(B, S) + 1,
                                  torch.tensor([[0, 1, 2], [4, 5, 6]]), mask,
                                  torch.tensor([0, 4], dtype=torch.int32))
    qkv_n = rt.params["layers"]["wqkv"][0].n
    assert seen and all(a8 == (n == qkv_n) for n, a8 in seen), seen
    assert sum(a8 for _, a8 in seen) == cfg.num_hidden_layers
    seen.clear()
    rt.forward(rt.params, rt.init_kv(), torch.tensor([1, 2, 3]), torch.arange(3),
               masks.causal_mask_rows(0, 3, MAX_LEN), 0)
    assert sum(a8 for _, a8 in seen) == 4 * cfg.num_hidden_layers  # wqkv, wo, gate_up, down
