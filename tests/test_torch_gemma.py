"""The port's Gemma2 family (models/gemma.py, the Gemma2 forms of
models/batched.py, loading and the three engines) against the JAX package and
HF transformers on the CPU.

A tiny random HF Gemma2 (4 layers, hidden 64, head dim 16) with
query_pre_attn_scalar 24 != head_dim, so a head_dim ** -0.5 scale would fail,
a sliding window of 16 that every test passes (S or positions > 16), and both
soft caps. The tail layers' post norms are damped to 0.05 (the Gemma form of
the early-exit composition: its post norms would undo a damped wo or down),
so the early-exit draft of the first EXIT layers is often right.

Tolerances: fp32 logits within 1e-4 x max|logit| of the JAX package's, and
within 3e-3 abs of HF's (tests/test_gemma.py's tolerance for the JAX
forward); an int8 KV cache within one quantization step per value; greedy
tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.models import batched as jax_batched
from umbrella_tpu.models import gemma as jax_gemma
from umbrella_tpu.models import kv_cache as jax_kv
from umbrella_tpu.ops import masks as jax_masks
from umbrella_tpu.ops import norms as jax_norms
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.serving.batched_engine import BatchedStaticEngine as JaxBatchedEngine
from umbrella_tpu.speculation.dynamic_engine import DynamicEngine as JaxDynamicEngine
from umbrella_tpu.speculation.static_engine import StaticEngine as JaxStaticEngine
from umbrella_tpu_torch.models import auto_model, batched, gemma
from umbrella_tpu_torch.models import kv_cache as port_kv
from umbrella_tpu_torch.models.convert import config_from, runtime_from_numpy
from umbrella_tpu_torch.ops import masks, norms
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

MAX_LEN = 128
CPU = "cpu"
EXIT = 2
TREE = (3, 4)
DYN_TREE = dict(width=4, num_beams=6, depth=4)
WINDOW = 16
HF_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              max_position_embeddings=512, rms_norm_eps=1e-6, rope_theta=10000.0,
              attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
              query_pre_attn_scalar=24, sliding_window=WINDOW, tie_word_embeddings=True,
              attn_implementation="eager")
PROMPT = [int(t) for t in np.random.default_rng(4).integers(0, 128, 20)]  # 20 > WINDOW


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jx(a):
    return jnp.asarray(np.asarray(a))


def _close_to(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max(), rtol=0)


@pytest.fixture(scope="module")
def hf_model():
    from transformers import Gemma2Config, Gemma2ForCausalLM

    torch.manual_seed(0)
    model = Gemma2ForCausalLM(Gemma2Config(**HF_CFG)).eval()
    with torch.no_grad():
        for layer in model.model.layers[EXIT:]:
            layer.post_attention_layernorm.weight.fill_(-0.95)
            layer.post_feedforward_layernorm.weight.fill_(-0.95)
    return model


@pytest.fixture(scope="module")
def hf_dir(hf_model, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gemma") / "gemma2")
    hf_model.save_pretrained(d, safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def runtimes(hf_model):
    """(JAX target, JAX early-exit draft), (port target, port draft) over the
    same fp32 weights."""
    sd = {k: v.detach().float().numpy() for k, v in hf_model.state_dict().items()}
    cfg = JaxConfig.from_dict(hf_model.config.to_dict())
    params = jax_gemma.gemma_params_from_hf_state_dict(sd, cfg, MAX_LEN, dtype=jnp.float32)
    jt = jax_auto.ModelRuntime(cfg, params, MAX_LEN, dtype=jnp.float32, family="gemma2")
    pt = runtime_from_numpy(_np(params), cfg, MAX_LEN, family="gemma2")
    return ((jt, jax_auto.early_exit_runtime(jt, EXIT)),
            (pt, auto_model.early_exit_runtime(pt, EXIT)))


# ------------------------------------------------------------------ ops and forwards


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemma_rms_norm_matches_jax_and_is_row_invariant(dtype):
    """Within 1 ulp of the JAX norm (fp32 within 1e-6 relative); a row's result
    is the same bits alone and among 7 rows (the fp64 sum of ops/norms.py)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((7, 64)) * 3).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    got = norms.gemma_rms_norm(_t(x).to(dtype), _t(w).to(dtype), 1e-6)
    want = jax_norms.gemma_rms_norm(_jx(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                   else jnp.float32),
                                    _jx(w).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                  else jnp.float32), 1e-6)
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol,
                               atol=1e-6)
    alone = norms.gemma_rms_norm(_t(x[3:4]).to(dtype), _t(w).to(dtype), 1e-6)
    assert torch.equal(alone[0], got[3])


def test_embedding_scale_rounds_to_the_hidden_dtype():
    """sqrt(hidden_size) is rounded to the hidden dtype before the multiply,
    as the JAX package and HF do: at Gemma-2-9B's width sqrt(3584) = 59.866
    becomes 59.75 in bf16 and stays 59.866 in fp32."""
    args = gemma.GemmaStaticArgs(16, 8, 256, 3584, 1e-6, 1, 1.0, 0.0, 0.0, 0)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        params = {"embed": torch.ones((4, 8), dtype=dtype),
                  "final_norm": torch.ones(8, dtype=dtype)}
        out = gemma.embed_scaled(params, args, torch.tensor([1, 3]))
        want = jnp.ones((2, 8), jdt) * jnp.asarray(3584 ** 0.5, jdt)
        assert out.dtype == dtype
        assert np.array_equal(out.float().numpy(), np.asarray(want, np.float32))
    assert float(out[0, 0]) != 59.75 and float(jnp.asarray(3584 ** 0.5, jnp.bfloat16)) == 59.75


def test_gemma2_forward_matches_jax_and_hf(runtimes, hf_model):
    """A 24-token prefill (past the window) and a 5-token continuation at slot
    24: logits within 1e-4 x max|logit| of gemma2_forward, the prefill within
    3e-3 of HF Gemma2ForCausalLM; the attention scale is
    query_pre_attn_scalar ** -0.5 and the KV caches agree."""
    (jt, _), (pt, _) = runtimes
    assert pt.gemma_args.attn_scale == pytest.approx(24 ** -0.5)
    assert pt.gemma_args == gemma.GemmaStaticArgs(*jt.gemma_args[:10])
    ids = np.random.default_rng(0).integers(0, 128, 29).astype(np.int32)
    jkv, pkv = jt.init_kv(), pt.init_kv()
    for start, n in ((0, 24), (24, 5)):
        chunk, pos = ids[start:start + n], np.arange(start, start + n)
        mask = np.asarray(jax_masks.causal_mask_rows(start, n, MAX_LEN))
        jl, jkv = jt.forward(jt.params, jkv, _jx(chunk), _jx(pos), _jx(mask), start)
        pl, pkv = pt.forward(pt.params, pkv, _t(chunk), _t(pos), _t(mask), start)
        _close_to(pl.numpy(), jl)
        if start == 0:
            with torch.no_grad():
                ref = hf_model(torch.tensor(chunk, dtype=torch.long)[None]).logits[0].numpy()
            np.testing.assert_allclose(pl.numpy(), ref, atol=3e-3, rtol=3e-3)
    np.testing.assert_allclose(pkv.k.numpy(), np.asarray(jkv.k), atol=1e-5)


def test_sliding_window_masks_even_layers_only():
    """In slot space a row at position p reads slots c > p - window; layer 0
    slides, layer 1 does not."""
    mask = masks.causal_mask_rows(0, 40, 64)
    pos = torch.arange(40)
    slid = gemma.sliding_mask(mask, pos, WINDOW)
    want = np.asarray(jax_masks.causal_mask_rows(0, 40, 64)) & (
        np.arange(64)[None, :] > np.arange(40)[:, None] - WINDOW)
    assert np.array_equal(slid.numpy(), want)
    assert gemma.is_sliding(0) and not gemma.is_sliding(1)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("form", ["batched", "slot"])
def test_batched_gemma_forwards_match_jax(runtimes, kv_dtype, form):
    """batched_gemma2_forward and slot_gemma2_forward (jitted, as the JAX
    engine runs them) on 20 rows a slot (past the window): logits within 1e-4
    x max|logit|; the fp32 cache within 1e-5, the int8 one within one step."""
    (jt, _), (pt, _) = runtimes
    cfg = jt.cfg
    jdt = "int8" if kv_dtype == "int8" else jnp.float32
    pdt = "int8" if kv_dtype == "int8" else torch.float32
    rng = np.random.default_rng(3)
    B, S = 3, 20
    ids = rng.integers(0, 128, (B, S)).astype(np.int32)
    offsets = np.array([0, 9, 4], np.int32)
    pos = offsets[:, None] + np.arange(S)[None, :]
    mask = np.stack([np.asarray(jax_masks.causal_mask_rows(int(o), S, MAX_LEN)) for o in offsets])
    jkv = jax_batched.init_batched_kv(cfg, B, MAX_LEN, jdt)
    pkv = batched.init_batched_kv(config_from(cfg), B, MAX_LEN, pdt)
    gargs = jt.gemma_args
    if form == "batched":
        jl, jkv = jax.jit(lambda p, kv: jax_batched.batched_gemma2_forward(
            p, gargs, kv, _jx(ids), _jx(pos), _jx(mask), _jx(offsets)))(jt.params, jkv)
        fwd = batched.model_forwards(pt)[0]
        pl, pkv = fwd(pt.params, pkv, _t(ids), _t(pos), _t(mask), _t(offsets))
    else:
        jl, jkv = jax.jit(lambda p, kv: jax_batched.slot_gemma2_forward(
            p, gargs, kv, _jx(ids[0]), _jx(pos[1]), _jx(mask[1]), jnp.int32(2),
            jnp.int32(9)))(jt.params, jkv)
        fwd = batched.model_forwards(pt)[1]
        pl, pkv = fwd(pt.params, pkv, _t(ids[0]), _t(pos[1]), _t(mask[1]), 2, 9)
        assert not pkv.k[:, :2].any()
    _close_to(pl.numpy(), jl)
    if kv_dtype == "int8":
        assert np.abs(pkv.k.numpy().astype(np.int32) - np.asarray(jkv.k, np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(pkv.k.numpy(), np.asarray(jkv.k), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_pretrained_loads_gemma_as_jax_does(hf_dir, dtype):
    """AutoModelLM.from_pretrained on an HF-saved directory: family gemma2 and
    every param equal to the JAX package's loader's, bit for bit."""
    jrt = jax_auto.AutoModelLM.from_pretrained(hf_dir, max_length=MAX_LEN,
                                               dtype=getattr(jnp, dtype))
    prt = auto_model.AutoModelLM.from_pretrained(hf_dir, max_length=MAX_LEN,
                                                 dtype=getattr(torch, dtype), device=CPU)
    assert prt.family == jrt.family == "gemma2"
    jp = _np(jrt.params)
    assert set(prt.params) == set(jp) and set(prt.params["layers"]) == set(jp["layers"])
    for k, v in prt.params["layers"].items():
        assert np.array_equal(v.float().numpy(), np.asarray(jp["layers"][k], np.float32)), k
    for k in ("embed", "final_norm", "rope_inv_freq"):
        assert np.array_equal(prt.params[k].float().numpy(), np.asarray(jp[k], np.float32)), k


# ------------------------------------------------------------------ engines


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


@pytest.fixture(scope="module")
def ar_tokens(runtimes):
    return _port_ar_decode(runtimes[1][0], PROMPT, 40)


def _port_engine(models, engine, **kw):
    target, draft = models
    tree = dict(DYN_TREE) if engine == "dynamic" else dict(growmap=growmap_from_spec(*TREE))
    eng = AutoEngine.from_config(device=CPU, engine=engine, model=target, draft_model=draft,
                                 dtype=torch.float32, max_length=MAX_LEN, safe_buffer=32,
                                 eos_token_ids=[-1], draft_topk_recall=1.0, **tree, **kw)
    eng.initialize()
    return eng


def _jax_engine(models, engine, **kw):
    target, draft = models
    common = dict(draft_model_name=draft, target_model_name=target, dtype=jnp.float32,
                  max_length=MAX_LEN, safe_buffer=32, eos_token_ids=[-1],
                  draft_topk_recall=1.0, **kw)
    if engine == "dynamic":
        eng = JaxDynamicEngine(**common, **DYN_TREE)
    elif engine == "static":
        eng = JaxStaticEngine(**common, growmap=jax_growmap_from_spec(*TREE))
    else:
        eng = JaxBatchedEngine(**common, growmap=jax_growmap_from_spec(*TREE))
    eng.initialize()
    return eng


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("engine", ["static", "dynamic"])
def test_single_slot_engines_token_identical_with_jax(runtimes, ar_tokens, engine, kv_dtype):
    """generate() of 40 tokens after a 20-token prompt (past the window): the
    port's tokens and accept rate equal the JAX engine's on the same weights;
    with an fp32 cache they also equal the port's AR decode, and the
    early-exit draft is accepted."""
    jax_models, port_models = runtimes
    want = _jax_engine(jax_models, engine, kv_dtype=kv_dtype).generate(
        input_ids=PROMPT, max_new_tokens=40)
    got = _port_engine(port_models, engine, kv_dtype=kv_dtype).generate(
        input_ids=PROMPT, max_new_tokens=40)
    assert got["generated_tokens"] == want["generated_tokens"]
    assert got["avg_accept_tokens"] == pytest.approx(want["avg_accept_tokens"])
    if kv_dtype is None:
        assert got["generated_tokens"][:40] == ar_tokens
        assert got["avg_accept_tokens"] > 1.5


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_batched_engine_token_identical_with_jax(runtimes, ar_tokens, kv_dtype):
    """BatchedStaticEngine.run() over 5 requests on 3 slots, prompts past the
    window: every request's tokens and accept rate equal the JAX batched
    engine's; the first request's equal the AR decode (fp32 cache)."""
    rng = np.random.default_rng(8)
    reqs = [dict(input_ids=PROMPT, max_new_tokens=40)] + [
        dict(input_ids=rng.integers(0, 128, int(rng.integers(3, 24))).tolist(),
             max_new_tokens=int(rng.integers(8, 30))) for _ in range(4)]
    jax_models, port_models = runtimes
    want = _jax_engine(jax_models, "batched", batch_size=3, segment_steps=3,
                       kv_dtype=kv_dtype).run([dict(r) for r in reqs])
    got = _port_engine(port_models, "batched_static", batch_size=3, segment_steps=3,
                       kv_dtype=kv_dtype).run([dict(r) for r in reqs])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["generated_tokens"] == w["generated_tokens"], i
        assert g["avg_accept_tokens"] == pytest.approx(w["avg_accept_tokens"]), i
    if kv_dtype is None:
        assert got[0]["generated_tokens"][:40] == ar_tokens


# ------------------------------------------------------------------ refusals


def test_quantize_draft_refused_for_a_gemma2_draft(runtimes):
    """The static, dynamic and batched engines refuse quantize_draft for a
    gemma2 draft up front. The JAX package cannot run one either:
    `quantization.loader.quantize_runtime` stores the layers as tuples of
    per-layer AwqTensors, and the first forward of the quantized Gemma2
    runtime fails in `gemma2_forward`'s `lax.scan` over them
    (umbrella_tpu/models/gemma.py:113, "scan got values with different
    leading axis sizes"); its head (:116-120) has no W4 branch either."""
    target, draft = runtimes[1]
    for engine, extra in (("static", dict(growmap=growmap_from_spec(*TREE))),
                          ("dynamic", DYN_TREE),
                          ("batched_static", dict(growmap=growmap_from_spec(*TREE)))):
        for mode in (True, "int4f"):
            eng = AutoEngine.from_config(device=CPU, engine=engine, model=target,
                                         draft_model=draft, dtype=torch.float32,
                                         max_length=MAX_LEN, quantize_draft=mode, **extra)
            with pytest.raises(ValueError, match="quantize_draft is not supported for gemma2"):
                eng.initialize()


def test_offload_pipeline_and_expert_parallel_refused(runtimes, hf_dir):
    """Gemma2 has no offload variant and no pipeline-staged forward (the JAX
    package asserts against both: offload/streaming.py:120,
    parallel/pipeline.py:183), and expert parallelism takes MoE models only
    (serving/batched_engine.py:150 there)."""
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
    from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp

    target, draft = runtimes[1]
    with pytest.raises(ValueError, match="gemma2 has no offload loader"):
        auto_model.AutoModelLM.from_pretrained(hf_dir, offload=True, num_cache_layers=1,
                                               max_length=MAX_LEN, device=CPU)
    with pytest.raises(NotImplementedError, match="offload tier"):
        OffloadModelRuntime(target.cfg, {}, [], MAX_LEN, family="gemma2", device=CPU)
    with pytest.raises(NotImplementedError, match="pipeline staging"):
        shard_runtime_pp(auto_model.early_exit_runtime(target, 4), [CPU, CPU])
    eng = AutoEngine.from_config(device=CPU, engine="static", model=target, draft_model=draft,
                                 dtype=torch.float32, max_length=MAX_LEN, pipeline_parallel=2,
                                 growmap=growmap_from_spec(*TREE))
    with pytest.raises(NotImplementedError, match="pipeline staging"):
        eng.initialize()
    for engine in ("static", "batched_static"):
        eng = AutoEngine.from_config(device=CPU, engine=engine, model=target, draft_model=draft,
                                     expert_parallel=2, growmap=growmap_from_spec(*TREE))
        with pytest.raises(ValueError, match="expert_parallel requires an MoE"):
            eng.initialize()


def test_int8_cache_rows_of_a_gemma_prefill_match_jax(runtimes):
    """update_layer quantizes Gemma's head-dim rows as the JAX cache does
    (scales bit for bit under jit)."""
    (jt, _), (pt, _) = runtimes
    ids = np.arange(18, dtype=np.int32)
    mask = np.asarray(jax_masks.causal_mask_rows(0, 18, MAX_LEN))
    jkv = jax_kv.init_kv_cache(jt.cfg, MAX_LEN, dtype="int8")
    _, jkv = jax.jit(lambda p, kv: jt.forward(p, kv, _jx(ids), jnp.arange(18), _jx(mask), 0))(
        jt.params, jkv)
    pkv = port_kv.init_kv_cache(pt.cfg, MAX_LEN, dtype="int8")
    _, pkv = pt.forward(pt.params, pkv, _t(ids), torch.arange(18), _t(mask), 0)
    assert np.abs(pkv.k.numpy().astype(np.int32) - np.asarray(jkv.k, np.int32)).max() <= 1
    np.testing.assert_allclose(pkv.k_scale.numpy(), np.asarray(jkv.k_scale), rtol=1e-5)
