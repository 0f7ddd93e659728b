"""The port's MoE family (models/moe.py, the MoE forms of models/batched.py,
loading and the three engines) against the JAX package and HF transformers on
the CPU.

Weights: the JAX package's `init_moe_llama_params` (2 layers of 4 experts,
top-2, hidden 64, head dim 16) carried across with params_from_numpy; for
the early-exit composition the tail layer's wo and expert_down are damped
x0.05, so the draft of the first EXIT layers is often right. Loading is
checked on a tiny HF Mixtral saved with save_pretrained.

Tolerances: fp32 logits within 1e-4 x max|logit| of the JAX package's
(moe_mlp's outputs within 1e-5 abs), and within 2e-3 abs of HF's
(tests/test_moe_config.py's tolerance for the JAX forward); an int8 KV cache
within one quantization step per value; greedy tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.models import batched as jax_batched
from umbrella_tpu.models import moe as jax_moe
from umbrella_tpu.ops import masks as jax_masks
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.serving.batched_engine import BatchedStaticEngine as JaxBatchedEngine
from umbrella_tpu.speculation.dynamic_engine import DynamicEngine as JaxDynamicEngine
from umbrella_tpu.speculation.static_engine import StaticEngine as JaxStaticEngine
from umbrella_tpu_torch.models import auto_model, batched, llama, moe
from umbrella_tpu_torch.models.convert import config_from, params_from_numpy, runtime_from_numpy
from umbrella_tpu_torch.ops import masks
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

MAX_LEN = 128
CPU = "cpu"
EXIT = 1
E = 4
TREE = (3, 4)
DYN_TREE = dict(width=4, num_beams=6, depth=4)
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=MAX_LEN,
             rope_theta=10000.0, tie_word_embeddings=False, eos_token_id=-1,
             model_type="mixtral", num_local_experts=E, num_experts_per_tok=2)
PROMPT = [1, 17, 42, 9, 55, 3, 77]


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
def runtimes():
    """(JAX target, JAX early-exit draft), (port target, port draft) over the
    same fp32 weights."""
    cfg = JaxConfig(**SMALL)
    params = jax_moe.init_moe_llama_params(cfg, jax.random.PRNGKey(0), E, jnp.float32)
    layers = dict(params["layers"])
    for k in ("wo", "expert_down"):
        layers[k] = layers[k].at[EXIT:].multiply(0.05)
    params = dict(params, layers=layers)
    jt = jax_moe.moe_runtime(cfg, params, MAX_LEN, dtype=jnp.float32)
    pt = runtime_from_numpy(_np(params), cfg, MAX_LEN, family="moe")
    return ((jt, jax_auto.early_exit_runtime(jt, EXIT)),
            (pt, auto_model.early_exit_runtime(pt, EXIT)))


# ------------------------------------------------------------------ routing and forwards


def _layer0(params, to):
    return {k: to(v[0]) for k, v in params["layers"].items()}


def test_moe_mlp_matches_jax(runtimes):
    """moe_mlp on [2, 5, H]: outputs within 1e-5, the aux loss within 1e-6."""
    (jt, _), (pt, _) = runtimes
    x = np.random.default_rng(1).standard_normal((2, 5, 64)).astype(np.float32)
    jo, ja = jax.jit(lambda lw, x: jax_moe.moe_mlp(lw, x, top_k=2))(
        _layer0(jt.params, lambda v: v), _jx(x))
    po, pa = moe.moe_mlp(_layer0(pt.params, lambda v: v), _t(x), top_k=2)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)
    assert float(pa) == pytest.approx(float(ja), abs=1e-6)


def test_router_ties_go_to_the_lower_expert_index():
    """Experts 1 and 3 have the same router column, so they tie for second
    place on every token: lax.top_k and the port both take expert 1 (expert 3
    gets no weight), and the outputs agree."""
    rng = np.random.default_rng(2)
    H, I = 16, 24
    v = rng.standard_normal(H).astype(np.float32)
    router = np.stack([v, 0.5 * v, -v, 0.5 * v], axis=1)
    lw = {"router": router,
          "expert_gate": rng.standard_normal((E, H, I)).astype(np.float32) * 0.2,
          "expert_up": rng.standard_normal((E, H, I)).astype(np.float32) * 0.2,
          "expert_down": rng.standard_normal((E, I, H)).astype(np.float32) * 0.2}
    x = rng.standard_normal((1, 9, H)).astype(np.float32)
    plw = {k: _t(a) for k, a in lw.items()}
    probs, _, weights = moe.route(plw, _t(x), 2)
    assert torch.equal(probs[..., 1], probs[..., 3])
    assert (weights[..., 1] > 0).all() and not weights[..., 3].any()
    jo, _ = jax_moe.moe_mlp({k: _jx(a) for k, a in lw.items()}, _jx(x), top_k=2)
    po, _ = moe.moe_mlp(plw, _t(x), top_k=2)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)
    vals, idx = moe.top_k_lowest_index(torch.tensor([[0.2, 0.3, 0.3, 0.3]]), 2)
    assert idx.tolist() == [[1, 2]]


def test_moe_decode_forward_matches_jax(runtimes):
    """A 9-token prefill and a 4-token continuation: logits within 1e-4 x
    max|logit| of moe_decode_forward, caches within 1e-5."""
    (jt, _), (pt, _) = runtimes
    ids = np.random.default_rng(0).integers(0, 128, 13).astype(np.int32)
    jkv, pkv = jt.init_kv(), pt.init_kv()
    for start, n in ((0, 9), (9, 4)):
        chunk, pos = ids[start:start + n], np.arange(start, start + n)
        mask = np.asarray(jax_masks.causal_mask_rows(start, n, MAX_LEN))
        jl, jkv = jt.forward(jt.params, jkv, _jx(chunk), _jx(pos), _jx(mask), start)
        pl, pkv = pt.forward(pt.params, pkv, _t(chunk), _t(pos), _t(mask), start)
        _close_to(pl.numpy(), jl)
    np.testing.assert_allclose(pkv.k.numpy(), np.asarray(jkv.k), atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("form", ["batched", "slot"])
def test_batched_moe_forwards_match_jax(runtimes, kv_dtype, form):
    """batched_moe_forward and slot_moe_forward (jitted, as the JAX engine runs
    them): logits within 1e-4 x max|logit|; the fp32 cache within 1e-5, the
    int8 one within one step."""
    (jt, _), (pt, _) = runtimes
    cfg, args = jt.cfg, jt.args
    jdt = "int8" if kv_dtype == "int8" else jnp.float32
    pdt = "int8" if kv_dtype == "int8" else torch.float32
    rng = np.random.default_rng(3)
    B, S = 3, 6
    ids = rng.integers(0, 128, (B, S)).astype(np.int32)
    offsets = np.array([0, 7, 3], np.int32)
    pos = offsets[:, None] + np.arange(S)[None, :]
    mask = np.stack([np.asarray(jax_masks.causal_mask_rows(int(o), S, MAX_LEN)) for o in offsets])
    jkv = jax_batched.init_batched_kv(cfg, B, MAX_LEN, jdt)
    pkv = batched.init_batched_kv(config_from(cfg), B, MAX_LEN, pdt)
    if form == "batched":
        jl, jkv = jax.jit(lambda p, kv: jax_batched.batched_moe_forward(
            p, args, kv, _jx(ids), _jx(pos), _jx(mask), _jx(offsets)))(jt.params, jkv)
        pl, pkv = batched.batched_moe_forward(pt.params, pt.args, pkv, _t(ids), _t(pos),
                                              _t(mask), _t(offsets))
    else:
        jl, jkv = jax.jit(lambda p, kv: jax_batched.slot_moe_forward(
            p, args, kv, _jx(ids[0]), _jx(pos[1]), _jx(mask[1]), jnp.int32(2),
            jnp.int32(7)))(jt.params, jkv)
        pl, pkv = batched.model_forwards(pt)[1](pt.params, pkv, _t(ids[0]), _t(pos[1]),
                                                _t(mask[1]), 2, 7)
        assert not pkv.k[:, :2].any()
    _close_to(pl.numpy(), jl)
    if kv_dtype == "int8":
        assert np.abs(pkv.k.numpy().astype(np.int32) - np.asarray(jkv.k, np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(pkv.k.numpy(), np.asarray(jkv.k), atol=1e-5)


@pytest.fixture(scope="module")
def hf_mixtral(tmp_path_factory):
    """A tiny HF Mixtral (tests/test_moe_config.py's) and its saved directory."""
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(0)
    model = MixtralForCausalLM(MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=E,
        num_experts_per_tok=2, max_position_embeddings=512, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False, sliding_window=None,
        eos_token_id=-1)).eval()
    d = str(tmp_path_factory.mktemp("moe") / "mixtral")
    model.save_pretrained(d, safe_serialization=True)
    return model, d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_pretrained_loads_mixtral_as_jax_does(hf_mixtral, dtype):
    """AutoModelLM.from_pretrained on an HF-saved Mixtral directory: family moe
    and every param equal to the JAX package's load_moe_params', bit for bit."""
    _, d = hf_mixtral
    jrt = jax_auto.AutoModelLM.from_pretrained(d, max_length=MAX_LEN, dtype=getattr(jnp, dtype))
    prt = auto_model.AutoModelLM.from_pretrained(d, max_length=MAX_LEN,
                                                 dtype=getattr(torch, dtype), device=CPU)
    assert prt.family == jrt.family == "moe"
    jp = _np(jrt.params)
    assert set(prt.params) == set(jp) and set(prt.params["layers"]) == set(jp["layers"])
    assert prt.params["layers"]["expert_gate"].shape == (2, E, 64, 128)
    for k, v in prt.params["layers"].items():
        assert np.array_equal(v.float().numpy(), np.asarray(jp["layers"][k], np.float32)), k
    for k in ("embed", "lm_head", "final_norm", "rope_inv_freq"):
        assert np.array_equal(prt.params[k].float().numpy(), np.asarray(jp[k], np.float32)), k


def test_loaded_mixtral_matches_hf_and_jax(hf_mixtral):
    """The loaded directory's prefill logits: within 2e-3 of HF
    MixtralForCausalLM and 1e-4 x max|logit| of the JAX runtime's."""
    model, d = hf_mixtral
    prt = auto_model.AutoModelLM.from_pretrained(d, max_length=MAX_LEN, dtype=torch.float32,
                                                 device=CPU)
    jrt = jax_auto.AutoModelLM.from_pretrained(d, max_length=MAX_LEN, dtype=jnp.float32)
    ids = np.random.default_rng(1).integers(0, 128, 9).astype(np.int32)
    mask = np.asarray(jax_masks.causal_mask_rows(0, 9, MAX_LEN))
    pl, _ = prt.forward(prt.params, prt.init_kv(), _t(ids), torch.arange(9), _t(mask), 0)
    jl, _ = jrt.forward(jrt.params, jrt.init_kv(), _jx(ids), jnp.arange(9), _jx(mask), 0)
    with torch.no_grad():
        ref = model(torch.tensor(ids, dtype=torch.long)[None]).logits[0].numpy()
    np.testing.assert_allclose(pl.numpy(), ref, atol=2e-3, rtol=2e-3)
    _close_to(pl.numpy(), jl)


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
def test_single_slot_engines_token_identical_with_jax(runtimes, engine, kv_dtype):
    """generate() of 40 tokens: the port's tokens and accept rate equal the JAX
    engine's on the same weights; with an fp32 cache they also equal the
    port's AR decode, and the early-exit draft is accepted."""
    jax_models, port_models = runtimes
    want = _jax_engine(jax_models, engine, kv_dtype=kv_dtype).generate(
        input_ids=PROMPT, max_new_tokens=40)
    got = _port_engine(port_models, engine, kv_dtype=kv_dtype).generate(
        input_ids=PROMPT, max_new_tokens=40)
    assert got["generated_tokens"] == want["generated_tokens"]
    assert got["avg_accept_tokens"] == pytest.approx(want["avg_accept_tokens"])
    if kv_dtype is None:
        assert got["generated_tokens"][:40] == _port_ar_decode(port_models[0], PROMPT, 40)
        assert got["avg_accept_tokens"] > 1.5


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_batched_engine_token_identical_with_jax(runtimes, kv_dtype):
    """BatchedStaticEngine.run() over 5 requests on 3 slots: every request's
    tokens and accept rate equal the JAX batched engine's."""
    rng = np.random.default_rng(8)
    reqs = [dict(input_ids=rng.integers(0, 128, int(rng.integers(3, 24))).tolist(),
                 max_new_tokens=int(rng.integers(8, 30))) for _ in range(5)]
    jax_models, port_models = runtimes
    want = _jax_engine(jax_models, "batched", batch_size=3, segment_steps=3,
                       kv_dtype=kv_dtype).run([dict(r) for r in reqs])
    got = _port_engine(port_models, "batched_static", batch_size=3, segment_steps=3,
                       kv_dtype=kv_dtype).run([dict(r) for r in reqs])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["generated_tokens"] == w["generated_tokens"], i
        assert g["avg_accept_tokens"] == pytest.approx(w["avg_accept_tokens"]), i


@pytest.fixture(scope="module")
def wide_vocab_drafts():
    """A dense llama draft whose vocabulary (160) is wider than the MoE
    target's (128), as Mistral-7B-v0.3's (32768) is wider than
    Mixtral-8x7B's (32000); its logits favour the ids past the target's."""
    cfg = JaxConfig(**dict(SMALL, vocab_size=160, model_type="mistral", num_local_experts=None))
    jd = jax_auto.random_runtime(cfg, MAX_LEN, dtype=jnp.float32, seed=5)
    params = dict(jd.params, lm_head=jd.params["lm_head"].at[:, 128:].multiply(20.0))
    jd = jax_auto.ModelRuntime(cfg, params, MAX_LEN, dtype=jnp.float32)
    return jd, runtime_from_numpy(_np(params), cfg, MAX_LEN)


@pytest.mark.parametrize("engine", ["static", "dynamic", "batched"])
def test_draft_ids_past_the_target_vocabulary(runtimes, wide_vocab_drafts, engine,
                                              monkeypatch):
    """Draft tokens >= the target's vocabulary reach the target's tree.
    The JAX package's lookup off the TPU clamps them to the last row
    (lax.dynamic_slice, umbrella_tpu/ops/select.py:64-69) and never accepts
    them; the port's engines clamp them as it does before the target's
    embedding (engine_common.clamp_draft_ids): tokens and accept rate equal
    the JAX engine's, no output token is >= 128, the draft proposed such ids
    and the target's embedding was never given one."""
    from umbrella_tpu_torch.ops import select

    seen = {128: [], 160: []}

    def lookup(embed, input_ids, dtype=None):
        seen[embed.shape[0]].append(int(input_ids.max()))
        return select.embed_lookup(embed, input_ids, dtype)

    for mod in (moe, batched, llama):
        monkeypatch.setattr(mod, "embed_lookup", lookup)
    (jt, _), (pt, _) = runtimes
    jd, pd = wide_vocab_drafts
    kw = dict(batch_size=2, segment_steps=3) if engine == "batched" else {}
    port = _port_engine((pt, pd), "batched_static" if engine == "batched" else engine, **kw)
    want = _jax_engine((jt, jd), engine, **kw)
    if engine == "batched":
        reqs = [dict(input_ids=PROMPT, max_new_tokens=24),
                dict(input_ids=PROMPT[:4], max_new_tokens=16)]
        pairs = list(zip(port.run([dict(r) for r in reqs]), want.run([dict(r) for r in reqs])))
    else:
        pairs = [(port.generate(input_ids=PROMPT, max_new_tokens=24),
                  want.generate(input_ids=PROMPT, max_new_tokens=24))]
    for g, w in pairs:
        assert g["generated_tokens"] == w["generated_tokens"]
        assert g["avg_accept_tokens"] == pytest.approx(w["avg_accept_tokens"])
        assert max(g["generated_tokens"]) < 128
    assert max(seen[160]) >= 128
    assert max(seen[128]) < 128


def test_embed_lookup_is_strict():
    """The embedding takes no id past its table: the engines clamp a wider
    draft's ids themselves (test_draft_ids_past_the_target_vocabulary)."""
    from umbrella_tpu_torch.ops.select import embed_lookup

    table = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(embed_lookup(table, torch.tensor([3, 0])), table[[3, 0]])
    with pytest.raises(IndexError):
        embed_lookup(table, torch.tensor([4]))


# ------------------------------------------------------------------ refusals


def test_refusals(runtimes, hf_mixtral):
    """quantize_draft for an MoE draft (as the JAX package refuses it,
    speculation/engine_common.py:129-130), offload (the JAX offload loaders
    take llama keys only), pipeline staging and an expert_parallel that does
    not divide the experts are refused."""
    from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp

    target, draft = runtimes[1]
    for engine, extra in (("static", dict(growmap=growmap_from_spec(*TREE))),
                          ("dynamic", DYN_TREE),
                          ("batched_static", dict(growmap=growmap_from_spec(*TREE)))):
        eng = AutoEngine.from_config(device=CPU, engine=engine, model=target, draft_model=draft,
                                     dtype=torch.float32, max_length=MAX_LEN,
                                     quantize_draft=True, **extra)
        with pytest.raises(ValueError, match="quantize_draft is not supported for moe"):
            eng.initialize()
        eng = AutoEngine.from_config(device=CPU, engine=engine, model=target, draft_model=draft,
                                     expert_parallel=3, **extra)
        with pytest.raises(ValueError, match="num_local_experts=4 must be divisible"):
            eng.initialize()
    with pytest.raises(ValueError, match="moe has no offload loader"):
        auto_model.AutoModelLM.from_pretrained(hf_mixtral[1], offload=True, num_cache_layers=1,
                                               max_length=MAX_LEN, device=CPU)
    with pytest.raises(NotImplementedError, match="pipeline staging"):
        shard_runtime_pp(target, [CPU, CPU])


def test_init_moe_llama_params_shapes_and_scale():
    """The port's init builds the JAX package's tree (the same keys, shapes
    and dtype) with Glorot-normal weights on the device it is given."""
    cfg = JaxConfig(**SMALL)
    jp = _np(jax_moe.init_moe_llama_params(cfg, jax.random.PRNGKey(0), E, jnp.float32))
    pp = moe.init_moe_llama_params(config_from(cfg), torch.Generator().manual_seed(0), E,
                                   torch.float32)
    ref = params_from_numpy(jp)
    assert set(pp) == set(ref) and set(pp["layers"]) == set(ref["layers"])
    for k, v in pp["layers"].items():
        assert v.shape == ref["layers"][k].shape and v.dtype == torch.float32, k
    w = pp["layers"]["expert_gate"]
    assert float(w.std()) == pytest.approx((2.0 / (64 + 96)) ** 0.5, rel=0.05)
