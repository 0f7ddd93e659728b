"""The port's offload tier against the JAX package on the CPU.

`umbrella_tpu_torch.offload.streaming.OffloadModelRuntime` (the first
`num_cache_layers` layers resident, the rest copied from host memory into two
device buffers layer by layer) against the JAX package's
`OffloadModelRuntime` on the same weights, fp32: streamed logits equal the
port's resident forward exactly (same ops, same order) and JAX's within
1e-5 (fp32 summation order); the static and dynamic engines over an offload
target (stepwise verify, the pipelined loop, the streaming loop) commit the
JAX engines' tokens and the AR decode's exactly; the step split around the
streamed forward (the graphed loop's draft and tail segments) equals the
unsplit step bit for bit. The cases mirror tests/test_offload.py and
tests/test_mistral_and_awq_offload.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mistral_and_awq_offload import _synthetic_awq_sd
from test_static_engine import MAX_LEN, _cfg, _greedy_ar_decode
from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.offload.streaming import OffloadModelRuntime as JaxOffload
from umbrella_tpu.ops.masks import causal_mask_rows as jax_causal_mask_rows
from umbrella_tpu.quantization.loader import awq_params_from_hf_state_dict as jax_awq_params
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.speculation.dynamic_engine import DynamicEngine as JaxDynamicEngine
from umbrella_tpu.speculation.static_engine import StaticEngine as JaxStaticEngine
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.cuda_graphs import plan_segments
from umbrella_tpu_torch.models import auto_model
from umbrella_tpu_torch.models.convert import offload_runtime_from_numpy, params_from_numpy
from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
from umbrella_tpu_torch.ops.masks import causal_mask_rows
from umbrella_tpu_torch.quantization.loader import awq_params_from_hf_state_dict
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

torch.set_num_threads(1)  # several workers share the cores

CPU = "cpu"
PROMPT = [1, 17, 42, 9]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
        "eos_token_id", "tie_word_embeddings", "rope_theta")})


@pytest.fixture(scope="module")
def models():
    """tests/test_offload.py's resident target (seed 0) and draft (seed 1), JAX
    and port."""
    jt, jd = (jax_auto.random_runtime(_cfg(), MAX_LEN, seed=s) for s in (0, 1))
    cfg = _port_cfg(jt.cfg)
    pt, pd = (auto_model.ModelRuntime(cfg, params_from_numpy(_np(r.params)), MAX_LEN,
                                      dtype=torch.float32, device=CPU) for r in (jt, jd))
    return (jt, jd), (pt, pd)


def _inputs(S=7, seed=0, vocab=97):
    ids = np.random.default_rng(seed).integers(0, vocab, S).astype(np.int32)
    return ((jnp.asarray(ids), jnp.arange(S), jax_causal_mask_rows(0, S, MAX_LEN)),
            (torch.from_numpy(ids), torch.arange(S), causal_mask_rows(0, S, MAX_LEN)))


@pytest.mark.parametrize("num_cache_layers", [0, 1, 2])
def test_streamed_forward_matches_resident_and_jax(models, num_cache_layers):
    """Two streamed forwards in a row (the buffers reused, the second forward's
    first copies after the first's last reads) equal the resident forward
    exactly; JAX's streamed forward within 1e-5; the KV caches too."""
    (jt, _), (pt, _) = models
    joff = JaxOffload.from_params(jt.params, jt.cfg, MAX_LEN, dtype=jnp.float32,
                                  num_cache_layers=num_cache_layers)
    off = OffloadModelRuntime.from_params(pt.params, pt.cfg, MAX_LEN, dtype=torch.float32,
                                          num_cache_layers=num_cache_layers, device=CPU)
    assert (off.n_resident, off.n_streamed) == (num_cache_layers, 2 - num_cache_layers)
    jargs, pargs = _inputs()
    want, _ = pt.forward(pt.params, pt.init_kv(), *pargs, 0)
    jl, jkv = joff.streamed_forward(joff.init_kv(), *jargs, jnp.int32(0))
    kv = off.init_kv()
    for _ in range(2):
        got, kv = off.streamed_forward(kv, *pargs, torch.tensor(0, dtype=torch.int32))
        assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kv.k.numpy(), np.asarray(jkv.k), rtol=1e-5, atol=1e-5)


def test_jax_offload_runtime_carried_across(models):
    """A JAX OffloadModelRuntime (its `top` and numpy `host_layers`) through
    convert.offload_runtime_from_numpy: JAX's logits within 1e-5."""
    (jt, _), (pt, _) = models
    joff = JaxOffload.from_params(jt.params, jt.cfg, MAX_LEN, dtype=jnp.float32,
                                  num_cache_layers=1)
    off = offload_runtime_from_numpy(_np(joff.top), joff.host_layers, pt.cfg, MAX_LEN,
                                     num_cache_layers=1)
    jargs, pargs = _inputs(seed=4)
    jl, _ = joff.streamed_forward(joff.init_kv(), *jargs, jnp.int32(0))
    got, _ = off.streamed_forward(off.init_kv(), *pargs, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_streamed_forward_traced_matches_and_reports(models):
    """The traced forward returns the fast path's logits and per-layer
    accounting; on the CPU the copies are timed by the host clock and no
    host-to-device rate is given."""
    (_, _), (pt, _) = models
    off = OffloadModelRuntime.from_params(pt.params, pt.cfg, MAX_LEN, dtype=torch.float32,
                                          num_cache_layers=1, device=CPU)
    _, pargs = _inputs()
    ref, _ = off.streamed_forward(off.init_kv(), *pargs, 0)
    got, _, stats = off.streamed_forward_traced(off.init_kv(), *pargs, 0)
    assert torch.equal(got, ref)
    assert stats["n_layers"] == off.n_layers and stats["n_resident"] == 1
    assert stats["compute_ms"] > 0 and stats["stream_ms"] > 0
    assert stats["overlap"] in ("compute-bound", "DMA-bound")
    assert len(stats["per_layer_head"]) == min(4, off.n_layers)
    assert stats["timed_by"] == "host_clock" and stats["h2d_gbps"] is None
    assert [("copy_ms" in r) for r in stats["per_layer"]] == [False, True]


def test_awq_offload_matches_awq_resident():
    """AWQ layers streamed (the 70B configs' combination): the state dict
    through OffloadModelRuntime.from_state_dict equals the resident AWQ
    runtime exactly and JAX's streamed AWQ runtime within 1e-4
    (tests/test_mistral_and_awq_offload.py's tolerance)."""
    kw = dict(vocab_size=128, hidden_size=128, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=MAX_LEN,
              eos_token_id=2, tie_word_embeddings=False)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    sd = _synthetic_awq_sd(jcfg)
    resident = auto_model.ModelRuntime(
        cfg, awq_params_from_hf_state_dict(sd, cfg, MAX_LEN, dtype=torch.float32), MAX_LEN,
        dtype=torch.float32, device=CPU)
    off = OffloadModelRuntime.from_state_dict(sd, cfg, MAX_LEN, dtype=torch.float32,
                                              quantized=True, num_cache_layers=1, device=CPU)
    joff = JaxOffload.from_state_dict(sd, jcfg, MAX_LEN, dtype=jnp.float32, quantized=True,
                                      num_cache_layers=1)
    jres = jax_auto.ModelRuntime(jcfg, jax_awq_params(sd, jcfg, MAX_LEN, dtype=jnp.float32),
                                 MAX_LEN, dtype=jnp.float32)
    jargs, pargs = _inputs(seed=3, vocab=128)
    want, _ = resident.forward(resident.params, resident.init_kv(), *pargs, 0)
    got, _ = off.streamed_forward(off.init_kv(), *pargs, 0)
    assert torch.equal(got, want)
    jl, _ = joff.streamed_forward(joff.init_kv(), *jargs, jnp.int32(0))
    jr, _ = jres.forward(jres.params, jres.init_kv(), *jargs, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ engines over it

def _targets(models, num_cache_layers=0):
    (jt, jd), (pt, pd) = models
    joff = JaxOffload.from_params(jt.params, jt.cfg, MAX_LEN, dtype=jnp.float32,
                                  num_cache_layers=num_cache_layers)
    off = OffloadModelRuntime.from_params(pt.params, pt.cfg, MAX_LEN, dtype=torch.float32,
                                          num_cache_layers=num_cache_layers, device=CPU)
    return (joff, jd), (off, pd)


def _engines(models, engine, num_cache_layers=0, **kw):
    """A JAX and a port engine of one kind over the offload target."""
    (joff, jd), (off, pd) = _targets(models, num_cache_layers)
    common = dict(max_length=MAX_LEN, safe_buffer=32, eos_token_ids=[-1], **kw)
    if engine == "static":
        jeng = JaxStaticEngine(draft_model_name=jd, target_model_name=joff, dtype=jnp.float32,
                               growmap=jax_growmap_from_spec(3, 4), **common)
        eng = AutoEngine.from_config(device=CPU, engine="static", model=off, draft_model=pd,
                                     growmap=growmap_from_spec(3, 4), dtype=torch.float32,
                                     **common)
    else:
        tree = dict(width=4, num_beams=4, depth=3, draft_topk_recall=1.0)
        jeng = JaxDynamicEngine(draft_model_name=jd, target_model_name=joff, dtype=jnp.float32,
                                **common, **tree)
        eng = AutoEngine.from_config(device=CPU, model=off, draft_model=pd, dtype=torch.float32,
                                     **common, **tree)
    jeng.initialize()
    eng.initialize()
    assert not eng._can_decode_fused() and eng._offload
    return jeng, eng


def test_offload_target_stepwise_verify_matches_jax(models):
    """The static engine's stepwise loop over an offload target (the streamed
    verify): four steps, JAX's tokens and the AR decode's."""
    (jt, _), _ = models
    jeng, eng = _engines(models, "static")
    out = []
    for e in (jeng, eng):
        assert e._prefill(np.asarray(PROMPT))
        start = e.num_nodes
        for _ in range(4):
            e.build_tree()
            e.verify()
        out.append(e.tokens_host[start:e.num_nodes + 1].tolist())
    assert out[1] == out[0]
    assert out[1] == _greedy_ar_decode(jt, PROMPT, len(out[1]))


@pytest.mark.parametrize("engine,num_cache_layers,max_new",
                         [("static", 0, 12), ("static", 1, 30), ("dynamic", 0, 8),
                          ("dynamic", 2, 24)])
def test_offload_pipelined_generate_matches_jax(models, engine, num_cache_layers, max_new):
    """generate() over an offload target takes the pipelined loop (the host one
    step ahead, results read one step behind): JAX's tokens, accept length
    and the AR decode's; the trailing in-flight step changes nothing (a
    second request repeats the first)."""
    (jt, _), _ = models
    jeng, eng = _engines(models, engine, num_cache_layers)
    calls = []
    pipelined = eng._decode_offload_pipelined
    eng._decode_offload_pipelined = lambda *a, **k: calls.append(a) or pipelined(*a, **k)
    want = jeng.generate(input_ids=PROMPT, max_new_tokens=max_new)
    got = eng.generate(input_ids=PROMPT, max_new_tokens=max_new)
    assert calls and len(got["generated_tokens"]) >= max_new
    assert got["generated_tokens"] == want["generated_tokens"]
    assert got["avg_accept_tokens"] == want["avg_accept_tokens"] >= 1.0
    toks = got["generated_tokens"]
    assert toks == _greedy_ar_decode(jt, PROMPT, len(toks))
    assert eng.generate(input_ids=PROMPT, max_new_tokens=max_new)["generated_tokens"] == toks


@pytest.mark.parametrize("engine", ["static", "dynamic"])
def test_offload_step_splits_around_the_streamed_forward(models, engine):
    """The offload engine's step as the graphed loop runs it (JAX's
    `_offload_step`): the draft phase and the tail (sampling, accept rule,
    commit, both compactions, the stop rule) each one captured segment, the
    streamed forward an eager segment between them whose logits the tail
    reads from a static buffer. Run as split (stochastic, repetition
    penalty), four steps equal the unsplit step bit for bit: the packed
    result, tokens, loop state and both KV caches."""
    from test_torch_decode_loop import engine_state, unsplit_step

    kw = dict(temperature=0.8, repetition_penalty=1.2, seed=5)
    split, whole = (_engines(models, engine, num_cache_layers=1, **kw)[1] for _ in range(2))
    plan = plan_segments(split._step_phases(False, True))
    assert [(seg.eager, [ph.name for ph in seg.phases], seg.hops) for seg in plan] == [
        (False, ["draft"], ()), (True, ["streamed_forward"], ()),
        (False, ["commit", "compact0", "update"], ("logits",))]
    for e in (split, whole):
        assert e._prefill(np.asarray(PROMPT))
        for k, v in (("nn", e.num_nodes), ("start", e.num_nodes), ("max_new", 64),
                     ("cont", True)):
            e._loop[k].fill_(v)
    for _ in range(4):
        assert torch.equal(split._decode_step(False, True), unsplit_step(whole, False, True))
        assert all(torch.equal(a, b) for a, b in zip(engine_state(split), engine_state(whole)))
    assert int(split._loop["steps"]) == 4


@pytest.mark.parametrize("engine", ["static", "dynamic"])
def test_offload_pipelined_stream_loop_matches_jax(models, engine):
    """speculative_decoding (the streaming loop) over an offload target goes
    through the pipelined loop with the per-commit callback: JAX's dec_len,
    steps and tokens, and the AR decode's."""
    (jt, _), _ = models
    jeng, eng = _engines(models, engine, stop_distance=4)
    res = []
    for e in (jeng, eng):
        assert e._prefill(np.asarray(PROMPT))
        start = e.num_nodes
        dec_len, _, steps = e.speculative_decoding(max_new_tokens=10)
        res.append((dec_len, steps, e.tokens_host[start:e.num_nodes + 1].tolist()))
    assert res[1] == res[0]
    dec_len, steps, produced = res[1]
    assert steps >= 1 and dec_len >= 2
    assert produced == _greedy_ar_decode(jt, PROMPT, len(produced))


def test_offload_exclusive_with_parallel_modes(models):
    """offload and tensor / pipeline / expert parallel are mutually exclusive
    (the JAX engines assert it); the batched engine takes no offload target."""
    (_, _), (off, pd) = _targets(models)
    base = dict(device=CPU, engine="static", model=off, draft_model=pd,
                growmap=growmap_from_spec(3, 4))
    for key in ("tensor_parallel", "pipeline_parallel", "expert_parallel"):
        with pytest.raises(ValueError, match="mutually exclusive"):
            AutoEngine.from_config(offload=True, **{key: 2}, **base)
    eng = AutoEngine.from_config(**dict(base, engine="batched_static", batch_size=2,
                                        max_length=MAX_LEN))
    with pytest.raises(ValueError, match="resident"):
        eng.initialize()
