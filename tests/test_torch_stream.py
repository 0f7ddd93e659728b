"""The port's streaming generation against the JAX package on the CPU.

`generate_stream` of the port's static and dynamic engines against the JAX
engines' over the same weights (the JAX trees carried across with
params_from_numpy, fp32, greedy): the frames' texts are equal, one by one;
over an offload target (which the JAX engines stream stepwise and the port
through its pipelined loop) the final text and tokens are equal; the
batched path's frames (ContinuousBatcher through BatcherBackend) grow as
prefixes and end in the final text. A tokenizer that ends every word of a
token divisible by 5 with a period drives the sentence-complete stop.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_static_engine import MAX_LEN, _cfg
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.offload.streaming import OffloadModelRuntime as JaxOffload
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.speculation.dynamic_engine import DynamicEngine as JaxDynamicEngine
from umbrella_tpu.speculation.static_engine import StaticEngine as JaxStaticEngine
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.models import auto_model
from umbrella_tpu_torch.models.convert import params_from_numpy
from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher
from umbrella_tpu_torch.serving.scheduler import BatcherBackend
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

torch.set_num_threads(1)  # several workers share the cores

CPU = "cpu"
PROMPT = [1, 5, 9]
DYNAMIC_TREE = dict(width=4, num_beams=4, depth=3, draft_topk_recall=1.0)


class WordTokenizer:
    """One word a token; a token divisible by 5 ends its word with a period."""

    def encode(self, text):
        return [1] + [ord(c) % 90 + 2 for c in text][:16]

    def decode(self, ids, **kw):
        return " ".join(f"{i}." if i % 5 == 0 else str(i) for i in ids)


def words_to_ids(text):
    return [int(w.rstrip(".")) for w in text.split()]


@functools.lru_cache(maxsize=None)
def runtimes():
    """tests/test_api_server.py's target (seed 0) and draft (seed 1): JAX's and
    the port's over the same weights."""
    jt, jd = (jax_auto.random_runtime(_cfg(), MAX_LEN, seed=s) for s in (0, 1))
    c = jt.cfg
    cfg = ModelConfig(**{f: getattr(c, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
        "eos_token_id", "tie_word_embeddings", "rope_theta")})
    pt, pd = (auto_model.ModelRuntime(cfg, params_from_numpy(jax.tree_util.tree_map(
        np.asarray, r.params)), MAX_LEN, dtype=torch.float32, device=CPU) for r in (jt, jd))
    return (jt, jd), (pt, pd)


def jax_engine(kind, target, draft, **kw):
    common = dict(max_length=MAX_LEN, safe_buffer=32, eos_token_ids=[-1], dtype=jnp.float32)
    if kind == "static":
        eng = JaxStaticEngine(draft_model_name=draft, target_model_name=target,
                              growmap=jax_growmap_from_spec(3, 4), **common, **kw)
    else:
        eng = JaxDynamicEngine(draft_model_name=draft, target_model_name=target, **common,
                               **DYNAMIC_TREE, **kw)
    eng.initialize()
    return eng


def port_engine(kind, target, draft, **kw):
    common = dict(device=CPU, model=target, draft_model=draft, max_length=MAX_LEN,
                  safe_buffer=32, eos_token_ids=[-1], dtype=torch.float32)
    if kind == "static":
        eng = AutoEngine.from_config(engine="static", growmap=growmap_from_spec(3, 4), **common,
                                     **kw)
    else:
        eng = AutoEngine.from_config(**common, **DYNAMIC_TREE, **kw)
    eng.initialize()
    return eng


def engines(kind, **kw):
    """A JAX and a port engine of one kind over the same weights."""
    (jt, jd), (pt, pd) = runtimes()
    return jax_engine(kind, jt, jd, **kw), port_engine(kind, pt, pd, **kw)


def check_frames_grow(frames):
    """Each frame's text extends the one before; the last is the final text."""
    texts = [t for t, _ in frames]
    assert all(b.startswith(a) for a, b in zip(texts, texts[1:])), texts
    return texts[-1]


@pytest.mark.parametrize("kind,max_new,stop_distance", [
    ("static", 20, 8), ("static", 70, 8), ("static", 48, 32), ("dynamic", 24, 8),
    ("dynamic", 60, 16)])
def test_generate_stream_frames_equal_jax(kind, max_new, stop_distance):
    """Frame texts equal JAX's one by one (the 32-token segments of the
    device-resident loop, the sentence-complete stop within stop_distance
    of the budget); the final text is a prefix of generate()'s over the
    same budget; perf logs are strings; the engine is reset after."""
    jeng, eng = engines(kind, tokenizer=WordTokenizer(), stop_distance=stop_distance)
    want = list(jeng.generate_stream(input_ids=PROMPT, max_new_tokens=max_new))
    got = list(eng.generate_stream(input_ids=PROMPT, max_new_tokens=max_new))
    assert [t for t, _ in got] == [t for t, _ in want]
    assert all(isinstance(p, str) and p.startswith("Output Tokens") for _, p in got)
    final = check_frames_grow(got).split()
    assert eng.num_nodes == 0
    full = eng.generate(input_ids=PROMPT, max_new_tokens=max_new)["generated_text"].split()
    assert len(final) >= max(max_new, stop_distance) - stop_distance
    assert final == full[:len(final)]


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_generate_stream_refusals_equal_jax(kind):
    """An empty prompt, a zero budget and a prompt past the reserved context
    each give JAX's one frame; the engine serves the next request."""
    jeng, eng = engines(kind, tokenizer=WordTokenizer())
    long = list(range(3, MAX_LEN - 40))
    for req in (dict(input_ids=[]), dict(input_ids=PROMPT, max_new_tokens=0),
                dict(input_ids=long, max_new_tokens=8), dict(context="")):
        want = list(jeng.generate_stream(**dict(req)))
        assert list(eng.generate_stream(**dict(req))) == want
        assert want == [("Exceeding reserved allowed context length",) * 2]
    assert list(eng.generate_stream(input_ids=PROMPT, max_new_tokens=8))[-1][0]


def test_generate_stream_from_context_equals_jax():
    """A text prompt (the tokenizer's encode) streams the frames of JAX."""
    jeng, eng = engines("static", tokenizer=WordTokenizer(), stop_distance=8)
    req = dict(context="hello world", max_new_tokens=30)
    assert [t for t, _ in eng.generate_stream(**dict(req))] == \
        [t for t, _ in jeng.generate_stream(**dict(req))]


def test_stochastic_stream_equals_generate_from_one_seed():
    """Stochastic (0.8 / 0.9 / 1.2): two port engines from one seed, one
    streaming in segments and one running generate() in one go, commit the
    same tokens (a segment's trailing no-op steps take back their draws)."""
    (_, _), (pt, pd) = runtimes()
    kw = dict(tokenizer=WordTokenizer(), stop_distance=4, seed=7, temperature=0.8, topp=0.9,
              repetition_penalty=1.2)
    a, b = (port_engine("static", pt, pd, **kw) for _ in range(2))
    text = list(a.generate_stream(input_ids=PROMPT, max_new_tokens=80))[-1][0]
    toks = b.generate(input_ids=PROMPT, max_new_tokens=80)["generated_tokens"]
    streamed = words_to_ids(text)
    assert len(streamed) >= 76 and streamed == toks[:len(streamed)]


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_offload_stream_final_text_and_tokens_equal_jax(kind):
    """Over an offload target (one layer resident, one streamed) JAX streams
    stepwise and the port through the pipelined loop: the final text and
    tokens are equal (frame boundaries may differ), and equal the port's
    own resident engine's stream."""
    (jt, jd), (pt, pd) = runtimes()
    joff = JaxOffload.from_params(jt.params, jt.cfg, MAX_LEN, dtype=jnp.float32,
                                  num_cache_layers=1)
    off = OffloadModelRuntime.from_params(pt.params, pt.cfg, MAX_LEN, dtype=torch.float32,
                                          num_cache_layers=1, device=CPU)
    kw = dict(tokenizer=WordTokenizer(), stop_distance=8)
    jeng, eng = jax_engine(kind, joff, jd, **kw), port_engine(kind, off, pd, **kw)
    assert eng._offload and not eng._can_decode_fused()
    want = list(jeng.generate_stream(input_ids=PROMPT, max_new_tokens=40))[-1][0]
    frames = list(eng.generate_stream(input_ids=PROMPT, max_new_tokens=40))
    got = check_frames_grow(frames)
    assert got == want and words_to_ids(got) == words_to_ids(want)
    resident = port_engine(kind, pt, pd, **kw)
    assert list(resident.generate_stream(input_ids=PROMPT, max_new_tokens=40))[-1][0] == got


def test_batched_stream_frames_are_growing_prefixes_of_the_result():
    """BatcherBackend.generate_stream over a ContinuousBatcher (B=2, segments
    of 2 steps): text frames, each a prefix of the next, then the final text
    with the result dict; the tokens equal run()'s for the same request,
    also with a second request decoding beside it."""
    (_, _), (pt, pd) = runtimes()
    eng = AutoEngine.from_config(
        device=CPU, engine="batched_static", model=pt, draft_model=pd, batch_size=2,
        growmap=growmap_from_spec(3, 4), max_length=MAX_LEN, safe_buffer=32,
        eos_token_ids=[-1], dtype=torch.float32, segment_steps=2, tokenizer=WordTokenizer())
    eng.initialize()
    reqs = [dict(input_ids=PROMPT, max_new_tokens=40), dict(input_ids=[2, 7, 3], max_new_tokens=24)]
    want = eng.run([dict(r) for r in reqs])
    batcher = ContinuousBatcher(eng)
    batcher.start()
    try:
        other = batcher.submit(**dict(reqs[1]))
        frames = list(BatcherBackend(batcher).generate_stream(**dict(reqs[0])))
        assert other.result(timeout=120)["generated_tokens"] == want[1]["generated_tokens"]
    finally:
        batcher.shutdown()
    assert len(frames) >= 3
    text, result = frames[-1]
    assert isinstance(result, dict) and all(isinstance(p, str) for _, p in frames[:-1])
    assert check_frames_grow(frames) == text == result["generated_text"]
    assert result["generated_tokens"] == want[0]["generated_tokens"]
    assert words_to_ids(text) == result["generated_tokens"]
