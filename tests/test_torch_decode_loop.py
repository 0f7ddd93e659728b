"""The port's device-resident decode loop against the JAX package on the CPU.

`StaticEngine._decode_fused` (the counterpart of the JAX package's one-dispatch
`decode_loop_fn`) runs gated steps in blocks, with num_nodes, the continue
flag and the stop rule on the device; on the card each block is a run of CUDA
graph replays, here the same step runs eagerly. Its tokens must equal the
JAX package's `_decode_fused` and `generate`, and the port's own stepwise loop
(build_tree(); verify()), greedy, with an fp32 and an int8 KV cache, through
an EOS inside a block, a budget that ends inside one and the context cap. The
step must make no host read, and the engines' buffers must keep their
addresses (a captured graph holds them). The batched segment refills its
persistent inputs in place: two greedy segments with a new repetition penalty
and a slot admitted between them give JAX's tokens. A pipeline-staged target
takes the same loop (JAX's `_decode_fused` over `pipeline_parallel`). Tokens
are compared exactly. `unsplit_step` (the step as one function) and
`engine_state` serve the pipeline and offload tests' comparisons of the
step's phases too.
"""
import contextlib
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.models import kv_cache as jax_kv
from umbrella_tpu.ops import masks as jax_masks
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.serving.batched_engine import BatchedStaticEngine as JaxBatchedEngine
from umbrella_tpu.speculation.static_engine import StaticEngine as JaxStaticEngine
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.models import auto_model
from umbrella_tpu_torch.models.convert import params_from_numpy
from umbrella_tpu_torch.models.kv_cache import gather_compact, init_kv_cache, update_layer
from umbrella_tpu_torch.ops import masks
from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.serving.batched_engine import BatchedStaticEngine
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
from umbrella_tpu_torch.speculation.verify import gated_stop, verify_tail

MAX_LEN = 256
CPU = "cpu"
SMALL = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
             max_position_embeddings=MAX_LEN, tie_word_embeddings=False, eos_token_id=-100)
EXIT = 2
TREE = (3, 4)  # 13 nodes, 5 levels: a step commits at most 5 tokens
PROMPT = [1, 17, 42, 9]
LONG_PROMPT = list(np.random.default_rng(5).integers(3, 500, size=170))


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_target():
    """A dense fp32 target with a damped tail (wo and down x0.05 from layer
    EXIT on), so that its early-exit draft is often right."""
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


def _jax_engine(jax_target, kv_dtype=None, eos=-1):
    eng = JaxStaticEngine(
        draft_model_name=jax_auto.early_exit_runtime(jax_target, exit_layer=EXIT),
        target_model_name=jax_target, dtype=jnp.float32, growmap=jax_growmap_from_spec(*TREE),
        max_length=MAX_LEN, safe_buffer=32, eos_token_ids=[eos], draft_topk_recall=1.0,
        kv_dtype=kv_dtype)
    eng.initialize()
    return eng


def _port_engine(models, kv_dtype=None, eos=-1, **kw):
    target, draft = models
    eng = AutoEngine.from_config(
        device=CPU, engine="static", model=target, draft_model=draft,
        growmap=growmap_from_spec(*TREE), max_length=MAX_LEN, safe_buffer=32,
        eos_token_ids=[eos], dtype=torch.float32, kv_dtype=kv_dtype, **kw)
    eng.initialize()
    return eng


def _fused(eng, prompt, max_new):
    """(tokens committed after the prompt, steps, eos stop) of one
    _decode_fused from a fresh prefill; the engine is reset afterwards."""
    assert eng._prefill(np.asarray(prompt, np.int32))
    start = eng.num_nodes
    steps = eng._decode_fused(max_new)
    out = (eng.tokens_host[start:eng.num_nodes + 1].tolist(), steps, eng._last_eos_stop)
    eng.reset()
    return out


def _stepwise(eng, prompt, max_new):
    assert eng._prefill(np.asarray(prompt, np.int32))
    start = eng.num_nodes
    steps = eng._decode_stepwise(max_new)
    out = eng.tokens_host[start:eng.num_nodes + 1].tolist(), steps
    eng.reset()
    return out


@pytest.fixture(scope="module")
def jax_engines(jax_target):
    return {kv: _jax_engine(jax_target, kv) for kv in (None, "int8")}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("case", ["budget", "budget-mid-block", "context-cap"])
def test_block_loop_matches_jax_fused_and_stepwise(jax_engines, port_models, kv_dtype, case):
    """Greedy: the port's block loop commits JAX's _decode_fused tokens and
    step count, and the port's stepwise loop's; a budget of 24 or 37 tokens
    ends inside the last block (blocks of ceil(room / 5) replays never run a
    replay past the budget, so none is a no-op), and a 170-token prompt with a
    200-token budget stops at the context cap (max_length - safe_buffer)."""
    prompt, max_new = {"budget": (PROMPT, 24), "budget-mid-block": (PROMPT, 37),
                       "context-cap": (LONG_PROMPT, 200)}[case]
    jeng = jax_engines[kv_dtype]
    eng = _port_engine(port_models, kv_dtype)
    assert eng._can_decode_fused() and eng.max_step_advance == 5
    want = _fused(jeng, prompt, max_new)
    got = _fused(eng, prompt, max_new)
    assert got == want
    assert eng.decode_stats["noop_replays"] == 0 and eng.decode_stats["replays"] == got[1]
    toks, steps = _stepwise(eng, prompt, max_new)
    assert (toks, steps) == got[:2]
    if case == "context-cap":
        cap = MAX_LEN - eng.safe_buffer
        assert len(prompt) + len(toks) - 1 > cap >= len(prompt) + len(toks) - 1 - 5
    else:
        assert max_new <= len(toks) - 1 < max_new + 5
    # generate() takes the block loop and returns JAX's generate()
    want_gen = jeng.generate(input_ids=prompt, max_new_tokens=max_new)
    got_gen = eng.generate(input_ids=prompt, max_new_tokens=max_new)
    assert got_gen["generated_tokens"] == want_gen["generated_tokens"]
    assert got_gen["avg_accept_tokens"] == want_gen["avg_accept_tokens"]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_eos_inside_a_block_matches_jax(jax_target, jax_engines, port_models, kv_dtype):
    """An EOS token met a few steps into a block stops the loop there: the
    block's remaining replays are no-ops that change no committed token, and
    the tokens, steps and EOS flag equal JAX's _decode_fused (and the port's
    stepwise loop)."""
    free, _, _ = _fused(jax_engines[kv_dtype], PROMPT, 60)
    eos = next(t for i, t in enumerate(free) if i >= 8 and t not in free[:i])
    jeng = _jax_engine(jax_target, kv_dtype, eos=eos)
    eng = _port_engine(port_models, kv_dtype, eos=eos)
    want = _fused(jeng, PROMPT, 60)
    got = _fused(eng, PROMPT, 60)
    assert got == want and got[2] and got[0][-1] == eos and len(got[0]) < 60
    assert eng.decode_stats["noop_replays"] > 0
    assert _stepwise(eng, PROMPT, 60) == got[:2]


def test_speculative_decoding_matches_jax(jax_engines, port_models):
    """The streaming loop advances in segments of stream_segment tokens: JAX's
    (dec_len, steps) and the same committed tokens."""
    jeng = jax_engines[None]
    eng = _port_engine(port_models)
    want, got = [], []
    for e, out in ((jeng, want), (eng, got)):
        assert e._prefill(np.asarray(PROMPT, np.int32))
        dec_len, _, steps = e.speculative_decoding(max_new_tokens=70)
        out.append((dec_len, steps, e.tokens_host[:len(PROMPT) + dec_len].tolist()))
        e.reset()
    assert got == want
    assert eng.decode_stats["blocks"] >= 3  # 70 tokens in segments of 32


@pytest.mark.parametrize("offset", [0, 17, 243, 250, 255])  # 243+: the window is clamped
def test_masks_at_a_device_offset_match_jax(offset):
    """Exact: mask rows built from a 0-d int32 device tensor equal JAX's from an int."""
    gm = jax_growmap_from_spec(*TREE)
    bm = np.asarray(gm.bitmap)
    nn = torch.tensor(offset, dtype=torch.int32)
    np.testing.assert_array_equal(
        masks.causal_mask_rows(nn - 1, 2, MAX_LEN).numpy(),
        np.asarray(jax_masks.causal_mask_rows(offset - 1, 2, MAX_LEN)))
    np.testing.assert_array_equal(
        masks.tree_mask_rows(nn, _t(bm), MAX_LEN).numpy(),
        np.asarray(jax_masks.tree_mask_rows(offset, jnp.asarray(bm), MAX_LEN)))
    for lvl in range(gm.num_levels):
        s, n = gm.level_start(lvl), len(gm.roots[lvl])
        np.testing.assert_array_equal(
            masks.tree_level_mask_rows(nn, _t(bm), s, n, MAX_LEN).numpy(),
            np.asarray(jax_masks.tree_level_mask_rows(offset, jnp.asarray(bm), s, n, MAX_LEN)))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("offset", [0, 9, 58, 60, 63])  # 58+ is clamped for 6-slot windows
def test_update_layer_and_gather_compact_at_a_device_offset_match_jax(kv_dtype, offset):
    """Exact: writes and compaction at a 0-d device offset equal JAX's at the
    int (JAX under jit, as its engines run it: jit multiplies by 1 / 127 where
    eager JAX divides)."""
    import jax

    rng = np.random.default_rng(offset)
    jdt, pdt = ("int8", "int8") if kv_dtype == "int8" else (jnp.float32, torch.float32)
    jkv = jax_kv.init_kv_cache(JaxConfig(**SMALL), 64, dtype=jdt, num_layers=2)
    pkv = init_kv_cache(ModelConfig(**SMALL), 64, dtype=pdt, num_layers=2)
    off = torch.tensor(offset, dtype=torch.int32)
    for layer in (0, 1):
        kn = rng.standard_normal((6, 2, 32)).astype(np.float32)
        vn = rng.standard_normal((6, 2, 32)).astype(np.float32)
        jkv = jax.jit(jax_kv.update_layer, static_argnums=1)(
            jkv, layer, jnp.asarray(kn), jnp.asarray(vn), offset)
        update_layer(pkv, layer, _t(kn), _t(vn), off)
    idx = np.array([0, 2, 3, 5, 5, 5], np.int32)
    jkv = jax.jit(jax_kv.gather_compact)(jkv, jnp.asarray(idx), offset, 4)
    gather_compact(pkv, _t(idx), off, torch.tensor(4, dtype=torch.int32))
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(pkv, name) is not None:
            np.testing.assert_array_equal(getattr(pkv, name).numpy(),
                                          np.asarray(getattr(jkv, name)))


@contextlib.contextmanager
def no_host_reads():
    """Inside the block every way a tensor reaches the host raises."""
    def boom(*_a, **_k):
        raise AssertionError("host read inside a step")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "__bool__", "__int__", "__index__", "cpu", "numpy", "tolist"):
            mp.setattr(torch.Tensor, name, boom)
        yield


@pytest.mark.parametrize("kv_dtype,greedy,use_pen",
                         [(None, True, False), ("int8", True, True), (None, False, True)])
def test_decode_step_makes_no_host_read(port_models, kv_dtype, greedy, use_pen):
    """The step (build, verify, gated commit) runs with every host read
    patched to raise, and advances the device state."""
    eng = _port_engine(port_models, kv_dtype, temperature=0.0 if greedy else 0.8,
                       repetition_penalty=1.2 if use_pen else 1.0)
    assert eng._prefill(np.asarray(PROMPT, np.int32))
    assert eng._sampling_mode() == (greedy, use_pen)
    st = eng._loop
    for k, v in (("nn", len(PROMPT)), ("start", len(PROMPT)), ("max_new", 64), ("cont", True)):
        st[k].fill_(v)
    with no_host_reads():
        eng._decode_step(greedy, use_pen)
        eng._decode_step(greedy, use_pen)
    assert torch.equal(st["steps"], torch.tensor(2, dtype=torch.int32))
    assert torch.gt(st["nn"], len(PROMPT) + 1)


def test_batched_segment_step_makes_no_host_read(port_models):
    eng = _batched(port_models)
    assert eng.admit(0, PROMPT) and eng.admit(1, PROMPT[:3])
    handle = eng.step_many_async(1, [100, 100, 100], penalty=[1.2, 1.0, 1.0],
                                 temperature=[0.0, 0.7, 0.0])
    eng.sync_segment(handle)
    before = eng._seg["steps"].clone()
    with no_host_reads():
        eng._segment_step(True, False)
    assert torch.equal(eng._seg["steps"], before + torch.tensor([1, 1, 0], dtype=torch.int32))


def _buffers(eng):
    return [eng.tokens.data_ptr()] + [t.data_ptr() for kv in (eng.kv_draft, eng.kv_target)
                                      for t in kv if t is not None] \
        + [t.data_ptr() for t in (*eng._loop.values(), *eng._sampling.values())]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_buffers_keep_their_addresses_across_requests(port_models, kv_dtype):
    """tokens, both KV caches and the loop state stay where they are through
    _prefill, a decode, _append, a decode and reset (a captured graph reads
    them at those addresses), and reset zeroes them in place."""
    eng = _port_engine(port_models, kv_dtype)
    ptrs = _buffers(eng)
    assert eng._prefill(np.asarray(PROMPT, np.int32))
    eng._decode_fused(16)
    assert eng._append(np.asarray([7, 8, 9], np.int32))
    eng._decode_fused(16)
    assert eng.num_nodes >= len(PROMPT) + 16 + 3 + 16
    assert _buffers(eng) == ptrs
    eng.reset()
    assert _buffers(eng) == ptrs
    assert not eng.tokens.any() and not any(t.any() for t in eng.kv_target if t is not None)


def test_multi_turn_block_loop_matches_stepwise(port_models):
    """_prefill, a decode, _append, a decode: the block loop commits the
    stepwise loop's tokens in both turns."""
    out = []
    for decode in ("_decode_fused", "_decode_stepwise"):
        eng = _port_engine(port_models, eos=-1)
        assert eng._prefill(np.asarray(PROMPT, np.int32))
        getattr(eng, decode)(20)
        assert eng._append(np.asarray([7, 8, 9], np.int32))
        getattr(eng, decode)(20)
        out.append(eng.tokens_host[:eng.num_nodes + 1].tolist())
    assert out[0] == out[1]


def _eos_after(tokens, at_least=8):
    """A token that first appears at index at_least or later of `tokens`."""
    return next(t for i, t in enumerate(tokens) if i >= at_least and t not in tokens[:i])


def _two_turns(eng, decode, max_new=60):
    """_prefill, a decode, _append, a decode. Returns, for each turn, (tokens
    committed after its prefix, steps, eos stop), and the draft KV rows below
    num_nodes after the first turn."""
    turns = []
    assert eng._prefill(np.asarray(PROMPT, np.int32))
    for turn in range(2):
        start = eng.num_nodes
        steps = decode(eng, max_new)
        turns.append((eng.tokens_host[start:eng.num_nodes + 1].tolist(), steps,
                      bool(eng._last_eos_stop)))
        if turn == 0:
            kv = [np.asarray(t)[:, :, :eng.num_nodes] for t in eng.kv_draft if t is not None]
            assert eng._append(np.asarray([7, 8, 9], np.int32))
    return turns, kv


def _port_stepwise(eng, max_new):
    steps = eng._decode_stepwise(max_new)
    eng._last_eos_stop = eng.tokens_host[eng.num_nodes] in eng.eos_token_ids
    return steps


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_no_op_replays_leave_the_next_turn_as_stepwise(jax_target, jax_engines, port_models,
                                                        kv_dtype):
    """An EOS stops the first turn a few steps into a block, so the block
    ends in no-op replays. They rewrite no committed draft KV (the draft's
    rows below num_nodes equal the stepwise loop's, bit for bit), and after
    _append the second turn's tokens, steps and accept rate equal the
    stepwise loop's and the JAX package's _decode_fused (whose while_loop
    exits at once)."""
    free, _, _ = _fused(jax_engines[kv_dtype], PROMPT, 60)
    eos = _eos_after(free)
    jeng = _jax_engine(jax_target, kv_dtype, eos=eos)
    want, _ = _two_turns(jeng, lambda e, n: e._decode_fused(n))
    fused = _port_engine(port_models, kv_dtype, eos=eos)
    got, kv = _two_turns(fused, lambda e, n: e._decode_fused(n))
    assert got[0][2] and fused.decode_stats["noop_replays"] > 0
    step, kv_step = _two_turns(_port_engine(port_models, kv_dtype, eos=eos), _port_stepwise)
    assert got == want == step  # tokens and steps, so avg_accept_tokens too
    for a, b in zip(kv, kv_step):
        np.testing.assert_array_equal(a, b)


def test_no_op_replays_take_back_their_random_draws(port_models):
    """Stochastic (temperature 0.8, top-p 0.9, one seed): the first request
    stops at an EOS inside a block, and its trailing no-op steps' draws are
    taken back, so the next request draws, and commits, what it would after
    the stepwise loop."""
    kw = dict(temperature=0.8, topp=0.9, seed=4)
    free = _port_engine(port_models, **kw).generate(input_ids=PROMPT, max_new_tokens=60)
    eos = _eos_after(free["generated_tokens"])
    out = []
    for mode in ("fused", "stepwise"):
        eng = _port_engine(port_models, eos=eos, **kw)
        if mode == "stepwise":
            eng._can_decode_fused = lambda: False
        out.append([eng.generate(input_ids=PROMPT, max_new_tokens=60)["generated_tokens"]
                    for _ in range(2)])
        if mode == "fused":
            assert eng.decode_stats["noop_replays"] > 0
    assert out[0][0][-1] == eos and len(out[0][0]) < 60
    assert out[0] == out[1]


def unsplit_step(eng, greedy: bool, use_pen: bool) -> torch.Tensor:
    """The device-resident loop's step written as one function (the port's
    step before it became phases): the draft build, the target's forward
    (`_target_logits`), verify_tail gated on the continue flag (both caches
    compacted), the stop rule and the loop state's update. Returns the
    step's packed (accept_len, cont, block)."""
    st = eng._loop
    nn, cont = st["nn"], st["cont"]
    eng._build(nn, cont)
    alen, eos, block = verify_tail(
        eng._target_logits(nn), eng.kv_target, eng.kv_draft, eng.tokens, nn, eng._bitmap,
        eng._parents, eng._node_in_path, eng._eos_arr, cont=cont,
        **eng._tail_kw(greedy, use_pen))
    nn_out, cont_out = gated_stop(nn, cont, alen, eos, st["start"], st["max_new"],
                                  eng.max_length - eng.safe_buffer)
    st["steps"].add_(cont.to(torch.int32))
    st["eos"].copy_(torch.where(cont, eos, st["eos"]))
    st["nn"].copy_(nn_out)
    st["cont"].copy_(cont_out)
    return torch.cat([alen.reshape(1), cont_out.reshape(1).to(torch.int32), block])


def engine_state(eng) -> list:
    """Everything a step writes: the token row, the loop state and every KV
    buffer (a staged cache's stages in order)."""
    caches = [c for kv in (eng.kv_draft, eng.kv_target) for c in getattr(kv, "stages", (kv,))]
    return [eng.tokens.clone(), *(t.clone() for t in eng._loop.values()),
            *(t.clone() for c in caches for t in c if t is not None)]


def _staged(target, stages=2):
    return shard_runtime_pp(auto_model.ModelRuntime(target.cfg, dict(target.params), MAX_LEN,
                                                    dtype=torch.float32, device=CPU),
                            [CPU] * stages)


def test_staged_target_runs_the_fused_loop(jax_target, port_models):
    """A pipeline-staged target supports fused phases, as in the JAX package:
    its engine takes the device-resident loop, whose tokens and step count
    equal the staged engine's stepwise loop, the unstaged engine's block loop
    and JAX's `_decode_fused` on a pipeline_parallel=2 engine (2 of its 8
    host devices a stage); the committed KV rows of the three port decodes
    are equal bit for bit (a staged cache's stages concatenated)."""
    target, draft = port_models
    staged = _staged(target)
    assert staged.supports_fused_phases
    eng = _port_engine((staged, draft))
    assert eng._can_decode_fused()
    out = {}
    for name, e, decode in (("fused", eng, "_decode_fused"),
                            ("stepwise", _port_engine((staged, draft)), "_decode_stepwise"),
                            ("unstaged", _port_engine(port_models), "_decode_fused")):
        assert e._prefill(np.asarray(PROMPT, np.int32))
        start = e.num_nodes
        steps = getattr(e, decode)(24)
        n = e.num_nodes
        rows = [torch.cat([c[f] for c in getattr(e.kv_target, "stages", (e.kv_target,))])[:, :, :n]
                for f in range(2)]
        out[name] = (e.tokens_host[start:n + 1].tolist(), steps, rows)
    assert eng.decode_stats["replays"] >= out["fused"][1] > 0
    for name in ("stepwise", "unstaged"):
        assert out[name][:2] == out["fused"][:2], name
        assert all(torch.equal(a, b) for a, b in zip(out[name][2], out["fused"][2])), name
    jeng = JaxStaticEngine(
        draft_model_name=jax_auto.early_exit_runtime(jax_target, exit_layer=EXIT),
        target_model_name=jax_auto.ModelRuntime(JaxConfig(**SMALL), dict(jax_target.params),
                                                MAX_LEN, dtype=jnp.float32),
        dtype=jnp.float32, growmap=jax_growmap_from_spec(*TREE), max_length=MAX_LEN,
        safe_buffer=32, eos_token_ids=[-1], draft_topk_recall=1.0, pipeline_parallel=2)
    jeng.initialize()
    assert jeng._can_decode_fused()
    toks, steps, _ = _fused(jeng, PROMPT, 24)
    assert (toks, steps) == out["fused"][:2]
    assert len(toks) > 24


# ------------------------------------------------------------------ batched segments


def _batched(models, batch_size=3, **kw):
    target, draft = models
    eng = AutoEngine.from_config(
        device=CPU, engine="batched_static", model=target, draft_model=draft,
        batch_size=batch_size, growmap=growmap_from_spec(*TREE), max_length=MAX_LEN,
        safe_buffer=32, eos_token_ids=[-1], dtype=torch.float32, **kw)
    eng.initialize()
    return eng


def _jax_batched(jax_target, batch_size=3):
    eng = JaxBatchedEngine(
        draft_model_name=jax_auto.early_exit_runtime(jax_target, exit_layer=EXIT),
        target_model_name=jax_target, batch_size=batch_size, dtype=jnp.float32,
        growmap=jax_growmap_from_spec(*TREE), max_length=MAX_LEN, safe_buffer=32,
        eos_token_ids=[-1], draft_topk_recall=1.0)
    eng.initialize()
    return eng


def _two_segments(eng, third):
    """Slots 0 and 1 admitted; a segment with slot 0's repetition penalty
    1.2; then slot 2 admitted as the pipelined loop admits (chunks queued,
    set_nn and activate riding the next dispatch) and a segment with slot
    1's penalty 1.3. Returns (tokens, num_nodes, steps of each segment)."""
    assert eng.admit(0, PROMPT) and eng.admit(1, PROMPT[:3])
    stop = [len(PROMPT) + 40, 3 + 40, len(third) + 40]
    h1 = eng.step_many_async(3, stop, penalty=[1.2, 1.0, 1.0])
    st = eng.begin_admission(2, third)
    assert eng.advance_admission(st, fetch=False) and not st["failed"]
    h2 = eng.step_many_async(4, stop, penalty=[1.0, 1.3, 1.0], set_nn={2: len(third)},
                             activate=[2])
    s1 = eng.sync_segment(h1)
    s2 = eng.sync_segment(h2)
    return ([eng.tokens_host[b, :int(eng.num_nodes[b]) + 1].tolist() for b in range(3)],
            eng.num_nodes.tolist(), s1.tolist(), s2.tolist())


def test_batched_segments_refill_their_inputs_and_match_jax(jax_target, port_models):
    """Greedy: two segments whose repetition penalty changes between them,
    with a slot admitted between them, give the JAX engine's step_many_async
    tokens; the segment's inputs are refilled in place, never rebound."""
    third = [5, 6, 7, 8, 9]
    eng = _batched(port_models)
    ptrs = {k: v.data_ptr() for k, v in eng._seg.items()}
    got = _two_segments(eng, third)
    assert {k: v.data_ptr() for k, v in eng._seg.items()} == ptrs
    want = _two_segments(_jax_batched(jax_target), third)
    assert got == want
    assert got[3] == [4, 4, 4]


def test_stochastic_segments_match_the_stepwise_step_loop(port_models):
    """Stochastic slots (temperature 0.8, top-p 0.9) beside a greedy one:
    step_many_async's segment equals the same number of step() calls from one
    seed (jax.random and torch.Generator draw different numbers, so the JAX
    engine is no oracle here)."""
    out = []
    for mode in ("segment", "step"):
        eng = _batched(port_models, seed=3)
        assert eng.admit(0, PROMPT) and eng.admit(1, PROMPT[:3]) and eng.admit(2, [5, 6, 7])
        tv, pv = [0.8, 0.0, 0.8], [0.9, 0.9, 0.9]
        if mode == "segment":
            eng.sync_segment(eng.step_many_async(5, [10 ** 6] * 3, temperature=tv, topp=pv))
        else:
            for _ in range(5):
                eng.step(temperature=tv, topp=pv)
        out.append([eng.tokens_host[b, :int(eng.num_nodes[b]) + 1].tolist() for b in range(3)])
    assert out[0] == out[1]


@pytest.mark.parametrize("engine", ["static", "batched_static"])
def test_a_dropped_engine_is_freed_at_once(port_models, engine):
    """No reference cycle keeps an engine (its caches and, on the card, its
    graphs' memory pool) alive after its last reference goes: a serving
    process that replaces an engine gets the device memory back without a
    garbage collection."""
    eng = _port_engine(port_models) if engine == "static" else _batched(port_models)
    if engine == "static":
        eng.generate(input_ids=PROMPT, max_new_tokens=8)
    else:
        eng.run([dict(input_ids=PROMPT, max_new_tokens=8)])
    ref = weakref.ref(eng)
    del eng
    assert ref() is None
