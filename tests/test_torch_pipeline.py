"""The port's pipeline-parallel inference (parallel/pipeline.py: staged layer
blocks, per-stage KV caches, the W4A16 kernel's layered mode through
AwqLayerView) and the single-slot engine's stochastic verify, against the JAX
package on the CPU.

Weights are the JAX package's random runtimes carried across with
params_from_numpy, or numpy arrays from a seed; each comparison states its
tolerance. The staged static engine's greedy tokens equal the JAX
pipeline_parallel engine's (tests/test_pp_infer.py's sizes: H 64, 4 layers) and
the port's own AR decode. The JAX side stages on the 8 virtual CPU devices of
tests/conftest.py; the port stages every stage on the CPU. The graphed step's
segment plan over stages on several cards is held as a pure function, and
run per card on the CPU against the unsplit step.
"""
import contextlib
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.models.llama import split_scan_layers as jax_split_scan_layers
from umbrella_tpu.ops import sampling as jax_sampling
from umbrella_tpu.ops.pallas.w4a16 import w4a16_matmul as jax_w4a16_matmul
from umbrella_tpu.quantization import awq as jax_awq
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.speculation.static_engine import StaticEngine as JaxStaticEngine
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.cuda_graphs import Phase, StepGraph, plan_segments
from umbrella_tpu_torch.models import auto_model, llama
from umbrella_tpu_torch.models.convert import params_from_numpy
from umbrella_tpu_torch.models.kv_cache import KVCache, StagedKVCache
from umbrella_tpu_torch.ops import masks
from umbrella_tpu_torch.ops.kernels.w4a16 import w4a16_matmul
from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp, stack_awq_layers, stage_ranges
from umbrella_tpu_torch.quantization import awq
from umbrella_tpu_torch.quantization.awq import AwqLayerView, AwqTensor
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
from umbrella_tpu_torch.speculation.static_engine import StaticEngine
from umbrella_tpu_torch.speculation.tree import GrowMap
from umbrella_tpu_torch.speculation.verify import verify_tail

# one intra-op thread per process: the suite runs in several processes on
# shared cores (see tests/test_torch_batched.py)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 256
CPU = "cpu"
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
             max_position_embeddings=MAX_LEN, tie_word_embeddings=True, eos_token_id=-1)
PROMPT = np.asarray([5, 9, 17, 3, 44, 71, 20, 8], np.int32)
STEPS = 6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _stacked_awq(n_layers, K, N, g, seed, dtype=np.float32):
    """n_layers random W4 layers: the JAX package's per-layer AwqTensors and the
    port's stacked AwqTensor of the same bytes."""
    rng = np.random.default_rng(seed)
    jqs = []
    for _ in range(n_layers):
        w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
        jqs.append(jax_awq.pack_tpu_layout(*jax_awq.quantize_matrix(w, g), dtype=dtype))
    per_layer = tuple(params_from_numpy({"q": _np(q)})["q"] for q in jqs)
    return jqs, stack_awq_layers({"w": per_layer})["w"]


# ------------------------------------------------------------------ layered W4A16


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_layered_w4a16_matches_jax_interpret(out_dtype):
    """The layered mode on a CPU tensor (the plain version on the selected
    layer) against the JAX package's layered Pallas kernel in interpret mode,
    for every layer: within 1e-5 x max|y| (fp32 out; other summation order) or
    2**-7 x max|y| (bf16 out, one rounding). It equals the plain mode on the
    layer's own tensors bit for bit."""
    jqs, stacked = _stacked_awq(3, 512, 256, 128, seed=11, dtype=jnp.bfloat16)
    jstacked = jax_awq.AwqTensor(*(jnp.stack([getattr(q, f) for q in jqs])
                                   for f in ("w8", "scales", "zeros")))
    x = np.random.default_rng(1).standard_normal((8, 512)).astype(np.float32) * 0.1
    jx = jnp.asarray(x, jnp.bfloat16)
    px = _t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    tol = 1e-5 if out_dtype == "float32" else 2 ** -7
    for i in range(3):
        want = np.asarray(jax_w4a16_matmul(jx, jstacked, interpret=True, out_dtype=out_dtype,
                                           layer_idx=jnp.int32(i)), np.float32)
        got = w4a16_matmul(px, stacked, out_dtype=getattr(torch, out_dtype),
                           layer_idx=torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=tol * np.abs(want).max(), rtol=0)
        plain = AwqTensor(*(t[i] for t in stacked))
        assert torch.equal(got, w4a16_matmul(px, plain, out_dtype=getattr(torch, out_dtype)))
    with pytest.raises(ValueError, match="layer_idx"):
        w4a16_matmul(px, stacked)
    with pytest.raises(ValueError, match="layer_idx"):
        w4a16_matmul(px, plain, layer_idx=torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("route", ["w4a16", "w4a8", "dequantize"])
def test_awq_layer_view_routes_to_the_selected_layer(route):
    """awq_matmul on an AwqLayerView equals awq_matmul on that layer's own
    AwqTensor exactly, on each route (the W4A16 layered mode, W4A8 and the
    dequantize route, which select the layer first); the dequantize route
    equals the JAX package's view within 1e-5 (tests/test_awq.py:157)."""
    jqs, stacked = _stacked_awq(2, 256, 128, 128, seed=12)
    x = np.random.default_rng(2).standard_normal((4, 256)).astype(np.float32)
    kw = dict(w4a16=dict(prefer_fused=True), w4a8=dict(prefer_fused=True, act_int8=True),
              dequantize=dict(prefer_fused=False))[route]
    jstacked = jax_awq.AwqTensor(*(jnp.stack([getattr(q, f) for q in jqs])
                                   for f in ("w8", "scales", "zeros")))
    for i in range(2):
        view = AwqLayerView(stacked, torch.tensor(i, dtype=torch.int32))
        got = awq.awq_matmul(_t(x), view, **kw)
        assert torch.equal(got, awq.awq_matmul(_t(x), AwqTensor(*(t[i] for t in stacked)), **kw))
        if route == "dequantize":
            want = jax_awq.awq_matmul(jnp.asarray(x), jax_awq.AwqLayerView(jstacked, jnp.int32(i)),
                                      prefer_fused=False)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_staged_gate_up_takes_the_matmul_route(monkeypatch):
    """As in the JAX package's _mlp_act, only a whole AwqTensor goes through
    awq_gate_up_silu: a layer view's gate_up is one awq_matmul and then
    silu(g) * u, which equals the unstaged layer's result exactly."""
    _, stacked = _stacked_awq(2, 128, 256, 64, seed=13)
    hidden = _t(np.random.default_rng(3).standard_normal((5, 128)).astype(np.float32))
    want = llama._mlp_act({"gate_up": AwqTensor(*(t[1] for t in stacked))}, hidden)
    monkeypatch.setattr(llama, "awq_gate_up_silu", lambda *a, **k: pytest.fail("view fused"))
    got = llama._mlp_act({"gate_up": AwqLayerView(stacked, torch.tensor(1, dtype=torch.int32))},
                         hidden)
    assert torch.equal(got, want)


def test_split_scan_layers_and_view_scan_layer():
    """The same split as the JAX package's on the same tree (stacked AWQ
    entries whole, the rest per layer); a forward whose layers take their
    weights through view_scan_layer gives the unstaged forward's logits bit for
    bit."""
    jrt = jax_auto.random_awq_runtime(JaxConfig(**SMALL), MAX_LEN, dtype=jnp.float32, seed=2,
                                      group_size=32)
    jlayers = dict(jrt.params["layers"])
    jlayers.update({k: jax_awq.AwqTensor(*(jnp.stack([getattr(q, f) for q in v])
                                           for f in ("w8", "scales", "zeros")))
                    for k, v in jlayers.items() if isinstance(v, tuple)})
    prt = auto_model.ModelRuntime(ModelConfig(**SMALL), params_from_numpy(_np(jrt.params)),
                                  MAX_LEN, dtype=torch.float32, device=CPU)
    stacked = stack_awq_layers(prt.params["layers"])
    awq_part, dense = llama.split_scan_layers(stacked)
    jawq, jdense = jax_split_scan_layers(jlayers)
    assert set(awq_part) == set(jawq) == {"wqkv", "wo", "gate_up", "down"}
    assert set(dense) == set(jdense) == {"input_norm", "post_norm"}
    ids = torch.tensor(PROMPT.tolist())
    S = len(ids)
    pos, mask = torch.arange(S), masks.causal_mask_rows(0, S, MAX_LEN)
    want, _ = prt.forward(prt.params, prt.init_kv(), ids, pos, mask, 0)
    params, kv = prt.params, prt.init_kv()
    hidden = llama.embed_lookup(params["embed"], ids, params["final_norm"].dtype)
    for i in range(prt.args.n_layers):
        lw = llama.view_scan_layer(awq_part, {k: v[i] for k, v in dense.items()},
                                   torch.tensor(i, dtype=torch.int32))
        assert isinstance(lw["wqkv"], AwqLayerView) and lw["wqkv"].q is awq_part["wqkv"]
        hidden, kv = llama.llama_layer(prt.args, lw, hidden, kv, i, pos, mask, 0,
                                       params["rope_inv_freq"], params["rope_scale"])
    got = llama.lm_head_logits(params, llama.rms_norm(hidden, params["final_norm"],
                                                      prt.args.rms_eps))
    assert torch.equal(got, want)


# ------------------------------------------------------------------ staged engine vs JAX


def _jax_runtime(kind, seed):
    cfg = JaxConfig(**SMALL)
    if kind == "awq":
        return jax_auto.random_awq_runtime(cfg, max_length=MAX_LEN, dtype=jnp.float32, seed=seed,
                                           group_size=32, quantize_lm_head=False)
    return jax_auto.random_runtime(cfg, MAX_LEN, jnp.float32, seed=seed)


def _decode(eng, steps=STEPS):
    assert eng._prefill(PROMPT)
    for _ in range(steps):
        eng.build_tree()
        eng.verify()
    return eng.tokens_host[:eng.num_nodes + 1].tolist()


@functools.lru_cache(maxsize=None)
def _jax_pp(kind, stages, kv_dtype):
    """The JAX package's pipeline_parallel engine (tests/test_pp_infer.py's
    setup, exact draft top-k): decoded tokens, target KV and num_nodes."""
    eng = JaxStaticEngine(
        draft_model_name=_jax_runtime("dense", 1), target_model_name=_jax_runtime(kind, 2),
        dtype=jnp.float32, growmap=jax_growmap_from_spec(3, 4, acc=[0.5, 0.3, 0.2, 0.1]),
        max_length=MAX_LEN, eos_token_ids=[-1], temperature=0.0, safe_buffer=32, seed=0,
        kv_dtype=kv_dtype, pipeline_parallel=stages, draft_topk_recall=1.0)
    eng.initialize()
    toks = _decode(eng)
    return toks, np.asarray(eng.kv_target.k), eng.num_nodes


def _port_runtime(kind, seed):
    return auto_model.ModelRuntime(ModelConfig(**SMALL),
                                   params_from_numpy(_np(_jax_runtime(kind, seed).params)),
                                   MAX_LEN, dtype=torch.float32, device=CPU)


def _port_engine(target, draft, **kw):
    eng = AutoEngine.from_config(
        device=CPU, engine="static", model=target, draft_model=draft,
        growmap=growmap_from_spec(3, 4, acc=[0.5, 0.3, 0.2, 0.1]), max_length=MAX_LEN,
        eos_token_ids=[-1], safe_buffer=32, dtype=torch.float32, **dict(dict(seed=0), **kw))
    eng.initialize()
    return eng


def _ar_decode(runtime, n_new, kv_dtype=None):
    kv = runtime.init_kv(kv_dtype=kv_dtype)
    S = len(PROMPT)
    logits, kv = runtime.forward(runtime.params, kv, _t(PROMPT), torch.arange(S),
                                 masks.causal_mask_rows(0, S, MAX_LEN), 0)
    out = [int(torch.argmax(logits[-1]))]
    for t in range(S, S + n_new - 1):
        lg, kv = runtime.forward(runtime.params, kv, torch.tensor([out[-1]]), torch.tensor([t]),
                                 masks.causal_mask_rows(t, 1, MAX_LEN), t)
        out.append(int(torch.argmax(lg[0])))
    return out


@pytest.mark.parametrize("kind,stages,kv_dtype", [("dense", 2, None), ("dense", 4, None),
                                                   ("awq", 2, None), ("dense", 2, "int8")])
def test_staged_engine_tokens_match_jax_pipeline_engine(kind, stages, kv_dtype):
    """Greedy: the port's pipeline_parallel engine stages the target (stage s
    holds layers [s*4/N, (s+1)*4/N) and its own KV cache) and decodes the JAX
    pipeline engine's tokens exactly, which are also the port's AR decode's."""
    want, _, _ = _jax_pp(kind, stages, kv_dtype)
    eng = _port_engine(_port_runtime(kind, 2), _port_runtime("dense", 1), kv_dtype=kv_dtype,
                       pipeline_parallel=stages)
    assert eng.target_model.stage_devices == (torch.device(CPU),) * stages
    assert isinstance(eng.kv_target, StagedKVCache) and len(eng.kv_target.stages) == stages
    assert all(s.quantized == (kv_dtype == "int8") for s in eng.kv_target.stages)
    got = _decode(eng)
    assert got == want
    assert len(got) > len(PROMPT) + STEPS
    new = got[len(PROMPT):]
    assert new == _ar_decode(_port_runtime(kind, 2), len(new), kv_dtype)


def test_staged_kv_matches_jax_pipeline_kv():
    """Each stage's cache holds its layers' rows: concatenated over the stages,
    the committed slots [0, num_nodes) equal the JAX pipeline engine's target
    cache within 2e-5 (JAX's scratch tail past max_length has no counterpart)."""
    _, jk, n = _jax_pp("dense", 2, None)
    eng = _port_engine(_port_runtime("dense", 2), _port_runtime("dense", 1), pipeline_parallel=2)
    _decode(eng)
    assert eng.num_nodes == n
    stages = eng.kv_target.stages
    assert [s.k.shape[0] for s in stages] == [2, 2] and stages[0].k.shape[2] == MAX_LEN
    k = torch.cat([s.k for s in stages]).numpy()
    np.testing.assert_allclose(k[:, :, :n], jk[:, :, :n], rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------------ staging rules


def test_shard_runtime_pp_layout():
    """Contiguous blocks of n_layers / stages; AWQ entries stacked from the
    per-layer tensors bit for bit; an uneven split, restaging and a per-layer
    Int4F entry raise."""
    assert stage_ranges(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="divisible"):
        stage_ranges(4, 3)
    rt = _port_runtime("awq", 2)
    per_layer = rt.params["layers"]["gate_up"]
    shard_runtime_pp(rt, [CPU, CPU])
    assert "layers" not in rt.params and rt.stage_devices == (torch.device(CPU),) * 2
    s1 = rt.params["stages"][1]
    assert s1.layers["gate_up"].w8.shape == (2, *per_layer[0].w8.shape)
    assert all(torch.equal(getattr(s1.layers["gate_up"], f)[j], getattr(per_layer[2 + j], f))
               for f in AwqTensor._fields for j in range(2))
    assert s1.layers["input_norm"].shape == (2, SMALL["hidden_size"])
    assert s1.layer_ids.dtype == torch.int32 and s1.layer_ids.tolist() == [0, 1]
    with pytest.raises(ValueError, match="already staged"):
        shard_runtime_pp(rt, [CPU, CPU])
    with pytest.raises(ValueError, match="divisible"):
        shard_runtime_pp(_port_runtime("dense", 2), [CPU] * 3)
    q = _port_runtime("dense", 2)
    q.params["layers"]["wo"] = tuple(q.params["layers"]["wo"])  # per-layer, not AWQ
    with pytest.raises(ValueError, match=r"\['wo'\]: staging takes dense and AWQ"):
        shard_runtime_pp(q, [CPU, CPU])
    assert q.stage_devices is None and "layers" in q.params  # left as it was


def test_pp_forward_runs_each_stage_on_its_current_device(monkeypatch):
    """The hand-written kernels launch on the current CUDA device, so a stage's
    layers run with the stage's device made current (a torch.cuda.device
    context for a card, none for the CPU), and the logits stay the unstaged
    runtime's."""
    from umbrella_tpu_torch.parallel import pipeline

    ctx = pipeline._current_device(torch.device("cuda", 2))
    assert isinstance(ctx, torch.cuda.device) and ctx.idx == 2
    assert isinstance(pipeline._current_device(torch.device(CPU)), contextlib.nullcontext)
    entered, layers_seen = [], []
    real_layer = pipeline.llama_layer

    @contextlib.contextmanager
    def record(device):
        entered.append(device)
        yield
        entered.append(None)

    def layer(*a, **k):
        layers_seen.append(len(entered))
        return real_layer(*a, **k)

    monkeypatch.setattr(pipeline, "_current_device", record)
    monkeypatch.setattr(pipeline, "llama_layer", layer)
    whole = _port_runtime("dense", 0)
    staged = shard_runtime_pp(_port_runtime("dense", 0), [CPU, CPU])
    S = len(PROMPT)
    args = (_t(PROMPT), torch.arange(S), masks.causal_mask_rows(0, S, MAX_LEN), 0)
    got, _ = staged.forward(staged.params, staged.init_kv(), *args)
    assert entered == [torch.device(CPU), None] * 2 and layers_seen == [1, 1, 3, 3]
    want, _ = whole.forward(whole.params, whole.init_kv(), *args)
    assert torch.equal(got, want)


def test_parallel_and_offload_exclusivity():
    """As in the JAX package: tensor / pipeline / expert parallel are mutually
    exclusive, and so are pipeline_parallel and offload (the JAX engine
    asserts both)."""
    rt = _port_runtime("dense", 2)
    base = dict(device=CPU, engine="static", model=rt, draft_model=rt,
                growmap=growmap_from_spec(3, 4))
    with pytest.raises(ValueError, match="mutually exclusive"):
        AutoEngine.from_config(pipeline_parallel=2, tensor_parallel=2, **base)
    with pytest.raises(ValueError, match="offload"):
        AutoEngine.from_config(pipeline_parallel=2, offload=True, **base)
    eng = AutoEngine.from_config(tensor_parallel=2, **base)
    with pytest.raises(ValueError, match="packed"):  # tensor parallelism: tests/test_torch_tp.py
        eng.initialize()
    jrt = _jax_runtime("dense", 2)
    for kw in (dict(pipeline_parallel=2, tensor_parallel=2),
               dict(pipeline_parallel=2, offload=True)):
        jeng = JaxStaticEngine(jrt, jrt, growmap=jax_growmap_from_spec(3, 4), **kw)
        with pytest.raises(AssertionError):
            jeng.initialize()


def test_pipeline_needs_a_card_per_stage_unless_staged(monkeypatch):
    """pipeline_parallel=4 on a host with one card raises before any model is
    loaded; a target the caller staged keeps its stages (here four on one
    device), and a staged target of another stage count raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rt = _port_runtime("dense", 2)
    eng = StaticEngine(rt, rt, growmap=growmap_from_spec(3, 4), device="cuda:0",
                       pipeline_parallel=4, max_length=MAX_LEN)
    with pytest.raises(ValueError, match="needs 4 CUDA devices from cuda:0, have 1"):
        eng.initialize()
    staged = shard_runtime_pp(_port_runtime("dense", 2), [CPU] * 4)
    stages = staged.params["stages"]
    eng = _port_engine(staged, _port_runtime("dense", 1), pipeline_parallel=4)
    assert eng.target_model.params["stages"] is stages
    with pytest.raises(ValueError, match="staged in 4 stages"):
        _port_engine(staged, _port_runtime("dense", 1), pipeline_parallel=2)


# ------------------------------------------------------------------ stochastic verify


def test_verify_tail_stochastic_chi_square():
    """The stochastic branch of verify_tail (one-node tree: the bonus token is
    the target's sample at the root) against the exact distribution from the
    JAX package's ops/sampling: repetition penalty over tokens[:num_nodes + 1]
    (both signs; a token past it stays unpenalized), top-k mask, temperature
    softmax, top-p renormalization. 2,500 draws; chi-square p > 1e-3; no draw
    outside the support."""
    V, nn, n = 64, 10, 2500
    temperature, topk, topp, penalty = 0.7, 16, 0.8, 1.3
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((1, V)) * 2.0).astype(np.float32)
    order = np.argsort(-logits[0])
    tokens = rng.integers(0, V, size=32).astype(np.int32)
    tokens[[2, 5]] = order[[0, 3]]  # in the penalized prefix: the top logits
    tokens[7] = int(np.argmin(logits[0]))  # a negative logit, penalized upward
    tokens[nn + 2] = order[1]  # past num_nodes + 1: must stay unpenalized
    lj = jax_sampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(tokens), nn + 1,
                                               penalty)
    probs = jax.nn.softmax(jax_sampling.apply_topk_mask(lj, topk) / temperature, axis=-1)
    p = np.asarray(jax_sampling.top_p_renorm_probs(probs, topp), np.float64)[0]

    kv = KVCache(k=torch.zeros(1, 1, 32, 4), v=torch.zeros(1, 1, 32, 4))
    one = dict(bitmap=torch.ones(1, 1, dtype=torch.bool), parents=torch.zeros(1, dtype=torch.long),
               node_in_path=torch.ones(1, dtype=torch.long), eos_arr=torch.tensor([-1]))
    gen = torch.Generator().manual_seed(0)
    tok = _t(tokens)
    counts = np.zeros(V)
    for _ in range(n):
        alen, _, block = verify_tail(
            _t(logits), kv, kv, tok, nn, one["bitmap"], one["parents"], one["node_in_path"],
            one["eos_arr"], tree_size=1, greedy=False, use_pen=True, generator=gen,
            temperature=temperature, topp=topp, penalty=penalty, topk=topk)
        assert int(alen) == 1
        counts[int(block[1])] += 1
    support = p > 0
    assert counts[~support].sum() == 0
    assert 2 <= support.sum() <= topk
    _, pval = stats.chisquare(counts[support], p[support] * n)
    assert pval > 1e-3, (pval, counts[support], p[support] * n)
    # the greedy branch takes the argmax of the penalized logits
    _, _, block = verify_tail(_t(logits), kv, kv, tok, nn, one["bitmap"], one["parents"],
                              one["node_in_path"], one["eos_arr"], tree_size=1, use_pen=True,
                              penalty=penalty)
    assert int(block[1]) == int(np.argmax(np.asarray(lj)[0]))


def test_stochastic_staged_and_unstaged_engines_agree():
    """Temperature 0.6, top-p 0.9, repetition penalty 1.05: with one seed the
    staged and unstaged engines draw the same tokens (same logits, same
    generator stream); a second request draws on from the stream."""
    kw = dict(temperature=0.6, topp=0.9, repetition_penalty=1.05, topk=32, seed=7)
    cfg = ModelConfig(**SMALL)

    def target():
        return auto_model.random_awq_runtime(cfg, MAX_LEN, dtype=torch.float32, seed=2,
                                             group_size=32, device=CPU)

    draft = auto_model.random_runtime(cfg, MAX_LEN, dtype=torch.float32, seed=1, device=CPU)
    unstaged = _port_engine(target(), draft, **kw)
    staged = _port_engine(target(), draft, pipeline_parallel=2, **kw)
    a = unstaged.generate(input_ids=PROMPT.tolist(), max_new_tokens=16)["generated_tokens"]
    b = staged.generate(input_ids=PROMPT.tolist(), max_new_tokens=16)["generated_tokens"]
    assert len(a) >= 16 and a == b
    again = staged.generate(input_ids=PROMPT.tolist(), max_new_tokens=16)["generated_tokens"]
    assert again[0] == a[0] and again != a  # prefill's token is the argmax either way


def test_pp4_config_accepted_with_random_stand_ins():
    """configs/chat_config_70b_awq_pp4.json as shipped (pipeline_parallel 4,
    temperature 0.6, top-p 0.9, repetition penalty 1.05, 24x6 tree,
    max_length 8192), with small random runtimes in place of the 70B target
    and the 8B draft: the engine stages the target in four stages and
    generates."""
    with open(os.path.join(REPO, "configs", "chat_config_70b_awq_pp4.json")) as f:
        cfg = json.load(f)
    L = cfg["max_length"]
    mc = ModelConfig(**dict(SMALL, max_position_embeddings=L))
    target = auto_model.random_awq_runtime(mc, L, dtype=torch.float32, seed=3, group_size=32,
                                           device=CPU)
    draft = auto_model.random_runtime(mc, L, dtype=torch.float32, seed=4, device=CPU)
    cfg.update(model=target, draft_model=draft, growmap_path=os.path.join(
        REPO, "umbrella_tpu_torch", "trees", os.path.basename(cfg["growmap_path"])))
    eng = AutoEngine.from_config(device=CPU, dtype=torch.float32, **cfg)
    eng.initialize()
    assert eng.target_model.stage_devices == (torch.device(CPU),) * 4
    assert (eng.temperature, eng.topp, eng.repetition_penalty, eng.topk, eng.tree_size) == \
        (0.6, 0.9, 1.05, 32, GrowMap.from_json(cfg["growmap_path"]).size)
    out = eng.generate(input_ids=PROMPT.tolist(), max_new_tokens=8)
    toks = out["generated_tokens"]
    assert len(toks) >= 8 and all(0 <= t < SMALL["vocab_size"] for t in toks)


# ------------------------------------------------------------------ the step's segment plan

# the segments of a step over a target staged in 4 stages, by the stages' cards:
# (card, phase names, the values copied in from another card)
INPUTS = ("hidden", "pos", "mask", "nn")
COMPACT = ("path", "nn", "alen")
PLANS = {
    (0, 0, 0, 0): [(0, ["draft", "embed", "stage0", "stage1", "stage2", "stage3", "head",
                        "commit", "compact0", "compact1", "compact2", "compact3", "update"], ())],
    (0, 1, 2, 3): [(0, ["draft", "embed", "stage0"], ()), (1, ["stage1"], INPUTS),
                   (2, ["stage2"], INPUTS), (3, ["stage3"], INPUTS),
                   (0, ["head", "commit", "compact0"], ("hidden",)),
                   (1, ["compact1"], COMPACT), (2, ["compact2"], COMPACT),
                   (3, ["compact3"], COMPACT), (0, ["update"], ())],
    (0, 0, 1, 1): [(0, ["draft", "embed", "stage0", "stage1"], ()),
                   (1, ["stage2", "stage3"], INPUTS),
                   (0, ["head", "commit", "compact0", "compact1"], ("hidden",)),
                   (1, ["compact2", "compact3"], COMPACT), (0, ["update"], ())],
}


def _on_cards(phases, cards):
    """The phases with stage s's phases (its layers, its compaction) on
    cuda:cards[s] and the rest on cuda:cards[0] (no card is touched)."""
    def card(name):
        s = name[-1] if name.startswith(("stage", "compact")) else "0"
        return torch.device("cuda", cards[int(s)])

    return [ph._replace(device=card(ph.name)) for ph in phases]


def _run_plan_per_card(phases, plan):
    """Run the CPU phases in the order of a plan over cards, each card
    reading only what its own segments wrote and what the plan copies in
    (a clone, as a graphed step copies into a static buffer): a value the
    plan fails to copy is missing or stale."""
    by_name = {ph.name: ph for ph in phases}
    ctx, last = {}, {}  # card -> its values; value -> the card that last wrote it
    for seg in plan:
        own = ctx.setdefault(seg.device, {})
        local = {k: ctx[last[k]][k].clone() for k in seg.hops}
        for ph in seg.phases:
            fn = by_name[ph.name]
            out = fn.fn(*(local[k] if k in local else own[k] for k in fn.inputs))
            out = (out,) if len(fn.outputs) == 1 else (out or ())
            for k, v in zip(fn.outputs, out, strict=True):
                local[k] = own[k] = v
                last[k] = seg.device
    return ctx[plan[-1].device]["result"]


@pytest.mark.parametrize("cards", list(PLANS))
def test_step_plan_cuts_at_each_change_of_card(cards):
    """The graphed step's segment plan (cuda_graphs.plan_segments, a pure
    function) for a 4-stage target whose stages sit on `cards`: one graph on
    one card; across cards the draft, embedding and first stages, each run
    of stages, the head and the tail, each card's compaction, then the state
    update, with the hidden state, positions, mask and offset copied to each
    stage's card, the hidden state back, and the path, offset and accept
    length to each compaction. Run in that order (stochastic, repetition
    penalty), each card reading only its own values and the copies, three
    steps equal the unsplit step and `_decode_step` bit for bit: tokens,
    loop state, both KV caches, and each step's packed result."""
    from test_torch_decode_loop import engine_state, unsplit_step

    kw = dict(temperature=0.8, repetition_penalty=1.2, seed=3)
    engines = [_port_engine(_port_runtime("dense", 2), _port_runtime("dense", 1),
                            pipeline_parallel=4, **kw) for _ in range(3)]
    for e in engines:
        assert e._prefill(PROMPT)
        for k, v in (("nn", e.num_nodes), ("start", e.num_nodes), ("max_new", 64),
                     ("cont", True)):
            e._loop[k].fill_(v)
    plan = plan_segments(_on_cards(engines[0]._step_phases(False, True), cards))
    assert [(seg.device.index, [ph.name for ph in seg.phases], seg.hops) for seg in plan] == \
        [(c, names, tuple(hops)) for c, names, hops in PLANS[cards]]
    assert not any(seg.eager for seg in plan)
    for _ in range(3):
        results = [_run_plan_per_card(engines[0]._step_phases(False, True), plan),
                   engines[1]._decode_step(False, True), unsplit_step(engines[2], False, True)]
        assert all(torch.equal(r, results[2]) for r in results)
        states = [engine_state(e) for e in engines]
        assert all(torch.equal(a, b) for st in states[:2] for a, b in zip(st, states[2]))
    assert int(engines[2]._loop["nn"]) >= len(PROMPT) + 3  # three live steps


def test_a_captured_step_takes_no_outside_values():
    """StepGraph.capture refuses a phase that reads a value no phase before
    it writes (a graph could not follow it), before it touches a card."""
    read = Phase("reads_x", torch.device(CPU), lambda x: x, ("x",), ("y",))
    with pytest.raises(ValueError, match=r"reads_x reads \['x'\]"):
        StepGraph.capture([read], {})
