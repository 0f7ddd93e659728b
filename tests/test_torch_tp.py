"""The port's tensor parallelism (parallel/mesh.py, parallel/collectives.py,
quantization/awq.repack_row_shards, the engines' `tensor_parallel`) against the
JAX package on the CPU.

The JAX side shards over the first m of tests/conftest.py's 8 virtual CPU
devices and runs its shard_map forward; the port puts every shard on the CPU
(["cpu"] * m). Weights are the JAX package's random params (packed=False; AWQ
per-layer tensors quantized with its own quantize_matrix, group 16) carried
across with params_from_numpy, or tiny HF checkpoints written with
save_pretrained. Tolerances: fp32 logits within 1e-5 x max|logit| of JAX's
sharded forward and of the port's unsharded forward (the partials are summed
in another order); each shard's KV within 1e-5 of JAX's kv-head slice; the
row repack bit for bit; greedy tokens identical.
"""
import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.models import gemma as jax_gemma
from umbrella_tpu.models import llama as jax_llama
from umbrella_tpu.ops.masks import causal_mask_rows as jax_causal_mask_rows
from umbrella_tpu.parallel import mesh as jax_mesh
from umbrella_tpu.quantization import awq as jax_awq
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.serving.batched_engine import BatchedStaticEngine as JaxBatchedEngine
from umbrella_tpu.speculation.auto_engine import AutoEngine as JaxAutoEngine
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.cuda_graphs import plan_segments
from umbrella_tpu_torch.models import auto_model
from umbrella_tpu_torch.models.convert import runtime_from_numpy
from umbrella_tpu_torch.models.kv_cache import ShardedKVCache
from umbrella_tpu_torch.ops import masks
from umbrella_tpu_torch.parallel import collectives, mesh
from umbrella_tpu_torch.quantization import awq
from umbrella_tpu_torch.quantization.awq import AwqTensor
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
from umbrella_tpu_torch.speculation.static_engine import StaticEngine

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TREE = os.path.join(REPO, "umbrella_tpu", "trees", "sequoia_tree-3x4.json")
PORT_TREE = os.path.join(REPO, "umbrella_tpu_torch", "trees", "sequoia_tree-3x4.json")
MAX_LEN = 128
CPU = "cpu"
G = 16
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=MAX_LEN,
             rope_theta=10000.0, tie_word_embeddings=False, eos_token_id=-1)
PROMPT = [1, 9, 23, 7, 51, 3, 88, 14, 30]
QUANTIZED = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max(), rtol=0)


def _jax_params(kind, seed, group=G, **cfg_kw):
    """The JAX package's random unpacked llama params (fp32), with kind "awq"
    each linear layer quantized per layer (`group`) into AwqTensor tuples."""
    cfg = JaxConfig(**dict(SMALL, **cfg_kw))
    params = jax_llama.init_llama_params(cfg, jax.random.PRNGKey(seed), MAX_LEN, jnp.float32,
                                         packed=False)
    if kind == "awq":
        layers = dict(params["layers"])
        for k in QUANTIZED:
            w = np.asarray(layers[k])
            layers[k] = tuple(jax_awq.pack_tpu_layout(*jax_awq.quantize_matrix(w[i], group),
                                                      dtype=jnp.float32)
                              for i in range(w.shape[0]))
        params = dict(params, layers=layers)
    return cfg, params


def _port_runtime(cfg, params, family="llama"):
    return runtime_from_numpy(_np(params), cfg, MAX_LEN, family=family)


# ------------------------------------------------------------------ row repack


@pytest.mark.parametrize("m", [2, 4])
def test_repack_row_shards_matches_jax(m):
    """The repacked bytes equal the JAX package's bit for bit, and each row
    shard (w8 block s, group block s) dequantizes to block s of the whole
    weight's rows, exactly."""
    w = np.random.default_rng(m).standard_normal((256, 96)).astype(np.float32)
    jq = jax_awq.pack_tpu_layout(*jax_awq.quantize_matrix(w, 32), dtype=jnp.float32)
    q = AwqTensor(*(_t(np.asarray(getattr(jq, f))) for f in AwqTensor._fields))
    rep = awq.repack_row_shards(q, m)
    assert torch.equal(rep.w8, _t(np.asarray(jax_awq.repack_row_shards(jq, m).w8)))
    assert rep.scales is q.scales and rep.zeros is q.zeros
    whole = awq.dequantize(q, torch.float32)
    for s in range(m):
        shard = mesh._rows(rep, m, s)
        assert shard.k == 256 // m and shard.group_size == 32
        assert torch.equal(awq.dequantize(shard, torch.float32),
                           whole[s * 256 // m:(s + 1) * 256 // m])
    assert awq.repack_row_shards(q, 1) is q
    with pytest.raises(ValueError, match="divisible"):
        awq.repack_row_shards(q, 3)


# ------------------------------------------------------------------ the sharded forward


@functools.lru_cache(maxsize=None)
def _jax_tp_forward(kind, m):
    """The JAX package's TP runtime over m virtual devices: a 9-token prefill,
    then 4 rows at offset 9; (logits, logits, global KV k, v)."""
    cfg, params = _jax_params(kind, seed=3)
    rt = jax_auto.ModelRuntime(cfg, params, MAX_LEN, dtype=jnp.float32)
    jax_mesh.shard_runtime(rt, jax_mesh.make_mesh(model=m))
    kv = rt.init_kv()
    fwd = jax.jit(rt.forward)
    out = []
    for ids, off in ((PROMPT, 0), ([4, 71, 2, 60], len(PROMPT))):
        S = len(ids)
        logits, kv = fwd(rt.params, kv, jnp.asarray(ids, jnp.int32), jnp.arange(off, off + S),
                         jax_causal_mask_rows(off, S, MAX_LEN), jnp.int32(off))
        out.append(np.asarray(logits))
    return out[0], out[1], np.asarray(kv.k), np.asarray(kv.v)


def _port_forwards(rt, kv):
    out = []
    for ids, off in ((PROMPT, 0), ([4, 71, 2, 60], len(PROMPT))):
        S = len(ids)
        logits, kv = rt.forward(rt.params, kv, torch.tensor(ids), torch.arange(off, off + S),
                                masks.causal_mask_rows(off, S, MAX_LEN), off)
        out.append(logits)
    return out


@pytest.mark.parametrize("kind", ["fp", "awq"])
@pytest.mark.parametrize("m", [2, 4])
def test_tp_forward_matches_jax_shard_map(kind, m):
    """The port's TP forward on ["cpu"] * m against JAX's tp_shard_map_forward
    on m devices: logits of a prefill and of a 4-row step within 1e-5 x
    max|logit|, each shard's cache equal to JAX's kv-head slice within 1e-5,
    and the logits within 1e-5 of the port's unsharded forward."""
    want0, want1, jk, jv = _jax_tp_forward(kind, m)
    cfg, params = _jax_params(kind, seed=3)
    whole = _port_runtime(cfg, params)
    ref = _port_forwards(whole, whole.init_kv())
    rt = mesh.shard_runtime(_port_runtime(cfg, params), [CPU] * m)
    assert rt.shard_devices == (torch.device(CPU),) * m and not rt.spans_cards
    kv = rt.init_kv()
    assert isinstance(kv, ShardedKVCache) and len(kv.shards) == m
    got0, got1 = _port_forwards(rt, kv)
    _close_to(got0, want0)
    _close_to(got1, want1)
    _close_to(got0, ref[0])
    _close_to(got1, ref[1])
    h = SMALL["num_key_value_heads"] // m
    for s, cache in enumerate(kv.shards):
        assert cache.k.shape == (2, h, MAX_LEN, 16)
        np.testing.assert_allclose(cache.k.numpy(), jk[:, s * h:(s + 1) * h], atol=1e-5)
        np.testing.assert_allclose(cache.v.numpy(), jv[:, s * h:(s + 1) * h], atol=1e-5)


def test_shard_runtime_layout():
    """Column entries cut on their output axis, row entries on their input
    rows (AWQ repacked, whole groups), the vocab-sharded head and the
    replicated rest on the first device; each shard's AWQ entry dequantizes
    to its block of the whole weight."""
    cfg, params = _jax_params("awq", seed=5)
    whole = _port_runtime(cfg, params)
    rt = mesh.shard_runtime(_port_runtime(cfg, params), [CPU, CPU])
    assert set(rt.params["layers"]) == {"input_norm", "post_norm"}
    assert "lm_head" not in rt.params
    shards = rt.params["tp_shards"]
    for s, sh in enumerate(shards):
        assert sh.lm_head.shape == (64, 64)
        assert torch.equal(sh.lm_head, whole.params["lm_head"][:, s * 64:(s + 1) * 64])
        for i in range(2):
            wq = awq.dequantize(sh.layers["wq"][i], torch.float32)
            full = awq.dequantize(whole.params["layers"]["wq"][i], torch.float32)
            assert torch.equal(wq, full[:, s * 32:(s + 1) * 32])
            down = awq.dequantize(sh.layers["down"][i], torch.float32)
            full = awq.dequantize(whole.params["layers"]["down"][i], torch.float32)
            assert torch.equal(down, full[s * 64:(s + 1) * 64])


def test_collectives_sum_in_shard_order_and_round_once():
    """all_reduce adds the partials in shard order in fp32 and rounds once
    (bf16 partials summed in bf16 would round after each add); broadcast
    makes one copy a device and none where a device repeats; all_gather
    concatenates on the last axis."""
    parts = [torch.tensor([1.0, 2 ** -9], dtype=torch.float32),
             torch.tensor([0.75 * 2 ** -8, 0.0]), torch.tensor([0.75 * 2 ** -8, 1.0])]
    got = collectives.all_reduce(parts, torch.device(CPU), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (parts[0] + parts[1] + parts[2]).to(torch.bfloat16))
    assert got[0] != (parts[0].bfloat16() + parts[1].bfloat16() + parts[2].bfloat16())[0]
    x = torch.ones(3)
    assert all(c is x for c in collectives.broadcast(x, [torch.device(CPU)] * 3))
    assert collectives.broadcast(7, [CPU, CPU]) == [7, 7]
    cat = collectives.all_gather([torch.zeros(2, 3), torch.ones(2, 2)], torch.device(CPU))
    assert cat.shape == (2, 5) and torch.equal(cat[:, 3:], torch.ones(2, 2))


# ------------------------------------------------------------------ engines from checkpoints


def _write_fp_dir(root, name, seed, heads=4, kv_heads=4):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=heads, num_key_value_heads=kv_heads, max_position_embeddings=512,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False, attention_bias=False,
        eos_token_id=-1)).eval()
    d = os.path.join(root, name)
    model.save_pretrained(d, safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """fp target and draft directories (heads 4, kv heads 4), an AutoAWQ
    target (hidden 128, kv heads 2, group 64) and its fp draft (kv heads 2)."""
    from test_checkpoint_load import _write_awq_dir

    root = str(tmp_path_factory.mktemp("tp"))
    awq_dir = os.path.join(root, "target_awq")
    os.makedirs(awq_dir)
    _write_awq_dir(awq_dir, JaxConfig(
        vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=MAX_LEN,
        eos_token_id=-1, tie_word_embeddings=False))
    return dict(fp=(_write_fp_dir(root, "target", 0), _write_fp_dir(root, "draft", 1)),
                awq=(awq_dir, _write_fp_dir(root, "draft_kv2", 2, kv_heads=2)))


def _engine_config(engine, target, draft, tree_path):
    tree = dict(width=4, num_beams=6, depth=4) if engine == "dynamic" else dict(
        growmap_path=tree_path)
    return dict(model=target, draft_model=draft, engine=engine, max_length=MAX_LEN,
                safe_buffer=16, temperature=0.0, eos_token_ids=[-1], tokenizer=object(), **tree)


def _decode(eng, steps=4):
    eng.initialize()
    assert eng._prefill(np.asarray(PROMPT, np.int32))
    start = eng.num_nodes
    for _ in range(steps):
        eng.build_tree()
        eng.verify()
    return eng, eng.tokens_host[start:eng.num_nodes].tolist()


@pytest.mark.parametrize("engine,kind,tp", [("static", "fp", 4), ("static", "awq", 2),
                                            ("dynamic", "fp", 2)])
def test_tp_engine_from_checkpoints_matches_jax_and_unsharded(ckpt_dirs, engine, kind, tp):
    """`tensor_parallel` in a config over checkpoint directories (the port of
    tests/test_tp_config.py): the target loads unpacked and is sharded on
    tp CPU shards, the draft stays whole; greedy tokens equal JAX's TP
    engine's and the port's unsharded engine's."""
    target, draft = ckpt_dirs[kind]
    _, want = _decode(JaxAutoEngine.from_config(
        **_engine_config(engine, target, draft, JAX_TREE), dtype=jnp.float32,
        draft_topk_recall=1.0, tensor_parallel=tp))
    port = dict(_engine_config(engine, target, draft, PORT_TREE), dtype=torch.float32,
                device=CPU, draft_topk_recall=1.0)
    eng, got = _decode(AutoEngine.from_config(**port, tensor_parallel=tp))
    assert eng.target_model.shard_devices == (torch.device(CPU),) * tp
    assert "wq" in eng.target_model.params["tp_shards"][0].layers
    assert eng.draft_model.shard_devices is None
    assert isinstance(eng.kv_target, ShardedKVCache)
    if kind == "awq":
        assert isinstance(eng.target_model.params["tp_shards"][0].layers["wo"][0], AwqTensor)
    _, ref = _decode(AutoEngine.from_config(**port))
    assert got == want == ref
    assert len(got) >= 4


# ------------------------------------------------------------------ the batched engine


@functools.lru_cache(maxsize=None)
def _batched_runtimes():
    """(target, draft) JAX params of tests/test_batched_tp.py's sizes (kv heads 2)."""
    return _jax_params("fp", 0, num_key_value_heads=2), _jax_params("fp", 1, num_key_value_heads=2)


REQUESTS = [dict(input_ids=[1, 9, 23, 7], max_new_tokens=12),
            dict(input_ids=[5, 2, 61, 11, 30], max_new_tokens=12),
            dict(input_ids=[17, 3], max_new_tokens=8)]


def _jax_batched_run(tp, kv_dtype, family="llama"):
    if family == "gemma2":
        models = _gemma_models()[0]
    else:
        (tc, tp_), (dc, dp) = _batched_runtimes()
        models = (jax_auto.ModelRuntime(tc, tp_, MAX_LEN, dtype=jnp.float32),
                  jax_auto.ModelRuntime(dc, dp, MAX_LEN, dtype=jnp.float32))
    eng = JaxBatchedEngine(draft_model_name=models[1], target_model_name=models[0],
                           batch_size=2, dtype=jnp.float32, growmap=jax_growmap_from_spec(3, 4),
                           max_length=MAX_LEN, eos_token_ids=[-1], tokenizer=None,
                           safe_buffer=16, segment_steps=4, kv_dtype=kv_dtype,
                           tensor_parallel=tp, draft_topk_recall=1.0)
    eng.initialize()
    return [r["generated_tokens"] for r in eng.run([dict(r) for r in REQUESTS])]


def _port_batched(tp, kv_dtype, family="llama", **kw):
    if family == "gemma2":
        models = _gemma_models()[1]()
    else:
        (tc, tp_), (dc, dp) = _batched_runtimes()
        models = (_port_runtime(tc, tp_), _port_runtime(dc, dp))
    eng = AutoEngine.from_config(device=CPU, engine="batched_static", model=models[0],
                                 draft_model=models[1], batch_size=2, dtype=torch.float32,
                                 growmap=growmap_from_spec(3, 4), max_length=MAX_LEN,
                                 eos_token_ids=[-1], safe_buffer=16, segment_steps=4,
                                 kv_dtype=kv_dtype, tensor_parallel=tp, draft_topk_recall=1.0,
                                 **kw)
    eng.initialize()
    return eng


def _port_batched_run(tp, kv_dtype, family="llama"):
    eng = _port_batched(tp, kv_dtype, family)
    return eng, [r["generated_tokens"] for r in eng.run([dict(r) for r in REQUESTS])]


HF_GEMMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                max_position_embeddings=512, rms_norm_eps=1e-6, rope_theta=10000.0,
                attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                query_pre_attn_scalar=24, sliding_window=8, tie_word_embeddings=True,
                attn_implementation="eager")


@functools.lru_cache(maxsize=None)
def _gemma_models():
    """(JAX target, JAX draft), a maker of (port target, port draft): two tiny
    HF Gemma2 models (seeds 0 and 1) with a sliding window of 8."""
    from transformers import Gemma2Config, Gemma2ForCausalLM

    out = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        model = Gemma2ForCausalLM(Gemma2Config(**HF_GEMMA)).eval()
        sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
        cfg = JaxConfig.from_dict(model.config.to_dict())
        out.append((cfg, jax_gemma.gemma_params_from_hf_state_dict(sd, cfg, MAX_LEN,
                                                                   dtype=jnp.float32)))
    jax_models = tuple(jax_auto.ModelRuntime(c, p, MAX_LEN, dtype=jnp.float32, family="gemma2")
                       for c, p in out)
    return jax_models, lambda: tuple(_port_runtime(c, p, "gemma2") for c, p in out)


@pytest.mark.parametrize("family,kv_dtype", [("llama", None), ("llama", "int8"),
                                             ("gemma2", None), ("gemma2", "int8")])
def test_tp_batched_engine_matches_jax_and_unsharded(family, kv_dtype):
    """The batched engine with tensor_parallel=2 (the port of
    tests/test_batched_tp.py and test_gemma.py's batched TP check): run()'s
    tokens for 3 requests on 2 slots equal JAX's TP batched engine's and the
    port's unsharded batched engine's, fp32, with an fp32 and an int8 KV
    cache (its per-slot scales on each shard's kv heads). Gemma2 sums the row
    partials before its post norms."""
    want = _jax_batched_run(2, kv_dtype, family)
    eng, got = _port_batched_run(2, kv_dtype, family)
    assert isinstance(eng.kv_target, ShardedKVCache) and len(eng.kv_target.shards) == 2
    assert all(c.k.shape[2] == 1 and c.quantized == (kv_dtype == "int8")
               for c in eng.kv_target.shards)
    assert eng.draft_model.shard_devices is None
    _, ref = _port_batched_run(0, kv_dtype, family)
    assert got == want == ref
    assert all(len(t) >= 8 for t in got)


def test_tp_batched_step_matches_unsharded():
    """step() (one read a step) on the sharded batched engine commits the
    unsharded engine's tokens slot by slot."""
    def drive(tp):
        eng = _port_batched(tp, None)
        assert eng.admit(0, [1, 9, 23, 7]) and eng.admit(1, [5, 2, 61, 11, 30])
        starts = [int(eng.num_nodes[b]) for b in range(2)]
        for _ in range(3):
            eng.step()
        return [eng.tokens_host[b, starts[b]:int(eng.num_nodes[b])].tolist() for b in range(2)]

    got = drive(2)
    assert got == drive(0) and all(len(t) >= 3 for t in got)


# ------------------------------------------------------------------ phases and refusals


def test_tp_forward_phase_is_eager_only_across_cards():
    """The sharded forward is one phase of the step: captured with the step
    where every shard is on the runtime's device, eager where they span
    cards (the step then cuts around it)."""
    cfg, params = _jax_params("fp", 0)
    rt = mesh.shard_runtime(_port_runtime(cfg, params), [CPU, CPU])
    (ph,) = rt.forward_phases(rt.init_kv())
    assert ph.name == "forward" and not ph.eager
    rt.params["tp_shards"] = tuple(sh._replace(device=torch.device("cuda", s))
                                   for s, sh in enumerate(rt.params["tp_shards"]))
    assert rt.spans_cards
    (ph,) = rt.forward_phases(None)
    assert ph.eager and ph.device == torch.device(CPU)
    plan = plan_segments([ph._replace(name="draft", eager=False), ph])
    assert [s.eager for s in plan] == [False, True]


def test_refusals():
    """As in the JAX package: a packed target, heads / kv heads / quant groups
    that do not divide, offload with TP, TP with EP in the batched engine, a
    batched MoE target with TP, a single-slot Gemma2 TP forward, and a
    sharded target of another shard count."""
    cfg, params = _jax_params("fp", 0)
    packed = auto_model.random_runtime(ModelConfig(**SMALL), MAX_LEN, device=CPU)
    with pytest.raises(ValueError, match="packed"):
        mesh.shard_runtime(packed, [CPU, CPU])
    with pytest.raises(ValueError, match="num_attention_heads=4 must be divisible"):
        mesh.shard_runtime(_port_runtime(cfg, params), [CPU] * 3)
    cfg2, params2 = _jax_params("fp", 0, num_key_value_heads=2)
    with pytest.raises(ValueError, match="num_key_value_heads=2 must be divisible"):
        mesh.shard_runtime(_port_runtime(cfg2, params2), [CPU] * 4)
    cfg3, params3 = _jax_params("awq", 0, group=32)  # wo: 64 rows, 2 groups
    with pytest.raises(ValueError, match=r"quant-group count \(2\)"):
        mesh.shard_runtime(_port_runtime(cfg3, params3), [CPU] * 4)
    rt = mesh.shard_runtime(_port_runtime(cfg, params), [CPU, CPU])
    with pytest.raises(ValueError, match="already"):
        mesh.shard_runtime(rt, [CPU, CPU])
    base = dict(device=CPU, model=rt, draft_model=_port_runtime(cfg, params),
                growmap=growmap_from_spec(3, 4), max_length=MAX_LEN)
    with pytest.raises(ValueError, match="mutually exclusive"):
        AutoEngine.from_config(engine="static", tensor_parallel=2, offload=True, **base)
    with pytest.raises(ValueError, match="mutually exclusive"):
        AutoEngine.from_config(engine="batched_static", tensor_parallel=2, expert_parallel=2,
                               **base)
    eng = AutoEngine.from_config(engine="static", tensor_parallel=4, **base)
    with pytest.raises(ValueError, match="sharded in 2 shards, tensor_parallel=4"):
        eng.initialize()
    jax_models, port_models = _gemma_models()
    g_target, g_draft = port_models()
    eng = AutoEngine.from_config(engine="static", device=CPU, model=g_target, draft_model=g_draft,
                                 growmap=growmap_from_spec(3, 4), max_length=MAX_LEN,
                                 safe_buffer=16, dtype=torch.float32, tensor_parallel=2)
    with pytest.raises(NotImplementedError, match="single-slot TP gemma2"):
        eng.initialize()
        eng._prefill(np.asarray(PROMPT, np.int32))
    jeng = JaxAutoEngine.from_config(engine="static", model=jax_models[0],
                                     draft_model=jax_models[1],
                                     growmap=jax_growmap_from_spec(3, 4), max_length=MAX_LEN,
                                     dtype=jnp.float32, tensor_parallel=2, eos_token_ids=[-1],
                                     safe_buffer=16, tokenizer=object())
    with pytest.raises(NotImplementedError, match="single-slot TP gemma2"):
        jeng.initialize()
        jeng._prefill(np.asarray(PROMPT, np.int32))


def test_refuses_moe_tensor_parallel():
    """A batched MoE target shards its experts, not its tensors."""
    from umbrella_tpu_torch.models import moe

    mcfg = ModelConfig(**dict(SMALL, model_type="mixtral", num_local_experts=4))
    params = moe.init_moe_llama_params(mcfg, torch.Generator().manual_seed(0), 4)
    target = moe.moe_runtime(mcfg, params, MAX_LEN, device=CPU)
    eng = AutoEngine.from_config(device=CPU, engine="batched_static", model=target,
                                 draft_model=target, growmap=growmap_from_spec(3, 4),
                                 max_length=MAX_LEN, tensor_parallel=2)
    with pytest.raises(ValueError, match="batched MoE shards experts"):
        eng.initialize()
    with pytest.raises(ValueError, match="shards its experts"):
        mesh.shard_runtime(target, [CPU, CPU])


@pytest.mark.parametrize("engine", ["static", "batched_static"])
def test_fewer_cards_than_shards_raise_unless_sharded(monkeypatch, engine):
    """tensor_parallel=4 on a host with one card raises a ValueError before
    any model is loaded (nothing puts every shard on one card unasked); a
    target the caller sharded (here four shards on one device) keeps its
    shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg, params = _jax_params("fp", 0)
    rt = _port_runtime(cfg, params)
    kw = dict(growmap=growmap_from_spec(3, 4), max_length=MAX_LEN, tensor_parallel=4)
    if engine == "static":
        eng = StaticEngine(rt, rt, device="cuda:0", **kw)
        with pytest.raises(ValueError, match="needs 4 CUDA devices from cuda:0, have 1"):
            eng.initialize()
    else:
        from umbrella_tpu_torch.serving.batched_engine import BatchedStaticEngine

        eng = BatchedStaticEngine(rt, rt, device="cuda:0", **kw)
        with pytest.raises(ValueError, match="needs 4 CUDA devices from cuda:0, have 1"):
            eng.initialize()
    monkeypatch.undo()
    sharded = mesh.shard_runtime(_port_runtime(cfg, params), [CPU] * 4)
    shards = sharded.params["tp_shards"]
    eng = AutoEngine.from_config(device=CPU, engine=engine, model=sharded,
                                 draft_model=_port_runtime(cfg, params), dtype=torch.float32,
                                 **kw)
    eng.initialize()
    assert eng.target_model.params["tp_shards"] is shards


def test_shards_run_on_their_current_device(monkeypatch):
    """The hand-written kernels launch on the current CUDA device: each
    shard's products run with its device made current."""
    from umbrella_tpu_torch.parallel import mesh as port_mesh

    entered = []

    @contextlib.contextmanager
    def record(device):
        entered.append(device)
        yield

    monkeypatch.setattr(port_mesh, "device_scope", record)
    cfg, params = _jax_params("fp", 0)
    rt = mesh.shard_runtime(_port_runtime(cfg, params), [CPU, CPU])
    S = len(PROMPT)
    rt.forward(rt.params, rt.init_kv(), torch.tensor(PROMPT), torch.arange(S),
               masks.causal_mask_rows(0, S, MAX_LEN), 0)
    # two row-parallel products a layer and the head, each shard in turn
    assert entered == [torch.device(CPU)] * (2 * (2 * 2) + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_mirror_holds_the_sharded_forward(dtype):
    """chip_smoke's reference for the AWQ cases of [tp-lossless]: the mirror
    (the unsharded forward, one cache over every kv head, over the shards'
    own products) gives the sharded forward's logits bit for bit and its
    engine the sharded engine's tokens; the shards reassemble the unsharded
    weights; both planted all_reduce faults part the logits from the
    mirror's."""
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    cfg = ModelConfig(**dict(SMALL, hidden_size=512, intermediate_size=1024,
                             num_attention_heads=8, max_position_embeddings=cs.MAX_LEN))
    target = cs.tp_target(torch, torch.device(CPU), cfg, dtype, 3, cs.MAX_LEN)
    sharded = cs.tp_copy(torch, target, [CPU] * 4)
    mirror = cs.tp_mirror(torch, sharded)
    assert cs.tp_layout_equal(torch, sharded, target)
    got = cs.tp_logits_against_mirror(torch, sharded, mirror, PROMPT)
    assert got["sharded"]["equal"]
    assert not got["bf16_per_add"]["equal"] and not got["dropped_partial"]["equal"]
    draft = auto_model.random_runtime(ModelConfig(**dict(SMALL, num_hidden_layers=1,
                                                         max_position_embeddings=cs.MAX_LEN)),
                                      cs.MAX_LEN, dtype=dtype, seed=7, device=CPU)
    toks = [cs.make_engine(torch, torch.device(CPU), rt, draft, dtype, **kw).generate(
        input_ids=PROMPT, max_new_tokens=12)["generated_tokens"]
        for rt, kw in ((sharded, dict(tensor_parallel=4)), (mirror, {}))]
    assert toks[0] == toks[1] and len(toks[0]) >= 12
