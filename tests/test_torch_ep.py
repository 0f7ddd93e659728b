"""The port's expert parallelism (models/moe.shard_runtime_ep, ShardedExperts,
the engines' `expert_parallel`) against the JAX package on the CPU.

The JAX side shards its MoE runtimes over an 'expert' mesh of the first m of
tests/conftest.py's 8 virtual CPU devices (GSPMD partitions the per-expert
einsums and inserts one psum for the combine); the port puts every shard on
the CPU (["cpu"] * m). Weights are the JAX package's `init_moe_llama_params`
(2 layers of 4 experts, top-2, hidden 64) carried across with
params_from_numpy, or a tiny HF Mixtral written with save_pretrained (the
port of tests/test_moe_config.py). Tolerances: fp32 logits within 1e-5 x
max|logit| of JAX's sharded forward and of the port's unsharded forward;
KV within 1e-5; greedy tokens identical.
"""
import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import moe as jax_moe
from umbrella_tpu.ops.masks import causal_mask_rows as jax_causal_mask_rows
from umbrella_tpu.speculation.auto_engine import AutoEngine as JaxAutoEngine
from umbrella_tpu_torch.models import auto_model, moe
from umbrella_tpu_torch.models.convert import runtime_from_numpy
from umbrella_tpu_torch.ops import masks
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
from umbrella_tpu_torch.speculation.static_engine import StaticEngine

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TREE = os.path.join(REPO, "umbrella_tpu", "trees", "sequoia_tree-3x4.json")
PORT_TREE = os.path.join(REPO, "umbrella_tpu_torch", "trees", "sequoia_tree-3x4.json")
MAX_LEN = 128
CPU = "cpu"
E = 4
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=MAX_LEN,
             rope_theta=10000.0, tie_word_embeddings=False, eos_token_id=-1,
             model_type="mixtral", num_local_experts=E, num_experts_per_tok=2)
PROMPT = [1, 17, 42, 9, 55, 3, 77]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_to(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def _params():
    cfg = JaxConfig(**SMALL)
    return cfg, jax_moe.init_moe_llama_params(cfg, jax.random.PRNGKey(0), E, jnp.float32)


def _port_runtime():
    cfg, params = _params()
    return runtime_from_numpy(_np(params), cfg, MAX_LEN, family="moe")


STEPS = ((PROMPT, 0), ([4, 71, 2, 60], len(PROMPT)))


@functools.lru_cache(maxsize=None)
def _jax_ep_forward(m):
    """JAX's shard_runtime_ep over m devices: a prefill and a 4-row step,
    jitted; (logits, logits, KV k)."""
    cfg, params = _params()
    rt = jax_moe.shard_runtime_ep(jax_moe.moe_runtime(cfg, params, MAX_LEN),
                                  Mesh(np.asarray(jax.devices()[:m]), ("expert",)))
    fwd, kv, out = jax.jit(rt.forward), rt.init_kv(), []
    for ids, off in STEPS:
        S = len(ids)
        logits, kv = fwd(rt.params, kv, jnp.asarray(ids, jnp.int32), jnp.arange(off, off + S),
                         jax_causal_mask_rows(off, S, MAX_LEN), jnp.int32(off))
        out.append(np.asarray(logits))
    return out[0], out[1], np.asarray(kv.k)


def _port_forwards(rt):
    kv, out = rt.init_kv(), []
    for ids, off in STEPS:
        S = len(ids)
        logits, kv = rt.forward(rt.params, kv, torch.tensor(ids), torch.arange(off, off + S),
                                masks.causal_mask_rows(off, S, MAX_LEN), off)
        out.append(logits)
    return out + [kv.k]


@pytest.mark.parametrize("m", [2, 4])
def test_ep_forward_matches_jax(m):
    """shard_runtime_ep on ["cpu"] * m: shard s holds experts [s*E/m,
    (s+1)*E/m) of every layer; the forward's logits (a prefill and a 4-row
    step) are within 1e-5 x max|logit| of JAX's EP runtime and of the port's
    unsharded forward, and the KV cache (unsharded, on the first device)
    within 1e-5 of JAX's."""
    want0, want1, jk = _jax_ep_forward(m)
    whole = _port_runtime()
    ref = _port_forwards(whole)
    rt = moe.shard_runtime_ep(_port_runtime(), [CPU] * m)
    assert rt.shard_devices == (torch.device(CPU),) * m and not rt.spans_cards
    sharded = rt.params["layers"]["expert_shards"]
    assert "expert_gate" not in rt.params["layers"]
    for s, sh in enumerate(sharded.shards):
        assert sh.gate.shape == (2, E // m, 64, 96) and sh.down.shape == (2, E // m, 96, 64)
        assert torch.equal(sh.up, whole.params["layers"]["expert_up"][:, s * E // m:
                                                                      (s + 1) * E // m])
    got0, got1, k = _port_forwards(rt)
    _close_to(got0, want0)
    _close_to(got1, want1)
    _close_to(got0, ref[0])
    _close_to(got1, ref[1])
    np.testing.assert_allclose(k.numpy(), jk, atol=1e-5)


def test_moe_mlp_over_shards_matches_unsharded():
    """moe_mlp on [2, 5, H] with a layer's ShardedExperts (2 shards): the
    combine of the shards' fp32 partials, rounded once, within 1e-6 of the
    unsharded dense dispatch; the aux loss is the same."""
    rt = _port_runtime()
    lw = {k: v[0] for k, v in rt.params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 5, 64)).astype(np.float32))
    want, want_aux = moe.moe_mlp(lw, x)
    ep = moe.shard_runtime_ep(_port_runtime(), [CPU, CPU])
    lw = {k: v[0] for k, v in ep.params["layers"].items()}
    got, aux = moe.moe_mlp(lw, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert float(aux) == float(want_aux)


def test_experts_run_on_their_shard_device(monkeypatch):
    """Each shard's experts run with its device made current (the ctypes
    kernels and the library launch on the current card)."""
    entered = []

    @contextlib.contextmanager
    def record(device):
        entered.append(device)
        yield

    monkeypatch.setattr(moe, "device_scope", record)
    rt = moe.shard_runtime_ep(_port_runtime(), [CPU] * 4)
    _port_forwards(rt)
    assert entered == [torch.device(CPU)] * (4 * 2 * 2)  # 4 shards, 2 layers, 2 forwards


# ------------------------------------------------------------------ engines from checkpoints


def _write_mixtral(root, name, seed):
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(seed)
    model = MixtralForCausalLM(MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=E,
        num_experts_per_tok=2, max_position_embeddings=512, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False, sliding_window=None,
        eos_token_id=-1)).eval()
    d = os.path.join(root, name)
    model.save_pretrained(d, safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """Two tiny HF Mixtral directories (target, MoE draft) and a dense llama
    draft (kv heads 2)."""
    from test_torch_tp import _write_fp_dir

    root = str(tmp_path_factory.mktemp("ep"))
    return dict(target=_write_mixtral(root, "target", 0), moe=_write_mixtral(root, "draft", 3),
                dense=_write_fp_dir(root, "dense", 1, kv_heads=2))


class _NoText:
    """A tokenizer stand-in for directories that ship none: run() decodes
    each result to text."""

    def decode(self, ids, **kw):
        return ""


def _config(ckpt_dirs, draft, engine, tree_path, **kw):
    return dict(model=ckpt_dirs["target"], draft_model=ckpt_dirs[draft], engine=engine,
                growmap_path=tree_path, max_length=MAX_LEN, safe_buffer=16, temperature=0.0,
                eos_token_ids=[-1], tokenizer=_NoText(), draft_topk_recall=1.0, **kw)


def _static_tokens(eng, steps=4):
    eng.initialize()
    assert eng._prefill(np.asarray(PROMPT, np.int32))
    start = eng.num_nodes
    for _ in range(steps):
        eng.build_tree()
        eng.verify()
    return eng, eng.tokens_host[start:eng.num_nodes].tolist()


REQUESTS = [dict(input_ids=[1, 9, 23, 7], max_new_tokens=12),
            dict(input_ids=[5, 2, 61, 11, 30], max_new_tokens=12),
            dict(input_ids=[17, 3], max_new_tokens=8)]


def _batched_tokens(eng):
    eng.initialize()
    return eng, [r["generated_tokens"] for r in eng.run([dict(r) for r in REQUESTS])]


@pytest.mark.parametrize("engine,draft,kv_dtype", [
    ("static", "dense", None), ("static", "moe", None), ("static", "dense", "int8"),
    ("batched_static", "dense", "int8"), ("batched_static", "moe", None)])
def test_ep_engine_from_checkpoints_matches_jax_and_unsharded(ckpt_dirs, engine, draft,
                                                              kv_dtype):
    """`expert_parallel: 2` over a Mixtral directory: the target's experts
    (and an MoE draft's) sharded on two CPU shards, a dense draft whole;
    greedy tokens equal JAX's EP engine's and the port's unsharded engine's
    (the static engine stepwise, the batched one through run(): 3 requests
    on 2 slots), with an fp32 and an int8 KV cache."""
    kw = dict(kv_dtype=kv_dtype)
    if engine == "batched_static":
        kw.update(batch_size=2, segment_steps=4)
    drive = _batched_tokens if engine == "batched_static" else _static_tokens
    _, want = drive(JaxAutoEngine.from_config(
        **_config(ckpt_dirs, draft, engine, JAX_TREE, **kw), dtype=jnp.float32,
        expert_parallel=2))
    port = dict(_config(ckpt_dirs, draft, engine, PORT_TREE, **kw), dtype=torch.float32,
                device=CPU)
    eng, got = drive(AutoEngine.from_config(**port, expert_parallel=2))
    assert eng.target_model.shard_devices == (torch.device(CPU),) * 2
    assert (eng.draft_model.shard_devices is not None) == (draft == "moe")
    _, ref = drive(AutoEngine.from_config(**port))
    assert got == want == ref
    assert all(len(t) >= 4 for t in (got if engine == "batched_static" else [got]))


# ------------------------------------------------------------------ phases and refusals


def test_ep_forward_phase_is_eager_only_across_cards():
    """The expert-parallel forward is one phase of the step, captured with
    it on one card and eager where the shards span cards."""
    rt = moe.shard_runtime_ep(_port_runtime(), [CPU, CPU])
    (ph,) = rt.forward_phases(rt.init_kv())
    assert not ph.eager
    sharded = rt.params["layers"]["expert_shards"]
    rt.params["layers"]["expert_shards"] = moe.ShardedExperts(
        sh._replace(device=torch.device("cuda", s)) for s, sh in enumerate(sharded.shards))
    assert rt.spans_cards and rt.forward_phases(None)[0].eager


def test_refusals(ckpt_dirs, monkeypatch):
    """As in the JAX package: a dense target with expert_parallel (static and
    batched), E not divisible by expert_parallel, an already sharded runtime
    or one of another shard count, and fewer cards than shards without a
    sharded target (a ValueError before any model loads); a target the
    caller sharded keeps its shards."""
    for engine in ("static", "batched_static"):
        eng = AutoEngine.from_config(device=CPU, engine=engine, model=ckpt_dirs["dense"],
                                     draft_model=ckpt_dirs["dense"], growmap_path=PORT_TREE,
                                     max_length=MAX_LEN, expert_parallel=2)
        with pytest.raises(ValueError, match="requires an MoE"):
            eng.initialize()
    with pytest.raises(ValueError, match="num_local_experts=4 must be divisible"):
        moe.shard_runtime_ep(_port_runtime(), [CPU] * 3)
    rt = moe.shard_runtime_ep(_port_runtime(), [CPU] * 2)
    with pytest.raises(ValueError, match="already sharded"):
        moe.shard_runtime_ep(rt, [CPU] * 2)
    draft = auto_model.AutoModelLM.from_pretrained(ckpt_dirs["dense"], max_length=MAX_LEN,
                                                   dtype=torch.float32, device=CPU)
    kw = dict(growmap_path=PORT_TREE, max_length=MAX_LEN, dtype=torch.float32)
    eng = AutoEngine.from_config(device=CPU, engine="static", model=rt, draft_model=draft,
                                 expert_parallel=4, **kw)
    with pytest.raises(ValueError, match="sharded in 2 shards, expert_parallel=4"):
        eng.initialize()
    shards = rt.params["layers"]["expert_shards"]
    eng = AutoEngine.from_config(device=CPU, engine="static", model=rt, draft_model=draft,
                                 expert_parallel=2, **kw)
    eng.initialize()
    assert eng.target_model.params["layers"]["expert_shards"] is shards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    eng = StaticEngine(_port_runtime(), draft, device="cuda:0", expert_parallel=4, **kw)
    with pytest.raises(ValueError, match="expert_parallel=4 needs 4 CUDA devices"):
        eng.initialize()
