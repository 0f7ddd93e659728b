"""The port's dynamic beam-tree engine against the JAX package on the CPU.

`umbrella_tpu_torch.speculation.dynamic_engine.DynamicEngine` and the JAX
package's `DynamicEngine` run on the same weights (carried across with
`params_from_numpy`), fp32, with the exact draft top-k on both sides
(`draft_topk_recall=1.0`): the trees (tokens, bitmap, parents), the committed
tokens and the accept lengths must be equal, and the greedy tokens must equal
the port's own autoregressive decode, over a resident target and over one
staged in pipeline stages. Stochastic decoding is held against
the exact target distribution with a chi-square test. The accept rule over
static and dynamic bitmaps is held against `tests/test_accept_parity.py`'s
numpy re-expression of the reference's rule. Tokens are compared exactly;
the one tolerance is the chi-square test's p > 1e-3.
"""
import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from test_accept_parity import EOS_SET, NUM_NODES, _ref_accept
from test_static_engine import _cfg as _jax_small_cfg
from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.ops import sampling as jax_sampling
from umbrella_tpu.speculation import auto_engine as jax_auto_engine
from umbrella_tpu.speculation.dynamic_engine import DynamicEngine as JaxDynamicEngine
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.models import auto_model
from umbrella_tpu_torch.models.convert import params_from_numpy
from umbrella_tpu_torch.models.kv_cache import KVCache
from umbrella_tpu_torch.ops import masks
from umbrella_tpu_torch.speculation import auto_engine
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
from umbrella_tpu_torch.speculation.dynamic_engine import DynamicEngine, expand_level
from umbrella_tpu_torch.speculation.tree import GrowMap
from umbrella_tpu_torch.speculation.verify import verify_tail

torch.set_num_threads(1)  # several workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 256
CPU = "cpu"
TREE = dict(width=4, num_beams=6, depth=4)  # tests/test_dynamic_engine.py's tree
PROMPT = [1, 17, 42, 9, 55]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jrt):
    """The port's runtime over a JAX runtime's weights."""
    cfg = ModelConfig(**{f: getattr(jrt.cfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
        "eos_token_id", "tie_word_embeddings", "rope_theta")})
    return auto_model.ModelRuntime(cfg, params_from_numpy(_np(jrt.params)), MAX_LEN,
                                   dtype=torch.float32, device=CPU)


@pytest.fixture(scope="module")
def runtimes():
    """tests/test_dynamic_engine.py's target and draft (seeds 0 and 1), JAX
    and port."""
    jt, jd = (jax_auto.random_runtime(_jax_small_cfg(), MAX_LEN, seed=s) for s in (0, 1))
    return (jt, jd), (_port(jt), _port(jd))


def _jax_engine(target, draft, **kw):
    eng = JaxDynamicEngine(draft_model_name=draft, target_model_name=target, dtype=jnp.float32,
                           max_length=MAX_LEN, safe_buffer=32, draft_topk_recall=1.0,
                           **dict(dict(TREE, eos_token_ids=[-1]), **kw))
    eng.initialize()
    return eng


def _port_engine(target, draft, **kw):
    eng = AutoEngine.from_config(device=CPU, model=target, draft_model=draft,
                                 dtype=torch.float32, max_length=MAX_LEN, safe_buffer=32,
                                 draft_topk_recall=1.0,
                                 **dict(dict(TREE, eos_token_ids=[-1]), **kw))
    eng.initialize()
    return eng


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


def _tree(eng):
    """(tree tokens after num_nodes, bitmap, parents) of the last build."""
    nn, T = eng.num_nodes, eng.tree_size
    if isinstance(eng, DynamicEngine):
        return (eng.tokens[nn:nn + T].numpy(), eng._bitmap.numpy(), eng._parents.numpy())
    return (np.asarray(eng.tokens)[nn:nn + T], np.asarray(eng._tree_bitmap),
            np.asarray(eng._tree_parents))


# ------------------------------------------------------------------ greedy against JAX

def test_greedy_dynamic_matches_jax_and_ar_decode(runtimes):
    """tests/test_dynamic_engine.py's first case on both packages: the
    stepwise loop (build_tree(); verify()) for 30 tokens. Every step's tree
    (tokens, bitmap, parents) and accept length equal JAX's; the tokens after
    the EOS-banned first token equal the port's AR decode of that prefix."""
    (jt, jd), (pt, pd) = runtimes
    jeng, eng = _jax_engine(jt, jd), _port_engine(pt, pd)
    assert isinstance(eng, DynamicEngine) and eng.tree_size == 17
    for e in (jeng, eng):
        assert e._prefill(np.asarray(PROMPT))
    start, steps = eng.num_nodes, 0
    while (eng.num_nodes - start) < 30 and eng.validate_status():
        for e in (jeng, eng):
            e.build_tree()
        for a, b in zip(_tree(jeng), _tree(eng)):
            np.testing.assert_array_equal(a, b)
        for e in (jeng, eng):
            e.verify()
        assert eng.num_nodes == jeng.num_nodes
        steps += 1
    produced = eng.tokens_host[start + 1:eng.num_nodes + 1].tolist()
    assert eng.tokens_host[:eng.num_nodes + 1].tolist() == \
        jeng.tokens_host[:jeng.num_nodes + 1].tolist()
    prefix = eng.tokens_host[:start + 1].tolist()
    assert produced == _port_ar_decode(pt, prefix, len(produced))
    assert eng.num_nodes - start >= steps


def test_dynamic_self_draft_accept_depth(runtimes):
    """Draft == target: the greedy root path is accepted to full depth (depth
    + 1 tokens), on both packages."""
    (jt, _), (pt, _) = runtimes
    for eng in (_jax_engine(jt, jt), _port_engine(pt, pt)):
        assert eng._prefill(np.asarray([3, 7, 11]))
        before = eng.num_nodes
        eng.build_tree()
        eng.verify()
        assert eng.num_nodes - before == eng.tree_depth + 1


@pytest.mark.parametrize("max_new", [12, 40])
def test_dynamic_generate_contract_matches_jax(runtimes, max_new):
    """generate(): JAX's tokens and average accept length, at least max_new
    tokens, the engine reset afterwards; a second request repeats the first."""
    (jt, jd), (pt, pd) = runtimes
    want = _jax_engine(jt, jd).generate(input_ids=[1, 5, 9], max_new_tokens=max_new)
    eng = _port_engine(pt, pd)
    got = eng.generate(input_ids=[1, 5, 9], max_new_tokens=max_new)
    assert len(got["generated_tokens"]) >= max_new
    assert got["generated_tokens"] == want["generated_tokens"]
    assert got["avg_accept_tokens"] == want["avg_accept_tokens"] >= 1.0
    assert eng.num_nodes == 0
    assert eng.generate(input_ids=[1, 5, 9], max_new_tokens=max_new)["generated_tokens"] == \
        got["generated_tokens"]


@pytest.fixture(scope="module")
def damped():
    """A 4-layer target with a damped tail and its 2-layer early-exit draft
    (a draft that is often right, so that trees are accepted deep)."""
    cfg = JaxConfig(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                    num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
                    max_position_embeddings=MAX_LEN, tie_word_embeddings=False,
                    eos_token_id=-100)
    t = jax_auto.random_runtime(cfg, MAX_LEN, dtype=jnp.float32, seed=0)
    layers = dict(t.params["layers"])
    for k in ("wo", "down"):
        layers[k] = layers[k].at[2:].multiply(0.05)
    jt = jax_auto.ModelRuntime(cfg, dict(t.params, layers=layers), MAX_LEN, dtype=jnp.float32)
    pt = _port(jt)
    return (jt, jax_auto.early_exit_runtime(jt, 2)), (pt, auto_model.early_exit_runtime(pt, 2))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_device_resident_loop_matches_jax_fused_and_stepwise(damped, kv_dtype):
    """The graphed step's body, run eagerly on the CPU (`_decode_fused`: gated
    steps on the device-resident state, in blocks): JAX's `_decode_fused`
    tokens and step count, and the port's stepwise loop's, for the shipped
    configs' tree shape cut to width 4, depth 6, 8 beams."""
    (jt, jd), (pt, pd) = damped
    kw = dict(width=4, num_beams=8, depth=6, kv_dtype=kv_dtype)
    jeng, eng = _jax_engine(jt, jd, **kw), _port_engine(pt, pd, **kw)
    assert eng._can_decode_fused() and eng.max_step_advance == 7
    res = []
    for e, decode in ((jeng, "_decode_fused"), (eng, "_decode_fused"), (eng, "_decode_stepwise")):
        assert e._prefill(np.asarray(PROMPT, np.int32))
        start = e.num_nodes
        steps = getattr(e, decode)(48)
        res.append((e.tokens_host[start:e.num_nodes + 1].tolist(), steps))
        e.reset()
    assert res[1] == res[0] and res[2] == res[0]
    assert len(res[0][0]) > 48 and len(res[0][0]) / res[0][1] > 2  # deep accepts
    assert eng.decode_stats["replays"] >= res[0][1]


def test_dynamic_engine_over_a_staged_target(damped):
    """pipeline_parallel=2 in the dynamic engine: greedy generate() over the
    staged target (the device-resident loop, stages on the CPU) gives JAX's
    dynamic engine with pipeline_parallel=2 (2 of its 8 host devices a
    stage) the same tokens and accept length, and the port's unstaged
    dynamic engine's; a second request repeats the first."""
    (jt, jd), (pt, pd) = damped
    kw = dict(width=4, num_beams=6, depth=4)
    jstaged = jax_auto.ModelRuntime(jt.cfg, dict(jt.params), MAX_LEN, dtype=jnp.float32)
    pstaged = auto_model.ModelRuntime(pt.cfg, dict(pt.params), MAX_LEN, dtype=torch.float32,
                                      device=CPU)
    jeng = _jax_engine(jstaged, jd, pipeline_parallel=2, **kw)
    eng = _port_engine(pstaged, pd, pipeline_parallel=2, **kw)
    assert eng.target_model.stage_devices == (torch.device(CPU),) * 2
    assert eng._can_decode_fused() and jeng._can_decode_fused()
    want = jeng.generate(input_ids=PROMPT, max_new_tokens=40)
    got = eng.generate(input_ids=PROMPT, max_new_tokens=40)
    unstaged = _port_engine(pt, pd, **kw).generate(input_ids=PROMPT, max_new_tokens=40)
    assert len(got["generated_tokens"]) >= 40 and eng.decode_stats["replays"] > 0
    for other in (want, unstaged):
        assert got["generated_tokens"] == other["generated_tokens"]
        assert got["avg_accept_tokens"] == other["avg_accept_tokens"]
    assert got["avg_accept_tokens"] > 2  # deep accepts
    assert eng.generate(input_ids=PROMPT, max_new_tokens=40)["generated_tokens"] == \
        got["generated_tokens"]


def test_ban_eos_at_prefill(runtimes):
    """The first token after a prefill is the target's argmax with the EOS ids
    masked (the dynamic engine), or the plain argmax (the static engine)."""
    (jt, jd), (pt, pd) = runtimes
    top = _port_ar_decode(pt, PROMPT, 1)[0]
    kw = dict(eos_token_ids=[top, 96])
    jeng, eng = _jax_engine(jt, jd, **kw), _port_engine(pt, pd, **kw)
    for e in (jeng, eng):
        assert e._prefill(np.asarray(PROMPT))
    first = int(eng.tokens_host[len(PROMPT)])
    assert first == int(jeng.tokens_host[len(PROMPT)]) != top
    logits, _ = pt.forward(pt.params, pt.init_kv(), torch.tensor(PROMPT),
                           torch.arange(len(PROMPT)),
                           masks.causal_mask_rows(0, len(PROMPT), MAX_LEN), 0)
    assert first == int(torch.argmax(logits[-1].index_fill(0, torch.tensor([top, 96]),
                                                           -torch.inf)))
    static = AutoEngine.from_config(device=CPU, engine="static", model=pt, draft_model=pd,
                                    growmap=GrowMap.from_json(os.path.join(
                                        REPO, "umbrella_tpu_torch", "trees",
                                        "sequoia_tree-3x4.json")),
                                    max_length=MAX_LEN, dtype=torch.float32, **kw)
    static.initialize()
    assert static._prefill(np.asarray(PROMPT)) and int(static.tokens_host[len(PROMPT)]) == top


# ------------------------------------------------------------------ the expansion's ties

def test_expansion_top_k_breaks_ties_as_lax_top_k():
    """log(softmax + 1e-4) saturates: a row with one dominant value gives every
    other beam the same fp32 score. The selection must pick JAX's candidates
    (lax.top_k keeps the lower index among equals), tokens and parents too."""
    W, B = 4, 6
    rng = np.random.default_rng(3)
    top_vals = np.full((W, B), -30.0, np.float32)
    top_vals[:, 0] = 40.0  # every row: beam 0 dominant, beams 1..5 tied
    top_vals[2, 1] = -29.0  # one beam a little above the tie in row 2
    top_idx = rng.permutation(512)[:W * B].reshape(W, B).astype(np.int32)
    hist = np.array([0.0, -0.5, -0.5, -1.0], np.float32)
    jscores = jnp.log(jax.nn.softmax(jnp.asarray(top_vals), axis=-1) + 1e-4)
    cand = (jnp.asarray(hist)[:, None] + jscores).reshape(-1)
    assert len(np.unique(np.asarray(cand))) < W * B  # ties are there
    sel_score, sel = jax.lax.top_k(cand, W + 3)
    score, tokens, rows = expand_level(torch.from_numpy(top_vals), torch.from_numpy(top_idx),
                                       torch.from_numpy(hist), W + 3)
    np.testing.assert_array_equal(score.numpy(), np.asarray(sel_score))
    np.testing.assert_array_equal(tokens.numpy(), top_idx.reshape(-1)[np.asarray(sel)])
    np.testing.assert_array_equal(rows.numpy(), np.asarray(sel) // B)


# ------------------------------------------------------------------ stochastic

def test_stochastic_dynamic_decoding_chi_square(runtimes):
    """Temperature 0.7, top-k 16, top-p 0.8, repetition penalty 1.3: whatever
    tree is accepted, the token committed after the root is the target's
    sample at the root. 1,200 steps from one prefix (state restored each
    time) against the exact distribution from the JAX package's
    ops/sampling; chi-square p > 1e-3, no token outside the support."""
    (_, _), (pt, pd) = runtimes
    T_, k, p_, pen, n = 0.7, 16, 0.8, 1.3, 1200
    eng = _port_engine(pt, pd, temperature=T_, topk=k, topp=p_, repetition_penalty=pen, seed=5)
    assert eng._prefill(np.asarray(PROMPT))
    nn = eng.num_nodes
    snap = [t.clone() for t in (eng.tokens, *eng.kv_draft[:2], *eng.kv_target[:2])]
    host = eng.tokens_host.copy()
    ids = eng.tokens_host[:nn + 1].tolist()
    logits, _ = pt.forward(pt.params, pt.init_kv(), torch.tensor(ids), torch.arange(nn + 1),
                           masks.causal_mask_rows(0, nn + 1, MAX_LEN), 0)
    lj = jax_sampling.apply_repetition_penalty(jnp.asarray(logits[-1:].numpy()),
                                               jnp.asarray(host), nn + 1, pen)
    probs = jax.nn.softmax(jax_sampling.apply_topk_mask(lj, k) / T_, axis=-1)
    p = np.asarray(jax_sampling.top_p_renorm_probs(probs, p_), np.float64)[0]
    counts = np.zeros(p.shape[0])
    for _ in range(n):
        for buf, saved in zip((eng.tokens, *eng.kv_draft[:2], *eng.kv_target[:2]), snap):
            buf.copy_(saved)
        eng.tokens_host[:] = host
        eng.num_nodes = nn
        eng.build_tree()
        eng.verify()
        assert eng.num_nodes > nn
        counts[int(eng.tokens_host[nn + 1])] += 1
    support = p > 0
    assert counts[~support].sum() == 0
    assert 2 <= support.sum() <= k
    expected = p[support] / p[support].sum() * n  # the fp32 mass renormalized in fp64
    _, pval = stats.chisquare(counts[support], expected)
    assert pval > 1e-3, (pval, counts[support], expected)


# ------------------------------------------------------------------ config surface

def test_from_config_without_an_engine_key_builds_a_dynamic_engine(runtimes):
    """The default engine is "dynamic" (as in the JAX package), with its key
    allowlist; the shipped offload configs' keys are accepted."""
    (_, _), (pt, pd) = runtimes
    assert auto_engine._ENGINE_CONFIG_KEYS["dynamic"] == \
        jax_auto_engine._ENGINE_CONFIG_KEYS["dynamic"]
    eng = AutoEngine.from_config(device=CPU, model=pt, draft_model=pd, max_length=MAX_LEN)
    assert isinstance(eng, DynamicEngine)
    assert (eng.tree_width, eng.num_beams, eng.tree_depth) == (16, 24, 24)
    with pytest.raises(ValueError, match="not consumed"):
        AutoEngine.from_config(device=CPU, model=pt, draft_model=pd, growmap_path="x.json")
    with pytest.raises(ValueError, match="num_beams"):
        AutoEngine.from_config(device=CPU, model=pt, draft_model=pd, width=8, num_beams=4)
    import json

    for name in ("greedy_config_v5e.json", "chat_config_v5e_16gb.json"):
        with open(os.path.join(REPO, "configs", name)) as f:
            cfg = json.load(f)
        cfg.update(model=pt, draft_model=pd)
        eng = AutoEngine.from_config(device=CPU, **cfg)
        assert isinstance(eng, DynamicEngine) and eng.tree_size == 16 * 16 + 1
        assert eng.config["offload"] and eng.config["num_cache_layers"] == 16


# ------------------------------------------------------------------ accept rule parity

ALL_TREES = sorted(glob.glob(os.path.join(REPO, "umbrella_tpu_torch", "trees", "*.json")))


def _dynamic_tree(width, depth, seed):
    """A random dynamic tree as the engine builds one: level l's nodes each pick
    a parent on level l - 1; bitmap rows are the parent's row plus self."""
    rng = np.random.default_rng(seed)
    T = width * depth + 1
    parents, bitmap = np.zeros(T, np.int32), np.eye(T, dtype=bool)
    depth_v = np.zeros(T, np.int32)
    for lvl in range(depth):
        lo = 0 if lvl == 0 else 1 + (lvl - 1) * width
        n_prev = 1 if lvl == 0 else width
        for j in range(width):
            v = 1 + lvl * width + j
            parents[v] = lo + rng.integers(n_prev)
            bitmap[v] |= bitmap[parents[v]]
            depth_v[v] = lvl + 1
    return types.SimpleNamespace(size=T, bitmap=bitmap, parents=parents,
                                 node_in_path=depth_v + 1)


def _cases(gm, seed):
    """(spec, sampled) pairs: random tokens, a path accepted to a leaf, an EOS
    in the middle of an accepted path."""
    rng = np.random.default_rng(seed)
    T, V = gm.size, 16
    out = [(rng.integers(5, V, T), rng.integers(5, V, T))]
    leaf = int(np.argmax(gm.node_in_path))
    path = np.nonzero(gm.bitmap[leaf])[0]
    spec, sampled = rng.integers(5, V, T), rng.integers(5, V, T)
    for v in path[1:]:
        spec[v] = sampled[gm.parents[v]]
    out.append((spec.copy(), sampled.copy()))
    if len(path) > 2:
        spec[path[len(path) // 2]] = EOS_SET[0]
        for v in path[len(path) // 2 + 1:]:
            sampled[gm.parents[v]] = spec[v]
        sampled[gm.parents[path[len(path) // 2]]] = EOS_SET[0]
        out.append((spec, sampled))
    return out


def _port_accept(spec, sampled, gm, vocab=16):
    T = gm.size
    L = NUM_NODES + 2 * T + 8
    logits = torch.zeros(T, vocab)
    logits[torch.arange(T), torch.from_numpy(sampled).long()] = 1.0
    tokens = torch.zeros(L, dtype=torch.int32)
    tokens[NUM_NODES:NUM_NODES + T] = torch.from_numpy(spec.astype(np.int32))
    kv, kv_d = (KVCache(k=torch.zeros(1, 1, L, 1), v=torch.zeros(1, 1, L, 1)) for _ in "td")
    kv.k[0, 0, NUM_NODES:NUM_NODES + T, 0] = torch.arange(T, dtype=torch.float32)
    alen, eos, block = verify_tail(
        logits, kv, kv_d, tokens, NUM_NODES, torch.from_numpy(np.asarray(gm.bitmap)),
        torch.from_numpy(np.asarray(gm.parents)).long(),
        torch.from_numpy(np.asarray(gm.node_in_path)).long(), torch.tensor(EOS_SET),
        tree_size=T)
    return int(alen), bool(eos), block.numpy(), kv.k[0, 0, NUM_NODES:NUM_NODES + T, 0].numpy()


@pytest.mark.parametrize("tree", [os.path.basename(p) for p in ALL_TREES]
                         + ["dynamic-4x4", "dynamic-16x16"])
def test_verify_tail_matches_the_reference_accept_rule(tree):
    """The port's verify_tail against `_ref_accept` (the reference's rule in
    numpy): accept length, committed block, stop flag and the KV compaction
    order, for every bundled growmap and for dynamic trees (4x4, and 16x16,
    the shipped configs' shape)."""
    if tree.startswith("dynamic"):
        w, d = map(int, tree.split("-")[1].split("x"))
        gm = _dynamic_tree(w, d, seed=w)
    else:
        gm = GrowMap.from_json(os.path.join(REPO, "umbrella_tpu_torch", "trees", tree))
    for spec, sampled in _cases(gm, seed=gm.size):
        path, alen, committed, cont = _ref_accept(spec, sampled, gm)
        got_alen, eos, block, kv_order = _port_accept(spec, sampled, gm)
        assert got_alen == alen and eos == (not cont)
        np.testing.assert_array_equal(block[:alen + 1], committed[:alen + 1])
        np.testing.assert_array_equal(kv_order[:alen], path[:alen])
        assert not kv_order[alen:].any()
