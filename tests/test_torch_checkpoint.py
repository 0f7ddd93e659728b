"""Checkpoint directories through the PyTorch port (umbrella_tpu_torch) and the
JAX package on the CPU.

Checkpoints are written with `safetensors` (an independent writer; the port
reads them with its own reader) or `torch.save`, in the HF layouts: fp
(Llama, Qwen2.5 with a padded vocab and q/k/v biases, a tied 1B-style draft)
and AutoAWQ GEMM. Inputs come from numpy seeds. Each test states its
tolerance.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.ops import masks as jax_masks
from umbrella_tpu.quantization import awq as jax_awq
from umbrella_tpu.quantization import int4f as jax_int4f
from umbrella_tpu.quantization import loader as jax_loader
from umbrella_tpu.serving.batched_engine import BatchedStaticEngine as JaxBatchedEngine
from umbrella_tpu.speculation.static_engine import StaticEngine as JaxStaticEngine
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.models import auto_model
from umbrella_tpu_torch.models.weights import SafetensorsReader, _load_state_dict
from umbrella_tpu_torch.ops import masks
from umbrella_tpu_torch.quantization import awq, int4f, loader
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its safetensors writer)

torch.set_num_threads(1)  # several workers share the cores

CPU = "cpu"
MAX_LEN = 128
TREE = "sequoia_tree-3x4.json"
SMALL = dict(model_type="llama", vocab_size=256, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=MAX_LEN,
             rope_scaling=dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                               original_max_position_embeddings=64, rope_type="llama3"),
             tie_word_embeddings=False, bos_token_id=1, eos_token_id=[-7, -8])


class _Tok:
    """Stands in for a tokenizer (the directories ship none)."""

    def decode(self, ids, **kw):
        return ""


# ------------------------------------------------------------------ checkpoint writers


def _fp_sd(hf, rng, scale=0.05):
    """HF-layout fp32 state dict ([out, in] linears) for a llama/qwen2 config."""
    H, I, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    D = hf.get("head_dim") or H // hf["num_attention_heads"]
    Hq, KV = hf["num_attention_heads"] * D, hf["num_key_value_heads"] * D

    def w(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": 1 + w(H)}
    if not hf.get("tie_word_embeddings"):
        sd["lm_head.weight"] = w(V, H)
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + w(H)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(H)
        for name, n, k in (("self_attn.q_proj", Hq, H), ("self_attn.k_proj", KV, H),
                           ("self_attn.v_proj", KV, H), ("self_attn.o_proj", H, Hq),
                           ("mlp.gate_proj", I, H), ("mlp.up_proj", I, H),
                           ("mlp.down_proj", H, I)):
            sd[p + name + ".weight"] = w(n, k)
        if hf.get("attention_bias"):
            for c, n in (("q", Hq), ("k", KV), ("v", KV)):
                sd[p + f"self_attn.{c}_proj.bias"] = w(n)
    return sd


def _awq_sd(hf, rng, group_size):
    """AutoAWQ GEMM-format state dict (fp16 scales and fp tensors)."""
    H, I, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    D = H // hf["num_attention_heads"]
    Hq, KV = hf["num_attention_heads"] * D, hf["num_key_value_heads"] * D
    sd = {"model.embed_tokens.weight": (rng.standard_normal((V, H)) * 0.05).astype(np.float16),
          "model.norm.weight": np.ones(H, np.float16),
          "lm_head.weight": (rng.standard_normal((V, H)) * 0.05).astype(np.float16)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = np.ones(H, np.float16)
        sd[p + "post_attention_layernorm.weight"] = np.ones(H, np.float16)
        for name, k, n in (("self_attn.q_proj", H, Hq), ("self_attn.k_proj", H, KV),
                           ("self_attn.v_proj", H, KV), ("self_attn.o_proj", Hq, H),
                           ("mlp.gate_proj", H, I), ("mlp.up_proj", H, I),
                           ("mlp.down_proj", I, H)):
            qw, qz = jax_awq.pack_awq_numpy(
                rng.integers(0, 16, (k, n)).astype(np.int8),
                rng.integers(4, 12, (k // group_size, n)).astype(np.int8))
            sd[p + name + ".qweight"] = qw
            sd[p + name + ".qzeros"] = qz
            sd[p + name + ".scales"] = rng.uniform(0.003, 0.008,
                                                   (k // group_size, n)).astype(np.float16)
    return sd


def _write_dir(path, hf, sd, shards=1, fmt="safetensors"):
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    names = list(sd)
    for s in range(shards):
        part = {k: sd[k] for k in names[s::shards]}
        if fmt == "bin":
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in part.items()},
                       os.path.join(path, f"pytorch_model-{s}.bin"))
        else:
            save_file(part, os.path.join(path, f"model-{s:05d}.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    rng = np.random.default_rng(0)
    awq_hf = dict(SMALL, quantization_config=dict(quant_method="awq", bits=4, group_size=64,
                                                  version="gemm", zero_point=True))
    draft_hf = dict(SMALL, num_hidden_layers=1, head_dim=16, num_attention_heads=8,
                    tie_word_embeddings=True)
    qwen_hf = dict(SMALL, model_type="qwen2", vocab_size=auto_model.QWEN25_VOCAB + 128,
                   hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                   num_attention_heads=2, num_key_value_heads=1, attention_bias=True,
                   rope_scaling=None)
    awq_sd = _awq_sd(awq_hf, rng, 64)
    dirs = {
        "awq": _write_dir(root / "awq", awq_hf, awq_sd, shards=2),
        "awq_int8": _write_dir(root / "awq_int8", dict(awq_hf, awq_act="int8"), awq_sd),
        "fp": _write_dir(root / "fp", SMALL, _fp_sd(SMALL, rng), shards=3),
        "fp_bin": _write_dir(root / "fp_bin", SMALL, _fp_sd(SMALL, rng), shards=2, fmt="bin"),
        "draft": _write_dir(root / "draft", draft_hf, _fp_sd(draft_hf, rng)),
        "qwen": _write_dir(root / "qwen", qwen_hf, _fp_sd(qwen_hf, rng)),
    }
    return dirs, awq_sd


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ (a) the reader

READER_DTYPES = ["float32", "float16", "bfloat16", "int32", "int64", "int8", "uint8"]


def _arrays(rng):
    out = {}
    for i, dt in enumerate(READER_DTYPES):
        a = rng.standard_normal((3, 5 + i)) * 50
        out[f"t.{dt}"] = torch.from_numpy(a).to(getattr(torch, dt))
    out["odd.offset"] = torch.arange(3, dtype=torch.uint8)  # later tensors start unaligned
    out["after.odd"] = torch.from_numpy(rng.standard_normal((2, 3))).to(torch.float32)
    out["empty"] = torch.zeros((0, 4), dtype=torch.float16)
    return out


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("writer", ["safetensors", "chip_smoke", "bin"])
def test_reader_matches_independent_writers(tmp_path, writer):
    """Exact, every dtype the reader supports, on a sharded directory: the
    port's reader against safetensors' own writer and reader (and torch.load
    for .bin); chip_smoke's writer read back by safetensors and by the port."""
    from safetensors.torch import load_file, save_file

    tensors = _arrays(np.random.default_rng(1))
    names = list(tensors)
    shards = [names[:4], names[4:]]
    for s, part in enumerate(shards):
        path = str(tmp_path / f"model-{s}.{'bin' if writer == 'bin' else 'safetensors'}")
        sub = {k: tensors[k] for k in part}
        if writer == "safetensors":
            save_file(sub, path)
        elif writer == "chip_smoke":
            chip_smoke.write_safetensors(path, [(k, t.dtype, tuple(t.shape), lambda t=t: t)
                                                for k, t in sub.items()])
            back = load_file(path)  # safetensors' reader accepts the file
            assert all(torch.equal(_bits(back[k]), _bits(sub[k])) for k in sub)
        else:
            torch.save(sub, str(tmp_path / f"pytorch_model-{s}.bin"))
    sd = _load_state_dict(str(tmp_path))
    assert isinstance(sd, dict if writer == "bin" else SafetensorsReader)
    assert sorted(sd.keys()) == sorted(names)
    for k, t in tensors.items():
        got = sd[k]
        assert got.dtype == t.dtype and got.shape == t.shape, k
        assert torch.equal(_bits(got), _bits(t)), k
    if writer != "bin":
        sd.close()
        assert torch.equal(_bits(got), _bits(t))  # a view outlives the closed file


def test_reader_matches_safetensors_numpy(tmp_path):
    """Exact against safetensors.numpy.load_file on the numpy dtypes."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(2)
    arrs = {f"x{i}": (rng.standard_normal((4, 3 + i)) * 40).astype(dt)
            for i, dt in enumerate([np.float32, np.float16, np.int32, np.int64, np.int8,
                                    np.uint8])}
    save_file(arrs, str(tmp_path / "a.safetensors"))
    want = load_file(str(tmp_path / "a.safetensors"))
    sd = SafetensorsReader([str(tmp_path / "a.safetensors")])
    for k, a in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), a)
    sd.close()


# ------------------------------------------------------------------ (b) config


@pytest.mark.parametrize("which", ["awq", "awq_int8", "draft", "qwen"])
def test_config_from_pretrained_matches_jax(ckpts, which):
    """Field by field, quantization, awq_act, rope_scaling and eos included."""
    dirs, _ = ckpts
    got = dataclasses.asdict(ModelConfig.from_pretrained(dirs[which]))
    want = dataclasses.asdict(JaxConfig.from_pretrained(dirs[which]))
    assert got == want
    if which.startswith("awq"):
        assert got["quantization"] == dict(method="awq", bits=4, group_size=64, version="gemm")
        assert got["awq_act"] == ("int8" if which == "awq_int8" else "bf16")
    assert ModelConfig.from_pretrained(dirs[which]).eos_token_ids == \
        JaxConfig.from_pretrained(dirs[which]).eos_token_ids


def test_config_from_pretrained_non_directory_goes_to_autoconfig(monkeypatch):
    """A name that is no directory goes to transformers.AutoConfig; where
    transformers is missing, that raises ImportError (it never guesses)."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        ModelConfig.from_pretrained("meta-llama/Llama-3.2-1B-Instruct")


# ------------------------------------------------------------------ (c) AWQ repack


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 64, 64), (256, 96, 128)])
def test_awq_from_hf_tensors_bit_identical_with_jax(dtype, shape):
    K, N, g = shape
    rng = np.random.default_rng(K + N)
    qw, qz = jax_awq.pack_awq_numpy(rng.integers(0, 16, (K, N)).astype(np.int8),
                                    rng.integers(0, 16, (K // g, N)).astype(np.int8))
    sc = rng.uniform(0.001, 0.02, (K // g, N)).astype(np.float16)
    j = _np(jax_awq.awq_from_hf_tensors(qw, qz, sc, dtype=getattr(jnp, dtype)))
    p = awq.awq_from_hf_tensors(torch.from_numpy(qw), torch.from_numpy(qz),
                                torch.from_numpy(sc), dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(p.w8.numpy(), j.w8)
    for f in ("scales", "zeros"):
        np.testing.assert_array_equal(_bits(getattr(p, f)).numpy(),
                                      getattr(j, f).view(np.int16) if dtype == "bfloat16"
                                      else getattr(j, f))
    iw, iz = awq.unpack_awq_numpy(qw, qz)
    jw, jz = jax_awq.unpack_awq_numpy(qw, qz)
    assert np.array_equal(iw, jw) and np.array_equal(iz, jz)
    # the numpy route (unpack, then pack_tpu_layout) gives the same tensors
    n = awq.pack_tpu_layout(iw, iz, sc.astype(np.float32), dtype=getattr(torch, dtype))
    assert all(torch.equal(_bits(getattr(n, f)), _bits(getattr(p, f)))
               for f in ("w8", "scales", "zeros"))
    assert all(np.array_equal(a, b) for a, b in zip(awq.pack_awq_numpy(iw, iz), (qw, qz)))


# ------------------------------------------------------------------ (d) from_pretrained


def _logits_jax(rt, ids):
    S = len(ids)
    lg, _ = rt.forward(rt.params, rt.init_kv(), jnp.asarray(ids, jnp.int32), jnp.arange(S),
                       jax_masks.causal_mask_rows(0, S, MAX_LEN), 0)
    return np.asarray(lg)


def _logits_port(rt, ids):
    S = len(ids)
    lg, _ = rt.forward(rt.params, rt.init_kv(), torch.tensor(ids), torch.arange(S),
                       masks.causal_mask_rows(0, S, MAX_LEN), 0)
    return lg.numpy()


@pytest.mark.parametrize("which,kw", [("awq", {}), ("fp", {}), ("fp_bin", {}), ("qwen", {}),
                                      ("fp", {"exit_layer": 1}), ("awq", {"packed": False}),
                                      ("draft", {})],
                         ids=["awq", "fp", "fp_bin", "qwen", "fp-exit1", "awq-unpacked",
                              "draft-tied"])
def test_from_pretrained_logits_match_jax(ckpts, which, kw):
    """fp32 logits within 1e-4 abs of JAX's AutoModelLM.from_pretrained on the
    same directory (the same weights; sums in another order)."""
    dirs, _ = ckpts
    jrt = jax_auto.AutoModelLM.from_pretrained(dirs[which], max_length=MAX_LEN,
                                               dtype=jnp.float32, **kw)
    prt = auto_model.AutoModelLM.from_pretrained(dirs[which], max_length=MAX_LEN,
                                                 dtype=torch.float32, device=CPU, **kw)
    assert prt.family == jrt.family and prt.args.n_layers == jrt.args.n_layers
    assert set(prt.params["layers"]) == set(jrt.params["layers"])
    assert ("lm_head" in prt.params) == ("lm_head" in jrt.params)
    if which == "qwen":
        assert prt.cfg.vocab_size == auto_model.QWEN25_VOCAB
        assert prt.params["embed"].shape[0] == auto_model.QWEN25_VOCAB
        assert "bqkv" in prt.params["layers"]
    ids = list(np.random.default_rng(3).integers(0, prt.cfg.vocab_size, size=7))
    np.testing.assert_allclose(_logits_port(prt, ids), _logits_jax(jrt, ids), atol=1e-4)


@pytest.mark.parametrize("which,cached", [("awq", 1), ("fp", 1), ("qwen", 0)])
def test_from_pretrained_offload_matches_resident_and_jax(ckpts, which, cached):
    """offload=True loads an OffloadModelRuntime layer by layer (`cached`
    layers resident, the rest streamed): its streamed logits equal the
    resident load's exactly, and JAX's offload load's within 1e-4 abs."""
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime

    dirs, _ = ckpts
    kw = dict(max_length=MAX_LEN, offload=True, num_cache_layers=cached)
    off = auto_model.AutoModelLM.from_pretrained(dirs[which], dtype=torch.float32, device=CPU,
                                                 **kw)
    assert isinstance(off, OffloadModelRuntime)
    assert (off.n_resident, off.n_streamed) == (cached, off.n_layers - cached) \
        and off.n_streamed >= 1
    res = auto_model.AutoModelLM.from_pretrained(dirs[which], max_length=MAX_LEN,
                                                 dtype=torch.float32, device=CPU)
    joff = jax_auto.AutoModelLM.from_pretrained(dirs[which], dtype=jnp.float32, **kw)
    ids = list(np.random.default_rng(3).integers(0, res.cfg.vocab_size, size=7))
    S = len(ids)
    args = (torch.tensor(ids), torch.arange(S), masks.causal_mask_rows(0, S, MAX_LEN), 0)
    got, _ = off.streamed_forward(off.init_kv(), *args)
    np.testing.assert_array_equal(got.numpy(), _logits_port(res, ids))
    jl, _ = joff.streamed_forward(joff.init_kv(), jnp.asarray(ids, jnp.int32), jnp.arange(S),
                                  jax_masks.causal_mask_rows(0, S, MAX_LEN), jnp.int32(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=1e-4)


def test_awq_dir_loads_like_the_in_memory_conversion(ckpts):
    """Exact: the directory through from_pretrained and the same tensors
    through awq_params_from_hf_state_dict in memory."""
    dirs, sd = ckpts
    rt = auto_model.AutoModelLM.from_pretrained(dirs["awq"], max_length=MAX_LEN,
                                                dtype=torch.float32, device=CPU)
    cfg = ModelConfig.from_pretrained(dirs["awq"])
    mem = auto_model.ModelRuntime(cfg, loader.awq_params_from_hf_state_dict(
        sd, cfg, MAX_LEN, dtype=torch.float32), MAX_LEN, dtype=torch.float32, device=CPU)
    ids = [5, 9, 200, 3]
    np.testing.assert_array_equal(_logits_port(rt, ids), _logits_port(mem, ids))


def test_from_pretrained_refusals(ckpts, tmp_path):
    dirs, _ = ckpts
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(SMALL, model_type="gemma2"), f)
    # Gemma2 is ported: its loader runs (and finds no weights here); it has no offload form
    with pytest.raises(FileNotFoundError):
        auto_model.AutoModelLM.from_pretrained(str(tmp_path), device=CPU)
    with pytest.raises(ValueError, match="gemma2 has no offload loader"):
        auto_model.AutoModelLM.from_pretrained(str(tmp_path), offload=True, device=CPU)
    assert auto_model.resolve_family("x", ModelConfig(model_type="mixtral")) == "moe"
    with pytest.raises(ValueError, match="MoE variant"):
        auto_model.resolve_family("x", ModelConfig(model_type="qwen2_moe", num_local_experts=4))
    empty = tmp_path / "no_weights"
    empty.mkdir()
    with open(empty / "config.json", "w") as f:
        json.dump(SMALL, f)
    with pytest.raises(FileNotFoundError):
        auto_model.AutoModelLM.from_pretrained(str(empty), device=CPU)


# ------------------------------------------------------------------ (e) quantize_runtime


@pytest.mark.parametrize("which", ["fp", "draft"])
def test_quantize_runtime_bit_exact_with_jax(ckpts, which):
    """W4 quantize_runtime (with the head; a tied head from embed.T): every
    packed leaf bit for bit equal to the JAX package's."""
    dirs, _ = ckpts
    jrt = jax_auto.AutoModelLM.from_pretrained(dirs[which], max_length=MAX_LEN,
                                               dtype=jnp.float32)
    prt = auto_model.AutoModelLM.from_pretrained(dirs[which], max_length=MAX_LEN,
                                                 dtype=torch.float32, device=CPU)
    jq = _np(jax_loader.quantize_runtime(jrt, group_size=64, dtype=jnp.float32,
                                         quantize_lm_head=True).params)
    pq = loader.quantize_runtime(prt, group_size=64, dtype=torch.float32,
                                 quantize_lm_head=True)
    assert pq.device == prt.device and awq.has_awq_layers(pq.params["layers"])
    pairs = [(jq["lm_head"], pq.params["lm_head"])]
    for name in ("wqkv", "wo", "gate_up", "down"):
        pairs += list(zip(jq["layers"][name], pq.params["layers"][name]))
    for j, p in pairs:
        for f in ("w8", "scales", "zeros"):
            np.testing.assert_array_equal(getattr(p, f).numpy(), getattr(j, f))


def test_quantize_runtime_int4f_matches_jax(ckpts):
    """Int4F of a tied draft (head from embed.T), within the rounding edges
    documented for quantize_int4f (test_torch_slice): the row factor within
    1e-6 relative; b within 1e-5 on 90% of columns; each leaf's fit error
    within 1% of JAX's. The ALS sweeps flip nibbles at rounding edges and a
    flip moves its column's next b; at these small widths (K = 128) one flip
    moves b more than at the 4096-row shape there, so up to 1% of nibbles (not
    0.1%) may differ."""
    dirs, _ = ckpts
    jrt = jax_auto.AutoModelLM.from_pretrained(dirs["draft"], max_length=MAX_LEN,
                                               dtype=jnp.float32)
    prt = auto_model.AutoModelLM.from_pretrained(dirs["draft"], max_length=MAX_LEN,
                                                 dtype=torch.float32, device=CPU)
    jq = jax_int4f.quantize_runtime_int4f(jrt, group_size=64)
    pq = int4f.quantize_runtime_int4f(prt, group_size=64)
    assert int4f.has_int4f_layers(pq.params["layers"]) and not int4f.has_int4f_layers(
        prt.params["layers"])
    jp, src = _np(jq.params), _np(jrt.params)
    leaves = [(jp["lm_head"], pq.params["lm_head"], src["embed"].T)]
    for name in ("wqkv", "wo", "gate_up", "down"):
        leaves += [(j, p, src["layers"][name][i])
                   for i, (j, p) in enumerate(zip(jp["layers"][name], pq.params["layers"][name]))]
    differ = total = close = cols = 0
    for j, p, w in leaves:
        np.testing.assert_allclose(p.a.numpy(), j.a, rtol=1e-6)
        close += int((np.abs(p.b.numpy() / j.b - 1) <= 1e-5).sum())
        cols += j.b.size
        jw, pw = j.w8.view(np.uint8), p.w8.numpy().view(np.uint8)
        differ += np.count_nonzero((jw & 0xF) != (pw & 0xF)) + np.count_nonzero(
            (jw >> 4) != (pw >> 4))
        total += 2 * jw.size
        e_jax = np.sum((np.asarray(jax_int4f.dequantize_int4f(j, jnp.float32)) - w) ** 2)
        e_port = np.sum((int4f.dequantize_int4f(p, torch.float32).numpy() - w) ** 2)
        assert abs(e_port - e_jax) <= 0.01 * e_jax
    assert close >= 0.9 * cols and differ < 1e-2 * total, (close, cols, differ, total)


# ------------------------------------------------------------------ (f) engines from paths


def _engine_cfg(dirs, target, qd, engine, package):
    cfg = dict(model=dirs[target], draft_model=dirs["draft"], quantize_draft=qd,
               max_length=MAX_LEN, safe_buffer=16, temperature=0.0, tokenizer=_Tok(),
               growmap_path=os.path.join(REPO, package, "trees", TREE))
    if engine == "batched_static":
        cfg.update(batch_size=2, segment_steps=4)
    return cfg


PROMPTS = [[1, 17, 42, 9, 100], [3, 3, 7]]
NEW_TOKENS = 20


def _run_jax(dirs, target, qd, engine):
    cfg = _engine_cfg(dirs, target, qd, engine, "umbrella_tpu")
    cls = JaxBatchedEngine if engine == "batched_static" else JaxStaticEngine
    eng = cls(cfg.pop("draft_model"), cfg.pop("model"), dtype=jnp.float32,
              draft_topk_recall=1.0, **cfg)
    eng.initialize()
    if engine == "batched_static":
        return eng.run([dict(input_ids=p, max_new_tokens=NEW_TOKENS) for p in PROMPTS])
    return [eng.generate(input_ids=p, max_new_tokens=NEW_TOKENS) for p in PROMPTS]


def _run_port(dirs, target, qd, engine):
    cfg = _engine_cfg(dirs, target, qd, engine, "umbrella_tpu_torch")
    eng = AutoEngine.from_config(device=CPU, engine=engine, dtype=torch.float32, **cfg)
    eng.initialize()
    kind = int4f.Int4FTensor if qd == "int4f" else awq.AwqTensor
    assert isinstance(eng.draft_model.params["lm_head"], kind)
    assert isinstance(eng.draft_model.params["layers"]["wqkv"][0], kind)
    if engine == "batched_static":
        return eng.run([dict(input_ids=p, max_new_tokens=NEW_TOKENS) for p in PROMPTS])
    return [eng.generate(input_ids=p, max_new_tokens=NEW_TOKENS) for p in PROMPTS]


@pytest.mark.parametrize("engine", ["static", "batched_static"])
@pytest.mark.parametrize("qd", [True, "int4f"])
def test_path_engines_token_identical_with_jax(ckpts, engine, qd):
    """AWQ target and fp tied draft given as directories, quantize_draft W4
    or Int4F: greedy tokens equal the JAX engines' on the same directories
    (they depend on the target only); accept counts equal for the W4 draft,
    whose quantization is bit-exact with the JAX package's."""
    dirs, _ = ckpts
    want = _run_jax(dirs, "awq", qd, engine)
    got = _run_port(dirs, "awq", qd, engine)
    for g, w in zip(got, want):
        assert len(g["generated_tokens"]) >= NEW_TOKENS
        assert g["generated_tokens"] == w["generated_tokens"]
        if qd is True:
            assert g["avg_accept_tokens"] == pytest.approx(w["avg_accept_tokens"])


# ------------------------------------------------------------------ (g) shipped configs

SHIPPED = ["code_config_8b_awq_v5e.json", "chat_config_8b_awq_v5e.json",
           "serve_batched_8b_awq_int8kv_v5e.json"]


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_8b_config_keys_are_accepted(ckpts, name):
    """Every key of the shipped 8B configs is accepted (model, draft_model and
    growmap_path rewritten), and so are offload and num_cache_layers on the
    single-slot engines; the batched engine refuses offload."""
    dirs, _ = ckpts
    with open(os.path.join(REPO, "configs", name)) as f:
        cfg = json.load(f)
    cfg.update(model=dirs["awq"], draft_model=dirs["draft"],
               growmap_path=os.path.join(REPO, "umbrella_tpu_torch", "trees",
                                         os.path.basename(cfg["growmap_path"])))
    eng = AutoEngine.from_config(device=CPU, **cfg)
    assert eng.draft_model_name == dirs["draft"]
    assert AutoEngine.from_config(device=CPU, **dict(cfg, num_cache_layers=2)).config[
        "num_cache_layers"] == 2
    if cfg["engine"] == "static":
        assert AutoEngine.from_config(device=CPU, **dict(cfg, offload=True)).config["offload"]
    else:
        with pytest.raises(ValueError, match="resident"):
            AutoEngine.from_config(device=CPU, **dict(cfg, offload=True))
