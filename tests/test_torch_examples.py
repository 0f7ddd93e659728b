"""The port's example scripts (umbrella_tpu_torch/examples/) against the JAX
package's `examples/` on the CPU.

Tiny fp32 models: checkpoint directories written from a seed with numpy
(`__graft_entry__._write_tiny_fp_ckpt`) beside a WordLevel tokenizer, loaded by
both packages, or the JAX package's random runtimes carried across with
`models/convert.runtime_from_numpy`. Greedy tokens, accept counts, the
acceptance vector and the written tree are held equal exactly; the 70B bench's
layer within 1e-5 x max|y|.
"""
import ast
import importlib
import json
import logging
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.config import ModelConfig as JaxConfig
from umbrella_tpu.models import auto_model as jax_auto
from umbrella_tpu.sequoia import generate_sequoia_tree as jax_generate_sequoia_tree
from umbrella_tpu_torch.models.convert import runtime_from_numpy
from umbrella_tpu_torch.sequoia import generate_sequoia_tree

from test_spec_bench import _write_tokenizer  # a WordLevel tokenizer saved beside a checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
            eos_token_id=-1, tie_word_embeddings=False)
MODULES = ("spec_generate", "spec_bench", "spec_bench_python", "generate", "construct_sequoia",
           "bench", "bench_70b", "serve_soak")


def jax_example(name):
    return importlib.import_module(f"examples.{name}")


def port_example(name):
    return importlib.import_module(f"umbrella_tpu_torch.examples.{name}")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Target and draft checkpoint directories (fp32, seeds 0 and 1), the
    tokenizer in the target's."""
    import __graft_entry__ as g

    root = tmp_path_factory.mktemp("pair")
    dirs = {k: str(root / k) for k in ("target", "draft")}
    g._write_tiny_fp_ckpt(dirs["target"], JaxConfig(**TINY), seed=0)
    g._write_tiny_fp_ckpt(dirs["draft"], JaxConfig(**TINY), seed=1)
    return dict(dirs, tokenizer=_write_tokenizer(dirs["target"]), root=root)


def _configs(pair, name, **keys):
    """One config file each for the JAX package and the port (each its own
    copy of the tree)."""
    paths = {}
    for side, package in (("jax", "umbrella_tpu"), ("port", "umbrella_tpu_torch")):
        cfg = dict(engine="static", model=pair["target"], draft_model=pair["draft"],
                   growmap_path=os.path.join(REPO, package, "trees", "sequoia_tree-3x4.json"),
                   max_length=384, safe_buffer=32, stop_distance=16, temperature=0.0,
                   eos_token_ids=[-1], dtype="float32", draft_topk_recall=1.0, **keys)
        paths[side] = str(pair["root"] / f"{name}-{side}.json")
        with open(paths[side], "w") as f:
            json.dump(cfg, f)
    return paths


def _recording(monkeypatch, module):
    """Record (tokens, steps) of every speculative_decoding call of the
    engines that `module`'s main() builds."""
    calls, real = [], module.AutoEngine

    class Recording:
        @staticmethod
        def from_config(**kw):
            eng = real.from_config(**kw)
            decode = eng.speculative_decoding

            def record(n):
                dec_len, elapsed, steps = decode(n)
                calls.append((int(dec_len), int(steps)))
                return dec_len, elapsed, steps

            eng.speculative_decoding = record
            return eng

    monkeypatch.setattr(module, "AutoEngine", Recording)
    return calls


def _accept_lines(text):
    return re.findall(r"\[(\w+)\] Avg Accept Tokens ([0-9.]+)", text)


def test_spec_bench_equals_the_jax_example(pair, monkeypatch, caplog):
    caplog.set_level(logging.INFO)
    data = os.path.join(REPO, "umbrella_tpu_torch", "data", "question.jsonl")
    cfg = _configs(pair, "chat", template="meta-llama3")
    jax_sb = jax_example("spec_bench")
    calls = _recording(monkeypatch, jax_sb)
    monkeypatch.setattr(sys, "argv", ["spec_bench.py", "--configuration", cfg["jax"],
                                      "--data", data, "--max_new_tokens", "16", "--limit", "2"])
    jax_sb.main()
    jax_lines = _accept_lines(caplog.text)
    caplog.clear()
    got = port_example("spec_bench").main(["--configuration", cfg["port"], "--data", data,
                                          "--max_new_tokens", "16", "--limit", "2",
                                          "--device", "cpu"])
    assert _accept_lines(caplog.text) == jax_lines
    assert [c for c, _ in jax_lines] == ["roleplay", "writing", "TOTAL"]
    # questions 1 (writing) and 2 (roleplay), two turns each, in that order
    assert len(calls) == 4
    want = {"writing": calls[:2], "roleplay": calls[2:]}
    for cat, turns in want.items():
        s = got["categories"][cat]
        assert (s["tokens"], s["steps"]) == (sum(t for t, _ in turns), sum(s for _, s in turns))
    total = got["total"]
    assert (total["tokens"], total["steps"]) == (sum(t for t, _ in calls),
                                                 sum(s for _, s in calls))
    assert total["tokens"] >= 4 * 16 and total["avg_accept_tokens"] >= 1.0


def test_spec_bench_python_keeps_and_skips_the_jax_examples_prompts(pair, monkeypatch, caplog):
    caplog.set_level(logging.INFO)
    cfg = _configs(pair, "code", template="llama3-code")
    jax_sbp = jax_example("spec_bench_python")
    port = port_example("spec_bench_python")
    assert port.DEFAULT_PROMPTS == jax_sbp.DEFAULT_PROMPTS
    # the default prompts are under 20 tokens to this tokenizer; two longer ones are kept
    words = [w for w in pair["tokenizer"].get_vocab() if not w.startswith("<")]
    prompts = port.DEFAULT_PROMPTS + [" ".join(words), " ".join(words[::-1])]
    data = str(pair["root"] / "code.jsonl")
    with open(data, "w") as f:
        f.writelines(json.dumps(dict(prompt=p)) + "\n" for p in prompts)
    calls = _recording(monkeypatch, jax_sbp)
    monkeypatch.setattr(sys, "argv", ["spec_bench_python.py", "--configuration", cfg["jax"],
                                      "--data", data, "--max_new_tokens", "16"])
    jax_sbp.main()
    jax_lines = _accept_lines(caplog.text)
    caplog.clear()
    got = port.main(["--configuration", cfg["port"], "--data", data, "--max_new_tokens", "16",
                     "--device", "cpu"])
    assert _accept_lines(caplog.text) == jax_lines
    long_enough = [i for i, p in enumerate(prompts) if len(pair["tokenizer"].encode(p)) >= 20]
    assert got["kept"] == long_enough == [5, 6]
    assert len(calls) == len(long_enough)
    assert (got["tokens"], got["steps"]) == (sum(t for t, _ in calls), sum(s for _, s in calls))
    assert got["tokens"] >= 2 * 16


@pytest.fixture(scope="module")
def runtimes():
    """The JAX package's random fp32 target and draft (max_length 64), and the
    port's runtimes over the same weights."""
    cfg = JaxConfig(**dict(TINY, max_position_embeddings=64))
    jax_rt = {k: jax_auto.random_runtime(cfg, 64, dtype=jnp.float32, seed=s)
              for k, s in (("target", 3), ("draft", 4))}
    port_rt = {k: runtime_from_numpy(jax_tree(rt.params), cfg, 64) for k, rt in jax_rt.items()}
    return jax_rt, port_rt


def jax_tree(params):
    import jax

    return jax.tree_util.tree_map(np.asarray, params)


def test_autoregressive_decode_equals_the_jax_example(runtimes):
    jax_rt, port_rt = runtimes
    ids = np.random.default_rng(5).integers(3, 128, 9).tolist()
    want, _ = jax_example("generate").autoregressive_decode(jax_rt["target"], ids,
                                                           max_new_tokens=12)
    gen = port_example("generate")
    got, tpot = gen.autoregressive_decode(port_rt["target"], ids, max_new_tokens=12)
    assert got == [int(t) for t in want] and tpot >= 0
    # sampled: the first token is still the prefill's argmax (as in the JAX example)
    sampled, _ = gen.autoregressive_decode(port_rt["target"], ids, max_new_tokens=12,
                                           greedy=False, seed=7)
    assert len(sampled) == 12 and sampled[0] == got[0]
    assert all(0 <= t < TINY["vocab_size"] for t in sampled)


def test_measure_acceptance_and_the_tree_equal_the_jax_example(runtimes, tmp_path):
    jax_rt, port_rt = runtimes
    rng = np.random.default_rng(6)
    seqs = [rng.integers(3, 128, n).tolist() for n in (5, 30, 70)]  # skipped, whole, cut to 56
    want = jax_example("construct_sequoia").measure_acceptance(
        jax_rt["draft"], jax_rt["target"], seqs, num_beams=8, max_len=64)
    cs = port_example("construct_sequoia")
    got = cs.measure_acceptance(port_rt["draft"], port_rt["target"], seqs, num_beams=8,
                                max_len=64)
    assert got == want and len(got) == 8 and sum(got) <= 1.0
    generate_sequoia_tree(5, 6, acc=got, json_file=str(tmp_path / "port.json"))
    jax_generate_sequoia_tree(5, 6, acc=want, json_file=str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_construct_sequoia_main_writes_the_jax_tree(pair, tmp_path):
    """The whole script over the checkpoint pair and its tokenizer: the
    acceptance of DEFAULT_TEXTS and the tree equal the JAX package's."""
    jax_cs = jax_example("construct_sequoia")
    assert port_example("construct_sequoia").DEFAULT_TEXTS == jax_cs.DEFAULT_TEXTS
    rt = {k: jax_auto.AutoModelLM.from_pretrained(pair[k], max_length=1024)
          for k in ("target", "draft")}
    tok = pair["tokenizer"]
    want = jax_cs.measure_acceptance(rt["draft"], rt["target"],
                                     [tok.encode(t) for t in jax_cs.DEFAULT_TEXTS])
    out = str(tmp_path / "tree.json")
    acc, path = port_example("construct_sequoia").main(
        ["--draft_model", pair["draft"], "--target_model", pair["target"], "--width", "4",
         "--depth", "3", "--output", out, "--device", "cpu"])
    assert acc == want and path == out
    jax_generate_sequoia_tree(4, 3, acc=want, json_file=str(tmp_path / "jax.json"))
    assert (tmp_path / "jax.json").read_bytes() == open(out, "rb").read()


SMALL_70B = dict(hidden_size=64, intermediate_size=128, head_dim=16, num_heads=4, num_kv_heads=2,
                 vocab_size=256, tree_size=8, kv_len=64, group_size=32)


def test_bench_70b_layer_equals_jax_llama_layer():
    from umbrella_tpu.models.kv_cache import init_kv_cache
    from umbrella_tpu.models.llama import StaticModelArgs, llama_layer
    from umbrella_tpu.ops.masks import tree_mask_rows
    from umbrella_tpu.ops.rope import rope_params
    from umbrella_tpu.quantization.awq import AwqTensor

    b70 = port_example("bench_70b")
    b = b70.build_layer(**SMALL_70B, num_nodes=16, dtype=torch.float32, device="cpu")
    got = b70.layer_output(b, b["x0"]).numpy()
    # the JAX example's draws (examples/bench_70b.py:81-110) at the same widths, fp32
    s = SMALL_70B
    H, I, D, S, L, GS = (s["hidden_size"], s["intermediate_size"], s["head_dim"],
                         s["tree_size"], s["kv_len"], s["group_size"])
    cfg = JaxConfig(vocab_size=s["vocab_size"], hidden_size=H, intermediate_size=I,
                    num_hidden_layers=1, num_attention_heads=s["num_heads"],
                    num_key_value_heads=s["num_kv_heads"], head_dim=D, rope_theta=500000.0,
                    max_position_embeddings=L, tie_word_embeddings=False, eos_token_id=-100)
    rng = np.random.default_rng(0)

    def q(k_dim, n_dim):
        G = k_dim // GS
        return AwqTensor(
            w8=jnp.asarray(rng.integers(0, 256, (k_dim // 2, n_dim), dtype=np.uint8)
                           .view(np.int8)),
            scales=jnp.asarray(rng.uniform(0.001, 0.01, (G, n_dim)).astype(np.float32)),
            zeros=jnp.asarray(rng.integers(0, 16, (G, n_dim)).astype(np.float32)))

    Hq, KV = s["num_heads"] * D, s["num_kv_heads"] * D
    lw = {"input_norm": jnp.ones(H, jnp.float32), "post_norm": jnp.ones(H, jnp.float32),
          "wqkv": q(H, Hq + 2 * KV), "wo": q(Hq, H), "gate_up": q(H, 2 * I), "down": q(I, H)}
    bitmap = np.eye(S, dtype=bool)
    bitmap[:, 0] = True
    nn = jnp.int32(16)
    x0 = jnp.asarray(rng.standard_normal((S, H)), jnp.float32)
    rp = rope_params(cfg)
    want, _ = llama_layer(StaticModelArgs.from_config(cfg, n_layers=1), lw, x0,
                          init_kv_cache(cfg, L, jnp.float32, num_layers=1), 0,
                          nn + jnp.zeros(S, jnp.int32), tree_mask_rows(nn, jnp.asarray(bitmap), L),
                          nn, rp["rope_inv_freq"], rp["rope_scale"])
    want = np.asarray(want)
    np.testing.assert_allclose(b["x0"].numpy(), np.asarray(x0))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_bench_70b_extrapolation_and_measure():
    b70 = port_example("bench_70b")
    layer_s, head_s, n, S, H = 0.002, 0.005, 80, 128, 8192
    step = b70.extrapolate(layer_s, head_s, 400e6, 500e6, n, S, H, device_bytes=80e9)
    psum = 2 * S * H * 4  # two fp32 all_reduces of [S, H] a layer
    for tp in (1, 4, 8):
        coll = 0.0 if tp == 1 else n * 2 * (tp - 1) / tp * psum / 450e9
        verify = 1000 * ((n * layer_s + head_s) / tp + coll)
        d = step[f"tp{tp}"]
        assert d["verify_ms"] == round(verify, 2) and d["collective_ms"] == round(1000 * coll, 2)
        assert d["fits_hbm"] == ((400e6 * n + 500e6) / tp < 80e9)
        assert d["proj_tok_s_accept5"] == round(5000 / d["verify_ms"], 1)
    hop = 3 * S * H * 2 / 450e9
    assert step["pp4"]["verify_ms"] == round(1000 * (n * layer_s + head_s + hop), 2)
    assert b70.extrapolate(layer_s, head_s, 400e6, 500e6, n, S, H)["tp1"]["fits_hbm"] is None
    res = b70.measure(**SMALL_70B, num_layers=4, dtype=torch.float32, device="cpu", n1=1, n2=2)
    d = res["detail"]
    assert d["platform"] == "cpu" and "tp8" in d["extrapolated_verify_step"]
    assert set(d["offload_tier"]) == {"layer_stream_ms_measured", "link_GBps_measured",
                                      "split_measured", "offload_step_ms_measured_stream"}
    # no TPU constant survives in the port's copy
    src = open(b70.__file__).read()
    assert "819e9" not in src and "90e9" not in src and "draft_ms = 8.0" not in src


def test_bench_resident_and_offload_print_the_jax_line(pair, capsys):
    bench = port_example("bench")
    line = re.compile(r"decode step \(4 tokens @ prefix 16\): [0-9.]+ ms  "
                      r"\([0-9.]+ tok verified/s\)")
    for extra in ([], ["--offload", "--num_cache_layers", "1"]):
        res = bench.main(["--model", pair["target"], "--max_length", "128", "--prefix_len", "16",
                          "--decode_len", "4", "--iters", "2", "--device", "cpu"] + extra)
        assert line.search(capsys.readouterr().out) and res["step_ms"] > 0


def _jax_soak_keys():
    """The keys of the JAX example's result and of its "detail" (the dict
    literal it prints, examples/serve_soak.py)."""
    tree = ast.parse(open(os.path.join(REPO, "examples", "serve_soak.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "result":
            keys = [k.value for k in node.value.keys]
            detail = node.value.values[keys.index("detail")]
            return keys, [k.value for k in detail.keys]
    raise AssertionError("no result dict in the JAX example")


def test_serve_soak_tiny_resolves_every_request(capsys):
    res = port_example("serve_soak").main(
        ["--model-class", "tiny", "--batch", "2", "--requests", "6", "--max-new", "8",
         "--prompt-min", "8", "--prompt-max", "24", "--max-len", "256", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys, detail = _jax_soak_keys()
    assert list(printed) == keys and list(printed["detail"]) == detail
    outs = res["outputs"]
    assert len(outs) == 6 and all(len(o["generated_tokens"]) >= 1 for o in outs)
    assert printed["detail"]["total_tokens"] == sum(len(o["generated_tokens"]) for o in outs)
    assert printed["detail"]["platform"] == "cpu" and printed["value"] > 0


def test_question_set_is_the_jax_packages_copy():
    with open(os.path.join(REPO, "umbrella_tpu", "data", "question.jsonl"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "umbrella_tpu_torch", "data", "question.jsonl"), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("name", MODULES)
def test_each_example_defaults_to_cuda_and_raises_without_it(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--draft_model", "d", "--target_model", "t"] if name == "construct_sequoia" else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_example(name).main(argv)
