"""The port's training entry point (training/train_draft.py, the counterpart
of draft/train_draft.py) on the CPU: a tiny config trained from a .npy token
file, its checkpoints, and what it refuses."""
import json
import os

import numpy as np
import pytest
import torch

from umbrella_tpu_torch.training import train_draft

TINY = dict(model_type="llama", vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64, eos_token_id=2, tie_word_embeddings=False)


def _files(tmp_path, n_tokens=2000, period=0):
    cfg = os.path.join(tmp_path, "config.json")
    with open(cfg, "w") as f:
        json.dump(TINY, f)
    rng = np.random.default_rng(0)
    if period:
        tokens = np.tile(rng.integers(0, TINY["vocab_size"], period), n_tokens // period + 1)
    else:
        tokens = rng.integers(0, TINY["vocab_size"], n_tokens)
    data = os.path.join(tmp_path, "tokens.npy")
    np.save(data, tokens[:n_tokens].astype(np.int32))
    return cfg, data


def _argv(cfg, data, out, *extra):
    return ["--config", cfg, "--data", data, "--output_dir", out, "--device", "cpu",
            "--batch_size", "4", "--seq_len", "32", *extra]


@pytest.mark.parametrize("dp", [1, 2])
def test_trains_from_npy_and_keeps_two_checkpoints(tmp_path, capsys, dp):
    cfg, data = _files(tmp_path, period=17)
    out = os.path.join(tmp_path, "ckpt")
    losses = train_draft.main(_argv(cfg, data, out, "--steps", "50", "--save_steps", "20",
                                    "--lr", "1e-2", "--dp", str(dp)))
    assert len(losses) == 50 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0] - 1.0  # a periodic stream is learnt
    printed = capsys.readouterr().out
    assert "0.0M tokens -> 62 windows of 32" in printed
    assert "step 50 loss " in printed and "K tok/s)" in printed
    assert sorted(os.listdir(out)) == ["ckpt_40.pt", "ckpt_50.pt"]  # save_total_limit=2
    ck = torch.load(os.path.join(out, "ckpt_50.pt"), weights_only=False)
    assert ck["step"] == 50
    p = ck["params"]
    assert p["layers"]["wqkv"].dtype == torch.bfloat16 and "wq" not in p["layers"]  # packed
    assert p["rope_scale"].dim() == 0 and p["rope_scale"].dtype == torch.float32


def test_refuses_tensor_parallel(tmp_path):
    """A model axis that does not divide the heads is refused (--tp 2 trains:
    tests/test_torch_tp_train.py)."""
    cfg, data = _files(tmp_path)
    with pytest.raises(ValueError, match="divisible"):
        train_draft.main(_argv(cfg, data, str(tmp_path), "--steps", "2", "--tp", "3"))


@pytest.mark.parametrize("data", ["DKYoon/SlimPajama-6B", "no/such/file.txt"])
def test_refuses_data_that_is_not_local(tmp_path, data):
    cfg, _ = _files(tmp_path)
    with pytest.raises(ValueError, match="must be local"):
        train_draft.main(_argv(cfg, data, str(tmp_path), "--steps", "2"))


def test_defaults_match_the_jax_script():
    a = train_draft.parse_args([])
    assert (a.config, a.data, a.batch_size, a.seq_len, a.steps, a.lr, a.save_steps, a.tp,
            a.dp) == ("draft/config.json", "DKYoon/SlimPajama-6B", 8, 1024, 10000, 3e-4, 5000,
                      1, 0)
    assert train_draft.train_devices("cpu", 0) == [torch.device("cpu")]
    assert train_draft.train_devices("cpu", 2) == [torch.device("cpu")] * 2
    assert train_draft.train_devices("cpu", 0, tp=2) == [[torch.device("cpu")] * 2]
    assert train_draft.train_devices("cpu", 3, tp=2) == [[torch.device("cpu")] * 2] * 3
