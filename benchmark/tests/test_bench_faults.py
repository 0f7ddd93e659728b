"""The whole run on the CPU at tiny sizes, the look for a card skipped: sound,
it comes out correct; with the timed path broken underneath (a token altered
where the verify produces it), it comes out not correct."""
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_cell

CELLS = ["mistral7b_awq.serve32", "mixtral8x7b.chat", "mistral7b_awq.chat"]
LIMIT = 0.3  # the tiny bf16 program reads below 0.1 on the CPU; an altered token ~1


def run(name):
    torch.set_num_threads(2)
    c = tiny_cell(name)
    c["limits"]["max_gap"] = LIMIT
    return harness.run_cell(c, seed=2 ** 31 + 3, seconds=3.0, trace=False,
                            device=torch.device("cpu"), t_start=time.time())


def altered(orig, vocab):
    def accept_and_commit(*args):
        block, path, alen, eos = orig(*args)
        return (block + vocab // 2) % vocab, path, alen, eos
    return accept_and_commit


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert res["checks"]["tokens_checked"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_altered_token_is_not_correct(name, monkeypatch):
    from umbrella_tpu_torch.serving import batched_engine
    from umbrella_tpu_torch.speculation import verify

    vocab = tiny_cell(name)["config"]["vocab_size"]
    monkeypatch.setattr(verify, "accept_and_commit", altered(verify.accept_and_commit, vocab))
    monkeypatch.setattr(batched_engine, "accept_and_commit",
                        altered(batched_engine.accept_and_commit, vocab))
    res = run(name)
    assert not res["correct"]
    assert res["checks"]["max_gap"]["value"] > LIMIT
