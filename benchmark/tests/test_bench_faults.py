"""The whole run on the CPU at tiny sizes, the look for a card skipped: sound,
it comes out correct; with the timed path broken underneath (a token altered
where the verify produces it; in the four-card cell, the exchange between
the cards left out), it comes out not correct."""
import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests.tiny import tiny_cell

CELLS = ["mistral7b_awq.serve32", "mixtral8x7b.chat", "mistral7b_awq.chat",
         "mixtral8x7b.chat_ep4"]
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


def test_exchange_left_out_is_not_correct(monkeypatch):
    """The expert shards' partial sums never reach the first card: each layer
    keeps the first shard's experts alone. Judged by the cell's own number
    and limit (`mean_gap`): at this size the embedding outweighs the experts,
    so the widest gap stays under LIMIT (0.16), while the mean (0.0073 on
    this seed) is six times the limit and a sound run reads 0."""
    from umbrella_tpu_torch.parallel import collectives

    all_reduce = collectives.all_reduce
    monkeypatch.setattr(collectives, "all_reduce",
                        lambda parts, device, dtype, span=None: all_reduce(parts[:1], device, dtype))
    name = "mixtral8x7b.chat_ep4"
    torch.set_num_threads(2)
    c = tiny_cell(name)
    c["limits"]["mean_gap"] = spec.cell(name)["limits"]["mean_gap"]
    res = harness.run_cell(c, seed=2 ** 31 + 3, seconds=3.0, trace=False,
                           device=torch.device("cpu"), t_start=time.time())
    assert not res["correct"]
    assert res["checks"]["mean_gap"]["value"] > c["limits"]["mean_gap"]
