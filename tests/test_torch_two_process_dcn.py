"""Two OS processes joined by the port's parallel/distributed.initialize
(gloo over a localhost TCPStore, four CPU devices each), launched by
umbrella_tpu_torch/examples/multihost_demo.launch: the counterpart of
tests/test_two_process_dcn.py, not marked slow (the run takes seconds).

Asserted: both processes train over the (data=2, model=4) grid (tensor- and
sequence-parallel step, the gradient sum across the processes) with the
same losses, equal to the same grid's losses in one process (bit for bit:
both add every replica's gradient in replica order in fp32); the
tensor_parallel=8 static engine spanning both processes commits the same
tokens on both and the prompt's logits bit for bit, equal to the one-process
tensor_parallel=8 engine's; the batched engine (B=2, priority order) gives
both the same tokens, the one-process engine's. A worker that fails, or a
run past 180 s, fails the test.
"""
import os

import torch

from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.examples import multihost_worker as worker
from umbrella_tpu_torch.examples.multihost_demo import launch, write_tiny_checkpoint

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

CPU = torch.device("cpu")


def test_two_process_train_and_decode(tmp_path):
    ckpt = os.path.join(tmp_path, "ckpt")
    write_tiny_checkpoint(ckpt, worker.TINY_CFG, seed=3)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r0, r1 = launch(["--ckpt-dir", ckpt, "--tensor-parallel", "8"], ["cpu,cpu,cpu,cpu"] * 2,
                    str(tmp_path), timeout=180, env=env)
    assert r0["process_count"] == r1["process_count"] == 2
    assert r0["backend"] == r1["backend"] == "gloo"
    assert "backend gloo" in r0["log"] and "backend gloo" in r1["log"]
    assert [[p for p, _ in row] for row in r0["grid"]] == [[0] * 4, [1] * 4]

    # one process: the same grid, the same engines over the same checkpoint
    losses = worker.train_grid(ModelConfig.from_dict(worker.TINY_CFG), [[CPU] * 4] * 2)["losses"]
    assert r0["losses"] == r1["losses"] == losses and losses[-1] < losses[0]
    one = worker.static_decode(ckpt, ckpt, 8, CPU, torch.float32, worker.MAX_LEN, 12)
    assert r0["committed"] == r1["committed"] == one["tokens"] and len(one["tokens"]) >= 12
    for i in (0, 1):
        got = torch.load(os.path.join(tmp_path, f"worker{i}.json.logits.pt"))
        assert torch.equal(got, one["logits"])
    batched = worker.batched_decode(ckpt, ckpt, 8, CPU, torch.float32, worker.MAX_LEN)
    assert r0["batched"] == r1["batched"] == batched
    assert all(len(t) >= 6 for t in batched)
    # 2 row products a layer and the head's gather, one gather each
    assert r0["static"]["gathers_per_forward"] == 2 * 2 + 1
