#!/usr/bin/env python3
"""Count autograd's "AccumulateGrad node's stream does not match" warnings in
one staged (GPipe) training step over four cards, for a given checkout.

    python3 scripts/stream_warning_check.py [ROOT]

ROOT (default: this repository) is a checkout whose umbrella_tpu_torch is
imported, so that two versions of the staged step can be compared in one
call on one host: run the script once per checkout, each in its own process
(the warning is issued once a process). It builds draft/config.json's model
at full width in fp32, stages it over cuda:0..3 (parallel/pipeline.
shard_params_pp, 4 microbatches), runs one forward and backward of B 8 x 1024
with every warning recorded, and prints one JSON line: the warnings by text,
the loss, and the card's name and power limit. It needs four cards.
"""
import json
import os
import subprocess
import sys
import warnings


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if torch.cuda.device_count() < 4:
        print("stream_warning_check: needs four cards", file=sys.stderr)
        return 2
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.llama import StaticModelArgs
    from umbrella_tpu_torch.parallel.pipeline import make_pp_forward, shard_params_pp
    from umbrella_tpu_torch.training import train_draft
    from umbrella_tpu_torch.training.draft_trainer import lm_loss

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "draft", "config.json")) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    args = StaticModelArgs.from_config(cfg)
    devices = [torch.device("cuda", i) for i in range(4)]
    params = train_draft.init_train_params(cfg, 1024, devices[0], torch.float32, packed=True,
                                           seed=0)
    staged = shard_params_pp(params, devices)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 1024)).astype(np.int32)).to(devices[0])
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        loss = lm_loss(make_pp_forward(args, devices, 4)(staged, ids), ids)
        loss.backward()
        for d in devices:
            torch.cuda.synchronize(d)
    texts = [str(w.message) for w in seen]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(root=root, loss=float(loss.detach()), warnings=len(texts),
                          stream_mismatch=sum("AccumulateGrad node's stream" in t
                                              for t in texts),
                          texts=[t[:200] for t in texts],
                          card=card.strip().splitlines()[0])), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)  # skip interpreter teardown, which can stall after CUDA work
