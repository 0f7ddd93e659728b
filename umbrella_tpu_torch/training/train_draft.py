"""Draft-model training script, counterpart of `draft/train_draft.py`.

    python -m umbrella_tpu_torch.training.train_draft --data tokens.npy \\
        [--config draft/config.json] [--device cuda|cpu] [--tp M] [--dp N]

The same flags and defaults as the JAX package's script: a llama-family
draft (`--config`) initialised at random in bf16, packed (`wqkv`,
`gate_up`) where `--tp` is 1 and unpacked otherwise, trained with AdamW
under the warmup-cosine schedule on random windows of `--seq_len` tokens, a
checkpoint every `--save_steps` steps and at the end (the newest 2 kept),
and a loss and K tok/s line every 50 steps. The devices are the JAX
script's `make_mesh(model=tp, data=dp)`: `--dp` replicas (default: the
cards // tp, at least one) split each batch (training/data_parallel.py),
each sharded over `--tp` cards (parallel/mesh.shard_train_params; one
replica's shards on consecutive cards, wrapping round where the cards run
out). A checkpoint holds the params whole (mesh.gather_train_params), so a
draft trained with `--tp` loads into the engines as any other.

Data is local: a `.npy` token file, or a text file tokenized with
`--tokenizer` from the local Hugging Face cache. The JAX script can stream a
dataset from the Hub (`--max_tokens` caps that stream; the flag is kept and
has nothing to cap here); any other `--data` raises.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models.convert import trainable_params
from ..models.llama import StaticModelArgs, init_llama_params
from ..parallel.mesh import gather_train_params, shard_train_params
from .data_parallel import make_dp_train_step
from .draft_trainer import TrainState, init_train_state, make_optimizer, make_train_step, map_params


def load_token_stream(data: str, tokenizer: str) -> np.ndarray:
    """int32 token ids from a `.npy` file, or a local text file tokenized with
    `tokenizer` (a local directory or a name in the local cache)."""
    if data.endswith(".npy"):
        return np.load(data).astype(np.int32)
    if os.path.isfile(data):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(tokenizer, local_files_only=True)
        with open(data) as f:
            return np.asarray(tok.encode(f.read()), np.int32)
    raise ValueError(f"--data {data!r} is neither a .npy token file nor a local text file: "
                     "the data must be local (datasets are not streamed from the network)")


def windows_of(tokens: np.ndarray, seq_len: int) -> np.ndarray:
    """[n, seq_len] consecutive windows of the token stream (the tail dropped)."""
    n = len(tokens) // seq_len
    return tokens[:n * seq_len].reshape(n, seq_len)


def train_devices(device: str, dp: int = 0, tp: int = 1) -> list:
    """The replicas' devices: `dp` of them (0: cards // tp, at least one),
    each one device where tp is 1, else a row of tp devices (a replica's
    shards); the cards of `device`'s type taken in turn, so a card may hold
    several; on the CPU every one is the CPU."""
    if tp < 1:
        raise ValueError(f"--tp {tp} must be at least 1")
    dev = torch.device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n == 0:
        raise RuntimeError(f"device {device} requested but CUDA is not available; pass "
                           "--device cpu to train on the CPU")
    dp = dp or max(n // tp, 1)
    flat = ([torch.device("cuda", i % n) for i in range(dp * tp)] if dev.type == "cuda"
            else [dev] * (dp * tp))
    if tp == 1:
        return flat
    return [flat[r * tp:(r + 1) * tp] for r in range(dp)]


def init_train_params(cfg: ModelConfig, seq_len: int, device, dtype=torch.bfloat16,
                      packed: bool = True, seed: int = 0) -> dict:
    """Random train params (init_llama_params, N(0, 0.02)) on `device`, every
    leaf trainable (rope included)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return trainable_params(init_llama_params(cfg, gen, seq_len, dtype, packed=packed,
                                              device=device))


def make_trainer(cfg: ModelConfig, params: dict, lr: float, steps: int, devices: Sequence):
    """(TrainState, train_step) over `params` (on devices[0]; sharded over it
    where it is a row): one replica's step, or the data-parallel step over
    `devices` (train_devices')."""
    args = StaticModelArgs.from_config(cfg)
    optimizer = make_optimizer(lr=lr, total_steps=steps)
    step = (make_train_step(args, optimizer) if len(devices) == 1
            else make_dp_train_step(args, optimizer, devices))
    return init_train_state(params, optimizer), step


def save_checkpoint(path: str, state: TrainState, step: int, keep: int = 2) -> str:
    """torch.save the params (whole, on the CPU), the optimizer's and the
    schedule's state and the step as ckpt_{step}.pt; keep the newest `keep`."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step}.pt")
    opt, sched = state.opt_state
    params = gather_train_params(state.params) if "tp_shards" in state.params else state.params
    torch.save({"params": map_params(lambda t: t.detach().cpu(), params),
                "optimizer": opt.state_dict(), "scheduler": sched.state_dict(),
                "step": state.step}, fname)
    ckpts = sorted((f for f in os.listdir(path) if f.startswith("ckpt_")),
                   key=lambda f: int(f.split("_")[1].split(".")[0]))
    for old in ckpts[:-keep]:  # save_total_limit=2 (the reference's train_draft.py)
        os.remove(os.path.join(path, old))
    return fname


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="draft/config.json")
    parser.add_argument("--data", type=str, default="DKYoon/SlimPajama-6B")
    parser.add_argument("--tokenizer", type=str, default="mistralai/Mistral-7B-Instruct-v0.3")
    parser.add_argument("--output_dir", type=str, default="draft/checkpoints")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--seq_len", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=10000)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--save_steps", type=int, default=5000)
    parser.add_argument("--max_tokens", type=int, default=50_000_000)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--dp", type=int, default=0, help="0 = use remaining devices")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Train as the flags say; returns the loss of every step."""
    args = parse_args(argv)
    devices = train_devices(args.device, args.dp, args.tp)
    tokens = load_token_stream(args.data, args.tokenizer)
    with open(args.config) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    windows = windows_of(tokens, args.seq_len)
    n_windows = len(windows)
    print(f"{len(tokens)/1e6:.1f}M tokens -> {n_windows} windows of {args.seq_len}")

    first = devices[0] if args.tp == 1 else devices[0][0]
    params = init_train_params(cfg, args.seq_len, first, packed=(args.tp == 1))
    if args.tp > 1:
        params = shard_train_params(params, devices[0])
    state, train_step = make_trainer(cfg, params, args.lr, args.steps, devices)
    rng = np.random.default_rng(0)
    losses = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        idx = rng.integers(0, n_windows, args.batch_size)
        batch = torch.from_numpy(windows[idx]).to(first)
        state, loss = train_step(state, batch)
        losses.append(loss)  # read at the prints and the end, not every step
        if step % 50 == 0:
            print(f"step {step} loss {float(loss):.4f} "
                  f"({step*args.batch_size*args.seq_len/(time.time()-t0)/1e3:.1f}K tok/s)")
        if step % args.save_steps == 0:
            save_checkpoint(args.output_dir, state, step)
    save_checkpoint(args.output_dir, state, args.steps)
    return [float(x) for x in losses]


if __name__ == "__main__":
    main()
