"""One process of a multi-process run: counterpart of
`examples/multihost_worker.py`.

    python -m umbrella_tpu_torch.examples.multihost_worker --process-id {0,1} \\
        --coordinator localhost:PORT [--devices cuda:0,cuda:1] --ckpt-dir DIR --out OUT.json

Launched by umbrella_tpu_torch/examples/multihost_demo.py (two processes).
Each process drives `--devices` (a device may repeat: two processes may share
one card, or the CPU; by default its share of the visible cards, and it
raises without CUDA). The worker:
  1. joins the group (parallel/distributed.initialize; the backend follows
     from the layout: NCCL where each process has cards of its own, gloo
     otherwise) and lays the (data, model) grid make_multihost_mesh gives:
     model rows inside a process, the data axis across processes;
  2. runs the tensor- (and sequence-) parallel train step over that grid,
     its gradient sums across processes (training/data_parallel.py);
  3. decodes greedily with a static engine whose `tensor_parallel` spans
     both processes (each holds its block of shards; the collectives cross
     the process boundary), and takes the target's logits on the prompt;
  4. runs the tensor-parallel batched engine (B=2 slots, continuous batching)
     over requests admitted in the scheduler's priority order (priority,
     arrival), which both processes compute alike from the same list;
then writes its result to --out (the prompt's logits beside it, OUT.logits.pt)
and ends with os._exit: torch's interpreter shutdown can stall for minutes.

The target is a checkpoint directory (`--ckpt-dir`, loaded and sharded by
the engines) or a random AWQ llama from a seed (`--random-target` config
JSON), sharded here over --devices; the draft is the same directory, or
`--random-draft`, also from a seed. The functions below run
a step in one process too (span None): the reference that the processes'
results are held to.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

TINY_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=8, num_key_value_heads=8, max_position_embeddings=256,
                eos_token_id=-1)
MAX_LEN = 128
TREE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "trees",
                    "sequoia_tree-3x4.json")
PROMPT = [1, 2, 3, 4]
TARGET_SEED, DRAFT_SEED = 3, 7  # random_models' weights
REQUESTS = [dict(input_ids=[1, 2, 3, 4], max_new_tokens=6, _priority=5),
            dict(input_ids=[9, 8, 7], max_new_tokens=6, _priority=1),
            dict(input_ids=[5, 5, 5, 5, 5], max_new_tokens=6, _priority=5),
            dict(input_ids=[2, 4, 6], max_new_tokens=6, _priority=1)]


class WordTokenizer:
    """Decodes ids as space-separated numbers (the checkpoints carry no tokenizer)."""

    def decode(self, ids, **kw):
        return " ".join(str(i) for i in ids)


def train_grid(cfg, rows, span=None, batch=(4, 32), steps=3, dtype=torch.float32,
               sequence_parallel=True, seed=0) -> dict:
    """`steps` tensor-parallel train steps over `rows` (this process's rows
    of the grid; a row: a replica's shard devices), the data axis across the
    processes of `span`: every process builds the same params from `seed`
    and takes the same global batch. Returns the losses and ms a step (the
    steps after the first, synchronised)."""
    from ..models.llama import StaticModelArgs
    from ..parallel.mesh import shard_train_params
    from ..training import train_draft
    from ..training.data_parallel import make_dp_train_step
    from ..training.draft_trainer import init_train_state, make_optimizer

    params = train_draft.init_train_params(cfg, batch[1], rows[0][0], dtype, packed=False,
                                           seed=seed)
    state = init_train_state(shard_train_params(params, rows[0]),
                             make_optimizer(total_steps=steps + 1))
    step = make_dp_train_step(StaticModelArgs.from_config(cfg), None, rows, sequence_parallel,
                              span)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, batch).astype(np.int32)
    ids = torch.from_numpy(ids).to(rows[0][0])
    losses, t0 = [], time.time()
    for i in range(steps):
        if i == 1:
            t0 = time.time()
        state, loss = step(state, ids)
        losses.append(float(loss))  # a host read: every step ends synchronised
    return dict(losses=losses, step_ms=(time.time() - t0) * 1e3 / max(steps - 1, 1))


def random_models(target_cfg: dict, draft_cfg: dict, devices, span, dtype, max_len):
    """(a random AWQ target in the tensor-parallel layout from TARGET_SEED,
    sharded over `devices` as this process's block of the span; a random
    dense draft from DRAFT_SEED), both built on devices[0]."""
    from ..config import ModelConfig
    from ..models.auto_model import random_awq_runtime, random_runtime
    from ..parallel.mesh import shard_runtime

    tcfg = ModelConfig.from_dict(dict(target_cfg, max_position_embeddings=max_len))
    dcfg = ModelConfig.from_dict(dict(draft_cfg, max_position_embeddings=max_len))
    target = random_awq_runtime(tcfg, max_len, dtype=dtype, seed=TARGET_SEED, packed=False,
                                device=devices[0])
    shard_runtime(target, devices, span=span)
    draft = random_runtime(dcfg, max_len, dtype=dtype, seed=DRAFT_SEED, device=devices[0])
    return target, draft


def prompt_logits(target, prompt, max_len) -> torch.Tensor:
    """The target's fp32 logits on the prompt, on a fresh cache (eager)."""
    from ..ops.masks import causal_mask_rows

    dev, S = target.device, len(prompt)
    with torch.no_grad():
        return target.forward(target.params, target.init_kv(), torch.tensor(prompt, device=dev),
                              torch.arange(S, device=dev),
                              causal_mask_rows(0, S, max_len, device=dev), 0)[0]


def static_decode(target, draft, tp: int, device, dtype, max_len, new_tokens, span=None,
                  prompt=PROMPT, tree=TREE) -> dict:
    """A greedy generate() of the static engine with tensor_parallel `tp`
    over `target` (a runtime or a checkpoint directory): tokens, the prompt's
    logits, ms a decode step, the gathers over the process group in one
    target forward and in the whole generate() (prefill included), and the
    kernels' launches in the generate()."""
    from ..ops.kernels import launch_counts, reset_launch_counts
    from ..speculation.auto_engine import AutoEngine

    eng = AutoEngine.from_config(
        model=target, draft_model=draft, engine="static", tensor_parallel=tp,
        growmap_path=tree, max_length=max_len, safe_buffer=32, temperature=0.0,
        eos_token_ids=[-1], tokenizer=WordTokenizer(), dtype=dtype, device=device)
    eng.initialize()
    calls = span.calls if span is not None else 0
    logits = prompt_logits(eng.target_model, prompt, max_len).cpu()
    per_forward = span.calls - calls if span is not None else 0
    reset_launch_counts()
    out = eng.generate(input_ids=prompt, max_new_tokens=new_tokens)
    launches = {k: n for k, n in launch_counts().items() if n}
    toks = out["generated_tokens"]
    steps = max(1, round(len(toks) / out["avg_accept_tokens"]))
    return dict(tokens=toks, logits=logits, steps=steps,
                step_ms=out["time_per_output_token"] * len(toks) / steps,
                gathers_per_forward=per_forward,
                gathers_in_generate=(span.calls - calls - per_forward if span is not None else 0),
                launches=launches)


def batched_decode(target, draft, tp: int, device, dtype, max_len, requests=REQUESTS,
                   tree=TREE) -> list:
    """The tensor-parallel batched engine (B=2, 2-step segments) over
    `requests`, admitted in the scheduler's order (priority, arrival): each
    request's tokens, in the list's order."""
    from ..speculation.auto_engine import AutoEngine

    eng = AutoEngine.from_config(
        model=target, draft_model=draft, engine="batched_static", tensor_parallel=tp,
        batch_size=2, segment_steps=2, growmap_path=tree, max_length=max_len, safe_buffer=32,
        temperature=0.0, eos_token_ids=[-1], tokenizer=WordTokenizer(), dtype=dtype,
        device=device)
    eng.initialize()
    order = sorted(range(len(requests)), key=lambda i: (requests[i]["_priority"], i))
    done = eng.run([{k: v for k, v in requests[i].items() if k != "_priority"} for i in order])
    tokens = [None] * len(requests)
    for rank, i in enumerate(order):
        tokens[i] = done[rank]["generated_tokens"]
    return tokens


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", type=str, required=True)
    p.add_argument("--devices", type=str, default=None,
                   help="this process's devices, comma-separated (a device may repeat); "
                        "default: its share of the visible cards")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--random-target", type=str, default=None, help="a config JSON file")
    p.add_argument("--random-draft", type=str, default=None, help="a config JSON file")
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--tensor-parallel", type=int, default=0, help="0: every device of both")
    p.add_argument("--max-length", type=int, default=MAX_LEN)
    p.add_argument("--new-tokens", type=int, default=12)
    p.add_argument("--train-config", type=str, default=None, help="a config JSON file")
    p.add_argument("--train-batch", type=str, default="4,32")
    p.add_argument("--spawned-at", type=float, default=None)
    return p.parse_args(argv)


def _config(path, default):
    from ..config import ModelConfig

    if path is None:
        return ModelConfig.from_dict(default)
    with open(path) as f:
        return ModelConfig.from_dict(json.load(f))


def default_devices(process_id: int, num_processes: int) -> list:
    """Process p's share of the visible cards (a block of cards // P, or the
    first card for each where there are fewer cards than processes); raises
    without CUDA."""
    from ..utils import resolve_device

    resolve_device("cuda")
    n = torch.cuda.device_count()
    per = max(n // num_processes, 1)
    first = (process_id * per) % n
    return [torch.device("cuda", first + i) for i in range(per)]


def run(args) -> dict:
    from ..parallel import distributed

    devices = ([torch.device(d) for d in args.devices.split(",")] if args.devices
               else default_devices(args.process_id, args.num_processes))
    if all(d.type == "cpu" for d in devices) and "OMP_NUM_THREADS" not in os.environ:
        # the processes share the host's cores: more threads make them spin
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.num_processes))
    backend = distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                                     devices=devices)
    ready_s = None if args.spawned_at is None else time.time() - args.spawned_at
    span = distributed.span()
    grid = distributed.make_multihost_mesh()
    rows = distributed.local_rows(grid)
    dtype = getattr(torch, args.dtype)
    t0 = time.time()
    train = train_grid(_config(args.train_config, TINY_CFG), rows, span,
                       tuple(int(x) for x in args.train_batch.split(",")))
    train_s = time.time() - t0
    tp = args.tensor_parallel or len(devices) * args.num_processes
    if args.random_target:
        with open(args.random_target) as f:
            tcfg = json.load(f)
        with open(args.random_draft or args.random_target) as f:
            dcfg = json.load(f)
        target, draft = random_models(tcfg, dcfg, devices[:tp // args.num_processes], span,
                                      dtype, args.max_length)
    else:
        target = draft = args.ckpt_dir
    static = static_decode(target, draft, tp, devices[0], dtype, args.max_length,
                           args.new_tokens, span)
    torch.save(static.pop("logits"), args.out + ".logits.pt")
    batched = batched_decode(target, draft, tp, devices[0], dtype, args.max_length)
    return dict(process_id=args.process_id, process_count=distributed.process_count(),
                backend=backend, devices=[str(d) for d in devices],
                grid=[[[g.process, str(g.device)] for g in row] for row in grid],
                spawn_to_ready_s=ready_s, train_s=train_s, losses=train["losses"],
                train_step_ms=train["step_ms"],
                committed=static["tokens"], static=static, batched=batched)


def main(argv=None):
    args = parse_args(argv)
    code = 0
    try:
        result = run(args)
        with open(args.out, "w") as f:
            json.dump(result, f)
        print("worker", args.process_id, "ok", flush=True)
    except Exception:  # the launcher reads the exit code and this traceback
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    main()
