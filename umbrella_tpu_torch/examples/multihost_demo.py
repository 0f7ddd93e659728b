"""Launch a two-process run of umbrella_tpu_torch/examples/multihost_worker.py:
counterpart of `examples/multihost_demo.py`.

    python -m umbrella_tpu_torch.examples.multihost_demo [--device cuda|cpu]

Spawns two processes on this host, joined over a localhost coordinator
(parallel/distributed.initialize), each driving four shard devices: its
half of the cards (all on one card where there is one), or four CPU devices
with `--device cpu`; without CUDA the default raises. Checks that both
trained over the (data=2, model=4) grid with identical losses, and that a
tensor_parallel=8 static engine and batched engine whose collectives span
both processes committed identical tokens on both. Writes the result to
build/multihost/two_process_run.json. The checkpoint is a tiny random
llama written here with numpy (`write_tiny_checkpoint`).

`launch` is the launcher the tests and the chip check use: a child that
fails, or that outlives the timeout, fails the launch (the others are
killed), and nothing is retried.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ST_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.int32): "I32"}


def write_safetensors(path: str, tensors: dict) -> None:
    """A safetensors file of numpy arrays (fp32 or int32): an 8-byte
    little-endian header length, the JSON header, then each array's bytes."""
    header, offset, blobs = {}, 0, []
    for name, a in tensors.items():
        a = np.ascontiguousarray(a)
        header[name] = dict(dtype=_ST_DTYPES[a.dtype], shape=list(a.shape),
                            data_offsets=[offset, offset + a.nbytes])
        offset += a.nbytes
        blobs.append(a.tobytes())
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for b in blobs:
            f.write(b)


def write_tiny_checkpoint(path: str, cfg: dict, seed: int) -> None:
    """An HF-format llama checkpoint directory (config.json and fp32
    model.safetensors) of N(0, 0.02) weights and unit norms from `seed`."""
    rng = np.random.default_rng(seed)
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    D = cfg.get("head_dim") or H // cfg["num_attention_heads"]
    Hq, KV = cfg["num_attention_heads"] * D, cfg["num_key_value_heads"] * D

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": np.ones(H, np.float32),
          "lm_head.weight": w(V, H)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = np.ones(H, np.float32)
        sd[p + "post_attention_layernorm.weight"] = np.ones(H, np.float32)
        for name, shape in (("self_attn.q_proj", (Hq, H)), ("self_attn.k_proj", (KV, H)),
                            ("self_attn.v_proj", (KV, H)), ("self_attn.o_proj", (H, Hq)),
                            ("mlp.gate_proj", (I, H)), ("mlp.up_proj", (I, H)),
                            ("mlp.down_proj", (H, I))):
            sd[p + name + ".weight"] = w(*shape)
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(cfg, model_type="llama", architectures=["LlamaForCausalLM"],
                       tie_word_embeddings=False), f)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(worker_args: Sequence[str], devices: Sequence[str], out_dir: str,
           timeout: float = 180.0, env: Optional[dict] = None) -> list:
    """Run one worker a process (len(devices) of them; devices[p] is process
    p's --devices) with `worker_args`, and return their results in process
    order. Raises if a worker exits non-zero or the run outlives `timeout`
    seconds; the other workers are killed then."""
    n = len(devices)
    port = free_port()
    outs = [os.path.join(out_dir, f"worker{i}.json") for i in range(n)]
    logs = [open(os.path.join(out_dir, f"worker{i}.log"), "w+") for i in range(n)]
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "umbrella_tpu_torch.examples.multihost_worker",
         "--process-id", str(i), "--num-processes", str(n),
         "--coordinator", f"127.0.0.1:{port}", "--devices", devices[i], "--out", outs[i],
         "--spawned-at", repr(time.time()), *worker_args],
        cwd=REPO, env=env, stdout=logs[i], stderr=subprocess.STDOUT) for i in range(n)]
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad:
                failed = f"worker {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.time() > deadline:
                failed = f"the workers outlived the timeout of {timeout} s"
                break
            time.sleep(0.05)
        else:
            bad = [i for i, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"worker {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for f in logs:
        f.seek(0)
        text.append(f.read())
        f.close()
    if failed:
        raise RuntimeError(failed + "\n" + "\n".join(
            f"--- worker {i} ---\n{t[-4000:]}" for i, t in enumerate(text)))
    results = []
    for o, t in zip(outs, text):
        with open(o) as f:
            results.append(dict(json.load(f), log=t))
    return results


def shard_devices(device: str, shards: int = 4, processes: int = 2) -> list:
    """Each process's --devices: `shards` CPU devices, or its half of the
    visible cards in turn (every shard on card 0 where there is one);
    raises without CUDA unless `device` is "cpu"."""
    if device == "cpu":
        return [",".join(["cpu"] * shards)] * processes
    import torch

    from ..utils import resolve_device

    resolve_device(device)
    n = torch.cuda.device_count()
    per = max(n // processes, 1)
    return [",".join(f"cuda:{c}" for c in itertools.islice(
        itertools.cycle(range((p * per) % n, (p * per) % n + per)), shards))
        for p in range(processes)]


def main(argv=None):
    from .multihost_worker import TINY_CFG

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    devices = shard_devices(args.device)
    root = tempfile.mkdtemp(prefix="multihost-")
    ckpt = os.path.join(root, "ckpt")
    write_tiny_checkpoint(ckpt, TINY_CFG, seed=3)
    r0, r1 = launch(["--ckpt-dir", ckpt, "--tensor-parallel", "8"], devices, root)
    assert r0["process_count"] == 2 and r0["backend"] == r1["backend"]
    assert r0["losses"] == r1["losses"] and r0["losses"][-1] < r0["losses"][0], r0["losses"]
    assert r0["committed"] == r1["committed"] and len(r0["committed"]) >= 3
    assert r0["batched"] == r1["batched"] and all(len(t) >= 6 for t in r0["batched"])
    artifact = dict(
        metric="two_process_run", ok=True, process_count=2, backend=r0["backend"],
        grid=r0["grid"], losses=r0["losses"], committed_tokens_identical=True,
        committed_len=len(r0["committed"]), batched_serving_tokens_identical=True,
        batched_requests=len(r0["batched"]),
        spawn_to_ready_s=[r0["spawn_to_ready_s"], r1["spawn_to_ready_s"]],
        devices=devices,
        detail="torch.distributed over a localhost TCPStore, two processes of 4 shard devices: "
               "the (data=2, model=4) grid's tensor- and sequence-parallel train step, its "
               "gradients summed across the processes; a tensor_parallel=8 static engine and "
               "batched engine (B=2, priority admission order) spanning both processes")
    out = os.path.join(REPO, "build", "multihost")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "two_process_run.json"), "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact), flush=True)


if __name__ == "__main__":
    code = 0
    try:
        main()
    except Exception:
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # torch's interpreter shutdown can stall for minutes
