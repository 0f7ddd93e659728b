"""The port's counterparts of the JAX package's `examples/` scripts, each run as

    python -m umbrella_tpu_torch.examples.<name> [--device cuda|cpu] ...

with <name> one of spec_generate, spec_bench, spec_bench_python, generate,
construct_sequoia, bench, bench_70b, serve_soak, multihost_demo (and its
multihost_worker). Each `main(argv=None)` parses the JAX example's options plus
`--device` (default cuda: it raises without CUDA; cpu runs the kernels' plain
versions) and builds the engine or runtime; a second function does the
measuring on an engine or runtime it is given and returns its numbers.
"""
import os

import torch

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def engine_config(config: dict) -> dict:
    """A config file's engine keys with a "dtype" name ("float32") as the torch
    dtype the engines take."""
    config = dict(config)
    if isinstance(config.get("dtype"), str):
        config["dtype"] = getattr(torch, config["dtype"])
    return config


def step_runner(phases, device: torch.device, generators=()):
    """`run(n)`: n steps of `phases` (cuda_graphs.Phase; the first reads no
    outside value). On the card the step is captured once as CUDA graphs
    (cuda_graphs.StepGraph, whose replays add the step's kernel launches to
    the counts) and `run` replays it without waiting for the device; on the
    CPU each step runs eagerly. The capture runs the step once eagerly: its
    writes must be ones the caller overwrites before the first `run`."""
    from ..cuda_graphs import StepGraph, run_phases

    if device.type == "cuda":
        return StepGraph.capture(phases, {}, generators).replay

    def run(n: int) -> None:
        for _ in range(n):
            run_phases(phases)

    return run


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def platform(device: torch.device) -> str:
    """"gpu <card name>" on the card, else the device type."""
    return f"gpu {torch.cuda.get_device_name(device)}" if device.type == "cuda" else device.type
