"""Profiling and tracing utilities.

Counterpart of `umbrella_tpu/profiling.py`: `trace` captures a
`torch.profiler` trace (host ops and, on a card, its kernels) into a Chrome
trace file, where the JAX package captures a `jax.profiler` trace for
TensorBoard; `PhaseTimer` sums wall-clock time by phase, and `block_on`
waits for the device of the tensors it is given before the clock stops
(CUDA work is asynchronous).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Run the block under torch.profiler (CPU, and CUDA where a card is
    there); on exit write `trace.json` (Chrome trace format) into log_dir.
    Yields the profiler (`key_averages()` for sums by op)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "umbrella_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(block_on) -> None:
    """Wait for the devices of every CUDA tensor in `block_on` (a tensor, or
    a dict / list / tuple of them); CPU tensors are already done."""
    if isinstance(block_on, torch.Tensor):
        if block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
    elif isinstance(block_on, dict):
        for v in block_on.values():
            _synchronize(v)
    elif isinstance(block_on, (list, tuple)):
        for v in block_on:
            _synchronize(v)


class PhaseTimer:
    """Accumulates wall-clock per phase; `block_on` syncs the device first."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.time()
        yield
        if block_on is not None:
            _synchronize(block_on)
        self.totals[name] += time.time() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            ms = 1000 * self.totals[name] / max(n, 1)
            lines.append(f"{name}: {ms:.2f} ms/call x{n}")
        return "\n".join(lines)
