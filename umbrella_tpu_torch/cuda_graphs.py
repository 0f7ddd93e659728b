"""CUDA graphs of decode steps: one step captured, then replayed in blocks.

The JAX package runs a decode loop inside one dispatch: `lax.while_loop` in
`decode_loop_fn` (speculation/static_engine.py) and in the batched engine's
segment. The port captures one step of each loop as a `torch.cuda.CUDAGraph`
and replays it. A replay launches the kernels of the captured call on the
addresses that call used, so a step reads every input from device buffers
that the host refills in place, and writes its state back into them.

`StepGraph.capture(step, device, pool, generators, idle)`:
  1. the step runs once eagerly on a side stream, inside `idle()` (a context
     in which the step is a no-op: the engine's continue or active flags
     off), and the generators' state is restored after it: each ctypes
     kernel sets its shared-memory attribute at its first launch, and
     library state (cuBLAS workspaces) is created outside the capture, while
     the engine's state and random stream stay as they were;
  2. the step is captured on that stream, with the sampling generators
     registered so that each replay draws new numbers (their Philox offsets
     advance as eager calls advance them), into the engine's memory pool,
     which all its graphs share;
  3. the kernel wrappers' launch counts taken during the capture move onto
     the graph: a capture launches nothing, and each replay adds the step's
     launches (`ops.kernels.add_launches`).
A replay draws as many random numbers whether the step is live or a no-op;
`rewind(n)` takes back the draws of n replays, so that a loop which ran n
no-op replays past its stop leaves the random stream where a loop that
stopped at once would. Capture and replays run under
`torch.cuda.set_sync_debug_mode("error")`: a host read inside a step raises.
A capture that fails raises; nothing falls back to eager steps.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .ops import kernels


@contextlib.contextmanager
def no_host_sync():
    """torch.cuda.set_sync_debug_mode("error") for the block (the previous
    mode after it)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class StepGraph:
    """One captured step. `launches`: the kernel launches of one replay by
    name (`ops.kernels.launch_counts` keys); `capture_ms` the warm-up and
    capture's wall time; `pool_bytes` what the capture added to the memory
    pool; `replays` the replays so far; `draws` each registered generator's
    Philox offset advance in one replay."""

    def __init__(self, graph, device, deltas, launches, capture_ms, pool_bytes, generators,
                 draws):
        self.graph, self.device = graph, device
        self._deltas = deltas
        self.launches, self.capture_ms, self.pool_bytes = launches, capture_ms, pool_bytes
        self.generators, self.draws = generators, draws
        self.replays = 0

    @classmethod
    def capture(cls, step, device: torch.device, pool, generators=(),
                idle=contextlib.nullcontext) -> "StepGraph":
        t0 = time.time()
        generators = tuple(generators)
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            states = [g.get_state() for g in generators]
            offsets = [g.get_offset() for g in generators]
            with torch.cuda.stream(stream), idle():
                step()
            draws = [g.get_offset() - o for g, o in zip(generators, offsets)]
            for g, state in zip(generators, states):
                g.set_state(state)
            torch.cuda.current_stream(device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            before, named = kernels.counter_values(), kernels.launch_counts()
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(device)
                with no_host_sync():
                    step()
            pool_bytes = torch.cuda.memory_reserved(device) - reserved
            deltas = [a - b for a, b in zip(kernels.counter_values(), before)]
            launches = {k: v - named[k] for k, v in kernels.launch_counts().items()}
            kernels.add_launches(deltas, -1)
            torch.cuda.synchronize(device)
        return cls(graph, device, deltas, launches, 1000 * (time.time() - t0), pool_bytes,
                   generators, draws)

    def replay(self, n: int) -> None:
        """Launch the step n times on the device's current stream (no wait)."""
        with torch.cuda.device(self.device), no_host_sync():
            for _ in range(n):
                self.graph.replay()
        kernels.add_launches(self._deltas, n)
        self.replays += n

    def rewind(self, n: int) -> None:
        """Take back the random draws of the last n replays: each registered
        generator's Philox offset moves back by n replays' advance."""
        for g, d in zip(self.generators, self.draws):
            if d:
                g.set_offset(g.get_offset() - n * d)
