"""CUDA graphs of decode steps: a step as phases, captured once per device run,
then replayed in blocks.

The JAX package runs a decode loop inside one dispatch: `lax.while_loop` in
`decode_loop_fn` (speculation/static_engine.py) and in the batched engine's
segment. The port captures one step of each loop as CUDA graphs and replays
them. A replay launches the kernels of the captured call on the addresses
that call used, so a step reads every input from device buffers that the host
refills in place, and writes its state back into them.

A step is a list of `Phase`s: functions of named values (the step's context)
that each run on one device. `plan_segments` cuts the list into segments, the
maximal runs of phases on one device (all captured, or all eager); a step
whose phases all run on one device, as a resident or staged target on one
card, is one segment and one graph. A target staged over several cards cuts
the step at each change of device (`torch.cuda.graph` captures one device's
stream into that device's pool, so one capture cannot span cards); the
offload target's streamed forward is an eager phase between two graphs.
`run_phases` runs the phases eagerly, moving a value to the device of the
phase that reads it (the plain version: the CPU, and every eager forward).

`StepGraph.capture(phases, pools, generators, idle)`:
  1. the step runs once eagerly, each device's phases on a side stream of
     that device, inside `idle()` (a context in which the step is a no-op:
     the engine's continue or active flags off), and the generators' state
     is restored after it: each ctypes kernel sets its shared-memory
     attribute at its first launch, and library state (cuBLAS workspaces) is
     created outside the capture, while the engine's state and random stream
     stay as they were. The run gives the shapes of the values that cross
     into a captured segment from another device or from an eager segment
     (the segment's `hops`), and a static buffer is allocated for each on
     the segment's device, and the random draws of each segment;
  2. each captured segment is captured on its device's side stream into its
     device's memory pool (`pools`, one a device, shared by all of an
     engine's graphs there), reading its hops from their static buffers;
     the generators that its phases draw from are registered with its graph,
     so that each replay draws new numbers (their Philox offsets advance as
     eager calls advance them);
  3. the kernel wrappers' launch counts taken during the captures move onto
     the graph: a capture launches nothing, and each replay adds the step's
     launches (`ops.kernels.add_launches`).
A replay of the step runs its segments in order: the host copies each
segment's hops into their buffers (`copy_`: across cards a peer copy on the
source card's current stream, which PyTorch orders against both cards'
streams with events; no host wait), then replays the segment's graph on its
device's current stream, or runs an eager segment's phases. A replay draws as
many random numbers whether the step is live or a no-op; `rewind(n)` takes
back the draws of n replays, so that a loop which ran n no-op replays past
its stop leaves the random stream where a loop that stopped at once would.
Capture and replays run under `torch.cuda.set_sync_debug_mode("error")`: a
host read inside a step raises. A capture that fails raises; nothing falls
back to eager steps.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .ops import kernels


class Phase(NamedTuple):
    """One part of a step: `fn(*inputs)` runs on `device`, reading the
    step's values named `inputs`, and returns the values named `outputs` (a
    tuple in that order, the value itself for one output, None for none). An
    `eager` phase is never captured: a graphed step runs it between its
    graphs' replays (the offload target's streamed forward)."""
    name: str
    device: torch.device
    fn: Callable
    inputs: Tuple[str, ...] = ()
    outputs: Tuple[str, ...] = ()
    eager: bool = False


class Segment(NamedTuple):
    """A maximal run of phases on one device, all captured or all eager.
    `hops`: the values a captured segment reads from another device or from
    an eager segment, which a graphed step copies into static buffers on the
    segment's device before its replay."""
    device: torch.device
    eager: bool
    phases: Tuple[Phase, ...]
    hops: Tuple[str, ...]


def plan_segments(phases) -> List[Segment]:
    """The phases cut at each change of device or of eagerness, in order."""
    runs: list = []
    for ph in phases:
        if runs and runs[-1][0] == ph.device and runs[-1][1] == ph.eager:
            runs[-1][2].append(ph)
        else:
            runs.append((ph.device, ph.eager, [ph]))
    made: Dict[str, int] = {}  # value name -> the segment that last wrote it
    segments = []
    for j, (device, eager, group) in enumerate(runs):
        hops = []
        for ph in group:
            for k in ph.inputs:
                i = made.get(k, j)
                if not eager and i != j and k not in hops \
                        and (runs[i][0] != device or runs[i][1]):
                    hops.append(k)
            for k in ph.outputs:
                made[k] = j
        segments.append(Segment(device, eager, tuple(group), tuple(hops)))
    return segments


def _on(x, device: torch.device):
    """A tensor on `device` (a copy where it lies on another); anything else as it is."""
    return x.to(device, non_blocking=True) if isinstance(x, torch.Tensor) else x


def run_segment(seg: Segment, ctx: dict, hopped: dict) -> None:
    """Run one segment's phases on the values in `ctx` (updated with their
    outputs); `hopped` holds the segment's hops on its device."""
    local = dict(hopped)
    for ph in seg.phases:
        out = ph.fn(*(local[k] if k in local else _on(ctx[k], seg.device) for k in ph.inputs))
        if len(ph.outputs) == 1:
            out = (out,)
        elif out is None:
            out = ()
        for k, v in zip(ph.outputs, out, strict=True):
            local[k] = ctx[k] = v


def run_phases(phases, ctx: Optional[dict] = None) -> dict:
    """Run a step's phases eagerly, in order; a value read on another device
    than its own is copied there. `ctx`: values the phases read that no
    phase writes. Returns every value."""
    ctx = dict(ctx or {})
    for seg in plan_segments(phases):
        run_segment(seg, ctx, {k: _on(ctx[k], seg.device) for k in seg.hops})
    return ctx


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
    """One captured step. `plan`: its segments as (device, eager, phase
    names, hops); `launches`: the kernel launches of one replay's graphs by
    name (`ops.kernels.launch_counts` keys); `capture_ms` the warm-up and
    captures' wall time; `pool_bytes` what the captures added to the memory
    pools (`pool_bytes_by_device` for each device); `replays` the replays so
    far; `draws` each registered generator's Philox offset advance in one
    replay (summed over the segments that draw)."""

    def __init__(self, plan, graphs, buffers, outputs, eager, deltas, launches, capture_ms,
                 pool_bytes_by_device, generators, draws):
        self.plan, self._graphs, self._buffers = plan, graphs, buffers
        self._outputs, self._eager, self._deltas = outputs, eager, deltas
        self._ctx = {}
        self.launches, self.capture_ms = launches, capture_ms
        self.pool_bytes_by_device = pool_bytes_by_device
        self.pool_bytes = sum(pool_bytes_by_device.values())
        self.generators, self.draws = generators, draws
        self.replays = 0

    @property
    def segments(self) -> int:
        return len(self.plan)

    def output(self, name: str):
        """A value of the step as its last replay left it (a captured
        segment's output stays at its address from replay to replay)."""
        return self._ctx[name]

    @classmethod
    def capture(cls, phases, pools: dict, generators=(),
                idle=contextlib.nullcontext) -> "StepGraph":
        """`pools`: device -> graph pool handle (a device without one gets a
        new handle, kept in the dict)."""
        t0 = time.time()
        phases = list(phases)
        written = set()
        for ph in phases:
            missing = [k for k in ph.inputs if k not in written]
            if missing:
                raise ValueError(f"phase {ph.name} reads {missing}, which no phase before it "
                                 "writes: a captured step takes no outside values")
            written.update(ph.outputs)
        segments = plan_segments(phases)
        devices = list(dict.fromkeys(seg.device for seg in segments))
        generators = tuple(generators)
        streams = {d: torch.cuda.Stream(d) for d in devices}
        for d in devices:
            streams[d].wait_stream(torch.cuda.current_stream(d))
        states = [g.get_state() for g in generators]
        # 1. the eager warm-up: hop shapes and each segment's draws
        ctx, shapes, draws = {}, [], []
        with contextlib.ExitStack() as stack:
            for d in devices:
                stack.enter_context(torch.cuda.stream(streams[d]))
            stack.enter_context(idle())
            for seg in segments:
                hopped = {k: _on(ctx[k], seg.device) for k in seg.hops}
                shapes.append({k: (v.shape, v.dtype) for k, v in hopped.items()})
                offsets = [g.get_offset() for g in generators]
                with torch.cuda.device(seg.device):
                    run_segment(seg, ctx, hopped)
                draws.append([g.get_offset() - o for g, o in zip(generators, offsets)])
        for g, state in zip(generators, states):
            g.set_state(state)
        for d in devices:
            torch.cuda.current_stream(d).wait_stream(streams[d])
        buffers = [{k: torch.empty(shape, dtype=dtype, device=seg.device)
                    for k, (shape, dtype) in s.items()} for seg, s in zip(segments, shapes)]
        # 2. the captures; each captured segment's outputs stay at their addresses
        before, named = kernels.counter_values(), kernels.launch_counts()
        ctx, graphs, outputs, pool_bytes = {}, [], [], dict.fromkeys(devices, 0)
        for seg, bufs, seg_draws in zip(segments, buffers, draws):
            if seg.eager:
                graphs.append(None)
                outputs.append({})
                continue
            graph = torch.cuda.CUDAGraph()
            for gen, n in zip(generators, seg_draws):
                if n:
                    graph.register_generator_state(gen)
            with torch.cuda.device(seg.device):
                if seg.device not in pools:
                    pools[seg.device] = torch.cuda.graph_pool_handle()
                with torch.cuda.graph(graph, pool=pools[seg.device], stream=streams[seg.device],
                                      capture_error_mode="thread_local"):
                    reserved = torch.cuda.memory_reserved(seg.device)
                    with no_host_sync():
                        run_segment(seg, ctx, bufs)
                pool_bytes[seg.device] += torch.cuda.memory_reserved(seg.device) - reserved
            graphs.append(graph)
            outputs.append({k: ctx[k] for ph in seg.phases for k in ph.outputs})
        deltas = [a - b for a, b in zip(kernels.counter_values(), before)]
        launches = {k: v - named[k] for k, v in kernels.launch_counts().items()}
        kernels.add_launches(deltas, -1)
        for d in devices:
            torch.cuda.synchronize(d)
        plan = [(seg.device, seg.eager, tuple(ph.name for ph in seg.phases), seg.hops)
                for seg in segments]
        # keep an eager segment's phases (to run them at each replay), not the
        # captured ones': their functions may hold the engine that holds this graph
        eager = {i: seg for i, seg in enumerate(segments) if seg.eager}
        total = [sum(d[g] for d in draws) for g in range(len(generators))]
        return cls(plan, graphs, buffers, outputs, eager, deltas, launches,
                   1000 * (time.time() - t0), pool_bytes, generators, total)

    def replay(self, n: int) -> None:
        """Run the step n times: each segment's hops copied in, then its graph
        replayed on its device's current stream (an eager segment run).
        Nothing waits for the device."""
        ctx = self._ctx
        with no_host_sync():
            for _ in range(n):
                for i, (graph, bufs) in enumerate(zip(self._graphs, self._buffers)):
                    for k, buf in bufs.items():
                        buf.copy_(ctx[k], non_blocking=True)
                    with torch.cuda.device(self.plan[i][0]):
                        if graph is None:
                            run_segment(self._eager[i], ctx, bufs)
                        else:
                            graph.replay()
                    ctx.update(self._outputs[i])
        kernels.add_launches(self._deltas, n)
        self.replays += n

    def rewind(self, n: int) -> None:
        """Take back the random draws of the last n replays: each registered
        generator's Philox offset moves back by n replays' advance."""
        for g, d in zip(self.generators, self.draws):
            if d:
                g.set_offset(g.get_offset() - n * d)
