"""Profiling and tracing utilities.

Counterpart of `umbrella_tpu/profiling.py`: `trace` captures a
`torch.profiler` trace (host ops and, on a card, its kernels) into a Chrome
trace file, where the JAX package captures a `jax.profiler` trace for
TensorBoard; `PhaseTimer` sums wall-clock time by phase, and `block_on`
waits for the device of the tensors it is given before the clock stops
(CUDA work is asynchronous).

Program spans (the port's own; the JAX package has none): `span(name,
request=None)` times a block on one thread, `record(name, start, end,
request=None)` files an interval that crosses threads (a request's wait from
its submit on a client thread to its pop on the serving loop's). Each
finished span (name, start and end in `time.time()` seconds, thread, the
span open around it on that thread, request id) goes into one bounded ring,
process-wide and thread-safe, and into a running total by name. `spans(since,
until)` reads the ring over a window and says whether the ring has dropped
any of it; `totals()` reads the totals. While torch.profiler records, a
`span` also opens a profiler range of its name, so the trace places it on
the host timeline on the clock of the device records; otherwise a span calls
nothing in torch. Spans sit at request, serving-loop and prefill-chunk
boundaries, never per kernel or inside a graph capture:

    serve.queue          submit to the serving loop's pop (record)
    serve.admit          pop to the dispatch its activation rides (record)
    serve.decode         activation to harvest (record)
    serve.prefill_chunk  one chunk of a batched admission's prefill
    serve.dispatch       the loop's phases: a segment queued,
    serve.sync             its results waited for,
    serve.harvest          finished requests resolved and frames streamed,
    serve.stage            requests popped and staged, prefill chunks run,
    serve.idle             the loop waiting for work
    engine.prefill       a single-request engine's prefill, to its device sync
"""
from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


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


# ------------------------------------------------------------------ spans

class Span(NamedTuple):
    id: int
    name: str
    start: float  # time.time() seconds
    end: float
    thread: int  # threading.get_ident() of the thread that filed it
    parent: Optional[int]  # id of the span open around it on its thread
    request: Optional[int]


_ROW = np.dtype([("id", "i8"), ("name", "i4"), ("start", "f8"), ("end", "f8"),
                 ("thread", "i8"), ("parent", "i8"), ("request", "i8")])
_NONE = -1  # parent or request absent
_SPAN_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)
_stacks = threading.local()  # each thread's open spans, innermost last


def next_request_id() -> int:
    """A process-wide request id for the spans of one request."""
    return next(_REQUEST_IDS)


def _open_range(name: str):
    """A torch.profiler range of the span's name, entered."""
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


def _stack() -> list:
    stack = getattr(_stacks, "ids", None)
    if stack is None:
        stack = _stacks.ids = []
    return stack


class SpanRing:
    """Finished spans in a ring of `capacity` rows (the oldest dropped
    first), with a running count and seconds by name. Thread-safe."""

    def __init__(self, capacity: int = 1 << 19):
        self.capacity = int(capacity)
        self._rows = np.empty(self.capacity, _ROW)
        self._lock = threading.Lock()
        self._n = 0  # rows ever filed
        self._dropped_end = -np.inf  # the latest end among dropped rows
        self._names: List[str] = []
        self._codes: Dict[str, int] = {}
        self._totals: Dict[str, list] = {}

    def append(self, sid: int, name: str, start: float, end: float, thread: int,
               parent: Optional[int] = None, request: Optional[int] = None) -> None:
        with self._lock:
            code = self._codes.get(name)
            if code is None:
                code = self._codes[name] = len(self._names)
                self._names.append(name)
                self._totals[name] = [0, 0.0]
            i = self._n % self.capacity
            if self._n >= self.capacity:
                self._dropped_end = max(self._dropped_end, float(self._rows[i]["end"]))
            self._rows[i] = (sid, code, start, end, thread,
                             _NONE if parent is None else parent,
                             _NONE if request is None else request)
            self._n += 1
            total = self._totals[name]
            total[0] += 1
            total[1] += end - start

    def span(self, name: str, request: Optional[int] = None) -> "_Span":
        return _Span(self, name, request)

    def record(self, name: str, start: float, end: float,
               request: Optional[int] = None) -> None:
        """File an interval timed elsewhere (it may cross threads): no parent,
        no profiler range."""
        self.append(next(_SPAN_IDS), name, start, end, threading.get_ident(), None, request)

    def spans(self, since: float = -np.inf, until: float = np.inf) -> Tuple[List[Span], bool]:
        """(the spans that overlap [since, until], oldest filed first; True
        where the ring has dropped a span that ended at or after `since`, so
        that the list may lack part of the window)."""
        with self._lock:
            n, cap = self._n, self.capacity
            rows = (self._rows[:n] if n <= cap else
                    np.concatenate([self._rows[n % cap:], self._rows[:n % cap]]))
            rows = rows[(rows["end"] >= since) & (rows["start"] <= until)]
            dropped = n > cap and bool(self._dropped_end >= since)
            names = list(self._names)
        out = [Span(int(r["id"]), names[r["name"]], float(r["start"]), float(r["end"]),
                    int(r["thread"]), None if r["parent"] == _NONE else int(r["parent"]),
                    None if r["request"] == _NONE else int(r["request"])) for r in rows]
        return out, dropped

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {"count", "seconds"}} over every span filed (dropped ones too)."""
        with self._lock:
            return {k: dict(count=c, seconds=s) for k, (c, s) in self._totals.items()}


class _Span:
    """`with ring.span(name):` -- the clock read, the block, the clock read;
    the profiler range (where one records) lies inside the span's interval."""
    __slots__ = ("ring", "name", "request", "id", "parent", "start", "end", "_range")

    def __init__(self, ring: SpanRing, name: str, request: Optional[int] = None):
        self.ring, self.name, self.request = ring, name, request

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_SPAN_IDS)
        stack.append(self.id)
        self.start = time.time()
        self._range = (_open_range(self.name) if _autograd_profiler._is_profiler_enabled
                       else None)
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self.end = time.time()
        _stack().pop()
        self.ring.append(self.id, self.name, self.start, self.end, threading.get_ident(),
                         self.parent, self.request)


_RING = SpanRing()


def span(name: str, request: Optional[int] = None) -> _Span:
    """Time a block as a span of the process-wide ring."""
    return _RING.span(name, request)


def record(name: str, start: float, end: float, request: Optional[int] = None) -> None:
    """File an interval timed elsewhere in the process-wide ring."""
    _RING.record(name, start, end, request)


def spans(since: float = -np.inf, until: float = np.inf) -> Tuple[List[Span], bool]:
    """The process-wide ring's spans over a window (SpanRing.spans)."""
    return _RING.spans(since, until)


def totals() -> Dict[str, Dict[str, float]]:
    """The process-wide count and seconds of every span name."""
    return _RING.totals()
