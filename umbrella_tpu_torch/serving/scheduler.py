"""Request scheduling layer, the counterpart of `umbrella_tpu/serving/scheduler.py`.

A priority FIFO with deadlines in front of one or more backends: a worker
thread per engine (several distinct engines serve data-parallel), or B plus a
lookahead of workers over one ContinuousBatcher (`BatcherBackend`), with
streaming callbacks and per-priority metrics. Lower priority numbers run
sooner; requests of one priority run in arrival order.

One difference from the JAX package: a submit() after shutdown() fails its
future at once. The JAX Scheduler enqueues it where no worker will ever pop
it, so that client waits for its own timeout.
"""
from __future__ import annotations

import functools
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..utils import device_scope, setup_logger

logger = setup_logger()


@dataclass(order=True)
class _QueuedRequest:
    priority: int
    seq: int
    request: dict = field(compare=False)
    future: Future = field(compare=False)
    stream_cb: Optional[Callable] = field(compare=False, default=None)
    submitted_at: float = field(compare=False, default=0.0)
    deadline_s: Optional[float] = field(compare=False, default=None)


class DeadlineExpired(Exception):
    """Request spent longer than its deadline_s in the queue; never executed."""


def _shut_down_error() -> RuntimeError:
    return RuntimeError("Scheduler shut down before executing this request")


class Scheduler:
    """Priority FIFO over one or more engines (one worker thread per engine)."""

    def __init__(self, engines: List[Any]):
        assert engines
        self.engines = engines
        self._q: "queue.PriorityQueue[_QueuedRequest]" = queue.PriorityQueue()
        self._seq = itertools.count()
        self._workers = []
        self._stop = threading.Event()
        # submit() enqueues and shutdown() sets _stop under this lock, so a
        # request is either drained by shutdown() or refused by submit()
        self._submit_lock = threading.Lock()
        self.metrics: Dict[str, Any] = {
            "requests": 0, "tokens": 0, "busy_seconds": 0.0,
            "queue_seconds": 0.0, "expired": 0,
            # inversions observed at slot admission: a request entered a decode
            # slot while a request of a strictly better priority still waited
            # (behind it in the batcher's FIFO, or in this queue); the
            # batcher lookahead of make_scheduler allows some
            "priority_inversions": 0,
            # str(priority) -> {requests, tokens, queue_seconds, expired};
            # string keys survive the JSON get_metrics round trip
            "by_priority": {}}
        self._metrics_lock = threading.Lock()

    def _priority_bucket(self, priority: int) -> Dict[str, float]:
        return self.metrics["by_priority"].setdefault(
            str(priority), {"requests": 0, "tokens": 0, "queue_seconds": 0.0, "expired": 0})

    def start(self):
        for i, engine in enumerate(self.engines):
            t = threading.Thread(target=self._worker, args=(engine,),
                                 name=f"engine-worker-{i}", daemon=True)
            t.start()
            self._workers.append(t)

    def submit(self, priority: int = 10, stream_cb: Optional[Callable] = None,
               deadline_s: Optional[float] = None, **request) -> Future:
        """deadline_s: the most seconds the request may wait in the queue; an
        expired request is dropped (its future gets DeadlineExpired) instead
        of spending engine time on an answer the client has given up on."""
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set():
                fut.set_exception(_shut_down_error())
                return fut
            self._q.put(_QueuedRequest(
                priority=priority, seq=next(self._seq), request=request, future=fut,
                stream_cb=stream_cb, submitted_at=time.time(), deadline_s=deadline_s))
        return fut

    def _worker(self, engine):
        # a single engine's worker runs its requests' decode (graph captures
        # included) on this thread, which starts on cuda:0
        with device_scope(getattr(engine, "device", None)):
            self._serve(engine)

    def _serve(self, engine):
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            wait = time.time() - item.submitted_at
            if item.deadline_s is not None and wait > item.deadline_s:
                # expired requests count only in "expired": their wait would
                # skew queue_seconds, a mean over executed requests
                with self._metrics_lock:
                    self.metrics["expired"] += 1
                    self._priority_bucket(item.priority)["expired"] += 1
                item.future.set_exception(DeadlineExpired(
                    f"queued {wait:.2f}s > deadline {item.deadline_s:.2f}s"))
                continue
            t0 = time.time()
            if isinstance(engine, BatcherBackend):
                # the batcher reports the slot admission through _admit_cb, with
                # whether a better-priority request waited behind this one in
                # its own FIFO (which it judges by _priority)
                item.request["_priority"] = item.priority
                item.request["_submit_time"] = item.submitted_at  # TTFT includes the queue
                item.request["_admit_cb"] = functools.partial(
                    self._on_slot_admission, item.priority)
            err = None
            try:
                if item.stream_cb is not None:
                    partial = perf = None
                    for partial, perf in engine.generate_stream(**item.request):
                        item.stream_cb(partial, perf)
                    # a backend may yield its whole result dict as the last perf
                    result = perf if isinstance(perf, dict) \
                        else {"generated_text": partial, "perf": perf}
                else:
                    result = engine.generate(**item.request)
                ntok = len(result.get("generated_tokens", []) or [])
            except Exception as e:
                logger.exception("request failed")
                err = e
                ntok = 0
            # metrics before the future resolves: set_result runs the
            # done-callbacks inline, so a client may read them right after
            with self._metrics_lock:
                self.metrics["requests"] += 1
                self.metrics["tokens"] += ntok
                self.metrics["busy_seconds"] += time.time() - t0
                self.metrics["queue_seconds"] += wait
                b = self._priority_bucket(item.priority)
                b["requests"] += 1
                b["tokens"] += ntok
                b["queue_seconds"] += wait
            if err is None:
                item.future.set_result(result)
            else:
                item.future.set_exception(err)

    def _on_slot_admission(self, priority: int, downstream_better: bool = False):
        """A request of `priority` just entered a decode slot. It is an
        observed inversion if a request of a strictly better priority still
        waited: behind it in the batcher's FIFO (`downstream_better`, marked
        by ContinuousBatcher._pop_request) or here in the queue."""
        if not downstream_better:
            with self._q.mutex:
                waiting = [i.priority for i in self._q.queue]
            if not waiting or min(waiting) >= priority:
                return
        with self._metrics_lock:
            self.metrics["priority_inversions"] += 1

    def snapshot_metrics(self) -> dict:
        """A consistent copy of the metrics (by_priority copied too), which
        the server sends as JSON while the workers go on."""
        with self._metrics_lock:
            out = dict(self.metrics)
            out["by_priority"] = {k: dict(v) for k, v in self.metrics["by_priority"].items()}
        return out

    def shutdown(self, wait: bool = True):
        """Stop the workers and fail every request still queued; a later
        submit() fails at once."""
        with self._submit_lock:
            self._stop.set()
        if wait:
            for t in self._workers:
                t.join(timeout=5)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            try:
                item.future.set_exception(_shut_down_error())
            except Exception:
                pass  # resolved or cancelled meanwhile


class BatcherBackend:
    """A ContinuousBatcher behind the Scheduler's engine interface: `generate`
    submits into the batcher and blocks until the slot finishes. The Scheduler
    gets the same backend once per worker, so each worker holds one request in
    flight: up to B requests decode together while the priority queue orders
    admission (slots already decoding are not preempted)."""

    def __init__(self, batcher):
        self.batcher = batcher

    def generate(self, **request):
        return self.batcher.submit(**request).result()

    def generate_stream(self, **request):
        """(text so far, perf log) frames from the batcher's stream_cb (one
        per decode segment with new tokens), then one last (full text, result
        dict): the dict rides in the perf slot so that the Scheduler's worker
        keeps generated_tokens for its metrics."""
        frames: "queue.Queue" = queue.Queue()
        done = object()
        request["stream_cb"] = lambda text, perf: frames.put((text, perf))
        fut = self.batcher.submit(**request)
        fut.add_done_callback(lambda _f: frames.put(done))
        while True:
            item = frames.get()
            if item is done:
                break
            yield item
        result = fut.result()  # raises if the batcher failed the request
        yield result.get("generated_text", ""), result


def make_scheduler(engine=None, batcher=None, workers: Optional[int] = None) -> Scheduler:
    """A Scheduler over one engine or over a ContinuousBatcher.

    Batcher workers default to batch_size + max(2, batch_size // 4): B
    workers keep every slot fed, and the lookahead keeps requests queued
    inside the batcher, so a freed slot takes a new request at the next
    segment boundary instead of after a worker's wake-up. The lookahead
    bounds the priority inversions a better-priority arrival can see; raise
    `workers` for throughput, lower it for stricter priority order."""
    if batcher is not None:
        B = getattr(batcher.engine, "batch_size", 4)
        n = workers or (B + max(2, B // 4))
        return Scheduler([BatcherBackend(batcher)] * n)
    assert engine is not None
    if workers and workers > 1:
        # a single-slot engine is not thread-safe (generate mutates its tokens
        # and KV state); data-parallel serving passes distinct engines to
        # Scheduler([...]) directly
        raise ValueError(
            "workers > 1 on a single engine would run concurrent generate() "
            "on shared state; pass distinct engines to Scheduler(...) for DP")
    return Scheduler([engine])
