"""The port's request scheduler (umbrella_tpu_torch/serving/scheduler.py)
against the JAX package's on the CPU.

The same submit sequences go into both Schedulers over stub engines: the
execution order, the metric keys and the counts are equal. The batcher's
scheduler hooks (`_priority` marked `_downstream_better` at pop, `_admit_cb`
at slot registration) give JAX's reports and inversion count for one
admission sequence; greedy requests through make_scheduler over a batcher
get run()'s tokens. The port also fails a submit() after shutdown() at once,
which the JAX Scheduler does not (ROADMAP C).
"""
import functools
import sys
import threading
import time

import jax.numpy as jnp
import pytest
import torch

from test_static_engine import MAX_LEN
from test_torch_stream import WordTokenizer, runtimes
from umbrella_tpu.sequoia import growmap_from_spec as jax_growmap_from_spec
from umbrella_tpu.serving import scheduler as jax_scheduler
from umbrella_tpu.serving.batched_engine import BatchedStaticEngine as JaxBatchedEngine
from umbrella_tpu.serving.batched_engine import ContinuousBatcher as JaxBatcher
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.serving import scheduler
from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

torch.set_num_threads(1)  # several workers share the cores

PACKAGES = {"jax": jax_scheduler, "port": scheduler}
TIMED = ("busy_seconds", "queue_seconds")


class RecordingEngine:
    """Records the order it runs requests in; returns `ntok` tokens. Streams
    two frames and the result."""

    def __init__(self, sleep=0.0):
        self.order, self.sleep, self.lock = [], sleep, threading.Lock()

    def generate(self, **req):
        with self.lock:
            self.order.append(req["tag"])
        time.sleep(self.sleep)
        if req.get("boom"):
            raise RuntimeError("injected generate failure")
        return dict(generated_text=req["tag"], generated_tokens=list(range(req["ntok"])),
                    avg_accept_tokens=1.0, time_per_output_token=1.0)

    def generate_stream(self, **req):
        out = self.generate(**req)
        yield "partial", "perf"
        yield out["generated_text"], out


def untimed(metrics):
    """The metrics without wall-clock values."""
    out = {k: v for k, v in metrics.items() if k not in TIMED and k != "by_priority"}
    out["by_priority"] = {p: {k: v for k, v in b.items() if k not in TIMED}
                          for p, b in metrics["by_priority"].items()}
    return out


def run_sequence(mod, submits):
    """Submit all before the worker starts (so the queue decides the order),
    then start and wait. Returns (order, untimed metrics, outcomes)."""
    eng = RecordingEngine()
    sched = mod.Scheduler([eng])
    frames = []
    futs = [sched.submit(**dict(s, stream_cb=(lambda t, p: frames.append(t))
                                if s.get("stream") else None)) for s in submits]
    time.sleep(0.05)
    sched.start()
    outcomes = []
    for f in futs:
        try:
            outcomes.append(f.result(timeout=30)["generated_text"])
        except Exception as e:  # noqa: BLE001 -- the outcome is compared
            outcomes.append(type(e).__name__)
    snap = sched.snapshot_metrics()
    sched.shutdown()
    return eng.order, untimed(snap), outcomes, frames


SEQUENCES = {
    "priorities": [dict(priority=p, tag=f"r{i}", ntok=n)
                   for i, (p, n) in enumerate([(20, 3), (1, 5), (10, 2), (1, 4), (20, 1), (5, 7)])],
    "default priority and ties": [dict(tag=f"r{i}", ntok=i + 1) for i in range(4)]
    + [dict(priority=10, tag="late", ntok=2), dict(priority=9, tag="first", ntok=1)],
    "streams and a failure": [dict(priority=3, tag="s", ntok=4, stream=True),
                              dict(priority=2, tag="boom", ntok=1, boom=True),
                              dict(priority=1, tag="a", ntok=6)],
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_same_submits_same_order_and_metrics_as_jax(name):
    """One submit sequence into each package's Scheduler over one stub engine:
    the same execution order, results, stream frames, metric keys and
    counts (requests, tokens, expired, inversions, by priority)."""
    submits = SEQUENCES[name]
    port_run = run_sequence(scheduler, [dict(s) for s in submits])
    jax_run = run_sequence(jax_scheduler, [dict(s) for s in submits])
    assert port_run == jax_run
    order, metrics, _, _ = port_run
    assert order == [s["tag"] for s in sorted(submits, key=lambda s: s.get("priority", 10))]
    assert metrics["requests"] == len(submits) and metrics["expired"] == 0


@pytest.mark.parametrize("package", list(PACKAGES))
def test_deadline_expiry(package):
    """A request that waited past its deadline is dropped with DeadlineExpired
    and counted under its priority; the next request runs (both packages)."""
    mod = PACKAGES[package]
    eng = RecordingEngine()
    sched = mod.Scheduler([eng])
    late = sched.submit(priority=7, deadline_s=0.01, tag="late", ntok=1)
    fresh = sched.submit(priority=8, deadline_s=30.0, tag="fresh", ntok=2)
    time.sleep(0.1)
    sched.start()
    try:
        with pytest.raises(mod.DeadlineExpired):
            late.result(timeout=30)
        assert fresh.result(timeout=30)["generated_tokens"] == [0, 1]
        snap = sched.snapshot_metrics()
        assert (snap["expired"], snap["requests"], snap["tokens"]) == (1, 1, 2)
        assert snap["by_priority"]["7"] == dict(requests=0, tokens=0, queue_seconds=0.0,
                                                expired=1)
        assert eng.order == ["fresh"]
    finally:
        sched.shutdown()


@pytest.mark.parametrize("package", list(PACKAGES))
def test_workers_on_one_engine_refused(package):
    """make_scheduler refuses several workers on one engine and sizes a
    batcher's workers as B + max(2, B // 4), in both packages."""
    mod = PACKAGES[package]
    with pytest.raises(ValueError, match="distinct engines"):
        mod.make_scheduler(engine=RecordingEngine(), workers=2)
    assert len(mod.make_scheduler(engine=RecordingEngine(), workers=1).engines) == 1

    class Batcher:
        def __init__(self, b):
            self.engine = type("E", (), {"batch_size": b})()

    sizes = [len(mod.make_scheduler(batcher=Batcher(b)).engines) for b in (1, 4, 32)]
    assert sizes == [3, 6, 40]
    assert len(mod.make_scheduler(batcher=Batcher(8), workers=5).engines) == 5


def test_submit_after_shutdown_fails_fast():
    """The port only: a submit() after shutdown() fails its future at once
    (the JAX Scheduler queues it for ever); requests queued at shutdown fail
    too, and the request in flight completes."""
    release = threading.Event()

    class Blocking(RecordingEngine):
        def generate(self, **req):
            release.wait(timeout=30)
            return super().generate(**req)

    sched = scheduler.Scheduler([Blocking()])
    sched.start()
    first = sched.submit(tag="first", ntok=1)
    time.sleep(0.3)  # the worker holds the first request
    queued = sched.submit(tag="queued", ntok=1)
    threading.Timer(0.2, release.set).start()
    sched.shutdown(wait=True)
    assert first.result(timeout=5)["generated_text"] == "first"
    with pytest.raises(RuntimeError, match="shut down"):
        queued.result(timeout=1)
    t0 = time.time()
    late = sched.submit(tag="late", ntok=1)
    assert late.done() and time.time() - t0 < 0.5
    with pytest.raises(RuntimeError, match="shut down"):
        late.result(timeout=0)


def test_submits_racing_shutdown_leave_no_future_pending():
    """Sixteen threads submit before, during and after shutdown() (a short
    switch interval to interleave them): every future resolves, with a
    result or the shut-down error, none left waiting."""
    sched = scheduler.Scheduler([RecordingEngine()])
    sched.start()
    futs, lock, go, shut = [], threading.Lock(), threading.Event(), threading.Event()

    def submitter():
        go.wait(timeout=10)
        after = 0
        while after < 5:
            after += shut.is_set()
            f = sched.submit(tag="t", ntok=1)
            with lock:
                futs.append(f)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter) for _ in range(16)]
        for t in threads:
            t.start()
        go.set()
        time.sleep(0.01)
        sched.shutdown(wait=True)
        shut.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    errors = 0
    for f in futs:
        try:
            f.result(timeout=5)
        except RuntimeError as e:
            assert "shut down" in str(e)
            errors += 1
    assert errors >= 16 * 5


def _batched_engines():
    (jt, jd), (pt, pd) = runtimes()
    jeng = JaxBatchedEngine(draft_model_name=jd, target_model_name=jt, batch_size=1,
                            dtype=jnp.float32, growmap=jax_growmap_from_spec(3, 4),
                            max_length=MAX_LEN, safe_buffer=32, eos_token_ids=[-1],
                            segment_steps=2)
    eng = AutoEngine.from_config(device="cpu", engine="batched_static", model=pt, draft_model=pd,
                                 batch_size=1, growmap=growmap_from_spec(3, 4),
                                 max_length=MAX_LEN, safe_buffer=32, eos_token_ids=[-1],
                                 dtype=torch.float32, segment_steps=2)
    for e in (jeng, eng):
        e.initialize()
    return {"jax": (jeng, JaxBatcher), "port": (eng, ContinuousBatcher)}


def _admissions(mod, eng, batcher_cls):
    """One admission sequence (a single slot): A(5), B(5), C(1) queued in the
    batcher's FIFO in that order with the Scheduler's `_admit_cb`, while a
    request of priority 3 waits in the Scheduler's queue (its workers never
    start). Returns each admission's (downstream_better, inversions after)."""
    sched = mod.Scheduler([None])
    sched.submit(priority=3, input_ids=[1], max_new_tokens=1)
    batcher = batcher_cls(eng)
    reports = {}

    def admit_cb(name, priority, downstream_better):
        sched._on_slot_admission(priority, downstream_better)
        reports[name] = (downstream_better, sched.metrics["priority_inversions"])

    futs = [batcher.submit(input_ids=ids, max_new_tokens=6, _priority=p,
                           _admit_cb=functools.partial(admit_cb, name, p))
            for name, p, ids in (("A", 5, [1, 5, 9]), ("B", 5, [2, 6, 1]), ("C", 1, [3, 7, 2]))]
    batcher.start()
    try:
        toks = [f.result(timeout=120)["generated_tokens"] for f in futs]
    finally:
        batcher.shutdown()
    return reports, sched.metrics["priority_inversions"], toks


def test_priority_inversions_through_the_batcher_equal_jax():
    """The batcher's hooks in both packages: A is admitted with a better C
    behind it in the FIFO (an inversion), B too, C with none behind it but
    nothing better waiting (none); A and B also saw the Scheduler's waiting
    priority 3. The reports, the inversion count and the tokens are JAX's."""
    engines = _batched_engines()
    got = _admissions(scheduler, *engines["port"])
    want = _admissions(jax_scheduler, *engines["jax"])
    assert got == want
    reports, inversions, _ = got
    assert reports == {"A": (True, 1), "B": (True, 2), "C": (False, 2)} and inversions == 2


def test_make_scheduler_over_batcher_streams_and_reports_admissions():
    """make_scheduler over a port ContinuousBatcher (B=2, four workers):
    greedy requests of three priorities get run()'s tokens, one streams its
    frames, every request's admission reaches the Scheduler, and the
    metrics count every token."""
    (_, _), (pt, pd) = runtimes()
    eng = AutoEngine.from_config(device="cpu", engine="batched_static", model=pt, draft_model=pd,
                                 batch_size=2, growmap=growmap_from_spec(3, 4),
                                 max_length=MAX_LEN, safe_buffer=32, eos_token_ids=[-1],
                                 dtype=torch.float32, segment_steps=2, tokenizer=WordTokenizer())
    eng.initialize()
    reqs = [dict(input_ids=[1, 5, 9, 12], max_new_tokens=12), dict(input_ids=[2, 7, 3],
                                                                   max_new_tokens=16),
            dict(input_ids=[4, 4, 8], max_new_tokens=8)]
    want = [r["generated_tokens"] for r in eng.run([dict(r) for r in reqs])]
    batcher = ContinuousBatcher(eng)
    batcher.start()
    sched = scheduler.make_scheduler(batcher=batcher)
    assert len(sched.engines) == 4
    admitted = []
    on_admission = sched._on_slot_admission
    sched._on_slot_admission = lambda p, d=False: admitted.append(p) or on_admission(p, d)
    sched.start()
    frames = []
    try:
        futs = [sched.submit(priority=p, stream_cb=(lambda t, f: frames.append(t)) if p == 1
                             else None, **dict(r)) for p, r in zip((20, 1, 10), reqs)]
        got = [f.result(timeout=120)["generated_tokens"] for f in futs]
    finally:
        sched.shutdown(wait=False)
        batcher.shutdown()
    assert got == want
    assert sorted(admitted) == [1, 10, 20]
    assert len(frames) >= 2 and frames[-1] == " ".join(
        f"{i}." if i % 5 == 0 else str(i) for i in want[1])
    assert sched.metrics["requests"] == 3 and sched.metrics["tokens"] == sum(map(len, want))
