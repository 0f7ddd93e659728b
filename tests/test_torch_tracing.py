"""The port's program spans (profiling.py) on the CPU, on a tiny model: the
request spans of ContinuousBatcher's two loops, the loop-phase spans that
cover the loop thread, the single-request engines' `engine.prefill`, the
profiler ranges the spans open while torch.profiler records (and only
then), and the ring that holds them."""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from umbrella_tpu_torch import profiling
from umbrella_tpu_torch.config import ModelConfig
from umbrella_tpu_torch.models import auto_model
from umbrella_tpu_torch.sequoia import growmap_from_spec
from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher
from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

# several test processes share the cores: one intra-op thread each
torch.set_num_threads(1)

MAX_LEN = 1024
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=MAX_LEN,
           eos_token_id=-100)
LOOP_PHASES = {"serve.dispatch", "serve.sync", "serve.harvest", "serve.stage", "serve.idle"}
REQUEST_SPANS = ("serve.queue", "serve.admit", "serve.decode")
# two prompts above the 512-token prefill bucket admit over several chunks
PROMPTS = (600, 20, 40, 530, 9, 70)


@pytest.fixture(scope="module")
def models():
    target = auto_model.random_runtime(ModelConfig(**CFG), MAX_LEN, seed=0, device="cpu")
    return target, auto_model.early_exit_runtime(target, 1)


def _engine(models, kind="batched_static", **kw):
    target, draft = models
    if kind != "dynamic":
        kw["growmap"] = growmap_from_spec(2, 3)
    eng = AutoEngine.from_config(device="cpu", engine=kind, model=target, draft_model=draft,
                                 max_length=MAX_LEN, safe_buffer=32, eos_token_ids=[-1],
                                 dtype=torch.float32, **kw)
    eng.initialize()
    return eng


def _requests():
    rng = np.random.default_rng(3)
    return [dict(input_ids=rng.integers(3, 250, size=n).astype(np.int32).tolist(),
                 max_new_tokens=int(m)) for n, m in zip(PROMPTS, rng.integers(6, 16, len(PROMPTS)))]


def _serve(models, pipeline):
    """The requests through a batcher over B=3; (results, loop thread id,
    the spans filed from the batcher's start to its shutdown)."""
    eng = _engine(models, batch_size=3, segment_steps=2)
    batcher = ContinuousBatcher(eng, pipeline=pipeline)
    t0 = time.time()
    batcher.start()
    try:
        futs = [batcher.submit(**r) for r in _requests()]
        results = [f.result(timeout=300) for f in futs]
        loop_thread = batcher._thread.ident
    finally:
        batcher.shutdown()
    found, dropped = profiling.spans(t0, time.time())
    assert not dropped
    return results, loop_thread, found


@pytest.fixture(scope="module", params=["serial", "pipelined"])
def served(request, models):
    return _serve(models, request.param == "pipelined")


def test_each_request_has_its_queue_admit_and_decode_in_order(served):
    results, _thread, found = served
    by_request = {}
    for s in found:
        if s.name in REQUEST_SPANS:
            by_request.setdefault(s.request, []).append(s)
    assert None not in by_request
    assert len(by_request) == len(results) and all(r["generated_tokens"] for r in results)
    for rid, spans in by_request.items():
        assert sorted(s.name for s in spans) == sorted(REQUEST_SPANS), rid
        q, a, d = (next(s for s in spans if s.name == n) for n in REQUEST_SPANS)
        assert q.start <= q.end <= a.start <= a.end <= d.start <= d.end, rid
        assert q.parent is a.parent is d.parent is None


def test_prefill_chunks_lie_inside_their_admission(served):
    _results, thread, found = served
    admit = {s.request: s for s in found if s.name == "serve.admit"}
    chunks = [s for s in found if s.name == "serve.prefill_chunk"]
    stage = {s.id for s in found if s.name == "serve.stage"}
    # one chunk a short prompt, two for each prompt of 513-1024 tokens
    assert len(chunks) == sum(1 + (n > 512) for n in PROMPTS)
    for c in chunks:
        a = admit[c.request]
        assert a.start <= c.start <= c.end <= a.end
        assert c.thread == thread and c.parent in stage


def test_loop_phases_cover_the_loop_thread(served):
    _results, thread, found = served
    phases = sorted((s for s in found if s.name in LOOP_PHASES), key=lambda s: s.start)
    assert {s.thread for s in phases} == {thread}
    assert {"serve.dispatch", "serve.sync", "serve.harvest", "serve.stage"} <= \
        {s.name for s in phases}
    assert all(s.parent is None for s in phases)
    for a, b in zip(phases, phases[1:]):
        assert a.end <= b.start, (a, b)
    covered = sum(s.end - s.start for s in phases)
    assert covered >= 0.95 * (phases[-1].end - phases[0].start)


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_generate_stream_records_one_prefill_span(models, kind):
    eng = _engine(models, kind=kind)
    prompts = [r["input_ids"][:40] for r in _requests()[:3]]
    t0 = time.time()
    for p in prompts[:2]:
        list(eng.generate_stream(input_ids=p, max_new_tokens=8))
    eng.generate(input_ids=prompts[2], max_new_tokens=8)
    found, _dropped = profiling.spans(t0, time.time())
    prefills = [s for s in found if s.name == "engine.prefill"]
    assert len(prefills) == 3
    assert {s.thread for s in prefills} == {threading.get_ident()}


def _all_threads_profile():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def test_spans_appear_as_profiler_ranges(models):
    """Every span timed under the profiler appears as a host event of its
    name: on each thread in the same order, nested as the spans are, and
    inside the span's own interval (both clocks are Unix time)."""
    eng = _engine(models, batch_size=3, segment_steps=2)
    static = _engine(models, kind="static")
    with _all_threads_profile() as prof:
        t0 = time.time()
        batcher = ContinuousBatcher(eng, pipeline=True)
        batcher.start()
        try:
            for f in [batcher.submit(**r) for r in _requests()[:4]]:
                f.result(timeout=300)
        finally:
            batcher.shutdown()
        list(static.generate_stream(input_ids=_requests()[1]["input_ids"], max_new_tokens=8))
        t1 = time.time()
    found, _dropped = profiling.spans(t0, t1)
    timed = [s for s in found if s.name not in REQUEST_SPANS and s.start >= t0 and s.end <= t1]
    names = {s.name for s in timed}
    assert {"engine.prefill", "serve.prefill_chunk"} | LOOP_PHASES - {"serve.idle"} <= names
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in names]
    by_thread = {}
    for e in events:
        by_thread.setdefault(e.start_thread_id(), []).append(e)
    spans_by_thread = {}
    for s in timed:
        spans_by_thread.setdefault(s.thread, []).append(s)
    assert len(by_thread) == len(spans_by_thread) == 2
    tol = 50e-6  # the profiler's clock conversion to Unix time
    for evs in by_thread.values():
        evs.sort(key=lambda e: e.start_ns())
        thread = next(t for t, ss in spans_by_thread.items()
                      if {s.name for s in ss} == {e.name() for e in evs})
        spans = sorted(spans_by_thread[thread], key=lambda s: s.start)
        assert [e.name() for e in evs] == [s.name for s in spans]
        event_of = {s.id: e for s, e in zip(spans, evs)}
        for s, e in zip(spans, evs):
            assert s.start - tol <= e.start_ns() / 1e9 <= e.end_ns() / 1e9 <= s.end + tol
            if s.parent is not None:
                p = event_of[s.parent]
                assert p.start_ns() <= e.start_ns() and e.end_ns() <= p.end_ns()


def test_no_profiler_range_without_a_profiler(models, monkeypatch):
    opened = []
    real = profiling._open_range

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_open_range", spy)
    eng = _engine(models, kind="static")
    prompt = _requests()[1]["input_ids"]
    list(eng.generate_stream(input_ids=prompt, max_new_tokens=8))
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        list(eng.generate_stream(input_ids=prompt, max_new_tokens=8))
        with profiling.span("outer"):
            pass
    assert opened == ["engine.prefill", "outer"]


def test_ring_drops_the_oldest_first_and_says_so():
    ring = profiling.SpanRing(capacity=4)
    for i in range(6):
        ring.record(f"s{i}", float(10 * i), float(10 * i + 5), request=i)
    kept, dropped = ring.spans()
    assert [s.name for s in kept] == ["s2", "s3", "s4", "s5"] and dropped
    assert [s.request for s in kept] == [2, 3, 4, 5]
    # s1 ended at 15: a window from 15 on may lack it, one from 16 on does not
    assert ring.spans(15.0, 100.0)[1] and not ring.spans(16.0, 100.0)[1]
    assert [s.name for s in ring.spans(16.0, 32.0)[0]] == ["s2", "s3"]
    assert ring.totals()["s0"] == dict(count=1, seconds=5.0)
    assert sum(t["count"] for t in ring.totals().values()) == 6


def test_ring_under_contending_threads():
    """More threads than cores file nested spans at a short switch interval:
    no span is lost or torn, and each child names its own thread's parent."""
    ring = profiling.SpanRing(capacity=1 << 16)
    n_threads, per_thread = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                with ring.span("outer"):
                    with ring.span("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    found, dropped = ring.spans()
    assert not dropped and len(found) == 2 * n_threads * per_thread
    assert len({s.id for s in found}) == len(found)
    outer = {s.id: s for s in found if s.name == "outer"}
    for s in found:
        if s.name == "inner":
            p = outer[s.parent]
            assert p.thread == s.thread and p.start <= s.start <= s.end <= p.end
    assert ring.totals()["inner"]["count"] == n_threads * per_thread
