"""The readers of the program's spans (spans.py and the five metrics that use
it) on a synthetic ring and stretch: request spans count where they end,
loop shares count the part inside the stretch, and a ring that dropped part
of the stretch, or a program that keeps no spans, gives nothing."""
import types

import pytest

from benchmark import spec
from umbrella_tpu_torch import profiling

STRETCH = types.SimpleNamespace(t0=100.0, t1=110.0)


@pytest.fixture
def ring(monkeypatch):
    ring = profiling.SpanRing(capacity=64)
    monkeypatch.setattr(profiling, "_RING", ring)
    return ring


def test_request_spans_count_where_they_end(ring):
    ring.record("serve.queue", 95.0, 100.5, request=1)  # ends inside: 5.5 s
    ring.record("serve.queue", 101.0, 101.5, request=2)  # inside: 0.5 s
    ring.record("serve.queue", 109.0, 111.0, request=3)  # ends after the stretch
    ring.record("serve.queue", 90.0, 99.0, request=4)  # ends before it
    ring.record("serve.admit", 101.5, 102.0, request=2)
    ring.record("engine.prefill", 104.0, 104.2)
    assert spec.reader("batcher_wait_ms_mean")(STRETCH) == pytest.approx(3000.0)
    assert spec.reader("admit_ms_mean")(STRETCH) == pytest.approx(500.0)
    assert spec.reader("prefill_ms_mean.chat")(STRETCH) == pytest.approx(200.0)


def test_loop_shares_count_the_part_inside(ring):
    ring.record("serve.prefill_chunk", 99.0, 101.0)  # 1 s inside
    ring.record("serve.prefill_chunk", 105.0, 105.5)
    ring.record("serve.sync", 102.0, 104.0)
    ring.record("serve.sync", 109.5, 112.0)  # 0.5 s inside
    assert spec.reader("loop_prefill_share")(STRETCH) == pytest.approx(15.0)
    assert spec.reader("loop_sync_share")(STRETCH) == pytest.approx(25.0)


def test_nothing_to_read_gives_none(ring):
    ring.record("serve.sync", 90.0, 95.0)
    for name in ("batcher_wait_ms_mean", "admit_ms_mean", "loop_prefill_share",
                 "loop_sync_share", "prefill_ms_mean.chat"):
        assert spec.reader(name)(STRETCH) is None


def test_a_ring_that_dropped_part_of_the_stretch_gives_none(monkeypatch):
    small = profiling.SpanRing(capacity=2)
    monkeypatch.setattr(profiling, "_RING", small)
    small.record("serve.queue", 100.0, 101.0, request=1)
    small.record("serve.queue", 102.0, 103.0, request=2)
    assert spec.reader("batcher_wait_ms_mean")(STRETCH) == pytest.approx(1000.0)
    small.record("serve.queue", 104.0, 104.5, request=3)  # drops request 1's
    assert spec.reader("batcher_wait_ms_mean")(STRETCH) is None
    # a stretch after the dropped span's end is whole
    later = types.SimpleNamespace(t0=101.5, t1=110.0)
    assert spec.reader("batcher_wait_ms_mean")(later) == pytest.approx(750.0)


def test_a_program_without_spans_gives_none(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert spec.reader("loop_sync_share")(STRETCH) is None
    assert spec.reader("prefill_ms_mean.chat")(STRETCH) is None
