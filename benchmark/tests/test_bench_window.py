"""Window arithmetic: a rate over the whole window, percentiles over all
requests, and a stall inside the window moves both."""
import pytest

from benchmark import window
from benchmark.window import Record


def steady(stall_at=None, stall=0.0):
    """Ten requests, each 10 tokens in frames of 2 tokens every 0.1 s, sent
    every 1 s from t=0; a stall delays everything after `stall_at`."""
    recs = []
    for i in range(10):
        r = Record(index=i, prompt_len=100, max_new=10, greedy=False, sent=float(i))
        for f in range(1, 6):
            t = i + 0.1 * f + 0.05
            if stall_at is not None and t >= stall_at:
                t += stall
            r.arrive(t, 2 * f)
        r.done = r.times[-1]
        recs.append(r)
    return recs


def test_rate_over_the_whole_window():
    recs = steady()
    assert window.tokens_in(recs, 0.0, 10.0) == 100
    assert window.rate(recs, 0.0, 10.0) == pytest.approx(10.0)
    # a window that ends mid-request counts the frames that arrived
    assert window.tokens_in(recs, 0.0, 0.36) == 6


def test_percentiles_over_every_request():
    recs = steady()
    assert window.p95(window.ttfts(recs, 0.0, 10.0)) == pytest.approx(0.15)
    assert window.p95(window.tpots(recs, 0.0, 10.0)) == pytest.approx(0.4 / 9)
    assert window.p95(list(range(1, 101))) == 95
    assert window.p95([]) is None


def test_a_stall_moves_rate_and_tails():
    base, stalled = steady(), steady(stall_at=5.2, stall=2.0)
    assert window.rate(stalled, 0.0, 6.0) < window.rate(base, 0.0, 6.0)
    assert window.p95(window.tpots(stalled, 0.0, 12.0)) > window.p95(window.tpots(base, 0.0, 12.0))
    late = steady(stall_at=5.0, stall=2.0)
    assert window.p95(window.ttfts(late, 0.0, 12.0)) > window.p95(window.ttfts(base, 0.0, 12.0))


def test_context_seconds_and_prefills():
    r = Record(index=0, prompt_len=10, max_new=4, greedy=True, sent=0.0)
    r.arrive(1.0, 2)
    r.arrive(2.0, 4)
    r.done = 3.0
    # 1 s at 12 tokens of context, 1 s at 14
    assert window.context_seconds([r], 0.0, 10.0) == pytest.approx(26.0)
    assert window.context_seconds([r], 1.5, 10.0) == pytest.approx(0.5 * 12 + 14)
    assert window.prompts_started([r], 0.0, 10.0) == [10]
    assert window.prompts_started([r], 1.5, 10.0) == []


def test_traced_stretch_ends_where_the_counters_were_read():
    import types

    from benchmark import harness, spec

    def run_of(records):
        return types.SimpleNamespace(t0=0.0, t1=10.0, seconds=10.0, records=records,
                                     c0=dict(steps=0, at=0.0), c1=dict(steps=100, at=10.0))

    cm = dict(steps=50, at=5.0)
    base, stalled = steady(), steady(stall_at=5.2, stall=2.0)
    a, b = harness.stretch(run_of(base), cm), harness.stretch(run_of(stalled), cm)
    assert (a.t0, a.t1, a.seconds, a.c1["steps"]) == (0.0, 5.0, 5.0, 50)
    step_ms, tokens = spec.reader("step_ms"), spec.reader("tokens_per_step.serve")
    # a stall after the span's close moves neither the steps' time nor the tokens a step
    assert step_ms(a) == step_ms(b) == pytest.approx(100.0)
    assert tokens(a) == tokens(b) == pytest.approx(50 / 50)
    # over the whole window the stall would have moved them
    assert window.tokens_in(stalled, 0.0, 10.0) < window.tokens_in(base, 0.0, 10.0)
