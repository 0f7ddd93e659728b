"""The traced span's reduction: busy time is each card's union of its device
records clipped to the span, averaged over the run's cards; idle gaps (no
card busy) are named by the host op before them; one card reads as the
reduction did before it knew of cards."""
import bisect
import types

import pytest

from benchmark import spec, trace


def one_card_summary(t: dict, lo: float, hi: float, top: int = 10) -> dict:
    """The reduction as it read before cards: one union of every record."""
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e, _ in t["device"] if e > lo and s < hi]
    busy = trace.union([(s, e) for _, s, e in dev if e > s])
    by_name = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + max(0.0, e - s) / 1e6
    gaps, prev = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host = sorted(h for h in t["host"] if h[2] != trace.SPAN)
    starts = [h[0] for h in host]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        i = bisect.bisect_right(starts, b) - 1
        label = host[i][2] if i >= 0 else "no host op recorded"
        named.append([f"host in {label}"[:120], (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=sum(e - s for s, e in busy) / 1e6, window_s=(hi - lo) / 1e6,
                by_name=by_name, device_ops=[[n[:120], t] for n, t in ops], idle_gaps=named)


def one_card():
    return dict(device=[("k1", 0.0, 100.0, 0), ("k2", 50.0, 150.0, 0), ("k1", 400.0, 500.0, 0),
                        ("k3", 900.0, 1200.0, 0)],
                host=[(10.0, 20.0, "aten::mm"), (160.0, 170.0, "cudaGraphLaunch"),
                      (0.0, 1000.0, trace.SPAN)], pad=0)


def test_busy_union_and_gaps():
    s = trace.summarize(one_card(), 0.0, 1000.0)
    assert s["window_s"] == pytest.approx(1e-3)
    # [0, 150] and [400, 500] and [900, 1000] (clipped)
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["by_name"]["k1"] == pytest.approx(200e-6)
    gaps = s["idle_gaps"]
    assert gaps[0] == ["host in cudaGraphLaunch", pytest.approx(400e-6)]
    assert gaps[1] == ["host in cudaGraphLaunch", pytest.approx(250e-6)]
    assert len(gaps) == 2
    assert s["device_ops"][0][0] == "k3" or s["device_ops"][0][0] == "k1"


@pytest.mark.parametrize("card", [0, 3, -1])
def test_one_card_reads_as_before(card):
    """Whatever number the profiler gives the one card, every field is the
    one-union reduction's, bit for bit, and busy_s_by_card holds busy_s."""
    t = one_card()
    t["device"] = [(n, s, e, card) for n, s, e, _ in t["device"]]
    for lo, hi in ((0.0, 1000.0), (120.0, 950.0), (2000.0, 3000.0)):
        s = trace.summarize(t, lo, hi)
        assert s.pop("busy_s_by_card") == [s["busy_s"]]
        assert s == one_card_summary(t, lo, hi)


def two_cards():
    """Card 0 busy [0, 400] and [600, 700]; card 1 busy [300, 500], a peer
    copy [500, 600] and [800, 1000] past the span's end at 900."""
    return dict(device=[("k0", 0.0, 400.0, 0), ("k0", 600.0, 700.0, 0),
                        ("k1", 300.0, 500.0, 1), ("Memcpy PtoP (Device -> Device)", 500.0, 600.0, 1),
                        ("k1", 800.0, 1000.0, 1)],
                host=[(700.0, 710.0, "aten::to"), (0.0, 900.0, trace.SPAN)], pad=0)


def test_two_cards_busy_each_and_their_mean():
    s = trace.summarize(two_cards(), 0.0, 900.0, cards=2)
    assert s["busy_s_by_card"] == [pytest.approx(500e-6), pytest.approx(400e-6)]
    assert s["busy_s"] == pytest.approx(450e-6)
    # names and gaps stay over the cards together: no card busy in [700, 800] only
    assert s["by_name"]["k1"] == pytest.approx(300e-6)
    assert s["idle_gaps"] == [["host in aten::to", pytest.approx(100e-6)]]
    reader = spec.reader("device_idle_share")
    assert reader(types.SimpleNamespace(trace=s)) == pytest.approx(50.0)


def test_a_card_without_records_reads_zero():
    s = trace.summarize(two_cards(), 0.0, 900.0, cards=4)
    assert s["busy_s_by_card"][2:] == [0.0, 0.0]
    assert s["busy_s"] == pytest.approx(900e-6 / 4)


def test_peer_copy_share():
    read = spec.reader("peer_copy_share")
    s = trace.summarize(two_cards(), 0.0, 900.0, cards=2)
    assert read(types.SimpleNamespace(trace=s)) == pytest.approx(100.0 * 100 / 900)
    t = two_cards()
    t["device"] = [r for r in t["device"] if not r[0].startswith("Memcpy")]
    assert read(types.SimpleNamespace(trace=trace.summarize(t, 0.0, 900.0, cards=2))) is None
    assert read(types.SimpleNamespace(trace=None)) is None


def test_union():
    assert trace.union([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
