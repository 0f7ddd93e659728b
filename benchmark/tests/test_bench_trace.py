"""The traced span's reduction: busy time is the union of device records
clipped to the span, idle gaps are named by the host op before them."""
import pytest

from benchmark import trace


def test_busy_union_and_gaps():
    t = dict(device=[("k1", 0.0, 100.0), ("k2", 50.0, 150.0), ("k1", 400.0, 500.0),
                     ("k3", 900.0, 1200.0)],
             host=[(10.0, 20.0, "aten::mm"), (160.0, 170.0, "cudaGraphLaunch"),
                   (0.0, 1000.0, trace.SPAN)], pad=0)
    s = trace.summarize(t, 0.0, 1000.0)
    assert s["window_s"] == pytest.approx(1e-3)
    # [0, 150] and [400, 500] and [900, 1000] (clipped)
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["by_name"]["k1"] == pytest.approx(200e-6)
    gaps = s["idle_gaps"]
    assert gaps[0] == ["host in cudaGraphLaunch", pytest.approx(400e-6)]
    assert gaps[1] == ["host in cudaGraphLaunch", pytest.approx(250e-6)]
    assert len(gaps) == 2
    assert s["device_ops"][0][0] == "k3" or s["device_ops"][0][0] == "k1"


def test_union():
    assert trace.union([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
