"""The traffic generator: a seed fixes the requests; every seed gets the same
lengths in another order."""
import numpy as np

from benchmark import spec
from benchmark.traffic import Traffic, lognormal_quantiles


def mix():
    return spec.load_json(spec.HERE, "traffic", "serve32.json")


def test_same_seed_same_requests():
    a, b = Traffic(mix(), 2 ** 31 + 77, 32768), Traffic(mix(), 2 ** 31 + 77, 32768)
    for k in (0, 1, 5, 300):
        ra, rb = a.request(k), b.request(k)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert (ra.max_new, ra.greedy, ra.temperature) == (rb.max_new, rb.greedy, rb.temperature)


def test_every_seed_sends_the_same_sizes_and_other_ids():
    m = mix()
    a, b = Traffic(m, 1, 32768), Traffic(m, 2, 32768)
    la = [(len(a.request(k).prompt), a.request(k).max_new) for k in range(m["pool"])]
    assert la == [(len(b.request(k).prompt), b.request(k).max_new) for k in range(m["pool"])]
    assert not np.array_equal(a.request(3).prompt, b.request(3).prompt)
    # one pass over the pool sends each quantile once, prompts and outputs unpaired
    assert sorted(p for p, _ in la) == sorted(lognormal_quantiles(256, 384, 0.7, 32, 1536))
    assert len({o for _, o in la}) > 100 and la != sorted(la)


def test_a_short_prefix_spreads_over_the_distribution():
    m = mix()
    t = Traffic(m, 5, 32768)
    first = sorted(len(t.request(k).prompt) for k in range(8))
    q = lognormal_quantiles(256, 384, 0.7, 32, 1536)
    assert first[0] <= q[32] and first[-1] >= q[224]


def test_lengths_follow_the_mix():
    q = lognormal_quantiles(255, 384, 0.7, 32, 1536)
    assert q[127] == 384 and min(q) >= 32 and max(q) <= 1536 and q == sorted(q)


def test_greedy_share_and_ids():
    t = Traffic(mix(), 9, 1000)
    reqs = [t.request(k) for k in range(40)]
    assert [r.greedy for r in reqs] == [k % 4 == 0 for k in range(40)]
    assert all(r.temperature == 0.0 for r in reqs if r.greedy)
    assert all(r.prompt.max() < 1000 and r.prompt.dtype == np.int32 for r in reqs)
