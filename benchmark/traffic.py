"""The one general traffic generator: every mix is a JSON file under
`benchmark/traffic/`, read here.

Every seed gets the same work: a mix's `pool` prompt lengths are the
lognormal's quantiles at (i + 0.5) / pool, clipped, and so are its output
lengths. The k-th request takes the prompt quantile at the bit reversal of
k mod pool and the output quantile at a golden-ratio stride, so that every
prefix of the sequence (what a short window sends) spreads over the whole
distribution, and prompt and output lengths are not paired. A seed draws the
token ids (and the engine's sampling). The k-th request a run sends is
`request(k)`, whatever the clients' timing.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    prompt: np.ndarray  # int32 token ids
    max_new: int
    greedy: bool
    temperature: float
    topp: float
    repetition_penalty: float


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int, hi: int) -> List[int]:
    """n lengths at the lognormal's quantiles (i + 0.5) / n, rounded and clipped
    to [lo, hi]: the same multiset for every seed."""
    inv = NormalDist().inv_cdf
    out = [median * math.exp(sigma * inv((i + 0.5) / n)) for i in range(n)]
    return [int(min(hi, max(lo, round(x)))) for x in out]


def lengths(dist: dict, n: int) -> List[int]:
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return lognormal_quantiles(n, dist["median"], dist["sigma"], dist["min"], dist["max"])


def bit_reversal(i: int, n: int) -> int:
    """i's bits reversed over log2(n) bits (n a power of two)."""
    bits = n.bit_length() - 1
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def golden_stride(i: int, n: int) -> int:
    """i times the odd step nearest 0.618 n, mod n: a permutation of range(n)
    for n a power of two."""
    step = round(0.6180339887 * n) | 1
    return (i * step) % n


class Traffic:
    """The request sequence of one mix under one seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        self.pool = int(mix["pool"])
        if self.pool & (self.pool - 1):
            raise ValueError(f"a mix's pool is a power of two, not {self.pool}")
        self._prompts = lengths(mix["prompt"], self.pool)
        self._outputs = lengths(mix["output"], self.pool)

    def request(self, k: int) -> Request:
        i = k % self.pool
        n_prompt = self._prompts[bit_reversal(i, self.pool)]
        rng = np.random.default_rng([self.seed, k, 2])
        prompt = rng.integers(0, self.vocab, size=n_prompt, dtype=np.int64).astype(np.int32)
        s = self.mix["sampling"]
        every = int(self.mix["greedy_every"])
        greedy = k % every == 0
        return Request(index=k, prompt=prompt,
                       max_new=int(self._outputs[golden_stride(i, self.pool)]),
                       greedy=greedy,
                       temperature=0.0 if greedy else float(s["temperature"]),
                       topp=float(s["topp"]),
                       repetition_penalty=1.0 if greedy else float(s["repetition_penalty"]))
