"""Window arithmetic: what the clients saw, reduced to the end-to-end
metrics. Pure Python over the loops' records (drive.py; host clock, seconds).

A request's record holds its send time, each arrival of tokens as (time,
tokens delivered so far), and its completion time. The window is [t0, t1):
  - tokens in the window: for every request, tokens delivered by t1 less
    those delivered by t0 (streamed partial frames count as they arrive);
  - a rate is those tokens over t1 - t0, the window's whole length;
  - TTFT: first arrival less send, for every request whose first tokens came
    inside the window; TPOT: (completion - first arrival) / (tokens - 1) for
    every request completed inside the window with two tokens or more;
  - a p95 is the nearest-rank 95th percentile over all of those requests.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import List, Optional, Sequence


@dataclasses.dataclass
class Record:
    index: int
    prompt_len: int
    max_new: int
    greedy: bool
    sent: float
    times: List[float] = dataclasses.field(default_factory=list)  # arrival times
    counts: List[int] = dataclasses.field(default_factory=list)  # tokens so far
    done: Optional[float] = None
    failed: bool = False
    tokens: Optional[list] = None  # the served token ids, once complete

    def arrive(self, t: float, n: int) -> None:
        if n > (self.counts[-1] if self.counts else 0):
            self.times.append(t)
            self.counts.append(n)

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None

    def delivered(self, t: float) -> int:
        """Tokens delivered at or before t."""
        i = bisect.bisect_right(self.times, t)
        return self.counts[i - 1] if i else 0


def tokens_in(records: Sequence[Record], t0: float, t1: float) -> int:
    return sum(r.delivered(t1) - r.delivered(t0) for r in records)


def rate(records: Sequence[Record], t0: float, t1: float) -> float:
    return tokens_in(records, t0, t1) / (t1 - t0)


def p95(values: Sequence[float]) -> Optional[float]:
    """Nearest-rank 95th percentile; None for no values."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def ttfts(records: Sequence[Record], t0: float, t1: float) -> List[float]:
    return [r.first - r.sent for r in records
            if r.first is not None and t0 <= r.first < t1]


def tpots(records: Sequence[Record], t0: float, t1: float) -> List[float]:
    out = []
    for r in records:
        if r.done is None or not (t0 <= r.done < t1) or r.failed:
            continue
        n = r.counts[-1] if r.counts else 0
        if n >= 2:
            out.append((r.done - r.first) / (n - 1))
    return out


def completed_in(records: Sequence[Record], t0: float, t1: float) -> List[Record]:
    return [r for r in records if r.done is not None and t0 <= r.done < t1 and not r.failed]


def context_seconds(records: Sequence[Record], t0: float, t1: float) -> float:
    """Sum over requests of the integral, over the part of the window in which
    the request was decoding (first arrival to completion), of its context
    length (prompt plus tokens delivered): token-seconds of live cache."""
    total = 0.0
    for r in records:
        if r.first is None:
            continue
        a, b = max(t0, r.first), min(t1, r.done if r.done is not None else t1)
        if b <= a:
            continue
        i = bisect.bisect_right(r.times, a)
        t, n = a, r.counts[i - 1] if i else 0
        while i < len(r.times) and r.times[i] < b:
            total += (r.times[i] - t) * (r.prompt_len + n)
            t, n = r.times[i], r.counts[i]
            i += 1
        total += (b - t) * (r.prompt_len + n)
    return total


def prompts_started(records: Sequence[Record], t0: float, t1: float) -> List[int]:
    """Prompt lengths of the requests whose first tokens came inside the
    window: the prefills the window ran (a prefill ends at its first token)."""
    return [r.prompt_len for r in records if r.first is not None and t0 <= r.first < t1]
