"""Host-side speculation helpers (device-side ones live in ops/sampling.py)."""
import re


def is_sentence_complete_regex(text: str) -> bool:
    return bool(re.search(r"[.?!。？！]\s*$", text))


def next_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
