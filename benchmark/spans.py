"""The program's own spans (umbrella_tpu_torch/profiling.py) over a run's
stretch, for the per-layer metrics that read them. Host clock
(`time.time()`), the clock of the stretch's ends. A program that keeps no
spans, or whose ring has dropped part of the stretch, gives None."""
from __future__ import annotations

from typing import List, Optional


def in_stretch(run) -> Optional[list]:
    """The spans that overlap [run.t0, run.t1], or None."""
    try:
        from umbrella_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    found, dropped = read(run.t0, run.t1)
    return None if dropped else found


def mean_ms(run, name: str) -> Optional[float]:
    """The mean length of the `name` spans that end inside the stretch (a
    request's span counts where it ends), or None where none does."""
    found = in_stretch(run)
    if found is None:
        return None
    ms: List[float] = [1000.0 * (s.end - s.start) for s in found
                       if s.name == name and run.t0 <= s.end <= run.t1]
    return sum(ms) / len(ms) if ms else None


def share(run, name: str) -> Optional[float]:
    """The seconds of the `name` spans inside the stretch over its seconds,
    in %, or None where there are none."""
    found = in_stretch(run)
    if found is None:
        return None
    busy = sum(min(s.end, run.t1) - max(s.start, run.t0) for s in found if s.name == name)
    return 100.0 * busy / (run.t1 - run.t0) if busy > 0 else None
