"""What the readers of the program's own spans and counters share
(hipie_torch/utils/trace.py: ``span`` ranges in the traced window, the
``COUNTS`` counters).

* ``idle_in_spans_us``: the card-idle time inside the union of host spans:
  the union's length minus the part of it the card's intervals cover, whoever
  launched them (work launched before a span that runs into it is busy time);
* ``spans_within``: the spans of one name that lie inside a span of another
  (a checkpointed block's recompute inside the ``backward`` range);
* ``host_syncs``: the sum of the program's ``host_sync.*`` counters, or None
  for a program that has no such counters.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

Span = Tuple[float, float]


def merge(spans) -> List[List[float]]:
    """The union of (start, end) intervals as sorted disjoint [start, end]."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_in_spans_us(intervals: Sequence[tuple], spans: Sequence[Span],
                     window: Optional[Span] = None) -> float:
    """``intervals`` the card's (start, end, ...), ``spans`` host (start, end)
    that may nest or overlap, both in us; spans are clipped to ``window``."""
    if window is not None:
        spans = [(max(s, window[0]), min(e, window[1])) for s, e in spans]
        spans = [(s, e) for s, e in spans if e > s]
    busy = merge((iv[0], iv[1]) for iv in intervals)
    starts = [b[0] for b in busy]
    idle = 0.0
    for s, e in merge(spans):
        covered = 0.0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            covered += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
        idle += (e - s) - covered
    return idle


def spans_within(inner: Sequence[Span], outer: Sequence[Span]) -> List[Span]:
    """The spans of ``inner`` that lie wholly inside one of ``outer``."""
    out = merge(outer)
    starts = [o[0] for o in out]
    got = []
    for s, e in inner:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= out[i][1]:
            got.append((s, e))
    return got


def host_syncs() -> Optional[int]:
    try:
        import hipie_torch.utils.trace as trace
    except ImportError:         # a program without its own counters
        return None
    counts = getattr(trace, "COUNTS", None)
    if counts is None:
        return None
    return sum(v for k, v in dict(counts).items() if k.startswith("host_sync."))
