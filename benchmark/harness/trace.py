"""The traced run's profiler and its reduction to what the readers take.

``Trace`` runs ``torch.profiler`` (CPU and CUDA activities, no shapes, no
stacks) around the window, which is marked by a host range ``bench.window``.
Once the window is over, ``reduce`` reads the trace's raw events once:

* device intervals: every kernel, copy and memset on the card, clipped to the
  window;
* busy: the length of their union, so that overlapping streams count once;
  idle share = 1 - busy / window, the same arithmetic as on the result's
  ``device`` fields busy_s and window_s;
* device time by kernel name;
* the program's named host ranges (``torch.profiler.record_function``), and
  for each device interval the host time of the runtime call that launched
  it (linked by the CUDA correlation id), so that ``range_busy_us`` gives the
  device busy time of the work launched inside a range, whichever host thread
  launched it (autograd's engine thread launches the backward's kernels) and
  without the idle gaps the host leaves inside it;
* idle gaps: the stretches of the window where nothing ran on the card, each
  named by the innermost host operation running at its middle, or
  ``host_idle`` where none ran.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"


class Reduced:
    def __init__(self):
        self.window: Tuple[float, float] = (0.0, 0.0)      # us
        self.intervals: List[Tuple[float, float, str]] = []
        self.busy_us = 0.0
        self.by_kernel: Dict[str, List[float]] = {}          # name -> [us, count]
        self.spans: Dict[str, List[Tuple[float, float]]] = {}   # host ranges by name, us
        self.launched: List[Tuple[float, float, float]] = []  # (launch us, device start, end)
        self.gaps: List[Tuple[str, float]] = []               # (host op, seconds)
        self.n_events = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def kernel_us(self, patterns) -> Tuple[float, int]:
        """Device us and count of the kernels whose name contains any pattern."""
        us = n = 0
        for name, (t, c) in self.by_kernel.items():
            if any(p in name for p in patterns):
                us += t
                n += c
        return us, n

    def range_busy_us(self, match) -> float:
        """Device busy us (the union of the intervals) of the work launched
        while a host range whose name satisfies ``match`` was open."""
        return busy_in_spans(self.launched,
                             [sp for n, sps in self.spans.items() if match(n) for sp in sps])

    def top_ops(self, k: int = 10):
        rows = sorted(self.by_kernel.items(), key=lambda r: -r[1][0])[:k]
        return [[name[:64], t / 1e6] for name, (t, _) in rows]


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def busy_in_spans(launched, spans) -> float:
    """The union of the device intervals of ``launched`` ((launch, start, end))
    whose launch lies inside one of ``spans`` (host (start, end), may nest)."""
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [m[0] for m in merged]
    inside = []
    for t, s, e in launched:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= merged[i][1]:
            inside.append((s, e))
    return union_us(inside)


def _events(prof):
    """(name, device_type is CUDA, start us, end us, is a user annotation,
    CUDA correlation id)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    res = prof.profiler.kineto_results
    for e in res.events():
        start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
        dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else e.duration_us()
        annot = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
        yield e.name(), e.device_type() == cuda, start, start + dur, annot, e.correlation_id()


def reduce(prof, n_gaps: int = 10) -> Reduced:
    return reduce_events(_events(prof), n_gaps)


def reduce_events(events, n_gaps: int = 10) -> Reduced:
    r = Reduced()
    host, dev, launch = [], [], {}
    window: Optional[Tuple[float, float]] = None
    for name, on_dev, s, e, annot, corr in events:
        r.n_events += 1
        if on_dev:
            if not annot:
                dev.append((s, e, name, corr))
        elif name == WINDOW:
            window = (s, e)
        elif annot:
            r.spans.setdefault(name, []).append((s, e))
        else:
            host.append((s, e, name))
            if corr and name.startswith("cu"):        # a CUDA API call (cuda*, cu*)
                launch[corr] = s
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window
    r.window = window
    dev = sorted((max(s, w0), min(e, w1), n, c) for s, e, n, c in dev if e > w0 and s < w1)
    r.intervals = [(s, e, n) for s, e, n, _ in dev]
    r.launched = [(launch[c], s, e) for s, e, _, c in dev if c in launch]
    for s, e, n, _ in dev:
        t = r.by_kernel.setdefault(n, [0.0, 0])
        t[0] += e - s
        t[1] += 1
    # the union of the device intervals, and the gaps between its pieces
    merged: List[List[float]] = []
    for s, e, _, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    r.busy_us = sum(e - s for s, e in merged)
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]
    host.sort()
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        best = None
        i = bisect.bisect_right(starts, mid)
        # host ops that started before the middle and end after it; the shortest
        # is the innermost (look back over a bounded stretch of starts)
        for s, e, n in host[max(0, i - 4000):i]:
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        r.gaps.append((best[2] if best else "host_idle", (g1 - g0) / 1e6))
    return r


class Trace:
    """Context manager: the profiler around the window."""

    def __init__(self):
        import torch

        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            record_shapes=False, with_stack=False, profile_memory=False)
        self.reduced: Optional[Reduced] = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> Reduced:
        self.reduced = reduce(self.prof)
        return self.reduced
