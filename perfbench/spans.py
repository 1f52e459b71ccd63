"""What the program's own spans say about a traced run, for the per-layer
metrics that read them: the card's idle time inside the spans'
torch.profiler annotations, and the spans' device time (``dev_s``) a
unit. Each returns None where its input is absent (the CPU, no profile,
a program that records no such span)."""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence, Tuple

from perfbench import harness


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                 float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_inside(profile, name: str) -> Optional[Tuple[float, float]]:
    """(idle us, extent us) of the card inside the annotations ``name`` in
    ``profile``'s host events, clipped to the profiled window; None
    without a profile or such an annotation."""
    if profile is None:
        return None
    t0, t1 = profile.window_us
    marks = _union((max(a, t0), min(b, t1)) for a, b, n in profile.host
                   if n == name and b > t0 and a < t1)
    if not marks:
        return None
    dev = profile.dev
    starts = [a for a, _, _ in dev]
    longest = max((b - a for a, b, _ in dev), default=0.0)
    idle = extent = 0.0
    for a, b in marks:
        # the device events that may overlap [a, b]
        lo = bisect.bisect_left(starts, a - longest)
        hi = bisect.bisect_right(starts, b)
        idle += sum(g1 - g0 for g0, g1 in harness.idle_gaps(dev[lo:hi], a, b))
        extent += b - a
    return idle, extent


def idle_pct_inside(profile, name: str) -> Optional[float]:
    got = idle_inside(profile, name)
    if got is None or got[1] <= 0:
        return None
    return 100.0 * got[0] / got[1]


def dev_ms_per(window, names: Sequence[str], unit: str) -> Optional[float]:
    """Milliseconds of the card's time of the spans ``names`` (their
    ``dev_s`` summed) over the number of ``unit`` spans in ``window``;
    None where a span lacks ``dev_s`` or none was recorded."""
    units = len(window.spans_named(unit))
    spans = [s for s in window.spans if s["name"] in names]
    if not units or not spans or any("dev_s" not in s for s in spans):
        return None
    return 1e3 * sum(s["dev_s"] for s in spans) / units
