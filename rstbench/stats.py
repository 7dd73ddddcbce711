"""Window arithmetic: rates, percentiles and unions of intervals.

Pure Python on host numbers, so that the CPU tests can hold every formula
the metrics use.
"""
from __future__ import annotations

import math


def per_call_ms(window_s: float, calls: int) -> float | None:
    """The window's wall time over the calls completed in it, in ms."""
    if calls <= 0 or window_s <= 0:
        return None
    return window_s * 1e3 / calls


def percentile(values, q: float) -> float | None:
    """Nearest-rank percentile: the smallest value with at least ``q`` % of
    all values at or below it."""
    vals = sorted(values)
    if not vals:
        return None
    k = max(1, math.ceil(q / 100 * len(vals)))
    return vals[k - 1]


def merge(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint intervals covering the union of ``intervals``."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The uncovered stretches of [lo, hi] between sorted disjoint
    intervals ``merged``."""
    out, cur = [], lo
    for a, b in merged:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def idle_pct(busy_s: float, window_s: float) -> float | None:
    """Share of the window in which the device ran nothing, in %."""
    if window_s <= 0 or busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)
