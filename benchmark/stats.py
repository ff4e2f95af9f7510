"""The arithmetic of the end-to-end and device metrics, on plain lists."""

from __future__ import annotations

import math
import statistics


def rate(count: int, seconds: float) -> float:
    """Work completed per second over a whole window."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """(gap start, gap end) of ``[start, end]`` that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out


def spread(values) -> float:
    """Interquartile distance over the median (``statistics.quantiles``,
    n=4), the measure the bounds are set from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
