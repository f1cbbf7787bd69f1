"""The arithmetic of the metrics: the rate over a whole window, a
percentile over all samples, the union of busy intervals, the quartile
spread that sets a bound."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(work: float, window_s: float) -> float:
    """All the work finished in the window over all of its seconds."""
    if window_s <= 0.0:
        raise ValueError(f"window of {window_s} s")
    return work / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of all ``values``, linear between
    the two nearest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float,
         stop: float) -> List[Tuple[float, float]]:
    """The stretches of [start, stop) that no interval covers."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, stop)))
        at = max(at, e)
        if at >= stop:
            break
    if at < stop:
        out.append((at, stop))
    return [(s, e) for s, e in out if e > s]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles over the median
    (``statistics.quantiles``' default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)
