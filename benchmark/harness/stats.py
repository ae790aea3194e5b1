"""The window's arithmetic: rates over whole frames, tails over all frames,
and the spread of repeated runs."""
from __future__ import annotations

import math
import statistics


def window_seconds(frames) -> float:
    """From the first frame's start to the last frame's end."""
    return frames[-1]['end'] - frames[0]['start']


def rate(frames, key: str = 'samples') -> float:
    """All of ``key`` completed in the window's frames over the window."""
    return sum(f[key] for f in frames) / window_seconds(frames)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values."""
    v = sorted(values)
    if not v:
        raise ValueError('percentile of no values')
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def frame_ms(frames):
    return [1e3 * (f['end'] - f['start']) for f in frames]


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
