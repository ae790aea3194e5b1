"""The port's own spans in the trace of a window.

The port names its layers with ``torch.profiler`` ranges (``hc3.*``:
``hydracore3_torch/utils/spans.py``), which the trace holds as host
events beside the operations they enclose.  These helpers read them from
a ``TraceView``: a kernel is charged to a span when the host operation
that launched it started inside the span (the operation's own device
seconds, ``host[i][3]``); an idle stretch of the device to a span while
the host is inside it, or, for a blocking read, from inside it until the
device's next operation.  Nothing here looks at kernel names.  A trace of a
program without the spans holds none, and every reader then returns
nothing.
"""
from __future__ import annotations

import bisect
import itertools

# the port's span names
PREFIX = 'hc3.'

# the CUDA API calls that launch a kernel (runtime `cuda*`, `cu*`)
LAUNCHES = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
            'cuLaunchKernelEx', 'cudaLaunchCooperativeKernel')


def _index(tv):
    """(host starts in order, running sums of their device seconds and of
    their launches, the port's spans by name), made once a trace."""
    ix = getattr(tv, '_spans_index', None)
    if ix is None:
        host = sorted(tv.host, key=lambda h: h[1])
        by_name = {}
        for h in host:
            if h[0].startswith(PREFIX):
                by_name.setdefault(h[0], []).append((h[1], h[2]))
        ix = ([h[1] for h in host],
              list(itertools.accumulate((h[3] for h in host), initial=0.0)),
              list(itertools.accumulate((h[0] in LAUNCHES for h in host),
                                        initial=0)),
              by_name)
        tv._spans_index = ix
    return ix


def intervals(tv, names):
    """(start, end) of the port's spans named in ``names`` (a name ending
    in ``.*`` stands for every name under it), in start order."""
    by_name = _index(tv)[3]
    return sorted(iv for n, ivs in by_name.items()
                  if any(n == m or (m.endswith('.*')
                                    and n.startswith(m[:-1]))
                         for m in names)
                  for iv in ivs)


def count(tv, name) -> int:
    return len(_index(tv)[3].get(name, ()))


def union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _sum_inside(tv, names, which) -> float:
    ix = _index(tv)
    starts, sums = ix[0], ix[which]
    total = 0
    for s, e in union(intervals(tv, names)):
        total += (sums[bisect.bisect_right(starts, e)]
                  - sums[bisect.bisect_left(starts, s)])
    return total


def device_seconds_inside(tv, names) -> float:
    """Device seconds of the kernels launched by host operations that
    started inside a span named in ``names``."""
    return float(_sum_inside(tv, names, 1))


def launches_inside(tv, names) -> int:
    """Kernel launches (``LAUNCHES``) the host made inside a span named in
    ``names``."""
    return int(_sum_inside(tv, names, 2))


def _gaps(tv):
    """The device's idle gaps in the window, in order."""
    edges = [tv.t0] + [x for iv in tv.busy for x in iv] + [tv.t1]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]


def _spans_in_window(tv, names):
    return [(max(s, tv.t0), min(e, tv.t1))
            for s, e in union(intervals(tv, names))]


def idle_seconds_inside(tv, names) -> float:
    """Seconds of the window in which the device is idle and the host is
    inside a span named in ``names``: every idle gap of the window, each
    cut to the spans, over all of them."""
    spans = _spans_in_window(tv, names)
    total, j = 0.0, 0
    for g0, g1 in _gaps(tv):
        while j < len(spans) and spans[j][1] <= g0:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < g1:
            total += max(0.0, min(g1, spans[k][1]) - max(g0, spans[k][0]))
            k += 1
    return total


def idle_seconds_from(tv, names) -> float:
    """Seconds of the window in which the device is idle from inside a
    span named in ``names`` until its next operation: every idle gap that
    meets such a span, from where it first meets one to the gap's end (the
    next device operation, or the window's end).  After a blocking read
    the device drains its queue while the host waits, and stays idle once
    the read has returned until the host has queued the next kernels; this
    charges that stretch to the read, where ``idle_seconds_inside`` stops
    at the span's end."""
    spans = _spans_in_window(tv, names)
    total, j = 0.0, 0
    for g0, g1 in _gaps(tv):
        while j < len(spans) and spans[j][1] <= g0:
            j += 1
        if j < len(spans) and spans[j][0] < g1:
            total += g1 - max(g0, spans[j][0])
    return total
