"""Reduction of a ``torch.profiler`` trace of the window.

The window is bounded by the harness's own ``bench.frame`` spans (a
``record_function`` around each frame), so it is read on the trace's own
clock.  Device time is the union of the CUDA timeline's intervals
(kernels, copies, sets; the device-side copies of host annotations left
out) inside the window.  A kernel is charged to the host operation that
launched it (the profiler's correlation link).  An idle gap is named by the
innermost host operation running at its middle.

The raw events of the profiler's results are read directly: building its
``FunctionEvent`` tree takes minutes for the hundreds of thousands of
operations a window of the batched route holds.
"""
from __future__ import annotations

import bisect

FRAME_SPAN = 'bench.frame'
NEST_SCAN = 64      # host operations looked back over to find the innermost


def _raw_events(prof):
    """(host events, device events): (name, start_s, end_s) each, a host
    event with the device seconds of the kernels it launched itself."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in evs), default=0)
    host, dev, by_corr = [], [], {}
    for e in evs:
        s = (e.start_ns() - base) * 1e-9
        item = [e.name(), s, s + e.duration_ns() * 1e-9]
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and item[0] != FRAME_SPAN:
                dev.append(item + [e.linked_correlation_id()])
        elif e.device_type() == DeviceType.CPU:
            item.append(0.0)
            host.append(item)
            by_corr[e.correlation_id()] = item
    for d in dev:
        op = by_corr.get(d[3])
        if op is not None:
            op[3] += d[2] - d[1]
    return ([tuple(h) for h in host], [tuple(d[:3]) for d in dev])


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class TraceView:
    """What the per-layer readers read: device time by kernel name, the
    window, busy time and the breakdown."""

    def __init__(self, host, dev):
        spans = [(h[1], h[2]) for h in host if h[0] == FRAME_SPAN]
        if not spans:
            raise RuntimeError('the trace holds no frame span')
        self.t0 = min(s for s, _ in spans)
        self.t1 = max(e for _, e in spans)
        self.host = [h for h in host if h[0] != FRAME_SPAN
                     and h[2] > self.t0 and h[1] < self.t1]
        self.dev = [(n, max(s, self.t0), min(e, self.t1)) for n, s, e in dev
                    if e > self.t0 and s < self.t1]
        self.busy = _union([(s, e) for _, s, e in self.dev])

    @classmethod
    def from_profiler(cls, prof):
        return cls(*_raw_events(prof))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def kernel_seconds(self, names) -> float:
        """Device seconds of the operations whose name holds one of
        ``names``."""
        return sum(e - s for n, s, e in self.dev
                   if any(k in n for k in names))

    def device_seconds(self) -> float:
        """Device seconds of every operation in the window, summed."""
        return sum(e - s for _, s, e in self.dev)

    def op_device_seconds(self, names) -> float:
        """Device seconds of the kernels the host operations named in
        ``names`` launched themselves."""
        return sum(h[3] for h in self.host if h[0] in names)

    def device_ops(self, top: int = 10):
        by = {}
        for n, s, e in self.dev:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10):
        """The idle time inside the window, summed by the host operation
        running at each gap's middle (innermost: the latest started)."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        host = sorted(self.host, key=lambda x: x[1])
        starts = [h[1] for h in host]
        by = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            name = 'host (no traced op)'
            k = bisect.bisect_right(starts, mid)
            for j in range(k - 1, max(-1, k - 1 - NEST_SCAN), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            by[name] = by.get(name, 0.0) + (g1 - g0)
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]
