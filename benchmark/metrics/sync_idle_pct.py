"""The share of the traced window in which the device is idle while the
host is inside one of the port's blocking reads (an ``hc3.sync.*`` span:
K1's stop rule and sample count, the batched pass's unresolved lanes and
grid keys, the image's readback), and after it until the device's next
operation: every idle gap that meets such a span, from where it meets
it to the gap's end (``spans.idle_seconds_from``).  The device drains
its queue while the host waits in the read, so most of what a read costs
is the idle stretch after it returns, until the host has queued the next
kernels.  Nothing where the trace holds no such span."""
from harness import spans

SYNC = ('hc3.sync.*',)


def read(run):
    tv = run.trace
    if tv is None or tv.window_s <= 0.0 or not spans.intervals(tv, SYNC):
        return None
    return 100.0 * spans.idle_seconds_from(tv, SYNC) / tv.window_s
