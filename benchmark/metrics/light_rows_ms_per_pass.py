"""Device time of the light rows (``lights.gather_light``, the port's
``hc3.gather.light`` span) in one pass of the batched integrator: the
kernels launched inside those spans over the window's ``hc3.pass``
spans.  Nothing where the trace holds neither span."""
from harness import spans


def read(run):
    tv = run.trace
    n = 0 if tv is None else spans.count(tv, 'hc3.pass')
    if n == 0 or not spans.intervals(tv, ('hc3.gather.light',)):
        return None
    return 1e3 * spans.device_seconds_inside(tv, ('hc3.gather.light',)) / n
