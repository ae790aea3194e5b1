"""Device time of the texel taps (``ops/texture.sample``, the port's
``hc3.gather.texel`` span: the slot reads, the texel fetches and the
filter's arithmetic) in one pass of the batched integrator: the kernels
launched inside those spans over the window's ``hc3.pass`` spans.
Nothing where the trace holds neither span."""
from harness import spans


def read(run):
    tv = run.trace
    n = 0 if tv is None else spans.count(tv, 'hc3.pass')
    if n == 0 or not spans.intervals(tv, ('hc3.gather.texel',)):
        return None
    return 1e3 * spans.device_seconds_inside(tv, ('hc3.gather.texel',)) / n
