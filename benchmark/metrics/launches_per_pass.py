"""Kernel launches the host makes in one pass of the batched integrator:
the CUDA runtime's launch calls inside the port's ``hc3.pass`` spans over
the spans' count (the host-bound layer's work, as a count).  The port's
own ray-query kernels (K3 and K2, ten a pass) are launched through ctypes
by the CUDA runtime their library links statically; the trace links them
to no host operation, and whether their launch calls are among those
counted is not established.  Nothing where the trace holds no such
span."""
from harness import spans


def read(run):
    tv = run.trace
    n = 0 if tv is None else spans.count(tv, 'hc3.pass')
    if n == 0:
        return None
    return spans.launches_inside(tv, ('hc3.pass',)) / n
