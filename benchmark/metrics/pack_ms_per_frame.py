"""Host time of K1's per-frame table pack (``megakernel.pack``, the
port's ``hc3.mk.pack`` span) a frame: the spans' summed duration over
the window's ``hc3.render`` spans.  Nothing where the trace holds
neither span."""
from harness import spans


def read(run):
    tv = run.trace
    n = 0 if tv is None else spans.count(tv, 'hc3.render')
    packs = [] if n == 0 else spans.intervals(tv, ('hc3.mk.pack',))
    if not packs:
        return None
    return 1e3 * sum(e - s for s, e in packs) / n
