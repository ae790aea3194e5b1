"""Device time of everything other than K3 and K2 in one pass of the
batched integrator (a pass: one sample of every pixel of a tile; with the
whole frame in one tile, 1,048,576 lanes): the eager shading, sorts,
gathers, light and material math, copies and sets."""
import math

from harness import port


def passes(run):
    tile = int(run.traffic.get('tile_size') or 1 << 15)
    return sum(f['spp'] for f in run.frames) * math.ceil(run.pixels / tile)


def read(run):
    tv = run.trace
    if tv is None or run.traffic['route'] != 'batched':
        return None
    eager = tv.device_seconds() - tv.kernel_seconds(port.TRACE_KERNELS)
    return 1e3 * eager / passes(run)
