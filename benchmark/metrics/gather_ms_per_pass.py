"""Device time of the row gathers (``aten::index``, ``index_select``,
``gather``: light rows, texel taps, material rows) in one pass of the
batched integrator, from the kernels those operations launched."""
from harness import spec

GATHERS = ('aten::index', 'aten::index_select', 'aten::gather')


def read(run):
    tv = run.trace
    if tv is None or run.traffic['route'] != 'batched':
        return None
    per_pass = spec.load_module('metrics', 'eager_ms_per_pass').passes(run)
    return 1e3 * tv.op_device_seconds(GATHERS) / per_pass
