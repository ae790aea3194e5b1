"""Named host spans of the render routes, for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records, and one shared null context otherwise: an ungated range
costs tens of microseconds a call with no profiler running, the gate under
one.  A range lands on the profiler's clock beside the CUDA kernels it
launched, so a trace charges device time and idle gaps to the span the
host was in (the CLI's ``-profile`` trace shows them too).  Every span of
the port is made here.

The names (``hc3.`` then the layer):

- ``hc3.render``: one frame, the body of ``render.render`` and
  ``render.render_qmc`` (K1's frames included);
- ``hc3.sync.readback``: the image's copy to the host;
- K1's frame loop (``models/megakernel.render``): ``hc3.mk.pack`` (the
  tables packed for the kernel), ``hc3.mk.lane_setup``,
  ``hc3.sync.stop_rule`` (the host reads the lanes' mean samples),
  ``hc3.mk.finalize`` (``regen_finalize``) and ``hc3.sync.samples`` (the
  host reads the frame's sample count);
- the batched pass (``render._one_sample``,
  ``models/integrator_pt.trace_pass_state``): ``hc3.pass`` (one sample of
  one tile), and in each bounce ``hc3.bounce.sort`` (bounces after the
  first, on sorted scene classes), ``hc3.bounce.trace``,
  ``hc3.bounce.shade_ctx``, ``hc3.bounce.nee`` (not under ``naivept``)
  and ``hc3.bounce.next``; then ``hc3.pass.env`` (the permute back and
  the environment);
- the gathers by site: ``hc3.gather.light`` (``lights.gather_light``),
  ``hc3.gather.texel`` (``ops/texture.sample``), ``hc3.gather.material``
  (``bsdf/dispatch.gather_material``) and ``hc3.gather.permute``
  (``integrator_pt._permute_state``);
- the host's blocking reads in the batched pass: ``hc3.sync.unresolved``
  (the march's unresolved lanes, ``integrator_pt.nearest_hit``) and
  ``hc3.sync.grid_key`` (the grid's tables copied to the device,
  ``integrator_pt._grid_cell_key``).
"""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else the
    shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
