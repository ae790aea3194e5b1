"""The system under test: the only module of the benchmark that imports the
PyTorch port (``hydracore3_torch``).

It hands the port a scene description as the port's own ``SceneDesc``,
builds the scene on a device, renders one frame through the port's entry
``render.render`` and reads the port's launch counters and kernel names.
Nothing here computes a result of its own.
"""
from __future__ import annotations

import numpy as np


def _port():
    from hydracore3_torch import render
    from hydracore3_torch.models import megakernel
    from hydracore3_torch.scene import build
    return render, megakernel, build


def scene_desc(desc: dict):
    """The port's ``SceneDesc`` of a plain description (``scenes/*.py``)."""
    _, _, B = _port()
    sd = B.SceneDesc(width=desc['width'], height=desc['height'],
                     trace_depth=desc['depth'], spp=1)
    for t in desc['textures']:
        sd.add_texture(t)
    for m in desc['materials']:
        sd.materials.append(B.MaterialDesc(**m))
    for m in desc['meshes']:
        sd.meshes.append(B.MeshDesc(pos=m['pos'], indices=m['indices'],
                                    mat_indices=m['mat_indices'],
                                    texc=m.get('texc')))
        sd.instances.append((len(sd.meshes) - 1, m.get('matrix')))
    for L in desc.get('area_lights', ()):
        sd.lights.append(B.AreaLightDesc(**L))
    for L in desc.get('simple_lights', ()):
        sd.simple_lights.append(B.SimpleLightDesc(**L))
    if desc.get('env') is not None:
        sd.env = B.EnvLightDesc(**desc['env'])
    sd.camera = B.CameraDesc(**desc['camera'])
    return sd


def build(desc: dict, device, accel: str = 'auto'):
    """(scene, meta) of the description on ``device``."""
    _, _, B = _port()
    return B.build_scene(scene_desc(desc), device=device, accel=accel)


def route(scene, meta, traffic: dict) -> str:
    """'megakernel' where the port's router sends the frame to K1, else
    'batched'."""
    render, _, _ = _port()
    return ('megakernel' if render.use_megakernel(
        scene, meta, traffic['integrator']) else 'batched')


class RegenSpan:
    """A span around the port's persistent-lane layer: wraps
    ``megakernel.regen_pass`` (which ``megakernel.render`` looks up at each
    call) and counts its calls and the iterations they ask for, on the CPU
    plain version and the CUDA kernel alike.

    A regen frame's reference runs for the iterations the frame ran, and
    ``render`` does not return that count; this span is where the harness
    reads it.  ``verify`` refuses a window whose count it could not read."""

    def __init__(self):
        _, MK, _ = _port()
        self.calls = 0
        self.iters = 0
        self._mk = MK
        self._inner = MK.regen_pass

        def regen_pass(pk, xy, sf, su, k, *args, **kw):
            self.calls += 1
            self.iters += int(k)
            return self._inner(pk, xy, sf, su, k, *args, **kw)

        # the port counts its launches on whatever ``regen_pass`` names
        self._launches0 = getattr(self._inner, 'launches', 0)
        regen_pass.launches = self._launches0
        self._wrapper = regen_pass
        MK.regen_pass = regen_pass

    def launches(self) -> int:
        """The CUDA launches the port counted since the span opened."""
        return self._wrapper.launches - self._launches0

    def verify(self, frames, cuda: bool):
        """Raise unless every frame ran iterations through this span and,
        on the card, the span saw every launch the port counted."""
        blind = sum(1 for f in frames if f['iters'] <= 0)
        if blind or (cuda and self.calls != self.launches()):
            raise RuntimeError(
                f'the harness cannot read the regen iterations: {blind} of '
                f'{len(frames)} frames ran none through '
                f'megakernel.regen_pass, which saw {self.calls} calls where '
                f'the port counted {self.launches()} launches; the port no '
                'longer launches K1 through that name, so the reference '
                'cannot follow the frames (render should return the count)')

    def close(self):
        if hasattr(self._inner, 'launches'):
            self._inner.launches = self._wrapper.launches
        self._mk.regen_pass = self._inner


def frame(scene, meta, traffic: dict):
    """One frame through the port's entry, back on the host: (image
    [H, W, 4] float32 numpy, samples completed)."""
    render, _, _ = _port()
    kw = dict(spp=int(traffic['spp']), integrator=traffic['integrator'],
              regen=bool(traffic.get('regen', False)), return_timing=True)
    if traffic.get('tile_size'):
        kw['tile_size'] = int(traffic['tile_size'])
    img, timing = render.render(scene, meta, **kw)
    samples = timing.get('samples', meta.width * meta.height * kw['spp'])
    return np.asarray(img), int(samples)


# the port's kernel names, by the layer they belong to (the trace readers
# sum device time by these)
K1_KERNELS = ('mega_regen_kernel', 'mega_sample_kernel')
TRACE_KERNELS = ('intersect_march_kernel', 'intersect_stream_kernel')
