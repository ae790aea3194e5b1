"""The port's spans and its render counters (``utils/spans.py``).

On a tiny textured streamed city (the bench city's route: K3 / K2's plain
versions here, the bounce sort, texel taps) and a tiny box through K1's
plain version:

* under ``torch.profiler`` each ``hc3.*`` span of the batched route is
  recorded as often as the frame runs its layer: ``hc3.pass`` once a tile
  a sample, each bounce stage once a bounce of a pass (the sort from the
  second bounce on), the gather sites inside the passes;
* with no profiler ``span`` is the one shared null context;
* ``render``'s timing dict: ``samples`` is W x H x spp on the batched
  route, where the rays are counted outside the timed frame by
  ``count_rays_pass`` (the bounce loop's counter, the same counts under a
  profiler); a regen frame's ``iters`` is what a wrap of
  ``megakernel.regen_pass`` counts, and its ``launches`` are none on the
  CPU (``test_torch_kernels_cuda.py`` holds them to the wrap's calls on
  the card).
"""
import collections

import numpy as np
import pytest
import torch

from hydracore3_torch import render as TR
from hydracore3_torch.models import integrator_pt as IPT
from hydracore3_torch.models import megakernel as TMK
from hydracore3_torch.ops import rng as RNG
from hydracore3_torch.scene import synth
from hydracore3_torch.utils import spans
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H, DEPTH, SPP, TILE = 16, 12, 3, 2, 128
TILES = -(-W * H // TILE)
PASSES = SPP * TILES
GATHERS = ('hc3.gather.light', 'hc3.gather.texel', 'hc3.gather.material',
           'hc3.gather.permute')


@pytest.fixture(scope='module')
def city():
    scene, meta = synth.city_scene(n_blocks=4, subdiv=1, seed=3, width=W,
                                   height=H, depth=DEPTH, ground_subdiv=8,
                                   textured=True, device='cpu',
                                   accel='stream')
    assert meta.use_stream and scene.textures.width.numel() > 1
    return scene, meta


@pytest.fixture(scope='module')
def traced(city):
    """(image, timing, the hc3 events: name -> [(start, end)]) of one
    profiled frame."""
    scene, meta = city
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        img, timing = TR.render(scene, meta, spp=SPP, tile_size=TILE,
                                return_timing=True)
    evs = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith('hc3.'):
            evs[e.name].append((e.time_range.start, e.time_range.end))
    return img, timing, evs


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span('hc3.render') is spans.span('hc3.pass')
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = spans.span('hc3.render')
    assert isinstance(on, torch.profiler.record_function)


def test_each_batched_span_is_recorded_once_a_layer_call(traced):
    _, _, evs = traced
    n = {k: len(v) for k, v in evs.items()}
    assert n['hc3.render'] == 1 and n['hc3.sync.readback'] == 1
    assert n['hc3.pass'] == PASSES and n['hc3.pass.env'] == PASSES
    for stage in ('trace', 'shade_ctx', 'nee', 'next'):
        assert n[f'hc3.bounce.{stage}'] == DEPTH * PASSES, stage
    # bounce 0 traces the camera's order; the others sort first
    assert n['hc3.bounce.sort'] == (DEPTH - 1) * PASSES
    # one march a bounce; a grid key for each bounce sort and each NEE's
    # shadow sort
    assert n['hc3.sync.unresolved'] == DEPTH * PASSES
    assert n['hc3.sync.grid_key'] == (2 * DEPTH - 1) * PASSES
    for g in GATHERS:
        assert n.get(g, 0) >= PASSES, g
    assert not any(k.startswith('hc3.mk.') for k in n)


def test_gather_spans_nest_inside_the_passes(traced):
    _, _, evs = traced
    passes = sorted(evs['hc3.pass'])
    (r0, r1), = evs['hc3.render']
    assert all(r0 <= s and e <= r1 for s, e in passes)
    for g in GATHERS + ('hc3.bounce.trace', 'hc3.sync.grid_key'):
        for s, e in evs[g]:
            assert any(p0 <= s and e <= p1 for p0, p1 in passes), g


def test_batched_timing_counts_samples_and_rays(city, traced):
    scene, meta = city
    img, timing, _ = traced
    assert timing['samples'] == W * H * SPP and timing['nonfinite'] == 0
    # the timed frame counts no rays
    assert set(timing) == {'total_s', 'spp', 'samples', 'nonfinite'}
    # the same frame with no profiler: the same image and counts
    img2, timing2 = TR.render(scene, meta, spp=SPP, tile_size=TILE,
                              return_timing=True)
    np.testing.assert_array_equal(img, img2)
    assert timing2['samples'] == timing['samples']
    # count_rays_pass over each tile's passes, each from the RNG rows the
    # pass starts from, with a profiler recording and without
    pix = torch.arange(W * H, dtype=torch.int64)
    want = np.zeros(2, np.int64)
    for s in range(0, W * H, TILE):
        p = pix[s:s + TILE]
        rng = RNG.gen_init(p)
        for _ in range(SPP):
            n = IPT.count_rays_pass(scene, meta, rng, p)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                assert IPT.count_rays_pass(scene, meta, rng, p) == n
            want += n
            rng = IPT.trace_pass(scene, meta, rng, p)[2]
    # every lane traces its camera ray, some go on; NEE casts shadow rays
    assert want[0] > W * H * SPP and want[1] > 0


def _counting_regen_pass(monkeypatch):
    """A wrap of ``megakernel.regen_pass`` that counts its calls and the
    iterations they ask for (the harness's way of reading them)."""
    seen = dict(calls=0, iters=0)
    inner = TMK.regen_pass

    def regen_pass(pk, xy, sf, su, k, *args, **kw):
        seen['calls'] += 1
        seen['iters'] += int(k)
        return inner(pk, xy, sf, su, k, *args, **kw)

    regen_pass.launches = inner.launches
    monkeypatch.setattr(TMK, 'regen_pass', regen_pass)
    return seen


def test_regen_frame_returns_its_iterations(monkeypatch):
    scene, meta = synth.box_scene(16, 8, 3, textured=True, device='cpu')
    seen = _counting_regen_pass(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, timing = TR.render(scene, meta, spp=4, regen=True,
                              return_timing=True)
    assert seen['calls'] >= 1 and timing['iters'] == seen['iters']
    assert timing['launches'] == 0          # the plain version on the CPU
    assert timing['samples'] >= 16 * 8 * 4 and 'rays' not in timing
    n = collections.Counter(e.name for e in prof.events()
                            if e.name.startswith('hc3.'))
    assert n['hc3.render'] == n['hc3.mk.pack'] == n['hc3.mk.lane_setup'] == 1
    assert n['hc3.mk.finalize'] == n['hc3.sync.samples'] == 1
    assert n['hc3.sync.readback'] == 1 and n['hc3.sync.stop_rule'] >= 1
    assert n['hc3.pass'] == 0


def test_fixed_chain_frame_counts_its_samples():
    scene, meta = synth.box_scene(16, 8, 3, textured=True, device='cpu')
    _, timing = TR.render(scene, meta, spp=2, return_timing=True)
    assert timing['samples'] == 16 * 8 * 2 and timing['launches'] == 0
    assert 'iters' not in timing
