"""K1's pooled schedule (csrc/megakernel.cu) on the CPU, against its plain
version.

The CUDA source is compiled with g++ under the stub of
``scripts/rehearse_mega_cpu.py``: one ``std::thread`` per CUDA thread of a
block, a C++20 ``std::barrier`` for ``__syncthreads``, the warp votes
(``__match_any_sync``, ``__shfl_sync``) over groups of 32 threads, and a
grid of two persistent blocks, so a launch's pools are shared between two
blocks and every barrier of the schedule must hold.  Both entry points of
the GLTF ``mispt`` variant (one lane a thread) run on the textured box
(32 x 24; its geometry and walk stacks on chip) and on the box with its
walls cut into 20 x 20 grids (its geometry in device memory, a local
stack); of the zoo box's ``mispt`` variant (pooled) on the zoo box
(48 x 36; on chip) and on the zoo box with its walls cut into 4 x 4 grids
(32 x 24; in device memory); and of the spectral box's ``mispt`` variant
(pooled) on the spectral box with its walls cut likewise (32 x 24; in
device memory).  Each runs on a lane count that is no multiple of a pool:
the fixed chain, and regen with ``k = 1`` (a ``first`` launch alone, then
one iteration) and with ``k = 5``.

Bar: the RNG, flags, sample and bounce counts equal the plain version's on
every lane.  The f32 rows are within ``megakernel.KERNEL_TOL`` on at least
``CLOSE_MIN`` of the lanes: on the rest a libm ``sinf`` / ``cosf`` /
``sqrtf`` differs from torch's by an ulp, and the path's later f32 values
with it (the rehearsal measured 98.9-100% close; the card, whose
functions are torch's own, is held to 100% by
tests/test_torch_kernels_cuda.py).
The counting build (``-DHC3_COUNT``) counts the shades the plain version
runs, by material kind, on the zoo box.  No JAX: the plain version is the
reference (tests/test_torch_megakernel.py holds it to the JAX megakernel).
"""
import ctypes
import importlib.util
import os
import sys

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from hydracore3_torch.models import megakernel as MK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOSE_MIN = 0.98


def _rehearsal():
    spec = importlib.util.spec_from_file_location(
        'rehearse_mega_cpu', os.path.join(REPO, 'scripts',
                                          'rehearse_mega_cpu.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RM = _rehearsal()


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    """(pack, xy, su, depth, CPU library) of each scene and its layout
    (``'chip'`` or ``'device'``), at a lane count that is no multiple of a
    pool."""
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import zoo_scenes
    out = {}
    sc, meta = synth.box_scene(32, 24, depth=6, textured=True, device='cpu')
    out['box'] = (sc, meta, 700, 'chip')
    sc, meta = synth.box_scene(32, 24, depth=6, textured=True,
                               wall_subdiv=20, device='cpu')
    out['tess'] = (sc, meta, 700, 'device')
    sc, meta = B.load_scene(zoo_scenes.write_zoo_box(
        str(tmp_path_factory.mktemp('zoo')), 48, 36, 6), device='cpu')
    out['zoo'] = (sc, meta, 1700, 'chip')
    sc, meta = B.load_scene(zoo_scenes.write_zoo_box(
        str(tmp_path_factory.mktemp('zoo_cut')), 32, 24, 6, wall_subdiv=4),
        device='cpu')
    out['zoo cut'] = (sc, meta, 700, 'device')
    sc, meta = B.load_scene(zoo_scenes.write_spectral_box(
        str(tmp_path_factory.mktemp('spectral_cut')), 32, 24, 6,
        wall_subdiv=4), spectral_mode=True, device='cpu')
    out['spectral cut'] = (sc, meta, 700, 'device')
    res = {}
    for name, (sc, meta, m, layout) in out.items():
        pk = MK.pack(sc, meta)
        xy, su = MK.lane_setup(meta, 'cpu')
        lib = RM.build(MK.variant_defines(MK.variant_of(pk)))
        res[name] = (pk, xy[:, :m].contiguous(), su[:, :m].contiguous(),
                     meta.trace_depth, lib, layout)
    return res


def _assert_lanes(kernel, plain, exact_rows):
    close, equal, err = MK.lanes_agree(kernel, plain, exact_rows)
    assert equal == 1.0, (close, equal, err)
    assert close >= CLOSE_MIN, (close, equal, err)


@pytest.mark.parametrize('scene', ['box', 'tess', 'zoo', 'zoo cut',
                                   'spectral cut'])
@pytest.mark.parametrize('mode', ['fixed', 'regen k=1', 'regen k=5'])
def test_pooled_kernel_matches_plain(scenes, scene, mode):
    pk, xy, su, depth, lib, layout = scenes[scene]
    assert xy.shape[1] % 128 and xy.shape[1] % 512
    attrs = MK.kernel_attrs(lib, pk)
    for a in attrs.values():
        assert a['layout'] == layout, attrs
        assert (a['pool'] > 0) == (scene not in ('box', 'tess')), attrs
    if mode == 'fixed':
        _assert_lanes(RM.sample(lib, pk, xy, su, depth),
                      MK.sample_pass_plain(pk, xy, su, depth), 3)
        return
    k = int(mode[-1])
    sf, su_r = RM.regen(lib, pk, xy, None, su, k, depth, True)
    sf_p, su_p = MK.regen_iters_plain(pk, xy, None, su, k, depth, first=True)
    _assert_lanes((sf, su_r), (sf_p, su_p), MK.RU_NROWS)
    _assert_lanes(RM.regen(lib, pk, xy, sf, su_r, k, depth, False),
                  MK.regen_iters_plain(pk, xy, sf_p, su_p, k, depth),
                  MK.RU_NROWS)


def test_counting_build_counts_the_plain_shades(scenes):
    """Every thread ticks the lanes it runs and flushes once: the counting
    build's shades by material kind are the plain version's shaded lanes
    by kind, on the zoo box's fixed chain and a regen launch."""
    pk, xy, su, depth, _, _ = scenes['zoo']
    lib = RM.build(MK.variant_defines(MK.variant_of(pk)) + ('HC3_COUNT',))
    kinds = (MK.MAT_TYPE_GLTF, MK.MAT_TYPE_DIFFUSE, MK.MAT_TYPE_CONDUCTOR,
             MK.MAT_TYPE_DIELECTRIC, MK.MAT_TYPE_GLASS)
    seen = torch.zeros(6, dtype=torch.int64)
    shade0 = MK._shade

    def shade_rec(pk_, st, active, prim, integrator):
        mt = MK.fetch_mat(pk_, st['flags'] & 0x00FFFFFF)['mtype']
        kind = torch.full_like(st['flags'], 5)
        for j, t in enumerate(kinds):
            kind = torch.where(mt == float(t), j, kind)
        seen.add_(torch.bincount(kind[active], minlength=6))
        return shade0(pk_, st, active, prim, integrator)

    sf, su_r = MK.regen_iters_plain(pk, xy, None, su, 3, depth, first=True)
    for run, plain in (
            (lambda: RM.sample(lib, pk, xy, su, depth),
             lambda: MK.sample_pass_plain(pk, xy, su, depth)),
            (lambda: RM.regen(lib, pk, xy, sf, su_r, 3, depth, False),
             lambda: MK.regen_iters_plain(pk, xy, sf, su_r, 3, depth))):
        lib.hc3_mega_counts_reset()
        run()
        c = (ctypes.c_uint64 * RM.N_COUNTS)()
        lib.hc3_mega_counts_read(c)
        seen.zero_()
        MK._shade = shade_rec
        try:
            plain()
        finally:
            MK._shade = shade0
        assert list(c)[2:] == seen.tolist()
        assert c[0] > 0 and c[1] > 0
