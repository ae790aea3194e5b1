"""The QMC sampler: the port's ``ops/qmc.py`` and ``render.render_qmc``
against the JAX package's.

* ``nied_table`` (the Bratley-Fox-Niederreiter direction numbers) equal to
  JAX's; ``rnd_float`` bit for bit in all 11 dimensions on positions
  0..65,535, the last 4,096 below 2^32 and 1,024 on each side of 2^31
  (positions wrap to 32 bits as a JAX uint32; bit 31 selects nothing);
* ``_qmc_dims``, the EnableQMC dimension table, against the JAX test's
  eight rows and the lens stack's two (and JAX's own function);
* one QMC sample of every pixel lane by lane (JAX run op by op,
  ``jax.disable_jit``) on the textured box, the thin-lens feature box, the
  spectral box and the motion box at 32 x 24, depth 2: the same output
  pixel on every lane, the RNG rows equal, the contributions within
  rtol / atol 1e-4 on 99.9% of the lanes; the port's one-sample
  ``render_qmc`` against that sample scattered as JAX scatters it, 99.9%
  of the pixels within 1e-4; the spectral box's 16-channel framebuffer
  likewise;
* the JAX ``render_qmc`` (jitted) of the box at 2 spp in tiles of 256
  lanes against the port's: its tiles' streams and sample indices;
* the lens stack keeps its pseudo lens randoms under QMC, as JAX does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu import render as JR
from hydracore3_tpu.ops import qmc as JQ
from hydracore3_tpu.ops import rng as JRNG
from hydracore3_tpu.models import integrator_pt as JIPT
from hydracore3_tpu.scene import build as JB
from hydracore3_torch import render as TR
from hydracore3_torch.models import integrator_pt as TIPT
from hydracore3_torch.ops import qmc as TQ
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.scene import build as TB
import zoo_scenes
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H, DEPTH = 32, 24, 2
# a contribution's tolerance, relative and absolute: XLA fuses multiplies
# and adds where torch rounds each op
TOL = dict(rtol=1e-4, atol=1e-4)
LANES_MIN = 0.999


def test_nied_table_equals_jax():
    np.testing.assert_array_equal(TQ.nied_table(), JQ.nied_table())
    assert TQ.nied_table().dtype == np.uint32


POSITIONS = np.concatenate([
    np.arange(65536), 2**32 - 4096 + np.arange(4096),
    2**31 - 1024 + np.arange(2048)]).astype(np.uint32)


@pytest.mark.parametrize('dim', range(TQ.QRNG_DIMENSIONS))
def test_rnd_float_bit_exact(dim):
    j = np.asarray(JQ.rnd_float(jnp.asarray(JQ.nied_table()),
                                jnp.asarray(POSITIONS), dim))
    t = TQ.rnd_float(TQ.qmc_table('cpu'),
                     torch.from_numpy(POSITIONS.astype(np.int64)), dim)
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  j.view(np.uint32))
    # a position wraps to 32 bits
    wrapped = TQ.rnd_float(TQ.qmc_table('cpu'), torch.from_numpy(
        POSITIONS.astype(np.int64) + (1 << 32)), dim)
    np.testing.assert_array_equal(wrapped.numpy(), t.numpy())


class _Meta:
    """The four fields ``_qmc_dims`` reads."""
    def __init__(self, dof, spd, motion, optics=False):
        self.cam_lens_radius = 0.1 if dof else 0.0
        self.lens_lines = ((0.0, 1.0, 1.0, 1.0),) if optics else ()
        self.spectral_mode = spd
        self.has_motion = motion


QMC_DIMS = {  # (dof, spd, motion, optics) -> (spd_dim, mat_dim, lgt_dim)
    (True, True, True, False): (4, 0, 0),
    (True, True, False, False): (4, 5, 7),
    (False, True, True, False): (3, 4, 6),
    (True, False, True, False): (0, 5, 7),
    (True, False, False, False): (0, 4, 6),
    (False, True, False, False): (4, 2, 5),
    (False, False, True, False): (0, 2, 5),
    (False, False, False, False): (0, 2, 4),
    (False, False, False, True): (0, 4, 6),
    (False, True, False, True): (4, 5, 7),
}


@pytest.mark.parametrize('case', sorted(QMC_DIMS))
def test_qmc_dims_table(case):
    assert TR._qmc_dims(_Meta(*case)) == QMC_DIMS[case]
    assert JR._qmc_dims(_Meta(*case)) == QMC_DIMS[case]


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    d = tmp_path_factory.mktemp('qmc')
    return dict(
        box=(zoo_scenes.write_rt_box(str(d / 'box'), W, H, DEPTH), False),
        dof=(zoo_scenes.write_feature_box(str(d / 'dof'), W, H, DEPTH,
                                          camera='dof'), False),
        optics=(zoo_scenes.write_feature_box(str(d / 'optics'), W, H, DEPTH,
                                             camera='optics'), False),
        spec=(zoo_scenes.write_spectral_box(str(d / 'spec'), W, H, DEPTH),
              True),
        motion=(zoo_scenes.write_motion_box(str(d / 'motion'), W, H, DEPTH),
                False))


def load_both(libs, which):
    path, spectral = libs[which]
    return (JB.load_scene(path, spectral_mode=spectral),
            TB.load_scene(path, spectral_mode=spectral, device='cpu'))


def ctxs(jm, n, base=0):
    """The JAX and the port QMC contexts of ``n`` lanes from sample
    ``base``."""
    spd, mat, lgt = JR._qmc_dims(jm)
    idx = np.arange(n, dtype=np.int64) + base
    return (dict(table=jnp.asarray(JQ.nied_table()),
                 idx=jnp.asarray(idx.astype(np.uint32)), spd_dim=spd,
                 mat_dim=mat, lgt_dim=lgt),
            dict(table=TQ.qmc_table('cpu'), idx=torch.from_numpy(idx),
                 spd_dim=spd, mat_dim=mat, lgt_dim=lgt))


@pytest.mark.parametrize('which,channels', [('box', 4), ('dof', 4),
                                            ('spec', 4), ('spec', 16),
                                            ('motion', 4)])
def test_qmc_sample_matches_jax(libs, which, channels):
    (js, jm), (ts, tm) = load_both(libs, which)
    assert tm.spectral_mode == (which == 'spec')
    assert (tm.cam_lens_radius > 0) == (which == 'dof')
    assert tm.has_motion == (which == 'motion')
    n = W * H
    jctx, tctx = ctxs(jm, n)
    jp = jnp.zeros(n, jnp.int32)
    with jax.disable_jit():
        jc, jrng, jpx = (np.asarray(x) for x in JR._one_sample(
            js, jm, JRNG.gen_init(jnp.arange(n)), jp,
            JIPT.INTEGRATOR_MIS_PT, JIPT.FB_COLOR, channels, jctx))
    tc, trng, tpx = (x.numpy() for x in TR._one_sample(
        ts, tm, TRNG.gen_init(torch.arange(n)), torch.zeros(n, dtype=int),
        TIPT.INTEGRATOR_MIS_PT, channels, TIPT.FB_COLOR, tctx))
    np.testing.assert_array_equal(tpx, jpx)
    # the QMC pixels spread over the frame (a (0, 2)-sequence's first
    # W * H points land on 648 of the 32 x 24 pixels)
    assert len(np.unique(tpx)) > 0.8 * n
    np.testing.assert_array_equal(trng.astype(np.uint32), jrng)
    assert np.isfinite(tc).all() and tc.max() > 0
    close = np.isclose(tc, jc, **TOL).all(-1)
    assert close.mean() >= LANES_MIN, f'{close.mean():.4%}'
    # the frame: the port's render_qmc of one sample against JAX's sample
    # scattered in lane order
    img = np.zeros((n, channels), np.float32)
    np.add.at(img, jpx, jc)
    ti = TR.render_qmc(ts, tm, spp=1, integrator='mispt', channels=channels)
    assert ti.shape == (H, W, channels)
    within = np.abs(ti.reshape(n, channels) - img).max(-1) <= 1e-4
    assert within.mean() >= LANES_MIN, f'{within.mean():.4%}'


def test_render_qmc_tiles_match_jax(libs):
    """Three tiles of 256 lanes a pass (each its own RNG rows and sample
    indices), two passes: the jitted JAX render against the port's."""
    (js, jm), (ts, tm) = load_both(libs, 'box')
    ji = np.asarray(JR.render_qmc(js, jm, spp=2, integrator='mispt',
                                  tile_size=256))
    ti, timing = TR.render_qmc(ts, tm, spp=2, integrator='mispt',
                               tile_size=256, return_timing=True)
    assert timing['nonfinite'] == 0 and timing['samples'] == 2 * W * H
    within = np.abs(ti - ji).max(-1) <= 1e-4
    assert within.mean() >= LANES_MIN, f'{within.mean():.4%}'
    # the same samples over another tiling: JAX's streams depend on the
    # lanes' global ids and indices only
    one = TR.render_qmc(ts, tm, spp=2, integrator='mispt')
    np.testing.assert_allclose(one, ti, rtol=1e-5, atol=1e-6)


def test_render_qmc_refuses_what_render_refuses(libs):
    (_, _), (ts, tm) = load_both(libs, 'box')
    with pytest.raises(NotImplementedError):
        TR.render_qmc(ts, tm, spp=1, integrator='mlt')
    with pytest.raises(NotImplementedError):
        TR.render_qmc(ts, tm, spp=1, layer='normals')


def _camera(js, jm, ts, tm, ctx_pair, seed_ids):
    """JAX's and the port's ``sample_camera_ray`` under QMC, the RNG rows
    from ``seed_ids``; returns (port pos, port dir, JAX pos, JAX dir)."""
    n = W * H
    pix = np.arange(n)
    xs, ys = pix % W, pix // W
    with jax.disable_jit():
        jout = JIPT.sample_camera_ray(
            js, jm, JRNG.gen_init(jnp.asarray(seed_ids)), jnp.asarray(xs),
            jnp.asarray(ys), ctx_pair[0])
    tout = TIPT.sample_camera_ray(
        ts, tm, TRNG.gen_init(torch.from_numpy(seed_ids)),
        torch.from_numpy(xs), torch.from_numpy(ys), ctx_pair[1])
    np.testing.assert_array_equal(tout[4][0].numpy(), np.asarray(jout[5]))
    np.testing.assert_array_equal(tout[4][1].numpy(), np.asarray(jout[6]))
    return tout[1].numpy(), tout[2].numpy(), np.asarray(jout[1]), \
        np.asarray(jout[2])


@pytest.mark.parametrize('camera', ['dof', 'optics'])
def test_the_lens_stack_keeps_its_pseudo_lens_randoms(libs, camera):
    """Under QMC the JAX package serves lens dimensions 2/3 to the thin
    lens only (``cam_lens_radius > 0``, integrator_pt.py:268-273), while
    ``_qmc_dims`` reserves them for the lens stack too: the stack's rays
    take the pseudo draw's lens randoms.  The port keeps this.  Its camera
    rays equal JAX's; with other pseudo RNG rows and the same sample
    indices, the thin lens's rays stay the same (QMC serves all four of
    their randoms) and the lens stack's change."""
    (js, jm), (ts, tm) = load_both(libs, camera)
    assert (tm.cam_lens_radius > 0.0) == (camera == 'dof')
    assert bool(tm.lens_lines) == (camera == 'optics')
    assert TR._qmc_dims(tm) == (0, 4, 6)
    n = W * H
    pair = ctxs(jm, n, base=12345)
    runs = [_camera(js, jm, ts, tm, pair, np.arange(n) + k * n)
            for k in (0, 1)]
    for tpos, tdir, jpos, jdir in runs:
        np.testing.assert_allclose(tpos, jpos, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tdir, jdir, rtol=1e-5, atol=1e-5)
    same = np.array_equal(runs[0][1], runs[1][1])
    assert same == (camera == 'dof')
