"""``count_rays_pass`` and the untextured city against the JAX package.

* ``integrator_pt.count_rays_pass`` (JAX's ray counter, the bench's
  Mrays/s): the live lanes before each bounce's nearest-hit trace and the
  shadow rays NEE traces, for each integrator, equal to JAX's exactly on
  the textured box (a library both packages load; the small class, K5's
  plain version here, JAX's XLA trace) and on the untextured small city
  streamed (K3/K2's plain versions; JAX traces its soup brute force, the
  trick of ``test_torch_slice``);
* the untextured city (``tests/test_big_scene.py``'s ``CITY_KW``, JAX's
  ``build_city`` default: no texture, no environment, a grey ground and
  six wall colours): its meta and every table equal to JAX's (the bars of
  ``test_torch_scene``), and one ``trace_pass`` lane by lane within
  rtol/atol 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu.models import integrator_pt as JIPT
from hydracore3_tpu.ops import rng as JRNG
from hydracore3_tpu.scene import build as JB
from hydracore3_tpu.scene import synth as jsynth
from hydracore3_torch import api
from hydracore3_torch.models import integrator_pt as TIPT
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.scene import build as TB
from hydracore3_torch.scene import synth as tsynth
from test_big_scene import CITY_KW
from test_torch_scene import assert_tables_equal, scene_arrays_from_jax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

INTEGRATORS = ('naivept', 'shadowpt', 'mispt')


@pytest.fixture(scope='module')
def city(tmp_path_factory):
    """(JAX scene, JAX meta, port scene, port meta), both streamed."""
    base = tmp_path_factory.mktemp('ucity')
    js, jm = jsynth.city_scene(**CITY_KW, accel='stream',
                               cache_dir=str(base / 's'))
    ts, tm = tsynth.city_scene(**CITY_KW, accel='stream', device='cpu')
    return js, jm, ts, tm


@pytest.fixture(scope='module')
def box(tmp_path_factory):
    path = api.write_library(tsynth.build_box(32, 24, 3, textured=True),
                             str(tmp_path_factory.mktemp('box')))
    return (*JB.load_scene(path), *TB.load_scene(path, device='cpu'))


def test_untextured_city_meta(city):
    js, jm, ts, tm = city
    assert jm.use_stream and tm.use_stream
    assert not tm.has_env_map and ts.textures.width.numel() == len(
        np.asarray(js.textures.width))
    for f in ('width', 'height', 'trace_depth', 'num_lights', 'num_materials',
              'has_env_map', 'env_enable_sam', 'num_tris', 'exposure_mult'):
        assert getattr(jm, f) == getattr(tm, f), f


@pytest.mark.parametrize('group', ['mat', 'light', 'tri', 'env', 'cam',
                                   'tex', 'st', 'grid', 'misc'])
def test_untextured_city_tables_equal(city, group):
    js, jm, ts, _ = city
    assert_tables_equal(scene_arrays_from_jax(js, jm), ts.to_numpy(), group)


def test_untextured_city_pass_matches_jax(city):
    js, jm, ts, tm = city
    jm = dataclasses.replace(jm, use_stream=False, use_bvh=False)
    n = tm.width * tm.height
    jp = jnp.arange(n, dtype=jnp.int32)

    @jax.jit
    def jpass(r, p):
        acc, _, fl, r2, _ = JIPT.trace_pass(js, jm, r, p,
                                            JIPT.INTEGRATOR_MIS_PT,
                                            JIPT.FB_COLOR, None)
        return acc, fl, r2

    j_acc, j_fl, j_rng = (np.asarray(x) for x in jpass(JRNG.gen_init(jp), jp))
    tp = torch.arange(n)
    t_acc, t_fl, t_rng = (x.numpy() for x in TIPT.trace_pass(
        ts, tm, TRNG.gen_init(tp), tp))
    assert np.isfinite(t_acc).all() and (t_acc[:, :3].sum(1) > 0).mean() > 0.3
    close = np.isclose(t_acc, j_acc, rtol=1e-3, atol=1e-3).all(1)
    assert close.mean() == 1.0, f'accum agrees on {close.mean():.4%}'
    np.testing.assert_array_equal(t_fl.astype(np.uint32), j_fl)
    np.testing.assert_array_equal(t_rng.astype(np.uint32), j_rng)


def jax_counts(js, jm, integrator):
    n = jm.width * jm.height
    jp = jnp.arange(n, dtype=jnp.int32)
    fn = jax.jit(JIPT.count_rays_pass, static_argnums=(1, 4))
    near, shadow = fn(js, jm, JRNG.gen_init(jp), jp,
                      TIPT.INTEGRATOR_BY_NAME[integrator])
    return int(near), int(shadow)


def port_counts(ts, tm, integrator):
    n = tm.width * tm.height
    tp = torch.arange(n)
    return TIPT.count_rays_pass(ts, tm, TRNG.gen_init(tp), tp,
                                TIPT.INTEGRATOR_BY_NAME[integrator])


@pytest.mark.parametrize('integrator', INTEGRATORS)
@pytest.mark.parametrize('scene', ('box', 'city'))
def test_count_rays_pass_equals_jax(request, scene, integrator):
    js, jm, ts, tm = request.getfixturevalue(scene)
    if scene == 'city':
        jm = dataclasses.replace(jm, use_stream=False, use_bvh=False)
    near, shadow = port_counts(ts, tm, integrator)
    assert isinstance(near, int) and isinstance(shadow, int)
    n = tm.width * tm.height
    assert n < near <= n * (tm.trace_depth + 1)
    if integrator == 'naivept':
        assert shadow == 0
    else:
        assert 0 < shadow < near
    assert (near, shadow) == jax_counts(js, jm, integrator)
