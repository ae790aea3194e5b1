"""The port's city build against the JAX package's, field by field.

The JAX city goes through the in-process API, an XML/VSGF scene library and
``load_scene``; the port builds the same description directly.  Every table
the MIS slice reads must come out the same: integer tables exactly,
geometry, Woop rows and the other float tables to rtol 1e-6, texels after
the sRGB decode to atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from hydracore3_tpu.scene import synth as jsynth
from hydracore3_torch.scene import synth as tsynth

# tests/test_big_scene.py's small city, textured
CITY_KW = dict(n_blocks=4, subdiv=1, seed=3, width=32, height=16, depth=2,
               ground_subdiv=8, textured=True)

_LIGHT_KEYS = ('pos', 'norm', 'intensity', 'matrix', 'sam_row0', 'sam_row1',
               'sam_row0_inv', 'sam_row1_inv', 'size', 'pdf_a', 'mult',
               'geom_type', 'pdf_table_offset',
               'pdf_table_size_x', 'pdf_table_size_y', 'tex_id', 'ies_id')


def scene_arrays_from_jax(scene, meta) -> dict:
    """Flatten the JAX ``Scene`` to the port's table names (numpy)."""
    a = lambda x: np.asarray(x)  # noqa: E731
    out = dict(
        mat_mtype=a(scene.mat_mtype).astype(np.int64),
        mat_cflags=a(scene.mat_cflags).astype(np.int64),
        mat_texid=a(scene.mat_texid).astype(np.int64),
        mat_colors=a(scene.mat_colors), mat_row0=a(scene.mat_row0),
        mat_row1=a(scene.mat_row1), mat_data=a(scene.mat_data),
        tri_v0=a(scene.tri_v0), tri_e1=a(scene.tri_e1),
        tri_e2=a(scene.tri_e2), tri_shade=a(scene.tri_shade),
        remap_inst=a(scene.remap_inst).astype(np.int64),
        arrays1f=a(scene.arrays1f), env_color=a(scene.env_color),
        env_tex_id=a(scene.env_tex_id).astype(np.int64),
        env_sam_row0=a(scene.env_sam_row0),
        env_sam_row1=a(scene.env_sam_row1),
        env_light_id=a(scene.env_light_id).astype(np.int64),
        proj_inv=a(scene.proj_inv), world_view_inv=a(scene.world_view_inv),
        cam_response_rgb=a(scene.cam_response_rgb),
        st_nodes_f=a(scene.st_nodes_f), st_nodes_i=a(scene.st_nodes_i))
    for k in ('inst_id', 'geom_id', 'prim_id'):
        out['tri_' + k] = a(getattr(scene, 'tri_' + k)).astype(np.int64)
    for k in _LIGHT_KEYS:
        v = a(getattr(scene, 'light_' + k))
        out['light_' + k] = v.astype(np.int64) if v.dtype.kind == 'i' else v
    tp = scene.textures
    for k in ('texels', 'offset', 'width', 'height', 'filter', 'addr_u',
              'addr_v'):
        v = a(getattr(tp, k))
        out['tex_' + k] = v.astype(np.int64) if v.dtype.kind == 'i' else v
    # Woop blocks [C, 8, 256]: rows 0..3 = coefficient, lane comp * 64 + k
    st = a(scene.st_tris)
    C = st.shape[0]
    out['st_woop'] = (st[:, 0:4, 0:192].reshape(C, 4, 3, 64)
                      .transpose(0, 3, 2, 1).reshape(C * 64, 12))
    g = scene.st_grid
    for k in ('cell_tab', 'cell_cl', 'cl_aabb', 'outliers'):
        out['grid_' + k] = a(getattr(g, k))
    out['grid_lo'] = np.array(g.lo)
    out['grid_h'] = np.array(g.h)
    out['grid_dims'] = np.array(g.dims)
    return out


def jax_city(tmp_path_factory):
    base = tmp_path_factory.mktemp('jcity')
    return jsynth.city_scene(**CITY_KW, accel='stream',
                             cache_dir=str(base / 's'))


@pytest.fixture(scope='module')
def both(tmp_path_factory):
    jscene, jmeta = jax_city(tmp_path_factory)
    tscene, tmeta = tsynth.city_scene(**CITY_KW)
    return (scene_arrays_from_jax(jscene, jmeta), jmeta,
            tscene.to_numpy(), tmeta)


def test_meta(both):
    _, jmeta, _, tmeta = both
    assert jmeta.use_stream
    for f in ('width', 'height', 'trace_depth', 'num_lights', 'num_materials',
              'has_env_map', 'env_enable_sam', 'num_tris', 'exposure_mult'):
        assert getattr(jmeta, f) == getattr(tmeta, f), f


@pytest.mark.parametrize('group', ['mat', 'light', 'tri', 'env', 'cam',
                                   'tex', 'st', 'grid', 'misc'])
def test_tables_equal(both, group):
    ja, _, ta, _ = both
    prefix = {'cam': ('proj_inv', 'world_view_inv', 'cam_response_rgb'),
              'misc': ('remap_inst', 'arrays1f')}.get(group, (group + '_',))
    keys = [k for k in ja if k.startswith(prefix)]
    assert keys
    for k in keys:
        j, t = ja[k], ta[k]
        if k == 'tex_texels':
            # the JAX pool pads to a 32-row multiple
            assert j.shape[0] >= t.shape[0]
            np.testing.assert_allclose(t, j[:t.shape[0]], rtol=0, atol=1e-6,
                                       err_msg=k)
            continue
        assert j.shape == t.shape, (k, j.shape, t.shape)
        if j.dtype.kind in 'iu':
            np.testing.assert_array_equal(t, j, err_msg=k)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0, err_msg=k)


def test_real_triangle_count(both):
    """290 real soup rows: 288 of buildings and ground, 2 of the light."""
    _, _, ta, _ = both
    real = np.abs(ta['st_woop']).sum(1) > 0
    assert int(real.sum()) == 290
    assert (ta['tri_geom_id'][real] == 1).sum() == 2


def test_padding_rows_are_degenerate(both):
    _, _, ta, _ = both
    pad = (np.abs(ta['tri_e1']).sum(1) == 0) & (np.abs(ta['tri_e2']).sum(1)
                                                 == 0)
    assert pad.any()
    assert np.abs(ta['tri_shade'][pad, :24]).max(initial=0.0) == 0.0
    assert np.abs(ta['st_woop'][pad]).max(initial=0.0) == 0.0


def test_scene_on_device_follows_argument():
    scene, _ = tsynth.city_scene(**dict(CITY_KW, device='cpu'))
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor):
            assert v.device.type == 'cpu', f.name
