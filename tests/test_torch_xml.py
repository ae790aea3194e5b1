"""The port's Hydra XML loading against the JAX package's, table by table.

Libraries written by the JAX package's own writer (``api.py``) into
``tmp_path`` (the small city of ``CITY_KW``, streamed; the textured box,
small; a small instanced city, two-level; tests/test_api.py's remap scene
without its spot light) and small XML texts written here for the nodes the
writer cannot make (a GLTF node with metal-roughness textures, old-Hydra
fresnel, transparency -> glass, emission with the light-material sync, an
unknown type, disk and directional lights, a constant, an 8-bit and a
float sky, a camera-back texture, cameras by ``cam_id``, a view matrix, a
``look_at_override``, the render settings, a custom-geometry node, remap
lists).  Each is loaded by the JAX package's ``load_scene`` and the port's
``load_scene(..., device='cpu')``: integer tables equal, float tables to
rtol 1e-6, texels to atol 1e-6 (``test_torch_scene.assert_tables_equal``).

Also: the port's writer gives the JAX writer's files byte for byte;
``build_scene(desc)`` equals ``load_scene`` of the same description as
written; every unported node raises ``NotImplementedError`` naming its
ROADMAP.md item; a comment in a library changes nothing; 4-spp renders
of the loaded city and box at >= 45 dB against the JAX package's renders
of the same libraries; the render paths refuse what they cannot shade.
"""
import dataclasses
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu import api as JAPI
from hydracore3_tpu import render as JRENDER
from hydracore3_tpu.models import integrator_pt as JIPT
from hydracore3_tpu.ops import texture as JTEX
from hydracore3_tpu.scene import build as JB
from hydracore3_tpu.scene import synth as jsynth
from hydracore3_tpu.scene import vsgf as JVSGF
from hydracore3_torch import api as TAPI
from hydracore3_torch import render as TRENDER
from hydracore3_torch.models import integrator_pt as TIPT
from hydracore3_torch.models import megakernel as TMK
from hydracore3_torch.ops import texture as TTEX
from hydracore3_torch.scene import build as TB
from hydracore3_torch.scene import synth as tsynth
from hydracore3_torch.scene import vsgf as TVSGF
from test_torch_scene import CITY_KW, assert_tables_equal, \
    scene_arrays_from_jax
import jax_box

CITY = {k: v for k, v in CITY_KW.items() if k != 'accel'}
BOX = dict(width=32, height=24, depth=3, textured=True)
ICITY = dict(n_blocks=3, subdiv=1, seed=5, width=48, height=32, depth=3,
             ground_subdiv=6)
TT_TABLES = ('tlas_f', 'tlas_i', 'nodes_f', 'nodes_i', 'inst_f', 'inst_i',
             'inst_nm', 'shade', 'geom', 'prim')
ITEM4, ITEM5 = 'ROADMAP.md queue 1, item 4', 'ROADMAP.md queue 1, item 5'


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    peak = max(float(np.max(b)), 1e-9)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def jax_arrays(jscene, jmeta) -> dict:
    """``scene_arrays_from_jax`` and the tables it leaves out: the remap
    lists, the camera-back slot and the two-level tables."""
    out = scene_arrays_from_jax(jscene, jmeta)
    out['all_remap_lists'] = np.asarray(jscene.all_remap_lists, np.int64)
    out['all_remap_lists_size'] = np.asarray(jscene.all_remap_lists_size,
                                             np.int64)
    out['env_cam_back_id'] = np.asarray(jscene.env_cam_back_id, np.int64)
    if jscene.tt_tris is not None:
        C = jscene.tt_tris.shape[0]
        out['tt_woop'] = (np.asarray(jscene.tt_tris)[:, 0:4, 0:192]
                          .reshape(C, 4, 3, 64).transpose(0, 3, 2, 1)
                          .reshape(C * 64, 12))
        for k in TT_TABLES:
            v = np.asarray(getattr(jscene, 'tt_' + k))
            out['tt_' + k] = v.astype(np.int64) if k in ('geom', 'prim') \
                else v
    return out


def port_arrays(tscene) -> dict:
    out = tscene.to_numpy()
    out['all_remap_lists_size'] = np.asarray(tscene.all_remap_lists_size,
                                             np.int64)
    return out


META_FIELDS = ('width', 'height', 'trace_depth', 'spp', 'num_lights',
               'num_materials', 'has_env_map', 'env_enable_sam', 'num_tris',
               'exposure_mult', 'use_stream', 'use_stream_tlas',
               'use_pallas', 'mat_types_present', 'tex0_all_const',
               'has_cam_back', 'has_four_textures')


def assert_meta_equal(jmeta, tmeta):
    for f in META_FIELDS:
        assert getattr(jmeta, f) == getattr(tmeta, f), f


def check_group(ja, jmeta, ta, tmeta, group):
    if group == 'meta':
        assert_meta_equal(jmeta, tmeta)
    else:
        assert_tables_equal(ja, ta, group)


# ---- libraries the JAX writer writes -----------------------------------------

def remap_ctx(HR):
    """tests/test_api.py's remap scene without its spot light, through
    either package's API."""
    ctx = HR.hr2_create_scene()
    red = ctx.material_create(name='red', diffuse_color=(0.6, 0.1, 0.1))
    blue = ctx.material_create(name='blue', diffuse_color=(0.1, 0.1, 0.6))
    pos = np.array([(-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2)],
                   np.float32)
    mid = ctx.mesh_from_data(pos, np.array([0, 1, 2, 0, 2, 3], np.uint32),
                             mat_indices=[red, red])
    rl = ctx.remap_list_create([(red, blue)])
    ctx.instance_add(mid)
    m2 = np.eye(4, dtype=np.float32)
    m2[0, 3] = 5.0
    ctx.instance_add(mid, m2, rmap_id=rl)
    pm = np.eye(4, dtype=np.float32)
    pm[1, 3] = 3.0
    ctx.light_point(color=(1, 1, 1), multiplier=6.0, matrix=pm)
    ctx.light_sphere(color=(1, 0.8, 0.6), multiplier=3.0, radius=0.4,
                     matrix=pm)
    ctx.camera_set(pos=(0.0, 4.0, 8.0), look_at=(0.0, 0.0, 0.0))
    ctx.settings_set(width=48, height=32, depth=2, spp=4)
    return ctx


# name -> (JAX handle, port description, accel)
def _jax_handle(name):
    if name == 'city':
        return jsynth.build_city(**CITY)
    if name == 'box':
        return jax_box.box_ctx(**BOX)
    if name == 'icity':
        return jsynth.build_instanced_city(**ICITY)
    return remap_ctx(JAPI)


def _port_desc(name):
    if name == 'city':
        return tsynth.build_city(**CITY)
    if name == 'box':
        return tsynth.build_box(**BOX)
    if name == 'icity':
        return tsynth.build_instanced_city(**ICITY)
    return remap_ctx(TAPI).desc


ACCEL = dict(city='stream', box='auto', icity='stream_tlas', remap='auto')


@pytest.fixture(scope='module')
def libraries(tmp_path_factory):
    """Each library written by the JAX writer and loaded by both."""
    out = {}
    for name in ('city', 'box', 'icity', 'remap'):
        d = str(tmp_path_factory.mktemp(name))
        hr = _jax_handle(name)
        path = hr._write_library(d)
        js, jm = JB.load_scene(path, d, accel=ACCEL[name], width=hr.width,
                               height=hr.height)
        ts, tm = TB.load_scene(path, accel=ACCEL[name], device='cpu')
        out[name] = (d, path, jax_arrays(js, jm), jm, port_arrays(ts), tm,
                     (js, ts))
    return out


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, 'rb') as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


@pytest.mark.parametrize('name', ['city', 'box', 'icity', 'remap'])
def test_writer_is_byte_equal_to_jax(libraries, name, tmp_path):
    d = libraries[name][0]
    TAPI.write_library(_port_desc(name), str(tmp_path))
    jf, tf = _files(d), _files(str(tmp_path))
    assert sorted(jf) == sorted(tf)
    assert len(jf) >= 2 and any(k.endswith(".vsgf") for k in jf)
    for k in jf:
        assert jf[k] == tf[k], k


GROUPS = {
    'city': ('meta', 'mat', 'light', 'tri', 'env', 'cam', 'tex', 'st',
             'grid', 'misc', 'all'),
    'box': ('meta', 'mat', 'light', 'tri', 'env', 'cam', 'tex', 'misc',
            'all'),
    'icity': ('meta', 'mat', 'light', 'env', 'cam', 'tex', 'misc', 'all',
              'tt'),
    'remap': ('meta', 'mat', 'light', 'tri', 'env', 'cam', 'tex', 'misc',
              'all'),
}


@pytest.mark.parametrize('name,group', [(n, g) for n, gs in GROUPS.items()
                                        for g in gs])
def test_loaded_tables_equal_jax(libraries, name, group):
    _, _, ja, jm, ta, tm, _ = libraries[name]
    assert tm.use_stream == (name == 'city')
    assert tm.use_stream_tlas == (name == 'icity')
    check_group(ja, jm, ta, tm, group)


def test_remap_list_reaches_the_tables(libraries):
    _, _, ja, _, ta, _, _ = libraries['remap']
    # instance 1 carries list 0 (red -> blue), applied in the soup
    assert ta['remap_inst'][1, 0] == 0 and ta['all_remap_lists_size'] == 2
    np.testing.assert_array_equal(ta['all_remap_lists'], [0, 1, 0, 2])
    mats = ta['tri_shade'][:, 24][ta['tri_inst_id'] == 1]
    assert set(mats[:2].tolist()) == {1.0}


@pytest.mark.parametrize('name', ['city', 'box'])
def test_build_scene_equals_load_of_the_written_library(libraries, name):
    """The description built directly and the same description written
    by the port's writer and loaded: every table the same."""
    desc = _port_desc(name)
    bs, bm = TB.build_scene(desc, device='cpu', accel=ACCEL[name])
    d, path = libraries[name][:2]
    ls, lm = TB.load_scene(path, d, accel=ACCEL[name], device='cpu')
    assert bm == lm
    ba, la = port_arrays(bs), port_arrays(ls)
    assert sorted(ba) == sorted(la)
    for k in ba:
        np.testing.assert_array_equal(ba[k], la[k], err_msg=k)


def test_commit_loads_what_it_wrote(tmp_path):
    ctx = remap_ctx(TAPI)
    scene, meta = ctx.commit(str(tmp_path / 'lib'), device='cpu')
    assert meta.num_tris == 4 and meta.num_lights == 2
    assert os.path.exists(tmp_path / 'lib' / 'statex_00001.xml')
    img = ctx.commit_and_render(spp=1, out_dir=str(tmp_path / 'lib2'),
                                device='cpu')
    assert img.shape == (32, 48, 4) and np.isfinite(img).all()


@pytest.mark.parametrize('entry', ['load_scene', 'commit'])
def test_load_goes_to_the_card_unless_asked(libraries, entry, monkeypatch,
                                            tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == 'load_scene':
            TB.load_scene(libraries['box'][1])
        else:
            remap_ctx(TAPI).commit(str(tmp_path))


# ---- hand-written libraries ---------------------------------------------------

MATERIALS = {
    'gltf': '''<material id="{i}" name="gltf" type="gltf">
    <color val="0.8 0.7 0.6"><texture id="0" type="texref"
      addressing_mode_u="clamp" addressing_mode_v="mirror" filter="point"
      matrix="2 0 0 0.5 0 2 0 0" /></color>
    <roughness val="0.4"><texture id="2" type="texref" input_gamma="1" />
    </roughness>
    <metalness val="0.3"><texture id="2" type="texref" /></metalness>
    <coat val="0.5" /><fresnel_ior val="1.7" />
  </material>''',
    'fresnel': '''<material id="{i}" name="fresnel" type="hydra_material">
    <diffuse brdf_type="lambert"><color val="0.5 0.4 0.3">
      <texture id="0" type="texref" /></color><roughness val="0.2" />
    </diffuse>
    <reflectivity brdf_type="phong"><color val="0.3 0.3 0.3" />
      <glossiness val="0.7" /><fresnel val="1" /><fresnel_ior val="1.6" />
    </reflectivity>
  </material>''',
    'glass': '''<material id="{i}" name="glass" type="hydra_material">
    <reflectivity><color val="0.9 0.9 0.9" /><glossiness val="0.9" />
    </reflectivity>
    <transparency><color val="0.8 0.9 1.0" /><glossiness val="0.95" />
      <ior val="1.45" /></transparency>
  </material>''',
    'lamp': '''<material id="{i}" name="lamp" type="hydra_material"
    light_id="0"><emission><color val="2 2 2"><multiplier val="3" />
    </color></emission></material>''',
    'odd': '<material id="{i}" name="odd" type="some_unknown_type" />',
    'metal': '''<material id="{i}" name="metal" type="hydra_material">
    <reflectivity><color val="0.6 0.6 0.6" /><glossiness val="0.5" />
    </reflectivity></material>''',
    'lambert_metal': '''<material id="{i}" name="lm" type="hydra_material">
    <diffuse><color val="0.2 0.5 0.2" /></diffuse>
    <reflectivity><color val="0.4" /></reflectivity></material>''',
    'lambert': '''<material id="{i}" name="lambert" type="hydra_material">
    <diffuse><color val="0.7 0.7 0.7" /></diffuse></material>''',
}

LIGHTS = {
    'rect': '''type="area" shape="rect" distribution="diffuse">
    <size half_length="0.5" half_width="0.7" />
    <intensity><color val="1 1 1" /><multiplier val="4" /></intensity>''',
    'disk': '''type="area" shape="disk" distribution="diffuse">
    <size radius="0.3" />
    <intensity><color val="1 0.9 0.8" /><multiplier val="2" /></intensity>''',
    'directional': '''type="directional" shape="point">
    <intensity><color val="1 1 0.9" /><multiplier val="1.5" /></intensity>''',
    'point': '''type="point" shape="point" distribution="uniform">
    <intensity><color val="0.5 0.5 1" /><multiplier val="2" /></intensity>''',
    'sphere': '''type="area" shape="sphere" distribution="uniform">
    <size radius="0.2" />
    <intensity><color val="1 0.8 0.6" /><multiplier val="3" /></intensity>''',
}

SKIES = {
    'const': '<color val="0.2 0.3 0.4" />',
    'ldr': '<color val="1 1 1"><texture id="0" type="texref" /></color>',
    'hdr': '<color val="1 1 1"><texture id="1" type="texref" /></color>',
}

CAMERAS = '''<cam_lib>
  <camera id="0" name="c0" type="uvn">
    <fov>50</fov><nearClipPlane>0.05</nearClipPlane>
    <farClipPlane>200</farClipPlane><up>0 1 0</up>
    <position>0 3 8</position><look_at>0 0 0</look_at>
  </camera>
  <camera id="1" name="c1" type="uvn">
    <fov val="35" /><up val="0 1 0" /><position val="4 2 5" />
    <look_at val="0 0.5 0" /><exposure_mult val="1.5" />
    <sensor><response type="rgb"><color val="0.9 1.1 1.2" /></response>
    </sensor>
  </camera>
  <camera id="2" name="c2" type="uvn">
    <fov>40</fov><position>1 1 1</position><look_at>0 0 0</look_at>
    <matrix val="1 0 0 0 0 0.8 0.6 0 0 -0.6 0.8 0 0.5 2 6 1" />
  </camera>
</cam_lib>'''

EYE = '1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1'


def _grid_mesh(n=3):
    """An n x n grid of quads in the y = 0 plane, its materials cycling
    through the eight of MATERIALS."""
    a = np.linspace(-2, 2, n + 1, dtype=np.float32)
    x, z = np.meshgrid(a, a, indexing='ij')
    pos = np.stack([x.ravel(), np.zeros(x.size, np.float32), z.ravel()], 1)
    idx = []
    for i in range(n):
        for j in range(n):
            c = i * (n + 1) + j
            idx += [c, c + 1, c + n + 2, c, c + n + 2, c + n + 1]
    T = len(idx) // 3
    texc = pos[:, [0, 2]] * 0.25 + 0.5
    return JAPI.MeshData(pos=pos, norm=None, texc=texc,
                         indices=np.array(idx, np.uint32),
                         mat_indices=np.arange(T, dtype=np.uint32) % 8)


def _write_textures(d):
    rng = np.random.default_rng(11)
    os.makedirs(os.path.join(d, 'data'), exist_ok=True)
    texs = [rng.integers(0, 256, (8, 8, 4), dtype=np.uint8),
            (rng.random((4, 8, 4)) * 3).astype('<f4'),
            rng.integers(0, 256, (4, 4, 4), dtype=np.uint8)]
    lines = []
    for i, t in enumerate(texs):
        ext = 'image4ub' if t.dtype == np.uint8 else 'image4f'
        with open(os.path.join(d, f'data/t{i}.{ext}'), 'wb') as f:
            f.write(np.array([t.shape[1], t.shape[0]], '<i4').tobytes())
            f.write(t.tobytes())
        lines.append(f'  <texture id="{i}" name="t{i}" loc="data/t{i}.{ext}"'
                     f' offset="8" bytesize="{t.nbytes}" width="{t.shape[1]}"'
                     f' height="{t.shape[0]}" channels="4" dl="0" />')
    return '<textures_lib>\n' + '\n'.join(lines) + '\n</textures_lib>'


def kitchen_xml(sky=None, back=False, materials=tuple(MATERIALS),
                lights=tuple(LIGHTS), extra_light='', material_extra='',
                camera_extra='', instance_extra='', spectra='',
                comments=()):
    """A library of every node the port loads (materials, lights, three
    cameras, a VSGF grid placed twice, the second through a remap list,
    and a custom-geometry box); the arguments vary it.  ``comments``
    names the libraries that open with an XML comment."""
    c = {k: '<!-- a comment -->' if k in comments else ''
         for k in ('materials', 'geometry', 'lights')}
    mats = '\n  '.join(MATERIALS[m].format(i=i)
                       for i, m in enumerate(materials))
    lt = [f'  <light id="{i}" name="{k}" ' + LIGHTS[k] + '\n  </light>'
          for i, k in enumerate(lights)]
    if sky is not None:
        b = '<back><texture id="0" type="texref" /></back>' if back else ''
        lt.append(f'  <light id="{len(lt)}" name="env" type="sky" '
                  'shape="point" distribution="uniform"><intensity>'
                  f'{SKIES[sky]}<multiplier val="1.5" /></intensity>{b}'
                  '</light>')
    if extra_light:
        lt.append(f'  <light id="{len(lt)}" name="x" {extra_light}</light>')
    linst = '\n'.join(
        f'    <instance_light id="{i}" light_id="{i}" matrix="1 0 0 '
        f'{0.3 * i} 0 1 0 2 0 0 1 0.5 0 0 0 1" lgroup_id="-1" />'
        for i in range(len(lt)))
    return f'''<?xml version="1.0"?>
{{TEXTURES}}
{spectra}
<materials_lib>{c['materials']}
  {mats.replace('</material>', material_extra + '</material>', 1)}
</materials_lib>
<geometry_lib>{c['geometry']}
  <mesh id="0" name="grid" type="vsgf" loc="data/grid.vsgf" />
  <custom_geom id="1" name="blob" type="custom" mat_id="4"
    bbox_min="-0.5 0 -0.5" bbox_max="0.5 1 0.5" />
</geometry_lib>
<lights_lib>{c['lights']}
{chr(10).join(lt)}
</lights_lib>
{CAMERAS.replace('</camera>', camera_extra + '</camera>', 1)}
<render_lib>
  <render_settings type="HydraModern" id="0">
    <width>24</width><height>16</height><trace_depth>3</trace_depth>
    <maxRaysPerPixel>4</maxRaysPerPixel>
  </render_settings>
</render_lib>
<scenes>
  <scene id="0" name="s">
    <remap_lists><remap_list val="1 5 7 6" /></remap_lists>
    <instance id="0" mesh_id="0" rmap_id="-1" matrix="{EYE}" />
    <instance id="1" mesh_id="0" rmap_id="0"
      matrix="1 0 0 5 0 1 0 0 0 0 1 0 0 0 0 1">{instance_extra}</instance>
    <instance id="2" mesh_id="1" rmap_id="-1"
      matrix="0.5 0 0 0 0 2 0 0 0 0 1 1 0 0 0 1" />
{linst}
  </scene>
</scenes>'''


def write_kitchen(d, text):
    d = str(d)
    tex = _write_textures(d)
    JAPI.write_vsgf(os.path.join(d, 'data/grid.vsgf'), _grid_mesh())
    path = os.path.join(d, 'statex_00001.xml')
    with open(path, 'w') as f:
        f.write(text.replace('{TEXTURES}', tex))
    return path


LOOK = (1, 0, 0, 0.5, 0, 1, 0, -1, 0, 0, 1, -6, 0, 0, 0, 1)

# variant -> (kitchen_xml arguments, load_scene arguments)
VARIANTS = {
    'base': ({}, {}),
    'sky_const': (dict(sky='const'), {}),
    'sky_ldr': (dict(sky='ldr'), {}),
    'sky_hdr': (dict(sky='hdr'), {}),
    'sky_back': (dict(sky='hdr', back=True), {}),
    'cam_id_1': ({}, dict(cam_id=1)),
    'cam_matrix': ({}, dict(cam_id=2)),
    'look_at': ({}, dict(look_at_override=LOOK)),
    'size': ({}, dict(width=20, height=10)),
}
KITCHEN_GROUPS = ('meta', 'mat', 'light', 'tri', 'env', 'cam', 'tex',
                  'misc', 'all')


@pytest.fixture(scope='module')
def kitchens(tmp_path_factory):
    out = {}
    for name, (xkw, lkw) in VARIANTS.items():
        d = tmp_path_factory.mktemp(name)
        path = write_kitchen(d, kitchen_xml(**xkw))
        js, jm = JB.load_scene(path, **lkw)
        ts, tm = TB.load_scene(path, device='cpu', **lkw)
        out[name] = (jax_arrays(js, jm), jm, port_arrays(ts), tm)
    return out


@pytest.mark.parametrize('variant,group', [(v, g) for v in VARIANTS
                                           for g in KITCHEN_GROUPS])
def test_hand_written_tables_equal_jax(kitchens, variant, group):
    ja, jm, ta, tm = kitchens[variant]
    check_group(ja, jm, ta, tm, group)


def test_hand_written_library_loads_every_branch(kitchens):
    """What the base library exercises, so the equality above is not
    vacuous."""
    _, _, ta, tm = kitchens['base']
    mt = ta['mat_mtype'].tolist()
    assert mt[2] == TB.MAT_TYPE_GLASS and mt[3] == TB.MAT_TYPE_LIGHT_SOURCE
    assert ta['mat_cflags'][0] & TB.FLAG_FOUR_TEXTURES
    assert ta['mat_cflags'][1] == (TB.GLTF_COMPONENT_LAMBERT
                                   | TB.GLTF_COMPONENT_COAT
                                   | TB.GLTF_COMPONENT_ORENNAYAR)
    # the gltf texture slots: base (clamp/mirror/point), roughness without
    # gamma, metalness with gamma: three slots past the white one
    assert ta['mat_texid'][0].tolist() == [1, -1, 2, 3]
    assert ta['tex_addr_u'][1] == TTEX.ADDR_CLAMP
    assert ta['tex_addr_v'][1] == TTEX.ADDR_MIRROR
    assert ta['tex_filter'][1] == TTEX.FILTER_NEAREST
    # the light-material sync: the rect light's colour and multiplier
    np.testing.assert_array_equal(ta['mat_colors'][3, 0], [1, 1, 1, 0])
    assert ta['mat_data'][3, TB.EMISSION_MULT] == 4.0
    np.testing.assert_array_equal(ta['mat_colors'][4, 0], [.5, .5, .5, 0])
    assert tm.light_geom_types == (TB.LIGHT_GEOM_RECT, TB.LIGHT_GEOM_DISC,
                                   TB.LIGHT_GEOM_DIRECT, TB.LIGHT_GEOM_POINT,
                                   TB.LIGHT_GEOM_SPHERE)
    assert tm.num_tris == 2 * 18 + 12       # the grid twice, the box
    assert ta['all_remap_lists'].tolist() == [1, 5, 7, 6, 0, 4]


def test_sky_variants(kitchens):
    """A constant sky is no light row and no env map; an 8-bit sky is an
    env map with no importance table; a float one is sampled."""
    for name, has_map, sam, extra in (('sky_const', False, False, 0),
                                      ('sky_ldr', True, False, 0),
                                      ('sky_hdr', True, True, 1)):
        _, _, ta, tm = kitchens[name]
        assert (tm.has_env_map, tm.env_enable_sam) == (has_map, sam), name
        assert tm.num_lights == 5 + extra, name
        np.testing.assert_allclose(ta['env_color'], [0.2, 0.3, 0.4, 0.0]
                                   if name == 'sky_const' else [1, 1, 1, 0])
    assert kitchens['sky_back'][3].has_cam_back
    assert kitchens['sky_back'][2]['env_cam_back_id'] >= 1


@pytest.mark.parametrize('lib', ['materials', 'geometry', 'lights'])
def test_a_comment_changes_nothing(lib, tmp_path):
    """ElementTree drops comments, as the reference's pugixml does: the
    port's tables do not move.  The JAX package's lxml yields a comment as
    a child: in materials_lib it loads a phantom gray-lambert material, in
    geometry_lib the load fails on the comment's id, in lights_lib every
    light instance reads the light before its own."""
    plain = write_kitchen(tmp_path / 'a', kitchen_xml())
    noted = write_kitchen(tmp_path / 'b', kitchen_xml(comments=(lib,)))
    a, am = TB.load_scene(plain, device='cpu')
    b, bm = TB.load_scene(noted, device='cpu')
    assert am == bm
    pa, pb = port_arrays(a), port_arrays(b)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    js, jm = JB.load_scene(plain)
    assert jm.num_materials == am.num_materials
    if lib == 'geometry':
        with pytest.raises(TypeError):
            JB.load_scene(noted)
        return
    jt, jn = JB.load_scene(noted)
    if lib == 'materials':
        assert jn.num_materials == jm.num_materials + 1
    else:
        assert not np.array_equal(np.asarray(jt.light_geom_type),
                                  np.asarray(js.light_geom_type))


REFUSALS = {
    'spectral_mode': ({}, dict(spectral_mode=True), ITEM5),
    'spot': (dict(extra_light='type="point" shape="point" '
                  'distribution="spot"><falloff_angle val="60" />'), {},
             ITEM5),
    'ies': (dict(extra_light='type="point" shape="point" distribution="ies">'
                 '<ies loc="a.ies" />'), {}, ITEM5),
    'normal_bump': (dict(material_extra='<displacement type="normal_bump">'
                         '<normal_map><texture id="0" type="texref" />'
                         '</normal_map></displacement>'), {}, ITEM5),
    'motion': (dict(instance_extra=f'<motion matrix="{EYE}" />'), {}, ITEM5),
    'dof': (dict(camera_extra='<enable_dof val="1" />'
                 '<dof_lens_radius val="0.1" />'), {}, ITEM5),
    'optics': (dict(camera_extra='<optical_system scale="1" />'), {}, ITEM5),
    'spectral_response': (dict(camera_extra='<sensor><response type="xyz">'
                               '<spectrum id="0" /></response></sensor>'),
                          {}, ITEM5),
    'spectral_texture': (dict(spectra='<spectra_lib><spectrum id="0" '
                              'lambda_ref_ids="400 0 700 2" /></spectra_lib>'),
                         {}, ITEM5),
}
for _t in TB._UNPORTED_MATERIALS:
    REFUSALS[_t] = (dict(material_extra=f'</material><material id="8" '
                         f'name="x" type="{_t}">'), {}, ITEM4)


@pytest.mark.parametrize('case', sorted(REFUSALS))
def test_unported_nodes_raise(case, tmp_path):
    xkw, lkw, item = REFUSALS[case]
    path = write_kitchen(tmp_path, kitchen_xml(**xkw))
    with pytest.raises(NotImplementedError, match=item):
        TB.load_scene(path, device='cpu', **lkw)


def test_spot_light_of_a_description_raises():
    sd = tsynth.build_box(16, 8, 2)
    sd.simple_lights.append(TB.SimpleLightDesc(kind='spot'))
    with pytest.raises(NotImplementedError, match=ITEM5):
        TB.build_scene(sd, device='cpu')


def test_other_image_formats_name_the_file_without_imageio(tmp_path,
                                                           monkeypatch):
    text = kitchen_xml().replace('{TEXTURES}', '''<textures_lib>
  <texture id="0" name="p" loc="data/wall.png" width="8" height="8"
    bytesize="256" /></textures_lib>''')
    path = write_kitchen(tmp_path, text)
    monkeypatch.setitem(sys.modules, 'imageio', None)
    monkeypatch.setitem(sys.modules, 'imageio.v3', None)
    with pytest.raises(ImportError, match='wall.png'):
        TB.load_scene(path, device='cpu')


# ---- the render paths refuse what they cannot shade ---------------------------

REFUSED_ON_BOTH = {
    'glass': (dict(materials=('lambert', 'lamp', 'glass')), 'material types'),
    'four_textures': (dict(materials=('lambert', 'lamp', 'gltf')),
                      'slot-2/3'),
    'cam_back': (dict(materials=('lambert', 'lamp'), sky='hdr', back=True),
                 'camera-back'),
}


@pytest.mark.parametrize('case', sorted(REFUSED_ON_BOTH))
def test_render_paths_refuse(case, tmp_path):
    xkw, msg = REFUSED_ON_BOTH[case]
    path = write_kitchen(tmp_path, kitchen_xml(
        lights=('rect', 'point'), **xkw))
    scene, meta = TB.load_scene(path, device='cpu', accel='stream')
    with pytest.raises(NotImplementedError, match=msg):
        TIPT.check_scene(meta)
    small, small_meta = TB.load_scene(path, device='cpu')
    reason = TMK.why_unsupported(small, small_meta)
    assert reason is not None
    if case != 'cam_back':      # K1 refuses any env map first
        assert msg in reason


def test_loaded_lambert_scene_passes_the_checks(tmp_path):
    path = write_kitchen(tmp_path, kitchen_xml(
        materials=('lambert', 'lamp', 'fresnel', 'metal', 'lambert_metal',
                   'odd'), lights=('rect', 'point', 'sphere'), sky='const'))
    _, meta = TB.load_scene(path, device='cpu', accel='stream')
    TIPT.check_scene(meta)
    small, small_meta = TB.load_scene(path, device='cpu')
    assert TMK.why_unsupported(small, small_meta) is None


# ---- renders against the JAX package's --------------------------------------

def _city_with_sky(kind):
    hr = jsynth.build_city(**CITY)
    if kind == 'const':
        hr.light_env(color=(0.3, 0.4, 0.6), multiplier=2.0)
    elif kind == 'ldr':
        sky = (np.random.default_rng(4).random((8, 16, 3)) * 255).astype(
            np.uint8)
        hr.light_env(color=(1.0, 1.0, 1.0), multiplier=2.0,
                     tex_id=hr.texture_create(sky, 'ldr_sky'))
    return hr


@pytest.mark.parametrize('sky', ['float', 'const', 'ldr'])
def test_loaded_city_renders_as_jax(sky, tmp_path):
    """The loaded small city, streamed, 4 spp against the JAX package's
    render of the same library (its XLA brute trace, as
    test_torch_slice.py): the bench's float sky, a constant one and an
    8-bit one without an importance table."""
    hr = _city_with_sky(sky)
    path = hr._write_library(str(tmp_path))
    js, jm = JB.load_scene(path, accel='stream')
    ts, tm = TB.load_scene(path, accel='stream', device='cpu')
    assert tm.has_env_map == (sky != 'const')
    jm = dataclasses.replace(jm, use_stream=False, use_bvh=False)
    j_img = np.asarray(JRENDER.render(js, jm, spp=4,
                                      integrator='mispt'))[..., :3]
    t_img, timing = TRENDER.render(ts, tm, spp=4, return_timing=True)
    assert timing['nonfinite'] == 0
    p = psnr(t_img[..., :3], j_img)
    assert p >= 45.0, f'PSNR {p:.2f} dB'


@pytest.mark.parametrize('sky', ['none', 'const'])
def test_loaded_box_renders_as_jax(sky, tmp_path):
    """The loaded textured box through K1's plain version against the JAX
    package's render of the same library, 4 spp; with a constant sky K1
    adds the sky's colour on a miss as the JAX megakernel does."""
    hr = jax_box.box_ctx(**BOX)
    if sky == 'const':
        hr.light_env(color=(0.3, 0.4, 0.6), multiplier=1.0)
    path = hr._write_library(str(tmp_path))
    js, jm = JB.load_scene(path)
    ts, tm = TB.load_scene(path, device='cpu')
    assert TMK.supported(ts, tm)
    j_img = np.asarray(JRENDER.render(js, jm, spp=4,
                                      integrator='mispt'))[..., :3]
    t_img, timing = TRENDER.render(ts, tm, spp=4, return_timing=True)
    assert timing['nonfinite'] == 0
    p = psnr(t_img[..., :3], j_img)
    assert p >= 45.0, f'PSNR {p:.2f} dB'


# ---- the remap lookup -------------------------------------------------------

def _remap_scene(lists, inst_list):
    table, size = TB._remap_table(lists)
    return types.SimpleNamespace(
        all_remap_lists=torch.tensor(table),
        all_remap_lists_size=size,
        remap_inst=torch.tensor([[inst_list, -1]]))


def test_remap_lookup_searches_the_lists_pairs():
    """RemapMaterialId bisects a list's pairs.  The JAX package bisects
    over as many entries as the list has numbers, so material 3 under
    list 0 (0 -> 5) meets list 1's pair (3 -> 7) and is remapped."""
    lists = [[0, 5], [3, 7]]
    sc = _remap_scene(lists, 0)
    mats = torch.tensor([0, 3, 4])
    out = TIPT._remap_material_id(sc, mats, torch.zeros(3, dtype=torch.long))
    assert out.tolist() == [5, 3, 4]
    jsc = types.SimpleNamespace(
        all_remap_lists=jnp.asarray(sc.all_remap_lists.numpy()),
        all_remap_lists_size=sc.all_remap_lists_size,
        remap_inst=jnp.asarray(sc.remap_inst.numpy()))
    j = JIPT._remap_material_id(jsc, jnp.asarray([0, 3, 4]),
                                jnp.zeros(3, jnp.int32))
    assert np.asarray(j).tolist() == [5, 7, 4]


def test_remap_lists_are_sorted_for_the_lookup():
    sc = _remap_scene([[9, 1, 2, 6, 5, 0]], 0)
    assert sc.all_remap_lists.tolist()[:6] == [2, 6, 5, 0, 9, 1]
    mats = torch.tensor([9, 2, 5, 3])
    out = TIPT._remap_material_id(sc, mats, torch.zeros(4, dtype=torch.long))
    assert out.tolist() == [1, 6, 0, 3]


# ---- vsgf and texture files --------------------------------------------------

@pytest.mark.parametrize('flags', [0, TVSGF.HAS_TANGENT, TVSGF.HAS_NO_NORMALS,
                                   TVSGF.HAS_NO_NORMALS | TVSGF.HAS_TANGENT])
def test_vsgf_reader_matches_jax(flags, tmp_path):
    rng = np.random.default_rng(flags)
    V, T = 7, 4
    arrays = [rng.random((V, 4)).astype('<f4')]
    if not flags & TVSGF.HAS_NO_NORMALS:
        arrays.append(rng.random((V, 4)).astype('<f4'))
    if flags & TVSGF.HAS_TANGENT:
        arrays.append(rng.random((V, 4)).astype('<f4'))
    arrays += [rng.random((V, 2)).astype('<f4'),
               rng.integers(0, V, 3 * T).astype('<u4'),
               rng.integers(0, 3, T).astype('<u4')]
    blob = b''.join(a.tobytes() for a in arrays)
    head = np.array([(24 + len(blob), V, 3 * T, 3, flags)],
                    dtype=TVSGF._HEADER)
    path = str(tmp_path / 'm.vsgf')
    with open(path, 'wb') as f:
        f.write(head.tobytes() + blob)
    j, t = JVSGF.load_vsgf(path), TVSGF.load_vsgf(path)
    for k in ('v_pos', 'v_norm', 'v_tang', 'v_texc', 'indices',
              'mat_indices'):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize('kind', ['ub_srgb', 'ub_linear', 'f32'])
def test_decode_chunk_matches_jax(kind, tmp_path):
    rng = np.random.default_rng(5)
    data = (rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
            if kind != 'f32' else rng.random((5, 7, 4)).astype('<f4'))
    path = str(tmp_path / 'c.bin')
    with open(path, 'wb') as f:
        f.write(np.array([7, 5], '<i4').tobytes() + data.tobytes())
    bpp = 16 if kind == 'f32' else 4
    args = (path, 7, 5, bpp, 8, kind == 'ub_srgb')
    np.testing.assert_allclose(TTEX.decode_chunk(*args),
                               JTEX.decode_chunk(*args), rtol=0, atol=1e-6)


def test_decode_chunk_reads_at_the_offset(tmp_path):
    """Two chunks in one file: the second one's texels at its offset."""
    a = np.full((2, 3, 4), 10, np.uint8)
    b = np.arange(4 * 4 * 4, dtype=np.uint8).reshape(4, 4, 4)
    path = str(tmp_path / 'shared.image4ub')
    with open(path, 'wb') as f:
        for x in (a, b):
            f.write(np.array([x.shape[1], x.shape[0]], '<i4').tobytes()
                    + x.tobytes())
    got = TTEX.decode_chunk(path, 4, 4, 4, 8 + a.nbytes + 8, False)
    np.testing.assert_array_equal(got, b.astype(np.float32) / 255.0)


def test_addr_mode_and_image_file_match_jax(tmp_path):
    for s in ('wrap', 'clamp', 'mirror', 'border', 'mirror_once', 'odd'):
        assert TTEX.addr_mode_from_string(s) == JTEX.addr_mode_from_string(s)
    import imageio.v3 as iio
    img = np.random.default_rng(2).integers(0, 256, (6, 5, 3), np.uint8)
    path = str(tmp_path / 'i.png')
    iio.imwrite(path, img)
    for srgb in (False, True):
        np.testing.assert_allclose(TTEX.load_image_file(path, srgb),
                                   JTEX.load_image_file(path, srgb),
                                   rtol=0, atol=1e-6)
