"""The material zoo: the test box and the test city with every material,
light and integrator feature the port shades, as Hydra XML libraries.

Imports no JAX: the card tests and ``chip_smoke.py`` use it, and the CPU
tests load the same library text with both packages' ``load_scene``.

* ``write_zoo_box``: the textured box of ``scene.synth.build_box`` plus six
  quads and two closed cubes with placeholder materials, a second area
  light and an 8-bit lat-long sky (an env map that is not
  importance-sampled), written by ``api.write_library``; then the
  placeholders' material nodes are replaced in the library text by a rough
  conductor (alpha 0.25), a smooth conductor (alpha 0), a Lambert and an
  Oren-Nayar ``diffuse``, a ``dielectric`` cube and an old-Hydra glass cube
  (``<transparency>``), and the second light by a disc.  The walls, the
  textured quad and the glossy quad keep their GLTF conversions.
* ``write_zoo_city``: the bench city of ``scene.synth.build_city`` as
  written, its four wall materials replaced by an Oren-Nayar diffuse with
  its facade texture, a rough conductor, a dielectric and an old-Hydra
  glass; the ground stays GLTF.
"""
import os
import re

import numpy as np
import torch

from hydracore3_torch import api
from hydracore3_torch.scene import build as B
from hydracore3_torch.scene import synth

SKY_SEED = 21

# the zoo's material nodes, by placeholder name ({i}: the material id)
ZOO_MATERIALS = {
    'zoo_rough': '''<material id="{i}" name="zoo_rough" type="rough_conductor">
    <alpha val="0.25" /><eta val="0.2" /><k val="3.1" />
  </material>''',
    'zoo_mirror': '''<material id="{i}" name="zoo_mirror" type="rough_conductor">
    <alpha val="0" /><eta val="1.4" /><k val="2.6" />
  </material>''',
    'zoo_lambert': '''<material id="{i}" name="zoo_lambert" type="diffuse">
    <reflectance val="0.2 0.6 0.3" />
  </material>''',
    'zoo_orennayar': '''<material id="{i}" name="zoo_orennayar" type="diffuse">
    <bsdf type="oren-nayar" /><reflectance val="0.7 0.5 0.3" />
    <roughness val="0.6" />
  </material>''',
    'zoo_dielectric': '''<material id="{i}" name="zoo_dielectric" type="dielectric">
    <int_ior val="1.5" /><ext_ior val="1.0" />
  </material>''',
    'zoo_glass': '''<material id="{i}" name="zoo_glass" type="hydra_material">
    <reflectivity><color val="0.9 0.9 0.9" /><glossiness val="1" />
    </reflectivity>
    <transparency><color val="0.85 0.9 1.0" /><glossiness val="1" />
      <ior val="1.45" /></transparency>
  </material>''',
}
DISC_RADIUS = 0.6


def _quad(p0, p1, p2, p3):
    return (np.array([p0, p1, p2, p3], np.float32),
            np.array([[0, 1, 2], [0, 2, 3]], np.uint32))


def _cube(center, half):
    """A closed cube of 12 outward triangles."""
    c, h = np.asarray(center, np.float32), np.float32(half)
    corners = np.array([[x, y, z] for z in (-1, 1) for y in (-1, 1)
                        for x in (-1, 1)], np.float32) * h + c
    faces = np.array([[0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6],
                      [0, 1, 5], [0, 5, 4], [2, 6, 7], [2, 7, 3],
                      [0, 4, 6], [0, 6, 2], [1, 3, 7], [1, 7, 5]], np.uint32)
    return corners, faces


def sky_texture():
    """An 8-bit lat-long sky: a blue gradient with a bright band."""
    rng = np.random.default_rng(SKY_SEED)
    h, w = 16, 32
    t = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    sky = (1.0 - t) * np.float32([0.55, 0.7, 1.0]) + t * np.float32(
        [0.25, 0.2, 0.15])
    sky = np.broadcast_to(sky, (h, w, 3)).copy()
    sky[5:7] = (1.0, 0.95, 0.8)
    sky += rng.uniform(-0.05, 0.05, sky.shape).astype(np.float32)
    return (np.clip(sky, 0.0, 1.0) * 255).astype(np.uint8)


def zoo_box_desc(width: int = 64, height: int = 48, depth: int = 4,
                 wall_subdiv: int = 1) -> B.SceneDesc:
    """The box with the zoo's placeholder materials, the second area light
    (a disc after patching) and the sky; ``wall_subdiv`` as
    ``synth.build_box``'s."""
    sd = synth.build_box(width, height, depth, textured=True,
                         wall_subdiv=wall_subdiv)
    placements = {
        'zoo_rough': _quad((-3.5, 0, -2.5), (-1.5, 0, -2.5), (-1.5, 2, -2.0),
                           (-3.5, 2, -2.0)),
        'zoo_mirror': _quad((1.5, 0, -2.0), (3.5, 0, -2.5), (3.5, 2, -2.5),
                            (1.5, 2, -2.0)),
        'zoo_lambert': _quad((-3.5, -3.9, 1.0), (-1.5, -3.9, 1.0),
                             (-1.5, -3.9, -1.0), (-3.5, -3.9, -1.0)),
        'zoo_orennayar': _quad((-1, 0.5, -3.5), (1, 0.5, -3.5),
                               (1, 2.5, -3.5), (-1, 2.5, -3.5)),
        'zoo_dielectric': _cube((-2.0, -2.9, 2.0), 0.9),
        'zoo_glass': _cube((1.0, -0.6, 1.5), 0.7),
    }
    for name, (pos, ind) in placements.items():
        mat = len(sd.materials)
        sd.materials.append(B.MaterialDesc(name=name,
                                           diffuse_color=(0.5, 0.5, 0.5)))
        sd.meshes.append(B.MeshDesc(pos=pos, indices=ind,
                                    mat_indices=np.full(len(ind), mat)))
        sd.instances.append((len(sd.meshes) - 1, None))
    dm = np.eye(4, dtype=np.float32)
    dm[:3, 3] = (2.0, 3.9, 1.5)
    sd.lights.append(B.AreaLightDesc(name='zoo_disc', color=(1.0, 0.9, 0.7),
                                     multiplier=8.0, half_width=DISC_RADIUS,
                                     half_length=DISC_RADIUS, matrix=dm))
    sd.env = B.EnvLightDesc(color=(1.0, 1.0, 1.0), multiplier=1.5,
                            tex_id=sd.add_texture(sky_texture(), 'sky'))
    return sd


def patch_materials(text: str, nodes: dict, **fmt) -> str:
    """Replace the material nodes named in ``nodes`` ({name: template with
    ``{i}``}) by the templates, keeping each node's id; ``fmt`` fills the
    templates' other fields."""
    for name, tmpl in nodes.items():
        pat = re.compile(r'<material id="(\d+)" name="' + re.escape(name)
                         + r'"[^>]*>.*?</material>', re.S)
        m = pat.search(text)
        if m is None:
            raise KeyError(f'no material {name!r} in the library')
        text = (text[:m.start()] + tmpl.format(i=m.group(1), **fmt)
                + text[m.end():])
    return text


def patch_disc(text: str, name: str = 'zoo_disc') -> str:
    """The area light ``name`` as a disc of radius DISC_RADIUS."""
    pat = re.compile(r'(<light id="\d+" name="' + re.escape(name)
                     + r'" type="area" )shape="rect"(.*?)<size [^>]*/>', re.S)
    text, n = pat.subn(r'\1shape="disk"\2<size radius="'
                       + f'{DISC_RADIUS}' + '" />', text)
    if n != 1:
        raise KeyError(f'no area light {name!r} in the library')
    return text


def _rewrite(path: str, fn):
    with open(path) as f:
        text = f.read()
    with open(path, 'w') as f:
        f.write(fn(text))
    return path


def write_zoo_box(out_dir: str, width: int = 64, height: int = 48,
                  depth: int = 4, wall_subdiv: int = 1) -> str:
    """The zoo box library in ``out_dir``; returns the XML's path."""
    path = api.write_library(zoo_box_desc(width, height, depth, wall_subdiv),
                             out_dir)
    return _rewrite(path, lambda t: patch_disc(patch_materials(
        t, ZOO_MATERIALS)))


CITY_WALLS = {
    'wall0': '''<material id="{i}" name="wall0" type="diffuse">
    <bsdf type="oren-nayar" /><roughness val="0.5" />
    <reflectance val="1 1 1"><texture id="1" type="texref"
      matrix="0.25 0 0 0 0 0.25 0 0" addressing_mode_u="wrap"
      addressing_mode_v="wrap" filter="linear" /></reflectance>
  </material>''',
    'wall1': ZOO_MATERIALS['zoo_rough'].replace('zoo_rough', 'wall1'),
    'wall2': ZOO_MATERIALS['zoo_dielectric'].replace('zoo_dielectric',
                                                     'wall2'),
    'wall3': ZOO_MATERIALS['zoo_glass'].replace('zoo_glass', 'wall3'),
}


def write_zoo_city(out_dir: str, **city_kw) -> str:
    """The city library (``synth.build_city(**city_kw)``) with the zoo's
    wall materials in ``out_dir``; returns the XML's path."""
    path = api.write_library(synth.build_city(**city_kw), out_dir)
    return _rewrite(path, lambda t: patch_materials(t, CITY_WALLS))


# the zoo box II: plastic, thin film and blend ({i}: the node's own id,
# {ids[name]}: another material's id, {tex[name]}: a texture id)
_TEXREF = ('<texture id="{tex[%s]}" type="texref" matrix="1 0 0 0 0 1 0 0" '
           'addressing_mode_u="wrap" addressing_mode_v="wrap" '
           'filter="linear" />')
ZOO2_MATERIALS = {
    'zoo2_plastic_rough': '''<material id="{i}" name="zoo2_plastic_rough" type="plastic">
    <reflectance val="0.3 0.5 0.8" /><int_ior val="1.49" />
    <ext_ior val="1.0" /><alpha val="0.2" />
  </material>''',
    'zoo2_plastic_smooth': '''<material id="{i}" name="zoo2_plastic_smooth" type="plastic">
    <reflectance val="0.8 0.25 0.1" /><int_ior val="1.5" />
    <ext_ior val="1.0" /><alpha val="0.0005" /><nonlinear val="1" />
  </material>''',
    'zoo2_film_clear': '''<material id="{i}" name="zoo2_film_clear" type="thin_film">
    <ext_ior val="1.0" /><transparent val="1" />
    <layers><layer><thickness val="300" /><eta val="1.45" /><k val="0" />
    </layer></layers><eta val="1.5" /><k val="0" />
  </material>''',
    'zoo2_film_metal': '''<material id="{i}" name="zoo2_film_metal" type="thin_film">
    <alpha val="0.2" /><ext_ior val="1.0" /><transparent val="0" />
    <layers><layer><thickness val="250" />
      <eta val="1.4"><spectrum id="0" /></eta><k val="0" />
    </layer></layers><eta val="0.2" /><k val="3.0" />
  </material>''',
    'zoo2_film_tmap': '''<material id="{i}" name="zoo2_film_tmap" type="thin_film">
    <ext_ior val="1.0" /><transparent val="0" />
    <thickness_map min="150" max="650">''' + _TEXREF % 'tmap' + '''
    </thickness_map>
    <layers><layer><thickness val="400" /><eta val="1.33" /><k val="0" />
    </layer></layers><eta val="1.5" /><k val="0" />
  </material>''',
    'zoo2_blend': '''<material id="{i}" name="zoo2_blend" type="blend"
    node_top="{ids[zoo2_blend_inner]}" node_bottom="{ids[zoo2_plastic_rough]}">
    <weight val="0.35" />
  </material>''',
    'zoo2_blend_inner': '''<material id="{i}" name="zoo2_blend_inner" type="blend"
    node_top="{ids[zoo2_blend_diffuse]}" node_bottom="{ids[zoo2_blend_metal]}">
    <weight val="1.0">''' + _TEXREF % 'weight' + '''</weight>
  </material>''',
    'zoo2_blend_diffuse': '''<material id="{i}" name="zoo2_blend_diffuse" type="diffuse">
    <reflectance val="0.75 0.7 0.2" />
  </material>''',
    'zoo2_blend_metal': '''<material id="{i}" name="zoo2_blend_metal" type="rough_conductor">
    <alpha val="0.15" /><eta val="0.25" /><k val="3.4" />
  </material>''',
}
# the SPD of the metal film's layer (spectrum id 0): wavelength, eta
FILM_SPD = ((360.0, 1.52), (450.0, 1.46), (525.0, 1.42), (600.0, 1.39),
            (700.0, 1.37), (830.0, 1.35))


def float_sky_texture():
    """A float32 lat-long sky with a bright band: importance-sampled."""
    sky = sky_texture().astype(np.float32) / 255.0
    sky[5:7] *= 3.0
    return sky


def _quad_uv(p0, p1, p2, p3):
    pos, ind = _quad(p0, p1, p2, p3)
    return pos, ind, np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)


def zoo_box2_desc(width: int = 64, height: int = 48, depth: int = 4
                  ) -> B.SceneDesc:
    """The zoo box's shell (the textured box, its second light a disc after
    patching) with the zoo box II's placeholder materials, a checker (the
    blend's weight), a ramp (the thickness map) and a float-textured sky."""
    sd = synth.build_box(width, height, depth, textured=True)
    placements = {
        'zoo2_plastic_rough': _quad_uv((-3.5, 0, -2.5), (-1.5, 0, -2.5),
                                       (-1.5, 2, -2.0), (-3.5, 2, -2.0)),
        'zoo2_plastic_smooth': _quad_uv((1.5, 0, -2.0), (3.5, 0, -2.5),
                                        (3.5, 2, -2.5), (1.5, 2, -2.0)),
        'zoo2_film_metal': _quad_uv((-3.5, -3.9, 1.0), (-1.5, -3.9, 1.0),
                                    (-1.5, -3.9, -1.0), (-3.5, -3.9, -1.0)),
        'zoo2_film_tmap': _quad_uv((-1, 0.5, -3.5), (1, 0.5, -3.5),
                                   (1, 2.5, -3.5), (-1, 2.5, -3.5)),
        'zoo2_blend': _quad_uv((1.2, -3.9, 2.5), (3.5, -3.9, 2.5),
                               (3.5, -3.9, 0.2), (1.2, -3.9, 0.2)),
        'zoo2_film_clear': _cube((1.0, -0.6, 1.5), 0.7) + (None,),
    }
    for name, (pos, ind, texc) in placements.items():
        mat = len(sd.materials)
        sd.materials.append(B.MaterialDesc(name=name,
                                           diffuse_color=(0.5, 0.5, 0.5)))
        sd.meshes.append(B.MeshDesc(pos=pos, indices=ind, texc=texc,
                                    mat_indices=np.full(len(ind), mat)))
        sd.instances.append((len(sd.meshes) - 1, None))
    # the blend tree's inner nodes: materials without geometry
    for name in ('zoo2_blend_inner', 'zoo2_blend_diffuse',
                 'zoo2_blend_metal'):
        sd.materials.append(B.MaterialDesc(name=name))
    checker = np.kron(np.indices((4, 4)).sum(0) % 2, np.ones((4, 4)))
    sd.add_texture(np.repeat((40 + 200 * checker)[..., None], 3, 2)
                   .astype(np.uint8), 'weight')
    ramp = np.linspace(0, 255, 16)[None, :, None].repeat(4, 0).repeat(3, 2)
    sd.add_texture(ramp.astype(np.uint8), 'tmap')
    dm = np.eye(4, dtype=np.float32)
    dm[:3, 3] = (2.0, 3.9, 1.5)
    sd.lights.append(B.AreaLightDesc(name='zoo_disc', color=(1.0, 0.9, 0.7),
                                     multiplier=8.0, half_width=DISC_RADIUS,
                                     half_length=DISC_RADIUS, matrix=dm))
    sd.env = B.EnvLightDesc(color=(1.0, 1.0, 1.0), multiplier=1.5,
                            tex_id=sd.add_texture(float_sky_texture(), 'sky'))
    return sd


def _material_ids(text: str) -> dict:
    return {m.group(2): int(m.group(1)) for m in re.finditer(
        r'<material id="(\d+)" name="([^"]*)"', text)}


def _texture_ids(text: str) -> dict:
    return {m.group(2): int(m.group(1)) for m in re.finditer(
        r'<texture id="(\d+)" name="([^"]*)"', text)}


def add_spectra(text: str, out_dir: str, spd=FILM_SPD) -> str:
    """Write ``spd`` as ``film_eta.spd`` in ``out_dir`` and a spectra
    library naming it (spectrum id 0) into the library text."""
    with open(os.path.join(out_dir, 'film_eta.spd'), 'w') as f:
        f.write('# wavelength (nm) eta\n')
        f.writelines(f'{w} {v}\n' for w, v in spd)
    return text + ('\n<spectra_lib>\n  <spectrum id="0" name="film_eta" '
                   'loc="film_eta.spd" />\n</spectra_lib>\n')


def write_zoo_box2(out_dir: str, width: int = 64, height: int = 48,
                   depth: int = 4) -> str:
    """The zoo box II library in ``out_dir``; returns the XML's path."""
    path = api.write_library(zoo_box2_desc(width, height, depth), out_dir)

    def patch(text):
        text = patch_materials(text, ZOO2_MATERIALS, ids=_material_ids(text),
                               tex=_texture_ids(text))
        return add_spectra(patch_disc(text), out_dir)
    return _rewrite(path, patch)


CITY2_WALLS = {
    'wall0': CITY_WALLS['wall0'],
    'wall1': ZOO2_MATERIALS['zoo2_plastic_rough'].replace(
        'zoo2_plastic_rough', 'wall1'),
    'wall2': '''<material id="{i}" name="wall2" type="thin_film">
    <alpha val="0.2" /><ext_ior val="1.0" /><transparent val="0" />
    <layers><layer><thickness val="250" /><eta val="1.4" /><k val="0" />
    </layer></layers><eta val="0.2" /><k val="3.0" />
  </material>''',
    'wall3': '''<material id="{i}" name="wall3" type="blend"
    node_top="{ids[city2_diffuse]}" node_bottom="{ids[city2_metal]}">
    <weight val="1.0"><texture id="1" type="texref"
      matrix="0.25 0 0 0 0 0.25 0 0" addressing_mode_u="wrap"
      addressing_mode_v="wrap" filter="linear" /></weight>
  </material>''',
}
CITY2_EXTRA = (
    ('city2_diffuse', '''<material id="{i}" name="city2_diffuse" type="diffuse">
    <reflectance val="0.6 0.55 0.5" />
  </material>'''),
    ('city2_metal', ZOO2_MATERIALS['zoo2_blend_metal'].replace(
        'zoo2_blend_metal', 'city2_metal')),
)


def write_zoo_city2(out_dir: str, **city_kw) -> str:
    """The city library (``synth.build_city(**city_kw)``) with its four wall
    materials a textured Oren-Nayar diffuse, a rough plastic, a rough
    metal-substrate thin film and a blend (the facade texture weighing a
    diffuse against a rough conductor, two materials appended to the
    library) in ``out_dir``; returns the XML's path."""
    path = api.write_library(synth.build_city(**city_kw), out_dir)

    def patch(text):
        n = len(_material_ids(text))
        extra = ''.join('\n  ' + tmpl.format(i=n + k)
                        for k, (_, tmpl) in enumerate(CITY2_EXTRA))
        text = text.replace('</materials_lib>', extra + '\n</materials_lib>')
        return patch_materials(text, CITY2_WALLS, ids=_material_ids(text))
    return _rewrite(path, patch)


def golden_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'goldens', name)


# ---- the spectral boxes: hero-wavelength spectral mode -----------------------

SPEC_GRID = np.arange(360.0, 831.0, 10.0)     # where the SPD files sample


def _blackbody(lam, temp=4500.0):
    """Planck's law at ``temp`` kelvin, normalized to 1 at its peak over
    the grid."""
    h, c, k = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    m = lam * 1e-9
    b = 1.0 / (m ** 5 * (np.exp(h * c / (m * k * temp)) - 1.0))
    return b / b.max()


def _gauss(lam, mu, sigma):
    return np.exp(-((lam - mu) / sigma) ** 2)


# the spectra, by name: formulas over SPEC_GRID (nm)
SPECTRA = {
    'light_bb': _blackbody,
    'refl_green': lambda x: 0.1 + 0.6 * _gauss(x, 540.0, 50.0),
    'refl_orange': lambda x: 0.15 + 0.7 / (1.0 + np.exp(-(x - 580.0) / 25.0)),
    'gold_eta': lambda x: 0.2 + 1.3 / (1.0 + np.exp((x - 520.0) / 30.0)),
    'gold_k': lambda x: 1.5 + 4.0 * (x - 360.0) / 470.0,
    'env_sky': lambda x: 0.8 + 0.4 * _gauss(x, 460.0, 80.0),
    # box II's
    'cauchy_ior': lambda x: 1.5046 + 4200.0 / (x * x),
    'film_eta': lambda x: 1.38 + 5000.0 / (x * x),
    'resp_x': lambda x: _gauss(x, 595.0, 35.0) + 0.35 * _gauss(x, 445.0,
                                                                20.0),
    'resp_y': lambda x: _gauss(x, 555.0, 42.0),
    'resp_z': lambda x: 1.7 * _gauss(x, 450.0, 22.0),
}
K1_SPECTRA = ('light_bb', 'refl_green', 'refl_orange', 'gold_eta', 'gold_k',
              'env_sky')
BOX2_SPECTRA = K1_SPECTRA + ('cauchy_ior', 'film_eta', 'resp_x', 'resp_y',
                             'resp_z')
# a spectral texture: (wavelength, texture name) of its stack
SPEC_TEX = ((420.0, 'spec_blue'), (560.0, 'spec_green'), (700.0, 'spec_red'))


def _sid(name, names):
    return names.index(name)


def _spectrum(name, names):
    return f'<spectrum id="{_sid(name, names)}" />'


def spectral_materials(names) -> dict:
    """The spectral boxes' material nodes by placeholder name ({i}: the
    node's id, {ids[name]}: another material's id)."""
    s = lambda n: _spectrum(n, names)  # noqa: E731
    nodes = {
        'spec_lambert': '<material id="{i}" name="spec_lambert" '
        'type="diffuse">\n    <reflectance val="0.2 0.6 0.3">'
        + s('refl_green') + '</reflectance>\n  </material>',
        'spec_orennayar': '<material id="{i}" name="spec_orennayar" '
        'type="diffuse">\n    <bsdf type="oren-nayar" /><reflectance '
        'val="0.7 0.5 0.3">' + s('refl_orange') + '</reflectance>\n'
        '    <roughness val="0.6" />\n  </material>',
        'spec_rough': '<material id="{i}" name="spec_rough" '
        'type="rough_conductor">\n    <alpha val="0.25" /><eta val="0.2">'
        + s('gold_eta') + '</eta><k val="3.1">' + s('gold_k')
        + '</k>\n  </material>',
        'spec_mirror': '<material id="{i}" name="spec_mirror" '
        'type="rough_conductor">\n    <alpha val="0" /><eta val="1.4">'
        + s('gold_eta') + '</eta><k val="2.6">' + s('gold_k')
        + '</k>\n  </material>',
    }
    if 'cauchy_ior' not in names:
        return nodes
    texref = ('<texture id="{tex[%s]}" type="texref" matrix="1 0 0 0 0 1 0 '
              '0" addressing_mode_u="wrap" addressing_mode_v="wrap" '
              'filter="linear" />')
    nodes.update({
        'spec_dielectric': '<material id="{i}" name="spec_dielectric" '
        'type="dielectric">\n    <int_ior val="1.5">' + s('cauchy_ior')
        + '</int_ior><ext_ior val="1.0" />\n  </material>',
        'spec_glass': ZOO_MATERIALS['zoo_glass'].replace('zoo_glass',
                                                         'spec_glass'),
        'spec_texdiffuse': '<material id="{i}" name="spec_texdiffuse" '
        'type="diffuse">\n    <reflectance val="1 1 1">'
        '<spectrum id="{spec_tex_sid}" /></reflectance>\n  </material>',
        'spec_film': '<material id="{i}" name="spec_film" '
        'type="thin_film">\n    <alpha val="0.2" /><ext_ior val="1.0" />'
        '<transparent val="0" />\n    <layers><layer><thickness val="250" />'
        '<eta val="1.4">' + s('film_eta') + '</eta><k val="0" />\n    '
        '</layer></layers><eta val="0.2" /><k val="3.0" />\n  </material>',
        'spec_film_tmap': '<material id="{i}" name="spec_film_tmap" '
        'type="thin_film">\n    <ext_ior val="1.0" /><transparent val="0" />'
        '\n    <thickness_map min="150" max="650">' + texref % 'tmap'
        + '</thickness_map>\n    <layers><layer><thickness val="400" />'
        '<eta val="1.33">' + s('film_eta') + '</eta><k val="0" />\n    '
        '</layer></layers><eta val="1.5" /><k val="0" />\n  </material>',
        'spec_blend': '<material id="{i}" name="spec_blend" type="blend"\n'
        '    node_top="{ids[spec_blend_diffuse]}" '
        'node_bottom="{ids[spec_blend_metal]}">\n    <weight val="1.0">'
        + texref % 'weight' + '</weight>\n  </material>',
        'spec_blend_diffuse': '<material id="{i}" name="spec_blend_diffuse"'
        ' type="diffuse">\n    <reflectance val="0.75 0.7 0.2">'
        + s('refl_orange') + '</reflectance>\n  </material>',
        'spec_blend_metal': '<material id="{i}" name="spec_blend_metal" '
        'type="rough_conductor">\n    <alpha val="0.15" /><eta val="0.25">'
        + s('gold_eta') + '</eta><k val="3.4">' + s('gold_k')
        + '</k>\n  </material>',
    })
    return nodes


def spectral_box_desc(width: int = 64, height: int = 48, depth: int = 4,
                      k1: bool = True, wall_subdiv: int = 1) -> B.SceneDesc:
    """The zoo box's shell with the spectral boxes' placeholder materials.
    ``k1``: what the megakernel's spectral gate admits (a flat sky);
    else also a dielectric and a glass cube, a spectral-texture diffuse,
    two thin films, a blend and a float lat-long sky.  ``wall_subdiv`` as
    ``synth.build_box``'s."""
    sd = synth.build_box(width, height, depth, textured=True,
                         wall_subdiv=wall_subdiv)
    placements = {
        'spec_rough': _quad_uv((-3.5, 0, -2.5), (-1.5, 0, -2.5),
                               (-1.5, 2, -2.0), (-3.5, 2, -2.0)),
        'spec_mirror': _quad_uv((1.5, 0, -2.0), (3.5, 0, -2.5),
                                (3.5, 2, -2.5), (1.5, 2, -2.0)),
        'spec_lambert': _quad_uv((-3.5, -3.9, 1.0), (-1.5, -3.9, 1.0),
                                 (-1.5, -3.9, -1.0), (-3.5, -3.9, -1.0)),
        'spec_orennayar': _quad_uv((-1, 0.5, -3.5), (1, 0.5, -3.5),
                                   (1, 2.5, -3.5), (-1, 2.5, -3.5)),
    }
    if not k1:
        placements.update({
            'spec_dielectric': _cube((-2.0, -2.9, 2.0), 0.9) + (None,),
            'spec_glass': _cube((1.0, -0.6, 1.5), 0.7) + (None,),
            'spec_texdiffuse': _quad_uv((-1, -3.9, 3.5), (1, -3.9, 3.5),
                                        (1, -3.9, 1.5), (-1, -3.9, 1.5)),
            'spec_film': _quad_uv((-3.9, -1, 2.5), (-3.9, -1, 0.5),
                                  (-3.9, 1.5, 0.5), (-3.9, 1.5, 2.5)),
            'spec_film_tmap': _quad_uv((3.9, -1, 0.5), (3.9, -1, 2.5),
                                       (3.9, 1.5, 2.5), (3.9, 1.5, 0.5)),
            'spec_blend': _quad_uv((1.2, -3.9, 2.5), (3.5, -3.9, 2.5),
                                   (3.5, -3.9, 0.2), (1.2, -3.9, 0.2)),
        })
    for name, (pos, ind, texc) in placements.items():
        mat = len(sd.materials)
        sd.materials.append(B.MaterialDesc(name=name,
                                           diffuse_color=(0.5, 0.5, 0.5)))
        sd.meshes.append(B.MeshDesc(pos=pos, indices=ind, texc=texc,
                                    mat_indices=np.full(len(ind), mat)))
        sd.instances.append((len(sd.meshes) - 1, None))
    dm = np.eye(4, dtype=np.float32)
    dm[:3, 3] = (2.0, 3.9, 1.5)
    sd.lights.append(B.AreaLightDesc(name='zoo_disc', color=(1.0, 0.9, 0.7),
                                     multiplier=8.0, half_width=DISC_RADIUS,
                                     half_length=DISC_RADIUS, matrix=dm))
    if k1:
        sd.env = B.EnvLightDesc(color=(0.3, 0.35, 0.4), multiplier=0.8)
        return sd
    for name in ('spec_blend_diffuse', 'spec_blend_metal'):
        sd.materials.append(B.MaterialDesc(name=name))
    checker = np.kron(np.indices((4, 4)).sum(0) % 2, np.ones((4, 4)))
    sd.add_texture(np.repeat((40 + 200 * checker)[..., None], 3, 2)
                   .astype(np.uint8), 'weight')
    ramp = np.linspace(0, 255, 16)[None, :, None].repeat(4, 0).repeat(3, 2)
    sd.add_texture(ramp.astype(np.uint8), 'tmap')
    yy, xx = np.indices((16, 16))
    stacks = {'spec_blue': (xx // 4) % 2, 'spec_green': (yy // 4) % 2,
              'spec_red': ((xx + yy) // 4) % 2}
    for _, name in SPEC_TEX:
        g = (50 + 180 * stacks[name]).astype(np.uint8)
        sd.add_texture(np.repeat(g[..., None], 3, 2), name)
    sd.env = B.EnvLightDesc(color=(1.0, 1.0, 1.0), multiplier=1.5,
                            tex_id=sd.add_texture(float_sky_texture(), 'sky'))
    return sd


def write_spectra(out_dir: str, names, spec_tex=None) -> str:
    """The SPD files of ``names`` (SPECTRA's formulas on SPEC_GRID) in
    ``out_dir`` and the spectra library naming them, spectrum id = the
    name's index; ``spec_tex`` ((wavelength, texture id) pairs) appends a
    spectral texture (``lambda_ref_ids``) as the next id."""
    rows = []
    for k, name in enumerate(names):
        vals = SPECTRA[name](SPEC_GRID)
        with open(os.path.join(out_dir, name + '.spd'), 'w') as f:
            f.write(f'# {name}: wavelength (nm) value\n')
            f.writelines(f'{w:g} {v:.6g}\n' for w, v in zip(SPEC_GRID, vals))
        rows.append(f'  <spectrum id="{k}" name="{name}" loc="{name}.spd" />')
    if spec_tex:
        refs = ' '.join(f'{w:g} {t}' for w, t in spec_tex)
        rows.append(f'  <spectrum id="{len(names)}" name="spec_tex" '
                    f'lambda_ref_ids="{refs}" />')
    return '\n<spectra_lib>\n' + '\n'.join(rows) + '\n</spectra_lib>\n'


def _light_spectrum(text, light, spectrum):
    """Put ``spectrum`` (a node) first inside the intensity color of the
    light named ``light``."""
    pat = re.compile(r'(<light id="\d+" name="' + re.escape(light)
                     + r'"[^>]*>.*?<color val="[^"]*")( />|>)', re.S)
    text, n = pat.subn(lambda m: m.group(1) + '>' + spectrum
                       + ('</color>' if m.group(2) == ' />' else ''), text,
                       count=1)
    if n != 1:
        raise KeyError(f'no light {light!r} in the library')
    return text


def write_spectral_box(out_dir: str, width: int = 64, height: int = 48,
                       depth: int = 4, k1: bool = True,
                       wall_subdiv: int = 1) -> str:
    """A spectral box library in ``out_dir`` for ``load_scene(...,
    spectral_mode=True)``; returns the XML's path.

    ``k1=True``: what the JAX megakernel's spectral gate admits (at most 29
    spectra, no spectral texture or response, no env map, no dielectric or
    glass): an SPD Lambert and Oren-Nayar diffuse, a rough and a smooth
    conductor with gold-like eta / k SPDs, the box's textured GLTF quad
    and walls with no SPD, the top rect light with a blackbody SPD, the
    disc, point and sphere lights with colors only, and a flat sky with an
    SPD.  ``k1=False`` (the spectral box II, which the gate refuses) adds a
    dielectric cube with a Cauchy IOR SPD, an old-Hydra glass cube, a
    diffuse with a spectral texture (``lambda_ref_ids``, three 8-bit
    stacks), a metal-substrate thin film whose layer eta is an SPD, a
    thickness-mapped film (the direct Airy path), a blend of an SPD
    diffuse and a gold conductor, a float lat-long sky with the sky SPD
    and XYZ camera-response spectra.  The SPD files are written beside
    the library from SPECTRA's formulas.  ``wall_subdiv`` as
    ``synth.build_box``'s."""
    path = api.write_library(spectral_box_desc(width, height, depth, k1,
                                               wall_subdiv), out_dir)
    names = K1_SPECTRA if k1 else BOX2_SPECTRA

    def patch(text):
        tex = _texture_ids(text)
        text = patch_materials(
            text, spectral_materials(names), ids=_material_ids(text),
            tex=tex, spec_tex_sid=len(names))
        text = patch_disc(text)
        # the top light's blackbody and the sky's SPD
        text = _light_spectrum(text, 'top', _spectrum('light_bb', names))
        text = _light_spectrum(text, 'env', _spectrum('env_sky', names))
        if not k1:
            text = text.replace('</camera>', '  <sensor><response type="xyz">'
                                + ''.join(_spectrum(n, names) for n in (
                                    'resp_x', 'resp_y', 'resp_z'))
                                + '</response></sensor>\n  </camera>')
        spec_tex = (None if k1 else
                    [(w, tex[name]) for w, name in SPEC_TEX])
        return text + write_spectra(out_dir, names, spec_tex)
    return _rewrite(path, patch)


# ---- the feature scenes: spot and IES lights, normal maps, GLTF slot-2/3
# maps, the camera-back texture and the lens cameras --------------------------

_NMAP_REF = ('<texture id="{tex[%s]}" type="texref" matrix="%s" '
             'addressing_mode_u="wrap" addressing_mode_v="wrap" '
             'filter="linear" input_gamma="1" />')


def _normal_map(name, tile='1 0 0 0 0 1 0 0', invert=''):
    """A ``normal_bump`` displacement node reading texture ``name``."""
    return ('<displacement type="normal_bump"><normal_map>'
            + _NMAP_REF % (name, tile) + invert
            + '</normal_map></displacement>')


FEATURE_MATERIALS = {
    'feat_gltf_bump': '''<material id="{i}" name="feat_gltf_bump" type="gltf">
    <color val="0.8 0.6 0.4" /><glossiness val="0.6" /><metalness val="0.2" />
    ''' + _normal_map('bumps', invert='<invert x="1" swap_xy="1" />') + '''
  </material>''',
    'feat_cond_bump': '''<material id="{i}" name="feat_cond_bump" type="rough_conductor">
    <alpha val="0.3" /><eta val="0.3" /><k val="3.0" />
    ''' + _normal_map('ripples', '2 0 0 0 0 2 0 0',
                      '<invert y="1" />') + '''
  </material>''',
    'feat_gltf_split': '''<material id="{i}" name="feat_gltf_split" type="gltf">
    <color val="0.5 0.7 0.9" />
    <glossiness val="0.9">''' + _TEXREF % 'gloss' + '''</glossiness>
    <metalness val="0.8">''' + _TEXREF % 'metal' + '''</metalness>
  </material>''',
    'feat_gltf_packed': '''<material id="{i}" name="feat_gltf_packed" type="gltf">
    <color val="0.9 0.5 0.3" />
    <glossiness_metalness_coat val="1.0">''' + _TEXREF % 'packed' + '''
    </glossiness_metalness_coat>
  </material>''',
    'feat_blend': '''<material id="{i}" name="feat_blend" type="blend"
    node_top="{ids[feat_blend_bumped]}" node_bottom="{ids[feat_blend_metal]}">
    <weight val="0.45" />
  </material>''',
    'feat_blend_bumped': '''<material id="{i}" name="feat_blend_bumped" type="diffuse">
    <reflectance val="0.7 0.65 0.3" />
    ''' + _normal_map('bumps', '3 0 0 0 0 3 0 0') + '''
  </material>''',
    'feat_blend_metal': '''<material id="{i}" name="feat_blend_metal" type="rough_conductor">
    <alpha val="0.15" /><eta val="0.25" /><k val="3.4" />
  </material>''',
}
# the lens stack of the 'optics' camera, from the film to the scene
# (curvature radius, thickness, ior, semi-diameter; metres at scale 1): a
# biconvex back lens, an aperture stop and a cemented doublet
FEATURE_LENS = ((-0.045, 0.04, 1.0, 0.011), (0.045, 0.005, 1.5, 0.011),
                (0.0, 0.006, 0.0, 0.009),
                (-0.12, 0.006, 1.0, 0.012), (0.035, 0.004, 1.52, 0.012),
                (0.09, 0.003, 1.62, 0.012))
FEATURE_CAMERAS = ('pinhole', 'dof', 'optics')
DOF_LENS_RADIUS = 0.25


def _ies_text(v_angles, h_angles, candela, title):
    """An IES LM-63 (type C) file: candela [len(h), len(v)]."""
    rows = ['IESNA:LM-63-2002', f'[TEST] {title}', '[MANUFAC] a formula',
            'TILT=NONE',
            f'1 1000 1 {len(v_angles)} {len(h_angles)} 1 2 0.1 0.1 0.0',
            '1.0 1.0 50', ' '.join(f'{a:g}' for a in v_angles),
            ' '.join(f'{a:g}' for a in h_angles)]
    rows += [' '.join(f'{c:.4f}' for c in row) for row in candela]
    return '\n'.join(rows) + '\n'


def write_ies_profiles(out_dir: str) -> tuple:
    """Two IES profiles from formulas in ``out_dir``: a point profile over
    the whole sphere with quadrant symmetry (horizontal angles to 90) and
    a downward one with bilateral symmetry (to 180, vertical angles to 90,
    so the upper half reads 0).  Returns their file names."""
    v = np.arange(0.0, 181.0, 15.0)
    h = np.arange(0.0, 91.0, 22.5)
    vr, hr = np.radians(v)[None, :], np.radians(h)[:, None]
    point = 100.0 * (0.25 + 0.75 * np.cos(0.5 * vr) ** 2) * (
        1.0 + 0.4 * np.cos(2.0 * hr))
    v2 = np.arange(0.0, 91.0, 10.0)
    h2 = np.arange(0.0, 181.0, 45.0)
    vr2, hr2 = np.radians(v2)[None, :], np.radians(h2)[:, None]
    down = 100.0 * np.cos(vr2) ** 1.5 * (1.0 + 0.3 * np.cos(hr2))
    names = ('feat_point.ies', 'feat_rect.ies')
    for name, args in zip(names, ((v, h, point, 'point'),
                                  (v2, h2, down, 'rect'))):
        with open(os.path.join(out_dir, name), 'w') as f:
            f.write(_ies_text(*args))
    return names


def _feature_textures(sd):
    """The feature scenes' generated textures: two normal maps, a
    glossiness and a metalness map, a packed (glossiness, metalness, coat)
    map and the camera-back picture."""
    yy, xx = np.indices((32, 32)) / 32.0

    def nmap(nx, ny):
        nz = np.sqrt(np.clip(1.0 - nx * nx - ny * ny, 0.0, 1.0))
        n = np.stack([nx * 0.5 + 0.5, ny * 0.5 + 0.5, nz], -1)
        return (n * 255).astype(np.uint8)

    sd.add_texture(nmap(0.5 * np.sin(2 * np.pi * 2 * xx),
                        0.5 * np.cos(2 * np.pi * 3 * yy)), 'bumps')
    r = np.hypot(xx - 0.5, yy - 0.5)
    sd.add_texture(nmap(0.4 * np.sin(2 * np.pi * 4 * r) * (xx - 0.5) * 2,
                        0.4 * np.sin(2 * np.pi * 4 * r) * (yy - 0.5) * 2),
                   'ripples')
    ramp = np.repeat((40 + 200 * xx)[..., None], 3, 2).astype(np.uint8)
    sd.add_texture(ramp, 'gloss')
    sd.add_texture(ramp[::-1].transpose(1, 0, 2).copy(), 'metal')
    checker = (np.indices((32, 32)) // 8).sum(0) % 2
    packed = np.stack([60 + 180 * checker, 220 - 160 * xx, 128 + 100 * yy],
                      -1).astype(np.uint8)
    sd.add_texture(packed, 'packed')
    back = np.stack([80 + 150 * xx, 60 + 100 * yy, 200 - 120 * xx], -1)
    back[(np.indices((32, 32)) // 4).sum(0) % 2 == 0] *= 0.6
    sd.add_texture(back.astype(np.uint8), 'back')


def _light_at(x, y, z, rot_x=0.0):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(np.radians(rot_x)), np.sin(np.radians(rot_x))
    m[1:3, 1:3] = ((c, -s), (s, c))
    m[:3, 3] = (x, y, z)
    return m


def feature_box_desc(width: int = 64, height: int = 48, depth: int = 4
                     ) -> B.SceneDesc:
    """The textured box with the feature placeholders, a spot light, the
    two IES lights' placeholders (a point and a rect light), the feature
    textures and a flat sky, seen from further back so that prime rays
    past the box's open front miss (the camera-back texture)."""
    sd = synth.build_box(width, height, depth, textured=True)
    placements = {
        'feat_gltf_bump': _quad_uv((-3.5, 0, -2.5), (-1.5, 0, -2.5),
                                   (-1.5, 2, -2.0), (-3.5, 2, -2.0)),
        'feat_cond_bump': _quad_uv((1.5, 0, -2.0), (3.5, 0, -2.5),
                                   (3.5, 2, -2.5), (1.5, 2, -2.0)),
        'feat_gltf_split': _quad_uv((-3.5, -3.9, 1.0), (-1.5, -3.9, 1.0),
                                    (-1.5, -3.9, -1.0), (-3.5, -3.9, -1.0)),
        'feat_gltf_packed': _quad_uv((-1, 0.5, -3.5), (1, 0.5, -3.5),
                                     (1, 2.5, -3.5), (-1, 2.5, -3.5)),
        'feat_blend': _quad_uv((1.2, -3.9, 2.5), (3.5, -3.9, 2.5),
                               (3.5, -3.9, 0.2), (1.2, -3.9, 0.2)),
    }
    for name, (pos, ind, texc) in placements.items():
        mat = len(sd.materials)
        sd.materials.append(B.MaterialDesc(name=name,
                                           diffuse_color=(0.5, 0.5, 0.5)))
        sd.meshes.append(B.MeshDesc(pos=pos, indices=ind, texc=texc,
                                    mat_indices=np.full(len(ind), mat)))
        sd.instances.append((len(sd.meshes) - 1, None))
    for name in ('feat_blend_bumped', 'feat_blend_metal'):
        sd.materials.append(B.MaterialDesc(name=name))
    _feature_textures(sd)
    sd.lights.append(B.AreaLightDesc(name='feat_ies_rect',
                                     color=(0.9, 0.95, 1.0), multiplier=10.0,
                                     half_width=0.5, half_length=0.5,
                                     matrix=_light_at(-2.0, 3.9, -1.5)))
    sd.simple_lights += [
        B.SimpleLightDesc(kind='spot', name='feat_spot',
                          color=(1.0, 0.85, 0.6), multiplier=12.0,
                          falloff_angle=60.0, falloff_angle2=40.0,
                          matrix=_light_at(1.5, 3.2, -0.5, rot_x=15.0)),
        B.SimpleLightDesc(kind='point', name='feat_ies_point',
                          color=(0.7, 0.9, 1.0), multiplier=4.0,
                          matrix=_light_at(0.5, 1.5, 1.5))]
    sd.env = B.EnvLightDesc(color=(0.3, 0.35, 0.45), multiplier=1.0)
    sd.camera = B.CameraDesc(fov=45.0, pos=(0.0, 0.0, 15.0),
                             look_at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    return sd


def _patch_light(text, name, fn):
    """Apply ``fn`` to the light node named ``name``."""
    pat = re.compile(r'<light id="\d+" name="' + re.escape(name)
                     + r'"[^>]*>.*?</light>', re.S)
    m = pat.search(text)
    if m is None:
        raise KeyError(f'no light {name!r} in the library')
    return text[:m.start()] + fn(m.group(0)) + text[m.end():]


def _add_to_node(node, extra):
    return node.replace('</light>', '  ' + extra + '\n  </light>')


IES_MATRIX = '1 0 0 0 0 0.866025 -0.5 0 0 0.5 0.866025 0 0 0 0 1'


def patch_ies_point(text, ies_name, light='feat_ies_point'):
    """The point light ``light`` with the IES profile ``ies_name``
    (``distribution="ies"``) and a profile matrix."""
    return _patch_light(text, light, lambda n: _add_to_node(
        n.replace('distribution="uniform"', 'distribution="ies"'),
        f'<ies loc="{ies_name}" matrix="{IES_MATRIX}" />'))


def camera_nodes(camera: str) -> str:
    """The camera node's extra children for ``camera``."""
    if camera == 'pinhole':
        return ''
    if camera == 'dof':
        return ('<enable_dof val="1" />'
                f'<dof_lens_radius val="{DOF_LENS_RADIUS}" />')
    if camera == 'optics':
        lines = ''.join(
            f'<line id="{k}" curvature_radius="{c!r}" thickness="{t!r}" '
            f'ior="{n!r}" semi_diameter="{a!r}" />'
            for k, (c, t, n, a) in enumerate(FEATURE_LENS))
        return ('<optical_system scale="1" sensor_diagonal="0.05">'
                + lines + '</optical_system>')
    raise ValueError(f'camera {camera!r}: one of {FEATURE_CAMERAS}')


def write_feature_box(out_dir: str, width: int = 64, height: int = 48,
                      depth: int = 4, camera: str = 'pinhole') -> str:
    """The feature box library in ``out_dir``; returns the XML's path.

    The textured box plus: a spot light (``falloff_angle`` 60,
    ``falloff_angle2`` 40); a point light with an IES profile and a profile
    matrix; a rect light with an IES profile and ``point_area="1"``; a GLTF
    quad with a normal map (``invert x`` and ``swap_xy``) and a rough
    conductor with another (``invert y``); a GLTF with glossiness and
    metalness maps (slot 2 and 3) and one with a packed
    ``glossiness_metalness_coat`` map; a blend whose top leaf is a diffuse
    with a normal map; a flat sky with a ``<back>`` (camera-back) texture.
    ``camera``: 'pinhole', 'dof' (``enable_dof``, ``dof_lens_radius``) or
    'optics' (an ``optical_system`` of six lines: a back lens, an aperture
    stop and a doublet).  The IES files are written beside the library
    from formulas.  Under 100 triangles: the small class, which K1's gate
    refuses, so the batched route (K5) renders it."""
    extra = camera_nodes(camera)
    path = api.write_library(feature_box_desc(width, height, depth), out_dir)
    ies_names = write_ies_profiles(out_dir)

    def patch(text):
        tex = _texture_ids(text)
        text = patch_materials(text, FEATURE_MATERIALS,
                               ids=_material_ids(text), tex=tex)
        text = patch_ies_point(text, ies_names[0])
        text = _patch_light(text, 'feat_ies_rect', lambda n: _add_to_node(
            n, f'<ies loc="{ies_names[1]}" point_area="1" />'))
        text = _patch_light(text, 'env', lambda n: _add_to_node(
            n, f'<back><texture id="{tex["back"]}" type="texref" /></back>'))
        return text.replace('</camera>', extra + '</camera>')
    return _rewrite(path, patch)


FEATURE_CITY_WALLS = {
    'wall0': '''<material id="{i}" name="wall0" type="diffuse">
    <reflectance val="1 1 1"><texture id="1" type="texref"
      matrix="0.25 0 0 0 0 0.25 0 0" addressing_mode_u="wrap"
      addressing_mode_v="wrap" filter="linear" /></reflectance>
    ''' + _normal_map('bumps', '0.5 0 0 0 0 0.5 0 0',
                      '<invert x="1" swap_xy="1" />') + '''
  </material>''',
    'wall1': FEATURE_MATERIALS['feat_cond_bump'].replace('feat_cond_bump',
                                                         'wall1'),
}


def feature_city_desc(**city_kw) -> B.SceneDesc:
    """The city with the feature textures, a spot light and the IES point
    light's placeholder over its avenue."""
    sd = synth.build_city(**city_kw)
    _feature_textures(sd)
    half = city_kw.get('n_blocks', 48) * 4.0 + 20.0
    sd.simple_lights += [
        B.SimpleLightDesc(kind='spot', name='feat_spot',
                          color=(1.0, 0.85, 0.6), multiplier=3000.0,
                          falloff_angle=60.0, falloff_angle2=40.0,
                          matrix=_light_at(0.0, 24.0, half * 0.7,
                                           rot_x=-20.0)),
        B.SimpleLightDesc(kind='point', name='feat_ies_point',
                          color=(0.7, 0.9, 1.0), multiplier=2000.0,
                          matrix=_light_at(4.0, 16.0, half * 0.8))]
    return sd


def write_feature_city(out_dir: str, **city_kw) -> str:
    """The city library (``synth.build_city(**city_kw)``) with a spot light,
    a point light with an IES profile and a profile matrix, its first two
    wall materials normal-mapped (a textured diffuse and a rough
    conductor) and the rest as written, in ``out_dir``; returns the XML's
    path."""
    path = api.write_library(feature_city_desc(**city_kw), out_dir)
    ies_names = write_ies_profiles(out_dir)

    def patch(text):
        text = patch_materials(text, FEATURE_CITY_WALLS,
                               tex=_texture_ids(text))
        return patch_ies_point(text, ies_names[0])
    return _rewrite(path, patch)


# ---- motion blur: instances whose matrix moves over the shutter --------------

MOTION_CUBE = dict(center=(-2.0, -2.2, 1.0), half=0.7, shift=(2.5, 0.4, 0.0),
                   yaw=0.6)
MOTION_CITY_EVERY = 8        # every 8th block of the instanced city moves
MOTION_CITY_SHIFT = 4.0      # by half a block (the blocks' pitch is 8)
MOTION_CITY_YAW = 0.1


def _yaw(a):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(a), np.sin(a)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def _translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def add_motion(text: str, motion: dict) -> str:
    """The library text with a ``<motion matrix="..."/>`` child on each
    instance node whose id is a key of ``motion`` (instance id -> the
    matrix at the shutter's close, written as the library writes
    matrices)."""
    def sub(m):
        iid = int(m.group(1))
        if iid not in motion:
            return m.group(0)
        return (m.group(0)[:-2].rstrip() + '>\n      <motion matrix="'
                + api._mstr(motion[iid]) + '" />\n    </instance>')
    return re.sub(r'<instance id="(\d+)" mesh_id="[^"]*"[^>]*/>', sub, text)


def motion_box_desc(width: int = 64, height: int = 48, depth: int = 4
                    ) -> B.SceneDesc:
    """The textured box plus a closed cube (a diffuse GLTF) at its shutter
    open position."""
    sd = synth.build_box(width, height, depth, textured=True)
    mat = len(sd.materials)
    sd.materials.append(B.MaterialDesc(name='mover',
                                       diffuse_color=(0.2, 0.45, 0.7)))
    pos, ind = _cube((0.0, 0.0, 0.0), MOTION_CUBE['half'])
    sd.meshes.append(B.MeshDesc(pos=pos, indices=ind,
                                mat_indices=np.full(len(ind), mat)))
    sd.instances.append((len(sd.meshes) - 1,
                         _translate(MOTION_CUBE['center'])))
    return sd


def write_motion_box(out_dir: str, width: int = 64, height: int = 48,
                     depth: int = 4) -> str:
    """The motion box library in ``out_dir``; returns the XML's path: the
    textured box plus a cube that translates by ``MOTION_CUBE['shift']``
    and yaws by ``MOTION_CUBE['yaw']`` radians over the shutter (its
    instance's ``<motion>`` matrix; every other instance is static).  Under
    100 triangles: ``accel='auto'`` routes it two-level (a moving
    instance), which K1 refuses."""
    sd = motion_box_desc(width, height, depth)
    cube = len(sd.instances) - 1
    m1 = (_translate(np.add(MOTION_CUBE['center'], MOTION_CUBE['shift']))
          @ _yaw(MOTION_CUBE['yaw']))
    path = api.write_library(sd, out_dir)
    return _rewrite(path, lambda t: add_motion(t, {cube: m1}))


def write_motion_city(out_dir: str, **city_kw) -> str:
    """The instanced city (``synth.build_instanced_city(**city_kw)``) with
    every ``MOTION_CITY_EVERY``-th block instance moving by
    ``MOTION_CITY_SHIFT`` along x and yawing by ``MOTION_CITY_YAW`` radians
    about its own axis over the shutter; returns the XML's path."""
    sd = synth.build_instanced_city(**city_kw)
    motion = {}
    for iid, (mesh_id, m, *_) in enumerate(sd.instances):
        if mesh_id == 1 and (iid - 1) % MOTION_CITY_EVERY == 0:
            motion[iid] = (_translate((MOTION_CITY_SHIFT, 0.0, 0.0))
                           @ np.asarray(m, np.float32)
                           @ _yaw(MOTION_CITY_YAW))
    path = api.write_library(sd, out_dir)
    return _rewrite(path, lambda t: add_motion(t, motion))


def write_rt_box(out_dir: str, width: int = 64, height: int = 48,
                 depth: int = 4) -> str:
    """The textured box as a library (Whitted and the G-buffer's test
    scene)."""
    return api.write_library(synth.build_box(width, height, depth,
                                             textured=True), out_dir)


def write_rt_city(out_dir: str, **city_kw) -> str:
    """The bench city (``synth.build_city(**city_kw)``) as a library."""
    return api.write_library(synth.build_city(**city_kw), out_dir)


DR_TEX_SEED = 15
DR_TEX_SIZE = 256


def dr_box_desc(width: int = 64, height: int = 48, depth: int = 6
                ) -> B.SceneDesc:
    """The textured box with its back wall carrying a DR_TEX_SIZE x
    DR_TEX_SIZE texture made from DR_TEX_SEED (a white lambert of its own):
    drmain's trainable slot (``dr_tex_slot``)."""
    sd = synth.build_box(width, height, depth, textured=True)
    tex = np.random.default_rng(DR_TEX_SEED).integers(
        0, 256, (DR_TEX_SIZE, DR_TEX_SIZE, 3), dtype=np.uint8)
    tid = sd.add_texture(tex, 'dr_back')
    back = len(sd.materials)
    sd.materials.append(B.MaterialDesc(name='dr_back',
                                       diffuse_color=(0.8, 0.8, 0.8),
                                       diffuse_tex_id=tid))
    wall = sd.meshes[2]             # the back wall (build_box's third quad)
    wall.mat_indices = np.full(len(wall.indices), back)
    wall.texc = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return sd


def write_dr_box(out_dir: str, width: int = 64, height: int = 48,
                 depth: int = 6) -> str:
    """The DR box (``dr_box_desc``) as a library; returns the XML's
    path."""
    return api.write_library(dr_box_desc(width, height, depth), out_dir)


def dr_tex_slot(scene) -> int:
    """The texture pool slot of the DR box's back-wall texture (either
    package's scene)."""
    def host(a):
        return np.asarray(a.cpu() if hasattr(a, 'cpu') else a)

    w, h = host(scene.textures.width), host(scene.textures.height)
    return int(np.nonzero((w == DR_TEX_SIZE) & (h == DR_TEX_SIZE))[0][0])


def material_ids(path: str) -> dict:
    """{material name: id} of the library at ``path``."""
    with open(path) as f:
        return _material_ids(f.read())


# the DR and camera-plugin goldens (tests/jax_zoo.py dr_box, plugin_box):
# their sizes, depths and seeds, shared with chip_smoke.py
DR_GOLD = dict(width=128, height=128, depth=6)
DR_GOLD_TARGET_SPP = 16     # the target: render.render of the true scene
DR_GOLD_PARAM_SEED = 11     # the texels the gradient is taken at
DR_GOLD_ITERS = 4           # optimize_texture iterations (spp 1, adam2)
IOR_GOLD = dict(width=128, height=96, depth=6)   # the zoo box's glass IOR
IOR_GOLD_REF_SEED = 12
IOR_COLUMN = 50             # 48 + GLASS_FLOAT_IOR in JAX's packed row
PLUGIN_GOLD = dict(width=128, height=96, depth=6)
PLUGIN_GOLD_SPP = 16


def dr_gold_params(size: int) -> np.ndarray:
    """The non-uniform texels [size, 4] the DR golden's gradient is taken
    at."""
    return np.random.default_rng(DR_GOLD_PARAM_SEED).uniform(
        0.2, 1.0, (size, 4)).astype(np.float32)


def ior_gold_ref(n: int) -> np.ndarray:
    """The reference pixels [n, 3] of the glass-IOR golden's loss."""
    return np.random.default_rng(IOR_GOLD_REF_SEED).uniform(
        0.0, 0.5, (n, 3)).astype(np.float32)


def smooth_lanes(loss_at, eps, tol=0.01):
    """Central differences of every lane's loss (``loss_at(step)``: a
    tensor of per-lane losses at the parameter moved by ``step``) at steps
    eps and eps / 2, and the lanes whose loss is smooth over [-eps, eps]:
    the two derivatives agree and the second difference at the centre is
    small, both within ``tol`` (a jump inside the step, where a Fresnel
    choice, a total internal reflection or an edge flips, breaks one of
    them).  Returns (the derivatives at step eps, the smooth lanes)."""
    lp, lm = loss_at(eps), loss_at(-eps)
    lp2, lm2, l0 = loss_at(eps / 2), loss_at(-eps / 2), loss_at(0.0)
    d1 = (lp - lm) / (2 * eps)
    d2 = (lp2 - lm2) / eps
    smooth = ((abs(d1 - d2) <= tol * torch.maximum(abs(d1), abs(d2)) + 1e-3)
              & (abs(lp2 - 2 * l0 + lm2) <= tol * abs(lp2 - lm2) + 1e-9))
    return d1, smooth
