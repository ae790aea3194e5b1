"""In-process scene API: the counterpart of ``hydracore3_tpu/api.py``.

Build a scene from numpy arrays (meshes, materials, textures, lights,
camera, instances, remap lists) and commit it: ``commit()`` writes the
standard Hydra scene library (statex XML, ``.vsgf`` meshes, ``.image4ub`` /
``.image4f`` texture chunks) and loads it through
``scene.build.load_scene``, as the JAX package's ``commit()`` does.  For
the same calls the files are byte for byte the JAX package's, so the same
scene can be checked on a machine without JAX.

The handle accumulates a ``scene.build.SceneDesc``: ``write_library(desc,
out_dir)`` writes any description, and ``scene.build.build_scene(desc)``
loads one without files, from ``library(desc)``.
"""
from __future__ import annotations

import os
import tempfile
from xml.sax.saxutils import escape

import numpy as np

from .scene import build as B
from .scene import vsgf


class HRSceneInst:
    """The scene handle (hydra_api hrSceneInst): accumulates meshes,
    materials, lights, instances; ``commit()`` gives the device scene."""

    def __init__(self):
        self.desc = B.SceneDesc(width=256, height=256, trace_depth=6, spp=16)

    # -- creation ------------------------------------------------------
    def mesh_from_data(self, pos, indices, mat_indices=None, norm=None,
                       texc=None) -> int:
        pos = np.asarray(pos, np.float32)
        indices = np.asarray(indices, np.uint32).reshape(-1, 3)
        if mat_indices is None:
            mat_indices = np.zeros(len(indices), np.uint32)
        self.desc.meshes.append(B.MeshDesc(
            pos=pos, indices=indices, texc=texc, norm=norm,
            mat_indices=np.asarray(mat_indices, np.uint32)))
        return len(self.desc.meshes) - 1

    def material_create(self, **kw) -> int:
        self.desc.materials.append(B.MaterialDesc(**kw))
        return len(self.desc.materials) - 1

    def light_area(self, **kw) -> int:
        self.desc.lights.append(B.AreaLightDesc(**kw))
        return len(self.desc.lights) - 1

    def texture_create(self, data, name: str = 'tex') -> int:
        """A texture from a numpy [H, W, 3|4] array (uint8 sRGB / float32
        linear); returns its id for ``diffuse_tex_id`` / ``light_env``."""
        return self.desc.add_texture(data, name)

    def light_env(self, **kw):
        """The sky light; ``tex_id`` a lat-long map (float32 for importance
        sampling)."""
        self.desc.env = B.EnvLightDesc(**kw)

    def light_point(self, **kw) -> int:
        return self._simple_light('point', kw)

    def light_spot(self, **kw) -> int:
        return self._simple_light('spot', kw)

    def light_sphere(self, **kw) -> int:
        return self._simple_light('sphere', kw)

    def _simple_light(self, kind, kw) -> int:
        # simple lights are numbered after the area lights in lights_lib
        self.desc.simple_lights.append(B.SimpleLightDesc(kind=kind, **kw))
        return len(self.desc.lights) + len(self.desc.simple_lights) - 1

    def remap_list_create(self, pairs) -> int:
        """A material remap list [(from, to), ...] for ``instance_add``'s
        ``rmap_id``."""
        self.desc.remap_lists.append([int(v) for ab in pairs for v in ab])
        return len(self.desc.remap_lists) - 1

    def instance_add(self, mesh_id: int, matrix=None, rmap_id: int = -1
                     ) -> int:
        m = (np.eye(4, dtype=np.float32) if matrix is None
             else np.asarray(matrix, np.float32))
        self.desc.instances.append((mesh_id, m, rmap_id))
        return len(self.desc.instances) - 1

    def camera_set(self, **kw):
        self.desc.camera = B.CameraDesc(**kw)

    def settings_set(self, width=None, height=None, depth=None, spp=None):
        d = self.desc
        d.width = width or d.width
        d.height = height or d.height
        d.trace_depth = depth or d.trace_depth
        d.spp = spp or d.spp

    # -- commit (hr2Commit) --------------------------------------------
    def commit(self, out_dir: str = None, accel: str = 'auto', device=None):
        """Write the scene library into ``out_dir`` (a new temporary
        directory when None) and load it on ``device`` (None: the CUDA
        card).  Returns (scene, meta)."""
        out_dir = out_dir or tempfile.mkdtemp(prefix='hr2_scene_')
        xml_path = write_library(self.desc, out_dir)
        return B.load_scene(xml_path, out_dir, accel=accel,
                            width=self.desc.width, height=self.desc.height,
                            device=device)

    def commit_and_render(self, spp: int = None, integrator: str = 'mispt',
                          out_dir: str = None, device=None):
        """hr2CommitAndRender: commit and render; returns [H, W, 4]."""
        from . import render as R
        scene, meta = self.commit(out_dir, device=device)
        return R.render(scene, meta, spp=spp or self.desc.spp,
                        integrator=integrator)


def hr2_create_scene() -> HRSceneInst:
    """hr2Init / scene-handle creation."""
    return HRSceneInst()


# ---------------------------------------------------------------------------
# The scene library
# ---------------------------------------------------------------------------

def _face_normals_to_vertices(pos3, indices) -> np.ndarray:
    """Vertex normals of a mesh given without them: the sum of its faces'
    cross products, normalized."""
    ind = np.asarray(indices, np.int64).reshape(-1, 3)
    n = np.zeros((len(pos3), 3), np.float32)
    e1 = pos3[ind[:, 1]] - pos3[ind[:, 0]]
    e2 = pos3[ind[:, 2]] - pos3[ind[:, 0]]
    fn = np.cross(e1, e2)
    for k in range(3):
        np.add.at(n, ind[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def _mesh_record(m: B.MeshDesc) -> vsgf.SimpleMesh:
    """The arrays the library's ``.vsgf`` holds for a mesh: positions with
    w = 1, the given or face-averaged normals, zero tangents."""
    pos = np.asarray(m.pos, np.float32)
    if pos.shape[1] == 3:
        pos = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], -1)
    V = len(pos)
    norm = (_face_normals_to_vertices(pos[:, :3], m.indices)
            if m.norm is None else np.asarray(m.norm, np.float32))
    if norm.shape[1] == 3:
        norm = np.concatenate([norm, np.zeros((V, 1), np.float32)], -1)
    texc = (np.zeros((V, 2), np.float32) if m.texc is None
            else np.asarray(m.texc, np.float32))
    return vsgf.SimpleMesh(
        v_pos=pos, v_norm=norm, v_tang=np.zeros((V, 4), np.float32),
        v_texc=texc, indices=np.asarray(m.indices, np.uint32).reshape(-1),
        mat_indices=np.asarray(m.mat_indices, np.uint32).reshape(-1))


def _mstr(m) -> str:
    """A matrix (None: the identity) as the library writes it: 6
    significant digits."""
    m = np.eye(4, dtype=np.float32) if m is None else np.asarray(m, np.float32)
    return ' '.join(f'{v:g}' for v in m.reshape(-1))


def _vals(v) -> str:
    return ' '.join(str(x) for x in v)


def _tex_node(tex_id, tex_matrix) -> str:
    mat_attr = ''
    if tex_matrix is not None:
        mat_attr = ' matrix="' + _vals(tex_matrix) + '"'
    return (f'<texture id="{tex_id}" type="texref"{mat_attr} '
            'addressing_mode_u="wrap" addressing_mode_v="wrap" '
            'filter="linear" />')


def library(desc: B.SceneDesc):
    """The scene library of ``desc``: (statex XML text, the meshes'
    ``vsgf.SimpleMesh`` in geometry_lib order, {texture id: texels}).

    Every area light gets an emissive material, a rect mesh and an
    instance, as the reference HydraAPI writes them (the light_id /
    linst_id linkage)."""
    materials = list(desc.materials)
    meshes = list(desc.meshes)
    light_instances = []  # (mesh id, matrix, light id)
    for i, L in enumerate(desc.lights):
        emis = tuple(c * L.multiplier for c in L.color)
        mat_id = len(materials)
        materials.append(B.MaterialDesc(name=f'{L.name}_material',
                                        emission_color=emis, light_id=i))
        hw, hl = L.half_width, L.half_length
        meshes.append(B.MeshDesc(
            pos=np.array([[-hw, 0, -hl], [hw, 0, -hl], [hw, 0, hl],
                          [-hw, 0, hl]], np.float32),
            indices=np.array([[0, 1, 2], [0, 2, 3]], np.uint32),
            mat_indices=np.array([mat_id, mat_id], np.uint32),
            norm=np.tile(np.array([[0, -1, 0]], np.float32), (4, 1)),
            light_id=i))
        light_instances.append((len(meshes) - 1, L.matrix, i))

    parts = ['<?xml version="1.0"?>', '<textures_lib>']
    for i, T in enumerate(desc.textures):
        h, w = T.data.shape[:2]
        ext, size = ('image4ub', 1) if T.data.dtype == np.uint8 \
            else ('image4f', 4)
        parts.append(
            f'  <texture id="{i}" name="{escape(T.name)}" '
            f'loc="data/tex_{i:05d}.{ext}" offset="8" '
            f'bytesize="{T.data.size * size}" width="{w}" '
            f'height="{h}" channels="4" dl="0" />')
    parts.append('</textures_lib>')

    parts.append('<materials_lib>')
    for i, mat in enumerate(materials):
        lid = f' light_id="{mat.light_id}"' if mat.light_id >= 0 else ''
        parts.append(f'  <material id="{i}" name="{escape(mat.name)}" '
                     f'type="hydra_material"{lid}>')
        if mat.emission_color is not None:
            parts.append('    <emission><color '
                         f'val="{_vals(mat.emission_color)}" /></emission>')
        else:
            tex = (_tex_node(mat.diffuse_tex_id, mat.diffuse_tex_matrix)
                   if mat.diffuse_tex_id >= 0 else '')
            parts.append('    <diffuse brdf_type="lambert"><color '
                         f'val="{_vals(mat.diffuse_color)}">{tex}</color>'
                         '</diffuse>')
            if mat.reflectivity is not None:
                parts.append(
                    '    <reflectivity brdf_type="phong">'
                    f'<color val="{_vals(mat.reflectivity)}" />'
                    f'<glossiness val="{mat.glossiness}" />'
                    '</reflectivity>')
        parts.append('  </material>')
    parts.append('</materials_lib>')

    parts.append('<geometry_lib>')
    for i, m in enumerate(meshes):
        lid = f' light_id="{m.light_id}"' if m.light_id >= 0 else ''
        parts.append(f'  <mesh id="{i}" name="mesh{i}" type="vsgf" '
                     f'loc="data/chunk_{i:05d}.vsgf"{lid} />')
    parts.append('</geometry_lib>')

    def intensity(L):
        return (f'    <intensity><color val="{_vals(L.color)}" />'
                f'<multiplier val="{L.multiplier}" /></intensity>\n')

    parts.append('<lights_lib>')
    for i, L in enumerate(desc.lights):
        parts.append(
            f'  <light id="{i}" name="{escape(L.name)}" type="area" '
            'shape="rect" distribution="diffuse" visible="1">\n'
            f'    <size half_length="{L.half_length}" '
            f'half_width="{L.half_width}" />\n' + intensity(L)
            + '  </light>')
    n_area = len(desc.lights)
    for j, SL in enumerate(desc.simple_lights):
        head = f'  <light id="{n_area + j}" name="{escape(SL.name)}" '
        if SL.kind == 'sphere':
            parts.append(
                head + 'type="area" shape="sphere" distribution="uniform" '
                'visible="0">\n'
                f'    <size radius="{SL.radius}" />\n' + intensity(SL)
                + '  </light>')
            continue
        extra = ''
        if SL.kind == 'spot':
            extra = (f'    <falloff_angle val="{SL.falloff_angle}" />\n'
                     f'    <falloff_angle2 val="{SL.falloff_angle2}" />\n')
        dist = 'spot' if SL.kind == 'spot' else 'uniform'
        parts.append(
            head + f'type="point" shape="point" distribution="{dist}" '
            'visible="0">\n' + extra + intensity(SL) + '  </light>')
    n_lights = n_area + len(desc.simple_lights)
    if desc.env is not None:
        E = desc.env
        tex = _tex_node(E.tex_id, E.tex_matrix) if E.tex_id >= 0 else ''
        parts.append(
            f'  <light id="{n_lights}" name="env" type="sky" '
            'shape="point" distribution="uniform" visible="1">\n'
            f'    <intensity><color val="{_vals(E.color)}">{tex}</color>'
            f'<multiplier val="{E.multiplier}" /></intensity>\n'
            '  </light>')
    parts.append('</lights_lib>')

    cam = desc.camera
    parts.append(
        '<cam_lib>\n'
        '  <camera id="0" name="api camera" type="uvn">\n'
        f'    <fov>{cam.fov}</fov>\n'
        f'    <nearClipPlane>{cam.near}</nearClipPlane>\n'
        f'    <farClipPlane>{cam.far}</farClipPlane>\n'
        f'    <up>{_vals(cam.up)}</up>\n'
        f'    <position>{_vals(cam.pos)}</position>\n'
        f'    <look_at>{_vals(cam.look_at)}</look_at>\n'
        '  </camera>\n'
        '</cam_lib>')

    parts.append(
        '<render_lib>\n'
        '  <render_settings type="HydraModern" id="0">\n'
        f'    <width>{desc.width}</width>\n'
        f'    <height>{desc.height}</height>\n'
        f'    <trace_depth>{desc.trace_depth}</trace_depth>\n'
        f'    <maxRaysPerPixel>{desc.spp}</maxRaysPerPixel>\n'
        '  </render_settings>\n'
        '</render_lib>')

    parts.append('<scenes>\n  <scene id="0" name="api scene">')
    if desc.remap_lists:
        parts.append('    <remap_lists>')
        for rl in desc.remap_lists:
            parts.append(f'      <remap_list val="{_vals(rl)}" />')
        parts.append('    </remap_lists>')
    iid = 0
    for mesh_id, m, *rmap in desc.instances:
        parts.append(f'    <instance id="{iid}" mesh_id="{mesh_id}" '
                     f'rmap_id="{rmap[0] if rmap else -1}" '
                     f'matrix="{_mstr(m)}" />')
        iid += 1
    lights = list(desc.lights) + list(desc.simple_lights)
    for lid, L in enumerate(lights):
        parts.append(f'    <instance_light id="{lid}" light_id="{lid}" '
                     f'matrix="{_mstr(L.matrix)}" lgroup_id="-1" />')
    if desc.env is not None:
        parts.append(f'    <instance_light id="{n_lights}" '
                     f'light_id="{n_lights}" matrix="{_mstr(None)}" '
                     'lgroup_id="-1" />')
    for mesh_id, m, lid in light_instances:
        parts.append(f'    <instance id="{iid}" mesh_id="{mesh_id}" '
                     f'rmap_id="-1" matrix="{_mstr(m)}" '
                     f'light_id="{lid}" linst_id="{lid}" />')
        iid += 1
    parts.append('  </scene>\n</scenes>')
    return ('\n'.join(parts), [_mesh_record(m) for m in meshes],
            {i: T.data for i, T in enumerate(desc.textures)})


def write_library(desc: B.SceneDesc, out_dir: str) -> str:
    """Write the scene library of ``desc`` into ``out_dir``: the statex XML,
    ``data/chunk_*.vsgf`` and ``data/tex_*.image4ub|image4f`` (int32 w, h,
    then the texels).  Returns the XML's path."""
    text, meshes, images = library(desc)
    os.makedirs(os.path.join(out_dir, 'data'), exist_ok=True)
    for i, mesh in enumerate(meshes):
        vsgf.save_vsgf(os.path.join(out_dir, f'data/chunk_{i:05d}.vsgf'),
                       mesh)
    for i, data in images.items():
        ext, dt = (('image4ub', np.uint8) if data.dtype == np.uint8
                   else ('image4f', '<f4'))
        h, w = data.shape[:2]
        with open(os.path.join(out_dir, f'data/tex_{i:05d}.{ext}'),
                  'wb') as f:
            f.write(np.array([w, h], '<i4').tobytes())
            f.write(data.astype(dt).tobytes())
    xml_path = os.path.join(out_dir, 'statex_00001.xml')
    with open(xml_path, 'w') as f:
        f.write(text)
    return xml_path
