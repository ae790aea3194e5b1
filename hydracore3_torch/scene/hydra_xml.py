"""Hydra XML scene-state parser on the standard library's ElementTree.

The counterpart of ``hydracore3_tpu/scene/hydra_xml.py`` (the reference's
LiteScene hydraxml): parses a Hydra ``statex_*.xml`` into plain
dataclasses.  Hydra state files are XML fragments with several top-level
libraries (``textures_lib``, ``materials_lib``, ``geometry_lib``,
``lights_lib``, ``cam_lib``, ``render_lib``, ``scenes``), so the text is
wrapped in a synthetic root before parsing.

ElementTree drops XML comments and processing instructions, as the
reference's pugixml does with its default flags: a comment inside a
library is no material, mesh or light.  (The JAX package's parser yields
comments as children and loads them as phantom entries.)
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional
from xml.etree import ElementTree

import numpy as np


def _mat4_from_string(s: str) -> np.ndarray:
    """Row-major 16 floats -> [4, 4] (hydraxml.cpp:261-276)."""
    vals = [float(x) for x in s.split()]
    return np.array(vals, dtype=np.float32).reshape(4, 4)


def read_val_f(node, default=0.0) -> float:
    """hydra_xml::readval1f: the value in the 'val' attribute or the text."""
    if node is None:
        return default
    v = node.get('val')
    if v is not None:
        return float(v.split()[0])
    if node.text is not None and node.text.strip():
        return float(node.text.split()[0])
    return default


def _read_val_3f(node, default=(0.0, 0.0, 0.0)):
    if node is None:
        return np.array(default, np.float32)
    txt = node.get('val') if node.get('val') is not None else (node.text or '')
    vals = [float(x) for x in txt.split()]
    if len(vals) < 3:
        vals = (vals + list(default))[:3]
    return np.array(vals[:3], np.float32)


def read_color(node, default=(0.0, 0.0, 0.0, 0.0)) -> np.ndarray:
    """GetColorFromNode (integrator_pt_scene_mat.cpp:124-143): float ->
    splat4, float3 -> (xyz, 0), float4 -> as is."""
    if node is None:
        return np.array(default, np.float32)
    txt = node.get('val') if node.get('val') is not None else (node.text or '')
    vals = [float(x) for x in txt.split()]
    if len(vals) == 0:
        return np.array(default, np.float32)
    if len(vals) == 1:
        return np.full(4, vals[0], np.float32)
    if len(vals) == 3:
        return np.array(vals + [0.0], np.float32)
    return np.array(vals[:4], np.float32)


@dataclasses.dataclass
class TextureInfo:
    tex_id: int
    path: str            # resolved path of the chunk or image file
    width: int
    height: int
    bpp: int             # bytes per pixel (4 = rgba8, 16 = rgba32f)
    offset: int          # byte offset of the texels inside the file


@dataclasses.dataclass
class SpectrumInfo:
    spec_id: int
    path: str
    # spectral texture: (wavelength, tex_id) pairs of lambda_ref_ids
    lambda_ref_ids: Optional[np.ndarray] = None
    # inline 'lambda value lambda value ...' spectrum (value attribute)
    inline_value: Optional[str] = None


@dataclasses.dataclass
class MeshInfo:
    mesh_id: int
    path: str
    node: ElementTree.Element
    # 'mesh' -> .vsgf; any other tag is custom geometry
    # (integrator_pt_scene.cpp:818-831)
    tag: str = 'mesh'


@dataclasses.dataclass
class Camera:
    fov: float
    near_plane: float
    far_plane: float
    pos: np.ndarray
    look_at: np.ndarray
    up: np.ndarray
    exposure_mult: float
    has_matrix: bool
    matrix: Optional[np.ndarray]
    node: ElementTree.Element


@dataclasses.dataclass
class Settings:
    width: int
    height: int
    spp: int
    depth: int
    depth_diffuse: int
    node: ElementTree.Element


@dataclasses.dataclass
class Instance:
    inst_id: int
    geom_id: int
    rmap_id: int          # -1 = none
    light_inst_id: int    # -1 = none
    matrix: np.ndarray
    matrix_motion: np.ndarray
    has_motion: bool
    node: ElementTree.Element


@dataclasses.dataclass
class LightInstance:
    inst_id: int
    light_id: int
    matrix: np.ndarray
    light_node: ElementTree.Element
    inst_node: ElementTree.Element


class HydraScene:
    """Parsed scene state; mirrors hydra_xml::HydraScene.  ``text``, when
    given, is parsed in place of the file at ``path`` (then ``scene_dir``
    resolves the library's relative locations)."""

    def __init__(self, path: str, scene_dir: str = '',
                 text: Optional[bytes] = None):
        if text is None:
            with open(path, 'rb') as f:
                text = f.read()
        # strip the xml declaration, wrap the fragments in a synthetic root
        text = re.sub(rb'<\?xml[^>]*\?>', b'', text, count=1)
        root = ElementTree.fromstring(b'<hydra_root>' + text
                                      + b'</hydra_root>')
        self.root = root
        self.scene_dir = (scene_dir if scene_dir
                          else os.path.dirname(os.path.abspath(path)))

        self.textures_lib = root.find('textures_lib')
        self.materials_lib = root.find('materials_lib')
        self.geometry_lib = root.find('geometry_lib')
        self.lights_lib = root.find('lights_lib')
        self.cam_lib = root.find('cam_lib')
        self.render_lib = root.find('render_lib')
        self.spectra_lib = root.find('spectra_lib')
        self.scenes_node = root.find('scenes')

    # -- libraries ---------------------------------------------------------

    def textures(self) -> list[TextureInfo]:
        res = []
        if self.textures_lib is None:
            return res
        for node in self.textures_lib.findall('texture'):
            loc = node.get('loc') or node.get('path') or ''
            w = int(node.get('width', '0'))
            h = int(node.get('height', '0'))
            bytesize = int(node.get('bytesize', '0'))
            bpp = bytesize // max(w * h, 1) if w * h > 0 else 4
            res.append(TextureInfo(
                tex_id=int(node.get('id', '0')),
                path=os.path.join(self.scene_dir, loc),
                width=w, height=h, bpp=bpp,
                offset=int(node.get('offset', '0'))))
        return res

    def spectra(self) -> list[SpectrumInfo]:
        res = []
        if self.spectra_lib is None:
            return res
        for node in self.spectra_lib.findall('spectrum'):
            loc = node.get('loc') or ''
            refs = node.get('lambda_ref_ids')
            refs_arr = None
            if refs is not None:
                vals = np.array([float(x) for x in refs.split()], np.float32)
                refs_arr = vals.reshape(-1, 2)
            res.append(SpectrumInfo(
                spec_id=int(node.get('id', '0')),
                path=os.path.join(self.scene_dir, loc),
                lambda_ref_ids=refs_arr,
                inline_value=node.get('value')))
        return res

    def material_nodes(self) -> list[ElementTree.Element]:
        if self.materials_lib is None:
            return []
        return list(self.materials_lib)

    def geom_nodes(self) -> list[MeshInfo]:
        res = []
        if self.geometry_lib is None:
            return res
        for node in self.geometry_lib:
            loc = node.get('loc') or ''
            res.append(MeshInfo(
                mesh_id=int(node.get('id', '0')),
                path=os.path.join(self.scene_dir, loc),
                node=node, tag=str(node.tag)))
        return res

    def light_nodes(self) -> list[ElementTree.Element]:
        if self.lights_lib is None:
            return []
        return list(self.lights_lib)

    def cameras(self) -> list[Camera]:
        res = []
        if self.cam_lib is None:
            return res
        for node in self.cam_lib.findall('camera'):
            mat_node = node.find('matrix')
            has_matrix = mat_node is not None
            matrix = None
            if has_matrix:
                # stored transposed (hydraxml.h:219)
                matrix = _mat4_from_string(mat_node.get('val')).T
            res.append(Camera(
                fov=read_val_f(node.find('fov'), 45.0),
                near_plane=read_val_f(node.find('nearClipPlane'), 0.01),
                far_plane=read_val_f(node.find('farClipPlane'), 100.0),
                pos=_read_val_3f(node.find('position')),
                look_at=_read_val_3f(node.find('look_at')),
                up=_read_val_3f(node.find('up'), (0.0, 1.0, 0.0)),
                exposure_mult=read_val_f(node.find('exposure_mult'), 1.0),
                has_matrix=has_matrix, matrix=matrix, node=node))
        return res

    def settings(self) -> list[Settings]:
        res = []
        if self.render_lib is None:
            return res
        for node in self.render_lib.findall('render_settings'):
            res.append(Settings(
                width=int(read_val_f(node.find('width'), 1024)),
                height=int(read_val_f(node.find('height'), 1024)),
                spp=int(read_val_f(node.find('maxRaysPerPixel'), 0)),
                depth=int(read_val_f(node.find('trace_depth'), 0)),
                depth_diffuse=int(read_val_f(node.find('diff_trace_depth'),
                                             0)),
                node=node))
        return res

    # -- scene instances ---------------------------------------------------

    def _first_scene(self):
        return (self.scenes_node.find('scene')
                if self.scenes_node is not None else None)

    def instances_geom(self) -> list[Instance]:
        scene = self._first_scene()
        res = []
        if scene is None:
            return res
        for node in scene.findall('instance'):
            matrix = _mat4_from_string(node.get('matrix'))
            motion_node = node.find('motion')
            has_motion = motion_node is not None
            matrix_motion = (_mat4_from_string(motion_node.get('matrix'))
                             if has_motion else matrix.copy())
            linst = node.get('linst_id')
            res.append(Instance(
                inst_id=int(node.get('id', '0')),
                geom_id=int(node.get('mesh_id', '0')),
                rmap_id=int(node.get('rmap_id', '-1')),
                light_inst_id=int(linst) if linst is not None else -1,
                matrix=matrix, matrix_motion=matrix_motion,
                has_motion=has_motion, node=node))
        return res

    def instances_lights(self) -> list[LightInstance]:
        scene = self._first_scene()
        res = []
        if scene is None:
            return res
        lights = self.light_nodes()
        for node in scene.findall('instance_light'):
            light_id = int(node.get('light_id', '0'))
            res.append(LightInstance(
                inst_id=int(node.get('id', '0')),
                light_id=light_id,
                matrix=_mat4_from_string(node.get('matrix')),
                light_node=lights[light_id],
                inst_node=node))
        return res

    def remap_lists(self) -> list[list[int]]:
        scene = self._first_scene()
        res = []
        if scene is None:
            return res
        rl = scene.find('remap_lists')
        if rl is None:
            return res
        for node in rl.findall('remap_list'):
            val = node.get('val') or (node.text or '')
            res.append([int(x) for x in val.split()])
        return res
