"""Scene build: a Hydra XML scene library or an in-memory description ->
flat device tables.

The counterpart of ``hydracore3_tpu/scene/build.py``.  The build runs in
two stages, and both entry points share the second:

* the records (``_Records``): material records, light rows and the env,
  meshes, instances with their remap-list and light ids, the remap lists,
  the camera and the settings.  ``load_scene`` reads them from a Hydra XML
  library (``scene/hydra_xml.py``; meshes through ``scene/vsgf.py``,
  textures through ``ops/texture.py``'s chunk reader).  ``build_scene``
  reads them from an in-memory ``SceneDesc`` (what ``api.HRSceneInst``
  accumulates) through the same loaders: it takes the library text
  ``api.write_library`` would write for the description (the area lights'
  emissive quads, the 6-digit instance matrices, the old-Hydra material
  nodes) and hands the loaders the meshes and textures in memory instead
  of their files, so a description built directly and the same
  description committed through ``api`` give the same tables;
* the tables (``_tables``): the ``'auto'`` routes, the BVHs, the stream,
  grid, cluster and TLAS packs and the wide tables the card walks.

The routes of the JAX build (``accel='auto'``): an instanced scene whose
flattened soup would pass 200,000 triangles and twice its unique triangles
keeps every mesh once, in object space, under a TLAS over its instances
(``use_stream_tlas``; no world soup is built); a soup of 4096 to 175,000
triangles gets the unpadded cluster BVH (``use_pallas``); a larger one is
streamed (``use_stream``); a smaller one takes the small-scene branch: the
soup in the leaf order of a 4-triangle-leaf BVH and no cluster BVH or grid.

Loaded: old-Hydra materials (every branch of ``ConvertOldHydraMaterial``:
lambert, lambert|metal, metal, fresnel coat, transparency -> glass,
emission -> light source) and GLTF materials with their metal-roughness
texture slots; a material of an unknown type becomes a gray lambert, as in
the JAX package.  Sky (constant or textured, importance-sampled when its
texture is float), directional, rect, disk, sphere and point lights.  A
pinhole camera with ``cam_id``, ``look_at_override`` and an RGB sensor
multiplier.  VSGF meshes and custom geometry (a box over its bounds),
instances with remap lists.  What the port does not load yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item: the other material
types (queue 1, item 4); spot and IES lights, bump maps, motion, depth of
field, the lens stack, spectral data and spectral mode (item 5).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from . import hydra_xml
from . import vsgf
from ..ops import texture as TEX
from ..utils import lmath

# Material type ids (include/cmaterial.h:38-46)
MAT_TYPE_GLTF = 1
MAT_TYPE_GLASS = 2
MAT_TYPE_CONDUCTOR = 3
MAT_TYPE_DIFFUSE = 4
MAT_TYPE_PLASTIC = 5
MAT_TYPE_BLEND = 6
MAT_TYPE_DIELECTRIC = 7
MAT_TYPE_THIN_FILM = 8
MAT_TYPE_LIGHT_SOURCE = 0xEFFFFFFF
# f32-exact small code of MAT_TYPE_LIGHT_SOURCE in the megakernel's tables
MTYPE_SMALL_LIGHT = 9

# GLTF component flags (cmaterial.h:26-36)
GLTF_COMPONENT_LAMBERT = 1
GLTF_COMPONENT_COAT = 2
GLTF_COMPONENT_METAL = 4
GLTF_COMPONENT_ORENNAYAR = 16
FLAG_FOUR_TEXTURES = 256
FLAG_PACK_FOUR_PARAMS_IN_TEXTURE = 512
FLAG_INVERT_GLOSINESS = 1024

# Color slots (cmaterial.h:67-180)
GLTF_COLOR_BASE = 0
GLTF_COLOR_COAT = 1
GLTF_COLOR_METAL = 2
EMISSION_COLOR = 0
GLASS_COLOR_REFLECT = 0
GLASS_COLOR_TRANSP = 1

# Custom data slots
GLTF_FLOAT_MI_FDR_INT = 0
GLTF_FLOAT_MI_FDR_EXT = 1
GLTF_FLOAT_MI_SSW = 2
GLTF_FLOAT_ALPHA = 3
GLTF_FLOAT_GLOSINESS = 4
GLTF_FLOAT_IOR = 5
GLTF_FLOAT_ROUGH_ORENNAYAR = 6
GLTF_FLOAT_REFL_COAT = 7
EMISSION_MULT = 0
GLASS_FLOAT_GLOSS_REFLECT = 0
GLASS_FLOAT_GLOSS_TRANSP = 1
GLASS_FLOAT_IOR = 2

# Light geometry / distribution (include/clight.h:5-17)
LIGHT_GEOM_RECT = 1
LIGHT_GEOM_DISC = 2
LIGHT_GEOM_SPHERE = 3
LIGHT_GEOM_DIRECT = 4
LIGHT_GEOM_POINT = 5
LIGHT_GEOM_ENV = 6
LIGHT_DIST_LAMBERT = 0
LIGHT_DIST_OMNI = 1

# below this many triangles the soup stays brute-traced
# (hydracore3_tpu/scene/build.py:1348-1352)
SMALL_SCENE_TRIS = 4096

INVALID_ID = 0xFFFFFFFF

# where ROADMAP.md keeps what is not ported yet
ITEM_MATERIALS = 'ROADMAP.md queue 1, item 4'
ITEM_LIGHTS_SPECTRAL = 'ROADMAP.md queue 1, item 5'


def _not_ported(what: str, item: str = ITEM_LIGHTS_SPECTRAL):
    return NotImplementedError(f'{what} is not ported ({item})')


# ---------------------------------------------------------------------------
# Scene description (what api.HRSceneInst accumulates)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshDesc:
    pos: np.ndarray                    # [V, 3] f32
    indices: np.ndarray                # [T, 3] int
    mat_indices: np.ndarray            # [T] int
    texc: Optional[np.ndarray] = None  # [V, 2] f32
    norm: Optional[np.ndarray] = None  # [V, 3|4] f32 (face-averaged if None)
    light_id: int = -1                 # an area light's emissive quad


@dataclasses.dataclass
class MaterialDesc:
    name: str = 'mat'
    diffuse_color: tuple = (0.5, 0.5, 0.5)
    diffuse_tex_id: int = -1
    diffuse_tex_matrix: Optional[tuple] = None   # 8 floats (row0, row1)
    emission_color: Optional[tuple] = None
    reflectivity: Optional[tuple] = None   # phong specular color
    glossiness: float = 1.0
    light_id: int = -1


@dataclasses.dataclass
class TextureDesc:
    """[H, W, 4] uint8 (sRGB, written as .image4ub) or float32 (linear,
    written as .image4f)."""
    name: str = 'tex'
    data: np.ndarray = None


@dataclasses.dataclass
class AreaLightDesc:
    name: str = 'light'
    color: tuple = (1.0, 1.0, 1.0)
    multiplier: float = 1.0
    half_width: float = 1.0
    half_length: float = 1.0
    matrix: Optional[np.ndarray] = None


@dataclasses.dataclass
class SimpleLightDesc:
    """A light without geometry: kind 'point' (omni), 'sphere' or 'spot'
    (written, but not loaded)."""
    kind: str = 'point'
    name: str = 'light'
    color: tuple = (1.0, 1.0, 1.0)
    multiplier: float = 1.0
    radius: float = 1.0               # sphere only
    falloff_angle: float = 60.0       # spot outer cone (deg)
    falloff_angle2: float = 30.0      # spot inner cone (deg)
    matrix: Optional[np.ndarray] = None


@dataclasses.dataclass
class EnvLightDesc:
    color: tuple = (1.0, 1.0, 1.0)
    multiplier: float = 1.0
    tex_id: int = -1
    tex_matrix: Optional[tuple] = None


@dataclasses.dataclass
class CameraDesc:
    fov: float = 45.0
    pos: tuple = (0.0, 0.0, 15.0)
    look_at: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    near: float = 0.01
    far: float = 100.0


@dataclasses.dataclass
class SceneDesc:
    meshes: list = dataclasses.field(default_factory=list)
    materials: list = dataclasses.field(default_factory=list)
    textures: list = dataclasses.field(default_factory=list)  # TextureDesc
    lights: list = dataclasses.field(default_factory=list)   # area lights
    simple_lights: list = dataclasses.field(default_factory=list)
    env: Optional[EnvLightDesc] = None
    # (mesh id, matrix or None[, remap list id])
    instances: list = dataclasses.field(default_factory=list)
    # flat (from, to, from, to, ...) material id lists
    remap_lists: list = dataclasses.field(default_factory=list)
    camera: CameraDesc = dataclasses.field(default_factory=CameraDesc)
    width: int = 256
    height: int = 256
    trace_depth: int = 6
    spp: int = 16

    def add_texture(self, data: np.ndarray, name: str = 'tex') -> int:
        """[H, W, 3|4] uint8 (sRGB) or float (linear) -> texture id."""
        data = np.asarray(data)
        if data.ndim != 3 or data.shape[2] not in (3, 4):
            raise ValueError('texture data must be [H, W, 3|4]')
        if data.shape[2] == 3:
            alpha = (np.full(data.shape[:2] + (1,), 255, np.uint8)
                     if data.dtype == np.uint8
                     else np.ones(data.shape[:2] + (1,), np.float32))
            data = np.concatenate([data, alpha], axis=2)
        if data.dtype != np.uint8:
            data = data.astype(np.float32)
        self.textures.append(TextureDesc(name=name, data=data))
        return len(self.textures) - 1


# ---------------------------------------------------------------------------
# Device tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene facts."""
    width: int
    height: int
    trace_depth: int
    spp: int
    num_lights: int
    num_materials: int
    has_env_map: bool
    env_enable_sam: bool
    num_tris: int
    exposure_mult: float = 1.0
    use_stream: bool = True
    use_stream_tlas: bool = False    # instanced: TLAS over per-mesh BVHs
    use_pallas: bool = False         # mid-size soup: unpadded cluster BVH
    mat_types_present: tuple = ()
    light_geom_types: tuple = ()     # per light, in table order
    # every material's slot-0 texture is 1x1: taps fold to constants
    tex0_all_const: bool = False
    has_cam_back: bool = False       # a camera-back texture (the sky's back)
    has_four_textures: bool = False  # a GLTF material's slot-2/3 maps


@dataclasses.dataclass(frozen=True)
class Scene:
    # materials [M, ...]
    mat_mtype: torch.Tensor       # i64 (u32 values)
    mat_cflags: torch.Tensor      # i64
    mat_texid: torch.Tensor       # [M, 4] i64 (-1 invalid)
    mat_colors: torch.Tensor      # [M, 4, 4] f32
    mat_row0: torch.Tensor        # [M, 4, 4] f32
    mat_row1: torch.Tensor        # [M, 4, 4] f32
    mat_data: torch.Tensor        # [M, 16] f32
    # lights [L, ...]
    light_pos: torch.Tensor
    light_norm: torch.Tensor
    light_intensity: torch.Tensor
    light_matrix: torch.Tensor
    light_sam_row0: torch.Tensor
    light_sam_row1: torch.Tensor
    light_sam_row0_inv: torch.Tensor
    light_sam_row1_inv: torch.Tensor
    light_size: torch.Tensor
    light_pdf_a: torch.Tensor
    light_mult: torch.Tensor
    light_geom_type: torch.Tensor
    light_dist_type: torch.Tensor
    light_pdf_table_offset: torch.Tensor
    light_pdf_table_size_x: torch.Tensor
    light_pdf_table_size_y: torch.Tensor
    light_tex_id: torch.Tensor
    light_ies_id: torch.Tensor
    # the world-space soup [T, ...]: padded leaf-cluster order when
    # streamed, cluster-BVH leaf order for mid-size scenes, one zero row for
    # two-level (TLAS) scenes, which keep no world soup
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_inst_id: torch.Tensor
    tri_geom_id: torch.Tensor
    tri_prim_id: torch.Tensor
    # [Tpad, 32]: 3 x (norm3, tx, tang3, ty), matId in column 24 (the
    # instance's remap list applied)
    tri_shade: torch.Tensor
    remap_inst: torch.Tensor      # [I, 2] i64 (remap list, light id)
    # remap lists: (from, to) pairs sorted by from, all lists concatenated,
    # then their offsets (starting at all_remap_lists_size)
    all_remap_lists: torch.Tensor     # i64
    all_remap_lists_size: int
    arrays1f: torch.Tensor        # f32 env pdf tables
    env_color: torch.Tensor       # [4]
    env_tex_id: torch.Tensor      # scalar i64
    env_sam_row0: torch.Tensor
    env_sam_row1: torch.Tensor
    env_light_id: torch.Tensor    # scalar i64
    env_cam_back_id: torch.Tensor  # scalar i64 (-1: none)
    proj_inv: torch.Tensor        # [4, 4]
    world_view_inv: torch.Tensor  # [4, 4]
    cam_response_rgb: torch.Tensor
    textures: TEX.TexturePool
    # [M, 4] slot-0 texel per material when meta.tex0_all_const, else None
    mat_tex0_const: Optional[torch.Tensor]
    # streamed cluster BVH and its grid (kernel tables, i32/f32); None for
    # small scenes
    st_nodes_f: Optional[torch.Tensor]      # [M, 8] f32
    st_nodes_i: Optional[torch.Tensor]      # [M, 4] i32
    st_woop: Optional[torch.Tensor]         # [C * 64, 12] f32
    st_grid: object               # accel.traverse_dda.GridPack or None
    # what the card's streamed kernels (K2, K3) walk, derived from st_*:
    # accel.wide_bvh.WidePack (pack_wide_stream) or None
    st_wide: object = None
    # mid-size soups: the unpadded cluster BVH (meta.use_pallas), else None
    # (the node tables stay on the host: nothing on a card reads them)
    cl_nodes_f: Optional[torch.Tensor] = None   # [M, 8] f32
    cl_nodes_i: Optional[torch.Tensor] = None   # [M, 4] i32 (skip, toff, tcnt)
    cl_tris12: Optional[torch.Tensor] = None    # [T, 12] f32 (v0, e1, e2)
    # what the card's cluster kernel walks, derived from cl_tris12
    cl_wide: object = None                      # accel.wide_bvh.WidePack
    # two-level scenes (meta.use_stream_tlas), else None: the kernel's
    # tables and, per padded leaf slot of the per-mesh BVHs, OBJECT-space
    # shade rows (the UNREMAPPED material id in column 24), mesh id and the
    # mesh's primitive id; per instance the normal matrix
    tt: object = None                           # accel.traverse_tlas.TlasPack
    tt_shade: Optional[torch.Tensor] = None     # [C * 64, 32] f32
    tt_geom: Optional[torch.Tensor] = None      # [C * 64] i64
    tt_prim: Optional[torch.Tensor] = None      # [C * 64] i64
    tt_inst_nm: Optional[torch.Tensor] = None   # [I, 16] f32

    def to_numpy(self) -> dict:
        """Every table as a numpy array (texture pool and grid flattened)."""
        out = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, torch.Tensor):
                out[f.name] = val.cpu().numpy()
        for f in dataclasses.fields(self.textures):
            out['tex_' + f.name] = getattr(self.textures, f.name).cpu().numpy()
        if self.tt is not None:
            for f in dataclasses.fields(self.tt):
                if f.name != 'wide':
                    out['tt_' + f.name] = getattr(self.tt,
                                                  f.name).cpu().numpy()
        g = self.st_grid
        if g is None:
            return out
        for k in ('cell_tab', 'cell_cl', 'cl_aabb', 'outliers'):
            out['grid_' + k] = getattr(g, k).cpu().numpy()
        out['grid_lo'] = np.array(g.lo)
        out['grid_h'] = np.array(g.h)
        out['grid_dims'] = np.array(g.dims)
        return out


# ---------------------------------------------------------------------------
# Textures and materials (integrator_pt_scene_tex.cpp, _mat.cpp)
# ---------------------------------------------------------------------------

class TexCache:
    """(texture id, sampler) -> pool slot, like the reference's texCache
    keyed by HydraSampler (integrator_pt_scene_tex.cpp:107-131).
    ``images`` ({texture id: [H, W, 4] uint8 or float32}) stands in for
    the library's texture files."""

    def __init__(self, infos: list, images: Optional[dict] = None):
        self.infos = {i.tex_id: i for i in infos}
        self.images = images or {}
        self.pool = TEX.TexturePoolBuilder()
        self.cache: dict[tuple, int] = {}

    def _load(self, info, srgb: bool) -> np.ndarray:
        if info.tex_id in self.images:
            return TEX.decode_image(self.images[info.tex_id],
                                    srgb and info.bpp <= 4)
        path = info.path
        if '.image' in path:
            return TEX.decode_chunk(path, info.width, info.height, info.bpp,
                                    info.offset, srgb and info.bpp <= 4)
        return TEX.load_image_file(path, srgb)

    def slot_from_node(self, color_node):
        """ReadSamplerFromColorNode + LoadTextureFromNode: (slot, row0,
        row1); slot 0 (white) when there is no texture node."""
        row0 = np.array([1, 0, 0, 0], np.float32)
        row1 = np.array([0, 1, 0, 0], np.float32)
        if color_node is None:
            return 0, row0, row1
        tnode = color_node.find('texture')
        if tnode is None:
            return 0, row0, row1
        tex_id = int(tnode.get('id', '0'))
        addr_u = TEX.addr_mode_from_string(tnode.get('addressing_mode_u',
                                                     'wrap'))
        addr_v = TEX.addr_mode_from_string(tnode.get('addressing_mode_v',
                                                     'wrap'))
        filt = (TEX.FILTER_NEAREST
                if tnode.get('filter', 'linear') in ('point', 'nearest')
                else TEX.FILTER_LINEAR)
        disable_gamma = tnode.get('input_gamma') == '1'
        mat_attr = tnode.get('matrix')
        if mat_attr is not None:
            vals = [float(x) for x in mat_attr.split()]
            row0 = np.array(vals[0:4], np.float32)
            row1 = np.array(vals[4:8], np.float32)
        key = (tex_id, addr_u, addr_v, filt, disable_gamma)
        if key not in self.cache:
            info = self.infos.get(tex_id)
            if info is None:
                self.cache[key] = 0
            else:
                img = self._load(info, srgb=not disable_gamma)
                self.cache[key] = self.pool.add(img, filt, addr_u, addr_v)
        return self.cache[key], row0, row1


class MaterialRec:
    """Host mirror of the reference ``struct Material`` (cmaterial.h)."""

    def __init__(self):
        self.mtype = 0
        self.cflags = 0
        self.light_id = INVALID_ID
        self.texid = [0, 0, 0, 0]
        self.colors = np.zeros((4, 4), np.float32)
        self.row0 = np.tile(np.array([1, 0, 0, 0], np.float32), (4, 1))
        self.row1 = np.tile(np.array([0, 1, 0, 0], np.float32), (4, 1))
        self.data = np.zeros(16, np.float32)

    def set_tex(self, k: int, slot_rows):
        self.texid[k], self.row0[k], self.row1[k] = slot_rows


def _fdr(eta: float) -> float:
    """mi::fresnel_diffuse_reflectance (mi_materials.cpp:104-130)."""
    inv_eta = 1.0 / eta
    approx_1 = 0.0636 * inv_eta + (eta * (eta * -1.4399 + 0.7099) + 0.6681)
    coeffs = [0.919317, -3.4793, 6.75335, -7.80989, 4.98554, -1.36881]
    approx_2 = 0.0
    for c in reversed(coeffs):
        approx_2 = approx_2 * inv_eta + c
    return approx_1 if eta < 1.0 else approx_2


def set_mi_plastic(mat: MaterialRec, int_ior, ext_ior, diffuse_refl,
                   spec_refl):
    """mi_materials.cpp:455-469."""
    mat.colors[GLTF_COLOR_BASE] = diffuse_refl
    mat.colors[GLTF_COLOR_COAT] = spec_refl
    m_eta = int_ior / ext_ior
    mat.data[GLTF_FLOAT_IOR] = m_eta
    mat.data[GLTF_FLOAT_MI_FDR_INT] = _fdr(1.0 / m_eta)
    mat.data[GLTF_FLOAT_MI_FDR_EXT] = _fdr(m_eta)
    d_mean = float(np.mean(diffuse_refl[:3]))
    s_mean = float(np.mean(spec_refl[:3]))
    mat.data[GLTF_FLOAT_MI_SSW] = s_mean / max(d_mean + s_mean, 1e-20)


_read1f = hydra_xml.read_val_f
_read_color = hydra_xml.read_color


def convert_old_hydra_material(node, tc: TexCache) -> MaterialRec:
    """ConvertOldHydraMaterial (integrator_pt_scene_mat.cpp:280-452;
    hydracore3_tpu/scene/build.py:248-364)."""
    mat = MaterialRec()
    mat.mtype = MAT_TYPE_GLTF
    mat.data[GLTF_FLOAT_ALPHA] = 0.0
    mat.data[GLTF_FLOAT_REFL_COAT] = 1.0
    mat.colors[GLTF_COLOR_COAT] = (1, 1, 1, 1)
    mat.colors[GLTF_COLOR_METAL] = (0, 0, 0, 0)
    mat.data[EMISSION_MULT] = 1.0

    emiss = node.find('emission')
    color = np.zeros(4, np.float32)
    is_emission = False
    if node.get('light_id') is not None or emiss is not None:
        emiss_color_node = emiss.find('color') if emiss is not None else None
        color = _read_color(emiss_color_node)
        is_emission = (node.get('light_id') is not None
                       or float(np.linalg.norm(color)) > 1e-5)
        mat.set_tex(0, tc.slot_from_node(emiss_color_node))
        mat.colors[EMISSION_COLOR] = color
        mat.light_id = (int(node.get('light_id'))
                        if node.get('light_id') is not None else INVALID_ID)
        if emiss_color_node is not None:
            mult_node = emiss_color_node.find('multiplier')
            mat.data[EMISSION_MULT] = (_read1f(mult_node, 1.0)
                                       if mult_node is not None else 1.0)
        mat.mtype = MAT_TYPE_LIGHT_SOURCE

    diff_color_node = node.find('diffuse/color')
    if diff_color_node is not None:
        color = _read_color(diff_color_node)
        if diff_color_node.find('texture') is not None:
            mat.set_tex(0, tc.slot_from_node(diff_color_node))

    refl_color = np.zeros(4, np.float32)
    refl_gloss = 1.0
    fresnel_ior = 1.5
    refl = node.find('reflectivity')
    if refl is not None:
        refl_color = _read_color(refl.find('color'))
        refl_gloss = _read1f(refl.find('glossiness'), 1.0)
        fresnel_ior = _read1f(refl.find('fresnel_ior'), 1.5)

    transp_color = np.zeros(4, np.float32)
    transp_gloss, transp_ior = 1.0, 1.5
    transp = node.find('transparency')
    if transp is not None:
        transp_color = _read_color(transp.find('color'))
        transp_gloss = _read1f(transp.find('glossiness'), 1.0)
        transp_ior = _read1f(transp.find('ior'), 1.5)

    has_fresnel = False
    if refl is not None:
        fr = refl.find('fresnel')
        has_fresnel = fr is not None and fr.get('val') not in (None, '0')
    if not has_fresnel:
        fresnel_ior = 0.0

    ln_refl = float(np.linalg.norm(refl_color))
    ln_col3 = float(np.linalg.norm(color[:3]))

    if (ln_refl > 1e-5 and ln_col3 > 1e-5) or has_fresnel:
        mat.mtype = MAT_TYPE_GLTF
        mat.light_id = INVALID_ID
        mat.colors[GLTF_COLOR_BASE] = color
        mat.colors[GLTF_COLOR_COAT] = refl_color
        if has_fresnel:
            mat.data[GLTF_FLOAT_ALPHA] = 0.0
            mat.data[GLTF_FLOAT_REFL_COAT] = 1.0
            mat.colors[GLTF_COLOR_METAL] = (0, 0, 0, 0)
            mat.cflags = GLTF_COMPONENT_LAMBERT | GLTF_COMPONENT_COAT
            set_mi_plastic(mat, fresnel_ior, 1.0, color, refl_color)
        else:
            mat.data[GLTF_FLOAT_ALPHA] = ln_refl / (ln_refl + ln_col3)
            mat.data[GLTF_FLOAT_REFL_COAT] = 0.0
            mat.colors[GLTF_COLOR_COAT] = (0, 0, 0, 0)
            mat.colors[GLTF_COLOR_METAL] = refl_color
            mat.cflags = GLTF_COMPONENT_LAMBERT | GLTF_COMPONENT_METAL
    elif ln_refl > 1e-5:
        mat.mtype = MAT_TYPE_GLTF
        mat.cflags = GLTF_COMPONENT_METAL
        mat.colors[GLTF_COLOR_BASE] = refl_color
        mat.colors[GLTF_COLOR_METAL] = (1, 1, 1, 1)
        mat.colors[GLTF_COLOR_COAT] = (0, 0, 0, 0)
        mat.data[GLTF_FLOAT_ALPHA] = 1.0
    elif ln_col3 > 1e-5:
        mat.mtype = MAT_TYPE_GLTF
        mat.cflags = GLTF_COMPONENT_LAMBERT
        mat.colors[GLTF_COLOR_BASE] = color
        mat.colors[GLTF_COLOR_COAT] = (0, 0, 0, 0)
        mat.colors[GLTF_COLOR_METAL] = (0, 0, 0, 0)
        mat.data[GLTF_FLOAT_ALPHA] = 0.0
        mat.data[GLTF_FLOAT_REFL_COAT] = 0.0

    if float(np.linalg.norm(transp_color)) > 1e-5:
        mat.mtype = MAT_TYPE_GLASS
        mat.colors[GLTF_COLOR_BASE] = refl_color
        mat.colors[GLASS_COLOR_REFLECT] = refl_color
        mat.colors[GLASS_COLOR_TRANSP] = transp_color
        mat.data[GLASS_FLOAT_GLOSS_REFLECT] = refl_gloss
        mat.data[GLASS_FLOAT_GLOSS_TRANSP] = transp_gloss
        mat.data[GLASS_FLOAT_IOR] = (fresnel_ior if fresnel_ior != 0.0
                                     else transp_ior)

    if is_emission:
        mat.mtype = MAT_TYPE_LIGHT_SOURCE

    rough_node = node.find('diffuse/roughness')
    if rough_node is not None:
        mat.data[GLTF_FLOAT_ROUGH_ORENNAYAR] = _read1f(rough_node)
        mat.cflags |= GLTF_COMPONENT_ORENNAYAR

    mat.data[GLTF_FLOAT_GLOSINESS] = refl_gloss
    # the fresnel coat keeps set_mi_plastic's ratio of iors
    if mat.mtype != MAT_TYPE_GLTF or not has_fresnel:
        mat.data[GLTF_FLOAT_IOR] = fresnel_ior
    return mat


def convert_gltf_material(node, tc: TexCache) -> MaterialRec:
    """ConvertGLTFMaterial (integrator_pt_scene_mat.cpp:176-278;
    hydracore3_tpu/scene/build.py:367-435)."""
    mat = MaterialRec()
    mat.mtype = MAT_TYPE_GLTF
    mat.cflags = GLTF_COMPONENT_LAMBERT | GLTF_COMPONENT_COAT
    mat.data[GLTF_FLOAT_ALPHA] = 0.0
    mat.data[GLTF_FLOAT_REFL_COAT] = 1.0
    mat.data[EMISSION_MULT] = 1.0

    fresnel_ior, refl_gloss, metalness = 1.5, 1.0, 0.0
    base_color = np.ones(4, np.float32)

    cnode = node.find('color')
    if cnode is not None:
        base_color = _read_color(cnode)
        if cnode.find('texture') is not None:
            mat.set_tex(0, tc.slot_from_node(cnode))

    gnode = node.find('glossiness')
    rnode = node.find('roughness')
    if gnode is not None:
        refl_gloss = _read1f(gnode, 1.0)
        if gnode.find('texture') is not None:
            mat.set_tex(2, tc.slot_from_node(gnode))
            mat.cflags |= FLAG_FOUR_TEXTURES
    elif rnode is not None:
        refl_gloss = _read1f(rnode, 1.0)
        mat.cflags |= FLAG_INVERT_GLOSINESS
        if rnode.find('texture') is not None:
            mat.set_tex(2, tc.slot_from_node(rnode))
            mat.cflags |= FLAG_FOUR_TEXTURES

    mnode = node.find('metalness')
    if mnode is not None:
        metalness = _read1f(mnode, 0.0)
        if mnode.find('texture') is not None:
            mat.set_tex(3, tc.slot_from_node(mnode))
            mat.cflags |= FLAG_FOUR_TEXTURES

    if node.find('fresnel_ior') is not None:
        fresnel_ior = _read1f(node.find('fresnel_ior'), 1.5)
    if node.find('coat') is not None:
        mat.data[GLTF_FLOAT_REFL_COAT] = _read1f(node.find('coat'), 1.0)

    gmc = node.find('glossiness_metalness_coat')
    if gmc is not None:
        val = _read1f(gmc)
        metalness = refl_gloss = val
        mat.data[GLTF_FLOAT_REFL_COAT] = val
        if gmc.find('texture') is not None:
            mat.set_tex(2, tc.slot_from_node(gmc))
            mat.cflags |= FLAG_FOUR_TEXTURES | FLAG_PACK_FOUR_PARAMS_IN_TEXTURE

    mat.colors[GLTF_COLOR_BASE] = base_color
    mat.colors[GLTF_COLOR_METAL] = (1, 1, 1, 1)
    mat.colors[GLTF_COLOR_COAT] = (1, 1, 1, 1)
    mat.data[GLTF_FLOAT_ALPHA] = metalness
    mat.data[GLTF_FLOAT_GLOSINESS] = refl_gloss
    set_mi_plastic(mat, fresnel_ior, 1.0, base_color, np.ones(4, np.float32))
    return mat


# the JAX package's other loaders, each to land with its BSDF
_UNPORTED_MATERIALS = ('rough_conductor', 'diffuse', 'dielectric', 'plastic',
                       'thin_film', 'blend')


# ---------------------------------------------------------------------------
# The records: XML -> materials, lights, meshes, instances, camera
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Records:
    width: int
    height: int
    trace_depth: int
    spp: int
    tc: TexCache
    materials: list         # MaterialRec
    lights: list            # light rows (_light_row)
    env: dict
    arrays1f: list          # f32 env pdf tables
    meshes: list            # vsgf.SimpleMesh
    instances: list         # (mesh id, matrix [4, 4], remap list, light id)
    remap_lists: list       # flat (from, to, ...) lists
    camera: dict            # proj_inv, world_view_inv, cam_response_rgb,
    #                         exposure


def _light_row(**kw):
    row = dict(pos=np.zeros(4, np.float32),
               norm=np.array([0, -1, 0, 0], np.float32),
               intensity=np.zeros(4, np.float32),
               matrix=np.eye(4, dtype=np.float32),
               sam_row0=np.array([1, 0, 0, 0], np.float32),
               sam_row1=np.array([0, 1, 0, 0], np.float32),
               sam_row0_inv=np.array([1, 0, 0, 0], np.float32),
               sam_row1_inv=np.array([0, 1, 0, 0], np.float32),
               size=np.zeros(2, np.float32), pdf_a=1.0, mult=1.0,
               geom_type=0, dist_type=LIGHT_DIST_LAMBERT,
               pdf_table_offset=0, pdf_table_size_x=0, pdf_table_size_y=0,
               tex_id=-1, ies_id=-1)
    row.update(kw)
    return row


def _load_lights(xml, tc: TexCache):
    """LoadSceneLights (integrator_pt_scene.cpp:421-492;
    hydracore3_tpu/scene/build.py:793-958).  Returns (light rows, env,
    arrays1f, {light instance: light row})."""
    lights, arrays1f = [], []
    env = dict(color=np.zeros(4, np.float32), tex_id=-1,
               sam_row0=np.array([1, 0, 0, 0], np.float32),
               sam_row1=np.array([0, 1, 0, 0], np.float32),
               light_id=-1, cam_back_id=-1, enable_sam=False)
    old_to_new = {}
    for old_id, linst in enumerate(xml.instances_lights()):
        lnode = linst.light_node
        ltype = lnode.get('type', '')
        shape = lnode.get('shape', '')
        m = linst.matrix
        if lnode.find('ies') is not None:
            raise _not_ported('an IES light profile')
        snode = lnode.find('size')
        size_x = float(snode.get('half_width', '0')) if snode is not None \
            else 0.0
        size_z = float(snode.get('half_length', '0')) if snode is not None \
            else 0.0
        inode = lnode.find('intensity')
        power = 0.0
        if inode is not None and inode.find('multiplier') is not None:
            power = _read1f(inode.find('multiplier'), 0.0)
        power = power or 1.0
        cnode = inode.find('color') if inode is not None else None
        L = _light_row(intensity=_read_color(cnode), mult=power)

        add = True
        if ltype == 'sky':
            L.update(geom_type=LIGHT_GEOM_ENV, dist_type=LIGHT_DIST_OMNI)
            env['color'] = L['intensity']
            tnode = cnode.find('texture') if cnode is not None else None
            add = False
            if tnode is not None:
                tslot, r0, r1 = tc.slot_from_node(cnode)
                env.update(tex_id=tslot, sam_row0=r0, sam_row1=r1)
                tm = np.eye(4, dtype=np.float32)
                tm[0], tm[1] = r0, r1
                tmi = np.linalg.inv(tm)
                L.update(tex_id=tslot, sam_row0=r0, sam_row1=r1,
                         sam_row0_inv=tmi[0], sam_row1_inv=tmi[1])
                # the importance table (PdfTableFromImage,
                # integrator_pt_scene_lgt.cpp:237-270), for float maps only
                info = tc.infos.get(int(tnode.get('id', '0')))
                if tslot != 0 and (info.path.endswith('.exr')
                                   or info.bpp > 4):
                    img = tc.pool.slot_image(tslot)
                    lum = np.max(img[..., :3], axis=-1).astype(np.float64)
                    lum = np.maximum(lum, 0.1 * lum.mean())
                    prefix = np.zeros(lum.size + 1, np.float32)
                    prefix[1:] = np.cumsum(lum.reshape(-1))
                    L.update(pdf_table_offset=sum(a.size for a in arrays1f),
                             pdf_table_size_x=img.shape[1],
                             pdf_table_size_y=img.shape[0])
                    arrays1f.append(prefix)
                    env.update(light_id=len(lights), enable_sam=True)
                    add = True
            back = lnode.find('back')
            if back is not None:
                env['cam_back_id'] = tc.slot_from_node(back)[0]
        elif ltype == 'directional':
            nrm = m @ np.array([0, -1, 0, 0], np.float32)
            L.update(pos=m @ np.array([0, 0, 0, 1], np.float32),
                     norm=nrm / max(np.linalg.norm(nrm[:3]), 1e-20),
                     geom_type=LIGHT_GEOM_DIRECT)
        elif shape in ('rect', 'disk'):
            nrm = m @ np.array([0, -1, 0, 0], np.float32)
            scale = np.array([np.linalg.norm(m[:3, i]) for i in range(3)])
            mm = m.copy()
            mm[:3, 3] = 0
            size = np.array([size_z, size_x], np.float32)  # note ZX swap
            if shape == 'disk':
                radius = float(snode.get('radius', '0'))
                size[0] = radius
                pdf_a = 1.0 / (np.pi * radius * radius * scale[0] * scale[2])
            else:
                pdf_a = 1.0 / (4.0 * size[0] * size[1] * scale[0] * scale[2])
            L.update(pos=m @ np.array([0, 0, 0, 1], np.float32),
                     norm=nrm / max(np.linalg.norm(nrm[:3]), 1e-20),
                     geom_type=(LIGHT_GEOM_RECT if shape == 'rect'
                                else LIGHT_GEOM_DISC),
                     matrix=mm, size=size, pdf_a=pdf_a)
        elif shape == 'sphere':
            scale = np.array([np.linalg.norm(m[:3, i]) for i in range(3)])
            radius = float(snode.get('radius', '0')) * scale[0]
            L.update(pos=m @ np.array([0, 0, 0, 1], np.float32),
                     geom_type=LIGHT_GEOM_SPHERE,
                     size=np.array([radius, radius], np.float32),
                     pdf_a=1.0 / (4.0 * np.pi * radius * radius))
        elif shape == 'point':
            ldist = lnode.get('distribution', '')
            if ldist == 'spot':
                raise _not_ported('a spot light')
            nrm = m @ np.array([0, -1, 0, 0], np.float32)
            L.update(pos=m @ np.array([0, 0, 0, 1], np.float32),
                     norm=nrm / max(np.linalg.norm(nrm[:3]), 1e-20),
                     geom_type=LIGHT_GEOM_POINT,
                     dist_type=(LIGHT_DIST_OMNI
                                if ldist in ('uniform', 'omni', 'ies')
                                else LIGHT_DIST_LAMBERT))
        if add:
            old_to_new[old_id] = len(lights)
            lights.append(L)
    return lights, env, arrays1f, old_to_new


def _load_materials(xml, tc: TexCache, lights, old_to_new):
    """The materials loop (hydracore3_tpu/scene/build.py:974-1035)."""
    materials = []
    for node in xml.material_nodes():
        mtype_str = node.get('type', '')
        if mtype_str == 'hydra_material':
            mat = convert_old_hydra_material(node, tc)
        elif mtype_str == 'gltf':
            mat = convert_gltf_material(node, tc)
        elif mtype_str in _UNPORTED_MATERIALS:
            raise _not_ported(f'the {mtype_str!r} material', ITEM_MATERIALS)
        else:
            # unknown -> gray lambert placeholder
            mat = MaterialRec()
            mat.mtype = MAT_TYPE_GLTF
            mat.cflags = GLTF_COMPONENT_LAMBERT
            mat.colors[GLTF_COLOR_BASE] = (0.5, 0.5, 0.5, 0.0)
        # light-material intensity sync (integrator_pt_scene.cpp:575-600)
        if node.get('light_id') is not None:
            nl = old_to_new.get(int(node.get('light_id')))
            if nl is not None:
                mat.colors[EMISSION_COLOR] = lights[nl]['intensity']
                mat.data[EMISSION_MULT] = lights[nl]['mult']
        disp = node.find('displacement')
        if (disp is not None and disp.get('type') == 'normal_bump'
                and disp.find('normal_map') is not None):
            raise _not_ported('a normal_bump displacement (bump map)')
        mat.texid[1] = INVALID_ID
        materials.append(mat)
    return materials or [MaterialRec()]


def _load_camera(xml, cam_id, fb_w, fb_h, look_at_override):
    """LoadSceneCamera (integrator_pt_scene.cpp:645-726;
    hydracore3_tpu/scene/build.py:1037-1109), the pinhole camera."""
    cams = xml.cameras()
    cam = (cams[cam_id] if cams and 0 <= cam_id < len(cams)
           else (cams[0] if cams else None))
    aspect = float(fb_w) / float(fb_h)
    cam_response_rgb = np.array([1, 1, 1, 1], np.float32)
    if cam is not None:
        proj = lmath.perspective_matrix(cam.fov, aspect, cam.near_plane,
                                        cam.far_plane)
        if cam.has_matrix:
            c2w = cam.matrix.copy()
            c2w[:, 0] *= -1
            c2w[:, 2] *= -1
            world_view = np.linalg.inv(c2w).astype(np.float32)
        else:
            world_view = lmath.look_at(cam.pos, cam.look_at, cam.up)
        exposure = cam.exposure_mult
        dof = cam.node.find('enable_dof')
        if dof is not None and int(_read1f(dof)) != 0:
            raise _not_ported('depth of field (a thin-lens camera)')
        if (cam.node.find('optical_system') is not None
                or cam.node.find('optics') is not None):
            raise _not_ported('the optics lens stack')
        sensor = cam.node.find('sensor')
        resp = sensor.find('response') if sensor is not None else None
        if resp is not None:
            if resp.findall('spectrum'):
                raise _not_ported('a spectral sensor response')
            cnode = resp.find('color')
            if cnode is not None and cnode.get('val'):
                cam_response_rgb = np.array(
                    [float(x) for x in cnode.get('val').split()][:3] + [1.0],
                    np.float32)
    else:
        proj = lmath.perspective_matrix(45.0, aspect, 0.01, 100.0)
        world_view = np.eye(4, dtype=np.float32)
        exposure = 1.0
    if look_at_override is not None:
        # -look_at: a row-major 4x4 view matrix
        world_view = np.asarray(look_at_override, np.float32).reshape(4, 4)
    return dict(proj_inv=np.linalg.inv(proj).astype(np.float32),
                world_view_inv=np.linalg.inv(world_view).astype(np.float32),
                cam_response_rgb=cam_response_rgb, exposure=exposure)


def _custom_geom_box(node) -> vsgf.SimpleMesh:
    """Custom (non-mesh) geometry (integrator_pt_scene.cpp:818-831): the
    reference registers an opaque AABB primitive; it stands in as a
    12-triangle box over the declared bounds (bbox_min / bbox_max, else a
    unit box) shaded with its one material (hydracore3_tpu/scene/
    build.py:1111-1141)."""
    def vec3(attr, default):
        raw = node.get(attr)
        if not raw:
            return np.array(default, np.float32)
        return np.array([float(x) for x in raw.split()][:3], np.float32)

    lo = vec3('bbox_min', (-0.5, -0.5, -0.5))
    hi = vec3('bbox_max', (0.5, 0.5, 0.5))
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]],
                       np.float32)
    faces = np.array([  # outward CCW box faces
        [0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6],
        [0, 1, 5], [0, 5, 4], [2, 6, 7], [2, 7, 3],
        [0, 4, 6], [0, 6, 2], [1, 3, 7], [1, 7, 5]], np.int64)
    n = np.zeros((8, 4), np.float32)
    nrm = corners - ((lo + hi) * 0.5)[None]
    n[:, :3] = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                                1e-9)
    return vsgf.SimpleMesh(
        v_pos=np.concatenate([corners, np.ones((8, 1), np.float32)], 1),
        v_norm=n, v_tang=np.zeros((8, 4), np.float32),
        v_texc=np.zeros((8, 2), np.float32),
        indices=faces.reshape(-1).astype(np.uint32),
        mat_indices=np.full(12, int(node.get('mat_id', '0')), np.uint32))


def _records(xml, spectral_mode=False, width=None, height=None,
             look_at_override=None, cam_id=0, meshes=None,
             images=None) -> _Records:
    """A parsed library (``hydra_xml.HydraScene``) -> the records.
    ``meshes`` (``vsgf.SimpleMesh`` per geometry_lib node, in order) and
    ``images`` ({texture id: array}) stand in for the library's files."""
    if spectral_mode:
        raise _not_ported('spectral mode')
    if any(s.lambda_ref_ids is not None for s in xml.spectra()):
        raise _not_ported('a spectral texture')
    settings = xml.settings()
    sett = settings[0] if settings else None
    fb_w = width or (sett.width if sett else 1024)
    fb_h = height or (sett.height if sett else 1024)
    tc = TexCache(xml.textures(), images)
    lights, env, arrays1f, old_to_new = _load_lights(xml, tc)
    materials = _load_materials(xml, tc, lights, old_to_new)
    camera = _load_camera(xml, cam_id, fb_w, fb_h, look_at_override)
    # geometry (LoadSceneGeometry, integrator_pt_scene.cpp:727-837)
    geom = []
    for k, mi in enumerate(xml.geom_nodes()):
        if mi.tag != 'mesh':
            geom.append(_custom_geom_box(mi.node))
        else:
            geom.append(meshes[k] if meshes is not None
                        else vsgf.load_vsgf(mi.path))
    # instances (LoadSceneInstances, integrator_pt_scene.cpp:839-907)
    instances = []
    for inst in xml.instances_geom():
        if inst.has_motion:
            raise _not_ported('an instance with matrix_motion (motion blur)')
        light_id = (old_to_new.get(inst.light_inst_id, -1)
                    if inst.light_inst_id >= 0 else -1)
        instances.append((inst.geom_id, inst.matrix, inst.rmap_id, light_id))
    return _Records(
        width=fb_w, height=fb_h,
        trace_depth=(sett.depth if sett and sett.depth else 6),
        spp=(sett.spp if sett and sett.spp else 1), tc=tc,
        materials=materials, lights=lights, env=env, arrays1f=arrays1f,
        meshes=geom, instances=instances, remap_lists=xml.remap_lists(),
        camera=camera)


# ---------------------------------------------------------------------------
# The tables: records -> Scene, SceneMeta
# ---------------------------------------------------------------------------

def _shade_rows(idx, norm, tang, texc) -> np.ndarray:
    """[T, 24] per-triangle shading rows: 3 x (norm3, tx, tang3, ty)."""
    sh = np.zeros((len(idx), 24), np.float32)
    for c in range(3):
        vi = idx[:, c]
        sh[:, c * 8 + 0:c * 8 + 3] = norm[vi]
        sh[:, c * 8 + 3] = texc[vi, 0]
        sh[:, c * 8 + 4:c * 8 + 7] = tang[vi]
        sh[:, c * 8 + 7] = texc[vi, 1]
    return sh


def _pad_shade(shade, mat_id) -> np.ndarray:
    """[T4, 32] rows padded to a multiple of 4, matId in column 24."""
    out = np.zeros((max(-(-len(shade) // 4) * 4, 4), 32), np.float32)
    out[:len(shade), :24] = shade
    out[:len(shade), 24] = np.asarray(mat_id).astype(np.float32)
    return out


def _remapped(mat_indices, remap_list) -> np.ndarray:
    """Material ids through a flat (from, to, ...) remap list."""
    mids = mat_indices.astype(np.int64)
    out = mids.copy()
    for a, b in dict(zip(remap_list[0::2], remap_list[1::2])).items():
        out[mids == a] = b
    return out


def _world_soup(meshes, instances, remap_lists):
    """Every instance flattened into world space with its remap list
    applied (LoadSceneInstances): (v0, e1, e2, [inst id, mesh id, prim id,
    shade rows [T, 24], mat id])."""
    v0l, e1l, e2l, instl, geoml, priml, shadel, matl = ([] for _ in range(8))
    for real_id, (mesh_id, m, rmap_id, _) in enumerate(instances):
        mesh = meshes[mesh_id]
        idx = mesh.indices.reshape(-1, 3).astype(np.int64)
        nm = np.linalg.inv(m).T.astype(np.float32)
        pos = mesh.v_pos[:, :3] @ m[:3, :3].T + m[:3, 3]
        v0 = pos[idx[:, 0]]
        v0l.append(v0)
        e1l.append(pos[idx[:, 1]] - v0)
        e2l.append(pos[idx[:, 2]] - v0)
        nt = len(idx)
        instl.append(np.full(nt, real_id, np.int32))
        geoml.append(np.full(nt, mesh_id, np.int32))
        priml.append(np.arange(nt, dtype=np.int32))
        shadel.append(_shade_rows(idx, mesh.v_norm[:, :3] @ nm[:3, :3].T,
                                  mesh.v_tang[:, :3] @ nm[:3, :3].T,
                                  mesh.v_texc))
        mids = (_remapped(mesh.mat_indices, remap_lists[rmap_id])
                if 0 <= rmap_id < len(remap_lists)
                else mesh.mat_indices.astype(np.int64))
        matl.append(mids.astype(np.int32))
    return (np.concatenate(v0l), np.concatenate(e1l), np.concatenate(e2l),
            [np.concatenate(a) for a in (instl, geoml, priml, shadel, matl)])


def _two_level_tables(meshes, instances):
    """The ``accel='stream_tlas'`` tables (hydracore3_tpu/scene/build.py:
    1276-1313): every mesh once in object space under a TLAS over the
    instances.  Returns (TlasPack, shade [C * 64, 32], geom, prim,
    inst_nm)."""
    from ..accel import traverse_tlas as TT
    mesh_tris, mesh_shade = [], []
    for mesh in meshes:
        idx = mesh.indices.reshape(-1, 3).astype(np.int64)
        p3 = mesh.v_pos[:, :3]
        mv0 = p3[idx[:, 0]]
        mesh_tris.append((mv0, p3[idx[:, 1]] - mv0, p3[idx[:, 2]] - mv0))
        mesh_shade.append(_shade_rows(idx, mesh.v_norm[:, :3],
                                      mesh.v_tang[:, :3], mesh.v_texc))
    pk = TT.pack_stream_tlas(mesh_tris, [dict(geom_id=mesh_id, m0=m)
                                         for mesh_id, m, _, _ in instances])
    # per padded slot: object-space shade rows and unremapped material ids
    # (the per-instance remap runs at trace time)
    op, tmsh = pk['order_padded'], pk['tri_mesh']
    tt_sh = np.zeros((len(op), 24), np.float32)
    tt_mat = np.zeros(len(op), np.int32)
    for g, mesh in enumerate(meshes):
        selm = tmsh == g
        tt_sh[selm] = mesh_shade[g][op[selm]]
        tt_mat[selm] = mesh.mat_indices.astype(np.int32)[op[selm]]
    return (TT.tlas_pack(pk), _pad_shade(tt_sh, tt_mat),
            np.maximum(tmsh, 0).astype(np.int32),
            np.maximum(op, 0).astype(np.int32), pk['inst_nm'])


def _remap_table(remap_lists):
    """LoadSceneRemapLists: every list's (from, to) pairs sorted by from
    (the lookup bisects them), the lists concatenated, then their offsets.
    Returns (table, size of the lists part)."""
    flat, offsets = [], []
    for rl in remap_lists:
        offsets.append(len(flat))
        for a, b in sorted(zip(rl[0::2], rl[1::2])):
            flat += [a, b]
    offsets.append(len(flat))
    return flat + offsets, len(flat)


def _pad128(a):
    a = np.asarray(a, np.float32)
    if a.size % 128:
        a = np.concatenate([a, np.zeros(128 - a.size % 128, np.float32)])
    return a


def _tex0_consts(mats, pool: TEX.TexturePoolBuilder):
    """The const-texture fold (hydracore3_tpu/scene/build.py:1441-1451):
    [M, 4] slot-0 texels when every material's slot-0 texture is 1x1,
    else None."""
    out = np.ones((len(mats), 4), np.float32)
    for i, m_ in enumerate(mats):
        t0 = int(np.int64(m_.texid[0]) & 0xFFFFFFFF)
        if t0 == INVALID_ID or t0 >= len(pool):
            t0 = 0
        cval = pool.slot_const_value(t0)
        if cval is None:
            return None
        out[i] = cval
    return out


def _device(device, entry: str):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{entry}: no CUDA device; pass device='cpu' to build the "
                'scene for the plain CPU path')
        device = 'cuda'
    return torch.device(device)


def _tables(rec: _Records, device, accel: str) -> tuple[Scene, SceneMeta]:
    """The records -> the device tables on ``device`` and the routes."""
    from ..accel import build_bvh
    from ..accel import traverse_stream as TST
    from ..accel import traverse_dda as TDD
    from ..accel import traverse_pallas as TPL
    from ..accel import wide_bvh as WB

    meshes, instances, mats, lights = (rec.meshes, rec.instances,
                                       rec.materials, rec.lights)
    soup_T = sum(len(meshes[mesh_id].indices) // 3
                 for mesh_id, _, _, _ in instances)
    unique_T = sum(len(mesh.indices) // 3 for mesh in meshes)
    use_stream_tlas = accel == 'stream_tlas' or (
        accel == 'auto' and soup_T > 200_000 and soup_T > 2 * unique_T)
    two_level = None
    if use_stream_tlas:
        # every mesh once, in object space; no world soup (one zero row)
        two_level = _two_level_tables(meshes, instances)
        soup_v0, soup_e1, soup_e2 = (np.zeros((1, 3), np.float32)
                                     for _ in range(3))
        soup = [np.zeros(1, np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.int32), np.zeros((1, 24), np.float32),
                np.zeros(1, np.int32)]
    else:
        soup_v0, soup_e1, soup_e2, soup = _world_soup(meshes, instances,
                                                      rec.remap_lists)

    use_stream = not use_stream_tlas and (
        accel == 'stream' or len(soup_v0) > TPL.VMEM_TRI_LIMIT)
    use_pallas = (not use_stream_tlas and not use_stream
                  and len(soup_v0) >= SMALL_SCENE_TRIS)
    stream = clusters = cl_wide = st_wide = None
    if use_stream:
        # streamed cluster BVH: padded leaf-cluster order
        cbvh = build_bvh.build(soup_v0, soup_e1, soup_e2, max_leaf=TST.TBK)
        order = cbvh.order
        soup_v0, soup_e1, soup_e2 = (soup_v0[order], soup_e1[order],
                                     soup_e2[order])
        soup = [a[order] for a in soup]
        nodes_f, nodes_i, woop, order_padded = TST.pack_stream_bvh(
            cbvh, soup_v0, soup_e1, soup_e2)
        stream = (nodes_f, nodes_i, woop, TDD.pack_grid(nodes_f, nodes_i))
        sel = np.maximum(order_padded, 0)
        pad_rows = order_padded < 0
        soup_v0, soup_e1, soup_e2 = soup_v0[sel], soup_e1[sel], soup_e2[sel]
        for a in (soup_v0, soup_e1, soup_e2):
            a[pad_rows] = 0.0
        soup = [a[sel] for a in soup]
        soup[3][pad_rows] = 0.0
        st_wide = WB.pack_wide_stream(nodes_f, nodes_i, woop, soup_v0,
                                      soup_e1, soup_e2)
    elif not use_stream_tlas:
        # mid-size: the soup in the cluster BVH's leaf order, unpadded;
        # small: in the leaf order of a 4-triangle-leaf BVH
        cbvh = build_bvh.build(soup_v0, soup_e1, soup_e2,
                               max_leaf=TPL.CLUSTER if use_pallas else 4)
        order = cbvh.order
        soup_v0, soup_e1, soup_e2 = (soup_v0[order], soup_e1[order],
                                     soup_e2[order])
        soup = [a[order] for a in soup]
        if use_pallas:
            clusters = TPL.pack_cluster_bvh(cbvh, soup_v0, soup_e1, soup_e2)
            cl_wide = WB.pack_wide_clusters(clusters[2])
    inst, geom, prim, shade, mat_id = soup
    tri_shade = _pad_shade(shade, mat_id)
    tex0_const = _tex0_consts(mats, rec.tc.pool)
    remap_table, remap_size = _remap_table(rec.remap_lists)
    env, cam = rec.env, rec.camera

    pool = rec.tc.pool.finish(device)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    def light_col(key, dtype=np.float32):
        if not lights:     # the JAX build's one row: zeros, pdf_a/mult 1
            return dev(np.full((1,) + np.shape(_light_row()[key]),
                               1 if key in ('pdf_a', 'mult') else 0, dtype))
        return dev(np.stack([np.asarray(l[key], dtype) for l in lights]))

    scene = Scene(
        mat_mtype=dev([m_.mtype for m_ in mats], np.int64),
        mat_cflags=dev([m_.cflags for m_ in mats], np.int64),
        mat_texid=dev(np.array([m_.texid for m_ in mats], np.int64)
                      .astype(np.int32), np.int64),
        mat_colors=dev(np.stack([m_.colors for m_ in mats])),
        mat_row0=dev(np.stack([m_.row0 for m_ in mats])),
        mat_row1=dev(np.stack([m_.row1 for m_ in mats])),
        mat_data=dev(np.stack([m_.data for m_ in mats])),
        light_pos=light_col('pos'), light_norm=light_col('norm'),
        light_intensity=light_col('intensity'),
        light_matrix=light_col('matrix'),
        light_sam_row0=light_col('sam_row0'),
        light_sam_row1=light_col('sam_row1'),
        light_sam_row0_inv=light_col('sam_row0_inv'),
        light_sam_row1_inv=light_col('sam_row1_inv'),
        light_size=light_col('size'), light_pdf_a=light_col('pdf_a'),
        light_mult=light_col('mult'),
        light_geom_type=light_col('geom_type', np.int64),
        light_dist_type=light_col('dist_type', np.int64),
        light_pdf_table_offset=light_col('pdf_table_offset', np.int64),
        light_pdf_table_size_x=light_col('pdf_table_size_x', np.int64),
        light_pdf_table_size_y=light_col('pdf_table_size_y', np.int64),
        light_tex_id=light_col('tex_id', np.int64),
        light_ies_id=light_col('ies_id', np.int64),
        tri_v0=dev(soup_v0), tri_e1=dev(soup_e1), tri_e2=dev(soup_e2),
        tri_inst_id=dev(inst, np.int64), tri_geom_id=dev(geom, np.int64),
        tri_prim_id=dev(prim, np.int64),
        tri_shade=dev(tri_shade),
        remap_inst=dev([(rl, light_id) for _, _, rl, light_id in instances]
                       or [(-1, -1)], np.int64),
        all_remap_lists=dev(remap_table, np.int64),
        all_remap_lists_size=remap_size,
        arrays1f=dev(_pad128(np.concatenate(rec.arrays1f) if rec.arrays1f
                             else np.zeros(1, np.float32))),
        env_color=dev(env['color']),
        env_tex_id=dev(env['tex_id'], np.int64),
        env_sam_row0=dev(env['sam_row0']), env_sam_row1=dev(env['sam_row1']),
        env_light_id=dev(env['light_id'], np.int64),
        env_cam_back_id=dev(env['cam_back_id'], np.int64),
        proj_inv=dev(cam['proj_inv']),
        world_view_inv=dev(cam['world_view_inv']),
        cam_response_rgb=dev(cam['cam_response_rgb']),
        textures=pool,
        mat_tex0_const=None if tex0_const is None else dev(tex0_const),
        st_nodes_f=None if stream is None else dev(stream[0]),
        st_nodes_i=None if stream is None else dev(stream[1]),
        st_woop=None if stream is None else dev(stream[2]),
        st_grid=None if stream is None else stream[3].to(device),
        st_wide=None if st_wide is None else st_wide.to(device),
        cl_nodes_f=None if clusters is None else torch.as_tensor(clusters[0]),
        cl_nodes_i=None if clusters is None else torch.as_tensor(clusters[1]),
        cl_tris12=None if clusters is None else dev(clusters[2]),
        cl_wide=None if cl_wide is None else cl_wide.to(device),
        tt=None if two_level is None else two_level[0].to(device),
        tt_shade=None if two_level is None else dev(two_level[1]),
        tt_geom=None if two_level is None else dev(two_level[2], np.int64),
        tt_prim=None if two_level is None else dev(two_level[3], np.int64),
        tt_inst_nm=None if two_level is None else dev(two_level[4]))
    meta = SceneMeta(
        width=rec.width, height=rec.height, trace_depth=rec.trace_depth,
        spp=rec.spp, num_lights=len(lights), num_materials=len(mats),
        has_env_map=env['tex_id'] >= 0, env_enable_sam=env['enable_sam'],
        num_tris=soup_T if use_stream_tlas else int(len(soup_v0)),
        exposure_mult=cam['exposure'],
        use_stream=use_stream, use_stream_tlas=use_stream_tlas,
        use_pallas=use_pallas,
        mat_types_present=tuple(sorted({m_.mtype for m_ in mats})),
        light_geom_types=tuple(int(l['geom_type']) for l in lights),
        tex0_all_const=tex0_const is not None,
        has_cam_back=env['cam_back_id'] >= 0,
        has_four_textures=any(m_.cflags & FLAG_FOUR_TEXTURES for m_ in mats))
    return scene, meta


def _check_accel(accel):
    if accel not in ('auto', 'stream', 'stream_tlas'):
        raise NotImplementedError(f'accel={accel!r} is not ported')


def load_scene(path: str, scene_dir: str = '', spectral_mode: bool = False,
               accel: str = 'auto', width: Optional[int] = None,
               height: Optional[int] = None, look_at_override=None,
               cam_id: int = 0, device=None) -> tuple[Scene, SceneMeta]:
    """Load the Hydra XML scene library at ``path`` (the JAX package's
    ``load_scene``) into device tables on ``device``.  With no device given
    they go to the CUDA card, and the load raises where there is none.

    ``scene_dir`` resolves the library's relative locations (default: the
    directory of ``path``); ``width`` / ``height`` override the render
    settings; ``look_at_override`` (16 floats, a row-major world-view
    matrix) replaces the camera's view; ``cam_id`` picks a camera of a
    multi-camera library.  ``accel`` as for ``build_scene``."""
    _check_accel(accel)
    device = _device(device, 'load_scene')
    xml = hydra_xml.HydraScene(path, scene_dir)
    return _tables(_records(xml, spectral_mode, width, height,
                            look_at_override, cam_id), device, accel)


def build_scene(desc: SceneDesc, device=None, accel: str = 'auto'
                ) -> tuple[Scene, SceneMeta]:
    """Build the device tables of ``desc`` on ``device``.  With no device
    given they go to the CUDA card, and the build raises where there is
    none: a scene lands on the CPU (where every ray query runs its plain
    version) only when the caller asks for ``device='cpu'``.

    ``accel='auto'`` follows the JAX build: an instanced scene whose
    flattened soup would hold over 200,000 triangles and over twice its
    unique triangles goes two-level (``meta.use_stream_tlas``); otherwise a
    soup of fewer than ``SMALL_SCENE_TRIS`` triangles stays a brute-traced
    soup in BVH leaf order (the megakernel's class), one of up to
    ``VMEM_TRI_LIMIT`` (175,000) gets the unpadded cluster BVH
    (``meta.use_pallas``) and a larger one is streamed through the padded
    cluster BVH and its grid (``meta.use_stream``).  ``accel='stream'``
    streams any scene and ``accel='stream_tlas'`` builds any scene
    two-level."""
    from .. import api
    _check_accel(accel)
    device = _device(device, 'build_scene')
    text, meshes, images = api.library(desc)
    xml = hydra_xml.HydraScene(os.path.join(os.curdir, 'statex_00001.xml'),
                               text=text.encode())
    return _tables(_records(xml, width=desc.width, height=desc.height,
                            meshes=meshes, images=images), device, accel)
