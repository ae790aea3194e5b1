"""Scene build: an in-memory scene description -> flat device tables.

The counterpart of ``hydracore3_tpu/scene/build.py``'s ``load_scene`` for
the scenes the slice covers.  The JAX package commits an in-process scene
(``api.py``) by writing a Hydra XML library and loading it back; the port
takes the same description (``SceneDesc``) directly and reproduces what the
round trip does to it: the area light's emissive quad and material, the
face-averaged vertex normals, the 6-digit instance matrices, the sRGB
decode of 8-bit textures, the old-Hydra lambert -> GLTF conversion and the
light-material intensity sync.  The streamed branch of the JAX build then
gives the triangle soup in padded leaf-cluster order, the skip-pointer BVH
nodes, the Woop rows and the march grid.

The routes of the JAX build (``accel='auto'``): an instanced scene whose
flattened soup would pass 200,000 triangles and twice its unique triangles
keeps every mesh once, in object space, under a TLAS over its instances
(``use_stream_tlas``; no world soup is built); a soup of 4096 to 175,000
triangles gets the unpadded cluster BVH (``use_pallas``); a larger one is
streamed (``use_stream``); a smaller one takes the small-scene branch: the
soup in the leaf order of a 4-triangle-leaf BVH and no cluster BVH or grid
(the megakernel's brute trace reads the soup).

Covered: lambert materials with an optional slot-0 diffuse texture and an
optional phong reflectivity (the old-Hydra lambert|metal and metal
conversions, no fresnel), emissive light-source materials, rect area
lights, point and sphere lights, one float lat-long env map with
importance sampling, a pinhole camera.  Anything else raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import texture as TEX
from ..utils import lmath

# Material type ids (include/cmaterial.h:38-46)
MAT_TYPE_GLTF = 1
MAT_TYPE_LIGHT_SOURCE = 0xEFFFFFFF
# f32-exact small code of MAT_TYPE_LIGHT_SOURCE in the megakernel's tables
MTYPE_SMALL_LIGHT = 9

# GLTF component flags (cmaterial.h:26-36)
GLTF_COMPONENT_LAMBERT = 1
GLTF_COMPONENT_METAL = 4

# Color slots (cmaterial.h:67-180)
GLTF_COLOR_BASE = 0
GLTF_COLOR_COAT = 1
GLTF_COLOR_METAL = 2
EMISSION_COLOR = 0

# Custom data slots
GLTF_FLOAT_MI_FDR_INT = 0
GLTF_FLOAT_ALPHA = 3
GLTF_FLOAT_GLOSINESS = 4
GLTF_FLOAT_IOR = 5
GLTF_FLOAT_REFL_COAT = 7
EMISSION_MULT = 0

# Light geometry / distribution (include/clight.h:5-17)
LIGHT_GEOM_RECT = 1
LIGHT_GEOM_DISC = 2
LIGHT_GEOM_SPHERE = 3
LIGHT_GEOM_POINT = 5
LIGHT_GEOM_ENV = 6
LIGHT_DIST_LAMBERT = 0
LIGHT_DIST_OMNI = 1

# below this many triangles the soup stays brute-traced
# (hydracore3_tpu/scene/build.py:1348-1352)
SMALL_SCENE_TRIS = 4096

INVALID_ID = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Scene description (what hydracore3_tpu.api.HRSceneInst accumulates)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshDesc:
    pos: np.ndarray                    # [V, 3] f32
    indices: np.ndarray                # [T, 3] int
    mat_indices: np.ndarray            # [T] int
    texc: Optional[np.ndarray] = None  # [V, 2] f32
    norm: Optional[np.ndarray] = None  # [V, 3] f32 (face-averaged if None)


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
class AreaLightDesc:
    color: tuple = (1.0, 1.0, 1.0)
    multiplier: float = 1.0
    half_width: float = 1.0
    half_length: float = 1.0
    matrix: Optional[np.ndarray] = None


@dataclasses.dataclass
class SimpleLightDesc:
    """A light without geometry: kind 'point' (omni) or 'sphere'; 'spot'
    is described but not ported."""
    kind: str = 'point'
    color: tuple = (1.0, 1.0, 1.0)
    multiplier: float = 1.0
    radius: float = 1.0               # sphere only
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
    textures: list = dataclasses.field(default_factory=list)  # [H, W, 4]
    lights: list = dataclasses.field(default_factory=list)   # area lights
    simple_lights: list = dataclasses.field(default_factory=list)
    env: Optional[EnvLightDesc] = None
    instances: list = dataclasses.field(default_factory=list)  # (mesh, m)
    camera: CameraDesc = dataclasses.field(default_factory=CameraDesc)
    width: int = 256
    height: int = 256
    trace_depth: int = 6
    spp: int = 16

    def add_texture(self, data: np.ndarray) -> int:
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
        self.textures.append(data)
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
    # [Tpad, 32]: 3 x (norm3, tx, tang3, ty), matId in column 24
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
# What the XML round trip does to a description
# ---------------------------------------------------------------------------

def _read_color(vals) -> np.ndarray:
    """GetColorFromNode: float -> splat4, float3 -> (xyz, 0), float4."""
    vals = [float(v) for v in vals]
    if len(vals) == 1:
        return np.full(4, vals[0], np.float32)
    if len(vals) == 3:
        return np.array(vals + [0.0], np.float32)
    return np.array(vals[:4], np.float32)


def _instance_matrix(m) -> np.ndarray:
    """Instance matrices travel as 6-significant-digit text ('{v:g}')."""
    m = np.eye(4, dtype=np.float32) if m is None else np.asarray(m, np.float32)
    return np.array([float(f'{float(v):g}') for v in m.reshape(-1)],
                    np.float32).reshape(4, 4)


def _face_normals_to_vertices(pos3, indices):
    """Vertex normals written for meshes given without normals."""
    ind = np.asarray(indices, np.int64).reshape(-1, 3)
    n = np.zeros((len(pos3), 3), np.float32)
    e1 = pos3[ind[:, 1]] - pos3[ind[:, 0]]
    e2 = pos3[ind[:, 2]] - pos3[ind[:, 0]]
    fn = np.cross(e1, e2)
    for k in range(3):
        np.add.at(n, ind[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def _mesh_arrays(mesh: MeshDesc):
    """(pos [V, 3], idx [T, 3], vertex normals [V, 3], texc [V, 2])."""
    p3 = np.asarray(mesh.pos, np.float32)
    idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
    v_norm = (_face_normals_to_vertices(p3, idx) if mesh.norm is None
              else np.asarray(mesh.norm, np.float32))
    texc = (np.zeros((len(p3), 2), np.float32) if mesh.texc is None
            else np.asarray(mesh.texc, np.float32))
    return p3, idx, v_norm, texc


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


def _world_soup(meshes, instances):
    """Every instance flattened into world space (LoadSceneInstances):
    (v0, e1, e2, [inst id, mesh id, prim id, shade rows [T, 24], mat id])."""
    v0l, e1l, e2l, instl, geoml, priml, shadel, matl = ([] for _ in range(8))
    for real_id, (mesh_id, m, _) in enumerate(instances):
        p3, idx, v_norm, texc = _mesh_arrays(meshes[mesh_id])
        nm = np.linalg.inv(m).T.astype(np.float32)
        pos = p3 @ m[:3, :3].T + m[:3, 3]
        v0 = pos[idx[:, 0]]
        v0l.append(v0)
        e1l.append(pos[idx[:, 1]] - v0)
        e2l.append(pos[idx[:, 2]] - v0)
        nt = len(idx)
        instl.append(np.full(nt, real_id, np.int32))
        geoml.append(np.full(nt, mesh_id, np.int32))
        priml.append(np.arange(nt, dtype=np.int32))
        shadel.append(_shade_rows(
            idx, v_norm @ nm[:3, :3].T,
            np.zeros((len(p3), 3), np.float32) @ nm[:3, :3].T, texc))
        matl.append(np.asarray(meshes[mesh_id].mat_indices, np.int64)
                    .astype(np.int32))
    return (np.concatenate(v0l), np.concatenate(e1l), np.concatenate(e2l),
            [np.concatenate(a) for a in (instl, geoml, priml, shadel, matl)])


def _two_level_tables(meshes, instances):
    """The ``accel='stream_tlas'`` tables (hydracore3_tpu/scene/build.py:
    1276-1313): every mesh once in object space under a TLAS over the
    instances.  Returns (TlasPack, shade [C * 64, 32], geom, prim,
    inst_nm)."""
    from ..accel import traverse_tlas as TT
    mesh_tris, mesh_shade, mesh_mats = [], [], []
    for mesh in meshes:
        p3, idx, v_norm, texc = _mesh_arrays(mesh)
        mv0 = p3[idx[:, 0]]
        mesh_tris.append((mv0, p3[idx[:, 1]] - mv0, p3[idx[:, 2]] - mv0))
        mesh_shade.append(_shade_rows(idx, v_norm, np.zeros_like(p3), texc))
        mesh_mats.append(np.asarray(mesh.mat_indices, np.int64)
                         .astype(np.int32))
    pk = TT.pack_stream_tlas(mesh_tris, [dict(geom_id=mesh_id, m0=m)
                                         for mesh_id, m, _ in instances])
    # per padded slot: object-space shade rows and unremapped material ids
    # (the per-instance remap runs at trace time)
    op, tmsh = pk['order_padded'], pk['tri_mesh']
    tt_sh = np.zeros((len(op), 24), np.float32)
    tt_mat = np.zeros(len(op), np.int32)
    for g in range(len(meshes)):
        selm = tmsh == g
        tt_sh[selm] = mesh_shade[g][op[selm]]
        tt_mat[selm] = mesh_mats[g][op[selm]]
    return (TT.tlas_pack(pk), _pad_shade(tt_sh, tt_mat),
            np.maximum(tmsh, 0).astype(np.int32),
            np.maximum(op, 0).astype(np.int32), pk['inst_nm'])


class _MaterialRec:
    """Host mirror of the reference ``struct Material`` (cmaterial.h)."""

    def __init__(self):
        self.mtype = 0
        self.cflags = 0
        self.texid = [0, 0, 0, 0]
        self.colors = np.zeros((4, 4), np.float32)
        self.row0 = np.tile(np.array([1, 0, 0, 0], np.float32), (4, 1))
        self.row1 = np.tile(np.array([0, 1, 0, 0], np.float32), (4, 1))
        self.data = np.zeros(16, np.float32)


class _TexCache:
    """(texture id, sampler) -> pool slot, as the reference's texCache."""

    def __init__(self, textures):
        self.textures = textures
        self.pool = TEX.TexturePoolBuilder()
        self.cache: dict[int, int] = {}

    def slot(self, tex_id: int) -> int:
        # every texture reference of the slice is wrap/wrap/linear
        if tex_id not in self.cache:
            if not 0 <= tex_id < len(self.textures):
                self.cache[tex_id] = 0
            else:
                img = TEX.decode_image(self.textures[tex_id])
                self.cache[tex_id] = self.pool.add(img)
        return self.cache[tex_id]


def _tex_rows(tex_matrix):
    if tex_matrix is None:
        return (np.array([1, 0, 0, 0], np.float32),
                np.array([0, 1, 0, 0], np.float32))
    vals = [float(v) for v in tex_matrix]
    return np.array(vals[0:4], np.float32), np.array(vals[4:8], np.float32)


def _convert_material(desc: MaterialDesc, tc: _TexCache) -> _MaterialRec:
    """ConvertOldHydraMaterial (integrator_pt_scene_mat.cpp:280-452) on the
    lambert / phong-reflective / emissive materials the description can
    hold (hydracore3_tpu/scene/build.py:248-364 without fresnel, glass and
    Oren-Nayar)."""
    mat = _MaterialRec()
    mat.mtype = MAT_TYPE_GLTF
    mat.data[GLTF_FLOAT_ALPHA] = 0.0
    mat.data[GLTF_FLOAT_REFL_COAT] = 1.0
    mat.colors[GLTF_COLOR_COAT] = (1, 1, 1, 1)
    mat.colors[GLTF_COLOR_METAL] = (0, 0, 0, 0)
    mat.data[EMISSION_MULT] = 1.0
    is_emission = False
    color = np.zeros(4, np.float32)
    if desc.light_id >= 0 or desc.emission_color is not None:
        color = (_read_color(desc.emission_color)
                 if desc.emission_color is not None
                 else np.zeros(4, np.float32))
        is_emission = (desc.light_id >= 0
                       or float(np.linalg.norm(color)) > 1e-5)
        mat.texid[0] = 0
        mat.colors[EMISSION_COLOR] = color
        mat.mtype = MAT_TYPE_LIGHT_SOURCE
    else:
        color = _read_color(desc.diffuse_color)
        if desc.diffuse_tex_id >= 0:
            mat.texid[0] = tc.slot(desc.diffuse_tex_id)
            mat.row0[0], mat.row1[0] = _tex_rows(desc.diffuse_tex_matrix)
    refl_color = np.zeros(4, np.float32)
    refl_gloss = 1.0
    if desc.reflectivity is not None:
        refl_color = _read_color(desc.reflectivity)
        refl_gloss = float(desc.glossiness)
    ln_refl = float(np.linalg.norm(refl_color))
    ln_col3 = float(np.linalg.norm(color[:3]))
    if ln_refl > 1e-5 and ln_col3 > 1e-5:
        mat.mtype = MAT_TYPE_GLTF
        mat.cflags = GLTF_COMPONENT_LAMBERT | GLTF_COMPONENT_METAL
        mat.colors[GLTF_COLOR_BASE] = color
        mat.colors[GLTF_COLOR_COAT] = (0, 0, 0, 0)
        mat.colors[GLTF_COLOR_METAL] = refl_color
        mat.data[GLTF_FLOAT_ALPHA] = ln_refl / (ln_refl + ln_col3)
        mat.data[GLTF_FLOAT_REFL_COAT] = 0.0
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
    if is_emission:
        mat.mtype = MAT_TYPE_LIGHT_SOURCE
    mat.data[GLTF_FLOAT_GLOSINESS] = refl_gloss
    mat.data[GLTF_FLOAT_IOR] = 0.0      # no fresnel node
    return mat


def _pad128(a):
    a = np.asarray(a, np.float32)
    if a.size % 128:
        a = np.concatenate([a, np.zeros(128 - a.size % 128, np.float32)])
    return a


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


def _simple_light_row(L: SimpleLightDesc):
    """A point or sphere light (hydracore3_tpu/scene/build.py:908-923)."""
    if L.kind not in ('point', 'sphere'):
        raise NotImplementedError(f'{L.kind} lights are not ported')
    m = _instance_matrix(L.matrix)
    row = dict(pos=m @ np.array([0, 0, 0, 1], np.float32),
               intensity=_read_color(L.color),
               mult=float(L.multiplier) or 1.0)
    if L.kind == 'sphere':
        radius = float(L.radius)
        scale = np.array([np.linalg.norm(m[:3, i]) for i in range(3)])
        radius *= scale[0]
        return _light_row(**row, geom_type=LIGHT_GEOM_SPHERE,
                          size=np.array([radius, radius], np.float32),
                          pdf_a=1.0 / (4.0 * np.pi * radius * radius))
    nrm = m @ np.array([0, -1, 0, 0], np.float32)
    return _light_row(**row, norm=nrm / max(np.linalg.norm(nrm[:3]), 1e-20),
                      geom_type=LIGHT_GEOM_POINT, dist_type=LIGHT_DIST_OMNI)


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
    if accel not in ('auto', 'stream', 'stream_tlas'):
        raise NotImplementedError(f'accel={accel!r} is not ported')
    from ..accel import build_bvh
    from ..accel import traverse_stream as TST
    from ..accel import traverse_dda as TDD
    from ..accel import traverse_pallas as TPL
    from ..accel import wide_bvh as WB

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_scene: no CUDA device; pass device='cpu' to build "
                "the scene for the plain CPU path")
        device = 'cuda'
    device = torch.device(device)
    tc = _TexCache(desc.textures)

    # the area lights' emissive quads, materials and instances
    materials = list(desc.materials)
    meshes = list(desc.meshes)
    instances = [(mesh_id, _instance_matrix(m), -1)
                 for mesh_id, m in desc.instances]
    for i, L in enumerate(desc.lights):
        emis = tuple(c * L.multiplier for c in L.color)
        mat_id = len(materials)
        materials.append(MaterialDesc(name=f'light{i}_material',
                                      emission_color=emis, light_id=i))
        hw, hl = L.half_width, L.half_length
        meshes.append(MeshDesc(
            pos=np.array([[-hw, 0, -hl], [hw, 0, -hl], [hw, 0, hl],
                          [-hw, 0, hl]], np.float32),
            indices=np.array([[0, 1, 2], [0, 2, 3]]),
            mat_indices=np.array([mat_id, mat_id]),
            norm=np.tile(np.array([[0, -1, 0]], np.float32), (4, 1))))
        instances.append((len(meshes) - 1, _instance_matrix(L.matrix), i))

    # ---- lights: area lights, then the env (LoadSceneLights) ---------------
    lights = []
    arrays1f = []
    env = dict(color=np.zeros(4, np.float32), tex_id=-1,
               sam_row0=np.array([1, 0, 0, 0], np.float32),
               sam_row1=np.array([0, 1, 0, 0], np.float32), light_id=-1)
    for L in desc.lights:
        m = _instance_matrix(L.matrix)
        power = float(L.multiplier) or 1.0
        pos = m @ np.array([0, 0, 0, 1], np.float32)
        nrm = m @ np.array([0, -1, 0, 0], np.float32)
        scale = np.array([np.linalg.norm(m[:3, i]) for i in range(3)])
        mm = m.copy()
        mm[:3, 3] = 0
        size = np.array([float(L.half_length), float(L.half_width)],
                        np.float32)
        lights.append(_light_row(
            pos=pos, norm=nrm / max(np.linalg.norm(nrm[:3]), 1e-20),
            intensity=_read_color(L.color), matrix=mm, size=size,
            pdf_a=1.0 / (4.0 * size[0] * size[1] * scale[0] * scale[2]),
            mult=power, geom_type=LIGHT_GEOM_RECT))
    lights += [_simple_light_row(L) for L in desc.simple_lights]
    if desc.env is not None:
        E = desc.env
        tex = desc.textures[E.tex_id] if 0 <= E.tex_id < len(desc.textures) \
            else None
        if tex is None or tex.dtype == np.uint8:
            raise NotImplementedError('only a float lat-long env map with '
                                      'importance sampling is ported')
        color = _read_color(E.color)
        tslot = tc.slot(E.tex_id)
        r0, r1 = _tex_rows(E.tex_matrix)
        tm = np.eye(4, dtype=np.float32)
        tm[0], tm[1] = r0, r1
        tmi = np.linalg.inv(tm)
        img = TEX.decode_image(tex)
        # PdfTableFromImage (integrator_pt_scene_lgt.cpp:237-270)
        lum = np.max(img[..., :3], axis=-1).astype(np.float64)
        lum = np.maximum(lum, 0.1 * lum.mean())
        prefix = np.zeros(lum.size + 1, np.float32)
        prefix[1:] = np.cumsum(lum.reshape(-1))
        env.update(color=color, tex_id=tslot, sam_row0=r0, sam_row1=r1,
                   light_id=len(lights))
        lights.append(_light_row(
            intensity=color, sam_row0=r0, sam_row1=r1, sam_row0_inv=tmi[0],
            sam_row1_inv=tmi[1], mult=float(E.multiplier) or 1.0,
            geom_type=LIGHT_GEOM_ENV, dist_type=LIGHT_DIST_OMNI,
            pdf_table_offset=sum(a.size for a in arrays1f),
            pdf_table_size_x=img.shape[1], pdf_table_size_y=img.shape[0],
            tex_id=tslot))
        arrays1f.append(prefix)

    # ---- materials, with the light-material intensity sync ----------------
    mats = []
    for md in materials:
        mat = _convert_material(md, tc)
        if md.light_id >= 0:
            mat.colors[EMISSION_COLOR] = lights[md.light_id]['intensity']
            mat.data[EMISSION_MULT] = lights[md.light_id]['mult']
        mat.texid[1] = INVALID_ID
        mats.append(mat)

    # ---- camera (LoadSceneCamera) -----------------------------------------
    cam = desc.camera
    proj = lmath.perspective_matrix(float(cam.fov),
                                    float(desc.width) / float(desc.height),
                                    float(cam.near), float(cam.far))
    world_view = lmath.look_at(np.array(cam.pos, np.float32),
                               np.array(cam.look_at, np.float32),
                               np.array(cam.up, np.float32))
    proj_inv = np.linalg.inv(proj).astype(np.float32)
    world_view_inv = np.linalg.inv(world_view).astype(np.float32)

    # ---- two-level, or the world-space soup (LoadSceneInstances) -----------
    soup_T = sum(len(np.asarray(meshes[mesh_id].indices).reshape(-1, 3))
                 for mesh_id, _, _ in instances)
    unique_T = sum(len(np.asarray(mesh.indices).reshape(-1, 3))
                   for mesh in meshes)
    use_stream_tlas = accel == 'stream_tlas' or (
        accel == 'auto' and soup_T > 200_000 and soup_T > 2 * unique_T)
    remap_inst = [(-1, light_id) for _, _, light_id in instances]
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
        soup_v0, soup_e1, soup_e2, soup = _world_soup(meshes, instances)

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
    tex0_const = _tex0_consts(mats, tc.pool)

    pool = tc.pool.finish(device)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    def light_col(key, dtype=np.float32):
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
        remap_inst=dev(remap_inst, np.int64),
        # no description carries a remap list yet: the empty table
        all_remap_lists=dev([0], np.int64), all_remap_lists_size=0,
        arrays1f=dev(_pad128(np.concatenate(arrays1f) if arrays1f
                             else np.zeros(1, np.float32))),
        env_color=dev(env['color']),
        env_tex_id=dev(env['tex_id'], np.int64),
        env_sam_row0=dev(env['sam_row0']), env_sam_row1=dev(env['sam_row1']),
        env_light_id=dev(env['light_id'], np.int64),
        proj_inv=dev(proj_inv), world_view_inv=dev(world_view_inv),
        cam_response_rgb=dev(np.ones(4, np.float32)),
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
        width=desc.width, height=desc.height, trace_depth=desc.trace_depth,
        spp=desc.spp, num_lights=len(lights), num_materials=len(mats),
        has_env_map=env['tex_id'] >= 0, env_enable_sam=env['tex_id'] >= 0,
        num_tris=soup_T if use_stream_tlas else int(len(soup_v0)),
        use_stream=use_stream, use_stream_tlas=use_stream_tlas,
        use_pallas=use_pallas,
        mat_types_present=tuple(sorted({m_.mtype for m_ in mats})),
        light_geom_types=tuple(int(l['geom_type']) for l in lights),
        tex0_all_const=tex0_const is not None)
    return scene, meta
