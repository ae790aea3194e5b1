"""Whitted ray tracing and the primary-ray pass (reference integrator_rt.cpp).

The counterpart of ``hydracore3_tpu/models/integrator_rt.py``.
``ray_trace`` is the mirror-reflection Whitted integrator with a direct
loop over every light (kernel_RayBounce, integrator_rt.cpp:196-283);
``cast_single_ray`` is the flat-colour primary pass (CastSingleRay,
:420-430).  Deterministic: rays go through pixel centres, no RNG.

The JAX functions trace the world-space soup by brute force or its BVH; the
port answers the same (t, triangle, u, v) query with the scene class's own
kernel (``intersect``): the cluster kernel (K5) over ``scene.cl_wide`` on
small and mid-size soups, the grid march (K3, with the stream walk K2 for
lanes it leaves) and K2's any-hit on streamed soups, the TLAS kernel (K4)
on the ``stream_tlas`` scenes, which keep no soup.  A scene with a moving
instance keeps its soup at the shutter's open, which is traced here, as in
the JAX package (its Whitted pass has no time).  A hit reads its uv and
normal from the soup's baked world-space shade rows (the streamed
two-level scenes: the object-space rows through the instance's normal
matrix) and its material from the mesh's own ids (``mat_id_by_prim``, no
remap list), as the JAX ``_shading_data`` reads them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel import hit_grad as HG
from ..accel import traverse_pallas as TPL
from ..accel import traverse_stream as TST
from ..accel import traverse_tlas as TT
from ..bsdf import common as C
from ..bsdf import dispatch as MAT
from ..ops import texture as TEX
from ..scene.build import (MAT_TYPE_LIGHT_SOURCE, GLTF_COLOR_BASE,
                           GLTF_COLOR_METAL, GLTF_COLOR_COAT,
                           GLTF_FLOAT_ALPHA)
from ..utils import lmath as LM
from . import integrator_pt as IPT


class Hit(NamedTuple):
    """A nearest hit with the JAX ``Hit``'s ids (-1 on a miss) and the
    world-space normal, uv and material of the point hit."""
    t: torch.Tensor          # [N] (FLT_MAX on a miss)
    inst_id: torch.Tensor    # [N] i64
    geom_id: torch.Tensor    # [N] i64
    prim_id: torch.Tensor    # [N] i64
    norm: torch.Tensor       # [N, 3] normalized
    uv: torch.Tensor         # [N, 2]
    mat_id: torch.Tensor     # [N] i64: the mesh's own material id


def primary_rays(scene, meta, pixel_ids, offsets=None):
    """World-space camera rays through the pixels at ``offsets`` [N, 2]
    within them (kernel_InitEyeRay3, integrator_rt.cpp:55-82: the
    centres by default)."""
    xs = torch.remainder(pixel_ids, meta.width).to(torch.float32)
    ys = torch.div(pixel_ids, meta.width, rounding_mode='floor') \
        .to(torch.float32)
    if offsets is None:
        x_norm = (xs + 0.5) / float(meta.width)
        y_norm = (ys + 0.5) / float(meta.height)
    else:
        x_norm = (xs + offsets[:, 0]) / float(meta.width)
        y_norm = (ys + offsets[:, 1]) / float(meta.height)
    ray_dir = LM.eye_ray_dir_normalized(x_norm, y_norm, scene.proj_inv)
    return LM.transform_ray3f(scene.world_view_inv, torch.zeros_like(ray_dir),
                              ray_dir)


def _soup_query(scene, meta):
    if not (meta.use_stream_tlas or scene.st_grid is not None
            or scene.cl_wide is not None):
        raise NotImplementedError(
            'a two-level scene of over 1M triangles keeps no world soup, '
            'and Whitted and the G-buffer trace the soup (the JAX package '
            'traces an empty one there)')


def intersect(scene, meta, ray_pos, ray_dir, t_max) -> Hit:
    """The nearest hit of each ray beyond 0 and before ``t_max``, through
    the scene class's kernel, with the shading data of the point hit."""
    _soup_query(scene, meta)
    t_min = torch.zeros_like(t_max)
    if meta.use_stream_tlas:
        t, tri, u, v, inst = HG.tlas_with_grad(scene.tt, ray_pos, ray_dir,
                                               t_min, t_max)
        found = tri >= 0
        slot = torch.clamp(tri, min=0)
        geom = torch.where(found, scene.tt_geom[slot], -1)
        prim = torch.where(found, scene.tt_prim[slot], -1)
        norm_o, _, uv = IPT._lerp_shade(scene.tt_shade[slot], u, v)
        nm = scene.tt_inst_nm[torch.clamp(inst, min=0)].reshape(-1, 4, 4)
        norm = LM.mul3x3(nm, norm_o)
    else:
        t, tri, u, v = IPT.soup_nearest_hit(scene, ray_pos, ray_dir, t_min,
                                            t_max, scene.st_grid is not None)
        found = tri >= 0
        slot = torch.clamp(tri, min=0)
        inst = torch.where(found, scene.tri_inst_id[slot], -1)
        geom = torch.where(found, scene.tri_geom_id[slot], -1)
        prim = torch.where(found, scene.tri_prim_id[slot], -1)
        norm, _, uv = IPT._lerp_shade(scene.tri_shade[slot], u, v)
    mat_id = scene.mat_id_by_prim[scene.mesh_tri_base[torch.clamp(geom,
                                                                  min=0)]
                                  + torch.clamp(prim, min=0)]
    return Hit(t=torch.where(found, t, LM.FLT_MAX),
               inst_id=torch.where(found, inst, -1), geom_id=geom,
               prim_id=prim, norm=LM.normalize(norm), uv=uv, mat_id=mat_id)


def occluded(scene, meta, ray_pos, ray_dir, t_max):
    """Any-hit of each ray beyond 0 and before ``t_max``, through the scene
    class's kernel, in lane order."""
    _soup_query(scene, meta)
    q = (ray_pos, ray_dir, torch.zeros_like(t_max), t_max)
    if meta.use_stream_tlas:
        tri = TT.intersect_stream_tlas(scene.tt, *q, any_hit=True)[1]
    elif scene.st_grid is not None:
        tri = TST.intersect_stream(scene.st_nodes_f, scene.st_nodes_i,
                                   scene.st_woop, *q, any_hit=True,
                                   wide=scene.st_wide)[1]
    else:
        tri = TPL.intersect_clusters(None, None, scene.cl_tris12, *q,
                                     any_hit=True, wide=scene.cl_wide)[1]
    return tri >= 0


def tex0_color(scene, mat_id, uv):
    """The material's slot-0 texture at uv through its texture matrix:
    (transformed uv, texel)."""
    tc_t = LM.mul_rows_2x4(scene.mat_row0[mat_id][:, 0, :],
                           scene.mat_row1[mat_id][:, 0, :], uv)
    return tc_t, TEX.sample(scene.textures,
                            MAT._clamp_tex(scene,
                                           scene.mat_texid[mat_id][:, 0]),
                            tc_t)


def cast_single_ray(scene, meta, pixel_ids):
    """CastSingleRay + kernel_GetRayColor: flat albedo, no lighting.
    Returns [N, 4] float32 colours (alpha 0)."""
    ray_pos, ray_dir = primary_rays(scene, meta, pixel_ids)
    hit = intersect(scene, meta, ray_pos, ray_dir,
                    torch.full_like(ray_pos[:, 0], LM.FLT_MAX))
    found = hit.geom_id >= 0
    mdata = scene.mat_colors[hit.mat_id][:, GLTF_COLOR_BASE, :]
    _, tex_color = tex0_color(scene, hit.mat_id, hit.uv)
    color = torch.where((mdata[:, 3] > 0.0)[:, None],
                        torch.clamp(mdata[:, 3:4], 0.0, 1.0).expand(-1, 4),
                        mdata * tex_color)
    color = torch.where(found[:, None], color, 0.0)
    color[:, 3] = 0.0
    return color


def ray_trace(scene, meta, pixel_ids):
    """Whitted RT (integrator_rt.cpp RayTrace, :432-461): ``trace_depth``
    bounces of a nearest hit, a light hit's emission, a shadow ray to every
    light (Lambert times the base colour and texture, the light's intensity
    without its multiplier, as the reference) and the mirror bounce.
    Returns [N, 4]."""
    N = pixel_ids.shape[0]
    dev = pixel_ids.device
    ray_pos, ray_dir = primary_rays(scene, meta, pixel_ids)
    accum = torch.zeros((N, 4), dtype=torch.float32, device=dev)
    accum[:, 3] = 1.0
    throughput = torch.ones((N, 4), dtype=torch.float32, device=dev)
    flags = torch.zeros(N, dtype=torch.int64, device=dev)
    n_inst = scene.remap_inst.shape[0]
    for _ in range(meta.trace_depth):
        live = (flags & C.RAY_FLAG_IS_DEAD) == 0
        hit = intersect(scene, meta, ray_pos, ray_dir,
                        torch.where(live, LM.FLT_MAX, 0.0))
        found = hit.geom_id >= 0
        flags = torch.where(live & ~found, flags | C.RAY_FLAG_IS_DEAD
                            | C.RAY_FLAG_OUT_OF_SCENE, flags)
        live = live & found
        mat_id = hit.mat_id
        flip = torch.where(LM.dot(ray_dir, hit.norm) > 0.001, -1.0, 1.0)
        norm = flip[:, None] * hit.norm
        hit_pos = ray_pos + (hit.t * (1.0 - 1e-6))[:, None] * ray_dir
        is_light = scene.mat_mtype[mat_id] == MAT_TYPE_LIGHT_SOURCE

        # a light hit (integrator_rt.cpp:222-243), attenuated by the
        # instanced light's normal through the instance's light id
        _, tex_color = tex0_color(scene, mat_id, hit.uv)
        base = scene.mat_colors[mat_id][:, GLTF_COLOR_BASE, :3] \
            * tex_color[:, :3]
        lgt_id = scene.remap_inst[torch.clamp(hit.inst_id, 0, n_inst - 1),
                                  1]
        light_cos = LM.dot(ray_dir, scene.light_norm[
            torch.clamp(lgt_id, min=0)][:, :3])
        atten = torch.where(lgt_id >= 0, (light_cos < 0.0).to(torch.float32),
                            1.0)
        lit = live & is_light
        accum[:, :3] += torch.where(
            lit[:, None], throughput[:, :3] * base * atten[:, None], 0.0)
        flags = torch.where(lit, flags | C.RAY_FLAG_IS_DEAD
                            | C.RAY_FLAG_HIT_LIGHT, flags)
        live_s = live & ~is_light

        # the direct loop over every light (integrator_rt.cpp:245-262)
        shade = torch.zeros((N, 3), dtype=torch.float32, device=dev)
        bsdf = LM.INV_PI * base
        offs = torch.clamp(LM.maxcomp(hit_pos), min=1.0) * 5e-6
        for lid in range(meta.num_lights):
            lpos = scene.light_pos[lid, :3]
            hit_dist = torch.sqrt(((hit_pos - lpos) ** 2).sum(-1))
            sdir = LM.normalize(lpos - hit_pos)
            occ = occluded(scene, meta, hit_pos + norm * offs[:, None], sdir,
                           torch.where(live_s, hit_dist * 0.9995, 0.0))
            visible = ~occ & (LM.dot(sdir, scene.light_norm[lid, :3].expand(
                N, 3)) < 0.0)
            cos_out = torch.clamp(LM.dot(sdir, norm), min=0.0)
            contrib = (scene.light_intensity[lid, :3] * bsdf
                       * (cos_out / torch.clamp(hit_dist * hit_dist,
                                                min=1e-20))[:, None])
            shade = shade + torch.where((visible & live_s)[:, None], contrib,
                                        0.0)

        # the mirror bounce (MaterialSampleWhitted, integrator_rt.cpp:
        # 173-193)
        colors = scene.mat_colors[mat_id]
        alpha = scene.mat_data[mat_id][:, GLTF_FLOAT_ALPHA][:, None]
        refl_dir = LM.reflect(ray_dir, norm)
        refl_color = (alpha * colors[:, GLTF_COLOR_METAL, :]
                      + (1.0 - alpha) * colors[:, GLTF_COLOR_COAT, :])
        accum[:, :3] += torch.where(live_s[:, None],
                                    throughput[:, :3] * shade, 0.0)
        ls = live_s[:, None]
        new_thr = throughput * (LM.dot(refl_dir, norm)[:, None] * refl_color)
        ray_pos = torch.where(ls, LM.offs_ray_pos(hit_pos, norm, refl_dir),
                              ray_pos)
        ray_dir = torch.where(ls, refl_dir, ray_dir)
        throughput = torch.where(ls, new_thr, throughput)
    return accum
