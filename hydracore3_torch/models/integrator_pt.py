"""The batched MIS path tracer on the streamed-BVH scene class.

The counterpart of ``hydracore3_tpu/models/integrator_pt.py`` for RGB mode
and a pinhole camera: one ``trace_pass`` runs a ``[N]`` ray batch through
init eye rays -> ``trace_depth`` x (sort -> nearest hit -> NEE -> next
bounce) -> environment.  Dead rays are masked rather than removed, and the
masked RNG updates keep every ray's random stream identical to the
reference's per-thread sequence.  Nearest hits go through the grid march
(``accel/traverse_dda.py``), with the BVH walk
(``accel/traverse_stream.py``) for lanes the march leaves unresolved; shadow
rays go through the BVH walk's any-hit query.  Ray flags and RNG states
are int64 tensors holding uint32 values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import lmath as LM
from ..ops import rng as RNG
from ..accel import traverse_dda as TDD
from ..accel import traverse_stream as TST
from ..bsdf import common as C
from ..bsdf import dispatch as MAT
from ..scene.build import MAT_TYPE_LIGHT_SOURCE, EMISSION_COLOR
from .. import lights as LGT

INTEGRATOR_MIS_PT = 2
FB_COLOR = 0

_F32MAX = LM.FLT_MAX
_MISS_T = 3.4e38


def _is_dead(flags):
    return (flags & C.RAY_FLAG_IS_DEAD) != 0


def _has_non_spec(flags):
    return (flags & C.RAY_FLAG_HAS_NON_SPEC) != 0


def _extract_mat_id(flags):
    return flags & 0x00FFFFFF


class RayState(NamedTuple):
    ray_pos: torch.Tensor       # [N, 3]
    ray_dir: torch.Tensor       # [N, 3]
    flags: torch.Tensor         # [N] i64 (top byte flags, low 24 bits matId)
    accum_color: torch.Tensor   # [N, 4]
    throughput: torch.Tensor    # [N, 4]
    mis_pdf: torch.Tensor       # [N]
    rng: torch.Tensor           # [N, 2] i64 (u32 values)
    hit_pos: torch.Tensor       # [N, 3]
    hit_norm: torch.Tensor      # [N, 3]
    hit_tang: torch.Tensor      # [N, 3]
    hit_uv: torch.Tensor        # [N, 2]
    hit_inst: torch.Tensor      # [N] i64


def _permute_state(state: RayState, orig, perm):
    """Apply a row permutation to the whole ray state and ``orig``."""
    return RayState(*(a[perm] for a in state)), orig[perm]


def _grid_cell_key(grid, pos, d):
    """Sort key (origin grid cell major, quantized direction minor)."""
    lo = torch.tensor(grid.lo, dtype=torch.float32, device=pos.device)
    h = torch.tensor(grid.h, dtype=torch.float32, device=pos.device)
    dims = torch.tensor(grid.dims, dtype=torch.int64, device=pos.device)
    q = torch.floor((pos - lo) / h).to(torch.int64)
    q = torch.minimum(torch.clamp(q, min=0), dims - 1)
    d1, d2 = grid.dims[1], grid.dims[2]
    cell = q[:, 0] * (d1 * d2) + q[:, 1] * d2 + q[:, 2]
    u = torch.clamp(d[:, 0] * 16 + 16, 0, 31).to(torch.int64)
    v = torch.clamp(d[:, 1] * 16 + 16, 0, 31).to(torch.int64)
    return cell * 1024 + (u * 32 + v)


def _sort_rays_for_trace(state: RayState, orig, grid):
    """Bounce-ray coherence sort: live rays by (origin grid cell, direction),
    dead rays last.  ``orig`` tracks each row's original position so the
    pass can invert the composed permutation.  Returns (state, orig)."""
    key = _grid_cell_key(grid, state.ray_pos, state.ray_dir)
    key = torch.where(_is_dead(state.flags), 0x7FFFFFFF, key)
    perm = torch.sort(key, stable=True).indices
    return _permute_state(state, orig, perm)


def sample_camera_ray(scene, meta, rng_state, xs, ys):
    """SampleCameraRay (integrator_pt.cpp:44-126), pinhole: pixel jitter."""
    rng_state, pixel_offsets = RNG.rnd_lens(rng_state)
    x_norm = (xs.to(torch.float32) + pixel_offsets[..., 0]) / float(meta.width)
    y_norm = (ys.to(torch.float32) + pixel_offsets[..., 1]) / float(meta.height)
    ray_dir = LM.eye_ray_dir_normalized(x_norm, y_norm, scene.proj_inv)
    return rng_state, torch.zeros_like(ray_dir), ray_dir


def kernel_init_eye_ray(scene, meta, rng_state, pixel_ids) -> RayState:
    """kernel_InitEyeRay2 (integrator_pt.cpp:129-157)."""
    N = pixel_ids.shape[0]
    dev = pixel_ids.device
    xs = torch.remainder(pixel_ids, meta.width)
    ys = torch.div(pixel_ids, meta.width, rounding_mode='floor')
    rng_state, ray_pos, ray_dir = sample_camera_ray(scene, meta, rng_state,
                                                    xs, ys)
    ray_pos, ray_dir = LM.transform_ray3f(scene.world_view_inv, ray_pos,
                                          ray_dir)

    def zeros(*shape):
        return torch.zeros((N,) + shape, dtype=torch.float32, device=dev)

    return RayState(
        ray_pos=ray_pos, ray_dir=ray_dir,
        flags=torch.zeros(N, dtype=torch.int64, device=dev),
        accum_color=zeros(4),
        throughput=torch.ones((N, 4), dtype=torch.float32, device=dev),
        mis_pdf=torch.ones(N, dtype=torch.float32, device=dev),
        rng=rng_state, hit_pos=zeros(3), hit_norm=zeros(3), hit_tang=zeros(3),
        hit_uv=zeros(2),
        hit_inst=torch.zeros(N, dtype=torch.int64, device=dev))


def nearest_hit(scene, ray_pos, ray_dir, t_min, t_max):
    """The streamed scene's nearest-hit query: the grid march, then the BVH
    walk for the lanes the march left unresolved, gathered into a batch of
    their own (none, as a rule, so the walk is then not launched).
    Returns (t, tri, u, v)."""
    pt, ptri, pu, pv, un = TDD.intersect_march(
        scene.st_grid, scene.st_woop, ray_pos, ray_dir, t_min, t_max,
        with_unresolved=True)
    sel = torch.nonzero(un).squeeze(1)
    if sel.numel() > 0:
        ft, ftri, fu, fv = TST.intersect_stream(
            scene.st_nodes_f, scene.st_nodes_i, scene.st_woop, ray_pos[sel],
            ray_dir[sel], t_min[sel], t_max[sel])
        pt, ptri, pu, pv = (a.index_put((sel,), b) for a, b in
                            ((pt, ft), (ptri, ftri), (pu, fu), (pv, fv)))
    return pt, ptri, pu, pv


def kernel_ray_trace(scene, meta, state: RayState, bounce: int) -> RayState:
    """kernel_RayTrace2 (integrator_pt.cpp:214-348): nearest hit + shading
    prep from the baked per-triangle shade rows."""
    live = ~_is_dead(state.flags)
    t_min = torch.zeros_like(state.mis_pdf)
    t_max = torch.where(live, _F32MAX, 0.0)
    pt, ptri, pu, pv = nearest_hit(scene, state.ray_pos, state.ray_dir,
                                   t_min, t_max)
    found = ptri >= 0
    safe = torch.clamp(ptri, min=0)
    hit_t = torch.where(found, pt, _MISS_T)
    hit_inst = torch.where(found, scene.tri_inst_id[safe], -1)
    hit_pos = state.ray_pos + (hit_t * (1.0 - 1e-6))[:, None] * state.ray_dir

    shade = scene.tri_shade[safe]                      # [N, 32]
    # barycentric lerp: data = (1-u-v) A + u B + v C (integrator_pt.cpp:270)
    data = ((1.0 - pu - pv)[:, None] * shade[:, 0:8]
            + pu[:, None] * shade[:, 8:16] + pv[:, None] * shade[:, 16:24])
    hit_norm = LM.normalize(data[:, 0:3])
    hit_tang = LM.normalize(data[:, 4:7])
    hit_uv = torch.stack([data[:, 3], data[:, 7]], dim=-1)
    mid = shade[:, 24].to(torch.int64)

    flip = torch.where(LM.dot(state.ray_dir, hit_norm) > 0.001, -1.0, 1.0)
    hit_norm = flip[:, None] * hit_norm
    hit_tang = flip[:, None] * hit_tang
    inv_flag = C.RAY_FLAG_HAS_INV_NORMAL
    flags = torch.where(flip < 0.0, state.flags | inv_flag,
                        state.flags & ~inv_flag)
    flags_hit = (flags & 0xFF000000) | (mid & 0x00FFFFFF)
    miss_add = (C.RAY_FLAG_IS_DEAD | C.RAY_FLAG_OUT_OF_SCENE
                | (C.RAY_FLAG_PRIME_RAY_MISS if bounce == 0 else 0))
    new_flags = torch.where(live, torch.where(found, flags_hit,
                                              state.flags | miss_add),
                            state.flags)
    keep = ~live | ~found
    k3 = keep[:, None]
    return state._replace(
        flags=new_flags,
        hit_pos=torch.where(k3, state.hit_pos, hit_pos),
        hit_norm=torch.where(k3, state.hit_norm, hit_norm),
        hit_tang=torch.where(k3, state.hit_tang, hit_tang),
        hit_uv=torch.where(k3, state.hit_uv, hit_uv),
        hit_inst=torch.where(keep, state.hit_inst, hit_inst))


class ShadowRays(NamedTuple):
    pos: torch.Tensor           # [N, 3]
    dir: torch.Tensor           # [N, 3]
    t_max: torch.Tensor         # [N] (0 where no ray is traced)
    need_trace: torch.Tensor    # [N] bool


def sample_shadow_rays(scene, meta, state: RayState):
    """NEE's light sample and the shadow ray toward it, per lane.

    Returns (new rng state, light_id, light sample dict, ShadowRays)."""
    live = ~_is_dead(state.flags)
    rng_state, rands = RNG.rnd_lgts(state.rng, live)
    light_id = torch.clamp(
        (rands[:, 3] * meta.num_lights).to(torch.int64),
        max=meta.num_lights - 1)
    lsam = LGT.light_sample_rev(scene, meta, light_id, rands[:, :3],
                                state.hit_pos)
    hit_dist = torch.sqrt(((state.hit_pos - lsam['pos']) ** 2).sum(-1))
    shadow_dir = LM.normalize(lsam['pos'] - state.hit_pos)
    offs = torch.clamp(LM.maxcomp(state.hit_pos), min=1.0) * 5e-6
    shadow_pos = state.hit_pos + state.hit_norm * offs[:, None]

    in_illum = (LM.dot(shadow_dir, lsam['norm']) < 0.0) | lsam['is_omni']
    need_trace = live & in_illum
    s_tmax = torch.where(need_trace, hit_dist * 0.9995, 0.0)
    return rng_state, light_id, lsam, ShadowRays(shadow_pos, shadow_dir,
                                                 s_tmax, need_trace)


def sorted_shadow_query(grid, rays: ShadowRays):
    """The shadow rays in coherence order (origin grid cell, quantized
    direction; untraced lanes last).  Returns (perm, pos, dir, t_min,
    t_max): the permutation and the any-hit query's arguments."""
    key = _grid_cell_key(grid, rays.pos, rays.dir)
    key = torch.where(rays.need_trace, key, 0x7FFFFFFF)
    perm = torch.sort(key, stable=True).indices
    return (perm, rays.pos[perm], rays.dir[perm],
            torch.zeros_like(rays.t_max), rays.t_max[perm])


def shadow_occluded(scene, rays: ShadowRays):
    """Any-hit shadow query in coherence order, inverted by a scatter."""
    perm, *query = sorted_shadow_query(scene.st_grid, rays)
    _, stri, _, _ = TST.intersect_stream(
        scene.st_nodes_f, scene.st_nodes_i, scene.st_woop, *query,
        any_hit=True)
    occluded = torch.empty_like(rays.need_trace)
    occluded[perm] = stri >= 0
    return occluded


def kernel_sample_light_source(scene, meta, state: RayState, ctx):
    """kernel_SampleLightSource (integrator_pt.cpp:350-424), MIS.

    Returns (shade_color [N, 4], new rng state)."""
    rng_state, light_id, lsam, rays = sample_shadow_rays(scene, meta, state)
    shadow_pos, shadow_dir = rays.pos, rays.dir
    need_shade = rays.need_trace & ~shadow_occluded(scene, rays)

    bsdf = MAT.material_eval(ctx, shadow_dir, -state.ray_dir)
    cos_out = torch.clamp(LM.dot(shadow_dir, state.hit_norm), min=0.0)
    lgt_pdf_w = LGT.light_pdf_select_rev(meta) * LGT.light_eval_pdf(
        scene, meta, light_id, shadow_pos, shadow_dir, lsam['pos'],
        lsam['norm'], lsam['pdf'])
    mis = LM.mis_weight_heuristic(lgt_pdf_w, bsdf['pdf'])
    light_color = LGT.light_intensity(scene, meta, light_id, shadow_dir)
    shade = (light_color * bsdf['val']
             / torch.clamp(lgt_pdf_w, min=1e-30)[:, None]
             * (cos_out * mis)[:, None])
    return torch.where(need_shade[:, None], shade, 0.0), rng_state


def kernel_next_bounce(scene, meta, state: RayState, bounce: int,
                       shade_color, ctx) -> RayState:
    """kernel_NextBounce (integrator_pt.cpp:426-548), MIS."""
    live = ~_is_dead(state.flags)
    md = ctx['md']
    is_light_mat = md['mtype'] == MAT_TYPE_LIGHT_SOURCE

    # light-hit branch (integrator_pt.cpp:461-506)
    inst = torch.clamp(state.hit_inst, 0, scene.remap_inst.shape[0] - 1)
    light_id = scene.remap_inst[inst, 1]
    light_intensity = md['colors'][:, EMISSION_COLOR, :] * ctx['tex_color']
    has_light = light_id >= 0
    ld_hit = LGT.gather_light(scene, light_id)
    light_cos = LM.dot(state.ray_dir, ld_hit['norm'][:, :3])
    atten = torch.where(light_cos < 0.0, 1.0, 0.0)
    li_from_light = (LGT.light_intensity(scene, meta, light_id, state.ray_dir)
                     * atten[:, None])
    light_intensity = torch.where(has_light[:, None], li_from_light,
                                  light_intensity)
    mis_weight_l = torch.ones_like(state.mis_pdf)
    if bounce > 0:
        lgt_pdf = LGT.light_pdf_select_rev(meta) * LGT.light_eval_pdf(
            scene, meta, light_id, state.ray_pos, state.ray_dir,
            state.hit_pos, state.hit_norm, torch.ones_like(state.mis_pdf))
        w = LM.mis_weight_heuristic(state.mis_pdf, lgt_pdf)
        w = torch.where(state.mis_pdf <= 0.0, 1.0, w)
        mis_weight_l = torch.where(has_light, w, 1.0)
    light_branch = live & is_light_mat
    accum_light = (state.accum_color
                   + state.throughput * light_intensity * mis_weight_l[:, None])
    flags_light = state.flags | C.RAY_FLAG_IS_DEAD | C.RAY_FLAG_HIT_LIGHT

    # surface branch: sample the BSDF
    surf_live = live & ~is_light_mat
    mat_sam, rng_state = MAT.material_sample_and_eval(ctx, state.rng,
                                                      surf_live,
                                                      -state.ray_dir)
    bxdf_val = mat_sam['val'] / torch.clamp(mat_sam['pdf'], min=1e-20)[:, None]
    cos_theta = LM.dot(mat_sam['dir'], state.hit_norm).abs()
    new_mis_pdf = torch.where((mat_sam['flags'] & C.RAY_EVENT_S) != 0, -1.0,
                              mat_sam['pdf'])
    new_accum = state.accum_color + state.throughput * shade_color
    new_thr = state.throughput * cos_theta[:, None] * bxdf_val
    new_pos = LM.offs_ray_pos(state.hit_pos, state.hit_norm, mat_sam['dir'])
    next_flags = ((state.flags & ~C.RAY_FLAG_FIRST_NON_SPEC)
                  | mat_sam['flags'])
    first_ns = ~_has_non_spec(state.flags) & _has_non_spec(next_flags)
    next_flags = torch.where(first_ns,
                             next_flags | C.RAY_FLAG_FIRST_NON_SPEC,
                             next_flags)

    lb, sb = light_branch[:, None], surf_live[:, None]
    return state._replace(
        accum_color=torch.where(lb, accum_light,
                                torch.where(sb, new_accum, state.accum_color)),
        throughput=torch.where(sb, new_thr, state.throughput),
        flags=torch.where(light_branch, flags_light,
                          torch.where(surf_live, next_flags, state.flags)),
        ray_pos=torch.where(sb, new_pos, state.ray_pos),
        ray_dir=torch.where(sb, mat_sam['dir'], state.ray_dir),
        mis_pdf=torch.where(surf_live, new_mis_pdf, state.mis_pdf),
        rng=rng_state)


def kernel_hit_environment(scene, meta, state: RayState) -> RayState:
    """kernel_HitEnvironment (integrator_pt.cpp:550-595), MIS."""
    out = (state.flags & C.RAY_FLAG_OUT_OF_SCENE) != 0
    env_color, env_pdf = LGT.environment_color(scene, meta, state.ray_dir,
                                               True)
    if meta.env_enable_sam:
        is_spec = state.mis_pdf < 0.0
        exit_zero = (state.flags & C.RAY_FLAG_PRIME_RAY_MISS) != 0
        mis = LM.mis_weight_heuristic(
            state.mis_pdf, LGT.light_pdf_select_rev(meta) * env_pdf)
        env_color = torch.where((~is_spec & ~exit_zero)[:, None],
                                env_color * mis[:, None], env_color)
    new_accum = state.accum_color + state.throughput * env_color
    return state._replace(accum_color=torch.where(out[:, None], new_accum,
                                                  state.accum_color))


def trace_pass(scene, meta, rng_state, pixel_ids,
               integrator_type: int = INTEGRATOR_MIS_PT,
               render_layer: int = FB_COLOR):
    """One full MIS sample per pixel id.  Returns (accum_color [N, 4],
    flags [N] i64, new rng state [N, 2] i64)."""
    if integrator_type != INTEGRATOR_MIS_PT or render_layer != FB_COLOR:
        raise NotImplementedError('only the MIS integrator into the color '
                                  'layer is ported')
    state = kernel_init_eye_ray(scene, meta, rng_state, pixel_ids)
    orig = torch.arange(pixel_ids.shape[0], device=pixel_ids.device)
    for b in range(meta.trace_depth):
        if b > 0:
            state, orig = _sort_rays_for_trace(state, orig, scene.st_grid)
        state = kernel_ray_trace(scene, meta, state, b)
        ctx = MAT.make_shading_ctx(scene, meta, _extract_mat_id(state.flags),
                                   state.hit_norm, state.hit_tang,
                                   state.hit_uv)
        shade, rng2 = kernel_sample_light_source(scene, meta, state, ctx)
        state = state._replace(rng=rng2)
        state = kernel_next_bounce(scene, meta, state, b, shade, ctx)
    # restore positional order: the inverse of the composed sorts
    inv = torch.empty_like(orig)
    inv[orig] = torch.arange(orig.shape[0], device=orig.device)
    state, _ = _permute_state(state, orig, inv)
    state = kernel_hit_environment(scene, meta, state)
    return state.accum_color, state.flags, state.rng
