"""The batched path tracer on every scene class.

The counterpart of ``hydracore3_tpu/models/integrator_pt.py`` for RGB and
hero-wavelength spectral mode, the pinhole, thin-lens and lens-stack
cameras, the camera-back texture and motion blur, with its three
integrators: MIS (``mispt``), shadow rays without MIS (``shadowpt``) and the
naive tracer, which runs no NEE and takes one bounce more (``naivept``),
into the color, ``direct`` or ``indirect`` layer.  One ``trace_pass`` runs a
``[N]`` ray batch through init eye rays -> ``trace_depth`` x (sort ->
nearest hit -> NEE -> next bounce) -> environment.  Dead rays are masked
rather than removed, and the masked RNG updates keep every ray's random
stream identical to the reference's per-thread sequence.  Ray flags and
RNG states are int64 tensors holding uint32 values.  In spectral mode a
ray carries 4 hero wavelengths, drawn after its pixel offsets, which the
material eval and sample, the lights and the sky take.

Five scene classes, as the JAX integrator routes them:
  * streamed (``meta.use_stream``): nearest hits through the grid march
    (``accel/traverse_dda.py``), with the BVH walk
    (``accel/traverse_stream.py``) for lanes the march leaves unresolved;
    shadow rays through the walk's any-hit query, in a coherence order of
    their own;
  * two-level (``meta.use_stream_tlas``): both queries through the TLAS
    walk (``accel/traverse_tlas.py``); the hit's object-space shade row is
    taken to world space by the instance's normal matrix and its material
    id through the instance's remap list; bounce rays are sorted by an
    octant + origin-Morton key (these scenes have no grid);
  * two-level traced by time (``meta.use_two_level``: a scene with a
    moving instance): both queries through the moving two-level walk
    (``accel/two_level.py``) at each ray's shutter time, drawn after the
    lens samples; the normal and tangent through both ends' normal
    matrices, lerped by time; unsorted, as in JAX;
  * mid-size (``meta.use_pallas``): both queries through the cluster walk
    (``accel/traverse_pallas.py``), unsorted;
  * small (fewer than 4,096 triangles, none of the three flags): the same
    cluster walk over the soup's rows in its 4-triangle-leaf order
    (``scene.cl_tris12``, ``scene.cl_wide``), unsorted.  The JAX integrator
    traces this class by brute force or its BVH (``intersect_brute``,
    ``intersect_bvh``): the same Moller-Trumbore test on the same rows and
    the same lane contract.  The render sends such a scene here when the
    megakernel refuses it.  The same tables serve the soups of any size
    that ``accel='bvh'`` / ``'brute'`` lays out for the JAX package's XLA
    traces; a moving one (``meta.has_motion`` without
    ``meta.use_two_level``) is traced at each ray's time through the
    cluster walk's moving variant, each triangle lerped by its deltas
    (``scene.tri_dv0 / tri_de1 / tri_de2``), and its shade rows lerped by
    ``scene.tri_shade_d``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import lmath as LM
from ..utils.spans import span
from ..ops import qmc as QMC
from ..ops import rng as RNG
from ..ops import spectrum as SPEC
from ..ops import texture as TEX
from ..accel import hit_grad as HG
from ..accel import traverse_dda as TDD
from ..accel import traverse_pallas as TPL
from ..accel import traverse_stream as TST
from ..accel import traverse_tlas as TT
from ..accel import two_level as TL2
from ..bsdf import common as C
from ..bsdf import dispatch as MAT
from ..scene.build import (MAT_TYPE_LIGHT_SOURCE, EMISSION_COLOR,
                           LIGHT_GEOM_RECT, LIGHT_GEOM_ENV, LIGHT_GEOM_SPHERE,
                           LIGHT_GEOM_POINT, LIGHT_GEOM_DISC,
                           LIGHT_GEOM_DIRECT)
from .. import lights as LGT

INTEGRATOR_STUPID_PT = 0
INTEGRATOR_SHADOW_PT = 1
INTEGRATOR_MIS_PT = 2
INTEGRATOR_BY_NAME = {'naivept': INTEGRATOR_STUPID_PT,
                      'shadowpt': INTEGRATOR_SHADOW_PT,
                      'mispt': INTEGRATOR_MIS_PT}
FB_COLOR = 0
FB_DIRECT = 1
FB_INDIRECT = 2

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
    mis_ior: torch.Tensor       # [N] the IOR of the medium the ray is in
    rng: torch.Tensor           # [N, 2] i64 (u32 values)
    hit_pos: torch.Tensor       # [N, 3]
    hit_norm: torch.Tensor      # [N, 3]
    hit_tang: torch.Tensor      # [N, 3]
    hit_uv: torch.Tensor        # [N, 2]
    hit_dist: torch.Tensor      # [N] the t of the last hit
    hit_inst: torch.Tensor      # [N] i64
    wavelengths: torch.Tensor = None    # [N, 4] (spectral mode), else None
    time: torch.Tensor = None   # [N] the shutter time (a moving scene)
    pixel: torch.Tensor = None  # [N] i64 the output pixel (QMC / MLT)


def _permute_state(state: RayState, orig, perm):
    """Apply a row permutation to the whole ray state and ``orig``."""
    with span('hc3.gather.permute'):
        return RayState(*(None if a is None else a[perm] for a in state)), \
            orig[perm]


def _grid_cell_key(grid, pos, d):
    """Sort key (origin grid cell major, quantized direction minor)."""
    with span('hc3.sync.grid_key'):
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


def _morton10(q):
    """Spread 10-bit ints to every 3rd bit (a 3D Morton code's component)."""
    q = (q | (q << 16)) & 0x030000FF
    q = (q | (q << 8)) & 0x0300F00F
    q = (q | (q << 4)) & 0x030C30C3
    q = (q | (q << 2)) & 0x09249249
    return q


def _octant_morton_key(pos, d):
    """Sort key without a grid: (direction octant, 27-bit Morton code of
    the origin on a 512^3 lattice over the batch's own extent)."""
    octant = ((d[:, 0] > 0).to(torch.int64) * 4
              + (d[:, 1] > 0).to(torch.int64) * 2
              + (d[:, 2] > 0).to(torch.int64))
    lo = pos.amin(dim=0, keepdim=True)
    hi = pos.amax(dim=0, keepdim=True)
    q = torch.clamp((pos - lo) / torch.clamp(hi - lo, min=1e-6) * 511.0,
                    0, 511).to(torch.int64)
    key = (_morton10(q[:, 0]) | (_morton10(q[:, 1]) << 1)
           | (_morton10(q[:, 2]) << 2))
    return key | (octant << 27)


def _sort_rays_for_trace(state: RayState, orig, grid=None):
    """Bounce-ray coherence sort: live rays by (origin grid cell, direction)
    or, without a grid, by (direction octant, origin Morton code); dead
    rays last.  ``orig`` tracks each row's original position so the pass
    can invert the composed permutation.  Returns (state, orig)."""
    if grid is not None:
        key = _grid_cell_key(grid, state.ray_pos, state.ray_dir)
    else:
        key = _octant_morton_key(state.ray_pos, state.ray_dir)
    key = torch.where(_is_dead(state.flags), 0x7FFFFFFF, key)
    perm = torch.sort(key, stable=True).indices
    return _permute_state(state, orig, perm)


def _intersect_spherical_element(radius, z_center, pos, d):
    """IntersectSphericalElement (integrator_pt.cpp:852-874): a lens
    surface of curvature ``radius`` centred at ``z_center`` on the axis
    (both static floats).  Returns (t, normal facing the ray, hit)."""
    o = pos - torch.tensor([0.0, 0.0, z_center], dtype=torch.float32,
                           device=pos.device)
    a = LM.dot(d, d)
    b = 2.0 * LM.dot(d, o)
    c = LM.dot(o, o) - radius * radius
    disc = b * b - 4.0 * a * c
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / a
    t1 = c / torch.where(q == 0.0, 1e-20, q)
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    t = torch.where((d[..., 2] > 0.0) != (radius < 0.0), lo, hi)
    n = LM.normalize(o + t[..., None] * d)
    n = torch.where((LM.dot(n, -d) < 0.0)[..., None], -n, n)
    return t, n, (disc >= 0.0) & (t >= 0.0)


def _refract_pbrt(wi, n, eta):
    """Refract (integrator_pt.cpp:835-845), ``wi`` pointing away from the
    surface.  Returns (the refracted direction, not totally reflected)."""
    cos_i = LM.dot(n, wi)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return eta * -wi + (eta * cos_i - cos_t)[..., None] * n, sin2_t < 1.0


def trace_lenses_from_film(meta, ray_pos, ray_dir):
    """TraceLensesFromFilm (integrator_pt.cpp:876-938): a ray from the film
    through the lens stack ``meta.lens_lines`` (a loop over its static
    lines; a line of curvature 0 is the aperture stop).  Returns (pos, dir,
    ok) in camera space; ``ok`` is False where a surface is missed, the
    ray leaves an aperture or is totally reflected."""
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=torch.float32,
                        device=ray_pos.device)
    pos, d = ray_pos * flip, ray_dir * flip
    ok = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    lines = meta.lens_lines
    element_z = 0.0
    for i, (curv, thick, eta_i, aper) in enumerate(lines):
        element_z -= thick
        if curv == 0.0:     # the aperture stop
            ok = ok & (d[..., 2] < 0.0)
            t = (element_z - pos[..., 2]) / torch.where(d[..., 2] == 0.0,
                                                        -1e-20, d[..., 2])
        else:
            t, n, hit = _intersect_spherical_element(curv, element_z + curv,
                                                     pos, d)
            ok = ok & hit
        p_hit = pos + t[..., None] * d
        ok = ok & (p_hit[..., 0] ** 2 + p_hit[..., 1] ** 2 <= aper * aper)
        pos = torch.where(ok[..., None], p_hit, pos)
        if curv != 0.0:
            eta_t = lines[i + 1][2] if i + 1 < len(lines) else 1.0
            wt, rok = _refract_pbrt(LM.normalize(-d), n,
                                    eta_i / (eta_t if eta_t != 0.0 else 1.0))
            ok = ok & rok
            d = torch.where(ok[..., None], wt, d)
    return pos * flip, d * flip, ok


def qmc_float(qmc_ctx, dim: int):
    """The QMC context's draw of dimension ``dim`` for its sample indices."""
    return QMC.rnd_float(qmc_ctx['table'], qmc_ctx['idx'], dim)


def mlt_slice(qmc_ctx, offset: int, n: int = 4):
    """``n`` randoms of the MLT chains' primary-sample vectors from
    ``offset`` + 10 x the bounce (BOUNCE_START 6 + b * PER_BOUNCE)."""
    off = 6 + 10 * qmc_ctx['bounce'] + offset
    return qmc_ctx['mlt_rands'][:, off:off + n]


def sample_camera_ray(scene, meta, rng_state, xs, ys, qmc_ctx=None):
    """SampleCameraRay (integrator_pt.cpp:44-126): pixel jitter; the thin
    lens (``meta.cam_lens_radius``) or the lens stack
    (``meta.lens_lines``) from the same draw's two lens randoms; then the
    shutter time of a moving scene (``meta.has_motion``) and in spectral
    mode the wavelength draw, in that order.  A ray that fails the lens
    stack starts far below the scene, looking down, as in the reference.
    Returns (rng state, ray pos, ray dir, (time [N] or None, wavelength
    sample [N] or None), (xs, ys): the pixel the sample landed on).

    With ``qmc_ctx`` (IntegratorQMC, mlt/integrator_qmc.cpp:148-216) the
    pixel position comes from QMC dimensions 0/1, and for the thin lens
    (only: the lens stack keeps its pseudo randoms, as the JAX package
    does) the lens randoms from dimensions 2/3; with ``mlt_rands`` in it
    (Kelemen MLT, integrator_kmlt.cpp:87-151) the chains' vectors' first
    four give both, the fifth the wavelength.  The pseudo draws are made
    all the same, so that every later random of the lane is the
    reference's."""
    rng_state, pixel_offsets = RNG.rnd_lens(rng_state)
    mlt = qmc_ctx is not None and 'mlt_rands' in qmc_ctx
    if qmc_ctx is not None:
        if mlt:
            pixel_offsets = qmc_ctx['mlt_rands'][:, 0:4]
        else:
            lens = ((qmc_float(qmc_ctx, 2), qmc_float(qmc_ctx, 3))
                    if meta.cam_lens_radius > 0.0 else
                    (pixel_offsets[:, 2], pixel_offsets[:, 3]))
            pixel_offsets = torch.stack([qmc_float(qmc_ctx, 0),
                                         qmc_float(qmc_ctx, 1), *lens], -1)
        x_norm, y_norm = pixel_offsets[:, 0], pixel_offsets[:, 1]
        xs = torch.clamp((x_norm * meta.width).to(torch.int64),
                         max=meta.width - 1)
        ys = torch.clamp((y_norm * meta.height).to(torch.int64),
                         max=meta.height - 1)
    else:
        x_norm = ((xs.to(torch.float32) + pixel_offsets[..., 0])
                  / float(meta.width))
        y_norm = ((ys.to(torch.float32) + pixel_offsets[..., 1])
                  / float(meta.height))
    ray_dir = LM.eye_ray_dir_normalized(x_norm, y_norm, scene.proj_inv)
    ray_pos = torch.zeros_like(ray_dir)
    if meta.cam_lens_radius > 0.0:
        focus_pos = ray_dir * (meta.cam_target_dist
                               / -ray_dir[..., 2])[..., None]
        xy = meta.cam_lens_radius * 2.0 * LM.map_samples_to_disc(
            pixel_offsets[..., 2:4] - 0.5)
        ray_pos = torch.cat([xy, ray_pos[..., 2:]], -1)
        ray_dir = LM.normalize(focus_pos - ray_pos)
    elif meta.lens_lines:
        # the film point, shot at the rear element, through the stack
        film_pos = torch.stack(
            [0.25 * meta.phys_size[0] * (2.0 * x_norm - 1.0),
             0.25 * meta.phys_size[1] * (2.0 * y_norm - 1.0),
             torch.zeros_like(x_norm)], -1)
        rear_z, rear_r = meta.lens_lines[0][1], meta.lens_lines[0][3]
        rare = rear_r * 2.0 * LM.map_samples_to_disc(
            pixel_offsets[..., 2:4] - 0.5)
        shoot_to = torch.cat([rare, torch.full_like(x_norm, rear_z)[:, None]],
                             -1)
        pos_o, dir_o, ok = trace_lenses_from_film(
            meta, film_pos, LM.normalize(shoot_to - film_pos))
        miss_pos = torch.zeros_like(ray_pos)
        miss_pos[:, 1] = -1e7
        miss_dir = torch.zeros_like(ray_dir)
        miss_dir[:, 1] = -1.0
        ray_pos = torch.where(ok[:, None], -pos_o, miss_pos)
        ray_dir = torch.where(ok[:, None], -LM.normalize(dir_o), miss_dir)
    time = wave_sam = None
    if meta.has_motion:
        rng_state, time = RNG.rnd_time(rng_state)
    if meta.spectral_mode:
        rng_state, wave_sam = RNG.rnd_spec(rng_state)
        if mlt:
            wave_sam = qmc_ctx['mlt_rands'][:, 4]
        elif qmc_ctx is not None and qmc_ctx['spd_dim']:
            wave_sam = qmc_float(qmc_ctx, qmc_ctx['spd_dim'])
    return rng_state, ray_pos, ray_dir, (time, wave_sam), (xs, ys)


def kernel_init_eye_ray(scene, meta, rng_state, pixel_ids,
                        qmc_ctx=None) -> RayState:
    """kernel_InitEyeRay2 (integrator_pt.cpp:129-157).  Under a QMC or MLT
    context the state's ``pixel`` holds the pixel each lane's sample
    landed on (``pixel_ids`` are then unused)."""
    N = pixel_ids.shape[0]
    dev = pixel_ids.device
    xs = torch.remainder(pixel_ids, meta.width)
    ys = torch.div(pixel_ids, meta.width, rounding_mode='floor')
    rng_state, ray_pos, ray_dir, (time, wave_sam), (xs, ys) = \
        sample_camera_ray(scene, meta, rng_state, xs, ys, qmc_ctx)
    pixel = None if qmc_ctx is None else ys * meta.width + xs
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
        mis_ior=torch.ones(N, dtype=torch.float32, device=dev),
        rng=rng_state, hit_pos=zeros(3), hit_norm=zeros(3), hit_tang=zeros(3),
        hit_uv=zeros(2), hit_dist=zeros(),
        hit_inst=torch.zeros(N, dtype=torch.int64, device=dev),
        wavelengths=(None if wave_sam is None
                     else SPEC.sample_wavelengths(wave_sam)),
        time=time, pixel=pixel)


def ray_time(state: RayState):
    """The lanes' shutter times: 0 in a scene that does not move."""
    return (torch.zeros_like(state.mis_pdf) if state.time is None
            else state.time)


def nearest_hit(scene, ray_pos, ray_dir, t_min, t_max):
    """The streamed scene's nearest-hit query: the grid march, then the BVH
    walk for the lanes the march left unresolved, gathered into a batch of
    their own (none, as a rule, so the walk is then not launched).
    Returns (t, tri, u, v)."""
    pt, ptri, pu, pv, un = TDD.intersect_march(
        scene.st_grid, scene.st_woop, ray_pos, ray_dir, t_min, t_max,
        with_unresolved=True, wide=scene.st_wide)
    with span('hc3.sync.unresolved'):
        sel = torch.nonzero(un).squeeze(1)
    if sel.numel() > 0:
        ft, ftri, fu, fv = TST.intersect_stream(
            scene.st_nodes_f, scene.st_nodes_i, scene.st_woop, ray_pos[sel],
            ray_dir[sel], t_min[sel], t_max[sel], wide=scene.st_wide)
        pt, ptri, pu, pv = (a.index_put((sel,), b) for a, b in
                            ((pt, ft), (ptri, ftri), (pu, fu), (pv, fv)))
    return pt, ptri, pu, pv


def soup_motion(scene, time):
    """``intersect_clusters``' ``motion`` argument for a moving soup at the
    lanes' ``time``; None for a soup that does not move or no time (the
    soup is then traced at the shutter's open)."""
    if time is None or scene.tri_dv0 is None or scene.tri_dv0.shape[0] == 0:
        return None
    return scene.tri_dv0, scene.tri_de1, scene.tri_de2, time


def soup_nearest_hit(scene, ray_pos, ray_dir, t_min, t_max,
                     streamed: bool, time=None):
    """The nearest hit of a scene with a world soup: the streamed class's
    march and walk (``nearest_hit``), or the cluster walk of the mid-size
    and small classes; with ``time`` [N], a moving soup's at each ray's
    time.  Where autograd tracks the ray, t, u and v carry its gradient
    (``accel/hit_grad.py``).  Returns (t, tri, u, v)."""
    if streamed:
        def query(pos, d):
            return nearest_hit(scene, pos, d, t_min, t_max)
        rows_at = HG.soup_rows(scene)
    else:
        motion = soup_motion(scene, time)

        def query(pos, d):
            return TPL.intersect_clusters(
                scene.cl_nodes_f, scene.cl_nodes_i, scene.cl_tris12, pos, d,
                t_min, t_max, wide=scene.cl_wide, motion=motion)
        rows_at = HG.cluster_rows(scene.cl_tris12, motion)
    return HG.nearest_with_grad(query, rows_at, ray_pos, ray_dir)


def _remap_material_id(scene, mat_id, inst_id):
    """RemapMaterialId (integrator_pt_mat.cpp:530-573): the instance's
    remap list, (from, to) pairs sorted by from, searched by bisection
    over its pairs.  (The JAX package bisects over as many entries as the
    list has numbers, twice its pairs, and so can match a pair of the next
    list.)  Reads past the table's end clamp to its last entry, as the JAX
    package's gathers do (lanes without a list read there and are
    discarded)."""
    table = scene.all_remap_lists

    def at(idx):
        return table[torch.clamp(idx, 0, table.shape[0] - 1)]

    inst = torch.clamp(inst_id, 0, scene.remap_inst.shape[0] - 1)
    remap_list_id = scene.remap_inst[inst, 0]
    has_remap = remap_list_id >= 0
    rl = torch.clamp(remap_list_id, min=0)
    base = scene.all_remap_lists_size
    r_offset = at(base + rl)
    r_size = torch.div(at(base + rl + 1) - r_offset, 2,
                       rounding_mode='floor')

    lo = torch.zeros_like(mat_id)
    hi = r_size - 1
    for _ in range(20):
        valid = lo <= hi
        mid = lo + torch.div(hi - lo, 2, rounding_mode='floor')
        go_left = at(r_offset + torch.clamp(mid, min=0) * 2) >= mat_id
        hi = torch.where(valid & go_left, mid - 1, hi)
        lo = torch.where(valid & ~go_left, mid + 1, lo)
    pos = torch.clamp(hi + 1, min=0)
    in_range = hi + 1 < r_size
    from_id = at(r_offset + pos * 2)
    to_id = at(r_offset + pos * 2 + 1)
    remapped = torch.where(in_range & (from_id == mat_id), to_id, mat_id)
    return torch.where(has_remap, remapped, mat_id)


def _lerp_shade(shade, pu, pv):
    """Barycentric lerp of a [N, 32] shade row: data = (1-u-v) A + u B + v C
    (integrator_pt.cpp:270).  Returns (norm, tang, uv), not normalized."""
    data = ((1.0 - pu - pv)[:, None] * shade[:, 0:8]
            + pu[:, None] * shade[:, 8:16] + pv[:, None] * shade[:, 16:24])
    return (data[:, 0:3], data[:, 4:7],
            torch.stack([data[:, 3], data[:, 7]], dim=-1))


def kernel_ray_trace(scene, meta, state: RayState, bounce: int) -> RayState:
    """kernel_RayTrace2 (integrator_pt.cpp:214-348): nearest hit + shading
    prep from the baked per-triangle shade rows."""
    live = ~_is_dead(state.flags)
    t_min = torch.zeros_like(state.mis_pdf)
    t_max = torch.where(live, _F32MAX, 0.0)
    # on every class (t, u, v) carry the gradient of the ray where
    # autograd tracks it (accel/hit_grad.py)
    if meta.use_stream_tlas:
        # object-space shade rows; normal and tangent through the
        # instance's normal matrix (integrator_pt.cpp:263-292)
        pt, ptri, pu, pv, pinst = HG.tlas_with_grad(
            scene.tt, state.ray_pos, state.ray_dir, t_min, t_max)
        found = ptri >= 0
        shade = scene.tt_shade[torch.clamp(ptri, min=0)]
        norm_o, tang_o, hit_uv = _lerp_shade(shade, pu, pv)
        nm = scene.tt_inst_nm[torch.clamp(pinst, min=0)].reshape(-1, 4, 4)
        nm = nm[:, :3, :3]
        hit_norm = (nm * norm_o[:, None, :]).sum(-1)
        hit_tang = (nm * tang_o[:, None, :]).sum(-1)
        mid = _remap_material_id(scene, shade[:, 24].to(torch.int64), pinst)
        hit_inst = torch.where(found, pinst, -1)
    elif meta.use_two_level:
        # the instances at each ray's time (RayQuery_NearestHitMotion); the
        # normal and tangent through the normal matrices of both ends of
        # the shutter, lerped by time (integrator_pt.cpp:285-292)
        tl, time = scene.two_level, ray_time(state)
        pt, ptri, pinst, pu, pv = HG.two_level_with_grad(
            tl, state.ray_pos, state.ray_dir, t_min, t_max, time)
        found = ptri >= 0
        shade = scene.tl_shade[torch.clamp(ptri, min=0)]
        norm_o, tang_o, hit_uv = _lerp_shade(shade, pu, pv)
        inst = torch.clamp(pinst, min=0)

        def through(nm):
            nm = nm[inst].reshape(-1, 4, 4)[:, :3, :3]
            return ((nm * norm_o[:, None, :]).sum(-1),
                    (nm * tang_o[:, None, :]).sum(-1))

        hit_norm, hit_tang = through(tl.inst_nm0)
        if meta.has_motion:
            n1, t1 = through(tl.inst_nm1)
            hit_norm = hit_norm + time[:, None] * (n1 - hit_norm)
            hit_tang = hit_tang + time[:, None] * (t1 - hit_tang)
        mid = _remap_material_id(scene, shade[:, 24].to(torch.int64), pinst)
        hit_inst = pinst
    else:
        time = ray_time(state) if meta.has_motion else None
        pt, ptri, pu, pv = soup_nearest_hit(scene, state.ray_pos,
                                            state.ray_dir, t_min, t_max,
                                            meta.use_stream, time)
        found = ptri >= 0
        safe = torch.clamp(ptri, min=0)
        hit_inst = torch.where(found, scene.tri_inst_id[safe], -1)
        shade = scene.tri_shade[safe]                      # [N, 32]
        if time is not None:
            # the normal / tangent rows of both ends, lerped by time
            # (integrator_pt.cpp:285-292; JAX integrator_pt.py:557-561)
            shade = shade + time[:, None] * scene.tri_shade_d[safe]
        hit_norm, hit_tang, hit_uv = _lerp_shade(shade, pu, pv)
        mid = shade[:, 24].to(torch.int64)
    hit_t = torch.where(found, pt, _MISS_T)
    hit_pos = state.ray_pos + (hit_t * (1.0 - 1e-6))[:, None] * state.ray_dir
    hit_norm = LM.normalize(hit_norm)
    hit_tang = LM.normalize(hit_tang)

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
        hit_dist=torch.where(keep, state.hit_dist, hit_t),
        hit_inst=torch.where(keep, state.hit_inst, hit_inst))


class ShadowRays(NamedTuple):
    pos: torch.Tensor           # [N, 3]
    dir: torch.Tensor           # [N, 3]
    t_max: torch.Tensor         # [N] (0 where no ray is traced)
    need_trace: torch.Tensor    # [N] bool


def sample_shadow_rays(scene, meta, state: RayState, qmc_ctx=None):
    """NEE's light sample and the shadow ray toward it, per lane.  Under
    MLT the light randoms are the chains' (``mlt_slice`` 0..3); under QMC
    (a context is given at bounce 0 only) dimensions ``lgt_dim`` .. + 2
    replace three of them (integrator_qmc.cpp:100-116); the pseudo draw is
    made all the same.

    Returns (new rng state, light_id, light sample dict, ShadowRays)."""
    live = ~_is_dead(state.flags)
    rng_state, rands = RNG.rnd_lgts(state.rng, live)
    if qmc_ctx is not None and 'mlt_rands' in qmc_ctx:
        rands = mlt_slice(qmc_ctx, 0)
    elif qmc_ctx is not None and qmc_ctx['lgt_dim']:
        d0 = qmc_ctx['lgt_dim']
        rands = torch.stack([qmc_float(qmc_ctx, d0),
                             qmc_float(qmc_ctx, d0 + 1), rands[:, 2],
                             qmc_float(qmc_ctx, d0 + 2)], -1)
    light_id = torch.clamp(
        (rands[:, 3] * meta.num_lights).to(torch.int64),
        max=meta.num_lights - 1)
    lsam = LGT.light_sample_rev(scene, meta, light_id, rands[:, :3],
                                state.hit_pos)
    hit_dist = torch.sqrt(((state.hit_pos - lsam['pos']) ** 2).sum(-1))
    shadow_dir = LM.normalize(lsam['pos'] - state.hit_pos)
    offs = torch.clamp(LM.maxcomp(state.hit_pos), min=1.0) * 5e-6
    shadow_pos = state.hit_pos + state.hit_norm * offs[:, None]

    in_illum = ((LM.dot(shadow_dir, lsam['norm']) < 0.0) | lsam['is_omni']
                | lsam['has_ies'])
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


def shadow_occluded_in_lane_order(scene, meta, rays: ShadowRays,
                                  time=None):
    """The any-hit shadow query of two-level, mid-size and small scenes,
    traced in lane order as the JAX integrator traces it; a moving scene's
    (two-level, or a moving soup) at the lanes' shutter ``time``."""
    query = (rays.pos, rays.dir, torch.zeros_like(rays.t_max), rays.t_max)
    if meta.use_stream_tlas:
        stri = TT.intersect_stream_tlas(scene.tt, *query, any_hit=True)[1]
    elif meta.use_two_level:
        stri = TL2.intersect_two_level(scene.two_level, *query, time=time,
                                       any_hit=True)[1]
    else:
        stri = TPL.intersect_clusters(
            scene.cl_nodes_f, scene.cl_nodes_i, scene.cl_tris12, *query,
            any_hit=True, wide=scene.cl_wide,
            motion=soup_motion(scene, time if meta.has_motion else None))[1]
    return stri >= 0


def shadow_occluded(scene, rays: ShadowRays):
    """The streamed scene's any-hit shadow query, traced in a coherence
    order of its own and inverted by a scatter."""
    perm, *query = sorted_shadow_query(scene.st_grid, rays)
    _, stri, _, _ = TST.intersect_stream(
        scene.st_nodes_f, scene.st_nodes_i, scene.st_woop, *query,
        any_hit=True, wide=scene.st_wide)
    occluded = torch.empty_like(rays.need_trace)
    occluded[perm] = stri >= 0
    return occluded


def kernel_sample_light_source(scene, meta, state: RayState, ctx,
                               integrator_type: int = INTEGRATOR_MIS_PT,
                               render_layer: int = FB_COLOR, qmc_ctx=None,
                               return_count: bool = False):
    """kernel_SampleLightSource (integrator_pt.cpp:350-424); MIS weights
    only for the MIS integrator.  ``ctx``: the bounce's shading context
    (None in a scene with a blend).  The ``direct`` layer keeps the light
    a path reaches before its first non-specular bounce, the ``indirect``
    layer the rest.  ``qmc_ctx``: the QMC or MLT randoms of this bounce
    (``sample_shadow_rays``).

    Returns (shade_color [N, 4], new rng state); with ``return_count``
    also the number of shadow rays it traces (live lanes in the light's
    illumination, a scalar int64 tensor)."""
    rng_state, light_id, lsam, rays = sample_shadow_rays(scene, meta, state,
                                                         qmc_ctx)
    shadow_pos, shadow_dir = rays.pos, rays.dir
    occluded = (shadow_occluded(scene, rays) if meta.use_stream else
                shadow_occluded_in_lane_order(scene, meta, rays,
                                              ray_time(state)))
    need_shade = rays.need_trace & ~occluded

    bsdf = MAT.material_eval(scene, meta, _extract_mat_id(state.flags), ctx,
                             shadow_dir, -state.ray_dir, state.hit_norm,
                             state.hit_uv, state.wavelengths, state.hit_tang)
    cos_out = torch.clamp(LM.dot(shadow_dir, state.hit_norm), min=0.0)
    lgt_pdf_w = LGT.light_pdf_select_rev(meta) * LGT.light_eval_pdf(
        scene, meta, light_id, shadow_pos, shadow_dir, lsam['pos'],
        lsam['norm'], lsam['pdf'])
    mis = (LM.mis_weight_heuristic(lgt_pdf_w, bsdf['pdf'])
           if integrator_type == INTEGRATOR_MIS_PT
           else torch.ones_like(lgt_pdf_w))
    if {LIGHT_GEOM_POINT, LIGHT_GEOM_DIRECT} & set(meta.light_geom_types):
        # a point or directional light cannot be hit by a BSDF sample: no
        # MIS partner; a directional light's pdf is 1
        gt = scene.light_geom_type[torch.clamp(light_id, 0,
                                               meta.num_lights - 1)]
        is_direct = gt == LIGHT_GEOM_DIRECT
        mis = torch.where(is_direct | (gt == LIGHT_GEOM_POINT), 1.0, mis)
        lgt_pdf_w = torch.where(is_direct, 1.0, lgt_pdf_w)
    if render_layer != FB_COLOR:
        # integrator_pt.cpp:405-411
        direct = ~_has_non_spec(state.flags)
        mis = torch.where(direct if render_layer == FB_INDIRECT else ~direct,
                          0.0, mis)
    light_color = LGT.light_intensity(scene, meta, light_id, shadow_dir,
                                      state.wavelengths, shadow_pos)
    shade = (light_color * bsdf['val']
             / torch.clamp(lgt_pdf_w, min=1e-30)[:, None]
             * (cos_out * mis)[:, None])
    shade = torch.where(need_shade[:, None], shade, 0.0)
    if return_count:
        return shade, rng_state, rays.need_trace.sum()
    return shade, rng_state


def kernel_next_bounce(scene, meta, state: RayState, bounce: int,
                       shade_color, ctx,
                       integrator_type: int = INTEGRATOR_MIS_PT,
                       render_layer: int = FB_COLOR,
                       qmc_ctx=None) -> RayState:
    """kernel_NextBounce (integrator_pt.cpp:426-548).  A light hit is
    weighted by MIS for ``mispt``; ``shadowpt`` takes it only before the
    path's first non-specular bounce; ``naivept`` takes it whole and adds
    no NEE.  The ``indirect`` layer drops a light hit before or at the
    first non-specular bounce; the ``direct`` layer ends a path at its
    second non-specular bounce.  Under MLT the material's four randoms
    are the chains' (``mlt_slice`` 4..7), under QMC (bounce 0) the first
    two are dimensions ``mat_dim``, + 1 (integrator_qmc.cpp:118-127)."""
    live = ~_is_dead(state.flags)
    mat_id = _extract_mat_id(state.flags)
    if ctx is None:     # a scene with a blend shares no shading context
        md = MAT.gather_material(scene, mat_id)
        tex_color = MAT.slot0_tex_color(scene, md, state.hit_uv)
    else:
        md, tex_color = ctx['md'], ctx['tex_color']
    is_light_mat = md['mtype'] == MAT_TYPE_LIGHT_SOURCE

    # light-hit branch (integrator_pt.cpp:461-506)
    inst = torch.clamp(state.hit_inst, 0, scene.remap_inst.shape[0] - 1)
    light_id = scene.remap_inst[inst, 1]
    light_intensity = md['colors'][:, EMISSION_COLOR, :] * tex_color
    has_light = light_id >= 0
    ld_hit = LGT.gather_light(scene, light_id)
    light_cos = LM.dot(state.ray_dir, ld_hit['norm'][:, :3])
    atten = torch.where(
        (light_cos < 0.0) | (ld_hit['geom_type'] == LIGHT_GEOM_SPHERE),
        1.0, 0.0)
    li_from_light = (LGT.light_intensity(scene, meta, light_id,
                                         state.ray_dir, state.wavelengths,
                                         state.ray_pos)
                     * atten[:, None])
    light_intensity = torch.where(has_light[:, None], li_from_light,
                                  light_intensity)
    mis_weight_l = torch.ones_like(state.mis_pdf)
    if integrator_type == INTEGRATOR_SHADOW_PT:
        mis_weight_l = torch.where(_has_non_spec(state.flags), 0.0, 1.0)
    elif integrator_type == INTEGRATOR_MIS_PT and bounce > 0:
        lgt_pdf = LGT.light_pdf_select_rev(meta) * LGT.light_eval_pdf(
            scene, meta, light_id, state.ray_pos, state.ray_dir,
            state.hit_pos, state.hit_norm, torch.ones_like(state.mis_pdf))
        w = LM.mis_weight_heuristic(state.mis_pdf, lgt_pdf)
        w = torch.where(state.mis_pdf <= 0.0, 1.0, w)
        mis_weight_l = torch.where(has_light, w, 1.0)
    if render_layer == FB_INDIRECT:
        first_ns = (state.flags & C.RAY_FLAG_FIRST_NON_SPEC) != 0
        mis_weight_l = torch.where(~_has_non_spec(state.flags) | first_ns,
                                   0.0, mis_weight_l)
    light_branch = live & is_light_mat
    accum_light = (state.accum_color
                   + state.throughput * light_intensity * mis_weight_l[:, None])
    flags_light = state.flags | C.RAY_FLAG_IS_DEAD | C.RAY_FLAG_HIT_LIGHT

    # surface branch: sample the BSDF
    surf_live = live & ~is_light_mat
    override = override_full = None
    if qmc_ctx is not None and 'mlt_rands' in qmc_ctx:
        override_full = mlt_slice(qmc_ctx, 4)
    elif qmc_ctx is not None and qmc_ctx['mat_dim']:
        d0 = qmc_ctx['mat_dim']
        override = torch.stack([qmc_float(qmc_ctx, d0),
                                qmc_float(qmc_ctx, d0 + 1)], -1)
    mat_sam, rng_state, new_ior = MAT.material_sample_and_eval(
        scene, meta, mat_id, ctx, state.rng, surf_live, -state.ray_dir,
        state.hit_norm, state.hit_uv, state.mis_ior, state.flags,
        state.wavelengths, state.hit_tang, rnd_mats_override=override,
        rnd_mats_override_full=override_full)
    bxdf_val = mat_sam['val'] / torch.clamp(mat_sam['pdf'], min=1e-20)[:, None]
    cos_theta = LM.dot(mat_sam['dir'], state.hit_norm).abs()
    new_mis_pdf = torch.where((mat_sam['flags'] & C.RAY_EVENT_S) != 0, -1.0,
                              mat_sam['pdf'])
    new_accum = (state.accum_color if integrator_type == INTEGRATOR_STUPID_PT
                 else state.accum_color + state.throughput * shade_color)
    new_thr = state.throughput * cos_theta[:, None] * bxdf_val
    # the transmission offset (integrator_pt.cpp:534-537): a refracted ray
    # starts a little past the surface
    trans = (mat_sam['flags'] & C.RAY_EVENT_T) != 0
    hit_pos = torch.where(
        trans[:, None],
        state.hit_pos + (state.hit_dist * 2e-6)[:, None] * state.ray_dir,
        state.hit_pos)
    new_pos = LM.offs_ray_pos(hit_pos, state.hit_norm, mat_sam['dir'])
    next_flags = ((state.flags & ~C.RAY_FLAG_FIRST_NON_SPEC)
                  | mat_sam['flags'])
    if render_layer == FB_DIRECT:
        next_flags = torch.where(_has_non_spec(state.flags),
                                 next_flags | C.RAY_FLAG_IS_DEAD, next_flags)
    else:
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
        mis_ior=torch.where(surf_live, new_ior, state.mis_ior),
        rng=rng_state)


def kernel_hit_environment(scene, meta, state: RayState,
                           integrator_type: int = INTEGRATOR_MIS_PT,
                           pixel_ids=None) -> RayState:
    """kernel_HitEnvironment (integrator_pt.cpp:550-595).  With a sampled
    env, ``mispt`` weights the miss by MIS and ``shadowpt`` drops it (NEE
    took it); ``naivept`` overwrites the accumulator with the miss.  A
    camera-back texture replaces the miss of a prime ray by its texel at
    the ray's pixel (``pixel_ids``, in the state's order: under QMC or MLT
    the pixel the sample landed on)."""
    out = (state.flags & C.RAY_FLAG_OUT_OF_SCENE) != 0
    mis_pt = integrator_type == INTEGRATOR_MIS_PT
    env_color, env_pdf = LGT.environment_color(scene, meta, state.ray_dir,
                                               mis_pt, state.wavelengths)
    exit_zero = (state.flags & C.RAY_FLAG_PRIME_RAY_MISS) != 0
    if mis_pt and meta.env_enable_sam:
        is_spec = state.mis_pdf < 0.0
        mis = LM.mis_weight_heuristic(
            state.mis_pdf, LGT.light_pdf_select_rev(meta) * env_pdf)
        env_color = torch.where((~is_spec & ~exit_zero)[:, None],
                                env_color * mis[:, None], env_color)
    elif integrator_type == INTEGRATOR_SHADOW_PT and meta.env_enable_sam:
        env_color = torch.zeros_like(env_color)
    if meta.has_cam_back and pixel_ids is not None:
        # integrator_pt.cpp:578-589
        x = torch.remainder(pixel_ids, meta.width).to(torch.float32)
        y = torch.div(pixel_ids, meta.width,
                      rounding_mode='floor').to(torch.float32)
        tc = torch.stack([(x + 0.5) / meta.width, (y + 0.5) / meta.height],
                         -1)
        back = TEX.sample(scene.textures,
                          scene.env_cam_back_id.expand(pixel_ids.shape), tc)
        env_color = torch.where(exit_zero[:, None], back, env_color)
    new_accum = state.throughput * env_color
    if integrator_type != INTEGRATOR_STUPID_PT:
        new_accum = state.accum_color + new_accum
    return state._replace(accum_color=torch.where(out[:, None], new_accum,
                                                  state.accum_color))


def check_scene(meta):
    """Refuse a light of another geometry than rect, disc, directional,
    point, sphere and env (a shape the loader does not know).  Every scene
    class, material type, light distribution and camera the build loads
    are traced."""
    other = set(meta.light_geom_types) - {
        LIGHT_GEOM_RECT, LIGHT_GEOM_DISC, LIGHT_GEOM_DIRECT, LIGHT_GEOM_ENV,
        LIGHT_GEOM_SPHERE, LIGHT_GEOM_POINT}
    if other:
        raise NotImplementedError(f'light geometry {sorted(other)} is not '
                                  'ported to the batched path')


def init_state_from_input_rays(meta, rng_state, ray_pos, ray_dir,
                               wavelengths=None, time=None) -> RayState:
    """kernel_InitEyeRayFromInput (integrator_pt.cpp:159-199): the ray
    state of rays made outside the renderer (the camera plugin,
    PathTraceFromInputRays).  ``ray_pos`` / ``ray_dir`` are world-space
    [N, 3]; ``wavelengths`` [N] (one wavelength a ray, the plugin's
    CHANNELS=1 contract, taken for all four hero lanes) or [N, 4], read
    in spectral mode (zeros where None, as in the JAX package); ``time``
    [N], read in a moving scene (zeros where None)."""
    N = ray_pos.shape[0]
    dev = ray_pos.device

    def zeros(*shape):
        return torch.zeros((N,) + shape, dtype=torch.float32, device=dev)

    waves4 = None
    if meta.spectral_mode:
        waves4 = (zeros(4) if wavelengths is None else
                  wavelengths[:, None].expand(N, 4).contiguous()
                  if wavelengths.dim() == 1 else wavelengths)
    if meta.has_motion and time is None:
        time = zeros()
    return RayState(
        ray_pos=ray_pos, ray_dir=ray_dir,
        flags=torch.zeros(N, dtype=torch.int64, device=dev),
        accum_color=zeros(4),
        throughput=torch.ones((N, 4), dtype=torch.float32, device=dev),
        mis_pdf=torch.ones(N, dtype=torch.float32, device=dev),
        mis_ior=torch.ones(N, dtype=torch.float32, device=dev),
        rng=rng_state, hit_pos=zeros(3), hit_norm=zeros(3), hit_tang=zeros(3),
        hit_uv=zeros(2), hit_dist=zeros(),
        hit_inst=torch.zeros(N, dtype=torch.int64, device=dev),
        wavelengths=waves4, time=time if meta.has_motion else None)


def count_rays_pass(scene, meta, rng_state, pixel_ids,
                    integrator_type: int = INTEGRATOR_MIS_PT):
    """The rays one pass traces (JAX ``count_rays_pass``, the counter
    behind the bench's Mrays/s): ``n_nearest``, the live lanes before each
    bounce's nearest-hit trace, and ``n_shadow``, the shadow rays
    ``kernel_sample_light_source`` traces (live lanes in the light's
    illumination); the naive integrator runs one bounce more and no
    shadow ray.  The pass runs as the JAX one does: unsorted, through the
    scene class's kernels (``_bounces``' counter).  Returns (n_nearest,
    n_shadow) as ints."""
    rays = {k: torch.zeros((), dtype=torch.int64, device=pixel_ids.device)
            for k in ('nearest', 'shadow')}
    _bounces(scene, meta,
             kernel_init_eye_ray(scene, meta, rng_state, pixel_ids), None,
             integrator_type, FB_COLOR, None, False, rays)
    return int(rays['nearest']), int(rays['shadow'])


def trace_pass(scene, meta, rng_state, pixel_ids,
               integrator_type: int = INTEGRATOR_MIS_PT,
               render_layer: int = FB_COLOR, qmc_ctx=None, input_state=None):
    """One full sample per pixel id (PathTrace / NaivePathTrace,
    integrator_pt.cpp:681-759): ``trace_depth`` bounces, one more for the
    naive integrator, which runs no NEE.  Returns (accum_color [N, 4],
    flags [N] i64, new rng state [N, 2] i64); ``trace_pass_state`` returns
    the whole final state (with the hero wavelengths)."""
    state = trace_pass_state(scene, meta, rng_state, pixel_ids,
                             integrator_type, render_layer, qmc_ctx,
                             input_state)
    return state.accum_color, state.flags, state.rng


def trace_pass_state(scene, meta, rng_state, pixel_ids,
                     integrator_type: int = INTEGRATOR_MIS_PT,
                     render_layer: int = FB_COLOR,
                     qmc_ctx=None, input_state=None) -> RayState:
    """``trace_pass``'s sample, returning its final ``RayState``.

    ``qmc_ctx`` (JAX ``trace_pass``'s, :991-1083): dict(table, idx,
    spd_dim, mat_dim, lgt_dim) for IntegratorQMC, whose randoms feed
    bounce 0 only, or dict(mlt_rands [N, R]) for Kelemen MLT, whose feed
    every bounce at the bounce's offset.  With a context no ray is sorted
    and the state's ``pixel`` is each lane's output pixel.

    ``input_state`` (``init_state_from_input_rays``) is
    PathTraceFromInputRays (integrator_pt.cpp:761-798): the pass starts
    from those rays, unsorted (JAX :1015-1017), and ``pixel_ids`` only
    index the camera-back texture of a prime ray's miss (the camera plugin
    passes zeros, as the JAX package's does)."""
    if integrator_type not in (INTEGRATOR_STUPID_PT, INTEGRATOR_SHADOW_PT,
                               INTEGRATOR_MIS_PT):
        raise NotImplementedError(f'integrator type {integrator_type}')
    if render_layer not in (FB_COLOR, FB_DIRECT, FB_INDIRECT):
        raise NotImplementedError(f'render layer {render_layer}')
    check_scene(meta)
    # streamed and two-level scenes sort live rays into coherent order
    # before every secondary trace (by grid cell, or by Morton code where
    # there is no grid); mid-size scenes trace unsorted, and so does every
    # scene under QMC or MLT or from input rays
    sort_rays = ((meta.use_stream or meta.use_stream_tlas) and qmc_ctx is None
                 and input_state is None)
    # the first state goes to the loop unnamed here, so that it is freed
    # at the first bounce
    state, orig = _bounces(
        scene, meta,
        (kernel_init_eye_ray(scene, meta, rng_state, pixel_ids, qmc_ctx)
         if input_state is None else input_state),
        torch.arange(pixel_ids.shape[0], device=pixel_ids.device),
        integrator_type, render_layer, qmc_ctx, sort_rays)
    with span('hc3.pass.env'):
        # restore positional order: the inverse of the composed sorts
        inv = torch.empty_like(orig)
        inv[orig] = torch.arange(orig.shape[0], device=orig.device)
        state, _ = _permute_state(state, orig, inv)
        return kernel_hit_environment(
            scene, meta, state, integrator_type,
            pixel_ids if state.pixel is None else state.pixel)


def _bounces(scene, meta, state: RayState, orig, integrator_type: int,
             render_layer: int, qmc_ctx, sort_rays: bool, rays=None):
    """``trace_pass_state``'s bounce loop: ``trace_depth`` x (sort ->
    nearest hit -> shading context -> NEE -> next bounce), one bounce
    more and no NEE for the naive integrator.  ``orig`` (None unsorted)
    tracks each row's original position through the sorts; ``rays``
    (``count_rays_pass``' dict(nearest=, shadow=) of device scalars), where
    given, gains the live lanes before each nearest-hit trace and NEE's
    shadow rays.  Returns (state, orig)."""
    naive = integrator_type == INTEGRATOR_STUPID_PT
    mlt = qmc_ctx is not None and 'mlt_rands' in qmc_ctx
    for b in range(meta.trace_depth + int(naive)):
        # QMC feeds bounce 0, MLT every bounce at its offset
        bctx = (dict(qmc_ctx, bounce=b) if mlt else
                qmc_ctx if b == 0 else None)
        if sort_rays and b > 0:
            with span('hc3.bounce.sort'):
                state, orig = _sort_rays_for_trace(state, orig,
                                                   scene.st_grid)
        with span('hc3.bounce.trace'):
            if rays is not None:
                rays['nearest'] += (~_is_dead(state.flags)).sum()
            state = kernel_ray_trace(scene, meta, state, b)
        # one shared shading context a bounce, except with a blend (whose
        # descent picks the leaf per draw)
        with span('hc3.bounce.shade_ctx'):
            ctx = None if meta.has_blend else MAT.make_shading_ctx(
                scene, meta, _extract_mat_id(state.flags), state.hit_norm,
                state.hit_tang, state.hit_uv)
        if naive:
            shade = torch.zeros_like(state.accum_color)
        else:
            with span('hc3.bounce.nee'):
                shade, rng2, *n_tr = kernel_sample_light_source(
                    scene, meta, state, ctx, integrator_type, render_layer,
                    bctx, return_count=rays is not None)
            if rays is not None:
                rays['shadow'] += n_tr[0]
            state = state._replace(rng=rng2)
        with span('hc3.bounce.next'):
            state = kernel_next_bounce(scene, meta, state, b, shade, ctx,
                                       integrator_type, render_layer, bctx)
    return state, orig
