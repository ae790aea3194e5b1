"""Light sampling, PDFs and intensity (clight.h, integrator_pt_lgt.cpp).

The counterpart of ``hydracore3_tpu/lights.py``: the rect and disc area
lights, the directional light, the point (omni, Lambert or spot) and
sphere lights, the importance-sampled lat-long environment, an IES profile
on a light and the projective spot.  Only the branches of the types and
features a scene holds are computed (the JAX package's trace-time gates),
and merged with selects.  In spectral mode a light's or the sky's color
is its SPD at the ray's hero wavelengths where it names one; the IES,
projective and sky texels stay RGBA (an IES texel is (v, v, v, 1), so the
fourth hero wavelength is not shaped by the profile), as in the JAX
package.
"""
from __future__ import annotations

import torch

from .utils.lmath import (M_PI, dot, mul3x3, mul4x4_vec, epsilon_of_pos,
                          normalize, safe_arccos, pdf_a_to_w, mul_rows_2x4,
                          map_samples_to_disc,
                          sphere_map_to_2d_tex_coord,
                          tex_coord_2d_to_sphere_map)
from .ops import spectrum as SPEC
from .ops import texture as TEX
from .utils.spans import span
from .scene.build import (LIGHT_GEOM_ENV, LIGHT_GEOM_SPHERE, LIGHT_GEOM_POINT,
                          LIGHT_GEOM_DISC, LIGHT_GEOM_DIRECT,
                          LIGHT_DIST_LAMBERT, LIGHT_DIST_OMNI,
                          LIGHT_DIST_SPOT, LIGHT_FLAG_POINT_AREA,
                          LIGHT_FLAG_PROJECTIVE)


def gather_light(scene, light_id, extra=()):
    """Per-ray light rows (clight.h LightSource) by plain indexing; the
    IES and spot columns (``ies_matrix``, ``flags``, ``cos1``, ``cos2``)
    only where ``extra`` names them: the scenes without those lights do
    not pay for their gathers."""
    with span('hc3.gather.light'):
        lid = torch.clamp(light_id, 0, scene.light_pos.shape[0] - 1)
        return {k: getattr(scene, 'light_' + k)[lid] for k in (
            'pos', 'norm', 'intensity', 'matrix', 'sam_row0', 'sam_row1',
            'sam_row0_inv', 'sam_row1_inv', 'size', 'pdf_a', 'mult',
            'geom_type', 'dist_type', 'pdf_table_offset', 'pdf_table_size_x',
            'pdf_table_size_y', 'tex_id', 'ies_id') + tuple(extra)}


def _sample_map_2d(scene, rands3, table_offset, size_x, size_y):
    """SampleMap2D (integrator_pt_lgt.cpp:217-239): CDF inversion on the
    prefix-summed luminance table by binary search."""
    a1f = scene.arrays1f
    fw = size_x.to(torch.float32)
    fh = size_y.to(torch.float32)
    n = size_x * size_y
    total = a1f[table_offset + n]
    x = rands3[..., 2] * total
    lo = torch.zeros_like(n)
    hi = n - 1
    for _ in range(max(int(a1f.shape[0] - 1).bit_length(), 1)):
        mid = torch.div(lo + hi, 2, rounding_mode='floor')
        go_right = a1f[table_offset + mid] < x
        lo = torch.where(go_right, torch.minimum(mid + 1, hi), lo)
        hi = torch.where(go_right, hi, mid)
    pixel = lo - 1 + (a1f[table_offset + lo] < x).to(lo.dtype)
    pixel = torch.minimum(torch.clamp(pixel, min=0), n - 1)
    pdf = ((a1f[table_offset + pixel + 1] - a1f[table_offset + pixel])
           / torch.clamp(total, min=1e-30))
    y_pos = torch.div(pixel, size_x, rounding_mode='floor')
    x_pos = pixel - y_pos * size_x
    tex_x = (1.0 / fw) * ((x_pos.to(torch.float32) + 0.5)
                          + (rands3[..., 0] * 2.0 - 1.0) * 0.5)
    tex_y = (1.0 / fh) * ((y_pos.to(torch.float32) + 0.5)
                          + (rands3[..., 1] * 2.0 - 1.0) * 0.5)
    return torch.stack([tex_x, tex_y], dim=-1), pdf * fw * fh


def _eval_map_2d_pdf(scene, tex_coord, table_offset, size_x, size_y):
    """evalMap2DPdf (clight.h:190-218)."""
    a1f = scene.arrays1f
    fw = size_x.to(torch.float32)
    fh = size_y.to(torch.float32)
    tx = tex_coord[..., 0] - torch.floor(tex_coord[..., 0])
    ty = tex_coord[..., 1] - torch.floor(tex_coord[..., 1])
    # f32 -> int truncates toward zero, as the C++ cast
    px = torch.minimum(torch.clamp((fw * tx - 0.5).to(torch.int64), min=0),
                       size_x - 1)
    py = torch.minimum(torch.clamp((fh * ty - 0.5).to(torch.int64), min=0),
                       size_y - 1)
    off = py * size_x + px
    v0 = a1f[table_offset + off]
    v1 = a1f[table_offset + off + 1]
    total = a1f[table_offset + size_x * size_y]
    return (v1 - v0) * fw * fh / torch.clamp(total, min=1e-30)


def light_sample_rev(scene, meta, light_id, rands3, illum_point):
    """LightSampleRev: dict(pos, norm, pdf, is_omni, has_ies); ``has_ies``
    (a light with an IES profile, not directional or the sky) lets NEE
    trace toward the light from behind its plane."""
    ld = gather_light(scene, light_id)
    gt = ld['geom_type']
    present = set(meta.light_geom_types)
    # rect and disc (clight.h:67-84)
    off = 2.0 * (rands3[..., :2] - 0.5) * ld['size']
    if LIGHT_GEOM_DISC in present:
        off_disc = (map_samples_to_disc(rands3[..., :2] * 2.0 - 1.0)
                    * ld['size'][..., 0:1])
        off = torch.where((gt == LIGHT_GEOM_DISC)[..., None], off_disc, off)
    local = torch.stack([off[..., 0], torch.zeros_like(off[..., 0]),
                         off[..., 1]], dim=-1)
    pos = (mul3x3(ld['matrix'], local) + ld['pos'][..., :3]
           + epsilon_of_pos(ld['pos'][..., :3])[..., None]
           * ld['norm'][..., :3])
    norm = ld['norm'][..., :3]
    # branches of light types the scene lacks are not computed
    if LIGHT_GEOM_SPHERE in present:
        # sphere (clight.h:86-103)
        theta = 2.0 * M_PI * rands3[..., 0]
        phi = safe_arccos(1.0 - 2.0 * rands3[..., 1])
        sph_dir = torch.stack([torch.sin(phi) * torch.cos(theta),
                               torch.sin(phi) * torch.sin(theta),
                               torch.cos(phi)], dim=-1)
        sph_pos = (ld['pos'][..., :3]
                   + (ld['size'][..., 0] * 1.000001)[..., None] * sph_dir)
        is_sphere = (gt == LIGHT_GEOM_SPHERE)[..., None]
        pos = torch.where(is_sphere, sph_pos, pos)
        norm = torch.where(is_sphere, normalize(sph_pos - ld['pos'][..., :3]),
                           norm)
    if LIGHT_GEOM_DIRECT in present:
        # direct (clight.h:105-115): far along the light's direction
        pos = torch.where((gt == LIGHT_GEOM_DIRECT)[..., None],
                          illum_point - ld['norm'][..., :3] * 100000.0, pos)
    if LIGHT_GEOM_POINT in present:
        # point (clight.h:117-126)
        pos = torch.where((gt == LIGHT_GEOM_POINT)[..., None],
                          ld['pos'][..., :3], pos)
    pdf = torch.ones_like(rands3[..., 0])
    is_omni = (gt == LIGHT_GEOM_POINT) & (ld['dist_type'] == LIGHT_DIST_OMNI)
    has_ies = (ld['ies_id'] >= 0) & (gt != LIGHT_GEOM_DIRECT)
    if meta.env_enable_sam:
        # env importance sample (integrator_pt_lgt.cpp:30-55)
        is_env = ld['geom_type'] == LIGHT_GEOM_ENV
        tcs, map_pdf = _sample_map_2d(
            scene, rands3, ld['pdf_table_offset'],
            torch.clamp(ld['pdf_table_size_x'], min=1),
            torch.clamp(ld['pdf_table_size_y'], min=1))
        tc_t = mul_rows_2x4(ld['sam_row0_inv'], ld['sam_row1_inv'], tcs)
        sdir, sintheta = tex_coord_2d_to_sphere_map(tc_t)
        env_pos = illum_point + sdir * 1000.0
        env_pdf = map_pdf / (2.0 * M_PI * M_PI
                             * torch.clamp(sintheta.abs(), min=1e-20))
        pos = torch.where(is_env[..., None], env_pos, pos)
        norm = torch.where(is_env[..., None], sdir, norm)
        pdf = torch.where(is_env, env_pdf, pdf)
        is_omni = is_omni | is_env
        has_ies = has_ies & ~is_env
    return dict(pos=pos, norm=norm, pdf=pdf, is_omni=is_omni,
                has_ies=has_ies)


def light_pdf_select_rev(meta):
    """LightPdfSelectRev: uniform 1/N (integrator_pt_lgt.cpp:60-63)."""
    return 1.0 / float(max(meta.num_lights, 1))


def light_eval_pdf(scene, meta, light_id, illum_point, ray_dir, lpos, lnorm,
                   env_pdf):
    """LightEvalPDF (integrator_pt_lgt.cpp:71-107)."""
    ld = gather_light(scene, light_id)
    gt = ld['geom_type']
    hit_dist = torch.sqrt(((illum_point - lpos) ** 2).sum(-1))
    cos_tmp = dot(ray_dir, -lnorm)
    cos_val = torch.where(ld['ies_id'] < 0, torch.clamp(cos_tmp, min=0.0),
                          cos_tmp.abs())
    present = set(meta.light_geom_types)
    if LIGHT_GEOM_POINT in present:
        cos_point = torch.where(ld['dist_type'] == LIGHT_DIST_LAMBERT,
                                torch.clamp(cos_tmp, min=0.0), 1.0)
        cos_val = torch.where(gt == LIGHT_GEOM_POINT, cos_point, cos_val)
    if LIGHT_GEOM_SPHERE in present:
        cos_sphere = dot(normalize(lpos - illum_point), lnorm).abs()
        cos_val = torch.where(gt == LIGHT_GEOM_SPHERE, cos_sphere, cos_val)
    pdf = pdf_a_to_w(ld['pdf_a'], hit_dist, cos_val)
    return torch.where(ld['geom_type'] == LIGHT_GEOM_ENV, env_pdf, pdf)


def _spd(scene, spec_id, wavelengths):
    """The spectra ``spec_id`` [...] at ``wavelengths`` [..., 4]."""
    sid = torch.clamp(spec_id, 0, scene.spec_offset_sz.shape[0] - 1)
    return SPEC.sample_uniform_spectrum(
        scene.spec_values, scene.spec_offset_sz[sid, 0], wavelengths)


def light_intensity(scene, meta, light_id, ray_dir, wavelengths=None,
                    ray_pos=None):
    """LightIntensity (integrator_pt_lgt.cpp:109-173) toward ``ray_dir``
    from ``ray_pos`` (what the IES tap of a point-area light and the
    projective texture read); in spectral mode the light's SPD at
    ``wavelengths`` [N, 4] where it has one.  The IES profile, the spot's
    smoothstep and the projective texture modulate it, each computed only
    in a scene that has it (``meta.has_ies``, ``has_spot``,
    ``has_proj``)."""
    extra = ((('ies_matrix', 'flags') if meta.has_ies or meta.has_proj
              else ()) + (('cos1', 'cos2') if meta.has_spot else ()))
    ld = gather_light(scene, light_id, extra)
    color = ld['intensity']
    if meta.spectral_mode:
        sid = scene.light_spec_id[torch.clamp(
            light_id, 0, scene.light_spec_id.shape[0] - 1)]
        color = torch.where((sid >= 0)[..., None],
                            _spd(scene, sid, wavelengths), color)
    color = color * ld['mult'][..., None]
    if meta.has_ies:
        # the profile's texel toward the (rotated) direction
        ies_dir = torch.where(
            ((ld['flags'] & LIGHT_FLAG_POINT_AREA) != 0)[..., None],
            normalize(ld['pos'][..., :3] - ray_pos), ray_dir)
        dir_trans = mul4x4_vec(ld['ies_matrix'], torch.cat(
            [ies_dir, torch.zeros_like(ies_dir[..., :1])], -1))[..., :3]
        tc_ies, _ = sphere_map_to_2d_tex_coord(-dir_trans)
        ies_col = TEX.sample(scene.textures,
                             torch.clamp(ld['ies_id'], min=0), tc_ies)
        color = torch.where((ld['ies_id'] >= 0)[..., None], color * ies_col,
                            color)
    if meta.has_spot:
        # the cone's smoothstep (integrator_pt_lgt.cpp:145-162)
        is_spot = ld['dist_type'] == LIGHT_DIST_SPOT
        cos_theta = torch.clamp(-dot(ray_dir, ld['norm'][..., :3]), min=0.0)
        tval = torch.clamp((cos_theta - ld['cos2'])
                           / torch.clamp(ld['cos1'] - ld['cos2'], min=1e-20),
                           0.0, 1.0)
        smooth = tval * tval * (3.0 - 2.0 * tval)
        color = torch.where(is_spot[..., None], color * smooth[..., None],
                            color)
        if meta.has_proj:
            # the projective texture through the profile matrix's clip
            # space
            is_proj = (is_spot & ((ld['flags'] & LIGHT_FLAG_PROJECTIVE) != 0)
                       & (ld['tex_id'] >= 0))
            pos_clip = mul4x4_vec(ld['ies_matrix'], torch.cat(
                [ray_pos, torch.ones_like(ray_pos[..., :1])], -1))
            w = pos_clip[..., 3:4]
            ndc = pos_clip[..., :3] / torch.where(w == 0, 1.0, w)
            proj_col = TEX.sample(scene.textures,
                                  torch.clamp(ld['tex_id'], min=0),
                                  ndc[..., :2] * 0.5 + 0.5)
            color = torch.where(is_proj[..., None], color * proj_col, color)
    if meta.has_env_map:
        is_env_tex = (ld['geom_type'] == LIGHT_GEOM_ENV) & (ld['tex_id'] >= 0)
        tc_env, _ = sphere_map_to_2d_tex_coord(ray_dir)
        tc_env_t = mul_rows_2x4(ld['sam_row0'], ld['sam_row1'], tc_env)
        env_col = TEX.sample(scene.textures, torch.clamp(ld['tex_id'], min=0),
                             tc_env_t)
        color = torch.where(is_env_tex[..., None], color * env_col, color)
    return color


def environment_color(scene, meta, a_dir, mis_pt: bool, wavelengths=None):
    """EnvironmentColor (integrator_pt_lgt.cpp:175-215); in spectral mode
    the sky's SPD at ``wavelengths`` [N, 4] times its multiplier over the
    CIE Y integral, where it has one.

    Returns (color [N, 4], env_pdf [N])."""
    N = a_dir.shape[0]
    color = scene.env_color.expand(N, 4)
    if meta.spectral_mode:
        sampled = (_spd(scene, scene.env_spec_id.expand(N), wavelengths)
                   * scene.env_spec_mult / SPEC.CIE_Y_INTEGRAL)
        color = torch.where(scene.env_spec_id >= 0, sampled, color)
    out_pdf = torch.ones(N, dtype=torch.float32, device=a_dir.device)
    if meta.has_env_map:
        tc, sin_theta = sphere_map_to_2d_tex_coord(a_dir)
        tc_t = mul_rows_2x4(scene.env_sam_row0.expand(N, 4),
                            scene.env_sam_row1.expand(N, 4), tc)
        if meta.env_enable_sam and mis_pt:
            lid = scene.env_light_id.expand(N)
            ld = gather_light(scene, lid)
            map_pdf = _eval_map_2d_pdf(
                scene, tc_t, ld['pdf_table_offset'],
                torch.clamp(ld['pdf_table_size_x'], min=1),
                torch.clamp(ld['pdf_table_size_y'], min=1))
            pdf = map_pdf / (2.0 * M_PI * M_PI
                             * torch.clamp(sin_theta.abs(), min=1e-20))
            out_pdf = torch.where(sin_theta != 0.0, pdf, out_pdf)
        tex_col = TEX.sample(scene.textures,
                             torch.clamp(scene.env_tex_id, min=0).expand(N),
                             tc_t)
        color = color * tex_col
    return color, out_pdf
