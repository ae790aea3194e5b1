"""Light sampling, PDFs and intensity (clight.h, integrator_pt_lgt.cpp).

The counterpart of ``hydracore3_tpu/lights.py`` for the light types the
slice covers: the rect area light and the importance-sampled lat-long
environment.  Scenes with other light types are refused at build time
(``scene/build.py``), so only those two branches are computed and merged
with selects.
"""
from __future__ import annotations

import torch

from .utils.lmath import (M_PI, dot, mul3x3, epsilon_of_pos,
                          pdf_a_to_w, mul_rows_2x4, sphere_map_to_2d_tex_coord,
                          tex_coord_2d_to_sphere_map)
from .ops import texture as TEX
from .scene.build import LIGHT_GEOM_ENV


def gather_light(scene, light_id):
    """Per-ray light rows (clight.h LightSource) by plain indexing."""
    lid = torch.clamp(light_id, 0, scene.light_pos.shape[0] - 1)
    return {k: getattr(scene, 'light_' + k)[lid] for k in (
        'pos', 'norm', 'intensity', 'matrix', 'sam_row0', 'sam_row1',
        'sam_row0_inv', 'sam_row1_inv', 'size', 'pdf_a', 'mult', 'geom_type',
        'pdf_table_offset', 'pdf_table_size_x', 'pdf_table_size_y', 'tex_id',
        'ies_id')}


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
    """LightSampleRev: dict(pos, norm, pdf, is_omni)."""
    ld = gather_light(scene, light_id)
    # rect (clight.h:67-84)
    off = 2.0 * (rands3[..., :2] - 0.5) * ld['size']
    local = torch.stack([off[..., 0], torch.zeros_like(off[..., 0]),
                         off[..., 1]], dim=-1)
    pos = (mul3x3(ld['matrix'], local) + ld['pos'][..., :3]
           + epsilon_of_pos(ld['pos'][..., :3])[..., None]
           * ld['norm'][..., :3])
    norm = ld['norm'][..., :3]
    pdf = torch.ones_like(rands3[..., 0])
    is_omni = torch.zeros_like(rands3[..., 0], dtype=torch.bool)
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
        is_omni = is_env
    return dict(pos=pos, norm=norm, pdf=pdf, is_omni=is_omni)


def light_pdf_select_rev(meta):
    """LightPdfSelectRev: uniform 1/N (integrator_pt_lgt.cpp:60-63)."""
    return 1.0 / float(max(meta.num_lights, 1))


def light_eval_pdf(scene, meta, light_id, illum_point, ray_dir, lpos, lnorm,
                   env_pdf):
    """LightEvalPDF (integrator_pt_lgt.cpp:71-107), rect and env."""
    ld = gather_light(scene, light_id)
    hit_dist = torch.sqrt(((illum_point - lpos) ** 2).sum(-1))
    cos_tmp = dot(ray_dir, -lnorm)
    cos_val = torch.where(ld['ies_id'] < 0, torch.clamp(cos_tmp, min=0.0),
                          cos_tmp.abs())
    pdf = pdf_a_to_w(ld['pdf_a'], hit_dist, cos_val)
    return torch.where(ld['geom_type'] == LIGHT_GEOM_ENV, env_pdf, pdf)


def light_intensity(scene, meta, light_id, ray_dir):
    """LightIntensity (integrator_pt_lgt.cpp:109-173), RGB mode."""
    ld = gather_light(scene, light_id)
    color = ld['intensity'] * ld['mult'][..., None]
    if meta.has_env_map:
        is_env_tex = (ld['geom_type'] == LIGHT_GEOM_ENV) & (ld['tex_id'] >= 0)
        tc_env, _ = sphere_map_to_2d_tex_coord(ray_dir)
        tc_env_t = mul_rows_2x4(ld['sam_row0'], ld['sam_row1'], tc_env)
        env_col = TEX.sample(scene.textures, torch.clamp(ld['tex_id'], min=0),
                             tc_env_t)
        color = torch.where(is_env_tex[..., None], color * env_col, color)
    return color


def environment_color(scene, meta, a_dir, mis_pt: bool):
    """EnvironmentColor (integrator_pt_lgt.cpp:175-215), RGB mode.

    Returns (color [N, 4], env_pdf [N])."""
    N = a_dir.shape[0]
    color = scene.env_color.expand(N, 4)
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
