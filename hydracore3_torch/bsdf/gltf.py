"""GLTF metal-rough material (include/cmat_gltf.h), batched in torch.

Every lobe is computed for the whole batch and merged with selects, the
same estimator as ``hydracore3_tpu/bsdf/gltf.py``.
"""
from __future__ import annotations

import torch

from ..utils.lmath import dot, normalize, lerp, reflect
from . import common as C
from ..scene import build as B


def _params(md, four_params):
    metalness = md['data'][..., B.GLTF_FLOAT_ALPHA] * four_params[..., 1]
    metalness = torch.where(md['cflags'] == B.GLTF_COMPONENT_METAL, 1.0,
                            metalness)
    roughness = torch.clamp(
        1.0 - md['data'][..., B.GLTF_FLOAT_GLOSINESS] * four_params[..., 0],
        0.0, 1.0)
    coat_value = md['data'][..., B.GLTF_FLOAT_REFL_COAT] * four_params[..., 2]
    fresnel_ior = md['data'][..., B.GLTF_FLOAT_IOR]
    return roughness, metalness, coat_value, fresnel_ior


def sample_and_eval(md, rands, v, n, base_color, four_params):
    """gltfSampleAndEval (cmat_gltf.h:6-91).

    md: gathered material dict; rands [N, 4]; v, n [N, 3]; base_color
    [N, 4].  Returns dict(val [N, 4], dir [N, 3], pdf [N], flags [N] int64).
    """
    metal_col = md['colors'][..., B.GLTF_COLOR_METAL, :] * base_color
    coat_col = md['colors'][..., B.GLTF_COLOR_COAT, :]
    roughness, metalness, coat_value, fresnel_ior = _params(md, four_params)

    smooth = roughness == 0.0
    # mirror branch
    perf_refl = reflect(-v, n)
    cos_out = dot(perf_refl, n)
    mirror_val = torch.where(cos_out <= 1e-6, 0.0,
                             1.0 / torch.clamp(cos_out, min=1e-6))
    # ggx branch
    ggx_dir_r = C.ggx_sample(rands[..., :2], v, n, roughness)
    ggx_dir = torch.where(smooth[..., None], perf_refl, ggx_dir_r)
    ggx_pdf = torch.where(smooth, 1.0, C.ggx_eval_pdf(ggx_dir_r, v, n,
                                                      roughness))
    ggx_val = torch.where(smooth, mirror_val,
                          C.ggx_eval_bsdf(ggx_dir_r, v, n, roughness))

    lam_dir = C.lambert_sample(rands[..., :2], v, n)
    lam_pdf = C.lambert_eval_pdf(lam_dir, v, n)
    lam_val = C.lambert_eval_bsdf(lam_dir, v, n)

    pick_metal = rands[..., 2] < metalness
    v_dot_h = dot(v, normalize(v + ggx_dir))

    metal_bsdf = (ggx_val[..., None] * metalness[..., None]
                  * C.hydra_fresnel_cond(metal_col, v_dot_h, fresnel_ior,
                                         roughness))
    non_spec = torch.full_like(smooth, C.RAY_FLAG_HAS_NON_SPEC,
                               dtype=torch.int64)
    spec_flags = torch.where(smooth, C.RAY_EVENT_S, non_spec)

    # dielectric: specular vs diffuse
    f_i = C.fr_dielectric_pbrt(dot(v, n).abs(), 1.0, fresnel_ior)
    prob_spec = 0.5 * coat_value
    prob_diff = 1.0 - prob_spec
    pick_spec = rands[..., 3] < prob_spec

    coat_bsdf = ((ggx_val * (1.0 - metalness) * f_i * coat_value)[..., None]
                 * coat_col)
    lam_bsdf = (lam_val * (1.0 - metalness))[..., None] * base_color
    # plastic retroreflection correction (cmat_gltf.h:82-88)
    m_fdr_int = md['data'][..., B.GLTF_FLOAT_MI_FDR_INT]
    f_o = C.fr_dielectric_pbrt(dot(lam_dir, n).abs(), 1.0, fresnel_ior)
    coeff = lerp(1.0, (1.0 - f_i) * (1.0 - f_o)
                 / torch.clamp(fresnel_ior * fresnel_ior * (1.0 - m_fdr_int),
                               min=1e-12),
                 coat_value)
    apply_coat = (coat_value > 0.0) & (fresnel_ior > 0.0)
    lam_bsdf = torch.where(apply_coat[..., None], lam_bsdf * coeff[..., None],
                           lam_bsdf)

    pm, ps = pick_metal[..., None], pick_spec[..., None]
    out_dir = torch.where(pm, ggx_dir, torch.where(ps, ggx_dir, lam_dir))
    out_val = torch.where(pm, metal_bsdf, torch.where(ps, coat_bsdf, lam_bsdf))
    out_pdf = torch.where(pick_metal, ggx_pdf,
                          torch.where(pick_spec, ggx_pdf, lam_pdf))
    out_flags = torch.where(pick_metal, spec_flags,
                            torch.where(pick_spec, spec_flags, non_spec))
    pdf_select = torch.where(pick_metal, metalness,
                             (1.0 - metalness)
                             * torch.where(pick_spec, prob_spec, prob_diff))
    return dict(val=out_val, dir=out_dir, pdf=out_pdf * pdf_select,
                flags=out_flags)


def eval(md, l, v, n, base_color, four_params):
    """gltfEval (cmat_gltf.h:94-147). Returns dict(val [N, 4], pdf [N])."""
    metal_col = md['colors'][..., B.GLTF_COLOR_METAL, :] * base_color
    coat_col = md['colors'][..., B.GLTF_COLOR_COAT, :]
    roughness, metalness, coat_value, fresnel_ior = _params(md, four_params)

    rough = roughness != 0.0
    ggx_val = torch.where(rough, C.ggx_eval_bsdf(l, v, n, roughness), 0.0)
    ggx_pdf = torch.where(rough, C.ggx_eval_pdf(l, v, n, roughness), 0.0)
    v_dot_h = torch.where(rough, dot(v, normalize(v + l)), dot(v, n))

    lam_val = C.lambert_eval_bsdf(l, v, n)
    lam_pdf = C.lambert_eval_pdf(l, v, n)

    plastic = (coat_value > 0.0) & (metalness < 1.0) & (fresnel_ior > 0.0)
    f_i_c = C.fr_dielectric_pbrt(dot(v, n).abs(), 1.0, fresnel_ior)
    f_o = C.fr_dielectric_pbrt(dot(l, n).abs(), 1.0, fresnel_ior)
    m_fdr_int = md['data'][..., B.GLTF_FLOAT_MI_FDR_INT]
    coeff = lerp(1.0, (1.0 - f_i_c) * (1.0 - f_o)
                 / torch.clamp(fresnel_ior * fresnel_ior * (1.0 - m_fdr_int),
                               min=1e-12),
                 coat_value)
    lam_val = torch.where(plastic, lam_val * coeff, lam_val)
    f_i = torch.where(plastic, f_i_c, 1.0)

    f_conductor = C.hydra_fresnel_cond(metal_col, v_dot_h, fresnel_ior,
                                       roughness)
    specular_color = ggx_val[..., None] * f_conductor

    prob_spec = 0.5 * coat_value
    prob_diff = 1.0 - prob_spec
    dielectric_val = (lam_val[..., None] * base_color
                      + (ggx_val * f_i * coat_value)[..., None] * coat_col)
    dielectric_pdf = lam_pdf * prob_diff + ggx_pdf * prob_spec
    val = (metalness[..., None] * specular_color
           + (1.0 - metalness)[..., None] * dielectric_val)
    pdf = metalness * ggx_pdf + (1.0 - metalness) * dielectric_pdf
    return dict(val=val, pdf=pdf)
