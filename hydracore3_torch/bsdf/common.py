"""Shared BSDF primitives (include/cmaterial.h), batched in torch.

The subset of ``hydracore3_tpu/bsdf/common.py`` that GLTF shading uses:
ray/event flags, Lambert, Hydra GGX and the Fresnel terms.
"""
from __future__ import annotations

import torch

from ..utils.lmath import (M_PI, M_TWOPI, INV_PI, coordinate_system_v2, dot,
                           normalize, safe_sqrt,
                           map_sample_to_cosine_distribution)

# MATERIAL_EVENT (cmaterial.h:48-56)
RAY_EVENT_S = 1

# ray flags (cglobals.h:9-16)
RAY_FLAG_IS_DEAD = 0x80000000
RAY_FLAG_OUT_OF_SCENE = 0x40000000
RAY_FLAG_HIT_LIGHT = 0x20000000
RAY_FLAG_HAS_NON_SPEC = 0x10000000
RAY_FLAG_HAS_INV_NORMAL = 0x08000000
RAY_FLAG_PRIME_RAY_MISS = 0x02000000
RAY_FLAG_FIRST_NON_SPEC = 0x01000000


# Lambert (cmaterial.h:215-228)

def lambert_sample(rands2, v, n):
    return map_sample_to_cosine_distribution(rands2[..., 0], rands2[..., 1],
                                             n, n, 1.0)


def lambert_eval_pdf(l, v, n):
    return dot(l, n).abs() * INV_PI


def lambert_eval_bsdf(l, v, n):
    return torch.full(l.shape[:-1], INV_PI, dtype=l.dtype, device=l.device)


# Hydra GGX (cmaterial.h:322-397)

def ggx_distribution(cos_theta_nh, alpha):
    alpha2 = alpha * alpha
    nh_sqr = torch.clamp(cos_theta_nh * cos_theta_nh, 0.0, 1.0)
    den = nh_sqr * alpha2 + (1.0 - nh_sqr)
    return alpha2 / torch.clamp(M_PI * den * den, min=1e-6)


def ggx_geom_shad_mask(cos_theta_n, alpha):
    cos2 = torch.clamp(cos_theta_n * cos_theta_n, 0.0, 1.0)
    tan2 = (1.0 - cos2) / torch.clamp(cos2, min=1e-6)
    return 2.0 / (1.0 + safe_sqrt(1.0 + alpha * alpha * tan2))


def spherical_direction_pbrt(sintheta, costheta, phi):
    return torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi),
                        costheta], dim=-1)


def ggx_sample(rands2, v, n, roughness):
    rough_sqr = roughness * roughness
    nx, ny = coordinate_system_v2(n)
    nz = n
    wo = torch.stack([dot(v, nx), dot(v, ny), dot(v, nz)], dim=-1)
    phi = rands2[..., 0] * M_TWOPI
    r2 = rands2[..., 1]
    cos_theta = torch.clamp(
        safe_sqrt((1.0 - r2) / (1.0 + rough_sqr * rough_sqr * r2 - r2)),
        0.0, 1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    wh = spherical_direction_pbrt(sin_theta, cos_theta, phi)
    wi = 2.0 * dot(wo, wh)[..., None] * wh - wo
    world = wi[..., 0:1] * nx + wi[..., 1:2] * ny + wi[..., 2:3] * nz
    return normalize(world)


def ggx_eval_pdf(l, v, n, roughness):
    dot_nv = dot(n, v)
    dot_nl = dot(n, l)
    rough_sqr = roughness * roughness
    h = normalize(v + l)
    dot_nh = dot(n, h)
    dot_hv = dot(h, v)
    d = ggx_distribution(dot_nh, rough_sqr)
    pdf = d * dot_nh / (4.0 * torch.clamp(dot_hv, min=1e-6))
    return torch.where((dot_nv < 1e-6) | (dot_nl < 1e-6), 1.0, pdf)


def ggx_eval_bsdf(l, v, n, roughness):
    dot_nv = dot(n, v)
    dot_nl = dot(n, l)
    rough_sqr = roughness * roughness
    h = normalize(v + l)
    dot_nh = dot(n, h)
    d = ggx_distribution(dot_nh, rough_sqr)
    g = (ggx_geom_shad_mask(dot_nv, rough_sqr)
         * ggx_geom_shad_mask(dot_nl, rough_sqr))
    val = d * g / torch.clamp(4.0 * dot_nv * dot_nl, min=1e-6)
    bad = (dot(l, n).abs() < 1e-5) | (dot_nv < 1e-6) | (dot_nl < 1e-6)
    return torch.where(bad, 0.0, val)


# Fresnel (cmaterial.h:536-717)

def fr_dielectric_pbrt(cos_theta_i, eta_i, eta_t):
    """FrDielectricPBRT; eta == 0 means "Fresnel disabled" and stays
    NaN-free."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    eta_i = torch.as_tensor(eta_i, dtype=cos_theta_i.dtype,
                            device=cos_theta_i.device)
    eta_t = torch.as_tensor(eta_t, dtype=cos_theta_i.dtype,
                            device=cos_theta_i.device)
    entering = cos_theta_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    et_s = torch.where(et.abs() < 1e-12, 1.0, et)
    ei_s = torch.where(ei.abs() < 1e-12, 1.0, ei)
    ci = cos_theta_i.abs()
    sin_i = safe_sqrt(1.0 - ci * ci)
    sin_t = ei_s / et_s * sin_i
    ct = safe_sqrt(1.0 - sin_t * sin_t)
    denom1 = et_s * ci + ei_s * ct
    denom2 = ei_s * ci + et_s * ct
    r_parl = (et_s * ci - ei_s * ct) / torch.where(denom1.abs() < 1e-12, 1.0,
                                                   denom1)
    r_perp = (ei_s * ci - et_s * ct) / torch.where(denom2.abs() < 1e-12, 1.0,
                                                   denom2)
    r = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(sin_t >= 1.0, 1.0, r)


def fresnel_slick(v_dot_h):
    tmp = 1.0 - v_dot_h.abs()
    return (tmp * tmp) * (tmp * tmp) * tmp


def hydra_fresnel_cond(f0, v_dot_h, ior, roughness):
    """cmaterial.h:711-717."""
    fr = f0 + (1.0 - f0) * fresnel_slick(v_dot_h)[..., None]
    return torch.where((ior == 0.0)[..., None], f0, fr)
