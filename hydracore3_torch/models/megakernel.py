"""The path-tracing megakernel for small scenes (the Cornell class).

The counterpart of ``hydracore3_tpu/models/megakernel.py``.  A scene of at
most 4096 triangles whose features ``supported`` admits is rendered one
whole sample per lane: camera ray, then per bounce a nearest-hit trace,
next-event estimation (light sample, shadow any-hit, material eval), a
material sample and the next ray; then the flat environment on a miss and
the contribution.  ``regen`` mode keeps lanes persistent instead: a lane
whose path dies flushes the sample into its own accumulator and starts the
next sample of its pixel at once, and the frame is normalized by each
pixel's completed-sample count.

The module has the JAX module's names.  The stage functions
(``stage_init``, ``stage_trace``, ``stage_nee``, ``stage_next_bounce``,
``stage_env_contribute``, ``mat_eval``, ``mat_sample``, the light
functions) work on component-major planes: a per-lane scalar is an ``[N]``
tensor and a vector an ``[k, N]`` one, with the JAX module's arithmetic in
its order, so the plain versions ``sample_pass_plain`` and
``regen_iters_plain`` agree with ``sample_pass_ref`` and the regen kernels
lane by lane.  Their trace is the contract's brute Woop trace over every
triangle (``_trace_blocks``).  The wrappers ``sample_pass`` and
``regen_pass`` run those plain versions for CPU tensors and launch the
hand-written CUDA kernels of ``csrc/megakernel.cu`` for CUDA tensors (or
raise); the kernels walk the pack's wide BVH (``wide_table``) instead of
testing every triangle and return the brute trace's hits bit for bit.  RNG
states and flags are int64 tensors holding uint32 values (``ops/rng.py``).

What the slice covers is the JAX gate (``why_unsupported`` names the
rest): the naive, shadow and MIS integrators; GLTF, diffuse (Lambert,
Oren-Nayar), conductor (smooth, rough), dielectric, old-Hydra glass and
emissive light-source materials; rect, disc, sphere and point lights;
slot-0 textures (f32 pool, in-kernel bilinear or nearest taps) or the
const-texture fold; a flat environment color, or a lat-long env map
tapped on a miss (not importance-sampled); a pinhole camera.  Each stage
evaluates only the material types the scene holds (``MegaPack.mtypes``),
and the kernel is built once per (integrator, material set, env tap,
spectral mode).

Hero-wavelength spectral mode (the JAX gate's spectral scenes: no
spectral texture or response, no env map, no dielectric or glass, at most
29 spectra): ``stage_init`` draws 4 wavelengths after the pixel offsets;
a diffuse's reflectance, a conductor's eta and k, a light's emission and
the sky are their SPDs at those wavelengths where the material, light or
sky names one (``spd_or_color``: the color otherwise, and a diffuse's
texture is not applied); ``spectral_contrib`` converts the sample to RGB
through the CIE curves.  The SPD values are one flat table with a row
offset per spectrum (``MegaPack.spd``, ``spd_off``), read by plain
indexing, and the CIE curves a [471, 4] table: the JAX pack's [NS, 4, 128]
chunk rows and its static candidate sets are TPU gathers the card does not
need.  The regen lane state carries the 4 wavelengths in rows
``SF_LAM``.. (its accumulator moves 4 rows down, ``rf_acc``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import time

import numpy as np
import torch

from ..ops import rng as RNG
from ..ops import spectrum as SPEC
from ..ops import texture as TEX
from ..bsdf import common as C
from ..bsdf.common import (fresnel_slick, fr_dielectric_pbrt,
                           ggx_distribution, ggx_geom_shad_mask)
from ..utils.lmath import (safe_sqrt, pdf_a_to_w,
                           mis_weight_heuristic as mis_weight)
from ..accel import traverse_stream as TST
from ..accel import wide_bvh as WB
from ..scene.build import (MAT_TYPE_GLTF, MAT_TYPE_DIFFUSE,
                           MAT_TYPE_CONDUCTOR, MAT_TYPE_DIELECTRIC,
                           MAT_TYPE_GLASS, MAT_TYPE_LIGHT_SOURCE,
                           MTYPE_SMALL_LIGHT, GLTF_COMPONENT_METAL,
                           GLTF_COMPONENT_ORENNAYAR,
                           GLTF_FLOAT_MI_FDR_INT, GLTF_FLOAT_ALPHA,
                           GLTF_FLOAT_GLOSINESS, GLTF_FLOAT_IOR,
                           GLTF_FLOAT_REFL_COAT, DIELECTRIC_ETA_EXT,
                           DIELECTRIC_ETA_INT, GLASS_FLOAT_IOR,
                           CONDUCTOR_ETA, CONDUCTOR_K,
                           LIGHT_GEOM_RECT, LIGHT_GEOM_DISC,
                           LIGHT_GEOM_SPHERE, LIGHT_GEOM_POINT,
                           LIGHT_DIST_LAMBERT, LIGHT_DIST_OMNI, INVALID_ID,
                           SMALL_SCENE_TRIS)
from ..utils.native import PKG_DIR, build_shared_library
from ..utils.spans import span
from .integrator_pt import (INTEGRATOR_STUPID_PT, INTEGRATOR_SHADOW_PT,
                           INTEGRATOR_MIS_PT, INTEGRATOR_BY_NAME)

M_PI = math.pi
INV_PI = 1.0 / math.pi
M_TWOPI = 2.0 * math.pi
FLT_MAX = 3.4e38
GEPSILON = 1e-5
RBLK = 2048            # the JAX render's lane granularity (16 x 128 rays)
_BIG_I = 0x7FFFFFF0

# K1's material-set bits, one per shaded type, and one for disc lights
# (csrc/megakernel.cu MT_*)
MT_BITS = {MAT_TYPE_GLTF: 1, MAT_TYPE_DIFFUSE: 2, MAT_TYPE_CONDUCTOR: 4,
           MAT_TYPE_DIELECTRIC: 8, MAT_TYPE_GLASS: 16}
DISC_BIT = 32
REGEN_ITERS = 16       # rmid iterations per regen launch (JAX's kit)
K_SAMPLES = 16         # fixed-chain samples summed per chunk (JAX's default)

# material table columns ([128, MF_NROWS] f32, one row per material)
MF_MTYPE = 0         # small mtype code (MTYPE_SMALL_LIGHT for lights)
MF_CFLAGS = 1
MF_C0 = 2            # colors[0] = base / emission  (4)
MF_C1 = 6            # colors[1] = coat             (4)
MF_C2 = 10           # colors[2] = metal            (4)
MF_DATA = 14         # data[0..7]                   (8)
MF_TEXID = 22
MF_TEXC = 23         # folded slot-0 texel          (4)
MF_ROW0 = 27         # slot-0 uv transform row 0    (4)
MF_ROW1 = 31         # slot-0 uv transform row 1    (4)
MF_SPD0 = 35         # slot-0 SPD id (-1: none)     [spectral scenes]
MF_SPD1 = 36         # slot-1 SPD id (-1: none)
MF_NROWS = 40        # (37-39 pad the row to whole float4s, which K1 loads)

# light table columns ([128, LF_NROWS] f32)
LF_POS = 0           # 3
LF_NORM = 3          # 3
LF_INT = 6           # 4
LF_MAT = 10          # 3x3 rotation of 'matrix', row-major (9)
LF_SIZE = 19         # 2
LF_PDFA = 21
LF_MULT = 22
LF_GEOM = 23
LF_DIST = 24
LF_SPD = 25          # emission SPD id (-1: none)   [spectral scenes]
LF_NROWS = 28        # (26-27 pad)

# texture slot table columns ([128, TF_NROWS] f32)
TF_OFF, TF_W, TF_H, TF_FILT, TF_AU, TF_AV, TF_NROWS = range(7)

# consts vector layout ([CN_NROWS] f32)
CN_PROJ_INV = 0       # 16
CN_WVI = 16           # 16 (world_view_inv)
CN_CAM_RESP = 32      # 4
CN_ENV_COLOR = 36     # 4
CN_NUM_LIGHTS = 40
CN_WIDTH = 41
CN_HEIGHT = 42
CN_EXPOSURE = 43
CN_ENV_SROW0 = 44     # 4 env sampler matrix row 0
CN_ENV_SROW1 = 48     # 4 env sampler matrix row 1
CN_ENV_TEXID = 52
CN_ENV_SPD = 53       # the sky's SPD id (-1: none)  [spectral scenes]
CN_ENV_SMULT = 54     # its multiplier over the CIE Y integral, in f32
CN_NSPD = 55          # the number of spectra (an SPD id is clamped to it)
CN_NROWS = 56

# regen lane state: f32 rows [RF_NROWS, N] and uint32 rows [RU_NROWS, N]
SF_O, SF_D, SF_ACCUM, SF_THR = 0, 3, 6, 10
SF_MISPDF, SF_MISIOR = 14, 15
SF_HITPOS, SF_HITNORM, SF_HITUV = 16, 19, 22
SF_HITDIST, SF_HITLGT = 24, 25
SF_LAM = 26           # 4 rows: the hero wavelengths [spectral scenes]
RF_ACC = 26           # 4 rows: sum of completed-sample contributions
RF_NROWS = 30         # (spectral scenes: 4 more, ``rf_acc``)
SU_RNGX, SU_RNGY, SU_FLAGS = 0, 1, 2
RU_NDONE = 3          # completed-sample count
RU_BCNT = 4           # bounces shaded for the in-flight sample
RU_NROWS = 5


# ===========================================================================
# plane math (scalars [N], vectors [k, N]; the JAX module's op order).  The
# elementwise helpers come from bsdf/common.py, utils/lmath.py and
# ops/rng.py; those below put vectors on axis 0 (the shared ones put them on
# the last axis) or follow the JAX megakernel's own arithmetic.
# ===========================================================================

def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def normalize3(a):
    return a * torch.rsqrt(torch.clamp(dot3(a, a), min=1e-30))


def acos_poly(x):
    """arccos via Abramowitz-Stegun 4.4.45 (the JAX module's; |err| <
    2e-8)."""
    ax = torch.clamp(x.abs(), 0.0, 1.0)
    p = torch.full_like(ax, -0.0012624911)
    for c in (0.0066700901, -0.0170881256, 0.0308918810, -0.0501743046,
              0.0889789874, -0.2145988016, 1.5707963050):
        p = p * ax + c
    r = p * torch.sqrt(1.0 - ax)
    return torch.where(x < 0.0, M_PI - r, r)


def coordinate_system_v2(n):
    """Duff et al. basis (cglobals.h:120-132)."""
    nx, ny, nz = n[0], n[1], n[2]
    pos = nz >= 0
    sign = torch.where(pos, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([torch.where(pos, nx * nx * a, -nx * nx * a) + 1.0,
                     torch.where(pos, b, -b), torch.where(pos, -nx, nx)])
    t = torch.stack([b, ny * ny * a + sign, -ny])
    return s, t


def map_sample_to_cosine_distribution(r1, r2, direction, hit_norm):
    """power=1 cosine hemisphere sample (cglobals.h:143-181)."""
    sin_phi = torch.sin(M_TWOPI * r1)
    cos_phi = torch.cos(M_TWOPI * r1)
    cos_theta = torch.sqrt(torch.clamp(1.0 - r2, min=1e-20))
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    dx = sin_theta * cos_phi
    dy = sin_theta * sin_phi
    dz = cos_theta
    nx, ny = coordinate_system_v2(direction)
    nz = direction
    res = nx * dx + ny * dy + nz * dz
    inv_sign = torch.where(dot3(direction, hit_norm) > 0.0, 1.0, -1.0)
    below = inv_sign * dot3(res, hit_norm) < 0.0
    res_flipped = -nx * dx + ny * dy - nz * dz
    return torch.where(below, res_flipped, res)


def epsilon_of_pos(p3):
    m = torch.clamp(torch.maximum(p3[0].abs(), torch.maximum(
        p3[1].abs(), p3[2].abs())), min=2.0 * GEPSILON)
    return m * GEPSILON


def offs_ray_pos(hit_pos, n, d):
    sign = torch.where(dot3(d, n) < 0.0, -1.0, 1.0)
    return hit_pos + (sign * epsilon_of_pos(hit_pos)) * n


# GGX and Fresnel (cmaterial.h)

def ggx_sample(r1, r2, v, n, roughness):
    rough2 = roughness * roughness
    nx, ny = coordinate_system_v2(n)
    nz = n
    wox, woy, woz = dot3(v, nx), dot3(v, ny), dot3(v, nz)
    phi = r1 * M_TWOPI
    cos_t = torch.clamp(safe_sqrt((1.0 - r2) / (1.0 + rough2 * rough2 * r2
                                                - r2)), 0.0, 1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    whx = sin_t * torch.cos(phi)
    why = sin_t * torch.sin(phi)
    whz = cos_t
    dwh = wox * whx + woy * why + woz * whz
    wix = 2.0 * dwh * whx - wox
    wiy = 2.0 * dwh * why - woy
    wiz = 2.0 * dwh * whz - woz
    return normalize3(nx * wix + ny * wiy + nz * wiz)


def ggx_eval_pdf(l, v, n, roughness):
    dot_nv = dot3(n, v)
    dot_nl = dot3(n, l)
    rough2 = roughness * roughness
    h = normalize3(v + l)
    dot_nh = dot3(n, h)
    dot_hv = dot3(h, v)
    d = ggx_distribution(dot_nh, rough2)
    pdf = d * dot_nh / (4.0 * torch.clamp(dot_hv, min=1e-6))
    return torch.where((dot_nv < 1e-6) | (dot_nl < 1e-6), 1.0, pdf)


def ggx_eval_bsdf(l, v, n, roughness):
    dot_nv = dot3(n, v)
    dot_nl = dot3(n, l)
    rough2 = roughness * roughness
    h = normalize3(v + l)
    dot_nh = dot3(n, h)
    d = ggx_distribution(dot_nh, rough2)
    g = ggx_geom_shad_mask(dot_nv, rough2) * ggx_geom_shad_mask(dot_nl, rough2)
    val = d * g / torch.clamp(4.0 * dot_nv * dot_nl, min=1e-6)
    bad = (dot3(l, n).abs() < 1e-5) | (dot_nv < 1e-6) | (dot_nl < 1e-6)
    return torch.where(bad, 0.0, val)


def hydra_fresnel_cond(f0_4, v_dot_h, ior):
    fr = f0_4 + (1.0 - f0_4) * fresnel_slick(v_dot_h)
    return torch.where(ior == 0.0, f0_4, fr)


def reflect3(d, n):
    return d - 2.0 * dot3(d, n) * n


def cross3(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def map_samples_to_disc(x, y):
    """cglobals.h:188-231 ([-1, 1]^2 -> the disc, with the reference's
    sin/cos swap), in the JAX megakernel's form.  Returns (px, py)."""
    zero = (x == 0.0) & (y == 0.0)
    case_x = x.abs() > y.abs()
    sx = torch.where(x == 0.0, 1.0, x)
    sy = torch.where(y == 0.0, 1.0, y)
    r = torch.where(case_x, x, y)
    phi = torch.where(case_x, (M_PI / 4.0) * (y / sx),
                      (M_PI / 2.0) - (x / sy) * (M_PI / 4.0))
    r = torch.where(zero, 0.0, r)
    phi = torch.where(zero, 0.0, phi)
    return r * torch.sin(phi), r * torch.cos(phi)


def orennayar_func(l, v, n, roughness):
    """cmaterial.h:254-312 on planes."""
    cos_wi = dot3(l, n)
    cos_wo = dot3(v, n)
    sin_wi = safe_sqrt(1.0 - cos_wi * cos_wi)
    sin_wo = safe_sqrt(1.0 - cos_wo * cos_wo)
    sigma = roughness * M_PI * 0.5
    sigma2 = sigma * sigma
    A = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    B = 0.45 * sigma2 / (sigma2 + 0.09)
    nx, ny = coordinate_system_v2(n)
    wo0, wo1 = -dot3(v, nx), -dot3(v, ny)
    wi0, wi1 = -dot3(l, nx), -dot3(l, ny)

    def sphi(w1, st):
        return torch.where(st == 0.0, 0.0, torch.clamp(
            w1 / torch.where(st == 0.0, 1.0, st), -1.0, 1.0))

    def cphi(w0, st):
        return torch.where(st == 0.0, 1.0, torch.clamp(
            w0 / torch.where(st == 0.0, 1.0, st), -1.0, 1.0))

    dcos = (cphi(wi0, sin_wi) * cphi(wo0, sin_wo)
            + sphi(wi1, sin_wi) * sphi(wo1, sin_wo))
    maxcos = torch.where((sin_wi > 1e-4) & (sin_wo > 1e-4),
                         torch.clamp(dcos, min=0.0), 0.0)
    wi_big = cos_wi.abs() > cos_wo.abs()
    sinalpha = torch.where(wi_big, sin_wo, sin_wi)
    tanbeta = torch.where(wi_big,
                          sin_wi / torch.clamp(cos_wi.abs(), min=1e-20),
                          sin_wo / torch.clamp(cos_wo.abs(), min=1e-20))
    return A + B * maxcos * sinalpha * tanbeta


# Trowbridge-Reitz and the complex Fresnel (cmaterial.h:405-694) on
# local-frame planes [3, N]

def _sin2_l(w):
    return torch.clamp(1.0 - w[2] * w[2], min=0.0)


def _tan2_l(w):
    return _sin2_l(w) / torch.clamp(w[2] * w[2], min=1e-20)


def _cossin_phi_l(w):
    st = safe_sqrt(_sin2_l(w))
    safe = torch.where(st == 0.0, 1.0, st)
    cp = torch.where(st == 0.0, 1.0, torch.clamp(w[0] / safe, -1.0, 1.0))
    sp = torch.where(st == 0.0, 0.0, torch.clamp(w[1] / safe, -1.0, 1.0))
    return cp, sp


def tr_d_p(wm, a0, a1):
    """trD (cmaterial.h:460-470)."""
    tan2 = _sin2_l(wm) / (wm[2] * wm[2])      # inf where cos == 0
    cos4 = (wm[2] * wm[2]) ** 2
    cp, sp = _cossin_phi_l(wm)
    e = tan2 * ((cp / a0) ** 2 + (sp / a1) ** 2)
    val = 1.0 / (M_PI * a0 * a1 * cos4 * (1 + e) * (1 + e))
    return torch.where((cos4 < 1e-16) | ~torch.isfinite(tan2), 0.0, val)


def tr_lambda_p(w, a0, a1):
    tan2 = _tan2_l(w)
    cp, sp = _cossin_phi_l(w)
    a2 = (cp * a0) ** 2 + (sp * a1) ** 2
    val = (safe_sqrt(1.0 + a2 * tan2) - 1.0) / 2.0
    return torch.where(torch.isfinite(tan2), val, 0.0)


def tr_g_p(wo, wi, a0, a1):
    return 1.0 / (1.0 + tr_lambda_p(wo, a0, a1) + tr_lambda_p(wi, a0, a1))


def tr_pdf_p(w, wm, a0, a1):
    g1 = 1.0 / (1.0 + tr_lambda_p(w, a0, a1))
    return (g1 / torch.clamp(w[2].abs(), min=1e-20) * tr_d_p(wm, a0, a1)
            * dot3(w, wm).abs())


def tr_sample_p(wo, r0, r1, a0, a1):
    """trSample, VNDF sampling (cmaterial.h:506-530)."""
    wh = normalize3(torch.stack([a0 * wo[0], a1 * wo[1], wo[2]]))
    wh = torch.where(wh[2] < 0.0, -wh, wh)
    zero = torch.zeros_like(wh[0])
    t1n = normalize3(torch.stack([-wh[1], wh[0], zero]))
    near_z = wh[2] >= 0.99999
    t1 = torch.stack([torch.where(near_z, 1.0, t1n[0]),
                      torch.where(near_z, 0.0, t1n[1]), zero])
    t2 = cross3(wh, t1)
    pr = safe_sqrt(r0)
    th = M_TWOPI * r1
    px = pr * torch.cos(th)
    py0 = pr * torch.sin(th)
    h = safe_sqrt(1.0 - px * px)
    py = h + (py0 - h) * ((1.0 + wh[2]) / 2.0)
    pz = safe_sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))
    nh = t1 * px + t2 * py + wh * pz
    return normalize3(torch.stack([a0 * nh[0], a1 * nh[1],
                                   torch.clamp(nh[2], min=1e-6)]))


def fr_complex_cond(cos_i, eta, k):
    """FrComplexConductor (cmaterial.h:685-694) in real arithmetic, as the
    JAX megakernel has it; eta_c = eta + i k."""
    def cdiv(ar, ai, br, bi):
        d = br * br + bi * bi
        d = torch.where(d == 0.0, 1e-30, d)
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d

    def csqrt(xr, xi):
        m = torch.sqrt(xr * xr + xi * xi)
        u = torch.sqrt(torch.clamp((m + xr) * 0.5, min=0.0))
        v = torch.sqrt(torch.clamp((m - xr) * 0.5, min=0.0))
        return u, torch.where(xi < 0.0, -v, v)

    sin2 = 1.0 - cos_i * cos_i
    e2r = eta * eta - k * k
    e2i = 2.0 * eta * k
    str_, sti = cdiv(sin2, torch.zeros_like(sin2), e2r, e2i)
    ctr, cti = csqrt(1.0 - str_, -sti)
    ecr = eta * cos_i
    eci = k * cos_i
    pr_r, pr_i = cdiv(ecr - ctr, eci - cti, ecr + ctr, eci + cti)
    sr_r, sr_i = cdiv(cos_i - (eta * ctr - k * cti), -(eta * cti + k * ctr),
                      cos_i + (eta * ctr - k * cti), (eta * cti + k * ctr))
    return 0.5 * (pr_r * pr_r + pr_i * pr_i + sr_r * sr_r + sr_i * sr_i)


# ===========================================================================
# scene packing
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class MegaPack:
    """The megakernel's tables, one per (scene, meta), on one device."""
    woop: torch.Tensor     # [Tpad, 12] f32: Woop rows x, y, z (4 each)
    shade: torch.Tensor    # [Tpad, 32] f32 shade rows (+matid @24, light @25)
    mat: torch.Tensor      # [128, MF_NROWS] f32
    light: torch.Tensor    # [128, LF_NROWS] f32
    tex: torch.Tensor      # [128, TF_NROWS] f32
    consts: torch.Tensor   # [CN_NROWS] f32
    texels: torch.Tensor   # [P, 4] f32 texture pool
    n_tris: int            # Tpad
    tex_const: bool        # every slot-0 tap folds to MF_TEXC
    # what K1's trace walks (``wide_table``): 4-wide nodes over leaves of at
    # most 4 of the real triangles' Woop rows; None when the pack was made
    # without the soup, and the card then refuses the pack
    wide: WB.WidePack | None = None
    env_mapped: bool = False   # the env lat-long map is tapped on a miss
    # the scene's material types (meta.mat_types_present): every stage
    # evaluates only these, and K1 is built for them
    mtypes: tuple = (MAT_TYPE_GLTF, MAT_TYPE_LIGHT_SOURCE)
    has_disc: bool = True      # the scene has a disc light
    # hero-wavelength spectral mode: the SPD values on their 1 nm grid
    # (scene.spec_values), each spectrum's first row (i32), the CIE 1931
    # curves [471, 4]; None in RGB mode
    spectral: bool = False
    spd: torch.Tensor | None = None
    spd_off: torch.Tensor | None = None
    cie: torch.Tensor | None = None


def material_bits(mtypes, has_disc: bool = False) -> int:
    """K1's material-set bitmask (``MT_BITS``) of a pack's types, with
    ``DISC_BIT`` for a scene with disc lights."""
    return (sum(b for t, b in MT_BITS.items() if t in mtypes)
            + (DISC_BIT if has_disc else 0))


# K1 walks the pack's wide BVH in place of the brute trace and must return
# the brute trace's hit on every lane: its boxes are widened by
# wide_bvh.box_margin (the reason is stated at wide_bvh.MARGIN_REL).
MEGA_STACK = 32        # stack entries per lane the kernel provides


def wide_table(v0, e1, e2, woop) -> WB.WidePack:
    """K1's wide BVH over a soup's T real triangles (v0, e1, e2 [T, 3], the
    contract's order) and its Woop rows ``woop`` ([>= T, 12], the pack's):
    ``rows`` are ``woop[index]`` bit for bit, padding rows appear nowhere,
    and every child box is widened by ``wide_bvh.box_margin``."""
    v0, e1, e2 = (np.asarray(a, np.float32) for a in (v0, e1, e2))
    T = len(v0)
    fine = WB._fine_bvh(v0, e1, e2)
    nodes, stack = WB.collapse(fine)
    margin = WB.box_margin(v0, e1, e2)
    WB.widen_boxes(nodes, margin)
    index = fine.order.astype(np.int32)
    rows = np.asarray(woop, np.float32).reshape(-1, 12)[:T][index]
    return WB.WidePack(nodes=nodes, rows=np.ascontiguousarray(rows),
                       index=index, stack=stack, woop=True, margin=margin)


SHADED_MATERIALS = frozenset(MT_BITS) | {MAT_TYPE_LIGHT_SOURCE}


def why_unsupported(scene, meta, integrator: str = 'mispt'):
    """The reason the megakernel cannot render this scene, or None.

    The JAX gate (``hydracore3_tpu/models/megakernel.py`` :491-564).  What
    it refuses in a small scene the batched integrator renders
    (``render.use_megakernel``)."""
    if integrator not in INTEGRATOR_BY_NAME:
        return f'integrator {integrator!r} (naivept, shadowpt, mispt)'
    if meta.has_motion or meta.use_two_level:
        return ('a moving instance or a two-level scene (the JAX megakernel '
                'leaves them to the batched path)')
    if meta.spectral_mode:
        # the JAX gate's spectral scenes (:503-516)
        if meta.has_spd_tex or meta.has_cam_response_spectra:
            return 'a spectral texture or camera response in spectral mode'
        if meta.has_env_map:
            return 'an env map in spectral mode'
        if {MAT_TYPE_DIELECTRIC, MAT_TYPE_GLASS} & set(
                meta.mat_types_present):
            return ('a dielectric or glass in spectral mode (a '
                    'per-wavelength IOR)')
        if scene.spec_offset_sz.shape[0] > 29:
            return f'{scene.spec_offset_sz.shape[0]} spectra (29 at most)'
    if meta.has_bump:
        return 'a normal map (the JAX megakernel leaves it to the batched path)'
    if meta.has_ies or meta.has_spot or meta.has_proj:
        return ('an IES, spot or projective light (the JAX megakernel leaves '
                'it to the batched path)')
    if meta.cam_lens_radius > 0.0 or meta.lens_lines:
        return ('a thin-lens or lens-stack camera (the JAX megakernel leaves '
                'it to the batched path)')
    if meta.use_stream:
        return 'streamed scene (the megakernel takes small scenes)'
    if meta.num_tris < 1 or meta.num_tris > SMALL_SCENE_TRIS:
        return f'{meta.num_tris} triangles (the brute trace takes 1..4096)'
    if meta.trace_depth > 12:
        return f'trace depth {meta.trace_depth} > 12'
    if meta.num_materials > 128 or not 1 <= meta.num_lights <= 128:
        return 'more than 128 materials or lights, or no light'
    if meta.env_enable_sam:
        return ('an importance-sampled env map (the JAX megakernel leaves '
                'it to the batched path)')
    if meta.has_cam_back:
        return ('a camera-back texture (the JAX megakernel leaves it to the '
                'batched path)')
    if meta.has_four_textures:
        return ('GLTF slot-2/3 texture maps (the JAX megakernel leaves them '
                'to the batched path)')
    other = set(meta.mat_types_present) - SHADED_MATERIALS
    if other:
        return (f'material types {sorted(other)} (GLTF, diffuse, conductor, '
                'dielectric, glass and light-source only: plastic, thin film '
                'and blend take the batched path, as in the JAX package)')
    geom = scene.light_geom_type[:meta.num_lights].tolist()
    dist = scene.light_dist_type[:meta.num_lights].tolist()
    if not set(geom) <= {LIGHT_GEOM_RECT, LIGHT_GEOM_DISC, LIGHT_GEOM_SPHERE,
                         LIGHT_GEOM_POINT}:
        return (f'light geometry {sorted(set(geom))} (rect, disc, sphere, '
                'point only)')
    if not set(dist) <= {LIGHT_DIST_LAMBERT, LIGHT_DIST_OMNI}:
        return (f'light distribution {sorted(set(dist))} (Lambert and omni '
                'only: a spot takes the batched path)')
    if max(scene.light_ies_id[:meta.num_lights].tolist()) >= 0:
        return 'an IES light (it takes the batched path)'
    if ((not meta.tex0_all_const or meta.has_env_map)
            and scene.textures.offset.shape[0] > 128):
        return 'more than 128 texture slots'
    return None


def supported(scene, meta, integrator: str = 'mispt') -> bool:
    return why_unsupported(scene, meta, integrator) is None


def pack(scene, meta) -> MegaPack:
    """The JAX ``pack`` (:567-740) on the port's scene: the same tables,
    as torch tensors on the scene's device."""
    dev = scene.proj_inv.device
    v0 = scene.tri_v0.cpu().numpy()
    T = v0.shape[0]
    Tpad = max(8, -(-T // 8) * 8) if T <= 128 else -(-T // 128) * 128
    W = np.zeros((Tpad, 3, 4), np.float32)
    W[:T] = TST.woop_rows(v0, scene.tri_e1.cpu().numpy(),
                          scene.tri_e2.cpu().numpy())
    sh = np.zeros((Tpad, 32), np.float32)
    sh[:T] = scene.tri_shade.cpu().numpy()[:T]
    remap = scene.remap_inst.cpu().numpy()
    inst = np.clip(scene.tri_inst_id.cpu().numpy()[:T], 0, remap.shape[0] - 1)
    sh[:T, 25] = remap[inst, 1].astype(np.float32)

    M = min(meta.num_materials, 128)
    ml = np.zeros((128, MF_NROWS), np.float32)
    mt = scene.mat_mtype.cpu().numpy()[:M]
    ml[:M, MF_MTYPE] = np.where(mt == MAT_TYPE_LIGHT_SOURCE,
                                MTYPE_SMALL_LIGHT, mt)
    ml[:M, MF_CFLAGS] = scene.mat_cflags.cpu().numpy()[:M]
    colors = scene.mat_colors.cpu().numpy()[:M]
    ml[:M, MF_C0:MF_C0 + 4] = colors[:, 0]
    ml[:M, MF_C1:MF_C1 + 4] = colors[:, 1]
    ml[:M, MF_C2:MF_C2 + 4] = colors[:, 2]
    ml[:M, MF_DATA:MF_DATA + 8] = scene.mat_data.cpu().numpy()[:M, :8]
    ntex = scene.textures.offset.shape[0]
    t0 = scene.mat_texid.cpu().numpy()[:M, 0]
    ml[:M, MF_TEXID] = np.where((t0 < 0) | (t0 >= ntex)
                                | (t0 == INVALID_ID), 0, t0)
    ml[:M, MF_TEXC:MF_TEXC + 4] = (1.0 if scene.mat_tex0_const is None else
                                   scene.mat_tex0_const.cpu().numpy()[:M])
    ml[:M, MF_ROW0:MF_ROW0 + 4] = scene.mat_row0.cpu().numpy()[:M, 0]
    ml[:M, MF_ROW1:MF_ROW1 + 4] = scene.mat_row1.cpu().numpy()[:M, 0]

    nl = meta.num_lights
    ll = np.zeros((128, LF_NROWS), np.float32)
    cpu = lambda t: t.cpu().numpy()[:nl]  # noqa: E731
    ll[:nl, LF_POS:LF_POS + 3] = cpu(scene.light_pos)[:, :3]
    ll[:nl, LF_NORM:LF_NORM + 3] = cpu(scene.light_norm)[:, :3]
    ll[:nl, LF_INT:LF_INT + 4] = cpu(scene.light_intensity)
    ll[:nl, LF_MAT:LF_MAT + 9] = cpu(scene.light_matrix)[:, :3, :3].reshape(
        nl, 9)
    ll[:nl, LF_SIZE:LF_SIZE + 2] = cpu(scene.light_size)
    ll[:nl, LF_PDFA] = cpu(scene.light_pdf_a)
    ll[:nl, LF_MULT] = cpu(scene.light_mult)
    ll[:nl, LF_GEOM] = cpu(scene.light_geom_type)
    ll[:nl, LF_DIST] = cpu(scene.light_dist_type)

    tp = scene.textures
    tl = np.zeros((128, TF_NROWS), np.float32)
    nt = min(ntex, 128)
    for col, t in ((TF_OFF, tp.offset), (TF_W, tp.width), (TF_H, tp.height),
                   (TF_FILT, tp.filter), (TF_AU, tp.addr_u),
                   (TF_AV, tp.addr_v)):
        tl[:nt, col] = t.cpu().numpy()[:nt]

    consts = np.zeros(CN_NROWS, np.float32)
    consts[CN_PROJ_INV:CN_PROJ_INV + 16] = scene.proj_inv.cpu().numpy().ravel()
    consts[CN_WVI:CN_WVI + 16] = scene.world_view_inv.cpu().numpy().ravel()
    consts[CN_CAM_RESP:CN_CAM_RESP + 4] = scene.cam_response_rgb.cpu().numpy()
    consts[CN_ENV_COLOR:CN_ENV_COLOR + 4] = scene.env_color.cpu().numpy()
    consts[CN_NUM_LIGHTS] = meta.num_lights
    consts[CN_WIDTH] = meta.width
    consts[CN_HEIGHT] = meta.height
    consts[CN_EXPOSURE] = meta.exposure_mult
    if meta.has_env_map:
        for c, row in ((CN_ENV_SROW0, scene.env_sam_row0),
                       (CN_ENV_SROW1, scene.env_sam_row1)):
            consts[c:c + 4] = row.cpu().numpy()
        consts[CN_ENV_TEXID] = float(max(int(scene.env_tex_id), 0))

    spectral = bool(meta.spectral_mode)
    spd = spd_off = cie = None
    if spectral:
        spdid = scene.mat_spdid.cpu().numpy()[:M]
        ml[:M, MF_SPD0] = spdid[:, 0]
        ml[:M, MF_SPD1] = spdid[:, 1]
        ll[:nl, LF_SPD] = cpu(scene.light_spec_id)
        consts[CN_ENV_SPD] = float(int(scene.env_spec_id))
        consts[CN_NSPD] = scene.spec_offset_sz.shape[0]
        # the JAX pack's env_mult / CIE_Y_INTEGRAL, rounded once to f32
        consts[CN_ENV_SMULT] = np.float32(
            float(scene.env_spec_mult) / SPEC.CIE_Y_INTEGRAL)
        spd = scene.spec_values.to(torch.float32).contiguous()
        spd_off = scene.spec_offset_sz[:, 0].to(torch.int32).contiguous()
        cie = scene.cie_xyz.to(torch.float32).contiguous()

    def d(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    wide = wide_table(v0, scene.tri_e1.cpu().numpy(),
                      scene.tri_e2.cpu().numpy(), W.reshape(Tpad, 12))
    return MegaPack(woop=d(W.reshape(Tpad, 12)), shade=d(sh), mat=d(ml),
                    light=d(ll), tex=d(tl), consts=d(consts),
                    texels=tp.texels.to(torch.float32).contiguous(),
                    n_tris=Tpad, tex_const=bool(meta.tex0_all_const),
                    wide=wide.to(dev), env_mapped=bool(meta.has_env_map),
                    mtypes=tuple(meta.mat_types_present),
                    has_disc=LIGHT_GEOM_DISC in meta.light_geom_types,
                    spectral=spectral, spd=spd, spd_off=spd_off, cie=cie)


def pack_from_numpy(arrays: dict, device=None) -> MegaPack:
    """The JAX ``MegaPack``'s tables as numpy (``wx``, ``wy``, ``wz``,
    ``shade_t``, ``mat_lane``, ``light_lane``, ``tex_lane``, ``consts``),
    the JAX scene's f32 texel pool (``texels``) and the pack's ``n_tris``,
    ``tex_const`` and, where given, ``env_mapped``, ``mtypes`` and
    ``has_disc``, into the port's pack on ``device`` (the CUDA card unless
    the caller asks for the CPU).  A spectral pack also takes the scene's
    ``spec_values``, ``spec_offset_sz`` and ``cie_xyz`` (the JAX
    ``spd_lane`` holds the same values in chunk rows), and the consts must
    hold the sky's SPD id and multiplier at ``CN_ENV_SPD``,
    ``CN_ENV_SMULT`` (the JAX pack's ``spd_sets[4:6]``) and the count of
    spectra at ``CN_NSPD``.  With the JAX scene's soup (``tri_v0``,
    ``tri_e1``, ``tri_e2``, its real triangles) the pack also gets the wide
    table K1 walks, so it runs on the card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("pack_from_numpy: no CUDA device; pass "
                               "device='cpu' for the plain CPU path")
        device = 'cuda'

    def d(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def cols(a, n):        # the JAX rows as columns, padded to n
        a = np.asarray(a, np.float32).T
        return np.pad(a, ((0, 0), (0, n - a.shape[1])))

    woop = np.concatenate([arrays['wx'], arrays['wy'], arrays['wz']], axis=1)
    spectral = {}
    if 'spec_values' in arrays:
        spectral = dict(
            spectral=True, spd=d(arrays['spec_values']),
            spd_off=torch.as_tensor(np.asarray(arrays['spec_offset_sz'])[
                :, 0].astype(np.int32), device=device),
            cie=d(arrays['cie_xyz']))
    wide = None
    if 'tri_v0' in arrays:
        wide = wide_table(arrays['tri_v0'], arrays['tri_e1'],
                          arrays['tri_e2'], woop).to(device)
    return MegaPack(woop=d(woop), shade=d(np.asarray(arrays['shade_t']).T),
                    mat=d(cols(arrays['mat_lane'], MF_NROWS)),
                    light=d(cols(arrays['light_lane'], LF_NROWS)),
                    tex=d(np.asarray(arrays['tex_lane']).T),
                    consts=d(arrays['consts']), texels=d(arrays['texels']),
                    n_tris=int(arrays['n_tris']),
                    tex_const=bool(arrays['tex_const']), wide=wide,
                    env_mapped=bool(arrays.get('env_mapped', False)),
                    mtypes=tuple(arrays.get('mtypes', MegaPack.mtypes)),
                    has_disc=bool(arrays.get('has_disc', True)),
                    **spectral)


# ===========================================================================
# stage functions
# ===========================================================================

def fetch_mat(pk, mid):
    r = pk.mat[torch.clamp(mid, 0, 127)].T          # [MF_NROWS, N]
    return dict(mtype=r[MF_MTYPE], cflags=r[MF_CFLAGS], spd0=r[MF_SPD0],
                spd1=r[MF_SPD1],
                c0=r[MF_C0:MF_C0 + 4], c1=r[MF_C1:MF_C1 + 4],
                c2=r[MF_C2:MF_C2 + 4], data=r[MF_DATA:MF_DATA + 8],
                texid=r[MF_TEXID], texc=r[MF_TEXC:MF_TEXC + 4],
                row0=r[MF_ROW0:MF_ROW0 + 4], row1=r[MF_ROW1:MF_ROW1 + 4])


def fetch_light(pk, lid):
    r = pk.light[torch.clamp(lid, 0, 127)].T        # [LF_NROWS, N]
    return dict(pos=r[LF_POS:LF_POS + 3], norm=r[LF_NORM:LF_NORM + 3],
                intensity=r[LF_INT:LF_INT + 4], mat=r[LF_MAT:LF_MAT + 9],
                size=r[LF_SIZE:LF_SIZE + 2], pdf_a=r[LF_PDFA],
                mult=r[LF_MULT], geom=r[LF_GEOM].to(torch.int64),
                dist=r[LF_DIST].to(torch.int64), spd=r[LF_SPD])


def _is_dead(flags):
    return (flags & C.RAY_FLAG_IS_DEAD) != 0


def _has_non_spec(flags):
    return (flags & C.RAY_FLAG_HAS_NON_SPEC) != 0


def stage_init(consts, xs, ys, rngx, rngy, mask=None, spectral=False):
    """kernel_InitEyeRay2 (integrator_pt.cpp:129-157), pinhole.  Only lanes
    in ``mask`` (all when None) advance their RNG.  ``spectral``: the hero
    wavelengths are drawn after the pixel offsets (``lam`` [4, N])."""
    rngx, rngy, r4 = RNG.rnd_float4_xy(rngx, rngy, mask)
    lam = None
    if spectral:
        rngx, rngy, uw = RNG.rnd_float1_xy(rngx, rngy, mask)
        lam = SPEC.sample_wavelengths(uw).T
    xn = (xs + r4[0]) / consts[CN_WIDTH]
    yn = (ys + r4[1]) / consts[CN_HEIGHT]
    p = consts[CN_PROJ_INV:CN_PROJ_INV + 16]
    nx = 2.0 * xn - 1.0
    ny = 2.0 * yn - 1.0
    px = p[0] * nx + p[1] * ny + p[3]
    py = p[4] * nx + p[5] * ny + p[7]
    pz = p[8] * nx + p[9] * ny + p[11]
    pw = p[12] * nx + p[13] * ny + p[15]
    inv_w = 1.0 / torch.where(pw == 0.0, 1.0, pw)
    d = normalize3(torch.stack([px * inv_w, py * inv_w, pz * inv_w]))
    m = consts[CN_WVI:CN_WVI + 16]

    def mul4x3(v):
        return torch.stack([m[4 * r] * v[0] + m[4 * r + 1] * v[1]
                            + m[4 * r + 2] * v[2] + m[4 * r + 3]
                            for r in range(3)])

    o = mul4x3(torch.zeros_like(d))
    d = normalize3(mul4x3(100.0 * d) - o)
    z = torch.zeros_like(xs)
    st = dict(o=o, d=d, flags=torch.zeros_like(rngx),
              accum=xs.new_zeros((4,) + xs.shape),
              thr=xs.new_ones((4,) + xs.shape),
              mis_pdf=z + 1.0, mis_ior=z + 1.0,
              hit_pos=torch.zeros_like(d), hit_norm=torch.zeros_like(d),
              hit_uv=torch.zeros_like(d[:2]), hit_dist=z.clone(),
              hit_lgt=z - 1.0, rngx=rngx, rngy=rngy)
    if spectral:
        st['lam'] = lam
    return st


def _trace_blocks(pk, o, d, tmin, tmax, any_hit=False):
    """Brute Woop intersection of every lane with every triangle, in blocks
    of 128 (the JAX module's blocking and tie rule: the lowest index among
    equal t).  Nearest hit: (t, tri, u, v) with tri -1 and t = FLT_MAX on a
    miss; any-hit: the occlusion flags."""
    N = o.shape[1]
    TB = min(pk.n_tris, 128)
    one = torch.ones_like(tmin)
    if any_hit:
        occ = torch.zeros(N, dtype=torch.bool, device=o.device)
    else:
        best_t = torch.full_like(tmin, FLT_MAX)
        best_i = torch.full((N,), -1, dtype=torch.int64, device=o.device)
        best_u = torch.zeros_like(tmin)
        best_v = torch.zeros_like(tmin)
    for lo in range(0, pk.n_tris, TB):
        w = pk.woop[lo:lo + TB].T[:, :, None]          # [12, TB, 1]

        def tf(r, v, w3):
            c = w[4 * r:4 * r + 4]
            return c[0] * v[0] + c[1] * v[1] + c[2] * v[2] + c[3] * w3

        po_x, pd_x = tf(0, o, one), tf(0, d, 0.0 * one)
        po_y, pd_y = tf(1, o, one), tf(1, d, 0.0 * one)
        po_z, pd_z = tf(2, o, one), tf(2, d, 0.0 * one)
        t = -po_z / pd_z
        u = po_x + t * pd_x
        v = po_y + t * pd_y
        valid = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
                 & (t < tmax))
        if any_hit:
            occ = occ | valid.any(0)
            continue
        tm = torch.where(valid, t, FLT_MAX)
        bt = tm.amin(0)
        ii = torch.arange(tm.shape[0], device=o.device)[:, None]
        li = torch.where(tm == bt, ii, _BIG_I).amin(0)
        li = torch.clamp(li, max=tm.shape[0] - 1)
        closer = bt < best_t
        best_u = torch.where(closer, u.gather(0, li[None])[0], best_u)
        best_v = torch.where(closer, v.gather(0, li[None])[0], best_v)
        best_i = torch.where(closer, lo + li, best_i)
        best_t = torch.minimum(best_t, bt)
    if any_hit:
        return occ
    return best_t, best_i, best_u, best_v


def stage_trace(pk, st, prim):
    """kernel_RayTrace2 (integrator_pt.cpp:214-348): nearest hit, the shade
    row lerp, normal flip and flag packing.  ``prim``: lanes tracing their
    camera ray (a bool, or a bool plane in regen mode), which mark a miss
    PRIME_RAY_MISS."""
    live = ~_is_dead(st['flags'])
    tmin = torch.zeros_like(st['mis_pdf'])
    tmax = torch.where(live, FLT_MAX, 0.0)
    t, tri, u, v = _trace_blocks(pk, st['o'], st['d'], tmin, tmax)
    found = t < FLT_MAX * 0.5
    hit_pos = st['o'] + (t * (1.0 - 1e-6)) * st['d']
    shr = (pk.shade[torch.clamp(tri, min=0)]
           * (tri >= 0)[:, None].to(torch.float32)).T      # [32, N]
    wa = 1.0 - u - v
    data = [wa * shr[j] + u * shr[8 + j] + v * shr[16 + j] for j in range(8)]
    hit_norm = normalize3(torch.stack(data[0:3]))
    hit_uv = torch.stack([data[3], data[7]])
    mid = torch.floor(shr[24] + 0.5).to(torch.int64)
    lgt = torch.floor(shr[25] + 0.5)
    flip = torch.where(dot3(st['d'], hit_norm) > 0.001, -1.0, 1.0)
    hit_norm = flip * hit_norm
    inv = C.RAY_FLAG_HAS_INV_NORMAL
    flags = torch.where(flip < 0.0, st['flags'] | inv, st['flags'] & ~inv)
    flags_hit = (flags & 0xFF000000) | (mid & 0x00FFFFFF)
    miss_add = C.RAY_FLAG_IS_DEAD | C.RAY_FLAG_OUT_OF_SCENE
    prime = torch.where(torch.as_tensor(prim, device=flags.device),
                        C.RAY_FLAG_PRIME_RAY_MISS, 0)
    flags_miss = st['flags'] | miss_add | prime
    keep = ~live | ~found
    st = dict(st)
    st['flags'] = torch.where(live, torch.where(found, flags_hit, flags_miss),
                              st['flags'])
    st['hit_pos'] = torch.where(keep, st['hit_pos'], hit_pos)
    st['hit_norm'] = torch.where(keep, st['hit_norm'], hit_norm)
    st['hit_uv'] = torch.where(keep, st['hit_uv'], hit_uv)
    st['hit_dist'] = torch.where(keep, st['hit_dist'], t)
    st['hit_lgt'] = torch.where(keep, st['hit_lgt'], lgt)
    return st


def tex_tap(pk, md, st):
    """The slot-0 texture color at the lane's hit ([4, N]): the uv
    transform of the JAX module's ``stage_tap_prep`` (:998)."""
    if pk.tex_const:
        return md['texc']
    texid = md['texid'].to(torch.int64).clamp(0, 127)
    uvx, uvy = st['hit_uv'][0], st['hit_uv'][1]
    r0, r1 = md['row0'], md['row1']
    tcx = r0[0] * uvx + r0[1] * uvy + r0[3]
    tcy = r1[0] * uvx + r1[1] * uvy + r1[3]
    return _tap(pk, texid, tcx, tcy)


def env_tap(pk, d):
    """The env lat-long map at the miss direction ([4, N]): the JAX
    module's ``stage_env_tap_prep`` (:1009, sphereMapTo2DTexCoord and the
    env sampler matrix)."""
    c = pk.consts
    theta = acos_poly(torch.clamp(-d[1], -1.0, 1.0))
    phi = torch.atan2(d[0], d[2])     # on the card: atan2f, as K1's
    phi = torch.where(phi < 0.0, phi + M_TWOPI, phi)
    u = torch.clamp(phi * 0.5 * INV_PI, 0.0, 1.0)
    v = torch.clamp(theta * INV_PI, 0.0, 1.0)
    tcx = c[CN_ENV_SROW0] * u + c[CN_ENV_SROW0 + 1] * v + c[CN_ENV_SROW0 + 3]
    tcy = c[CN_ENV_SROW1] * u + c[CN_ENV_SROW1 + 1] * v + c[CN_ENV_SROW1 + 3]
    texid = c[CN_ENV_TEXID].to(torch.int64).clamp(0, 127).expand_as(u)
    return _tap(pk, texid, tcx, tcy)


def _tap(pk, texid, tcx, tcy):
    """A bilinear (or nearest) tap of slot ``texid`` at (tcx, tcy): the quad
    footprint of the JAX module's ``_uv_to_quad`` / ``tex_from_rows``
    (:1040-1088), with the four corner texels read from the f32 pool
    instead of a quad-packed row."""
    g = pk.tex[texid].T
    off, wf, hf, filt, au, av = (g[i] for i in range(TF_NROWS))

    def norm_coord(uc, mode):
        wrapped = uc - torch.floor(uc)
        clamped = torch.clamp(uc, 0.0, 1.0)
        half = 0.5 * uc
        m2 = 2.0 * (half - torch.floor(half))
        mirrored = torch.where(m2 < 1.0, m2, 2.0 - m2)
        return torch.where(mode == TEX.ADDR_WRAP, wrapped,
                           torch.where(mode == TEX.ADDR_MIRROR, mirrored,
                                       clamped))

    ffx = norm_coord(tcx, au) * wf - 0.5
    ffy = norm_coord(tcy, av) * hf - 0.5
    wrap_u = au == TEX.ADDR_WRAP
    wrap_v = av == TEX.ADDR_WRAP
    ffx = torch.where(wrap_u, ffx, torch.minimum(torch.clamp(ffx, min=0.0),
                                                 wf - 1.0))
    ffy = torch.where(wrap_v, ffy, torch.minimum(torch.clamp(ffy, min=0.0),
                                                 hf - 1.0))
    px = torch.floor(ffx)
    py = torch.floor(ffy)
    fx = ffx - px
    fy = ffy - py
    wx = torch.where(px < 0.0, wf - 1.0, px)
    wy = torch.where(py < 0.0, hf - 1.0, py)
    w4 = [(1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy, fx * fy]
    right = (fx >= 0.5).to(torch.float32)
    down = (fy >= 0.5).to(torch.float32)
    n4 = [(1.0 - right) * (1.0 - down), right * (1.0 - down),
          (1.0 - right) * down, right * down]
    lin = filt == TEX.FILTER_LINEAR
    w4 = [torch.where(lin, a, b) for a, b in zip(w4, n4)]
    # the quad's corners (c00, c10, c01, c11): +1 neighbours wrap or clamp
    # per axis, as the JAX pool's pre-wrapped footprints
    P = pk.texels.shape[0]
    x, y = wx.to(torch.int64), wy.to(torch.int64)
    w, h, o = wf.to(torch.int64), hf.to(torch.int64), off.to(torch.int64)
    x1 = torch.where(wrap_u, torch.where(x + 1 >= w, 0, x + 1),
                     torch.minimum(x + 1, w - 1))
    y1 = torch.where(wrap_v, torch.where(y + 1 >= h, 0, y + 1),
                     torch.minimum(y + 1, h - 1))
    corners = [pk.texels[torch.clamp(o + yy * w + xx, 0, P - 1)].T
               for yy, xx in ((y, x), (y, x1), (y1, x), (y1, x1))]
    return (corners[0] * w4[0] + corners[1] * w4[1] + corners[2] * w4[2]
            + corners[3] * w4[3])


def _gltf_params(md, base4):
    metal_col = md['c2'] * base4
    roughness = torch.clamp(1.0 - md['data'][GLTF_FLOAT_GLOSINESS], 0.0, 1.0)
    metalness = torch.where(md['cflags'] == float(GLTF_COMPONENT_METAL), 1.0,
                            md['data'][GLTF_FLOAT_ALPHA])
    return (metal_col, md['c1'], roughness, metalness,
            md['data'][GLTF_FLOAT_REFL_COAT], md['data'][GLTF_FLOAT_IOR])


def _orennayar_scale(md, l, v, n):
    """The diffuse material's scalar: 1/pi, times the Oren-Nayar factor
    where the material has one."""
    on = (md['cflags'].to(torch.int64) & GLTF_COMPONENT_ORENNAYAR) != 0
    return torch.where(on, INV_PI * orennayar_func(l, v, n, md['data'][0]),
                       INV_PI)


def conductor_sample(md, tex_color, r0, r1, v, n, eta=None, kk=None):
    """conductorSmooth/RoughSampleAndEval (cmat_conductor.h:7-103), the
    JAX module's ``conductor_sample`` (:1546); ``eta``, ``kk`` [4, N] per
    wavelength in spectral mode, else the material's."""
    refl = md['c0']
    if eta is None:
        eta, kk = md['data'][2], md['data'][3]
    a0 = torch.minimum(md['data'][0], tex_color[0])
    a1 = torch.minimum(md['data'][1], tex_color[1])
    smooth = torch.maximum(md['data'][1], md['data'][0]) < 1e-3
    perf = reflect3(-v, n)
    cos_out = dot3(perf, n)
    fr_s = fr_complex_cond(torch.clamp(cos_out, -1.0, 1.0), eta, kk)
    sm_val = torch.where(cos_out <= 1e-6, 0.0,
                         fr_s / torch.clamp(cos_out, min=1e-6))
    nx, ny = coordinate_system_v2(n)
    wo = torch.stack([dot3(v, nx), dot3(v, ny), dot3(v, n)])
    wm = tr_sample_p(wo, r0, r1, a0, a1)
    wi = reflect3(-wo, wm)
    same = wo[2] * wi[2] >= 0.0
    cos_o, cos_i = wo[2].abs(), wi[2].abs()
    fr_m = fr_complex_cond(torch.clamp(dot3(wo, wm).abs(), -1.0, 1.0), eta,
                           kk)
    d = tr_d_p(wm, a0, a1)
    g = tr_g_p(wo, wi, a0, a1)
    rough_val = fr_m * d * g / torch.clamp(4.0 * cos_i * cos_o, min=1e-20)
    bad = ~same | (cos_i == 0.0) | (cos_o == 0.0) | (wo[2] == 0.0)
    rough_val = torch.where(bad, 0.0, rough_val)
    rough_dir = normalize3(nx * wi[0] + ny * wi[1] + n * wi[2])
    rough_pdf = tr_pdf_p(wo, wm, a0, a1) / torch.clamp(
        4.0 * dot3(wo, wm).abs(), min=1e-20)
    rough_pdf = torch.where(bad, 1.0, rough_pdf)
    up = torch.zeros_like(rough_dir)
    up[1] = 1.0
    rough_dir = torch.where(bad, up, rough_dir)
    return dict(val=torch.where(smooth, sm_val * refl, rough_val * refl),
                dir=torch.where(smooth, perf, rough_dir),
                pdf=torch.where(smooth, 1.0, rough_pdf),
                flags=torch.where(smooth, C.RAY_EVENT_S,
                                  C.RAY_FLAG_HAS_NON_SPEC))


def conductor_eval(md, tex_color, l, v, n, eta=None, kk=None):
    """conductorRoughEval (cmat_conductor.h:105-137), the JAX module's
    ``conductor_eval`` (:1596); a smooth conductor gives 0.  ``eta``,
    ``kk`` as for ``conductor_sample``."""
    if eta is None:
        eta, kk = md['data'][2], md['data'][3]
    a0 = torch.minimum(md['data'][0], tex_color[0])
    a1 = torch.minimum(md['data'][1], tex_color[1])
    smooth = torch.maximum(md['data'][1], md['data'][0]) < 1e-3
    nx, ny = coordinate_system_v2(n)
    wo = torch.stack([dot3(v, nx), dot3(v, ny), dot3(v, n)])
    wi = torch.stack([dot3(l, nx), dot3(l, ny), dot3(l, n)])
    same = wo[2] * wi[2] >= 0.0
    wm0 = wo + wi
    wm_ok = dot3(wm0, wm0) > 0.0
    wm = normalize3(wm0)
    cos_o, cos_i = wo[2].abs(), wi[2].abs()
    fr_m = fr_complex_cond(torch.clamp(dot3(wo, wm).abs(), -1.0, 1.0), eta,
                           kk)
    d = tr_d_p(wm, a0, a1)
    g = tr_g_p(wo, wi, a0, a1)
    val = fr_m * d * g / torch.clamp(4.0 * cos_i * cos_o, min=1e-20)
    wm_ff = torch.where(wm[2] < 0.0, -wm, wm)
    pdf = tr_pdf_p(wo, wm_ff, a0, a1) / torch.clamp(
        4.0 * dot3(wo, wm_ff).abs(), min=1e-20)
    bad = smooth | ~same | ~wm_ok | (cos_i == 0.0) | (cos_o == 0.0)
    return torch.where(bad, 0.0, val) * md['c0'], torch.where(bad, 0.0, pdf)


def dielectric_sample(md, rands, v, n, ray_flags, mis_ior):
    """dielectricSmoothSampleAndEval (cmat_dielectric.h:8-57), the JAX
    module's ``dielectric_sample`` (:1201)."""
    ext_ior = md['data'][DIELECTRIC_ETA_EXT]
    eta_int = md['data'][DIELECTRIC_ETA_INT]
    inv_norm = (ray_flags & C.RAY_FLAG_HAS_INV_NORMAL) != 0
    n_fixed = torch.where(inv_norm, -n, n)
    s, t = coordinate_system_v2(n_fixed)
    wi = torch.stack([dot3(v, s), dot3(v, t), dot3(v, n_fixed)])
    eta = eta_int / ext_ior
    # FrDielectricDetailedV2 (cmaterial.h:646-683)
    ci = torch.clamp(wi[2], -1.0, 1.0)
    outside = ci >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = torch.where(outside, 1.0 / eta, eta)
    cos_t_sqr = 1.0 - (1.0 - ci * ci) * eta_ti * eta_ti
    ci_abs = ci.abs()
    ct_abs = safe_sqrt(cos_t_sqr)
    a_s = ((-eta_it * ct_abs + ci_abs)
           / torch.clamp(eta_it * ct_abs + ci_abs, min=1e-12))
    a_p = ((-eta_it * ci_abs + ct_abs)
           / torch.clamp(eta_it * ci_abs + ct_abs, min=1e-12))
    r = 0.5 * (a_s * a_s + a_p * a_p)
    special = (eta == 1.0) | (ci_abs == 0.0)
    r = torch.where(special, torch.where(eta == 1.0, 0.0, 1.0), r)
    cos_theta_t = torch.where(ci >= 0.0, -ct_abs, ct_abs)
    t_coef = 1.0 - r
    pick = rands[0] < r
    wo = torch.where(pick, torch.stack([-wi[0], -wi[1], wi[2]]),
                     torch.stack([-eta_ti * wi[0], -eta_ti * wi[1],
                                  cos_theta_t]))
    out_dir = normalize3(wo[0:1] * s + wo[1:2] * t + wo[2:3] * n_fixed)
    val = torch.where(pick, r, (eta_ti * eta_ti) * t_coef)
    return dict(
        val=(val / torch.clamp(dot3(out_dir, n_fixed).abs(), min=1e-6)
             ).expand(4, -1),
        dir=out_dir, pdf=torch.where(pick, r, t_coef),
        flags=torch.where(pick, C.RAY_EVENT_S, C.RAY_EVENT_S | C.RAY_EVENT_T),
        ior=torch.where(pick, mis_ior, torch.where(mis_ior == eta_int,
                                                   ext_ior, eta_int)))


def glass_sample(md, rands, v, n, ray_flags, mis_ior):
    """glassSampleAndEval (cmat_glass.h:234-275), the JAX module's
    ``glass_sample`` (:1251); rands[3] picks reflection or refraction."""
    ior = md['data'][GLASS_FLOAT_IOR]
    ray_dir = -v
    inv_norm = (ray_flags & C.RAY_FLAG_HAS_INV_NORMAL) != 0
    exiting = inv_norm & (mis_ior == ior)
    rel = torch.where(exiting, 1.0 / ior, ior / mis_ior)
    # fresnel2
    cosi = dot3(v, n)
    sint = safe_sqrt(1.0 - cosi * cosi) / rel
    cost = safe_sqrt(1.0 - sint * sint)
    rp = (rel * cosi - cost) / torch.clamp(rel * cosi + cost, min=1e-12)
    rs = (cosi - rel * cost) / torch.clamp(cosi + rel * cost, min=1e-12)
    fres = torch.where(sint > 1.0, 1.0, 0.5 * (rp * rp + rs * rs))
    pick = rands[3] < fres
    dir_refl = normalize3(ray_dir - (2.0 * dot3(ray_dir, n)) * n)
    # refract2: total internal reflection reflects
    cosi_d = dot3(ray_dir, n)
    eta2 = 1.0 / rel
    k = 1.0 - eta2 * eta2 * (1.0 - cosi_d * cosi_d)
    refr = normalize3(eta2 * ray_dir - (eta2 * cosi_d + safe_sqrt(k)) * n)
    out_dir = torch.where(pick, dir_refl, torch.where(k < 0.0, dir_refl,
                                                      refr))
    val = torch.where(pick, md['c0'], md['c1'])
    return dict(val=val / torch.clamp(dot3(out_dir, n).abs(), min=1e-6),
                dir=out_dir, pdf=torch.ones_like(fres),
                flags=torch.where(pick, C.RAY_EVENT_S,
                                  C.RAY_EVENT_S | C.RAY_EVENT_T),
                ior=torch.where(pick, mis_ior, ior))


def _spectral_params(pk, md, lam):
    """In spectral mode (``lam`` [4, N]) the diffuse base (its SPD, else its
    color without the texture) and the conductor's eta and k per
    wavelength; (None, None, None) in RGB mode."""
    if lam is None:
        return None, None, None
    types = pk.mtypes
    base = (spd_or_color(pk, md['spd0'], lam, md['c0'])
            if MAT_TYPE_DIFFUSE in types else None)
    if MAT_TYPE_CONDUCTOR not in types:
        return base, None, None
    ones = torch.ones_like(lam)
    return (base,
            spd_or_color(pk, md['spd0'], lam, md['data'][2] * ones),
            spd_or_color(pk, md['spd1'], lam, md['data'][3] * ones))


def mat_eval(md, tex_color, l, v, n, mtypes, spectral=(None, None, None)):
    """MaterialEval (integrator_pt_mat.cpp:308-528) for the types in
    ``mtypes``: GLTF (cmat_gltf.h:94-147), diffuse (cmat_diffuse.h:27-39),
    conductor; the delta materials and light sources give 0.  ``spectral``:
    ``_spectral_params``.  Returns (val [4, N], pdf [N])."""
    base4 = md['c0'] * tex_color
    mtype = md['mtype']
    lam_val = INV_PI
    lam_pdf = dot3(l, n).abs() * INV_PI
    val = torch.zeros_like(base4)
    pdf = torch.zeros_like(lam_pdf)
    if MAT_TYPE_GLTF in mtypes:
        metal_col, coat_col, roughness, metalness, coat, ior = _gltf_params(
            md, base4)
        rough = roughness != 0.0
        ggx_val = torch.where(rough, ggx_eval_bsdf(l, v, n, roughness), 0.0)
        ggx_pdf = torch.where(rough, ggx_eval_pdf(l, v, n, roughness), 0.0)
        v_dot_h = torch.where(rough, dot3(v, normalize3(v + l)), dot3(v, n))
        plastic = (coat > 0.0) & (metalness < 1.0) & (ior > 0.0)
        one = torch.ones_like(coat)
        f_i_c = fr_dielectric_pbrt(dot3(v, n).abs(), one, ior)
        f_o = fr_dielectric_pbrt(dot3(l, n).abs(), one, ior)
        fdr = md['data'][GLTF_FLOAT_MI_FDR_INT]
        x = (1.0 - f_i_c) * (1.0 - f_o) / torch.clamp(ior * ior * (1.0 - fdr),
                                                      min=1e-12)
        coeff = one + (x - one) * coat
        lam_val_g = torch.where(plastic, lam_val * coeff, lam_val)
        f_i = torch.where(plastic, f_i_c, one)
        spec_col = ggx_val * hydra_fresnel_cond(metal_col, v_dot_h, ior)
        prob_spec = 0.5 * coat
        prob_diff = 1.0 - prob_spec
        diel_val = lam_val_g * base4 + (ggx_val * f_i * coat) * coat_col
        diel_pdf = lam_pdf * prob_diff + ggx_pdf * prob_spec
        g_val = metalness * spec_col + (1.0 - metalness) * diel_val
        g_pdf = metalness * ggx_pdf + (1.0 - metalness) * diel_pdf
        is_gltf = mtype == float(MAT_TYPE_GLTF)
        val = torch.where(is_gltf, g_val, val)
        pdf = torch.where(is_gltf, g_pdf, pdf)
    diff_base, eta, kk = spectral
    if MAT_TYPE_DIFFUSE in mtypes:
        is_diff = mtype == float(MAT_TYPE_DIFFUSE)
        val = torch.where(is_diff, _orennayar_scale(md, l, v, n)
                          * (base4 if diff_base is None else diff_base), val)
        pdf = torch.where(is_diff, lam_pdf, pdf)
    if MAT_TYPE_CONDUCTOR in mtypes:
        c_val, c_pdf = conductor_eval(md, tex_color, l, v, n, eta, kk)
        is_cond = mtype == float(MAT_TYPE_CONDUCTOR)
        val = torch.where(is_cond, c_val, val)
        pdf = torch.where(is_cond, c_pdf, pdf)
    return val, pdf


def mat_sample(md, tex_color, rands, v, n, ray_flags, mis_ior, mtypes,
               spectral=(None, None, None)):
    """MaterialSampleAndEval (integrator_pt_mat.cpp:109-306) for the types
    in ``mtypes``: GLTF (cmat_gltf.h:6-91), diffuse (cmat_diffuse.h:8-24;
    the Oren-Nayar factor takes -v, as the reference does), conductor,
    dielectric, glass.  rands [4, N]; ``spectral``: ``_spectral_params``.
    Returns dict(val [4], dir [3], pdf, flags, ior)."""
    base4 = md['c0'] * tex_color
    mtype = md['mtype']
    lam_dir = map_sample_to_cosine_distribution(rands[0], rands[1], n, n)
    lam_pdf = dot3(lam_dir, n).abs() * INV_PI
    lam_val = INV_PI
    up = torch.zeros_like(lam_dir)
    up[1] = 1.0
    out = dict(val=torch.zeros_like(base4), dir=up,
               pdf=torch.ones_like(lam_pdf),
               flags=torch.zeros_like(ray_flags), ior=mis_ior)

    def merge(sel, res):
        for k_, v_ in res.items():
            out[k_] = torch.where(sel, v_, out[k_])

    if MAT_TYPE_GLTF in mtypes:
        metal_col, coat_col, roughness, metalness, coat, ior = _gltf_params(
            md, base4)
        smooth = roughness == 0.0
        perf_refl = -v - 2.0 * dot3(-v, n) * n
        cos_out = dot3(perf_refl, n)
        mirror_val = torch.where(cos_out <= 1e-6, 0.0,
                                 1.0 / torch.clamp(cos_out, min=1e-6))
        ggx_dir_r = ggx_sample(rands[0], rands[1], v, n, roughness)
        ggx_dir = torch.where(smooth, perf_refl, ggx_dir_r)
        ggx_pdf = torch.where(smooth, 1.0, ggx_eval_pdf(ggx_dir_r, v, n,
                                                        roughness))
        ggx_val = torch.where(smooth, mirror_val,
                              ggx_eval_bsdf(ggx_dir_r, v, n, roughness))
        pick_metal = rands[2] < metalness
        v_dot_h = dot3(v, normalize3(v + ggx_dir))
        metal_bsdf = ggx_val * metalness * hydra_fresnel_cond(metal_col,
                                                              v_dot_h, ior)
        spec_flags = torch.where(smooth, C.RAY_EVENT_S,
                                 C.RAY_FLAG_HAS_NON_SPEC)
        one = torch.ones_like(coat)
        f_i = fr_dielectric_pbrt(dot3(v, n).abs(), one, ior)
        prob_spec = 0.5 * coat
        prob_diff = 1.0 - prob_spec
        pick_spec = rands[3] < prob_spec
        coat_bsdf = (ggx_val * (1.0 - metalness) * f_i * coat) * coat_col
        lam_bsdf = (lam_val * (1.0 - metalness)) * base4
        fdr = md['data'][GLTF_FLOAT_MI_FDR_INT]
        f_o = fr_dielectric_pbrt(dot3(lam_dir, n).abs(), one, ior)
        x = (1.0 - f_i) * (1.0 - f_o) / torch.clamp(ior * ior * (1.0 - fdr),
                                                    min=1e-12)
        coeff = one + (x - one) * coat
        apply_coat = (coat > 0.0) & (ior > 0.0)
        lam_bsdf = torch.where(apply_coat, lam_bsdf * coeff, lam_bsdf)
        spec = pick_metal | pick_spec
        pdf_sel = torch.where(pick_metal, metalness, (1.0 - metalness)
                              * torch.where(pick_spec, prob_spec, prob_diff))
        merge(mtype == float(MAT_TYPE_GLTF), dict(
            dir=torch.where(spec, ggx_dir, lam_dir),
            val=torch.where(pick_metal, metal_bsdf,
                            torch.where(pick_spec, coat_bsdf, lam_bsdf)),
            pdf=torch.where(pick_metal, ggx_pdf, torch.where(
                pick_spec, ggx_pdf, lam_pdf)) * pdf_sel,
            flags=torch.where(spec, spec_flags, C.RAY_FLAG_HAS_NON_SPEC)))
    diff_base, eta, kk = spectral
    if MAT_TYPE_DIFFUSE in mtypes:
        merge(mtype == float(MAT_TYPE_DIFFUSE), dict(
            dir=lam_dir, val=_orennayar_scale(md, lam_dir, -v, n)
            * (base4 if diff_base is None else diff_base),
            pdf=lam_pdf, flags=torch.full_like(ray_flags,
                                               C.RAY_FLAG_HAS_NON_SPEC)))
    if MAT_TYPE_CONDUCTOR in mtypes:
        merge(mtype == float(MAT_TYPE_CONDUCTOR),
              conductor_sample(md, tex_color, rands[0], rands[1], v, n,
                               eta, kk))
    if MAT_TYPE_DIELECTRIC in mtypes:
        merge(mtype == float(MAT_TYPE_DIELECTRIC),
              dielectric_sample(md, rands, v, n, ray_flags, mis_ior))
    if MAT_TYPE_GLASS in mtypes:
        merge(mtype == float(MAT_TYPE_GLASS),
              glass_sample(md, rands, v, n, ray_flags, mis_ior))
    return out


def light_sample_rev(ld, r0, r1):
    """LightSampleRev for rect / disc / sphere / point (clight.h:67-126).
    Returns (pos [3], norm [3], is_omni)."""
    gt = ld['geom']
    dx, dz = map_samples_to_disc(r0 * 2.0 - 1.0, r1 * 2.0 - 1.0)
    is_disc = gt == LIGHT_GEOM_DISC
    off_x = torch.where(is_disc, dx * ld['size'][0],
                        2.0 * (r0 - 0.5) * ld['size'][0])
    off_z = torch.where(is_disc, dz * ld['size'][0],
                        2.0 * (r1 - 0.5) * ld['size'][1])
    m = ld['mat']
    zero = torch.zeros_like(off_x)
    rot = torch.stack([m[3 * r] * off_x + m[3 * r + 1] * zero
                       + m[3 * r + 2] * off_z for r in range(3)])
    area_pos = rot + ld['pos'] + epsilon_of_pos(ld['pos']) * ld['norm']
    theta = M_TWOPI * r0
    phi = acos_poly(torch.clamp(1.0 - 2.0 * r1, -1.0, 1.0))
    sph_dir = torch.stack([torch.sin(phi) * torch.cos(theta),
                           torch.sin(phi) * torch.sin(theta), torch.cos(phi)])
    sph_pos = ld['pos'] + (ld['size'][0] * 1.000001) * sph_dir
    sph_norm = normalize3(sph_pos - ld['pos'])
    is_sph = gt == LIGHT_GEOM_SPHERE
    is_pt = gt == LIGHT_GEOM_POINT
    pos = torch.where(is_sph, sph_pos, torch.where(is_pt, ld['pos'],
                                                   area_pos))
    norm = torch.where(is_sph, sph_norm, ld['norm'])
    return pos, norm, is_pt & (ld['dist'] == LIGHT_DIST_OMNI)


def light_eval_pdf(ld, illum_point, ray_dir, lpos, lnorm):
    """LightEvalPDF (integrator_pt_lgt.cpp:71-107) for rect / disc / sphere
    / point."""
    gt = ld['geom']
    diff = illum_point - lpos
    hit_dist = torch.sqrt(dot3(diff, diff))
    cos_tmp = dot3(ray_dir, -lnorm)
    cos_sphere = dot3(normalize3(lpos - illum_point), lnorm).abs()
    cos_point = torch.where(ld['dist'] == LIGHT_DIST_LAMBERT,
                            torch.clamp(cos_tmp, min=0.0), 1.0)
    cos_area = torch.clamp(cos_tmp, min=0.0)
    cos_val = torch.where(gt == LIGHT_GEOM_SPHERE, cos_sphere,
                          torch.where(gt == LIGHT_GEOM_POINT, cos_point,
                                      cos_area))
    return pdf_a_to_w(ld['pdf_a'], hit_dist, cos_val)


def light_intensity(ld, pk=None, lam=None):
    """LightIntensity: the light's color, or in spectral mode (``lam``) its
    SPD where it names one, times its multiplier."""
    color = ld['intensity']
    if lam is not None:
        color = spd_or_color(pk, ld['spd'], lam, color)
    return color * ld['mult']


# ---- spectral fetches (the JAX module's :1684-1747) -------------------------

def spd_sample(pk, sid, lam):
    """``sample_uniform_spectrum`` of spectrum ``sid`` [N] (f32 ids) on one
    wavelength plane ``lam`` [N]: the 1 nm grid index clamped to [0, 469]
    and lerped."""
    idx1 = torch.clamp(lam - 360.0, 0.0, 469.0).to(torch.int64)
    idx2 = torch.clamp(idx1 + 1, max=469)
    x1 = 360.0 + idx1.to(torch.float32)
    off = pk.spd_off[torch.clamp(sid.to(torch.int64), 0,
                                 pk.spd_off.shape[0] - 1)].to(torch.int64)
    last = pk.spd.shape[0] - 1
    y1 = pk.spd[torch.clamp(off + idx1, 0, last)]
    y2 = pk.spd[torch.clamp(off + idx2, 0, last)]
    return y1 + (lam - x1) * (y2 - y1)


def spd_or_color(pk, sid, lam4, color4):
    """[4, N]: each wavelength's SPD sample where ``sid`` >= 0, else the
    color rows as they are."""
    has = sid >= 0
    return torch.stack([torch.where(has, spd_sample(pk, sid, lam4[j]),
                                    color4[j]) for j in range(4)])


def cie_fetch(pk, k, lam):
    """CIE curve ``k`` (x, y, z) at round(lam) (``spectrum_to_xyz``'s
    indexing); a wavelength outside the table reads 0."""
    off = (torch.floor(lam + 0.5) - 360.0).to(torch.int64)
    valid = (off >= 0) & (off < SPEC.N_CIE_SAMPLES)
    v = pk.cie[torch.clamp(off, 0, SPEC.N_CIE_SAMPLES - 1), k]
    return torch.where(valid, v, 0.0)


def spectral_contrib(pk, st, accum):
    """``spectrum_to_xyz`` + ``xyz_to_rgb`` on planes (the JAX module's
    :1749): accum [4, N] per hero wavelength -> RGB and alpha 1 [4, N].
    Where the waves diverged only lane 0 counts, at a quarter of the
    pdf."""
    lam = st['lam']
    pdf0 = float(np.float32(1.0 / 470.0))
    tw = (st['flags'] & C.RAY_FLAG_WAVES_DIVERGED) != 0
    xyz = []
    for k in range(3):
        acc = torch.zeros_like(accum[0])
        for j in range(4):
            pdf = torch.where(tw, pdf0 / 4.0 if j == 0 else 0.0, pdf0)
            specp = torch.where(pdf != 0.0, accum[j] / torch.where(
                pdf == 0.0, 1.0, pdf), 0.0)
            acc = acc + cie_fetch(pk, k, lam[j]) * specp
        xyz.append(acc * (0.25 / SPEC.CIE_Y_INTEGRAL))
    m = SPEC.XYZ_TO_RGB
    rgb = [m[r][0] * xyz[0] + m[r][1] * xyz[1] + m[r][2] * xyz[2]
           for r in range(3)]
    return torch.stack(rgb + [torch.ones_like(rgb[0])])


def stage_nee(pk, md, tex_color, st, active, integrator,
              spectral=(None, None, None)):
    """kernel_SampleLightSource (integrator_pt.cpp:350-424); MIS weights
    for ``mispt`` only.  Lanes outside ``active`` draw no random numbers
    and get no light.  ``spectral``: ``_spectral_params``.  Returns
    (shade_color [4, N], rngx, rngy)."""
    consts = pk.consts
    rngx, rngy, rnd_id = RNG.rnd_float1_xy(st['rngx'], st['rngy'], active)
    rngx, rngy, r4 = RNG.rnd_float4_xy(rngx, rngy, active)
    num_lights = consts[CN_NUM_LIGHTS]
    lid = torch.minimum(torch.floor(rnd_id * num_lights),
                        num_lights - 1.0).to(torch.int64)
    ld = fetch_light(pk, lid)
    hit_pos = st['hit_pos']
    lpos, lnorm, is_omni = light_sample_rev(ld, r4[0], r4[1])
    ddiff = hit_pos - lpos
    hit_dist = torch.sqrt(dot3(ddiff, ddiff))
    shadow_dir = normalize3(lpos - hit_pos)
    offs = torch.clamp(torch.maximum(hit_pos[0], torch.maximum(
        hit_pos[1], hit_pos[2])), min=1.0) * 5e-6
    shadow_pos = hit_pos + st['hit_norm'] * offs
    need_trace = active & ((dot3(shadow_dir, lnorm) < 0.0) | is_omni)
    occluded = _trace_blocks(pk, shadow_pos, shadow_dir,
                             torch.zeros_like(hit_dist),
                             torch.where(need_trace, hit_dist * 0.9995, 0.0),
                             any_hit=True)
    need_shade = need_trace & ~occluded
    bsdf_val, bsdf_pdf = mat_eval(md, tex_color, shadow_dir, -st['d'],
                                  st['hit_norm'], pk.mtypes, spectral)
    cos_out = torch.clamp(dot3(shadow_dir, st['hit_norm']), min=0.0)
    lgt_pdf_w = (1.0 / torch.clamp(num_lights, min=1.0)) * light_eval_pdf(
        ld, shadow_pos, shadow_dir, lpos, lnorm)
    mis = (mis_weight(lgt_pdf_w, bsdf_pdf) if integrator == INTEGRATOR_MIS_PT
           else torch.ones_like(lgt_pdf_w))
    mis = torch.where(ld['geom'] == LIGHT_GEOM_POINT, 1.0, mis)
    shade = (light_intensity(ld, pk, st.get('lam')) * bsdf_val
             / torch.clamp(lgt_pdf_w, min=1e-30) * (cos_out * mis))
    return torch.where(need_shade, shade, 0.0), rngx, rngy


def stage_next_bounce(pk, md, tex_color, st, shade_color, active, prim,
                      integrator, spectral=(None, None, None)):
    """kernel_NextBounce (integrator_pt.cpp:426-548).  ``prim``: lanes
    shading their camera hit (a bool, or a bool plane in regen mode), which
    take a light's emission unweighted under MIS.  The shadow integrator
    takes a light hit only before the path's first non-specular bounce;
    the naive one adds no NEE."""
    is_light_mat = md['mtype'] == float(MTYPE_SMALL_LIGHT)
    # light-hit branch (integrator_pt.cpp:461-506)
    lgt_id = st['hit_lgt'].to(torch.int64)
    has_light = lgt_id >= 0
    emiss = md['c0'] * tex_color
    ldh = fetch_light(pk, torch.clamp(lgt_id, min=0))
    light_cos = dot3(st['d'], ldh['norm'])
    atten = torch.where((light_cos < 0.0) | (ldh['geom'] == LIGHT_GEOM_SPHERE),
                        1.0, 0.0)
    light_int = torch.where(has_light, light_intensity(
        ldh, pk, st.get('lam')) * atten, emiss)
    if integrator == INTEGRATOR_MIS_PT:
        num_lights = pk.consts[CN_NUM_LIGHTS]
        lgt_pdf = (1.0 / torch.clamp(num_lights, min=1.0)) * light_eval_pdf(
            ldh, st['o'], st['d'], st['hit_pos'], st['hit_norm'])
        w = mis_weight(st['mis_pdf'], lgt_pdf)
        w = torch.where(st['mis_pdf'] <= 0.0, 1.0, w)
        w = torch.where(torch.as_tensor(prim, device=w.device), 1.0, w)
        mis_weight_l = torch.where(has_light, w, 1.0)
    elif integrator == INTEGRATOR_SHADOW_PT:
        mis_weight_l = torch.where(_has_non_spec(st['flags']), 0.0, 1.0)
    else:
        mis_weight_l = 1.0
    light_branch = active & is_light_mat
    accum_light = st['accum'] + st['thr'] * light_int * mis_weight_l
    flags_light = st['flags'] | C.RAY_FLAG_IS_DEAD | C.RAY_FLAG_HIT_LIGHT

    # surface branch
    surf = active & ~is_light_mat
    rngx, rngy, rands = RNG.rnd_float4_xy(st['rngx'], st['rngy'], surf)
    samp = mat_sample(md, tex_color, rands, -st['d'], st['hit_norm'],
                      st['flags'], st['mis_ior'], pk.mtypes, spectral)
    bxdf = samp['val'] / torch.clamp(samp['pdf'], min=1e-20)
    cos_theta = dot3(samp['dir'], st['hit_norm']).abs()
    new_mis_pdf = torch.where((samp['flags'] & C.RAY_EVENT_S) != 0, -1.0,
                              samp['pdf'])
    new_accum = (st['accum'] if integrator == INTEGRATOR_STUPID_PT
                 else st['accum'] + st['thr'] * shade_color)
    new_thr = st['thr'] * cos_theta * bxdf
    new_pos = offs_ray_pos(st['hit_pos'], st['hit_norm'], samp['dir'])
    next_flags = ((st['flags'] & ~C.RAY_FLAG_FIRST_NON_SPEC) | samp['flags'])
    first_ns = ~_has_non_spec(st['flags']) & _has_non_spec(next_flags)
    next_flags = torch.where(first_ns, next_flags | C.RAY_FLAG_FIRST_NON_SPEC,
                             next_flags)
    st = dict(st)
    st['accum'] = torch.where(light_branch, accum_light,
                              torch.where(surf, new_accum, st['accum']))
    st['thr'] = torch.where(surf, new_thr, st['thr'])
    st['flags'] = torch.where(light_branch, flags_light,
                              torch.where(surf, next_flags, st['flags']))
    st['o'] = torch.where(surf, new_pos, st['o'])
    st['d'] = torch.where(surf, samp['dir'], st['d'])
    st['mis_pdf'] = torch.where(surf, new_mis_pdf, st['mis_pdf'])
    st['mis_ior'] = torch.where(surf, samp['ior'], st['mis_ior'])
    st['rngx'], st['rngy'] = rngx, rngy
    return st


def stage_env_contribute(pk, st, integrator):
    """kernel_HitEnvironment (the flat env color, times the lat-long map at
    the miss direction when the pack taps one), then the contribution
    ``accum * cam_response * exposure`` ([4, N]).  The naive integrator's
    miss overwrites the accumulator.  In spectral mode the sky is its SPD
    where it names one, and the contribution ``spectral_contrib``'s RGB
    times the exposure (alpha 1)."""
    consts = pk.consts
    out = (st['flags'] & C.RAY_FLAG_OUT_OF_SCENE) != 0
    env = consts[CN_ENV_COLOR:CN_ENV_COLOR + 4, None]
    if pk.spectral:
        sid = consts[CN_ENV_SPD].expand_as(st['mis_pdf'])
        env = torch.where(sid >= 0, torch.stack(
            [spd_sample(pk, sid, st['lam'][j]) for j in range(4)])
            * consts[CN_ENV_SMULT], env)
    if pk.env_mapped:
        env = env * env_tap(pk, st['d'])
    new_accum = st['thr'] * env
    if integrator != INTEGRATOR_STUPID_PT:
        new_accum = st['accum'] + new_accum
    accum = torch.where(out, new_accum, st['accum'])
    if pk.spectral:
        c = spectral_contrib(pk, st, accum)
        return torch.cat([c[:3] * consts[CN_EXPOSURE], c[3:4]])
    return (accum * consts[CN_CAM_RESP:CN_CAM_RESP + 4, None]
            * consts[CN_EXPOSURE])


def _shade(pk, st, active, prim, integrator):
    """NEE (none for the naive integrator) and the next bounce at the
    lanes' current hits."""
    md = fetch_mat(pk, st['flags'] & 0x00FFFFFF)
    tex = tex_tap(pk, md, st)
    spectral = _spectral_params(pk, md, st.get('lam'))
    if integrator == INTEGRATOR_STUPID_PT:
        shade = torch.zeros_like(st['accum'])
    else:
        shade, st['rngx'], st['rngy'] = stage_nee(pk, md, tex, st, active,
                                                  integrator, spectral)
    return stage_next_bounce(pk, md, tex, st, shade, active, prim,
                             integrator, spectral)


def n_bounces(depth: int, integrator: int) -> int:
    """Bounces a sample takes: one more for the naive integrator."""
    return depth + int(integrator == INTEGRATOR_STUPID_PT)


# ===========================================================================
# plain versions of the two kernels
# ===========================================================================

def sample_pass_plain(pk: MegaPack, xy, su, depth: int,
                      integrator: int = INTEGRATOR_MIS_PT):
    """One whole sample per lane (``sample_pass_ref``, :1965).

    xy [2, N] f32 pixel coordinates; su [>=2, N] int64 (rngx, rngy, ...).
    Returns (contrib [4, N] f32, su' [3, N] int64: rngx, rngy, flags)."""
    st = stage_init(pk.consts, xy[0], xy[1], su[0], su[1],
                    spectral=pk.spectral)
    for b in range(n_bounces(depth, integrator)):
        st = stage_trace(pk, st, b == 0)
        st = _shade(pk, st, ~_is_dead(st['flags']), b == 0, integrator)
    contrib = stage_env_contribute(pk, st, integrator)
    return contrib, torch.stack([st['rngx'], st['rngy'], st['flags']])


def rf_acc(spectral: bool) -> int:
    """The regen state's accumulator row (``_sf_nrows``, :2024): 4 rows
    further in spectral mode, past the wavelengths."""
    return RF_ACC + (4 if spectral else 0)


def rf_nrows(spectral: bool) -> int:
    return rf_acc(spectral) + 4


def _unpack_state(sf, su, spectral=False):
    st = dict(o=sf[SF_O:SF_O + 3], d=sf[SF_D:SF_D + 3],
              accum=sf[SF_ACCUM:SF_ACCUM + 4], thr=sf[SF_THR:SF_THR + 4],
              mis_pdf=sf[SF_MISPDF], mis_ior=sf[SF_MISIOR],
              hit_pos=sf[SF_HITPOS:SF_HITPOS + 3],
              hit_norm=sf[SF_HITNORM:SF_HITNORM + 3],
              hit_uv=sf[SF_HITUV:SF_HITUV + 2], hit_dist=sf[SF_HITDIST],
              hit_lgt=sf[SF_HITLGT], rngx=su[SU_RNGX], rngy=su[SU_RNGY],
              flags=su[SU_FLAGS])
    if spectral:
        st['lam'] = sf[SF_LAM:SF_LAM + 4]
    return st


def _pack_state(st, lane_acc, ndone, bcnt):
    sf = torch.cat([st['o'], st['d'], st['accum'], st['thr'],
                    st['mis_pdf'][None], st['mis_ior'][None], st['hit_pos'],
                    st['hit_norm'], st['hit_uv'], st['hit_dist'][None],
                    st['hit_lgt'][None]] + ([st['lam']] if 'lam' in st
                                            else []) + [lane_acc])
    su = torch.stack([st['rngx'], st['rngy'], st['flags'], ndone, bcnt])
    return sf, su


def _restart(pk, xy, st, mask):
    """Re-init the lanes in ``mask`` with their pixel's next camera ray
    (the JAX module's ``_merge_state``: the RNG comes from the masked
    init)."""
    stf = stage_init(pk.consts, xy[0], xy[1], st['rngx'], st['rngy'], mask,
                     pk.spectral)
    return {k: stf[k] if k in ('rngx', 'rngy') else
            torch.where(mask, stf[k], st[k]) for k in st}


def regen_iters_plain(pk: MegaPack, xy, sf, su, k: int, depth: int,
                      first: bool = False,
                      integrator: int = INTEGRATOR_MIS_PT):
    """``k`` persistent-lane iterations (``make_rmid``, :2412-2503); with
    ``first`` the first is ``make_rfirst`` (:2377): every lane's first
    camera ray, traced, with an empty accumulator (``sf`` is then unused
    and ``su`` holds the seeds in rows 0-1).

    xy [2, N]; sf [rf_nrows(pk.spectral), N] f32; su [RU_NROWS, N] int64.
    Returns the new (sf, su)."""
    if first:
        st = stage_init(pk.consts, xy[0], xy[1], su[0], su[1],
                        spectral=pk.spectral)
        st = stage_trace(pk, st, True)
        lane_acc = torch.zeros_like(st['accum'])
        ndone = torch.zeros_like(st['flags'])
        bcnt = torch.zeros_like(st['flags'])
        k -= 1
    else:
        st = _unpack_state(sf, su, pk.spectral)
        acc = rf_acc(pk.spectral)
        lane_acc, ndone, bcnt = sf[acc:acc + 4], su[RU_NDONE], su[RU_BCNT]
    n_b = n_bounces(depth, integrator)
    for _ in range(k):
        # 1. flush the lanes that missed at the last trace, re-init them
        dead0 = _is_dead(st['flags'])
        lane_acc = lane_acc + torch.where(
            dead0, stage_env_contribute(pk, st, integrator), 0.0)
        ndone = ndone + dead0.to(torch.int64)
        st = _restart(pk, xy, st, dead0)
        bcnt = torch.where(dead0, 0, bcnt)
        act = ~dead0
        # 2. shade the others
        st = _shade(pk, st, act, bcnt == 0, integrator)
        bcnt = bcnt + act.to(torch.int64)
        # depth truncation: the fixed chain drops the ray sampled at the
        # last bounce
        trunc = act & (bcnt >= n_b) & ~_is_dead(st['flags'])
        st['flags'] = torch.where(trunc, st['flags'] | C.RAY_FLAG_IS_DEAD,
                                  st['flags'])
        # 3. flush the shade deaths (light hits, truncation), re-init them
        dead1 = _is_dead(st['flags']) & act
        lane_acc = lane_acc + torch.where(
            dead1, stage_env_contribute(pk, st, integrator), 0.0)
        ndone = ndone + dead1.to(torch.int64)
        st = _restart(pk, xy, st, dead1)
        bcnt = torch.where(dead1, 0, bcnt)
        # 4. trace every lane
        st = stage_trace(pk, st, bcnt == 0)
    return _pack_state(st, lane_acc, ndone, bcnt)


def regen_finalize(pk: MegaPack, sf, su, integrator: int = INTEGRATOR_MIS_PT):
    """Flush the lanes dead at the last trace (the in-flight samples are
    dropped) and normalize each lane by its sample count (``_regen_finalize``
    :2651).  Returns (img [4, N], n_done [N] int64)."""
    st = _unpack_state(sf, su, pk.spectral)
    dead = _is_dead(st['flags'])
    acc = rf_acc(pk.spectral)
    lane_acc = sf[acc:acc + 4] + torch.where(
        dead, stage_env_contribute(pk, st, integrator), 0.0)
    ndone = su[RU_NDONE] + dead.to(torch.int64)
    return lane_acc / torch.clamp(ndone.to(torch.float32), min=1.0), ndone


# ===========================================================================
# the CUDA kernels (csrc/megakernel.cu) and their wrappers
# ===========================================================================

_CU_SRC = os.path.join(PKG_DIR, 'csrc', 'megakernel.cu')
# -fmad=false: no FMA contraction, so the kernel rounds op by op as the
# plain version does (the Woop test and every comparison agree bit for bit)
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC']
# A kernel variant is (integrator, material-set bits, env tap), and a fourth
# True for spectral mode: K1 is built once per variant, each branch the
# variant lacks compiled out, as the JAX package builds one kernel per
# (integrator, present material types, env tap, spectral).  The GLTF-only
# box's:
DEFAULT_VARIANT = (INTEGRATOR_MIS_PT, MT_BITS[MAT_TYPE_GLTF], False)
_LIBS = {}          # variant -> the loaded library the wrappers launch
_lib = None         # a library that replaces every variant's (measuring)


def variant_of(pk: MegaPack, integrator: int = INTEGRATOR_MIS_PT) -> tuple:
    """The kernel variant that renders ``pk`` with ``integrator``."""
    v = (int(integrator), material_bits(pk.mtypes, pk.has_disc),
         bool(pk.env_mapped))
    return v + (True,) if pk.spectral else v


def variant_defines(variant) -> tuple:
    """The ``-D`` macros that build ``variant`` (an RGB variant's are the
    three it had before spectral mode came)."""
    i, m, e, *spectral = variant
    return ((f'HC3_INTEGRATOR={i}', f'HC3_MTYPES={m}', f'HC3_ENV={int(e)}')
            + (('HC3_SPECTRAL=1',) if any(spectral) else ()))


def load_library(defines=(), source=_CU_SRC):
    """Compile (unless already built) and load ``source`` (by default
    ``csrc/megakernel.cu``) with the given ``-D`` macros; returns (library,
    seconds spent compiling).  ``variant_defines`` picks the variant (the
    default one without them); ``HC3_COUNT`` gives the measuring build,
    whose kernels sum every lane's Woop tests, child-box tests and shades
    by material kind (GLTF, diffuse, conductor, dielectric, glass, light
    source) into eight counters that ``hc3_mega_counts_reset()`` zeroes
    and ``hc3_mega_counts_read(ptr to 8 u64)`` copies out."""
    name = '-'.join(['megakernel', *(d.replace('HC3_', '').replace('=', '')
                                     for d in defines)]).lower()
    path, secs = build_shared_library(
        name, [source], [TST._nvcc()] + _NVCC_FLAGS
        + [f'-D{d}' for d in defines])
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hc3_mega_sample.restype = i
    lib.hc3_mega_sample.argtypes = [p, p, p, p, i, i, p, p, p]
    lib.hc3_mega_regen.restype = i
    lib.hc3_mega_regen.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p]
    lib.hc3_mega_attrs.restype = i
    lib.hc3_mega_attrs.argtypes = [i, p, ctypes.POINTER(ctypes.c_int)]
    if 'HC3_COUNT' in defines:
        lib.hc3_mega_counts_reset.restype = i
        lib.hc3_mega_counts_reset.argtypes = []
        lib.hc3_mega_counts_read.restype = i
        lib.hc3_mega_counts_read.argtypes = [p]
    return lib, secs


def build_kernels(variant=DEFAULT_VARIANT) -> float:
    """Compile (at first use) and load ``csrc/megakernel.cu`` for
    ``variant``; returns the seconds spent compiling (0 when already built
    or loaded)."""
    if variant in _LIBS:
        return 0.0
    lib, secs = load_library(variant_defines(variant))
    _LIBS.setdefault(variant, lib)
    return secs


def kernel_library(variant=DEFAULT_VARIANT):
    """The library the wrappers launch for ``variant`` (built at first
    use)."""
    if _lib is not None:
        return _lib
    build_kernels(variant)
    return _LIBS[variant]


def kernel_attrs(lib=None, pk: MegaPack = None) -> dict:
    """Registers per thread, local bytes per thread (spills, and the
    walk's stack when a pack's goes to local memory), shared bytes per
    block and lanes a pool (0: one lane a thread) of both kernels, as the
    loaded library (the default variant's by default) reports them; for a
    pack ``pk`` also what its launch takes: shared bytes per block at its
    layout, blocks an SM holds, and the layout (``'chip'``: its geometry
    and walk stacks in shared memory; ``'device'``: the geometry in device
    memory, the stacks local)."""
    if lib is None:
        lib = kernel_library()
    dims = None if pk is None else _dims(pk)
    out = {}
    for k, name in enumerate(('mega_sample_kernel', 'mega_regen_kernel')):
        v = (ctypes.c_int * 6)()
        TST.launch_checked(name, lib.hc3_mega_attrs(k, dims, v))
        out[name] = dict(registers=v[0], local_bytes=v[1], shared_bytes=v[2],
                         pool=v[4])
        if pk is not None:
            out[name].update(blocks_per_sm=v[3],
                             layout='chip' if v[5] else 'device')
    return out


def _dims(pk: MegaPack):
    """The sizes the C entry points lay a block's shared memory out by:
    the walk's stack need, texels, textured, wide nodes, real
    triangles."""
    w = pk.wide
    return (ctypes.c_int * 5)(
        w.stack, pk.texels.shape[0], int(not pk.tex_const), w.nodes.shape[0],
        w.rows.shape[0])


def _device_args(name, pk: MegaPack, xy, dev):
    """The pack's tables as the C entry points take them (an array of
    pointers; a spectral pack's also holds its SPD values, their row
    offsets and the CIE curves) and their sizes (``_dims``), after the
    checks: every table on the lanes' card, contiguous and of the kernel's
    dtype, and the wide table present with a stack the kernel provides."""
    if pk.wide is None:
        raise ValueError(f'{name}: a pack on the card needs its wide table '
                         '(pack(), or pack_from_numpy with the soup)')
    WB.require_stack(name, pk.wide.stack, MEGA_STACK)
    w = pk.wide
    TST.check_cuda_inputs(name, dict(
        woop=(pk.woop, torch.float32), nodes=(w.nodes, torch.float32),
        rows=(w.rows, torch.float32), index=(w.index, torch.int32),
        shade=(pk.shade, torch.float32), mat=(pk.mat, torch.float32),
        light=(pk.light, torch.float32), tex=(pk.tex, torch.float32),
        consts=(pk.consts, torch.float32), texels=(pk.texels, torch.float32),
        xy=(xy, torch.float32)), dev)
    tabs = [w.nodes, w.rows, w.index, pk.shade, pk.mat, pk.light, pk.tex,
            pk.consts, pk.texels]
    if pk.spectral:
        TST.check_cuda_inputs(name, dict(
            spd=(pk.spd, torch.float32), spd_off=(pk.spd_off, torch.int32),
            cie=(pk.cie, torch.float32)), dev)
        tabs += [pk.spd, pk.spd_off, pk.cie]
    if tuple(pk.mat.shape[1:]) != (MF_NROWS,) or \
            tuple(pk.light.shape[1:]) != (LF_NROWS,):
        raise ValueError(f'{name}: mat / light rows must have {MF_NROWS} / '
                         f'{LF_NROWS} columns')
    if xy.dim() != 2 or xy.shape[0] != 2:
        raise ValueError(f'{name}: xy must be [2, N], got {tuple(xy.shape)}')
    return ((ctypes.c_void_p * len(tabs))(*(t.data_ptr() for t in tabs)),
            _dims(pk))


def _u32_rows(name, su, rows, n, dev):
    if su.device != dev or su.dtype != torch.int64 or su.dim() != 2 \
            or su.shape[0] < rows or su.shape[1] != n:
        raise ValueError(f'{name}: su must be int64 [>={rows}, {n}] on {dev}')
    return su[:rows].contiguous()


def sample_pass(pk: MegaPack, xy, su, depth: int,
                integrator: int = INTEGRATOR_MIS_PT):
    """One whole sample per lane: the plain version for CPU tensors, the
    fixed-chain CUDA kernel of the pack's variant for CUDA tensors.  Same
    contract as ``sample_pass_plain``."""
    dev = xy.device
    if dev.type == 'cpu':
        return sample_pass_plain(pk, xy, su, depth, integrator)
    if dev.type != 'cuda':
        raise ValueError(f'sample_pass: unsupported device {dev}')
    lib = kernel_library(variant_of(pk, integrator))
    tables, dims = _device_args('sample_pass', pk, xy, dev)
    n = xy.shape[1]
    su_in = _u32_rows('sample_pass', su, 2, n, dev)
    contrib = torch.empty((4, n), dtype=torch.float32, device=dev)
    su_out = torch.empty((3, n), dtype=torch.int64, device=dev)
    if n > 0:
        rc = lib.hc3_mega_sample(
            tables, dims, xy.data_ptr(), su_in.data_ptr(), depth, n,
            contrib.data_ptr(), su_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        TST.launch_checked('sample_pass', rc)
        sample_pass.launches += 1
    return contrib, su_out


sample_pass.launches = 0


def regen_pass(pk: MegaPack, xy, sf, su, k: int, depth: int,
               first: bool = False, integrator: int = INTEGRATOR_MIS_PT):
    """``k`` regen iterations (``first``: starting with rfirst): the plain
    version for CPU tensors, the persistent-lane CUDA kernel of the pack's
    variant for CUDA tensors.  Same contract as ``regen_iters_plain``."""
    dev = xy.device
    if dev.type == 'cpu':
        return regen_iters_plain(pk, xy, sf, su, k, depth, first, integrator)
    if dev.type != 'cuda':
        raise ValueError(f'regen_pass: unsupported device {dev}')
    lib = kernel_library(variant_of(pk, integrator))
    tables, dims = _device_args('regen_pass', pk, xy, dev)
    n = xy.shape[1]
    su_in = _u32_rows('regen_pass', su, 2 if first else RU_NROWS, n, dev)
    rows = rf_nrows(pk.spectral)
    if first:
        sf_in = torch.empty((rows, n), dtype=torch.float32, device=dev)
    else:
        TST.check_cuda_inputs('regen_pass', dict(sf=(sf, torch.float32)), dev)
        if tuple(sf.shape) != (rows, n):
            raise ValueError(f'regen_pass: sf must be [{rows}, {n}]')
        sf_in = sf
    sf_out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    su_out = torch.empty((RU_NROWS, n), dtype=torch.int64, device=dev)
    if n > 0 and k > 0:
        rc = lib.hc3_mega_regen(
            tables, dims, xy.data_ptr(), sf_in.data_ptr(), su_in.data_ptr(),
            int(first), k, depth, n, sf_out.data_ptr(), su_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        TST.launch_checked('regen_pass', rc)
        regen_pass.launches += 1
    return sf_out, su_out


regen_pass.launches = 0

# K1 against its plain version on the same card: the kernel is built without
# FMA contraction and rounds op by op as torch's CUDA ops do, so every uint32
# row must be equal and every f32 within this rtol/atol (a few ulps)
KERNEL_TOL = 1e-6


def lanes_agree(kernel, plain, exact_rows):
    """A kernel's (f32 rows, int64 rows) against the plain version's, lane by
    lane: (share of lanes whose f32 rows are within ``KERNEL_TOL``, share of
    lanes whose first ``exact_rows`` uint32 rows are equal, max |difference|
    of the f32 rows)."""
    kf, pf = kernel[0], plain[0]
    close = torch.isclose(kf, pf, rtol=KERNEL_TOL, atol=KERNEL_TOL,
                          equal_nan=True).all(0)
    equal = (kernel[1][:exact_rows] == plain[1][:exact_rows]).all(0)
    same = (kf == pf) | (kf.isnan() & pf.isnan())
    err = torch.where(same, 0.0, (kf - pf).abs()).max().item() \
        if kf.numel() else 0.0
    return close.float().mean().item(), equal.float().mean().item(), err


# ===========================================================================
# the render loop
# ===========================================================================

def lane_setup(meta, device):
    """Per-lane pixel coordinates and RNG seeds: the frame padded to a
    multiple of ``RBLK`` lanes with copies of the last pixel (the JAX
    render's lane layout).  Returns (xy [2, Np] f32, su [2, Np] int64)."""
    N = meta.width * meta.height
    Np = -(-N // RBLK) * RBLK
    ids = torch.clamp(torch.arange(Np, device=device), max=N - 1)
    xy = torch.stack([torch.remainder(ids, meta.width),
                      torch.div(ids, meta.width, rounding_mode='floor')]
                     ).to(torch.float32)
    return xy, RNG.gen_init(ids).T.contiguous()


def render(scene, meta, spp: int = None, integrator: str = 'mispt',
           regen: bool = False, return_timing: bool = False):
    """Full-frame render through the megakernel with ``integrator``
    (``naivept``, ``shadowpt`` or ``mispt``): float32 numpy [H, W, 4],
    normalized.

    The fixed chain runs ``spp`` sample passes per tile of at most 2^20
    lanes, ``K_SAMPLES`` of them between host syncs; ``regen`` runs the
    persistent-lane pipeline with the JAX render's host stop rule
    (:2795-2820) and normalizes each pixel by its completed-sample count
    (a mean of at least ``spp``).  Nothing is scrubbed: ``return_timing``
    also returns dict(total_s, spp, samples, launches, nonfinite[, iters]):
    the samples the frame completed, the kernel launches it made (the
    ``launches`` of ``sample_pass`` or ``regen_pass``; none on the CPU;
    left out where ``regen_pass`` names a stand-in without a counter),
    the lane samples with a non-finite contribution (in regen mode: lanes
    whose accumulated sum is non-finite) and, in regen mode, the
    persistent-lane iterations summed over the tiles."""
    reason = why_unsupported(scene, meta, integrator)
    if reason is not None:
        raise NotImplementedError(f'megakernel: {reason}')
    spp = spp or meta.spp
    itype = INTEGRATOR_BY_NAME[integrator]
    W, H = meta.width, meta.height
    N = W * H
    depth = meta.trace_depth
    with span('hc3.mk.pack'):
        pk = pack(scene, meta)
    with span('hc3.mk.lane_setup'):
        xy, su0 = lane_setup(meta, pk.consts.device)
    Np = xy.shape[1]
    tile = min(1 << 20, Np)
    tiles = [(s, min(s + tile, Np)) for s in range(0, Np, tile)]
    xy_t = [xy[:, s:e].contiguous() for s, e in tiles]
    nonfinite = torch.zeros((), dtype=torch.int64, device=xy.device)
    t0 = time.perf_counter()
    timing = dict(spp=spp)
    if regen:
        # a stand-in for the wrapper without a counter (a planted fault)
        # counts nothing, and the frame then reports no launches
        launches0 = getattr(regen_pass, 'launches', None)
        n_bounce = n_bounces(depth, itype)
        kit = REGEN_ITERS
        img_parts, nd_parts = [], []
        timing['iters'] = 0
        for i, (s, e) in enumerate(tiles):
            sf, su = regen_pass(pk, xy_t[i], None, su0[:, s:e], kit, depth,
                                first=True, integrator=itype)
            iters = kit
            max_iters = spp * (n_bounce + 2) + kit  # the fixed chain's bound
            while iters < max_iters:
                with span('hc3.sync.stop_rule'):
                    mean_done = float(su[RU_NDONE].to(torch.float32).mean())
                if mean_done >= spp:
                    break
                rate = max(mean_done / iters, 1.0 / (n_bounce + 2))
                rem = max(1, int(math.ceil((spp - mean_done) / (rate * kit))))
                for _ in range(rem):
                    sf, su = regen_pass(pk, xy_t[i], sf, su, kit, depth,
                                        integrator=itype)
                iters += rem * kit
            timing['iters'] += iters
            with span('hc3.mk.finalize'):
                img4, nd = regen_finalize(pk, sf, su, itype)
            img_parts.append(img4)
            nd_parts.append(nd)
        flat = torch.cat(img_parts, dim=1)[:, :N]
        # a non-finite sample leaves its lane's sum non-finite
        nonfinite = (~torch.isfinite(flat)).any(0).sum()
        with span('hc3.sync.samples'):
            timing['samples'] = int(torch.cat(nd_parts)[:N].sum())
        if launches0 is not None:
            timing['launches'] = regen_pass.launches - launches0
    else:
        launches0 = sample_pass.launches
        fb = [None] * len(tiles)
        su_t = [su0[:, s:e] for s, e in tiles]
        k = min(K_SAMPLES, spp)
        done = 0
        while done < spp:
            kk = min(k, spp - done)
            for i, (s, e) in enumerate(tiles):
                # k samples summed per chunk, then the chunks (the JAX
                # render's order of summation)
                chunk = torch.zeros((4, e - s), dtype=torch.float32,
                                    device=xy.device)
                for _ in range(kk):
                    c, su_t[i] = sample_pass(pk, xy_t[i], su_t[i], depth,
                                             itype)
                    nonfinite += (~torch.isfinite(c[:, :max(0, N - s)])
                                  ).any(0).sum()
                    chunk = chunk + c
                fb[i] = chunk if fb[i] is None else fb[i] + chunk
            done += kk
            if xy.device.type == 'cuda':
                torch.cuda.synchronize(xy.device)
        flat = torch.cat(fb, dim=1)[:, :N] / float(spp)
        timing.update(samples=N * spp,
                      launches=sample_pass.launches - launches0)
    with span('hc3.sync.readback'):
        img = flat.T.cpu().numpy().reshape(H, W, 4)
    timing.update(total_s=time.perf_counter() - t0, nonfinite=int(nonfinite))
    if return_timing:
        return img, timing
    return img
