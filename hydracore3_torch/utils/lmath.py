"""Vector/matrix helpers (LiteMath + include/cglobals.h), batched in torch.

The counterpart of ``hydracore3_tpu/utils/lmath.py``, holding the helpers
the MIS path tracer's slice calls.  Vectors live on the last axis; matrices
are row-major ``[..., 4, 4]`` with the ``M @ v`` convention.  Host-side
camera matrices (``perspective_matrix``, ``look_at``) stay numpy.
"""
from __future__ import annotations

import numpy as np
import torch

GEPSILON = 1e-5

M_PI = float(np.pi)
M_TWOPI = float(2.0 * np.pi)
INV_PI = float(1.0 / np.pi)
FLT_MAX = float(np.finfo(np.float32).max)


def dot(a, b):
    """Dot product over the last axis."""
    return (a * b).sum(-1)


def normalize(v):
    """v / |v| with the guard of the JAX package (stays in the normal f32
    range, so zero vectors map to zero)."""
    n2 = (v * v).sum(-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=1e-30))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_arccos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def lerp(a, b, t):
    return a + (b - a) * t


def maxcomp(v):
    """Max component of a [..., 3] vector (cglobals.h:275)."""
    return v[..., :3].amax(-1)


def mul4x3(m, v3):
    """Transform a point by a [4, 4] matrix: (M @ [v, 1]).xyz."""
    return (v3[..., None, :] * m[:3, :3]).sum(-1) + m[:3, 3]


def mul3x3(m, v3):
    """Rotate a direction by the upper 3x3 of ``m`` (per-row [..., 4, 4]
    or shared [4, 4])."""
    return (v3[..., None, :] * m[..., :3, :3]).sum(-1)


def transform_ray3f(m, ray_pos, ray_dir):
    """cglobals.h:254-263: transform pos and pos + 100 dir, renormalize."""
    pos = mul4x3(m, ray_pos)
    pos2 = mul4x3(m, ray_pos + 100.0 * ray_dir)
    return pos, normalize(pos2 - pos)


def perspective_matrix(fov_deg, aspect, z_near, z_far):
    """OpenGL-style perspective (LiteMath perspectiveMatrix); numpy [4, 4]."""
    ymax = z_near * np.tan(fov_deg * np.pi / 360.0)
    xmax = ymax * aspect
    left, right, bottom, top = -xmax, xmax, -ymax, ymax
    temp, temp2, temp3, temp4 = (2.0 * z_near, right - left, top - bottom,
                                 z_far - z_near)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = temp / temp2
    m[1, 1] = temp / temp3
    m[0, 2] = (right + left) / temp2
    m[1, 2] = (top + bottom) / temp3
    m[2, 2] = (-z_far - z_near) / temp4
    m[3, 2] = -1.0
    m[2, 3] = (-temp * z_far) / temp4
    return m


def look_at(eye, center, up):
    """LiteMath lookAt: world->camera matrix, numpy [4, 4] row-major."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    y = y / np.linalg.norm(y)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = x
    m[1, :3] = y
    m[2, :3] = z
    m[0, 3] = -np.dot(x, eye)
    m[1, 3] = -np.dot(y, eye)
    m[2, 3] = -np.dot(z, eye)
    return m


def coordinate_system_v2(n):
    """Duff et al. orthonormal basis (cglobals.h:120-132). Returns (s, t)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    pos = nz >= 0
    sign = torch.where(pos, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([torch.where(pos, nx * nx * a, -nx * nx * a) + 1.0,
                     torch.where(pos, b, -b),
                     torch.where(pos, -nx, nx)], dim=-1)
    t = torch.stack([b, ny * ny * a + sign, -ny], dim=-1)
    return s, t


def map_sample_to_cosine_distribution(r1, r2, direction, hit_norm, power):
    """cglobals.h:143-181: power-cosine hemisphere sample around
    ``direction``."""
    sin_phi = torch.sin(M_TWOPI * r1)
    cos_phi = torch.cos(M_TWOPI * r1)
    cos_theta = torch.pow(torch.clamp(1.0 - r2, min=1e-20), 1.0 / (power + 1.0))
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    dx = (sin_theta * cos_phi)[..., None]
    dy = (sin_theta * sin_phi)[..., None]
    dz = cos_theta[..., None]
    nx, ny = coordinate_system_v2(direction)
    nz = direction
    res = nx * dx + ny * dy + nz * dz
    inv_sign = torch.where(dot(direction, hit_norm) > 0.0, 1.0, -1.0)
    below = inv_sign * dot(res, hit_norm) < 0.0
    res_flipped = -nx * dx + ny * dy - nz * dz
    return torch.where(below[..., None], res_flipped, res)


def epsilon_of_pos(hit_pos):
    """cglobals.h:233."""
    m = torch.clamp(hit_pos[..., :3].abs().amax(-1), min=2.0 * GEPSILON)
    return m * GEPSILON


def offs_ray_pos(hit_pos, surface_norm, sample_dir):
    """cglobals.h:242-247."""
    sign = torch.where(dot(sample_dir, surface_norm) < 0.0, -1.0, 1.0)
    eps = epsilon_of_pos(hit_pos)
    return hit_pos + (sign * eps)[..., None] * surface_norm


def pdf_a_to_w(pdf_a, dist, cos_there):
    """cglobals.h:265."""
    return (pdf_a * dist * dist) / torch.clamp(cos_there, min=1e-30)


def mis_weight_heuristic(a, b):
    """Balance heuristic, power 1 (cglobals.h:277-282)."""
    pa = torch.where(torch.isfinite(a), a.abs(), 0.0)
    pb = torch.where(torch.isfinite(b), b.abs(), 0.0)
    w = pa / torch.clamp(pa + pb, min=1e-30)
    return torch.where(torch.isfinite(w), w, 0.0)


def mul_rows_2x4(row0, row1, v):
    """2x4 texture-matrix transform of uv (cglobals.h:315-321)."""
    x = row0[..., 0] * v[..., 0] + row0[..., 1] * v[..., 1] + row0[..., 3]
    y = row1[..., 0] * v[..., 0] + row1[..., 1] * v[..., 1] + row1[..., 3]
    return torch.stack([x, y], dim=-1)


def sphere_map_to_2d_tex_coord(ray_dir):
    """cglobals.h:335-358. Returns (texCoord [..., 2], sinTheta)."""
    theta = safe_arccos(-ray_dir[..., 1])
    phi = torch.atan2(ray_dir[..., 0], ray_dir[..., 2])
    phi = torch.where(phi < 0.0, phi + M_TWOPI, phi)
    tex_x = torch.clamp(phi * 0.5 * INV_PI, 0.0, 1.0)
    tex_y = torch.clamp(theta * INV_PI, 0.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - ray_dir[..., 1] * ray_dir[..., 1],
                                       min=0.0))
    return torch.stack([tex_x, tex_y], dim=-1), sin_theta


def tex_coord_2d_to_sphere_map(tex_coord):
    """cglobals.h:360-373. Returns (dir [..., 3], sinTheta)."""
    phi = tex_coord[..., 0] * 2.0 * M_PI
    theta = tex_coord[..., 1] * M_PI
    sin_theta = torch.sin(theta)
    x = sin_theta * torch.cos(phi)
    y = sin_theta * torch.sin(phi)
    z = torch.cos(theta)
    return torch.stack([y, -z, x], dim=-1), sin_theta


def reflect(d, n):
    """Mirror-reflect direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def eye_ray_dir_normalized(x, y, proj_inv):
    """cglobals.h:49-55: NDC pixel -> camera-space ray direction."""
    ndc_x = 2.0 * x - 1.0
    ndc_y = 2.0 * y - 1.0
    rows = [proj_inv[i, 0] * ndc_x + proj_inv[i, 1] * ndc_y + proj_inv[i, 3]
            for i in range(4)]
    pos = torch.stack(rows[:3], dim=-1) / rows[3][..., None]
    return normalize(pos)
