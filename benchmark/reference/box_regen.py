"""Plain reference of a regen frame of a small scene (the box class).

It follows the estimator the program's persistent-lane path runs, written
out in plain torch from the renderer's published algorithm (HydraCore3's
``integrator_pt.cpp``: camera ray, then per bounce a nearest hit, next
event estimation with a shadow any-hit and MIS, a material sample; the
flat environment on a miss) and its per-pixel random streams
(``crandom.h``).  One lane is one pixel: it runs its samples one after the
other, each from the random state the last one left, flushes a finished
sample into its sum and starts the next at once; after the frame's
iterations it divides the sum by its count of finished samples.

It imports nothing of the program.  ``tables`` derives every table the
frame needs from the plain scene description (``scenes/box.py``): the
world-space triangles and their Woop rows, the shading rows, the
material and light rows, the camera matrices and the decoded texels.  The
trace is brute force over every triangle.  ``dtype`` sets the precision
of every float: float32 is the reference, bfloat16 the control.

Supported: MIS path tracing, GLTF materials made from the Hydra-style
diffuse / reflectivity description (Lambert, Lambert + metal, metal; a
glossiness of 1 is a smooth mirror), area-light emitters, rect, sphere
and point lights, one slot-0 texture (bilinear, wrap), a flat environment
and a pinhole camera.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

M_PI = math.pi
INV_PI = 1.0 / math.pi
M_TWOPI = 2.0 * math.pi
FLT_MAX = 3.4e38
GEPSILON = 1e-5
BIG_I = 0x7FFFFFF0

# ray flags (cglobals.h)
IS_DEAD = 0x80000000
OUT_OF_SCENE = 0x40000000
HIT_LIGHT = 0x20000000
HAS_NON_SPEC = 0x10000000
HAS_INV_NORMAL = 0x08000000
PRIME_RAY_MISS = 0x02000000
FIRST_NON_SPEC = 0x01000000
EVENT_S = 1

# material kinds of the reference tables
MK_GLTF, MK_LIGHT = 1, 9
LAMBERT, METAL = 1, 4
# light kinds
L_RECT, L_SPHERE, L_POINT = 1, 3, 5
D_LAMBERT, D_OMNI = 0, 1

M32 = 0xFFFFFFFF


# ---- random streams (crandom.h) -------------------------------------------

def _poly(x, a, b, c):
    x2 = (x * x) & M32
    return (x * ((x2 * a + b) & M32) + c) & M32


def _next(sx, sy, mask):
    x = (sx * 17 + sy * 13123) & M32
    nx = ((x << 13) & M32) ^ x
    ny = sy ^ ((x << 7) & M32)
    if mask is not None:
        nx = torch.where(mask, nx, sx)
        ny = torch.where(mask, ny, sy)
    return nx, ny, x


def _u2f(u, ft):
    return (u.to(torch.float32) * (1.0 / 4294967296.0)).to(ft)


def rnd4(sx, sy, mask, ft):
    sx, sy, x = _next(sx, sy, mask)
    h = torch.stack([_poly(x, 15731, 74323, 871483),
                     _poly(x, 13734, 37828, 234234),
                     _poly(x, 11687, 26461, 137589),
                     _poly(x, 15707, 789221, 1376312589)])
    return sx, sy, _u2f(h, ft)


def rnd1(sx, sy, mask, ft):
    sx, sy, x = _next(sx, sy, mask)
    return sx, sy, _u2f(_poly(x, 15731, 74323, 871483), ft)


def seed_state(pixel_ids):
    """RandomGenInit of each pixel's id: (sx, sy) int64 planes."""
    a = pixel_ids.to(torch.int64) & M32
    sx = _poly(a, 15731, 74323, 871483)
    sy = _poly(a, 13734, 37828, 234234)
    n_warm = torch.remainder(pixel_ids.to(torch.int32), 7)
    for i in range(6):
        sx, sy, _ = _next(sx, sy, n_warm > i)
    return sx, sy


# ---- the tables ----------------------------------------------------------

def _face_normals(pos, ind):
    n = np.zeros((len(pos), 3), np.float32)
    fn = np.cross(pos[ind[:, 1]] - pos[ind[:, 0]],
                  pos[ind[:, 2]] - pos[ind[:, 0]])
    for k in range(3):
        np.add.at(n, ind[:, k], fn)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


def _woop(v0, e1, e2):
    """[T, 12] rows: M = inv([e1 e2 e1 x e2]); the hit is M (o - v0) + t M d
    = (u, v, 0)."""
    v0, e1, e2 = (np.asarray(a, np.float64) for a in (v0, e1, e2))
    A = np.stack([e1, e2, np.cross(e1, e2)], axis=-1)
    Minv = np.linalg.inv(A)
    W = np.zeros((len(v0), 3, 4), np.float32)
    W[:, :, :3] = Minv.astype(np.float32)
    W[:, :, 3] = (-np.einsum('tij,tj->ti', Minv, v0)).astype(np.float32)
    return W.reshape(-1, 12)


def _perspective(fov, aspect, near, far):
    ymax = near * np.tan(fov * np.pi / 360.0)
    xmax = ymax * aspect
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 2.0 * near / (2.0 * xmax)
    m[1, 1] = 2.0 * near / (2.0 * ymax)
    m[2, 2] = (-far - near) / (far - near)
    m[3, 2] = -1.0
    m[2, 3] = (-2.0 * near * far) / (far - near)
    return m


def _look_at(eye, center, up):
    """The world-to-camera matrix of a pose given as float32 (as a scene
    file holds it), worked out in float64."""
    eye, center, up = (np.asarray(a, np.float32).astype(np.float64)
                       for a in (eye, center, up))
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    y = y / np.linalg.norm(y)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = x, y, z
    m[0, 3], m[1, 3], m[2, 3] = -x @ eye, -y @ eye, -z @ eye
    return m


def _color4(c):
    c = [float(x) for x in c]
    return np.array(c + [0.0] * (4 - len(c)), np.float32)


def tables(desc: dict, device, dtype=torch.float32) -> dict:
    """Every table of the frame, derived from the description."""
    meshes = list(desc['meshes'])
    mats = [dict(m) for m in desc['materials']]
    lights = []                     # light rows, in the scene's order
    for i, L in enumerate(desc.get('area_lights', ())):
        mid = len(mats)
        mats.append(dict(light=True))
        hw, hl = float(L['half_width']), float(L['half_length'])
        m = np.asarray(L['matrix'], np.float32)
        pos = np.array([[-hw, 0, -hl], [hw, 0, -hl], [hw, 0, hl],
                        [-hw, 0, hl]], np.float32)
        meshes.append(dict(pos=pos @ m[:3, :3].T + m[:3, 3],
                           indices=np.array([[0, 1, 2], [0, 2, 3]]),
                           mat_indices=np.array([mid, mid]),
                           norm=np.tile(np.float32([[0, -1, 0]]), (4, 1))
                           @ np.linalg.inv(m).T.astype(np.float32)[:3, :3].T,
                           light_id=i))
        nrm = m @ np.array([0, -1, 0, 0], np.float32)
        sc = [float(np.linalg.norm(m[:3, k])) for k in range(3)]
        size = np.array([hl, hw], np.float32)
        lights.append(dict(kind=L_RECT, dist=D_LAMBERT,
                           pos=(m @ np.float32([0, 0, 0, 1]))[:3],
                           norm=(nrm / max(np.linalg.norm(nrm[:3]),
                                           1e-20))[:3],
                           rot=m[:3, :3], size=size,
                           pdf_a=1.0 / (4.0 * size[0] * size[1] * sc[0]
                                        * sc[2]),
                           color=_color4(L['color']),
                           mult=float(L['multiplier'])))
    for L in desc.get('simple_lights', ()):
        m = np.asarray(L['matrix'], np.float32)
        pos = (m @ np.float32([0, 0, 0, 1]))[:3]
        row = dict(pos=pos, norm=np.float32([0, -1, 0]),
                   rot=np.eye(3, dtype=np.float32),
                   size=np.zeros(2, np.float32), pdf_a=1.0,
                   color=_color4(L['color']), mult=float(L['multiplier']))
        if L['kind'] == 'sphere':
            r = float(L['radius']) * float(np.linalg.norm(m[:3, 0]))
            row.update(kind=L_SPHERE, dist=D_LAMBERT,
                       size=np.array([r, r], np.float32),
                       pdf_a=1.0 / (4.0 * np.pi * r * r))
        elif L['kind'] == 'point':
            nrm = m @ np.array([0, -1, 0, 0], np.float32)
            row.update(kind=L_POINT, dist=D_OMNI,
                       norm=(nrm / max(np.linalg.norm(nrm[:3]), 1e-20))[:3])
        else:
            raise NotImplementedError(f"light kind {L['kind']!r}")
        lights.append(row)

    v0s, e1s, e2s, ns, uvs, mids, lids = [], [], [], [], [], [], []
    for m in meshes:
        pos = np.asarray(m['pos'], np.float32)
        ind = np.asarray(m['indices'], np.int64).reshape(-1, 3)
        nrm = (_face_normals(pos, ind) if m.get('norm') is None
               else np.asarray(m['norm'], np.float32))
        uv = (np.zeros((len(pos), 2), np.float32) if m.get('texc') is None
              else np.asarray(m['texc'], np.float32))
        p = [pos[ind[:, c]] for c in range(3)]
        v0s.append(p[0])
        e1s.append(p[1] - p[0])
        e2s.append(p[2] - p[0])
        ns.append(np.stack([nrm[ind[:, c]] for c in range(3)]))
        uvs.append(np.stack([uv[ind[:, c]] for c in range(3)]))
        mids.append(np.asarray(m['mat_indices'], np.int64))
        lids.append(np.full(len(ind), m.get('light_id', -1), np.int64))
    v0, e1, e2 = (np.concatenate(a) for a in (v0s, e1s, e2s))

    # materials: a Hydra diffuse / reflectivity description as GLTF
    M = len(mats)
    kind = np.zeros(M, np.int64)
    cflags = np.zeros(M, np.int64)
    base = np.zeros((M, 4), np.float32)
    metal = np.zeros((M, 4), np.float32)
    alpha = np.zeros(M, np.float32)
    gloss = np.ones(M, np.float32)
    texid = np.full(M, -1, np.int64)
    for i, md in enumerate(mats):
        if md.get('light'):
            kind[i] = MK_LIGHT
            continue
        kind[i] = MK_GLTF
        col = _color4(md.get('diffuse_color', (0.5, 0.5, 0.5)))
        refl = _color4(md['reflectivity']) if md.get('reflectivity') \
            else np.zeros(4, np.float32)
        ln_refl = float(np.linalg.norm(refl))
        ln_col = float(np.linalg.norm(col[:3]))
        texid[i] = md.get('diffuse_tex_id', -1)
        gloss[i] = md.get('glossiness', 1.0) if md.get('reflectivity') else 1.0
        base[i] = col
        if ln_refl > 1e-5 and ln_col > 1e-5:
            cflags[i] = LAMBERT | METAL
            alpha[i] = ln_refl / (ln_refl + ln_col)
            metal[i] = refl
        elif ln_col > 1e-5:
            cflags[i] = LAMBERT
        elif ln_refl > 1e-5:        # reflectivity alone: all metal
            cflags[i] = METAL
            base[i] = refl
            metal[i] = 1.0
            alpha[i] = 1.0
        else:
            raise NotImplementedError(f'material {md}')

    texels = []
    for t in desc['textures']:
        img = np.asarray(t, np.float32) / 255.0
        img = np.power(img, 2.2, dtype=np.float32)
        texels.append(np.concatenate(
            [img, np.ones(img.shape[:2] + (1,), np.float32)], -1))
    if len(texels) > 1:
        raise NotImplementedError('one texture')

    cam = desc['camera']
    aspect = float(desc['width']) / float(desc['height'])
    proj_inv = np.linalg.inv(_perspective(cam['fov'], aspect, cam['near'],
                                          cam['far'])).astype(np.float32)
    wv_inv = np.linalg.inv(_look_at(cam['pos'], cam['look_at'],
                                    cam['up'])).astype(np.float32)

    def f(a):
        # FLT_MAX turns infinite in bfloat16, whose range ends just below it
        return torch.as_tensor(np.asarray(a, np.float32), device=device
                               ).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    L = len(lights)
    return dict(
        dtype=dtype, width=int(desc['width']), height=int(desc['height']),
        depth=int(desc['depth']),
        woop=f(_woop(v0, e1, e2)), tri_n=f(np.concatenate(ns, 1)),
        tri_uv=f(np.concatenate(uvs, 1)), tri_mat=i(np.concatenate(mids)),
        tri_lgt=i(np.concatenate(lids)),
        mat_kind=i(kind), mat_cflags=i(cflags), mat_base=f(base),
        mat_metal=f(metal), mat_alpha=f(alpha), mat_gloss=f(gloss),
        mat_texid=i(texid),
        texels=f(texels[0]) if texels else None,
        n_lights=L,
        l_kind=i([x['kind'] for x in lights]),
        l_dist=i([x['dist'] for x in lights]),
        l_pos=f([x['pos'] for x in lights]),
        l_norm=f([x['norm'] for x in lights]),
        l_rot=f([np.asarray(x['rot'], np.float32).reshape(9) for x in lights]),
        l_size=f([x['size'] for x in lights]),
        l_pdf_a=f([x['pdf_a'] for x in lights]),
        l_color=f([x['color'] for x in lights]),
        l_mult=f([x['mult'] for x in lights]),
        proj_inv=f(proj_inv.reshape(16)), wv_inv=f(wv_inv.reshape(16)),
        env=f(np.zeros(4, np.float32)), far=f(FLT_MAX))


# ---- plane math: scalars [N], vectors [k, N] ------------------------------


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def normalize3(a):
    return a * torch.rsqrt(torch.clamp(dot3(a, a), min=1e-30))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def acos_poly(x):
    ax = torch.clamp(x.abs(), 0.0, 1.0)
    p = torch.full_like(ax, -0.0012624911)
    for c in (0.0066700901, -0.0170881256, 0.0308918810, -0.0501743046,
              0.0889789874, -0.2145988016, 1.5707963050):
        p = p * ax + c
    r = p * torch.sqrt(1.0 - ax)
    return torch.where(x < 0.0, M_PI - r, r)


def basis(n):
    """Duff et al.'s orthonormal basis (s, t) of n."""
    nx, ny, nz = n[0], n[1], n[2]
    pos = nz >= 0
    sign = torch.where(pos, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([torch.where(pos, nx * nx * a, -nx * nx * a) + 1.0,
                     torch.where(pos, b, -b), torch.where(pos, -nx, nx)])
    t = torch.stack([b, ny * ny * a + sign, -ny])
    return s, t


def cosine_sample(r1, r2, n):
    sin_phi = torch.sin(M_TWOPI * r1)
    cos_phi = torch.cos(M_TWOPI * r1)
    cos_theta = torch.sqrt(torch.clamp(1.0 - r2, min=1e-20))
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    dx, dy, dz = sin_theta * cos_phi, sin_theta * sin_phi, cos_theta
    bx, by = basis(n)
    res = bx * dx + by * dy + n * dz
    inv_sign = torch.where(dot3(n, n) > 0.0, 1.0, -1.0).to(n.dtype)
    below = inv_sign * dot3(res, n) < 0.0
    return torch.where(below, -bx * dx + by * dy - n * dz, res)


def eps_of(p):
    m = torch.clamp(torch.maximum(p[0].abs(), torch.maximum(
        p[1].abs(), p[2].abs())), min=2.0 * GEPSILON)
    return m * GEPSILON


def ggx_d(cos_nh, alpha):
    a2 = alpha * alpha
    c2 = torch.clamp(cos_nh * cos_nh, 0.0, 1.0)
    den = c2 * a2 + (1.0 - c2)
    return a2 / torch.clamp(M_PI * den * den, min=1e-6)


def ggx_g1(cos_n, alpha):
    c2 = torch.clamp(cos_n * cos_n, 0.0, 1.0)
    tan2 = (1.0 - c2) / torch.clamp(c2, min=1e-6)
    return 2.0 / (1.0 + safe_sqrt(1.0 + alpha * alpha * tan2))


def ggx_sample(r1, r2, v, n, rough):
    r2_ = rough * rough
    bx, by = basis(n)
    wox, woy, woz = dot3(v, bx), dot3(v, by), dot3(v, n)
    phi = r1 * M_TWOPI
    cos_t = torch.clamp(safe_sqrt((1.0 - r2) / (1.0 + r2_ * r2_ * r2 - r2)),
                        0.0, 1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    whx, why, whz = sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t
    dwh = wox * whx + woy * why + woz * whz
    return normalize3(bx * (2.0 * dwh * whx - wox)
                      + by * (2.0 * dwh * why - woy)
                      + n * (2.0 * dwh * whz - woz))


def ggx_pdf(l, v, n, rough):
    nv, nl = dot3(n, v), dot3(n, l)
    h = normalize3(v + l)
    nh, hv = dot3(n, h), dot3(h, v)
    pdf = ggx_d(nh, rough * rough) * nh / (4.0 * torch.clamp(hv, min=1e-6))
    return torch.where((nv < 1e-6) | (nl < 1e-6), 1.0, pdf)


def ggx_bsdf(l, v, n, rough):
    nv, nl = dot3(n, v), dot3(n, l)
    a = rough * rough
    h = normalize3(v + l)
    d = ggx_d(dot3(n, h), a)
    g = ggx_g1(nv, a) * ggx_g1(nl, a)
    val = d * g / torch.clamp(4.0 * nv * nl, min=1e-6)
    bad = (dot3(l, n).abs() < 1e-5) | (nv < 1e-6) | (nl < 1e-6)
    return torch.where(bad, 0.0, val)


# ---- the stages ------------------------------------------------------------

def camera_ray(T, xs, ys, sx, sy, mask):
    ft = T['dtype']
    sx, sy, r = rnd4(sx, sy, mask, ft)
    xn = (xs + r[0]) / float(T['width'])
    yn = (ys + r[1]) / float(T['height'])
    p = T['proj_inv']
    nx, ny = 2.0 * xn - 1.0, 2.0 * yn - 1.0
    px = p[0] * nx + p[1] * ny + p[3]
    py = p[4] * nx + p[5] * ny + p[7]
    pz = p[8] * nx + p[9] * ny + p[11]
    pw = p[12] * nx + p[13] * ny + p[15]
    inv_w = 1.0 / torch.where(pw == 0.0, 1.0, pw)
    d = normalize3(torch.stack([px * inv_w, py * inv_w, pz * inv_w]))
    m = T['wv_inv']

    def xf(v):
        return torch.stack([m[4 * k] * v[0] + m[4 * k + 1] * v[1]
                            + m[4 * k + 2] * v[2] + m[4 * k + 3]
                            for k in range(3)])

    o = xf(torch.zeros_like(d))
    return o, normalize3(xf(100.0 * d) - o), sx, sy


def new_sample(T, xs, ys, sx, sy, mask):
    """Fresh lane state of a camera sample (RNG advanced where ``mask``)."""
    o, d, sx, sy = camera_ray(T, xs, ys, sx, sy, mask)
    z = torch.zeros_like(xs)
    return dict(o=o, d=d, flags=torch.zeros_like(sx),
                accum=xs.new_zeros((4,) + xs.shape),
                thr=xs.new_ones((4,) + xs.shape), mis_pdf=z + 1.0,
                hit_pos=torch.zeros_like(d), hit_norm=torch.zeros_like(d),
                hit_uv=torch.zeros_like(d[:2]), hit_lgt=z - 1.0,
                sx=sx, sy=sy)


def trace(T, o, d, tmin, tmax, any_hit=False):
    """Brute force against every triangle: (t, tri, u, v), tri -1 and t
    FLT_MAX on a miss; or the occlusion flags."""
    w = T['woop'].T[:, :, None]                         # [12, T, 1]

    def tf(r, v, w3):
        c = w[4 * r:4 * r + 4]
        return c[0] * v[0] + c[1] * v[1] + c[2] * v[2] + c[3] * w3

    one = torch.ones_like(tmin)
    pox, pdx = tf(0, o, one), tf(0, d, 0.0 * one)
    poy, pdy = tf(1, o, one), tf(1, d, 0.0 * one)
    poz, pdz = tf(2, o, one), tf(2, d, 0.0 * one)
    t = -poz / pdz
    u = pox + t * pdx
    v = poy + t * pdy
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
    if any_hit:
        return ok.any(0)
    tm = torch.where(ok, t, T['far'])
    bt = tm.amin(0)
    ii = torch.arange(tm.shape[0], device=o.device)[:, None]
    li = torch.clamp(torch.where(tm == bt, ii, BIG_I).amin(0),
                     max=tm.shape[0] - 1)
    hit = bt < FLT_MAX
    return (torch.where(hit, bt, T['far']), torch.where(hit, li, -1),
            torch.where(hit, u.gather(0, li[None])[0], 0.0),
            torch.where(hit, v.gather(0, li[None])[0], 0.0))


def stage_trace(T, st, prim):
    live = (st['flags'] & IS_DEAD) == 0
    tmin = torch.zeros_like(st['mis_pdf'])
    tmax = torch.where(live, FLT_MAX, 0.0).to(tmin.dtype)
    t, tri, u, v = trace(T, st['o'], st['d'], tmin, tmax)
    found = t < FLT_MAX * 0.5
    hit_pos = st['o'] + (t * (1.0 - 1e-6)) * st['d']
    k = torch.clamp(tri, min=0)
    wa = 1.0 - u - v
    n = T['tri_n'][:, k].permute(0, 2, 1)               # [3 verts, 3, N]
    uv = T['tri_uv'][:, k].permute(0, 2, 1)             # [3 verts, 2, N]
    hit_norm = normalize3(wa * n[0] + u * n[1] + v * n[2])
    hit_uv = wa * uv[0] + u * uv[1] + v * uv[2]
    mid = T['tri_mat'][k]
    lgt = T['tri_lgt'][k].to(hit_pos.dtype)
    flip = torch.where(dot3(st['d'], hit_norm) > 0.001, -1.0, 1.0).to(
        hit_pos.dtype)
    hit_norm = flip * hit_norm
    flags = torch.where(flip < 0.0, st['flags'] | HAS_INV_NORMAL,
                        st['flags'] & ~HAS_INV_NORMAL)
    flags_hit = (flags & 0xFF000000) | (mid & 0x00FFFFFF)
    prime = torch.where(torch.as_tensor(prim, device=flags.device),
                        PRIME_RAY_MISS, 0)
    flags_miss = st['flags'] | IS_DEAD | OUT_OF_SCENE | prime
    keep = ~live | ~found
    st = dict(st)
    st['flags'] = torch.where(live, torch.where(found, flags_hit, flags_miss),
                              st['flags'])
    st['hit_pos'] = torch.where(keep, st['hit_pos'], hit_pos)
    st['hit_norm'] = torch.where(keep, st['hit_norm'], hit_norm)
    st['hit_uv'] = torch.where(keep, st['hit_uv'], hit_uv)
    st['hit_lgt'] = torch.where(keep, st['hit_lgt'], lgt)
    return st


def tex_color(T, mid, uv):
    """The slot-0 texture's bilinear tap (wrap) where the material has one,
    else white."""
    tid = T['mat_texid'][mid]
    tx = T['texels']
    if tx is None:
        return torch.ones((4,) + uv.shape[1:], dtype=uv.dtype,
                          device=uv.device)
    h, w = tx.shape[0], tx.shape[1]
    ffx = (uv[0] - torch.floor(uv[0])) * float(w) - 0.5
    ffy = (uv[1] - torch.floor(uv[1])) * float(h) - 0.5
    px, py = torch.floor(ffx), torch.floor(ffy)
    fx, fy = ffx - px, ffy - py
    x = torch.where(px < 0.0, float(w - 1), px).to(torch.int64)
    y = torch.where(py < 0.0, float(h - 1), py).to(torch.int64)
    x1 = torch.where(x + 1 >= w, 0, x + 1)
    y1 = torch.where(y + 1 >= h, 0, y + 1)
    c = [tx[yy, xx].T for yy, xx in ((y, x), (y, x1), (y1, x), (y1, x1))]
    tap = (c[0] * ((1.0 - fx) * (1.0 - fy)) + c[1] * (fx * (1.0 - fy))
           + c[2] * ((1.0 - fx) * fy) + c[3] * (fx * fy))
    return torch.where(tid >= 0, tap, 1.0)


def mat_params(T, mid, tex):
    base = T['mat_base'][mid].T * tex
    metal = T['mat_metal'][mid].T * base
    rough = torch.clamp(1.0 - T['mat_gloss'][mid], 0.0, 1.0)
    metalness = torch.where(T['mat_cflags'][mid] == METAL, 1.0,
                            T['mat_alpha'][mid])
    return base, metal, rough, metalness


def mat_eval(T, mid, tex, l, v, n):
    """The GLTF lobes (Lambert, metal) at (l, v): (val [4, N], pdf)."""
    base, metal, rough, metalness = mat_params(T, mid, tex)
    lam_pdf = dot3(l, n).abs() * INV_PI
    is_rough = rough != 0.0
    g_val = torch.where(is_rough, ggx_bsdf(l, v, n, rough), 0.0)
    g_pdf = torch.where(is_rough, ggx_pdf(l, v, n, rough), 0.0)
    spec = g_val * metal       # the Fresnel IOR is off (0): the color
    val = metalness * spec + (1.0 - metalness) * (INV_PI * base)
    pdf = metalness * g_pdf + (1.0 - metalness) * lam_pdf
    gltf = T['mat_kind'][mid] == MK_GLTF
    return torch.where(gltf, val, 0.0), torch.where(gltf, pdf, 0.0)


def mat_sample(T, mid, tex, r, v, n):
    base, metal, rough, metalness = mat_params(T, mid, tex)
    lam_dir = cosine_sample(r[0], r[1], n)
    lam_pdf = dot3(lam_dir, n).abs() * INV_PI
    smooth = rough == 0.0
    refl = -v - 2.0 * dot3(-v, n) * n
    cos_out = dot3(refl, n)
    mirror = torch.where(cos_out <= 1e-6, 0.0,
                         1.0 / torch.clamp(cos_out, min=1e-6))
    g_dir_r = ggx_sample(r[0], r[1], v, n, rough)
    g_dir = torch.where(smooth, refl, g_dir_r)
    g_pdf = torch.where(smooth, 1.0, ggx_pdf(g_dir_r, v, n, rough))
    g_val = torch.where(smooth, mirror, ggx_bsdf(g_dir_r, v, n, rough))
    pick_metal = r[2] < metalness
    metal_bsdf = g_val * metalness * metal
    lam_bsdf = (INV_PI * (1.0 - metalness)) * base
    pdf_sel = torch.where(pick_metal, metalness, 1.0 - metalness)
    flags = torch.where(pick_metal, torch.where(smooth, EVENT_S, HAS_NON_SPEC),
                        HAS_NON_SPEC)
    gltf = T['mat_kind'][mid] == MK_GLTF
    up = torch.zeros_like(lam_dir)
    up[1] = 1.0
    return dict(dir=torch.where(gltf, torch.where(pick_metal, g_dir, lam_dir),
                                up),
                val=torch.where(gltf, torch.where(pick_metal, metal_bsdf,
                                                  lam_bsdf), 0.0),
                pdf=torch.where(gltf, torch.where(pick_metal, g_pdf, lam_pdf)
                                * pdf_sel, 1.0),
                flags=torch.where(gltf, flags, 0))


def light_rows(T, lid):
    return dict(kind=T['l_kind'][lid], dist=T['l_dist'][lid],
                pos=T['l_pos'][lid].T, norm=T['l_norm'][lid].T,
                rot=T['l_rot'][lid].T, size=T['l_size'][lid].T,
                pdf_a=T['l_pdf_a'][lid], color=T['l_color'][lid].T,
                mult=T['l_mult'][lid])


def light_sample(ld, r0, r1):
    off_x = 2.0 * (r0 - 0.5) * ld['size'][0]
    off_z = 2.0 * (r1 - 0.5) * ld['size'][1]
    m = ld['rot']
    zero = torch.zeros_like(off_x)
    rot = torch.stack([m[3 * k] * off_x + m[3 * k + 1] * zero
                       + m[3 * k + 2] * off_z for k in range(3)])
    area_pos = rot + ld['pos'] + eps_of(ld['pos']) * ld['norm']
    theta = M_TWOPI * r0
    phi = acos_poly(torch.clamp(1.0 - 2.0 * r1, -1.0, 1.0))
    sph_dir = torch.stack([torch.sin(phi) * torch.cos(theta),
                           torch.sin(phi) * torch.sin(theta), torch.cos(phi)])
    sph_pos = ld['pos'] + (ld['size'][0] * 1.000001) * sph_dir
    sph_norm = normalize3(sph_pos - ld['pos'])
    is_sph, is_pt = ld['kind'] == L_SPHERE, ld['kind'] == L_POINT
    pos = torch.where(is_sph, sph_pos, torch.where(is_pt, ld['pos'], area_pos))
    norm = torch.where(is_sph, sph_norm, ld['norm'])
    return pos, norm, is_pt & (ld['dist'] == D_OMNI)


def light_pdf_w(ld, at, ray_dir, lpos, lnorm):
    diff = at - lpos
    dist = torch.sqrt(dot3(diff, diff))
    cos_tmp = dot3(ray_dir, -lnorm)
    cos_sph = dot3(normalize3(lpos - at), lnorm).abs()
    cos_pt = torch.where(ld['dist'] == D_LAMBERT,
                         torch.clamp(cos_tmp, min=0.0), 1.0)
    cos_area = torch.clamp(cos_tmp, min=0.0)
    cos_v = torch.where(ld['kind'] == L_SPHERE, cos_sph,
                        torch.where(ld['kind'] == L_POINT, cos_pt, cos_area))
    return (ld['pdf_a'] * dist * dist) / torch.clamp(cos_v, min=1e-30)


def mis(a, b):
    pa = torch.where(torch.isfinite(a), a.abs(), 0.0)
    pb = torch.where(torch.isfinite(b), b.abs(), 0.0)
    w = pa / torch.clamp(pa + pb, min=1e-30)
    return torch.where(torch.isfinite(w), w, 0.0)


def shade(T, st, active, prim):
    """Next event estimation and the next bounce at the lanes' hits."""
    ft = T['dtype']
    mid = st['flags'] & 0x00FFFFFF
    mid = torch.clamp(mid, 0, T['mat_kind'].shape[0] - 1)
    tex = tex_color(T, mid, st['hit_uv'])
    nl = float(T['n_lights'])
    # next event estimation
    sx, sy, rid = rnd1(st['sx'], st['sy'], active, ft)
    sx, sy, r4 = rnd4(sx, sy, active, ft)
    lid = torch.minimum(torch.floor(rid * nl), torch.full_like(rid, nl - 1.0)
                        ).to(torch.int64)
    ld = light_rows(T, lid)
    hp, hn = st['hit_pos'], st['hit_norm']
    lpos, lnorm, omni = light_sample(ld, r4[0], r4[1])
    dd = hp - lpos
    dist = torch.sqrt(dot3(dd, dd))
    sdir = normalize3(lpos - hp)
    offs = torch.clamp(torch.maximum(hp[0], torch.maximum(hp[1], hp[2])),
                       min=1.0) * 5e-6
    spos = hp + hn * offs
    need = active & ((dot3(sdir, lnorm) < 0.0) | omni)
    occ = trace(T, spos, sdir, torch.zeros_like(dist),
                torch.where(need, dist * 0.9995, 0.0), any_hit=True)
    bval, bpdf = mat_eval(T, mid, tex, sdir, -st['d'], hn)
    cos_out = torch.clamp(dot3(sdir, hn), min=0.0)
    lpdf = (1.0 / max(nl, 1.0)) * light_pdf_w(ld, spos, sdir, lpos, lnorm)
    w = torch.where(ld['kind'] == L_POINT, 1.0, mis(lpdf, bpdf))
    direct = (ld['color'] * ld['mult']) * bval / torch.clamp(lpdf, min=1e-30) \
        * (cos_out * w)
    direct = torch.where(need & ~occ, direct, 0.0)

    # a light hit ends the path
    is_light = T['mat_kind'][mid] == MK_LIGHT
    hlid = st['hit_lgt'].to(torch.int64)
    has_l = hlid >= 0
    ldh = light_rows(T, torch.clamp(hlid, min=0))
    atten = torch.where((dot3(st['d'], ldh['norm']) < 0.0)
                        | (ldh['kind'] == L_SPHERE), 1.0, 0.0)
    lint = torch.where(has_l, (ldh['color'] * ldh['mult']) * atten, 0.0)
    lpdf_h = (1.0 / max(nl, 1.0)) * light_pdf_w(ldh, st['o'], st['d'], hp, hn)
    wl = mis(st['mis_pdf'], lpdf_h)
    wl = torch.where(st['mis_pdf'] <= 0.0, 1.0, wl)
    wl = torch.where(torch.as_tensor(prim, device=wl.device), 1.0, wl)
    wl = torch.where(has_l, wl, 1.0)
    l_branch = active & is_light
    acc_light = st['accum'] + st['thr'] * lint * wl

    # a surface bounce
    surf = active & ~is_light
    sx, sy, r = rnd4(sx, sy, surf, ft)
    smp = mat_sample(T, mid, tex, r, -st['d'], hn)
    bxdf = smp['val'] / torch.clamp(smp['pdf'], min=1e-20)
    cos_t = dot3(smp['dir'], hn).abs()
    new_pdf = torch.where((smp['flags'] & EVENT_S) != 0, -1.0, smp['pdf'])
    sign = torch.where(dot3(smp['dir'], hn) < 0.0, -1.0, 1.0).to(ft)
    new_pos = hp + (sign * eps_of(hp)) * hn
    nflags = (st['flags'] & ~FIRST_NON_SPEC) | smp['flags']
    first_ns = (((st['flags'] & HAS_NON_SPEC) == 0)
                & ((nflags & HAS_NON_SPEC) != 0))
    nflags = torch.where(first_ns, nflags | FIRST_NON_SPEC, nflags)
    st = dict(st)
    st['accum'] = torch.where(l_branch, acc_light, torch.where(
        surf, st['accum'] + st['thr'] * direct, st['accum']))
    st['thr'] = torch.where(surf, st['thr'] * cos_t * bxdf, st['thr'])
    st['flags'] = torch.where(l_branch, st['flags'] | IS_DEAD | HIT_LIGHT,
                              torch.where(surf, nflags, st['flags']))
    st['o'] = torch.where(surf, new_pos, st['o'])
    st['d'] = torch.where(surf, smp['dir'], st['d'])
    st['mis_pdf'] = torch.where(surf, new_pdf, st['mis_pdf'])
    st['sx'], st['sy'] = sx, sy
    return st


def finished(T, st):
    """A finished sample's contribution [4, N]: the flat environment on a
    miss, the camera response 1 and exposure 1."""
    out = (st['flags'] & OUT_OF_SCENE) != 0
    return torch.where(out, st['accum'] + st['thr'] * T['env'][:, None],
                       st['accum'])


def restart(T, xs, ys, st, mask):
    fresh = new_sample(T, xs, ys, st['sx'], st['sy'], mask)
    return {k: fresh[k] if k in ('sx', 'sy') else
            torch.where(mask, fresh[k], st[k]) for k in st}


def _iteration(T, xs, ys, S):
    """One persistent-lane iteration on the lane state ``S`` (a flat dict
    of tensors: the sample's state, the lane's sum ``acc``, its finished
    samples ``done`` and the in-flight sample's bounces ``bcnt``)."""
    st = {k: v for k, v in S.items() if k not in ('acc', 'done', 'bcnt')}
    acc, done, bcnt = S['acc'], S['done'], S['bcnt']
    # flush the lanes that missed at the last trace, start their next sample
    dead0 = (st['flags'] & IS_DEAD) != 0
    acc = acc + torch.where(dead0, finished(T, st), 0.0)
    done = done + dead0.to(torch.int64)
    st = restart(T, xs, ys, st, dead0)
    bcnt = torch.where(dead0, 0, bcnt)
    # shade the others; the depth ends a path
    act = ~dead0
    st = shade(T, st, act, bcnt == 0)
    bcnt = bcnt + act.to(torch.int64)
    trunc = act & (bcnt >= T['depth']) & ((st['flags'] & IS_DEAD) == 0)
    st['flags'] = torch.where(trunc, st['flags'] | IS_DEAD, st['flags'])
    # flush the shade's deaths, start their next sample; trace every lane
    dead1 = ((st['flags'] & IS_DEAD) != 0) & act
    acc = acc + torch.where(dead1, finished(T, st), 0.0)
    done = done + dead1.to(torch.int64)
    st = restart(T, xs, ys, st, dead1)
    bcnt = torch.where(dead1, 0, bcnt)
    st = stage_trace(T, st, bcnt == 0)
    return dict(st, acc=acc, done=done, bcnt=bcnt)


def _replayed(step, S, n: int, warm: int = 2):
    """``n`` steps of ``step`` on ``S``: a few eagerly, the rest as replays
    of one CUDA graph of a step (the same kernels, without launching each
    from Python)."""
    for _ in range(min(warm, n)):
        S = step(S)
    if n <= warm:
        return S
    static = {k: v.clone() for k, v in S.items()}
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            out = step(static)
            for k, v in static.items():
                v.copy_(out[k])
    except RuntimeError as e:       # capture refused: the same steps eagerly
        print(f'reference: no CUDA graph ({e}); stepping eagerly',
              file=sys.stderr)
        for _ in range(n - warm):
            S = step(S)
        return S
    for _ in range(n - warm):
        g.replay()
    torch.cuda.synchronize()
    return static


def render_pixels(T, pixel_ids, iters: int):
    """The frame's values at ``pixel_ids`` after ``iters`` persistent-lane
    iterations: (value [K, 4], finished samples [K])."""
    dev = pixel_ids.device
    ft = T['dtype']
    xs = torch.remainder(pixel_ids, T['width']).to(ft)
    ys = torch.div(pixel_ids, T['width'], rounding_mode='floor').to(ft)
    sx, sy = seed_state(pixel_ids)
    st = new_sample(T, xs, ys, sx, sy, None)
    st = stage_trace(T, st, True)
    zero = torch.zeros_like(pixel_ids, dtype=torch.int64)
    S = dict(st, acc=torch.zeros((4,) + xs.shape, dtype=ft, device=dev),
             done=zero, bcnt=zero.clone())

    def step(S):
        return _iteration(T, xs, ys, S)

    if dev.type == 'cuda':
        S = _replayed(step, S, iters - 1)
    else:
        for _ in range(iters - 1):
            S = step(S)
    st = {k: v for k, v in S.items() if k not in ('acc', 'done', 'bcnt')}
    dead = (st['flags'] & IS_DEAD) != 0
    acc = S['acc'] + torch.where(dead, finished(T, st), 0.0)
    done = S['done'] + dead.to(torch.int64)
    return (acc / torch.clamp(done.to(ft), min=1.0)).T, done


BLOCK = 8192     # pixels a block of the reference takes at once


def expected(desc: dict, pixel_ids, frame: dict, device, dtype=torch.float32):
    """The frame's values [K, 4] at ``pixel_ids`` (int64 on ``device``),
    after the persistent-lane iterations the frame ran (``frame['iters']``),
    worked out in blocks of ``BLOCK`` pixels."""
    T = tables(desc, device, dtype)
    return torch.cat([render_pixels(T, blk, int(frame['iters']))[0]
                      for blk in pixel_ids.split(BLOCK)])
