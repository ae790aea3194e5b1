"""Plain reference of a frame of the batched path tracer (the city class).

It follows the estimator of HydraCore3's ``integrator_pt.cpp`` in the
form the program's batched route runs it, pass by pass: each pixel draws
one sample a pass from its own random stream (``crandom.h``), which the
next pass continues; a sample is the camera ray, then per bounce the
nearest hit, next event estimation (a uniformly chosen light: the rect
light or the importance-sampled sky, a shadow any-hit, MIS) and a GLTF
(Lambert) sample with its slot-0 texture tap, and after the last bounce
the sky on a miss, weighted by MIS.  The frame is the sum of the passes
over their count.

It imports nothing of the program.  ``tables`` derives every table from
the plain description (``scenes/city.py``): world-space triangles and
their Woop rows, shading rows, materials with their texture transforms,
the decoded texels, the lights, the sky's importance table and the camera
matrices.  The trace is brute force over every triangle, in blocks.
``dtype`` sets the precision of every float: float32 is the reference,
bfloat16 the control.  Vectors are on the last axis.

Supported: MIS path tracing, Lambert GLTF materials with a bilinear,
wrapped slot-0 texture under a 2 x 4 texture transform, one area-light
emitter, rect lights, a lat-long sky with its importance table, a pinhole
camera.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import box_regen as BX

M_PI = math.pi
INV_PI = 1.0 / math.pi
M_TWOPI = 2.0 * math.pi
FLT_MAX = 3.4e38
GEPSILON = 1e-5
TRI_BLOCK = 8192       # triangles a brute-force block tests at once

IS_DEAD, OUT_OF_SCENE, HIT_LIGHT = BX.IS_DEAD, BX.OUT_OF_SCENE, BX.HIT_LIGHT
HAS_NON_SPEC, HAS_INV_NORMAL = BX.HAS_NON_SPEC, BX.HAS_INV_NORMAL
PRIME_RAY_MISS, FIRST_NON_SPEC = BX.PRIME_RAY_MISS, BX.FIRST_NON_SPEC


# ---- last-axis vector helpers ----------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                       min=1e-30))


def eps_of(p):
    return (torch.clamp(p[..., :3].abs().amax(-1), min=2.0 * GEPSILON)
            * GEPSILON)


def basis(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    pos = nz >= 0
    sign = torch.where(pos, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([torch.where(pos, nx * nx * a, -nx * nx * a) + 1.0,
                     torch.where(pos, b, -b), torch.where(pos, -nx, nx)], -1)
    t = torch.stack([b, ny * ny * a + sign, -ny], -1)
    return s, t


def cosine_sample(r1, r2, n):
    sin_phi = torch.sin(M_TWOPI * r1)
    cos_phi = torch.cos(M_TWOPI * r1)
    cos_theta = torch.pow(torch.clamp(1.0 - r2, min=1e-20), 1.0 / (1.0 + 1.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    dx = (sin_theta * cos_phi)[..., None]
    dy = (sin_theta * sin_phi)[..., None]
    dz = cos_theta[..., None]
    bx, by = basis(n)
    res = bx * dx + by * dy + n * dz
    inv_sign = torch.where(dot(n, n) > 0.0, 1.0, -1.0).to(n.dtype)
    below = inv_sign * dot(res, n) < 0.0
    return torch.where(below[..., None], -bx * dx + by * dy - n * dz, res)


def rows_2x4(r0, r1, v):
    return torch.stack([r0[..., 0] * v[..., 0] + r0[..., 1] * v[..., 1]
                        + r0[..., 3],
                        r1[..., 0] * v[..., 0] + r1[..., 1] * v[..., 1]
                        + r1[..., 3]], -1)


def to_sphere_tc(d):
    """A direction's lat-long texture coordinate and sin(theta)."""
    theta = torch.arccos(torch.clamp(-d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 0], d[..., 2])
    phi = torch.where(phi < 0.0, phi + M_TWOPI, phi)
    tc = torch.stack([torch.clamp(phi * 0.5 * INV_PI, 0.0, 1.0),
                      torch.clamp(theta * INV_PI, 0.0, 1.0)], -1)
    return tc, torch.sqrt(torch.clamp(1.0 - d[..., 1] * d[..., 1], min=0.0))


def from_sphere_tc(tc):
    phi = tc[..., 0] * 2.0 * M_PI
    theta = tc[..., 1] * M_PI
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), -torch.cos(theta),
                        st * torch.cos(phi)], -1), st


def mis(a, b):
    return BX.mis(a, b)


# ---- the tables ----------------------------------------------------------

def _tex_rows(matrix):
    r0 = np.array([1, 0, 0, 0], np.float32)
    r1 = np.array([0, 1, 0, 0], np.float32)
    if matrix is not None:
        v = [float(x) for x in matrix]
        r0, r1 = np.array(v[0:4], np.float32), np.array(v[4:8], np.float32)
    return r0, r1


def _decode(t):
    t = np.asarray(t)
    if t.dtype != np.uint8:
        img = np.asarray(t, np.float32)
        a = np.ones(img.shape[:2] + (1,), np.float32)
        return img if img.shape[2] == 4 else np.concatenate([img, a], -1)
    img = t.astype(np.float32) / 255.0
    img = np.power(img, 2.2, dtype=np.float32)
    return np.concatenate([img, np.ones(img.shape[:2] + (1,), np.float32)],
                          -1)


def tables(desc: dict, device, dtype=torch.float32) -> dict:
    """Every table of the frame, derived from the description."""
    meshes = list(desc['meshes'])
    mats = [dict(m) for m in desc['materials']]
    if len(desc.get('area_lights', ())) != 1:
        raise NotImplementedError('one area light')
    L = desc['area_lights'][0]
    mats.append(dict(light=True))
    hw, hl = float(L['half_width']), float(L['half_length'])
    m = np.asarray(L['matrix'], np.float32)
    pos = np.array([[-hw, 0, -hl], [hw, 0, -hl], [hw, 0, hl], [-hw, 0, hl]],
                   np.float32)
    meshes.append(dict(pos=pos @ m[:3, :3].T + m[:3, 3],
                       indices=np.array([[0, 1, 2], [0, 2, 3]]),
                       mat_indices=np.array([len(mats) - 1] * 2),
                       norm=np.tile(np.float32([[0, -1, 0]]), (4, 1))
                       @ np.linalg.inv(m).T.astype(np.float32)[:3, :3].T,
                       light_id=0))
    nrm = m @ np.array([0, -1, 0, 0], np.float32)
    sc = [float(np.linalg.norm(m[:3, k])) for k in range(3)]
    size = np.array([hl, hw], np.float32)
    rect = dict(pos=(m @ np.float32([0, 0, 0, 1]))[:3],
                norm=(nrm / max(np.linalg.norm(nrm[:3]), 1e-20))[:3],
                rot=m[:3, :3], size=size,
                pdf_a=1.0 / (4.0 * size[0] * size[1] * sc[0] * sc[2]),
                color=BX._color4(L['color']), mult=float(L['multiplier']))

    v0s, e1s, e2s, shs, mids, lids = [], [], [], [], [], []
    for mm in meshes:
        p = np.asarray(mm['pos'], np.float32)
        ind = np.asarray(mm['indices'], np.int64).reshape(-1, 3)
        nr = (BX._face_normals(p, ind) if mm.get('norm') is None
              else np.asarray(mm['norm'], np.float32))
        uv = (np.zeros((len(p), 2), np.float32) if mm.get('texc') is None
              else np.asarray(mm['texc'], np.float32))
        v = [p[ind[:, c]] for c in range(3)]
        v0s.append(v[0])
        e1s.append(v[1] - v[0])
        e2s.append(v[2] - v[0])
        # per vertex (norm3, u, tang3 = 0, v), as a shading row holds them
        sh = np.zeros((len(ind), 3, 8), np.float32)
        for c in range(3):
            sh[:, c, 0:3] = nr[ind[:, c]]
            sh[:, c, 3] = uv[ind[:, c], 0]
            sh[:, c, 7] = uv[ind[:, c], 1]
        shs.append(sh)
        mids.append(np.asarray(mm['mat_indices'], np.int64))
        lids.append(np.full(len(ind), mm.get('light_id', -1), np.int64))
    v0, e1, e2 = (np.concatenate(a) for a in (v0s, e1s, e2s))

    texels = [_decode(t) for t in desc['textures']]
    M = len(mats)
    is_light = np.array([bool(md.get('light')) for md in mats])
    base = np.zeros((M, 4), np.float32)
    texid = np.full(M, -1, np.int64)
    r0s = np.zeros((M, 4), np.float32)
    r1s = np.zeros((M, 4), np.float32)
    for i, md in enumerate(mats):
        if md.get('light'):
            continue
        if md.get('reflectivity'):
            raise NotImplementedError('Lambert materials only')
        base[i] = BX._color4(md.get('diffuse_color', (0.5, 0.5, 0.5)))
        texid[i] = md.get('diffuse_tex_id', -1)
        r0s[i], r1s[i] = _tex_rows(md.get('diffuse_tex_matrix'))

    env = desc['env']
    sky = texels[env['tex_id']]
    lum = np.max(sky[..., :3], axis=-1).astype(np.float64)
    lum = np.maximum(lum, 0.1 * lum.mean())
    prefix = np.zeros(lum.size + 1, np.float32)
    prefix[1:] = np.cumsum(lum.reshape(-1))

    cam = desc['camera']
    aspect = float(desc['width']) / float(desc['height'])
    proj_inv = np.linalg.inv(BX._perspective(cam['fov'], aspect, cam['near'],
                                             cam['far'])).astype(np.float32)
    wv_inv = np.linalg.inv(BX._look_at(cam['pos'], cam['look_at'],
                                       cam['up'])).astype(np.float32)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device
                               ).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    # the material textures side by side in one pool; slot k at off[k]
    offs = np.cumsum([0] + [t.shape[0] * t.shape[1] for t in texels])
    return dict(
        dtype=dtype, width=int(desc['width']), height=int(desc['height']),
        depth=int(desc['depth']), woop=f(BX._woop(v0, e1, e2)),
        shade=f(np.concatenate(shs)), tri_mat=i(np.concatenate(mids)),
        tri_lgt=i(np.concatenate(lids)),
        mat_light=torch.as_tensor(is_light, device=device), mat_base=f(base),
        mat_texid=i(texid), mat_row0=f(r0s), mat_row1=f(r1s),
        pool=f(np.concatenate([t.reshape(-1, 4) for t in texels])),
        tex_off=i(offs[:-1]), tex_w=i([t.shape[1] for t in texels]),
        tex_h=i([t.shape[0] for t in texels]),
        n_lights=2, rect={k: (f(v) if k not in ('mult', 'pdf_a') else v)
                          for k, v in rect.items()},
        env_color=f(BX._color4(env.get('color', (1.0, 1.0, 1.0)))),
        env_mult=float(env.get('multiplier', 1.0)),
        env_tex=int(env['tex_id']), env_w=sky.shape[1], env_h=sky.shape[0],
        env_prefix=torch.as_tensor(prefix, device=device).to(dtype),
        proj_inv=f(proj_inv), wv_inv=f(wv_inv), far=f(FLT_MAX))


# ---- texture taps -----------------------------------------------------------

def tap(T, slot, uv):
    """Bilinear, wrapped taps of texture ``slot`` [N] at ``uv`` [N, 2]."""
    off, w, h = T['tex_off'][slot], T['tex_w'][slot], T['tex_h'][slot]
    wf, hf = w.to(uv.dtype), h.to(uv.dtype)
    nu = uv[..., 0] - torch.floor(uv[..., 0])
    nv = uv[..., 1] - torch.floor(uv[..., 1])
    ffx, ffy = nu * wf - 0.5, nv * hf - 0.5
    px, py = torch.floor(ffx), torch.floor(ffy)
    fx, fy = (ffx - px)[..., None], (ffy - py)[..., None]
    px, py = px.to(torch.int64), py.to(torch.int64)
    w1, h1 = w - 1, h - 1

    def wx(ix):
        return torch.where(ix < 0, w1, torch.where(ix > w1, 0, ix))

    def wy(iy):
        return torch.where(iy < 0, h1, torch.where(iy > h1, 0, iy))

    def fetch(ix, iy):
        return T['pool'][off + iy * w + ix]

    x0, x1, y0, y1 = wx(px), wx(px + 1), wy(py), wy(py + 1)
    return (fetch(x0, y0) * (1 - fx) * (1 - fy) + fetch(x1, y0) * fx * (1 - fy)
            + fetch(x0, y1) * (1 - fx) * fy + fetch(x1, y1) * fx * fy)


def mat_tex(T, mid, uv):
    """The slot-0 texel of each lane's material (white without one)."""
    tid = T['mat_texid'][mid]
    tc = rows_2x4(T['mat_row0'][mid], T['mat_row1'][mid], uv)
    col = tap(T, torch.clamp(tid, min=0), tc)
    return torch.where((tid >= 0)[..., None], col, 1.0)


# ---- the sky ---------------------------------------------------------------

def sky_sample(T, r3):
    """SampleMap2D on the sky's prefix table: (tex coord [N, 2], pdf)."""
    a = T['env_prefix']
    sx, sy = T['env_w'], T['env_h']
    n = sx * sy
    total = a[n]
    x = r3[..., 2] * total
    lo = torch.zeros(r3.shape[:-1], dtype=torch.int64, device=r3.device)
    hi = torch.full_like(lo, n - 1)
    for _ in range(max(int(a.shape[0] - 1).bit_length(), 1)):
        mid = torch.div(lo + hi, 2, rounding_mode='floor')
        right = a[mid] < x
        lo = torch.where(right, torch.minimum(mid + 1, hi), lo)
        hi = torch.where(right, hi, mid)
    pixel = lo - 1 + (a[lo] < x).to(lo.dtype)
    pixel = torch.clamp(torch.clamp(pixel, min=0), max=n - 1)
    pdf = (a[pixel + 1] - a[pixel]) / torch.clamp(total, min=1e-30)
    yp = torch.div(pixel, sx, rounding_mode='floor')
    xp = pixel - yp * sx
    fw, fh = float(sx), float(sy)
    tx = (1.0 / fw) * ((xp.to(r3.dtype) + 0.5)
                       + (r3[..., 0] * 2.0 - 1.0) * 0.5)
    ty = (1.0 / fh) * ((yp.to(r3.dtype) + 0.5)
                       + (r3[..., 1] * 2.0 - 1.0) * 0.5)
    return torch.stack([tx, ty], -1), pdf * fw * fh


def sky_pdf(T, tc):
    a = T['env_prefix']
    sx, sy = T['env_w'], T['env_h']
    fw, fh = float(sx), float(sy)
    tx = tc[..., 0] - torch.floor(tc[..., 0])
    ty = tc[..., 1] - torch.floor(tc[..., 1])
    px = torch.clamp(torch.clamp((fw * tx - 0.5).to(torch.int64), min=0),
                     max=sx - 1)
    py = torch.clamp(torch.clamp((fh * ty - 0.5).to(torch.int64), min=0),
                     max=sy - 1)
    off = py * sx + px
    return (a[off + 1] - a[off]) * fw * fh / torch.clamp(a[sx * sy],
                                                         min=1e-30)


def sky_color(T, d):
    """The sky's radiance toward ``d`` on a miss (its color times its
    texel) and its pdf for MIS."""
    tc, st = to_sphere_tc(d)
    pdf = sky_pdf(T, tc) / (2.0 * M_PI * M_PI
                            * torch.clamp(st.abs(), min=1e-20))
    pdf = torch.where(st != 0.0, pdf, 1.0)
    slot = torch.full(d.shape[:-1], T['env_tex'], dtype=torch.int64,
                      device=d.device)
    return T['env_color'] * tap(T, slot, tc), pdf


# ---- a pass ----------------------------------------------------------------

def trace(T, o, d, tmin, tmax, any_hit=False):
    """Brute force over every triangle in blocks: (t, tri, u, v) or the
    occlusion flags."""
    N = o.shape[0]
    ft = o.dtype
    best_t = T['far'].expand(N).clone()
    best_i = torch.full((N,), -1, dtype=torch.int64, device=o.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    occ = torch.zeros(N, dtype=torch.bool, device=o.device)
    W = T['woop']
    for lo in range(0, W.shape[0], TRI_BLOCK):
        w = W[lo:lo + TRI_BLOCK].T[:, :, None]           # [12, B, 1]

        def tf(r, v, w3):
            c = w[4 * r:4 * r + 4]
            return c[0] * v[:, 0] + c[1] * v[:, 1] + c[2] * v[:, 2] + c[3] * w3

        po = [tf(r, o, 1.0) for r in range(3)]
        pd = [tf(r, d, 0.0) for r in range(3)]
        t = -po[2] / pd[2]
        u = po[0] + t * pd[0]
        v = po[1] + t * pd[1]
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
        if any_hit:
            occ = occ | ok.any(0)
            continue
        tm = torch.where(ok, t, T['far'])
        bt, li = tm.min(0)
        closer = bt < best_t
        best_u = torch.where(closer, u.gather(0, li[None])[0], best_u)
        best_v = torch.where(closer, v.gather(0, li[None])[0], best_v)
        best_i = torch.where(closer, lo + li, best_i)
        best_t = torch.where(closer, bt, best_t)
    return occ if any_hit else (best_t, best_i, best_u, best_v)


def camera(T, ids, sx, sy):
    ft = T['dtype']
    sx, sy, r = BX.rnd4(sx, sy, None, ft)
    r = r.T
    xs = torch.remainder(ids, T['width'])
    ys = torch.div(ids, T['width'], rounding_mode='floor')
    x = (xs.to(ft) + r[:, 0]) / float(T['width'])
    y = (ys.to(ft) + r[:, 1]) / float(T['height'])
    p = T['proj_inv'].reshape(4, 4)
    nx, ny = 2.0 * x - 1.0, 2.0 * y - 1.0
    rows = [p[k, 0] * nx + p[k, 1] * ny + p[k, 3] for k in range(4)]
    d = normalize(torch.stack(rows[:3], -1) / rows[3][:, None])
    m = T['wv_inv'].reshape(4, 4)

    def xf(v):
        return (v[..., None, :] * m[:3, :3]).sum(-1) + m[:3, 3]

    o = xf(torch.zeros_like(d))
    return o, normalize(xf(d * 100.0 + torch.zeros_like(d)) - o), sx, sy


def sample(T, ids, sx, sy):
    """One pass: each pixel's next sample, [N, 4], and its stream."""
    ft = T['dtype']
    N = ids.shape[0]
    dev = ids.device
    o, d, sx, sy = camera(T, ids, sx, sy)
    flags = torch.zeros(N, dtype=torch.int64, device=dev)
    acc = torch.zeros((N, 4), dtype=ft, device=dev)
    thr = torch.ones((N, 4), dtype=ft, device=dev)
    mis_pdf = torch.ones(N, dtype=ft, device=dev)
    hp = torch.zeros((N, 3), dtype=ft, device=dev)
    hn = torch.zeros_like(hp)
    huv = torch.zeros((N, 2), dtype=ft, device=dev)
    hlgt = torch.full((N,), -1, dtype=torch.int64, device=dev)
    nl = T['n_lights']
    sel = 1.0 / float(nl)
    R = T['rect']
    for b in range(T['depth']):
        # nearest hit
        live = (flags & IS_DEAD) == 0
        t, tri, u, v = trace(T, o, d, torch.zeros_like(mis_pdf),
                             torch.where(live, FLT_MAX, 0.0).to(ft))
        found = tri >= 0
        k = torch.clamp(tri, min=0)
        sh = T['shade'][k]                                # [N, 3, 8]
        data = ((1.0 - u - v)[:, None] * sh[:, 0] + u[:, None] * sh[:, 1]
                + v[:, None] * sh[:, 2])
        n_hit = normalize(data[:, 0:3])
        uv_hit = torch.stack([data[:, 3], data[:, 7]], -1)
        hit_t = torch.where(found, t, T['far'])
        p_hit = o + (hit_t * (1.0 - 1e-6))[:, None] * d
        flip = torch.where(dot(d, n_hit) > 0.001, -1.0, 1.0).to(ft)
        n_hit = flip[:, None] * n_hit
        fl = torch.where(flip < 0.0, flags | HAS_INV_NORMAL,
                         flags & ~HAS_INV_NORMAL)
        fl_hit = (fl & 0xFF000000) | (T['tri_mat'][k] & 0x00FFFFFF)
        miss = IS_DEAD | OUT_OF_SCENE | (PRIME_RAY_MISS if b == 0 else 0)
        flags = torch.where(live, torch.where(found, fl_hit, flags | miss),
                            flags)
        keep = ~live | ~found
        hp = torch.where(keep[:, None], hp, p_hit)
        hn = torch.where(keep[:, None], hn, n_hit)
        huv = torch.where(keep[:, None], huv, uv_hit)
        hlgt = torch.where(keep, hlgt, T['tri_lgt'][k])

        mid = torch.clamp(flags & 0x00FFFFFF, 0, T['mat_base'].shape[0] - 1)
        tex = mat_tex(T, mid, huv)
        base = T['mat_base'][mid] * tex
        is_light = T['mat_light'][mid]

        # next event estimation
        live = (flags & IS_DEAD) == 0
        sx, sy, rid = BX.rnd1(sx, sy, live, ft)
        sx, sy, r4 = BX.rnd4(sx, sy, live, ft)
        r4 = r4.T
        lid = torch.clamp((rid * nl).to(torch.int64), max=nl - 1)
        is_env = lid == 1
        off = 2.0 * (r4[:, :2] - 0.5) * R['size']
        local = torch.stack([off[:, 0], torch.zeros_like(off[:, 0]),
                             off[:, 1]], -1)
        l_rect = ((local[..., None, :] * R['rot']).sum(-1) + R['pos']
                  + eps_of(R['pos'])[..., None] * R['norm'])
        tcs, map_pdf = sky_sample(T, r4[:, :3])
        sdir_env, st = from_sphere_tc(tcs)
        env_pdf = map_pdf / (2.0 * M_PI * M_PI
                             * torch.clamp(st.abs(), min=1e-20))
        lpos = torch.where(is_env[:, None], hp + sdir_env * 1000.0, l_rect)
        lnorm = torch.where(is_env[:, None], sdir_env, R['norm'].expand_as(hp))
        dist = torch.sqrt(((hp - lpos) ** 2).sum(-1))
        sdir = normalize(lpos - hp)
        offs = torch.clamp(hp[..., :3].amax(-1), min=1.0) * 5e-6
        spos = hp + hn * offs[:, None]
        need = live & ((dot(sdir, lnorm) < 0.0) | is_env)
        occ = trace(T, spos, sdir, torch.zeros_like(dist),
                    torch.where(need, dist * 0.9995, 0.0), any_hit=True)
        lam_pdf = dot(sdir, hn).abs() * INV_PI
        bval = torch.where(is_light[:, None], 0.0, INV_PI * base)
        bpdf = torch.where(is_light, 0.0, lam_pdf)
        cos_out = torch.clamp(dot(sdir, hn), min=0.0)
        ldist = torch.sqrt(((spos - lpos) ** 2).sum(-1))
        cos_l = torch.clamp(dot(sdir, -lnorm), min=0.0)
        lpdf = sel * torch.where(is_env, env_pdf, (R['pdf_a'] * ldist * ldist)
                                 / torch.clamp(cos_l, min=1e-30))
        w = mis(lpdf, bpdf)
        tc_env, _ = to_sphere_tc(sdir)
        slot = torch.full_like(lid, T['env_tex'])
        sky = (T['env_color'] * T['env_mult']) * tap(T, slot, tc_env)
        lcol = torch.where(is_env[:, None], sky, R['color'] * R['mult'])
        direct = (lcol * bval / torch.clamp(lpdf, min=1e-30)[:, None]
                  * (cos_out * w)[:, None])
        direct = torch.where((need & ~occ)[:, None], direct, 0.0)

        # a light hit ends the path
        has_l = hlgt >= 0
        atten = torch.where(dot(d, R['norm']) < 0.0, 1.0, 0.0)
        lint = torch.where(has_l[:, None], (R['color'] * R['mult'])
                           * atten[:, None], base)
        wl = torch.ones_like(mis_pdf)
        if b > 0:
            hd = torch.sqrt(((o - hp) ** 2).sum(-1))
            cl = torch.clamp(dot(d, -hn), min=0.0)
            lp = sel * ((R['pdf_a'] * hd * hd) / torch.clamp(cl, min=1e-30))
            ww = torch.where(mis_pdf <= 0.0, 1.0, mis(mis_pdf, lp))
            wl = torch.where(has_l, ww, 1.0)
        lb = live & is_light
        acc_l = acc + thr * lint * wl[:, None]

        # a surface bounce
        surf = live & ~is_light
        sx, sy, r = BX.rnd4(sx, sy, surf, ft)
        r = r.T
        ndir = cosine_sample(r[:, 0], r[:, 1], hn)
        npdf = dot(ndir, hn).abs() * INV_PI
        nval = (torch.full_like(npdf, INV_PI) * 1.0)[:, None] * base
        bxdf = nval / torch.clamp(npdf, min=1e-20)[:, None]
        cos_t = dot(ndir, hn).abs()
        sign = torch.where(dot(ndir, hn) < 0.0, -1.0, 1.0).to(ft)
        npos = hp + (sign * eps_of(hp))[:, None] * hn
        nfl = (flags & ~FIRST_NON_SPEC) | HAS_NON_SPEC
        first = ((flags & HAS_NON_SPEC) == 0) & ((nfl & HAS_NON_SPEC) != 0)
        nfl = torch.where(first, nfl | FIRST_NON_SPEC, nfl)
        acc = torch.where(lb[:, None], acc_l, torch.where(
            surf[:, None], acc + thr * direct, acc))
        thr = torch.where(surf[:, None], thr * cos_t[:, None] * bxdf, thr)
        flags = torch.where(lb, flags | IS_DEAD | HIT_LIGHT,
                            torch.where(surf, nfl, flags))
        o = torch.where(surf[:, None], npos, o)
        d = torch.where(surf[:, None], ndir, d)
        mis_pdf = torch.where(surf, npdf, mis_pdf)

    # the sky on a miss
    out = (flags & OUT_OF_SCENE) != 0
    env, env_pdf = sky_color(T, d)
    prime = (flags & PRIME_RAY_MISS) != 0
    w = mis(mis_pdf, sel * env_pdf)
    env = torch.where((~(mis_pdf < 0.0) & ~prime)[:, None], env * w[:, None],
                      env)
    acc = torch.where(out[:, None], acc + thr * env, acc)
    return acc, sx, sy


def expected(desc: dict, pixel_ids, frame: dict, device, dtype=torch.float32):
    """The frame's values [K, 4] at ``pixel_ids`` (int64 on ``device``)
    after ``frame['spp']`` passes."""
    T = tables(desc, device, dtype)
    sx, sy = BX.seed_state(pixel_ids)
    fb = torch.zeros((pixel_ids.shape[0], 4), dtype=dtype, device=device)
    for _ in range(int(frame['spp'])):
        c, sx, sy = sample(T, pixel_ids, sx, sy)
        fb = fb + c
    return fb / float(frame['spp'])
