"""The Sponza-class city, described in plain numpy from a seed.

A procedural stand-in for Crytek Sponza, whose files are not in the repo,
sized to the counts the configuration states: after the port's
``scene/synth.build_city(textured=True)``, widened to ``facade_textures``
facade materials, each with its own sRGB texture of ``texture_size`` a
side, an asphalt-textured ground and one untextured material.
``n_blocks`` x ``n_blocks`` buildings of five subdivided faces stand on a
ground of ``ground_subdiv`` squared quads, under one overhead area light
and a lat-long sky (float, importance-sampled), seen from a camera above
an avenue.

The layout (the buildings' sizes, offsets and materials, the facades'
tints and lit windows) is drawn from the configuration's ``layout_seed``,
the same for every run, so that every seed asks the same geometry and
nearly the same paths of the trace (a lit window changes where Russian
roulette ends a path).  The run's seed draws the texels' grain and the
camera pose, within the ranges the configuration states.  Every seed
gives a scene of the same shape.  Camera numbers are rounded to
``DECIMALS`` places, so that they survive a trip through a scene file as
text unchanged.
"""
from __future__ import annotations

import numpy as np

DECIMALS = 3


def _boxes(cx, cz, w, d, h, subdiv):
    """Buildings of five subdivided faces (no floor), one a row of the
    float64 arrays ``cx``, ``cz`` (centre), ``w``, ``d`` (half sizes) and
    ``h`` (height): (pos [B * 5 * n * n, 3], idx [B * 5 * 2 * s * s, 3],
    uv), n = subdiv + 1, the vertices of each face row by row."""
    x0, x1, z0, z1 = cx - w, cx + w, cz - d, cz + d
    zero = np.zeros_like(cx)
    # each face's corner o and edges eu (along a row), ev (across rows)
    o = np.stack([np.stack(v, -1) for v in (
        (x0, zero, z1), (x1, zero, z0), (x1, zero, z1), (x0, zero, z0),
        (x0, h, z1))], 1).astype(np.float32)
    eu = np.stack([np.stack(v, -1) for v in (
        (x1 - x0, zero, zero), (x0 - x1, zero, zero), (zero, zero, z0 - z1),
        (zero, zero, z1 - z0), (x1 - x0, zero, zero))], 1).astype(np.float32)
    ev = np.stack([np.stack(v, -1) for v in (
        (zero, h, zero), (zero, h, zero), (zero, h, zero), (zero, h, zero),
        (zero, zero, z0 - z1))], 1).astype(np.float32)
    n = subdiv + 1
    f = np.array([k / subdiv for k in range(n)], np.float32)
    pos = ((o[:, :, None, None] + eu[:, :, None, None] * f[:, None])
           + ev[:, :, None, None] * f[:, None, None])
    lu = np.sqrt((eu * eu).sum(-1)).astype(np.float64)
    lv = np.sqrt((ev * ev).sum(-1)).astype(np.float64)
    k = np.arange(n, dtype=np.float64)
    uv = np.stack(np.broadcast_arrays(
        (lu[:, :, None, None] * k[None, :]) / subdiv,
        (lv[:, :, None, None] * k[:, None]) / subdiv), -1).astype(np.float32)
    j, i = np.divmod(np.arange(subdiv * subdiv), subdiv)
    a = j * n + i
    quad = np.stack([np.stack([a, a + 1, a + n + 1], -1),
                     np.stack([a, a + n + 1, a + n], -1)], 1).reshape(-1, 3)
    faces = np.arange(len(cx) * 5)[:, None, None] * (n * n)
    idx = (quad[None] + faces).reshape(-1, 3)
    return pos.reshape(-1, 3), idx.astype(np.int64), uv.reshape(-1, 2)


def _ground(half, subdiv):
    pos, idx, uv = [], [], []
    n = subdiv + 1
    for j in range(n):
        for i in range(n):
            pos.append((-half + 2 * half * i / subdiv, 0.0,
                        -half + 2 * half * j / subdiv))
            uv.append((2 * half * i / subdiv, 2 * half * j / subdiv))
    for j in range(subdiv):
        for i in range(subdiv):
            a = j * n + i
            idx.append((a, a + n + 1, a + 1))
            idx.append((a, a + n, a + n + 1))
    return (np.array(pos, np.float32), np.array(idx, np.int64),
            np.array(uv, np.float32))


def _facade(lay, rng, size):
    """A facade: the tint and the lit windows from the layout's generator
    ``lay``, the grain from the run's ``rng``."""
    win = size // 8
    img = np.empty((size, size, 3), np.float32)
    img[:] = lay.uniform(0.4, 0.8, 3).astype(np.float32)
    for jy in range(0, size, win):
        for jx in range(0, size, win):
            lit = lay.random() < 0.12
            pane = (np.array([0.95, 0.85, 0.55], np.float32) if lit
                    else np.array([0.06, 0.07, 0.10], np.float32))
            img[jy + win // 4:jy + win - win // 5,
                jx + win // 5:jx + win - win // 5] = pane
    img *= rng.uniform(0.82, 1.0, (size, size, 1)).astype(np.float32)
    return (np.clip(img, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)


def _asphalt(rng, size):
    img = np.full((size, size, 3), 0.30, np.float32)
    img *= rng.uniform(0.8, 1.1, (size, size, 1)).astype(np.float32)
    line = slice(size // 2 - size // 64, size // 2 + size // 64)
    img[:, line] = 0.75
    img[line, :] = 0.75
    return (np.clip(img, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)


def _sky(w=64, h=32):
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    zen = np.array([0.22, 0.42, 0.95], np.float32)
    hor = np.array([0.95, 0.85, 0.70], np.float32)
    gnd = np.array([0.18, 0.16, 0.14], np.float32)
    t = np.clip(v * 2.0, 0.0, 1.0)[:, None]
    upper = zen[None] * (1 - t) + hor[None] * t
    col = np.where((v < 0.5)[:, None], upper, gnd[None])
    return np.repeat(col[:, None, :], w, axis=1).astype(np.float32)


def describe(config: dict, seed: int) -> dict:
    """The scene description of ``config`` for ``seed``."""
    rng = np.random.default_rng(seed)
    lay = np.random.default_rng(int(config['layout_seed']))
    nb, subdiv = int(config['n_blocks']), int(config['subdiv'])
    size, nf = int(config['texture_size']), int(config['facade_textures'])
    textures = [_asphalt(rng, size)] + [_facade(lay, rng, size)
                                        for _ in range(nf)]
    fm = (0.25, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0)
    gm = (0.125, 0.0, 0.0, 0.0, 0.0, 0.125, 0.0, 0.0)
    materials = [dict(name='ground', diffuse_color=(1.0, 1.0, 1.0),
                      diffuse_tex_id=0, diffuse_tex_matrix=gm)]
    materials += [dict(name=f'wall{i}', diffuse_color=(1.0, 1.0, 1.0),
                       diffuse_tex_id=i + 1, diffuse_tex_matrix=fm)
                  for i in range(nf)]
    materials.append(dict(name='plaster', diffuse_color=(0.7, 0.65, 0.55)))
    textures.append(_sky())
    pitch = 8.0
    half = nb * pitch * 0.5 + 20.0
    gp, gi, guv = _ground(half, int(config['ground_subdiv']))
    rows, mats = [], []
    for by in range(nb):
        for bx in range(nb):
            cx = (bx - nb / 2 + 0.5) * pitch
            cz = (by - nb / 2 + 0.5) * pitch
            w = lay.uniform(2.0, 3.2)
            d = lay.uniform(2.0, 3.2)
            h = lay.uniform(4.0, 28.0)
            rows.append((cx + lay.uniform(-0.8, 0.8),
                         cz + lay.uniform(-0.8, 0.8), w, d, h))
            mats.append(1 + int(lay.integers(nf + 1)))
    bp, bi, buv = _boxes(*np.array(rows).T, subdiv)
    per_box = len(bi) // len(rows)
    lm = np.eye(4, dtype=np.float32)
    lm[1, 3] = 60.0
    cam = config['camera']

    def draw(lo_hi, scale=1.0):
        return tuple(round(float(rng.uniform(lo, hi)) * scale, DECIMALS)
                     for lo, hi in lo_hi)

    return dict(
        width=int(config['width']), height=int(config['height']),
        depth=int(config['depth']),
        meshes=[dict(pos=np.concatenate([gp, bp]),
                     indices=np.concatenate([gi, bi + len(gp)]),
                     mat_indices=np.concatenate([
                         np.zeros(len(gi), np.int64),
                         np.repeat(np.array(mats, np.int64), per_box)]),
                     texc=np.concatenate([guv, buv]))],
        materials=materials, textures=textures,
        area_lights=[dict(name='light', color=(1.0, 1.0, 1.0),
                          multiplier=16.0, half_width=40.0, half_length=40.0,
                          matrix=lm)],
        env=dict(color=(1.0, 1.0, 1.0), multiplier=1.0,
                 tex_id=len(textures) - 1),
        camera=dict(fov=float(cam['fov']),
                    pos=draw(cam['pos'][:2]) + (round(half * float(
                        rng.uniform(*cam['pos'][2])), DECIMALS),),
                    look_at=draw(cam['look_at']), up=(0.0, 1.0, 0.0),
                    near=0.1, far=1000.0))
