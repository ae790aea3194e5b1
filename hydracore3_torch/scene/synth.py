"""The synthetic city: the sponza-class benchmark scene, built in numpy.

The counterpart of ``hydracore3_tpu/scene/synth.py``: the same geometry,
procedural textures, lights and camera from the same numpy RNG draws in
the same order, emitted as an in-memory ``SceneDesc`` (no XML) and built by
``scene.build.build_scene``.  At the bench size (48 x 48 blocks, subdiv 3,
64 x 64 ground) the city has 215,554 triangles: 48^2 buildings of 90, an
8192-triangle ground and the area light's 2.
"""
from __future__ import annotations

import numpy as np

from . import build as B


def _box(cx, cz, w, d, h, subdiv=3):
    """Building box [cx +- w, 0..h, cz +- d], each of its 5 faces
    subdivided subdiv x subdiv: (pos [V, 3], idx [T, 3], facade uv [V, 2])."""
    x0, x1 = cx - w, cx + w
    z0, z1 = cz - d, cz + d
    quads = [((x0, 0, z1), (x1 - x0, 0, 0), (0, h, 0)),      # front +z
             ((x1, 0, z0), (x0 - x1, 0, 0), (0, h, 0)),      # back -z
             ((x1, 0, z1), (0, 0, z0 - z1), (0, h, 0)),      # right +x
             ((x0, 0, z0), (0, 0, z1 - z0), (0, h, 0)),      # left -x
             ((x0, h, z1), (x1 - x0, 0, 0), (0, 0, z0 - z1))]  # roof
    pos, idx, uv = [], [], []
    for o, eu, ev in quads:
        o = np.array(o, np.float32)
        eu = np.array(eu, np.float32)
        ev = np.array(ev, np.float32)
        lu = float(np.linalg.norm(eu))
        lv = float(np.linalg.norm(ev))
        base = len(pos)
        n = subdiv + 1
        for j in range(n):
            for i in range(n):
                pos.append(o + eu * (i / subdiv) + ev * (j / subdiv))
                uv.append((lu * i / subdiv, lv * j / subdiv))
        for j in range(subdiv):
            for i in range(subdiv):
                a = base + j * n + i
                idx.append((a, a + 1, a + n + 1))
                idx.append((a, a + n + 1, a + n))
    return (np.array(pos, np.float32), np.array(idx, np.int64),
            np.array(uv, np.float32))


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


def _facade_texture(rng, tint, size=128, win=16):
    """Window grid on a tinted wall, a few windows lit; uint8 sRGB."""
    img = np.empty((size, size, 3), np.float32)
    img[:] = np.asarray(tint, np.float32)
    for jy in range(0, size, win):
        for jx in range(0, size, win):
            lit = rng.random() < 0.12
            pane = (np.array([0.95, 0.85, 0.55], np.float32) if lit
                    else np.array([0.06, 0.07, 0.10], np.float32))
            img[jy + 4:jy + win - 3, jx + 3:jx + win - 3] = pane
    img *= rng.uniform(0.82, 1.0, (size, size, 1)).astype(np.float32)
    return (np.clip(img, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)


def _asphalt_texture(rng, size=128):
    """Noisy asphalt with light lane lines along both axes; uint8 sRGB."""
    img = np.full((size, size, 3), 0.30, np.float32)
    img *= rng.uniform(0.8, 1.1, (size, size, 1)).astype(np.float32)
    img[:, size // 2 - 2:size // 2 + 2] = 0.75
    img[size // 2 - 2:size // 2 + 2, :] = 0.75
    return (np.clip(img, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)


def _sky_env_map(w=64, h=32):
    """Smooth lat-long gradient sky (float32, importance-sampled)."""
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    zen = np.array([0.22, 0.42, 0.95], np.float32)
    hor = np.array([0.95, 0.85, 0.70], np.float32)
    gnd = np.array([0.18, 0.16, 0.14], np.float32)
    t = np.clip(v * 2.0, 0.0, 1.0)[:, None]
    upper = zen[None] * (1 - t) + hor[None] * t
    col = np.where((v < 0.5)[:, None], upper, gnd[None])
    return np.repeat(col[:, None, :], w, axis=1).astype(np.float32)


def build_city(n_blocks: int = 48, subdiv: int = 3, seed: int = 7,
               width: int = 1024, height: int = 1024, depth: int = 5,
               ground_subdiv: int = 64, textured: bool = False
               ) -> B.SceneDesc:
    """The city description, deterministic in (n_blocks, subdiv, seed)."""
    if not textured:
        raise NotImplementedError('the untextured city is not ported; use '
                                  'textured=True')
    rng = np.random.default_rng(seed)
    sd = B.SceneDesc(width=width, height=height, trace_depth=depth, spp=64)
    t_ground = sd.add_texture(_asphalt_texture(rng))
    t_walls = [sd.add_texture(_facade_texture(rng, c))
               for c in [(0.65, 0.55, 0.45), (0.55, 0.60, 0.70),
                         (0.70, 0.45, 0.40), (0.75, 0.70, 0.60)]]
    # facade repeats every 4 world units, asphalt every 8 (street pitch)
    fm = (0.25, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0)
    gm = (0.125, 0.0, 0.0, 0.0, 0.0, 0.125, 0.0, 0.0)
    sd.materials.append(B.MaterialDesc(name='ground',
                                       diffuse_color=(1.0, 1.0, 1.0),
                                       diffuse_tex_id=t_ground,
                                       diffuse_tex_matrix=gm))
    m_walls = []
    for i, t in enumerate(t_walls):
        m_walls.append(len(sd.materials))
        sd.materials.append(B.MaterialDesc(name=f'wall{i}',
                                           diffuse_color=(1.0, 1.0, 1.0),
                                           diffuse_tex_id=t,
                                           diffuse_tex_matrix=fm))
    t_env = sd.add_texture(_sky_env_map())
    sd.env = B.EnvLightDesc(color=(1.0, 1.0, 1.0), multiplier=1.0,
                            tex_id=t_env)

    # blocks on an 8-unit pitch, streets between
    pitch = 8.0
    half = n_blocks * pitch * 0.5 + 20.0
    gp, gi, guv = _ground(half, ground_subdiv)
    all_pos, all_idx, all_uv = [gp], [gi], [guv]
    all_mat = [np.zeros(len(gi), np.int64)]
    voff = len(gp)
    for by in range(n_blocks):
        for bx in range(n_blocks):
            cx = (bx - n_blocks / 2 + 0.5) * pitch
            cz = (by - n_blocks / 2 + 0.5) * pitch
            w = rng.uniform(2.0, 3.2)
            d = rng.uniform(2.0, 3.2)
            h = rng.uniform(4.0, 28.0)
            p, i, uv = _box(cx + rng.uniform(-0.8, 0.8),
                            cz + rng.uniform(-0.8, 0.8), w, d, h, subdiv)
            all_pos.append(p)
            all_idx.append(i + voff)
            all_uv.append(uv)
            m = m_walls[int(rng.integers(len(m_walls)))]
            all_mat.append(np.full(len(i), m, np.int64))
            voff += len(p)
    sd.meshes.append(B.MeshDesc(pos=np.concatenate(all_pos),
                                indices=np.concatenate(all_idx),
                                mat_indices=np.concatenate(all_mat),
                                texc=np.concatenate(all_uv)))
    sd.instances.append((0, None))

    # one big overhead area light (the 'sun') above the city centre
    lm = np.eye(4, dtype=np.float32)
    lm[1, 3] = 60.0
    sd.lights.append(B.AreaLightDesc(color=(1.0, 1.0, 1.0), multiplier=16.0,
                                     half_width=40.0, half_length=40.0,
                                     matrix=lm))
    # street-level camera looking down an avenue
    sd.camera = B.CameraDesc(fov=60.0, pos=(0.0, 14.0, half * 0.92),
                             look_at=(0.0, 4.0, 0.0), up=(0.0, 1.0, 0.0),
                             near=0.1, far=1000.0)
    return sd


def city_scene(n_blocks: int = 48, subdiv: int = 3, seed: int = 7,
               width: int = 1024, height: int = 1024, depth: int = 5,
               ground_subdiv: int = 64, textured: bool = False,
               device='cpu'):
    """Build the city on ``device``; returns (scene, meta)."""
    sd = build_city(n_blocks, subdiv, seed, width, height, depth,
                    ground_subdiv, textured=textured)
    return B.build_scene(sd, device=device)
