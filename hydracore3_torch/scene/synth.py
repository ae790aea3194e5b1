"""The port's in-repo scenes, built in numpy: the cities and the box.

The city is the counterpart of ``hydracore3_tpu/scene/synth.py``: the same
geometry, materials (procedural textures and a sky with ``textured``, the
bench city; plain colours without, JAX's default), lights and camera
from the same numpy RNG draws in the same order, emitted as an in-memory
``SceneDesc`` (with the JAX package's names, so that
``api.write_library`` writes the JAX package's files byte for byte) and
built by ``scene.build.build_scene``.
At the bench size (48 x 48 blocks, subdiv 3, 64 x 64 ground) the city has
215,554 triangles: 48^2 buildings of 90, an 8192-triangle ground and the
area light's 2.

The instanced city (``instanced_city_scene``) is one unit building mesh of
90 triangles placed ``n_blocks``^2 times with a rotation and a non-uniform
scale, a ground mesh and the area light; untextured, no environment.  Built
two-level (``accel='stream_tlas'``) it keeps each mesh once.

The box is the Cornell-class scene of ``tests/test_api.py:16-42`` (12
triangles, one area light), optionally with a textured quad, a glossy
quad, a point light and a sphere light (16 triangles, 3 lights): the
megakernel's scene class.
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
    """The city description, deterministic in (n_blocks, subdiv, seed).
    ``textured`` gives the facades and the asphalt procedural textures and
    adds a lat-long sky; the untextured city (the JAX package's default)
    has no texture and no environment, a grey ground and six wall
    colours."""
    rng = np.random.default_rng(seed)
    sd = B.SceneDesc(width=width, height=height, trace_depth=depth, spp=64)
    if textured:
        t_ground = sd.add_texture(_asphalt_texture(rng), 'asphalt')
        t_walls = [sd.add_texture(_facade_texture(rng, c), f'facade{i}')
                   for i, c in enumerate([(0.65, 0.55, 0.45),
                                          (0.55, 0.60, 0.70),
                                          (0.70, 0.45, 0.40),
                                          (0.75, 0.70, 0.60)])]
        # facade repeats every 4 world units, asphalt every 8 (street pitch)
        fm = (0.25, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0)
        gm = (0.125, 0.0, 0.0, 0.0, 0.0, 0.125, 0.0, 0.0)
        sd.materials.append(B.MaterialDesc(name='ground',
                                           diffuse_color=(1.0, 1.0, 1.0),
                                           diffuse_tex_id=t_ground,
                                           diffuse_tex_matrix=gm))
        walls = [B.MaterialDesc(name=f'wall{i}', diffuse_color=(1.0, 1.0,
                                                                1.0),
                                diffuse_tex_id=t, diffuse_tex_matrix=fm)
                 for i, t in enumerate(t_walls)]
    else:
        sd.materials.append(B.MaterialDesc(name='ground',
                                           diffuse_color=(0.30, 0.30, 0.32)))
        walls = [B.MaterialDesc(name=f'wall{i}', diffuse_color=c)
                 for i, c in enumerate([(0.65, 0.55, 0.45),
                                        (0.55, 0.60, 0.70),
                                        (0.70, 0.45, 0.40),
                                        (0.50, 0.65, 0.50),
                                        (0.75, 0.70, 0.60),
                                        (0.45, 0.50, 0.60)])]
    m_walls = list(range(len(sd.materials), len(sd.materials) + len(walls)))
    sd.materials += walls
    if textured:
        t_env = sd.add_texture(_sky_env_map(), 'sky')
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
               device=None, accel: str = 'auto'):
    """Build the city on ``device`` (None: the CUDA card); returns
    (scene, meta)."""
    sd = build_city(n_blocks, subdiv, seed, width, height, depth,
                    ground_subdiv, textured=textured)
    return B.build_scene(sd, device=device, accel=accel)


def build_instanced_city(n_blocks: int = 32, subdiv: int = 3, seed: int = 7,
                         width: int = 1024, height: int = 1024,
                         depth: int = 5, ground_subdiv: int = 32
                         ) -> B.SceneDesc:
    """The instanced city description: the JAX package's
    ``build_instanced_city``, the same RNG draws in the same order."""
    rng = np.random.default_rng(seed)
    sd = B.SceneDesc(width=width, height=height, trace_depth=depth, spp=64)
    sd.materials += [
        B.MaterialDesc(name='ground', diffuse_color=(0.30, 0.30, 0.32)),
        B.MaterialDesc(name='wall', diffuse_color=(0.62, 0.55, 0.48))]
    m_ground, m_wall = 0, 1

    pitch = 8.0
    half = n_blocks * pitch * 0.5 + 20.0
    gp, gi, _ = _ground(half, ground_subdiv)
    sd.meshes.append(B.MeshDesc(pos=gp, indices=gi,
                                mat_indices=np.full(len(gi), m_ground)))
    sd.instances.append((0, None))
    bp, bi, _ = _box(0.0, 0.0, 1.0, 1.0, 1.0, subdiv)   # unit building
    sd.meshes.append(B.MeshDesc(pos=bp, indices=bi,
                                mat_indices=np.full(len(bi), m_wall)))
    for by in range(n_blocks):
        for bx in range(n_blocks):
            cx = (bx - n_blocks / 2 + 0.5) * pitch + rng.uniform(-0.8, 0.8)
            cz = (by - n_blocks / 2 + 0.5) * pitch + rng.uniform(-0.8, 0.8)
            sx = rng.uniform(2.0, 3.2)
            sz = rng.uniform(2.0, 3.2)
            sy = rng.uniform(4.0, 28.0)
            a = rng.uniform(0, np.pi / 2)
            c, s = np.cos(a), np.sin(a)
            sd.instances.append((1, np.array([[c * sx, 0, s * sz, cx],
                                              [0, sy, 0, 0],
                                              [-s * sx, 0, c * sz, cz],
                                              [0, 0, 0, 1]], np.float32)))

    lm = np.eye(4, dtype=np.float32)
    lm[1, 3] = 60.0
    sd.lights.append(B.AreaLightDesc(color=(1.0, 1.0, 1.0), multiplier=16.0,
                                     half_width=40.0, half_length=40.0,
                                     matrix=lm))
    sd.camera = B.CameraDesc(fov=60.0, pos=(0.0, 14.0, half * 0.92),
                             look_at=(0.0, 4.0, 0.0), up=(0.0, 1.0, 0.0),
                             near=0.1, far=1000.0)
    return sd


def instanced_city_scene(n_blocks: int = 32, subdiv: int = 3, seed: int = 7,
                         width: int = 1024, height: int = 1024,
                         depth: int = 5, ground_subdiv: int = 32,
                         accel: str = 'stream_tlas', device=None):
    """Build the instanced city on ``device`` (None: the CUDA card);
    returns (scene, meta)."""
    sd = build_instanced_city(n_blocks, subdiv, seed, width, height, depth,
                              ground_subdiv)
    return B.build_scene(sd, device=device, accel=accel)


def _quad(p0, p1, p2, p3):
    return np.array([p0, p1, p2, p3], np.float32), np.array([[0, 1, 2],
                                                            [0, 2, 3]])


def _grid_quad(p0, p1, p2, p3, n):
    """The parallelogram p0 p1 p2 p3 cut into an n x n grid of quads, two
    triangles each, wound as ``_quad``'s; n = 1 is ``_quad`` itself."""
    if n == 1:
        return _quad(p0, p1, p2, p3)
    p0, p1, p3 = (np.asarray(p, np.float64) for p in (p0, p1, p3))
    a = np.arange(n + 1) / n
    pos = (p0 + a[:, None, None] * (p1 - p0)
           + a[None, :, None] * (p3 - p0)).reshape(-1, 3)
    i, j = (g.reshape(-1) for g in np.meshgrid(np.arange(n), np.arange(n),
                                               indexing='ij'))
    c00, c10 = i * (n + 1) + j, (i + 1) * (n + 1) + j
    c11, c01 = c10 + 1, c00 + 1
    ind = np.stack([np.stack([c00, c10, c11], 1),
                    np.stack([c00, c11, c01], 1)], 1).reshape(-1, 3)
    return pos.astype(np.float32), ind


def build_box(width: int = 64, height: int = 48, depth: int = 4,
              textured: bool = False, wall_subdiv: int = 1) -> B.SceneDesc:
    """The box description (what tests/jax_box.py commits through the JAX
    package's API).  ``wall_subdiv`` cuts each of the five walls into a
    grid of that many quads a side (a test scene for the megakernel's
    trace: 20 gives 4,006 triangles); 1 is the box itself."""
    sd = B.SceneDesc(width=width, height=height, trace_depth=depth, spp=8)
    sd.materials += [B.MaterialDesc(name='white', diffuse_color=(0.5, 0.5,
                                                                 0.5)),
                     B.MaterialDesc(name='red', diffuse_color=(0.5, 0.0, 0.0)),
                     B.MaterialDesc(name='green', diffuse_color=(0.0, 0.5,
                                                                 0.0))]
    white, red, green = 0, 1, 2
    s = 4.0
    # floor (+Y normal), ceiling, back wall, left (red), right (green)
    quads = [
        (((-s, -s, -s), (-s, -s, s), (s, -s, s), (s, -s, -s)), white, None),
        (((-s, s, -s), (s, s, -s), (s, s, s), (-s, s, s)), white, None),
        (((-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s)), white, None),
        (((-s, -s, -s), (-s, s, -s), (-s, s, s), (-s, -s, s)), red, None),
        (((s, -s, -s), (s, -s, s), (s, s, s), (s, s, -s)), green, None),
    ]
    if textured:
        tid = sd.add_texture(np.random.default_rng(0).integers(
            0, 256, (64, 64, 3), dtype=np.uint8))
        tmat = len(sd.materials)
        sd.materials += [
            B.MaterialDesc(name='textured', diffuse_color=(0.8, 0.8, 0.8),
                           diffuse_tex_id=tid),
            B.MaterialDesc(name='glossy', diffuse_color=(0.3, 0.3, 0.6),
                           reflectivity=(0.5, 0.5, 0.5), glossiness=0.8)]
        pts = np.array([(-1, -3, -1), (1, -3, -1), (1, -1, -1),
                        (-1, -1, -1)], np.float32)
        texc = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        quads += [(pts, tmat, texc),
                  (pts + np.float32([2.5, 0.0, 1.0]), tmat + 1, texc)]
    for k, (pts, mat, texc) in enumerate(quads):
        pos, ind = _grid_quad(*pts, wall_subdiv if k < 5 else 1)
        sd.meshes.append(B.MeshDesc(pos=pos, indices=ind,
                                    mat_indices=np.full(len(ind), mat),
                                    texc=texc))
        sd.instances.append((len(sd.meshes) - 1, None))
    lmat = np.eye(4, dtype=np.float32)
    lmat[1, 3] = s - 0.05  # just under the ceiling
    sd.lights.append(B.AreaLightDesc(name='top', color=(1.0, 1.0, 1.0),
                                     multiplier=12.0, half_width=1.0,
                                     half_length=1.0, matrix=lmat))
    if textured:
        pm = np.eye(4, dtype=np.float32)
        pm[:3, 3] = (-2.0, 2.0, 0.0)
        sd.simple_lights += [
            B.SimpleLightDesc(kind='point', color=(1.0, 1.0, 1.0),
                              multiplier=3.0, matrix=pm),
            B.SimpleLightDesc(kind='sphere', color=(1.0, 0.8, 0.6),
                              multiplier=2.0, radius=0.3, matrix=pm)]
    # camera inside the box so the side walls reach the image borders
    sd.camera = B.CameraDesc(fov=45.0, pos=(0.0, 0.0, 6.0),
                             look_at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    return sd


def box_scene(width: int = 64, height: int = 48, depth: int = 4,
              textured: bool = False, wall_subdiv: int = 1, device=None):
    """Build the box on ``device`` (None: the CUDA card); returns
    (scene, meta)."""
    return B.build_scene(build_box(width, height, depth, textured,
                                   wall_subdiv), device=device)
