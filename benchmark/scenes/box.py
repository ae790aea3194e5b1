"""The mirror Cornell box, described in plain numpy from a seed.

The geometry is the Cornell box as Cornell's Program of Computer Graphics
publishes it (www.graphics.cornell.edu/online/box/data.html), its
millimetres scaled by ``SCALE`` (a unit is 100 mm): five walls (a white
floor, ceiling and back wall, a red left and a green right wall), a short
and a tall block of five faces each, and the ceiling light, 130 x 105 mm,
just under the ceiling.  Its front is open.  The configuration's
``scene_data`` states the materials (the tall block a smooth mirror: the
upstream perf suite's test_102 is the mirror Cornell box), the light's
colour and height, and the camera; its ``assumed`` says where each comes
from.  No texture, no other light.

What the seed changes is named in the configuration file (``seeded``):
the camera pose, drawn from the ranges the configuration states.  Every
seed gives a scene of the same shape.  Every drawn number is rounded to
``DECIMALS`` places, so that it survives a trip through a scene file as
text unchanged.

The description is a dict of plain arrays and numbers: the harness hands
it to the program, the reference derives its own tables from it.
"""
from __future__ import annotations

import numpy as np

DECIMALS = 3
SCALE = 0.01

# Cornell's published quads (mm), each with the material it takes
WALLS = {
    'floor': ([[552.8, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 559.2],
               [549.6, 0.0, 559.2]], 'white'),
    'ceiling': ([[556.0, 548.8, 0.0], [556.0, 548.8, 559.2],
                 [0.0, 548.8, 559.2], [0.0, 548.8, 0.0]], 'white'),
    'back': ([[549.6, 0.0, 559.2], [0.0, 0.0, 559.2], [0.0, 548.8, 559.2],
              [556.0, 548.8, 559.2]], 'white'),
    'right': ([[0.0, 0.0, 559.2], [0.0, 0.0, 0.0], [0.0, 548.8, 0.0],
               [0.0, 548.8, 559.2]], 'green'),
    'left': ([[552.8, 0.0, 0.0], [549.6, 0.0, 559.2], [556.0, 548.8, 559.2],
              [556.0, 548.8, 0.0]], 'red'),
}
SHORT_BLOCK = [
    [[130.0, 165.0, 65.0], [82.0, 165.0, 225.0], [240.0, 165.0, 272.0],
     [290.0, 165.0, 114.0]],
    [[290.0, 0.0, 114.0], [290.0, 165.0, 114.0], [240.0, 165.0, 272.0],
     [240.0, 0.0, 272.0]],
    [[130.0, 0.0, 65.0], [130.0, 165.0, 65.0], [290.0, 165.0, 114.0],
     [290.0, 0.0, 114.0]],
    [[82.0, 0.0, 225.0], [82.0, 165.0, 225.0], [130.0, 165.0, 65.0],
     [130.0, 0.0, 65.0]],
    [[240.0, 0.0, 272.0], [240.0, 165.0, 272.0], [82.0, 165.0, 225.0],
     [82.0, 0.0, 225.0]],
]
TALL_BLOCK = [
    [[423.0, 330.0, 247.0], [265.0, 330.0, 296.0], [314.0, 330.0, 456.0],
     [472.0, 330.0, 406.0]],
    [[423.0, 0.0, 247.0], [423.0, 330.0, 247.0], [472.0, 330.0, 406.0],
     [472.0, 0.0, 406.0]],
    [[472.0, 0.0, 406.0], [472.0, 330.0, 406.0], [314.0, 330.0, 456.0],
     [314.0, 0.0, 456.0]],
    [[314.0, 0.0, 456.0], [314.0, 330.0, 456.0], [265.0, 330.0, 296.0],
     [265.0, 0.0, 296.0]],
    [[265.0, 0.0, 296.0], [265.0, 330.0, 296.0], [423.0, 330.0, 247.0],
     [423.0, 0.0, 247.0]],
]
# the light's quad: x 213-343, z 227-332 (mm), facing down
LIGHT_X, LIGHT_Z = (213.0, 343.0), (227.0, 332.0)


def _mesh(quads, mat):
    pos = np.asarray(quads, np.float32).reshape(-1, 3) * np.float32(SCALE)
    ind = np.concatenate([np.array([[0, 1, 2], [0, 2, 3]], np.int64) + 4 * q
                          for q in range(len(quads))])
    return dict(pos=pos, indices=ind,
                mat_indices=np.full(len(ind), mat, np.int64))


def describe(config: dict, seed: int) -> dict:
    """The scene description of ``config`` for ``seed``."""
    rng = np.random.default_rng(seed)
    sc = config['scene_data']
    names = list(sc['materials'])
    materials = [dict(name=n, **sc['materials'][n]) for n in names]
    meshes = [_mesh([q], names.index(mat)) for q, mat in WALLS.values()]
    meshes += [_mesh(SHORT_BLOCK, names.index(sc['short_block'])),
               _mesh(TALL_BLOCK, names.index(sc['tall_block']))]
    lx, lz = np.float32(LIGHT_X) * SCALE, np.float32(LIGHT_Z) * SCALE
    lm = np.eye(4, dtype=np.float32)
    lm[:3, 3] = (lx.mean(), float(sc['light_y']), lz.mean())
    light = sc['light']
    cam = config['camera']

    def draw(lo_hi):
        return tuple(round(float(rng.uniform(lo, hi)), DECIMALS)
                     for lo, hi in lo_hi)

    return dict(
        width=int(config['width']), height=int(config['height']),
        depth=int(config['depth']), meshes=meshes, materials=materials,
        textures=[],
        area_lights=[dict(name='light', color=tuple(light['color']),
                          multiplier=float(light['multiplier']),
                          half_width=float(lx[1] - lx[0]) / 2,
                          half_length=float(lz[1] - lz[0]) / 2,
                          matrix=lm)],
        camera=dict(fov=float(cam['fov']), pos=draw(cam['pos']),
                    look_at=draw(cam['look_at']), up=(0.0, 1.0, 0.0),
                    near=0.01, far=100.0))
