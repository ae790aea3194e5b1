"""The CUDA kernels against their plain torch version, on the card.

Run on a machine with a CUDA card: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py -q`` (this file imports nothing of JAX, and
``--noconftest`` skips tests/conftest.py, which does).  Without a card every
test skips (the check happens inside the ``cuda`` fixture, never at
import).  Agreement bars: the ray-query kernels' (K2-K6) hit masks equal on
>= 99.9% of random rays, t within rtol 2e-4 where both hit, the
two-level kernel's instance ids equal wherever the triangle is; the
wide-BVH kernels (K2-K5) return the triangle that
``wide_bvh.walk_wide_plain``, their walk in plain torch, returns on >= 99.9%
of both-hit lanes.  K6 is held lane for lane to its plain round
(``traverse_dda.cell_pass_plain``): best hit, cell, entry t and done flag.
The Woop tests of K2, K3 and K6 round as the plain version's, so on rays
through the shared edges of a sheet, and at an equal-t tie met in two
cells, K2, K3 and K6 equal the dense plain version on every lane, t, u, v
and triangle; at a tie on a cell face K3 and K6 keep the march's stop
rule.
K1's entry points on every lane, on the box, the tessellated box and the
material zoo box (tests/zoo_scenes.py, each integrator's variant): RNG,
flags and counts equal and the f32 rows within ``megakernel.KERNEL_TOL``
(built without FMA contraction; rsqrtf, sinf, cosf and atan2f are the
card's, as in torch's own CUDA ops).  K2 and K3 on the small zoo city's
first-bounce rays, refracted ones among them, against the dense plain
version on every lane.  K5 over a small scene's rows (the zoo box II, the
batched route of what the megakernel refuses) against its plain version
on every lane (its Moller-Trumbore test rounds op by op, as the plain
version's): the camera and random rays, and the pass's camera, shadow and
first-bounce queries; and that scene's pass on the card against the
CPU's.  A regen frame's ``launches`` and ``iters`` against a wrap of
``regen_pass``.  K1's spectral variant (``-DHC3_SPECTRAL=1``) on the spectral box,
both entry points, every lane, for each integrator.  K1's pools and table
layouts, for the GLTF, zoo and spectral variants: lane counts that are
no multiple of a pool or a block, a ``first`` launch alone and single
iterations, a frame whose camera rays all miss, the geometry in shared
memory (the boxes) and in device memory (the boxes with their walls cut
into grids).  The feature box
(tests/zoo_scenes.py ``write_feature_box``: spot and IES lights, normal
maps, slot-2/3 maps, the camera-back texture) for each camera: K5 on its
pass's queries, every lane; the lens stack's failed rays (started at
y = -1e7, looking down) through K5, K3 and K2, every lane a miss equal to
the plain version; and its pass on the card against the CPU's.  K4's
motion variant on the motion box's pass queries (tests/zoo_scenes.py
``write_motion_box``) at the times 0, 0.5, 1 and the pass's own, every
lane against its plain version (hit flag, triangle, instance, t, u, v;
any-hit: the reported pair occludes its lane), its refusal of a table
without its wide tables, the motion box's pass on the card against the
CPU's with no plain walk on the card; Whitted, the primary-ray pass and
the G-buffer of the textured box and the motion box on the card against
the CPU's.  Differentiable rendering: the hit's ``Function`` on K5's
queries of the DR box (tests/zoo_scenes.py ``write_dr_box``), its output
and its backward on the card against the CPU's, and ``models/dr``'s
``loss_and_grad`` on the card against the CPU's.  The cluster kernel's
moving-soup variant (K5m) on random moving soups at five times and on the
motion box's pass queries under ``accel='bvh'``, every lane against its
plain version (any-hit: the reported triangle occludes its lane at the
lane's time), its refusal of a static table, and that scene's pass on the
card against the CPU's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from hydracore3_torch.accel import build_bvh as TB
from hydracore3_torch.accel import traverse_dda as TTD
from hydracore3_torch.accel import traverse_pallas as TTP
from hydracore3_torch.accel import traverse_stream as TTS
from hydracore3_torch.accel import traverse_tlas as TTT
from hydracore3_torch.accel import wide_bvh as TWB
from hydracore3_torch.models import megakernel as TMK
from torch_scenes import (cross_cell_tie_scene, face_tie_scene, port_pack,
                          tilted_sheet)

pytestmark = pytest.mark.cuda

# the integrator's t_max of a live ray: the largest float32
IPT_FLT_MAX = float(np.finfo(np.float32).max)

# tests/test_big_scene.py's small city, textured
CITY_KW = dict(n_blocks=4, subdiv=1, seed=3, width=32, height=16, depth=2,
               ground_subdiv=8, textured=True, accel='stream')


def random_scene(rng, n_tris, spread=4.0):
    v0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.5, 0.5, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.5, 0.5, (n_tris, 3)).astype(np.float32)
    return v0, e1, e2


def random_rays(rng, n, box=6.0):
    pos = rng.uniform(-box, box, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos, d


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


UV_TOL = 1e-4


def _agree(kernel, plain, any_hit=False):
    """(share of equal hit flags, share of both-hit lanes with t equal,
    count of both-hit lanes); fails unless at least 0.999 of the both-hit
    lanes report the same triangle and u, v agree to UV_TOL on every lane
    that does."""
    a = TTS.hits_agree(kernel, plain, any_hit)
    assert a['tri_eq'] >= 0.999, a
    assert a['max_duv'] <= UV_TOL, a
    return a['hit_eq'], a['t_ok'], a['both']


def _soup(cuda, seed=31, n_tris=1500, n_rays=4096):
    """The streamed tables of a random soup on the card (and the kernels'
    table on the host as well), and random rays."""
    rng = np.random.default_rng(seed)
    nf, ni, woop, _, grid, wide, _ = port_pack(*random_scene(rng, n_tris))
    pos, d = random_rays(rng, n_rays)
    dev = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    return (dev(nf), dev(ni), dev(woop), grid.to(cuda), dev(pos), dev(d),
            wide, wide.to(cuda))


def _same_as_walk(k, walk, any_hit):
    """The kernel against the same walk in plain torch, lane for lane."""
    kt, ktri = k[0].cpu(), k[1].cpu()
    assert ((ktri >= 0) == (walk[1] >= 0)).float().mean() >= 0.999
    both = (ktri >= 0) & (walk[1] >= 0)
    assert (ktri == walk[1])[both].float().mean() >= 0.999
    if any_hit:
        assert (ktri[ktri >= 0] == 0).all()


@pytest.mark.parametrize('any_hit', [False, True])
def test_stream_kernel_matches_plain(cuda, any_hit):
    nf, ni, woop, _, pos, d, wide_cpu, wide = _soup(cuda)
    n = pos.shape[0]
    tmin = torch.zeros(n, device=cuda)
    tmax = torch.full((n,), 4.0 if any_hit else IPT_FLT_MAX, device=cuda)
    tmax[::11] = 0.0                                   # dead lanes
    before = TTS.intersect_stream.launches
    # the card path reads the kernels' table alone
    k = TTS.intersect_stream(None, None, None, pos, d, tmin, tmax, any_hit,
                             wide=wide)
    torch.cuda.synchronize()
    assert TTS.intersect_stream.launches == before + 1
    assert k[1].dtype == torch.int64
    tmax_c = torch.clamp(tmax, max=TTS.T_MAX_CAP)
    p = TTS.intersect_plain(woop, pos, d, tmin, tmax_c, any_hit)
    hit_eq, t_eq, both = _agree(k, p, any_hit)
    assert hit_eq >= 0.999 and t_eq >= 0.999, (hit_eq, t_eq)
    assert both > 100
    assert (k[1][::11] == -1).all()
    if any_hit:
        assert (k[0][k[1] >= 0] == 0.0).all()
    _same_as_walk(k, TWB.walk_wide_plain(
        wide_cpu, pos.cpu(), d.cpu(), tmin.cpu(), tmax_c.cpu(), any_hit),
        any_hit)


def test_march_kernel_matches_plain(cuda):
    _, _, woop, grid, pos, d, wide_cpu, wide = _soup(cuda, seed=9,
                                                      n_tris=1200)
    n = pos.shape[0]
    # a third of the rays start exactly on interior cell faces in x, where
    # rounding can put the face just behind the origin
    m = n // 3
    k = torch.randint(1, grid.dims[0], (m,), device=cuda)
    pos[:m, 0] = (grid.lo[0] + k * grid.h[0]).float()
    tmin = torch.zeros(n, device=cuda)
    tmax = torch.full((n,), IPT_FLT_MAX, device=cuda)
    before = TTD.intersect_march.launches
    *k, un = TTD.intersect_march(grid, None, pos, d, tmin, tmax,
                                 with_unresolved=True, wide=wide)
    torch.cuda.synchronize()
    assert TTD.intersect_march.launches == before + 1
    assert int(un.sum()) == 0 and k[1].dtype == torch.int64
    tmax_c = torch.clamp(tmax, max=TTS.T_MAX_CAP)
    p = TTS.intersect_plain(woop, pos, d, tmin, tmax_c)
    hit_eq, t_eq, _ = _agree(k, p)
    assert hit_eq >= 0.999 and t_eq >= 0.999, (hit_eq, t_eq)
    # the march returns what the walk from node 0 returns
    _same_as_walk(k, TWB.walk_wide_plain(
        wide_cpu, pos.cpu(), d.cpu(), tmin.cpu(), tmax_c.cpu()), False)


def _instanced(cuda, n_inst=40, seed=3):
    """Two random meshes under rotated, non-uniformly scaled instances, one
    pair of them coincident (equal t on every ray that hits them)."""
    rng = np.random.default_rng(seed)
    meshes = [random_scene(rng, 200, spread=1.0),
              random_scene(rng, 90, spread=1.0)]
    inst = []
    for i in range(n_inst):
        a = rng.uniform(0, 6.28)
        c, s_ = np.cos(a), np.sin(a)
        sx, sy, sz = rng.uniform(0.5, 3.0, 3)
        m = np.array([[c * sx, 0, s_ * sz, rng.uniform(-8, 8)],
                      [0, sy, 0, rng.uniform(-8, 8)],
                      [-s_ * sx, 0, c * sz, rng.uniform(-8, 8)],
                      [0, 0, 0, 1]], np.float32)
        inst.append(dict(geom_id=i % 2, m0=m))
    inst.append(dict(inst[0]))
    pk = TTT.pack_stream_tlas(meshes, inst)
    return pk, TTT.tlas_pack(pk).to(cuda)


@pytest.mark.parametrize('any_hit', [False, True])
def test_tlas_kernel_matches_plain(cuda, any_hit):
    pk, pack = _instanced(cuda)
    rng = np.random.default_rng(11)
    n = 8192
    pos, d = random_rays(rng, n, box=10.0)
    # a quarter of the rays start exactly on faces of instance boxes
    leaf = pk['tlas_i'][:, 1] >= 0
    boxes = pk['tlas_f'][leaf]
    k = rng.integers(0, len(boxes), n // 4)
    pos[:n // 4, 0] = boxes[k, 0]
    pos, d = torch.from_numpy(pos).to(cuda), torch.from_numpy(d).to(cuda)
    tmin = torch.zeros(n, device=cuda)
    tmax = torch.full((n,), 6.0 if any_hit else 3.4e38, device=cuda)
    before = TTT.intersect_stream_tlas.launches
    k = TTT.intersect_stream_tlas(pack, pos, d, tmin, tmax, any_hit)
    torch.cuda.synchronize()
    assert TTT.intersect_stream_tlas.launches == before + 1
    p = TTT.intersect_tlas_plain(pack, pos, d, tmin, torch.clamp(
        tmax, max=0.99 * TTS.FLT_MAX), any_hit)
    hit_eq, t_eq, both = _agree(k, p, any_hit)
    assert hit_eq >= 0.999 and t_eq >= 0.999, (hit_eq, t_eq)
    assert both > 100
    if any_hit:
        assert (k[0][k[1] >= 0] == 0.0).all()
        assert (k[4] == -1).all()
        return
    same = (k[1] >= 0) & (k[1] == p[1])
    assert same.float().mean() > 0.3
    # same triangle, same instance, except on the coincident pair
    inst_eq = (k[4] == p[4])[same].float().mean()
    assert inst_eq >= 0.999, inst_eq
    assert (k[4][k[1] < 0] == -1).all()


def _cluster_soup(cuda, seed=17, n_tris=3000):
    """(bvh, contract tables on the card, the kernel's wide tables on the
    host and on the card) of a random soup."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = random_scene(rng, n_tris)
    bvh = TB.build(v0, e1, e2, max_leaf=TTP.CLUSTER)
    o = bvh.order
    tabs = TTP.pack_cluster_bvh(bvh, v0[o], e1[o], e2[o])
    wide = TWB.pack_wide_clusters(tabs[2])
    return (rng, bvh, [torch.from_numpy(a).to(cuda) for a in tabs], wide,
            wide.to(cuda))


@pytest.mark.parametrize('any_hit', [False, True])
def test_clusters_kernel_matches_plain(cuda, any_hit):
    rng, bvh, (nf, ni, tris12), wide_cpu, wide = _cluster_soup(cuda)
    n = 8192
    pos, d = random_rays(rng, n)
    # a quarter of the rays start exactly on leaf-box faces
    leaves = bvh.bmin[bvh.tri_count > 0]
    pos[:n // 4, 1] = leaves[rng.integers(0, len(leaves), n // 4), 1]
    pos, d = torch.from_numpy(pos).to(cuda), torch.from_numpy(d).to(cuda)
    tmin = torch.zeros(n, device=cuda)
    tmax = torch.full((n,), 3.0 if any_hit else IPT_FLT_MAX, device=cuda)
    tmax[::11] = 0.0                                   # dead lanes
    before = TTP.intersect_clusters.launches
    k = TTP.intersect_clusters(nf, ni, tris12, pos, d, tmin, tmax, any_hit,
                               wide=wide)
    torch.cuda.synchronize()
    assert TTP.intersect_clusters.launches == before + 1
    p = TTP.intersect_clusters_plain(tris12, pos, d, tmin, tmax, any_hit)
    hit_eq, t_eq, both = _agree(k, p, any_hit)
    assert hit_eq >= 0.999 and t_eq >= 0.999, (hit_eq, t_eq)
    assert both > 100
    assert (k[1][::11] == -1).all()
    # the same walk in plain torch, lane for lane
    w = TWB.walk_wide_plain(wide_cpu, pos.cpu(), d.cpu(), tmin.cpu(),
                            tmax.cpu(), any_hit)
    assert ((k[1].cpu() >= 0) == (w[1] >= 0)).float().mean() >= 0.999
    occ = (k[1].cpu() >= 0) & (w[1] >= 0)
    assert (k[1].cpu() == w[1])[occ].float().mean() >= 0.999
    if any_hit:
        assert (k[0][k[1] >= 0] == 0.0).all()
        valid = TTP.occluder_valid(tris12, k[1], pos, d, tmin, tmax)
        assert torch.equal(valid, k[1] >= 0)
    else:
        tri_eq = (k[1] == p[1]).float().mean()
        assert tri_eq >= 0.999, tri_eq
        miss = (k[1] < 0).cpu().numpy()
        assert (k[0].cpu().numpy()[miss]
                == tmax.cpu().numpy()[miss]).all()     # t_max not clamped


def test_tlas_kernel_matches_walk_wide_plain(cuda):
    """The two-level kernel against the same walk in plain torch: the
    coincident pair of instances included, the winner is the same."""
    pk, pack = _instanced(cuda)
    rng = np.random.default_rng(12)
    n = 4096
    pos, d = (torch.from_numpy(a) for a in random_rays(rng, n, box=10.0))
    tmin = torch.zeros(n)
    tmax = torch.full((n,), 0.99 * TTS.FLT_MAX)
    k = TTT.intersect_stream_tlas(pack, pos.to(cuda), d.to(cuda),
                                  tmin.to(cuda), tmax.to(cuda))
    w = TWB.walk_wide_plain(pk['wide'], pos, d, tmin, tmax)
    hit = w[1] >= 0
    assert ((k[1].cpu() >= 0) == hit).float().mean() >= 0.999
    both = hit & (k[1].cpu() >= 0)
    assert both.sum() > 100
    assert (k[1].cpu() == w[1])[both].float().mean() >= 0.999
    assert (k[4].cpu() == w[4])[both].float().mean() >= 0.999


def test_kernels_settle_ties_by_index_and_instance(cuda):
    """Equal t in different leaves and in different instances: the lower
    contract index, and the instance the contract TLAS's DFS meets first,
    win whatever the ray's direction (each ray and its mirror)."""
    # six coincident sheets of 64 quads each: every hit is a tie between a
    # triangle of the first sheet and its five twins, which leaves of at
    # most 4 cannot all hold together
    g = np.arange(8, dtype=np.float32)
    x, z = (a.reshape(-1) for a in np.meshgrid(g, g, indexing='ij'))
    low = np.stack([x, np.zeros_like(x), z], 1)
    sheet = np.zeros((128, 12), np.float32)
    sheet[:64, 0:3], sheet[:64, 3:6], sheet[:64, 6:9] = \
        low, (1, 0, 0), (0, 0, 1)
    sheet[64:, 0:3], sheet[64:, 3:6], sheet[64:, 6:9] = \
        low + (1, 0, 1), (-1, 0, 0), (0, 0, -1)
    tris12 = np.concatenate([sheet] * 6)
    wide = TWB.pack_wide_clusters(tris12).to(cuda)
    t12 = torch.from_numpy(tris12).to(cuda)
    rng = np.random.default_rng(5)
    n = 2048
    px = rng.uniform(0.1, 7.9, (n, 2)).astype(np.float32)
    pos = np.stack([px[:, 0], np.full(n, 2.0, np.float32), px[:, 1]], 1)
    d = np.tile(np.array([[0, -1, 0]], np.float32), (n, 1))
    for sign in (1.0, -1.0):
        P = torch.from_numpy(pos * np.array([1, sign, 1], np.float32)).to(cuda)
        D = torch.from_numpy(d * sign).to(cuda)
        tmin = torch.zeros(n, device=cuda)
        tmax = torch.full((n,), 1e30, device=cuda)
        # the card path reads the wide tables alone
        k = TTP.intersect_clusters(None, None, None, P, D, tmin, tmax,
                                   wide=wide)
        p = TTP.intersect_clusters_plain(t12, P, D, tmin, tmax)
        assert (p[1] >= 0).all() and (p[1] < 128).all()
        assert (k[1] >= 0).all() and (k[1] < 128).all()
        assert (k[1] == p[1]).float().mean() >= 0.999
    # the streamed kernels: the same sheet in two clusters, one reaching
    # down and one up, so a ray and its mirror enter them in opposite orders
    _, _, woop, _, grid, wide, _ = twin_clusters()
    wide, grid = wide.to(cuda), grid.to(cuda)
    woop = torch.from_numpy(woop).to(cuda)
    px = rng.uniform(0.1, 4.9, (n, 2)).astype(np.float32)
    pos = np.stack([px[:, 0], np.full(n, 2.0, np.float32), px[:, 1]], 1)
    for sign in (1.0, -1.0):
        P = torch.from_numpy(pos * np.array([1, sign, 1], np.float32)).to(cuda)
        D = torch.from_numpy(d * sign).to(cuda)
        tmin = torch.zeros(n, device=cuda)
        tmax = torch.full((n,), IPT_FLT_MAX, device=cuda)
        p = TTS.intersect_plain(woop, P, D, tmin,
                                torch.clamp(tmax, max=TTS.T_MAX_CAP))
        assert (p[1] >= 0).all() and (p[1] < 50).all()
        for k in (TTS.intersect_stream(None, None, None, P, D, tmin, tmax,
                                       wide=wide),
                  TTD.intersect_march(grid, None, P, D, tmin, tmax,
                                      wide=wide)):
            assert (k[1] >= 0).all() and (k[1] < 50).all()
            assert (k[1] == p[1]).float().mean() >= 0.999
    # two instances of one quad at the same place
    quad = (np.array([[-1, 0, -1], [-1, 0, -1]], np.float32),
            np.array([[2, 0, 0], [2, 0, 2]], np.float32),
            np.array([[2, 0, 2], [0, 0, 2]], np.float32))
    inst = [dict(geom_id=0, m0=np.eye(4, dtype=np.float32)) for _ in range(2)]
    pk = TTT.pack_stream_tlas([quad], inst)
    pack = TTT.tlas_pack(pk).to(cuda)
    leaves = pk['tlas_i'][:, 1]
    first = int(leaves[leaves >= 0][0])
    pos = np.stack([rng.uniform(-0.9, 0.9, n), np.full(n, 2.0),
                    rng.uniform(-0.9, 0.9, n)], 1).astype(np.float32)
    for sign in (1.0, -1.0):
        P = torch.from_numpy(pos * np.array([1, sign, 1], np.float32)).to(cuda)
        D = torch.from_numpy(d * sign).to(cuda)
        k = TTT.intersect_stream_tlas(pack, P, D, torch.zeros(n, device=cuda),
                                      torch.full((n,), 1e30, device=cuda))
        assert (k[1] >= 0).all() and (k[4] == first).all()


def twin_clusters():
    """Two clusters of 51 triangles: the same 5 x 5 sheet of quads at y = 0
    in both (equal t, the first cluster's 50 slots the lower), plus one
    small triangle below (cluster 0) or above (cluster 1), so a ray from
    above enters cluster 1's box first and one from below cluster 0's.
    Returns ``port_pack``'s tables."""
    g = np.arange(5, dtype=np.float32)
    x, z = (a.reshape(-1) for a in np.meshgrid(g, g, indexing='ij'))
    low = np.stack([x, np.zeros_like(x), z], 1)
    sheet = (np.concatenate([low, low + (1, 0, 1)]),
             np.repeat(np.array([[1, 0, 0], [-1, 0, 0]], np.float32), 25, 0),
             np.repeat(np.array([[0, 0, 1], [0, 0, -1]], np.float32), 25, 0))
    tips = [(np.array([[2, y, 2]], np.float32),
             np.array([[0.1, 0, 0]], np.float32),
             np.array([[0, 0, 0.1]], np.float32)) for y in (-5.0, 5.0)]
    v0, e1, e2 = (np.concatenate([sheet[j], tips[0][j], sheet[j],
                                  tips[1][j]]).astype(np.float32)
                  for j in range(3))
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    bvh = TB.FlatBVH(       # root, cluster 0, cluster 1 in DFS pre-order
        bmin=np.stack([lo.min(0), lo[:51].min(0), lo[51:].min(0)]),
        bmax=np.stack([hi.max(0), hi[:51].max(0), hi[51:].max(0)]),
        skip=np.array([-1, 2, -1], np.int32),
        tri_offset=np.array([0, 0, 51], np.int32),
        tri_count=np.array([0, 51, 51], np.int32),
        order=np.arange(102, dtype=np.int32))
    return port_pack(v0, e1, e2, bvh=bvh)


@pytest.mark.parametrize('any_hit', [False, True])
def test_cell_pass_kernel_and_dda_match_plain(cuda, any_hit):
    rng = np.random.default_rng(9)
    nf, ni, woop, _, _, wide, _ = port_pack(*random_scene(rng, 1200))
    grid = TTD.pack_grid(nf, ni, robust_aabb=False)
    n = 8192
    pos, d = random_rays(rng, n)
    # a third of the rays start exactly on interior cell faces in x
    m = n // 3
    pos[:m, 0] = grid.lo[0] + rng.integers(1, max(grid.dims[0], 2), m) \
        * grid.h[0]
    q = (torch.from_numpy(pos), torch.from_numpy(d), torch.zeros(n),
         torch.full((n,), 3.0 if any_hit else IPT_FLT_MAX))
    q[3][::11] = 0.0                                   # dead lanes
    tmax_c = torch.clamp(q[3], max=TTS.T_MAX_CAP)
    w_t = torch.from_numpy(woop)
    g_cpu, g_card, wide_card = grid.to('cpu'), grid.to(cuda), wide.to(cuda)
    on = TTS.ray_arrays('test', *(x.to(cuda) for x in q))
    # two rounds, one launch each (the first writes the entry), against the
    # plain round from the same state, lane for lane: best hit, cell, entry
    # t and done flag
    state = TTD.empty_state(n, cuda)
    plain = TTD.dda_entry(g_cpu, *q[:3], tmax_c)
    before = TTD.cell_pass.launches
    for r in range(2):
        count = torch.zeros(1, dtype=torch.int32, device=cuda)
        TTD.cell_pass(g_card, wide_card, on, state, count, any_hit,
                      first=r == 0)
        torch.cuda.synchronize()
        plain = TTD.cell_pass_plain(g_cpu, w_t, *q[:3], tmax_c, plain,
                                    any_hit)
        for name, a, b in zip(TTD.DdaState._fields, state, plain):
            assert torch.equal(a.cpu(), b), (r, name)
        assert int(count) == int((plain.done == 0).sum()) > 0
        # the next round from the plain state, as the card holds it
        state = TTD.DdaState(*(x.to(cuda) for x in plain))
    assert TTD.cell_pass.launches == before + 2
    assert (state.done.cpu()[::11] == 1).all()
    # the whole loop against the dense plain version, on every lane
    stats = {}
    k = TTD.intersect_dda(g_card, None, *(x.to(cuda) for x in q), any_hit,
                          stats=stats, wide=wide_card)
    assert stats['live'] == 0 and stats['rounds'] >= 2
    assert TTD.cell_pass.launches == before + 2 + stats['rounds']
    assert k[1].dtype == torch.int64
    p = TTS.intersect_plain(w_t, *q[:3], tmax_c, any_hit)
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)
    assert (p[1] >= 0).sum() > 100


def test_dda_on_the_card_needs_the_wide_table(cuda):
    """``intersect_dda`` on CUDA tensors walks ``wide`` and refuses a query
    without it, a tree whose cluster walk needs more stack than the kernel
    holds, or a table of another cluster count; nothing falls back to the
    plain rounds."""
    rng = np.random.default_rng(4)
    nf, ni, woop, _, _, wide, _ = port_pack(*random_scene(rng, 300))
    grid = TTD.pack_grid(nf, ni, robust_aabb=False).to(cuda)
    wide = wide.to(cuda)
    pos, d = (torch.from_numpy(a).to(cuda) for a in random_rays(rng, 64))
    q = (pos, d, torch.zeros(64, device=cuda),
         torch.full((64,), 1e30, device=cuda))
    woop = torch.from_numpy(woop).to(cuda)
    before = TTD.cell_pass.launches
    with pytest.raises(ValueError, match='wide'):
        TTD.intersect_dda(grid, woop, *q)
    with pytest.raises(ValueError, match='wide'):
        TTD.intersect_dda(grid, woop, *q, any_hit=True,
                          wide=dataclasses.replace(wide, cl_root=None))
    with pytest.raises(ValueError, match='stack'):
        TTD.intersect_dda(grid, woop, *q, wide=dataclasses.replace(
            wide, cl_stack=TWB.MARCH_STACK + 1))
    with pytest.raises(ValueError, match='clusters'):
        TTD.intersect_dda(grid, woop, *q, wide=dataclasses.replace(
            wide, cl_root=wide.cl_root[:-1]))
    with pytest.raises(ValueError):
        TTD.intersect_dda(grid, woop, *q, wide=dataclasses.replace(
            wide, rows=wide.rows.cpu()))
    assert TTD.cell_pass.launches == before
    TTD.intersect_dda(grid, None, *q, wide=wide)
    assert TTD.cell_pass.launches > before
    # a cap of two rounds (below READ_EVERY): the count of lanes left live
    # is read after the last launch and equals the plain rounds'
    card, plain = {}, {}
    TTD.intersect_dda(grid, None, *q, max_rounds=2, stats=card, wide=wide)
    TTD.intersect_dda(TTD.pack_grid(nf, ni, robust_aabb=False).to('cpu'),
                      woop.cpu(), *(x.cpu() for x in q), max_rounds=2,
                      stats=plain)
    assert card['rounds'] == plain['rounds'] == 2
    assert card['live'] == plain['live'] > 0


def test_march_kernel_unchanged_by_the_shared_cluster_visit(cuda):
    """K3 and K6 visit a cluster through one function
    (``visit_cluster``): on the small city's camera rays and on random rays
    K3 returns the dense plain version's t, u, v and triangle on every lane,
    as it did before it shared the visit, and K6 returns the same."""
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import synth
    scene, meta = synth.city_scene(**dict(CITY_KW, device=cuda))
    n = meta.width * meta.height
    pix = torch.arange(n, device=cuda)
    st = IPT.kernel_init_eye_ray(scene, meta, RNG.gen_init(pix), pix)
    rng = np.random.default_rng(5)
    pos = rng.uniform(-25, 25, (4096, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1])
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g0 = TTD.pack_grid(scene.st_nodes_f.cpu().numpy(),
                       scene.st_nodes_i.cpu().numpy(),
                       robust_aabb=False).to(cuda)
    for pos, d in ((st.ray_pos, st.ray_dir),
                   (torch.from_numpy(pos).to(cuda),
                    torch.from_numpy(d).to(cuda))):
        m = pos.shape[0]
        q = (pos, d, torch.zeros(m, device=cuda),
             torch.full((m,), IPT_FLT_MAX, device=cuda))
        want = TTS.intersect_plain(scene.st_woop, *q[:3],
                                   torch.clamp(q[3], max=TTS.T_MAX_CAP))
        march = TTD.intersect_march(scene.st_grid, None, *q,
                                    wide=scene.st_wide)
        cells = TTD.intersect_dda(g0, None, *q, wide=scene.st_wide)
        for got in (march, cells):
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        assert (want[1] >= 0).float().mean() > 0.3


@pytest.mark.parametrize('route', ['stream_tlas', 'clusters'])
def test_route_on_card_matches_cpu(cuda, route):
    """One trace pass of a small scene of the route's class on the card
    (through the route's kernel) against the same pass on the CPU (plain
    versions)."""
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import synth
    out = []
    for dev in ('cpu', cuda):
        if route == 'stream_tlas':
            scene, meta = synth.instanced_city_scene(
                n_blocks=3, subdiv=1, seed=5, width=48, height=32, depth=3,
                ground_subdiv=6, device=dev)
            wrapper = TTT.intersect_stream_tlas
            assert meta.use_stream_tlas
        else:
            scene, meta = synth.city_scene(
                n_blocks=8, subdiv=2, seed=3, width=32, height=16, depth=2,
                ground_subdiv=32, textured=True, device=dev)
            wrapper = TTP.intersect_clusters
            assert meta.use_pallas
        pix = torch.arange(meta.width * meta.height, device=dev)
        before = wrapper.launches
        acc, fl, _ = IPT.trace_pass(scene, meta, RNG.gen_init(pix), pix)
        if dev is cuda:
            assert wrapper.launches == before + 2 * meta.trace_depth
        out.append((acc.cpu().numpy(), fl.cpu().numpy()))
    (a_cpu, f_cpu), (a_gpu, f_gpu) = out
    assert np.isfinite(a_gpu).all()
    close = np.isclose(a_gpu, a_cpu, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.995
    assert (f_gpu == f_cpu).mean() >= 0.99


def test_slice_on_card_matches_cpu(cuda):
    """One trace pass of the small city on the card (through both kernels)
    against the same pass on the CPU (plain versions)."""
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import synth
    out = []
    for dev in ('cpu', cuda):
        scene, meta = synth.city_scene(**dict(CITY_KW, device=dev))
        pix = torch.arange(meta.width * meta.height, device=dev)
        n_s = TTS.intersect_stream.launches
        n_m = TTD.intersect_march.launches
        acc, fl, _ = IPT.trace_pass(scene, meta, RNG.gen_init(pix), pix)
        if dev is cuda:
            assert TTS.intersect_stream.launches > n_s
            assert TTD.intersect_march.launches > n_m
        out.append((acc.cpu().numpy(), fl.cpu().numpy()))
    (a_cpu, f_cpu), (a_gpu, f_gpu) = out
    assert np.isfinite(a_gpu).all()
    close = np.isclose(a_gpu, a_cpu, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.995
    assert (f_gpu == f_cpu).mean() >= 0.999


def _box_on(cuda, width=128, height=96, depth=6, wall_subdiv=1):
    from hydracore3_torch.scene import synth
    scene, meta = synth.box_scene(width, height, depth, textured=True,
                                  wall_subdiv=wall_subdiv, device=cuda)
    pk = TMK.pack(scene, meta)
    xy, su = TMK.lane_setup(meta, cuda)
    return pk, xy, su, depth


def test_mega_sample_kernel_matches_plain(cuda):
    """K1's fixed chain on the textured box (taps, reflectivity, point and
    sphere lights) against the plain version on the same lanes."""
    pk, xy, su, depth = _box_on(cuda)
    before = TMK.sample_pass.launches
    k = TMK.sample_pass(pk, xy, su, depth)
    torch.cuda.synchronize()
    assert TMK.sample_pass.launches == before + 1
    assert torch.isfinite(k[0]).all()
    close, equal, err = TMK.lanes_agree(
        k, TMK.sample_pass_plain(pk, xy, su, depth), 3)
    assert close == 1.0 and equal == 1.0, (close, equal, err)


def test_mega_regen_kernel_matches_plain(cuda):
    """K1's persistent-lane kernel: rfirst + 15 rmid, then 16 more, against
    the plain version's state."""
    pk, xy, su, depth = _box_on(cuda)
    before = TMK.regen_pass.launches
    sf, su2 = TMK.regen_pass(pk, xy, None, su, 16, depth, first=True)
    k = TMK.regen_pass(pk, xy, sf, su2, 16, depth)
    torch.cuda.synchronize()
    assert TMK.regen_pass.launches == before + 2
    sf_p, su_p = TMK.regen_iters_plain(pk, xy, None, su, 16, depth,
                                       first=True)
    p = TMK.regen_iters_plain(pk, xy, sf_p, su_p, 16, depth)
    close, equal, err = TMK.lanes_agree(k, p, TMK.RU_NROWS)
    assert close == 1.0 and equal == 1.0, (close, equal, err)


def test_regen_frame_counts_its_launches_and_iterations(cuda, monkeypatch):
    """A regen frame's timing on the card: ``launches`` equal the calls a
    wrap of ``megakernel.regen_pass`` sees (``render`` reaches the wrapper
    through the module's name), ``iters`` the iterations they ask for."""
    from hydracore3_torch import render as R
    from hydracore3_torch.scene import synth
    scene, meta = synth.box_scene(128, 96, 6, textured=True, device=cuda)
    seen = dict(calls=0, iters=0)
    inner = TMK.regen_pass

    def regen_pass(pk, xy, sf, su, k, *args, **kw):
        seen['calls'] += 1
        seen['iters'] += int(k)
        return inner(pk, xy, sf, su, k, *args, **kw)

    regen_pass.launches = inner.launches
    monkeypatch.setattr(TMK, 'regen_pass', regen_pass)
    _, timing = R.render(scene, meta, spp=64, regen=True, return_timing=True)
    assert seen['calls'] >= 2 and timing['launches'] == seen['calls']
    assert timing['iters'] == seen['iters']
    assert timing['samples'] >= 128 * 96 * 64


def test_wrappers_refuse_wrong_inputs(cuda):
    nf, ni, woop, grid, pos, d, _, wide = _soup(cuda, n_rays=128)
    tmin = torch.zeros(128, device=cuda)
    tmax = torch.full((128,), 1e30, device=cuda)
    # the streamed queries: no table, or a wrong one, is refused on the card
    # (never the old walks or the plain version)
    n = TTS.intersect_stream.launches, TTD.intersect_march.launches
    with pytest.raises(ValueError, match='wide'):
        TTS.intersect_stream(nf, ni, woop, pos, d, tmin, tmax)
    with pytest.raises(ValueError, match='wide'):
        TTS.intersect_stream(nf, ni, woop, pos, d, tmin, tmax, any_hit=True)
    with pytest.raises(ValueError, match='wide'):
        TTD.intersect_march(grid, woop, pos, d, tmin, tmax)
    with pytest.raises(ValueError):
        TTS.intersect_stream(nf, ni, woop, pos, d, tmin, tmax,
                             wide=dataclasses.replace(
                                 wide, index=wide.index.long()))
    with pytest.raises(ValueError):
        TTS.intersect_stream(nf, ni, woop, pos, d, tmin, tmax,
                             wide=dataclasses.replace(
                                 wide, nodes=wide.nodes.cpu()))
    with pytest.raises(ValueError, match='stack'):
        TTS.intersect_stream(nf, ni, woop, pos, d, tmin, tmax,
                             wide=dataclasses.replace(
                                 wide, stack=TWB.MAX_STACK + 1))
    with pytest.raises(ValueError):
        TTD.intersect_march(grid, woop, pos, d, tmin, tmax,
                            wide=dataclasses.replace(
                                wide, cl_root=wide.cl_root.long()))
    with pytest.raises(ValueError):
        TTD.intersect_march(dataclasses.replace(
            grid, cell_tab=grid.cell_tab.cpu()), woop, pos, d, tmin, tmax,
            wide=wide)
    with pytest.raises(ValueError, match='stack'):
        TTD.intersect_march(grid, woop, pos, d, tmin, tmax,
                            wide=dataclasses.replace(
                                wide, cl_stack=TWB.MARCH_STACK + 1))
    assert (TTS.intersect_stream.launches,
            TTD.intersect_march.launches) == n
    # the later ray-query wrappers: tables on the wrong device or dtype
    _, pack = _instanced(cuda, n_inst=4)
    with pytest.raises(ValueError):
        TTT.intersect_stream_tlas(
            dataclasses.replace(pack, inst_f=pack.inst_f.cpu()), pos, d,
            tmin, tmax)
    with pytest.raises(ValueError):
        TTT.intersect_stream_tlas(
            dataclasses.replace(pack, tlas_i=pack.tlas_i.long()), pos, d,
            tmin, tmax)
    with pytest.raises(ValueError):
        TTT.intersect_stream_tlas(
            dataclasses.replace(pack, wide=dataclasses.replace(
                pack.wide, index=pack.wide.index.long())), pos, d, tmin, tmax)
    with pytest.raises(ValueError, match='stack'):
        TTT.intersect_stream_tlas(
            dataclasses.replace(pack, wide=dataclasses.replace(
                pack.wide, stack=TWB.MAX_STACK + 1)), pos, d, tmin, tmax)
    with pytest.raises(ValueError, match='wide'):
        TTT.intersect_stream_tlas(dataclasses.replace(pack, wide=None), pos,
                                  d, tmin, tmax)
    _, _, (cnf, cni, tris12), _, wide = _cluster_soup(cuda, n_tris=40)
    with pytest.raises(ValueError):
        TTP.intersect_clusters(cnf, cni, tris12, pos, d, tmin, tmax,
                               wide=dataclasses.replace(
                                   wide, rows=wide.rows.double()))
    with pytest.raises(ValueError):
        TTP.intersect_clusters(cnf, cni, tris12, pos, d, tmin, tmax,
                               wide=dataclasses.replace(
                                   wide, nodes=wide.nodes.cpu()))
    with pytest.raises(ValueError, match='wide'):
        TTP.intersect_clusters(cnf, cni, tris12, pos, d, tmin, tmax)
    with pytest.raises(ValueError, match='stack'):
        TTP.intersect_clusters(cnf, cni, tris12, pos, d, tmin, tmax,
                               wide=dataclasses.replace(
                                   wide, stack=TWB.MAX_STACK + 1))
    # the wide-BVH kernels read the rays by raw address: a ray tensor off
    # ray_pos's card, or of another shape, is refused
    for bad in ((pos, d.cpu(), tmin, tmax), (pos, d, tmin.cpu(), tmax),
                (pos, d, tmin, tmax.cpu()), (pos, d, tmin, tmax[:1]),
                (pos, d, tmin[:, None], tmax), (pos, d, tmin, tmax[:, None]),
                (torch.cat([pos, pos[:, :1]], 1), d, tmin, tmax),
                (pos, d[:64], tmin, tmax)):
        with pytest.raises(ValueError):
            TTP.intersect_clusters(cnf, cni, tris12, *bad, wide=wide)
        with pytest.raises(ValueError):
            TTT.intersect_stream_tlas(pack, *bad)
        with pytest.raises(ValueError):
            TTS.intersect_stream(nf, ni, woop, *bad, wide=wide)
        with pytest.raises(ValueError):
            TTD.intersect_march(grid, woop, *bad, wide=wide)
    with pytest.raises(ValueError, match='outlier'):
        TTD.intersect_dda(dataclasses.replace(grid, n_outliers=1), woop, pos,
                          d, tmin, tmax)
    flat = TTD.pack_grid(nf.cpu().numpy(), ni.cpu().numpy(),
                         robust_aabb=False)
    with pytest.raises(ValueError):
        TTD.intersect_dda(flat.to(cuda), woop.cpu(), pos, d, tmin, tmax)
    # a CUDA scene launches K1 or raises: never the plain version
    pk, xy, su, depth = _box_on(cuda, 32, 16, 2)
    n = TMK.sample_pass.launches, TMK.regen_pass.launches
    cpu_pk = dataclasses.replace(pk, woop=pk.woop.cpu())
    with pytest.raises(ValueError):
        TMK.sample_pass(cpu_pk, xy, su, depth)
    with pytest.raises(ValueError):
        TMK.sample_pass(pk, xy, su.to(torch.int32), depth)
    with pytest.raises(ValueError):
        TMK.regen_pass(pk, xy.double(), None, su, 4, depth, first=True)
    sf, su2 = TMK.regen_pass(pk, xy, None, su, 4, depth, first=True)
    with pytest.raises(ValueError):
        TMK.regen_pass(pk, xy, sf[:10], su2, 4, depth)
    assert (TMK.sample_pass.launches, TMK.regen_pass.launches) == (
        n[0], n[1] + 1)


@pytest.mark.parametrize('regen', [False, True])
def test_mega_kernels_match_plain_on_tessellated_box(cuda, regen):
    """Both K1 entry points on the box whose walls are 20 x 20 grids (4,006
    triangles, shared edges everywhere): the wide walk returns the brute
    trace's hits, so every lane equals the plain version's."""
    pk, xy, su, depth = _box_on(cuda, 64, 48, 6, wall_subdiv=20)
    assert pk.n_tris == 4096 and pk.wide.stack <= TMK.MEGA_STACK
    if regen:
        sf, su2 = TMK.regen_pass(pk, xy, None, su, 16, depth, first=True)
        k = TMK.regen_pass(pk, xy, sf, su2, 16, depth)
        sf_p, su_p = TMK.regen_iters_plain(pk, xy, None, su, 16, depth,
                                           first=True)
        p = TMK.regen_iters_plain(pk, xy, sf_p, su_p, 16, depth)
        rows = TMK.RU_NROWS
    else:
        k = TMK.sample_pass(pk, xy, su, depth)
        p = TMK.sample_pass_plain(pk, xy, su, depth)
        rows = 3
    torch.cuda.synchronize()
    close, equal, err = TMK.lanes_agree(k, p, rows)
    assert close == 1.0 and equal == 1.0 and err == 0.0, (close, equal, err)


def test_mega_wrappers_refuse_a_pack_without_its_wide_table(cuda):
    pk, xy, su, depth = _box_on(cuda, 32, 16, 2)
    n = TMK.sample_pass.launches, TMK.regen_pass.launches
    with pytest.raises(ValueError, match='wide'):
        TMK.sample_pass(dataclasses.replace(pk, wide=None), xy, su, depth)
    with pytest.raises(ValueError, match='stack'):
        TMK.regen_pass(dataclasses.replace(pk, wide=dataclasses.replace(
            pk.wide, stack=TMK.MEGA_STACK + 1)), xy, None, su, 4, depth,
            first=True)
    with pytest.raises(ValueError):
        TMK.sample_pass(dataclasses.replace(pk, wide=dataclasses.replace(
            pk.wide, index=pk.wide.index.long())), xy, su, depth)
    assert (TMK.sample_pass.launches, TMK.regen_pass.launches) == n


def test_woop_kernels_settle_edge_ties_as_plain(cuda):
    """Coplanar triangles sharing edges, rays through the edges: K2
    nearest, K3 and K6 return the dense plain version's t, u, v and
    triangle on every lane.  That needs the kernels' Woop test to round as
    the plain version's does (no FMA contraction): an ulp of t decides
    which neighbour wins."""
    rng = np.random.default_rng(21)
    soup, edges, normal = tilted_sheet(rng)
    nf, ni, woop, _, grid, wide, _ = port_pack(*soup)
    n = 4096
    k = rng.integers(0, len(edges), n)
    s_ = rng.uniform(0.05, 0.95, n)[:, None]
    q = (1.0 - s_) * edges[k, 0] + s_ * edges[k, 1]
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0)[:, None]
    org = q + side * (2.0 * normal + rng.uniform(-0.6, 0.6, (n, 3)))
    d = q - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = torch.from_numpy(org.astype(np.float32))
    d = torch.from_numpy(d.astype(np.float32))
    tmin = torch.zeros(n)
    tmax = torch.full((n,), IPT_FLT_MAX)
    want = TTS.intersect_plain(torch.from_numpy(woop), pos, d, tmin,
                               torch.clamp(tmax, max=TTS.T_MAX_CAP))
    # the Woop test is not watertight: a ray exactly through an edge can
    # miss both neighbours
    assert (want[1] >= 0).float().mean() > 0.5
    on = [x.to(cuda) for x in (pos, d, tmin, tmax)]
    flat = TTD.pack_grid(nf, ni, robust_aabb=False)
    for got in (TTS.intersect_stream(None, None, None, *on,
                                     wide=wide.to(cuda)),
                TTD.intersect_march(grid.to(cuda), None, *on,
                                    wide=wide.to(cuda)),
                TTD.intersect_dda(flat.to(cuda), None, *on,
                                  wide=wide.to(cuda))):
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_march_stops_at_a_tie_on_a_cell_face_as_its_plain_rounds(cuda):
    """K3 (and K6) at an equal-t tie on a cell face: the march stops once
    the best t lies at the cell's exit, so a +x ray keeps cluster 1's
    triangle and never sees the lower slot listed only in the next cell
    (the rule the JAX march keeps, tests/test_torch_traverse.py); K3 and
    K6 return what the port's plain rounds (``intersect_dda`` on the CPU)
    return, t, u, v and triangle, on every lane."""
    nf, ni, woop, soup, grid, (pos, d), _ = face_tie_scene()
    wide = TWB.pack_wide_stream(nf, ni, woop, *soup)
    n = pos.shape[0]
    q = (torch.from_numpy(pos), torch.from_numpy(d), torch.zeros(n),
         torch.full((n,), IPT_FLT_MAX))
    w_t = torch.from_numpy(woop)
    want = TTD.intersect_dda(grid.to('cpu'), w_t, *q)
    assert (want[1][:n // 2] >= 64).all() and (want[1][n // 2:] < 2).all()
    on = [x.to(cuda) for x in q]
    march = TTD.intersect_march(grid.to(cuda), None, *on, wide=wide.to(cuda))
    cells = TTD.intersect_dda(grid.to(cuda), None, *on, wide=wide.to(cuda))
    for got in (march, cells):
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_dda_settles_a_tie_met_in_two_cells_as_plain(cuda):
    """K6 on ``cross_cell_tie_scene``: the lower slot wins an equal t
    across rounds, so every lane returns the dense plain version's t, u, v
    and triangle (the lane's best rides in its state)."""
    nf, ni, woop, soup, grid, (pos, d), _ = cross_cell_tie_scene()
    wide = TWB.pack_wide_stream(nf, ni, woop, *soup)
    n = pos.shape[0]
    q = (torch.from_numpy(pos), torch.from_numpy(d), torch.zeros(n),
         torch.full((n,), IPT_FLT_MAX))
    want = TTS.intersect_plain(torch.from_numpy(woop), *q[:3],
                               torch.clamp(q[3], max=TTS.T_MAX_CAP))
    assert (want[1] == 0).all()
    got = TTD.intersect_dda(grid.to(cuda), None, *(x.to(cuda) for x in q),
                            wide=wide.to(cuda))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize('name', ['box', 'city'])
def test_loaded_library_matches_plain_and_build(cuda, name, tmp_path):
    """The small box and the small city written by the port's writer and
    loaded by ``load_scene`` (and committed through ``api``) on the card,
    where both go with no device given: K1's two entry points (the box)
    and K2's and K3's camera query (the city) against their plain versions
    on every lane, and a render equal to the render of ``build_scene`` of
    the same description."""
    from hydracore3_torch import api
    from hydracore3_torch import render as R
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth
    if name == 'box':
        desc, accel = synth.build_box(128, 96, 6, textured=True), 'auto'
    else:
        desc, accel = synth.build_city(**{
            k: v for k, v in CITY_KW.items() if k != 'accel'}), 'stream'
    path = api.write_library(desc, str(tmp_path))
    # with no device given, the load and the commit go to the card
    scene, meta = B.load_scene(path, accel=accel)
    handle = api.hr2_create_scene()
    handle.desc = desc
    committed, cmeta = handle.commit(str(tmp_path / 'commit'), accel=accel)
    built, bmeta = B.build_scene(desc, device=cuda, accel=accel)
    assert meta == bmeta == cmeta
    assert scene.proj_inv.is_cuda and committed.tri_shade.is_cuda
    if name == 'box':
        pk = TMK.pack(scene, meta)
        xy, su = TMK.lane_setup(meta, cuda)
        depth = meta.trace_depth
        close, equal, _ = TMK.lanes_agree(
            TMK.sample_pass(pk, xy, su, depth),
            TMK.sample_pass_plain(pk, xy, su, depth), 3)
        assert close == 1.0 and equal == 1.0
        sf, su2 = TMK.regen_pass(pk, xy, None, su, 16, depth, first=True)
        sf_p, su_p = TMK.regen_iters_plain(pk, xy, None, su, 16, depth,
                                           first=True)
        close, equal, _ = TMK.lanes_agree(
            TMK.regen_pass(pk, xy, sf, su2, 16, depth),
            TMK.regen_iters_plain(pk, xy, sf_p, su_p, 16, depth),
            TMK.RU_NROWS)
        assert close == 1.0 and equal == 1.0
        renders = [R.render(s, meta, spp=4, regen=regen)
                   for regen in (False, True) for s in (scene, built)]
    else:
        pix = torch.arange(meta.width * meta.height, device=cuda)
        st = IPT.kernel_init_eye_ray(scene, meta, RNG.gen_init(pix), pix)
        n = pix.shape[0]
        q = (st.ray_pos, st.ray_dir, torch.zeros(n, device=cuda),
             torch.full((n,), IPT_FLT_MAX, device=cuda))
        want = TTS.intersect_plain(scene.st_woop.cpu(), *(x.cpu() for x in
                                                          q[:3]),
                                   torch.clamp(q[3], max=TTS.T_MAX_CAP).cpu())
        assert (want[1] >= 0).float().mean() > 0.5
        for got in (TTS.intersect_stream(None, None, None, *q,
                                         wide=scene.st_wide),
                    TTD.intersect_march(scene.st_grid, None, *q,
                                        wide=scene.st_wide)):
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
        renders = [R.render(s, meta, spp=4) for s in (scene, built)]
    for a, b in zip(renders[0::2], renders[1::2]):
        assert np.isfinite(a).all() and np.array_equal(a, b)


# ---- the material zoo (tests/zoo_scenes.py) ------------------------------------

def _zoo_box_on(cuda, tmp_path, width=128, height=96, depth=6,
                wall_subdiv=1):
    import zoo_scenes
    from hydracore3_torch.scene import build as B
    scene, meta = B.load_scene(zoo_scenes.write_zoo_box(
        str(tmp_path), width, height, depth, wall_subdiv), device=cuda)
    pk = TMK.pack(scene, meta)
    xy, su = TMK.lane_setup(meta, cuda)
    return pk, xy, su, depth


@pytest.mark.parametrize('regen', [False, True])
@pytest.mark.parametrize('name', ['naivept', 'shadowpt', 'mispt'])
def test_mega_kernels_match_plain_on_the_zoo_box(cuda, tmp_path, name,
                                                 regen):
    """K1's variant for the integrator, every material type and the env tap
    (conductors, diffuse, dielectric, glass, a disc light, an 8-bit sky)
    against the plain version on every lane: the fixed chain, or rfirst
    and 15 rmid iterations then 16 more."""
    pk, xy, su, depth = _zoo_box_on(cuda, tmp_path)
    itype = TMK.INTEGRATOR_BY_NAME[name]
    assert TMK.variant_of(pk, itype) == (itype, 63, True)
    if regen:
        sf, su2 = TMK.regen_pass(pk, xy, None, su, 16, depth, first=True,
                                 integrator=itype)
        k = TMK.regen_pass(pk, xy, sf, su2, 16, depth, integrator=itype)
        sf_p, su_p = TMK.regen_iters_plain(pk, xy, None, su, 16, depth,
                                           first=True, integrator=itype)
        p = TMK.regen_iters_plain(pk, xy, sf_p, su_p, 16, depth,
                                  integrator=itype)
        rows = TMK.RU_NROWS
    else:
        k = TMK.sample_pass(pk, xy, su, depth, itype)
        p = TMK.sample_pass_plain(pk, xy, su, depth, itype)
        rows = 3
        assert torch.isfinite(k[0]).all()
    close, equal, err = TMK.lanes_agree(k, p, rows)
    assert close == 1.0 and equal == 1.0, (close, equal, err)


@pytest.mark.parametrize('regen', [False, True])
@pytest.mark.parametrize('name', ['naivept', 'shadowpt', 'mispt'])
def test_mega_spectral_kernels_match_plain(cuda, tmp_path, name, regen):
    """K1's spectral variant for the integrator on the spectral box (SPD
    diffuses, gold-like conductors, a blackbody light, a flat sky with an
    SPD; 128 x 96, depth 6) against the plain version on every lane: the
    fixed chain, or rfirst and 15 rmid iterations then 16 more, the state
    with its 4 wavelength rows."""
    import zoo_scenes
    from hydracore3_torch.scene import build as B
    scene, meta = B.load_scene(zoo_scenes.write_spectral_box(
        str(tmp_path), 128, 96, 6), spectral_mode=True, device=cuda)
    pk = TMK.pack(scene, meta)
    xy, su = TMK.lane_setup(meta, cuda)
    itype = TMK.INTEGRATOR_BY_NAME[name]
    assert TMK.variant_of(pk, itype)[3:] == (True,)
    if regen:
        sf, su2 = TMK.regen_pass(pk, xy, None, su, 16, 6, first=True,
                                 integrator=itype)
        assert sf.shape[0] == TMK.rf_nrows(True)
        k = TMK.regen_pass(pk, xy, sf, su2, 16, 6, integrator=itype)
        sf_p, su_p = TMK.regen_iters_plain(pk, xy, None, su, 16, 6,
                                           first=True, integrator=itype)
        p = TMK.regen_iters_plain(pk, xy, sf_p, su_p, 16, 6,
                                  integrator=itype)
        rows = TMK.RU_NROWS
    else:
        k = TMK.sample_pass(pk, xy, su, 6, itype)
        p = TMK.sample_pass_plain(pk, xy, su, 6, itype)
        rows = 3
        assert torch.isfinite(k[0]).all()
    close, equal, err = TMK.lanes_agree(k, p, rows)
    assert close == 1.0 and equal == 1.0, (close, equal, err)


# ---- K1's pools, its table layouts and its edge cases, per variant -----------

K1_CASES = [('box', 'mispt')] + [(sc, n) for sc in ('zoo', 'spectral')
                                 for n in ('naivept', 'shadowpt', 'mispt')]


def _k1_scene(cuda, tmp_path, scene, width=128, height=96, wall_subdiv=1):
    """(pack, xy, su, depth) of the textured box (the GLTF variant), the
    zoo box or the spectral box, each with its walls cut into grids of
    ``wall_subdiv`` quads a side."""
    if scene == 'box':
        return _box_on(cuda, width, height, 6, wall_subdiv)
    if scene == 'zoo':
        return _zoo_box_on(cuda, tmp_path, width, height, 6, wall_subdiv)
    import zoo_scenes
    from hydracore3_torch.scene import build as B
    sc, meta = B.load_scene(zoo_scenes.write_spectral_box(
        str(tmp_path), width, height, 6, wall_subdiv=wall_subdiv),
        spectral_mode=True, device=cuda)
    pk = TMK.pack(sc, meta)
    xy, su = TMK.lane_setup(meta, cuda)
    return pk, xy, su, 6


def _every(shares, n):
    """(close, equal, max|d|) of ``lanes_agree`` held on all ``n`` lanes (a
    share is a mean that the card rounds: 123 of 123 may read 0.99999994)."""
    close, equal, _ = shares
    return round(close * n) == n and round(equal * n) == n


def _k1_both(pk, xy, su, depth, itype, k=16):
    """Both entry points against the plain version on every lane: the fixed
    chain, rfirst with k - 1 rmid iterations, then k more."""
    k_f = TMK.sample_pass(pk, xy, su, depth, itype)
    agree = [TMK.lanes_agree(k_f, TMK.sample_pass_plain(pk, xy, su, depth,
                                                        itype), 3)]
    sf, su2 = TMK.regen_pass(pk, xy, None, su, k, depth, first=True,
                             integrator=itype)
    sf_p, su_p = TMK.regen_iters_plain(pk, xy, None, su, k, depth,
                                       first=True, integrator=itype)
    agree.append(TMK.lanes_agree((sf, su2), (sf_p, su_p), TMK.RU_NROWS))
    agree.append(TMK.lanes_agree(
        TMK.regen_pass(pk, xy, sf, su2, k, depth, integrator=itype),
        TMK.regen_iters_plain(pk, xy, sf_p, su_p, k, depth,
                              integrator=itype), TMK.RU_NROWS))
    return agree


@pytest.mark.parametrize('scene,name', K1_CASES)
def test_mega_kernels_on_a_ragged_lane_count(cuda, tmp_path, scene, name):
    """Lane counts that are no multiple of a pool or of a block (the last
    pool ragged), and fewer lanes than one pool: both entry points equal
    the plain version on every lane."""
    pk, xy, su, depth = _k1_scene(cuda, tmp_path, scene)
    itype = TMK.INTEGRATOR_BY_NAME[name]
    # lanes a pool (one lane a thread, pool 0: a block's)
    pool = TMK.kernel_attrs(TMK.kernel_library(TMK.variant_of(pk, itype)),
                            pk)['mega_regen_kernel']['pool'] or 128
    for m in (3 * pool + 37, pool - 5, 1):
        assert m % 128 and m % pool
        xs, ss = xy[:, :m].contiguous(), su[:, :m].contiguous()
        for agree in _k1_both(pk, xs, ss, depth, itype):
            assert _every(agree, m), (m, agree)


@pytest.mark.parametrize('scene,name', K1_CASES)
def test_mega_regen_one_iteration_and_first_alone(cuda, tmp_path, scene,
                                                  name):
    """A ``first`` launch alone (rfirst, k = 1), then single iterations:
    every lane's state equals the plain version's after each launch."""
    pk, xy, su, depth = _k1_scene(cuda, tmp_path, scene)
    itype = TMK.INTEGRATOR_BY_NAME[name]
    sf, su2 = TMK.regen_pass(pk, xy, None, su, 1, depth, first=True,
                             integrator=itype)
    sf_p, su_p = TMK.regen_iters_plain(pk, xy, None, su, 1, depth,
                                       first=True, integrator=itype)
    for step in range(4):
        agree = TMK.lanes_agree((sf, su2), (sf_p, su_p), TMK.RU_NROWS)
        assert _every(agree, xy.shape[1]), (step, agree)
        sf, su2 = TMK.regen_pass(pk, xy, sf, su2, 1, depth,
                                 integrator=itype)
        sf_p, su_p = TMK.regen_iters_plain(pk, xy, sf_p, su_p, 1, depth,
                                           integrator=itype)
    assert (su2[TMK.RU_NDONE] > 0).any()


def _camera_away(pk):
    """The pack with its camera turned around (the world-view rotation
    negated): every camera ray leaves the scene."""
    c = pk.consts.clone()
    for r in range(3):
        c[TMK.CN_WVI + 4 * r:TMK.CN_WVI + 4 * r + 3] *= -1
    return dataclasses.replace(pk, consts=c)


@pytest.mark.parametrize('scene,name', K1_CASES)
def test_mega_kernels_when_every_camera_ray_misses(cuda, tmp_path, scene,
                                                   name):
    """A frame whose camera rays all miss: every lane restarts on every
    regen iteration (a pool's shade lists stay empty, its restart list
    full) and the fixed chain ends at its first bounce; both entry points
    equal the plain version on every lane."""
    pk, xy, su, depth = _k1_scene(cuda, tmp_path, scene)
    pk = _camera_away(pk)
    itype = TMK.INTEGRATOR_BY_NAME[name]
    _, su_p = TMK.regen_iters_plain(pk, xy, None, su, 1, depth, first=True,
                                    integrator=itype)
    assert ((su_p[2] & 0x40000000) != 0).all()      # FLAG_OUT_OF_SCENE
    for agree in _k1_both(pk, xy, su, depth, itype):
        assert _every(agree, xy.shape[1]), agree


@pytest.mark.parametrize('scene,subdiv', [(sc, sub) for sc in
                                          ('box', 'zoo', 'spectral')
                                          for sub in (1, 20)])
def test_mega_table_layouts(cuda, tmp_path, scene, subdiv):
    """The layout is chosen by the pack's bytes: the box's, the zoo box's
    and the spectral box's geometry and walk stacks sit in shared memory;
    with their walls cut into 20 x 20 grids (over 4,000 triangles, a stack
    of about 19 entries) in device and local memory.  The ``mispt``
    variant's both entry points, one lane a thread (the box) or pooled
    (the zoo and spectral boxes), equal the plain version on every lane
    in either."""
    if subdiv == 1:
        pk, xy, su, depth = _k1_scene(cuda, tmp_path, scene)
    else:
        pk, xy, su, depth = _k1_scene(cuda, tmp_path, scene, 64, 48, subdiv)
    itype = TMK.INTEGRATOR_MIS_PT
    attrs = TMK.kernel_attrs(TMK.kernel_library(TMK.variant_of(pk, itype)),
                             pk)
    want = 'device' if subdiv > 1 else 'chip'
    for a in attrs.values():
        assert a['layout'] == want and a['blocks_per_sm'] >= 1, attrs
        assert (a['pool'] > 0) == (scene != 'box'), attrs
    for agree in _k1_both(pk, xy, su, depth, itype):
        assert _every(agree, xy.shape[1]), agree


def test_zoo_city_refracted_lanes_match_plain(cuda, tmp_path):
    """K3's nearest query (and K2 on the lanes the march leaves) and K2's
    any-hit on the small zoo city's first-bounce rays, which start inside
    the dielectric and glass walls after a refraction, against the plain
    versions on every lane."""
    import zoo_scenes
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_zoo_city(str(tmp_path), **{
        k: v for k, v in CITY_KW.items() if k != 'accel'})
    sc, mt = B.load_scene(path, accel='stream', device=cuda)
    n = mt.width * mt.height
    pix = torch.arange(n, device=cuda)
    st = IPT.kernel_init_eye_ray(sc, mt, RNG.gen_init(pix), pix)
    st = IPT.kernel_ray_trace(sc, mt, st, 0)
    cx = IPT.MAT.make_shading_ctx(sc, mt, IPT._extract_mat_id(st.flags),
                                  st.hit_norm, st.hit_tang, st.hit_uv)
    sh, r2 = IPT.kernel_sample_light_source(sc, mt, st, cx)
    st = IPT.kernel_next_bounce(sc, mt, st._replace(rng=r2), 0, sh, cx)
    refracted = ((st.flags & IPT.C.RAY_EVENT_T) != 0) & ~IPT._is_dead(
        st.flags)
    assert refracted.any()
    live = ~IPT._is_dead(st.flags)
    q = (st.ray_pos, st.ray_dir, torch.zeros(n, device=cuda),
         torch.where(live, IPT_FLT_MAX, 0.0))
    plain = TTS.intersect_plain(sc.st_woop, *q[:3], torch.clamp(
        q[3], max=0.99 * TTS.FLT_MAX))
    *km, un = TTD.intersect_march(sc.st_grid, sc.st_woop, *q,
                                  with_unresolved=True, wide=sc.st_wide)
    ks = TTS.intersect_stream(sc.st_nodes_f, sc.st_nodes_i, sc.st_woop, *q,
                              wide=sc.st_wide)
    assert int(un.sum()) == 0
    for k in (km, ks):
        a = TTS.hits_agree(k, plain, False)
        assert a['hit_diff'] == 0 and a['tri_diff'] == 0, a


@pytest.mark.parametrize('any_hit', [False, True])
def test_clusters_kernel_on_a_small_scene(cuda, tmp_path, any_hit):
    """K5 over a small scene's rows (the zoo box II, which the megakernel
    refuses: ``scene.cl_wide`` over ``scene.cl_tris12``) against its plain
    version on the camera rays and random rays from inside the box; under
    any-hit each reported triangle occludes its lane."""
    import zoo_scenes
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_zoo_box2(str(tmp_path), 64, 48, 3)
    sc, mt = B.load_scene(path, device=cuda)
    assert not (mt.use_stream or mt.use_pallas or mt.use_stream_tlas)
    n = mt.width * mt.height
    pix = torch.arange(n, device=cuda)
    st = IPT.kernel_init_eye_ray(sc, mt, RNG.gen_init(pix), pix)
    rng = np.random.default_rng(41)
    pos, d = random_rays(rng, n, box=3.8)
    pos = torch.cat([st.ray_pos, torch.from_numpy(pos).to(cuda)])
    d = torch.cat([st.ray_dir, torch.from_numpy(d).to(cuda)])
    tmin = torch.zeros(2 * n, device=cuda)
    tmax = torch.full((2 * n,), 3.0 if any_hit else IPT_FLT_MAX,
                      device=cuda)
    before = TTP.intersect_clusters.launches
    k = TTP.intersect_clusters(sc.cl_nodes_f, sc.cl_nodes_i, sc.cl_tris12,
                               pos, d, tmin, tmax, any_hit, wide=sc.cl_wide)
    torch.cuda.synchronize()
    assert TTP.intersect_clusters.launches == before + 1
    p = TTP.intersect_clusters_plain(sc.cl_tris12, pos, d, tmin, tmax,
                                     any_hit)
    _assert_clusters_equal(sc, k, p, (pos, d, tmin, tmax), any_hit)


def _assert_clusters_equal(sc, k, p, q, any_hit):
    """K5 equals its plain version on every lane: hit flags and, for the
    nearest hit, t, triangle, u and v bit for bit; under any-hit the
    reported triangle occludes its lane (the walk reports the first
    occluder it meets)."""
    a = TTS.hits_agree(k, p, any_hit)
    assert a['hit_diff'] == 0 and (any_hit or a['both'] > 100), a
    if any_hit:
        valid = TTP.occluder_valid(sc.cl_tris12, k[1], *q)
        assert torch.equal(valid, k[1] >= 0)
    else:
        assert a['tri_diff'] == 0 and a['max_dt'] == 0.0, a
        assert a['max_duv'] == 0.0, a


def test_clusters_kernel_on_the_zoo_box2_queries(cuda, tmp_path):
    """K5 on the pass's own queries of the zoo box II (128 x 96): the camera
    rays' and the first-bounce rays' nearest hit and bounce 0's shadow
    any-hit, every lane against the plain version."""
    import zoo_scenes
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_zoo_box2(str(tmp_path), 128, 96, 6)
    sc, mt = B.load_scene(path, device=cuda)
    n = mt.width * mt.height
    pix = torch.arange(n, device=cuda)
    zeros = torch.zeros(n, device=cuda)

    def nearest_q(state):
        live = ~IPT._is_dead(state.flags)
        return (state.ray_pos, state.ray_dir, zeros,
                torch.where(live, IPT.LM.FLT_MAX, 0.0))

    st = IPT.kernel_init_eye_ray(sc, mt, RNG.gen_init(pix), pix)
    cam = nearest_q(st)
    st = IPT.kernel_ray_trace(sc, mt, st, 0)
    _, _, _, sr = IPT.sample_shadow_rays(sc, mt, st)
    shadow = (sr.pos, sr.dir, zeros, sr.t_max)
    sh, r2 = IPT.kernel_sample_light_source(sc, mt, st, None)
    st = IPT.kernel_next_bounce(sc, mt, st._replace(rng=r2), 0, sh, None)
    for q, any_hit in ((cam, False), (shadow, True), (nearest_q(st), False)):
        k = TTP.intersect_clusters(None, None, sc.cl_tris12, *q, any_hit,
                                   wide=sc.cl_wide)
        p = TTP.intersect_clusters_plain(sc.cl_tris12, *q, any_hit)
        _assert_clusters_equal(sc, k, p, q, any_hit)


def test_zoo_box2_pass_on_card_matches_cpu(cuda, tmp_path):
    """One MIS pass of the zoo box II (plastic, thin film, blend) through
    K5 on the card against the same pass on the CPU (plain versions)."""
    import zoo_scenes
    from hydracore3_torch import render as R
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_zoo_box2(str(tmp_path), 32, 24, 3)
    out = []
    for dev in ('cpu', cuda):
        scene, meta = B.load_scene(path, device=dev)
        assert not R.use_megakernel(scene, meta)
        pix = torch.arange(meta.width * meta.height, device=dev)
        before = TTP.intersect_clusters.launches
        acc, fl, rng_ = IPT.trace_pass(scene, meta, RNG.gen_init(pix), pix)
        if dev is cuda:
            assert TTP.intersect_clusters.launches == before + 2 * 3
        out.append((acc.cpu().numpy(), rng_.cpu().numpy()))
    (a_cpu, r_cpu), (a_gpu, r_gpu) = out
    assert np.isfinite(a_gpu).all()
    close = np.isclose(a_gpu, a_cpu, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.99
    assert (r_gpu == r_cpu).all(axis=1).mean() >= 0.99


def _pass_queries(sc, mt, cuda):
    """The pass's camera, bounce-0 shadow and first-bounce queries (each
    (pos, dir, t_min, t_max), any_hit) as ``trace_pass`` sends them."""
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    n = mt.width * mt.height
    pix = torch.arange(n, device=cuda)
    zeros = torch.zeros(n, device=cuda)

    def nearest_q(state):
        live = ~IPT._is_dead(state.flags)
        return (state.ray_pos, state.ray_dir, zeros,
                torch.where(live, IPT.LM.FLT_MAX, 0.0))

    st = IPT.kernel_init_eye_ray(sc, mt, RNG.gen_init(pix), pix)
    cam = nearest_q(st)
    st = IPT.kernel_ray_trace(sc, mt, st, 0)
    _, _, _, sr = IPT.sample_shadow_rays(sc, mt, st)
    shadow = (sr.pos, sr.dir, zeros, sr.t_max)
    sh, r2 = IPT.kernel_sample_light_source(sc, mt, st, None)
    st = IPT.kernel_next_bounce(sc, mt, st._replace(rng=r2), 0, sh, None)
    return ((cam, False), (shadow, True), (nearest_q(st), False))


@pytest.mark.parametrize('camera', ['pinhole', 'dof', 'optics'])
def test_clusters_kernel_on_the_feature_box_queries(cuda, tmp_path, camera):
    """K5 on the feature box's pass queries (128 x 96) for each camera,
    every lane against the plain version."""
    import zoo_scenes
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_feature_box(str(tmp_path), 128, 96, 6,
                                        camera=camera)
    sc, mt = B.load_scene(path, device=cuda)
    for q, any_hit in _pass_queries(sc, mt, cuda):
        k = TTP.intersect_clusters(None, None, sc.cl_tris12, *q, any_hit,
                                   wide=sc.cl_wide)
        p = TTP.intersect_clusters_plain(sc.cl_tris12, *q, any_hit)
        _assert_clusters_equal(sc, k, p, q, any_hit)


def test_kernels_miss_the_lens_stacks_failed_rays(cuda, tmp_path):
    """The lens stack's failed camera rays start at (0, -1e7, 0) in camera
    space and look down: K5 over the small class's rows, and K3 and K2 over
    the box streamed, report a miss on each of them and equal the plain
    version on every lane of the camera query; the march leaves no lane
    unresolved."""
    import zoo_scenes
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_feature_box(str(tmp_path), 128, 96, 6,
                                        camera='optics')
    sc, mt = B.load_scene(path, device=cuda)
    q = _pass_queries(sc, mt, cuda)[0][0]
    failed = q[0][:, 1] < -1e6
    assert 0 < int(failed.sum()) < failed.numel()
    k = TTP.intersect_clusters(None, None, sc.cl_tris12, *q, wide=sc.cl_wide)
    p = TTP.intersect_clusters_plain(sc.cl_tris12, *q)
    _assert_clusters_equal(sc, k, p, q, False)
    assert (k[1][failed] < 0).all()
    st, _ = B.load_scene(path, device=cuda, accel='stream')
    plain = TTS.intersect_plain(st.st_woop, *q[:3], torch.clamp(
        q[3], max=0.99 * TTS.FLT_MAX))
    *km, un = TTD.intersect_march(st.st_grid, st.st_woop, *q,
                                  with_unresolved=True, wide=st.st_wide)
    ks = TTS.intersect_stream(st.st_nodes_f, st.st_nodes_i, st.st_woop, *q,
                              wide=st.st_wide)
    assert int(un.sum()) == 0
    for out in (km, ks):
        a = TTS.hits_agree(out, plain, False)
        assert a['hit_diff'] == 0 and a['tri_diff'] == 0, a
        assert a['max_duv'] <= UV_TOL, a
        assert (out[1][failed] < 0).all()


def test_feature_box_pass_on_card_matches_cpu(cuda, tmp_path):
    """One MIS pass of the feature box with the lens stack (normal maps,
    IES and spot lights, the camera-back texture) through K5 on the card
    against the same pass on the CPU (plain versions)."""
    import zoo_scenes
    from hydracore3_torch import render as R
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_feature_box(str(tmp_path), 32, 24, 3,
                                        camera='optics')
    out = []
    for dev in ('cpu', cuda):
        scene, meta = B.load_scene(path, device=dev)
        assert not R.use_megakernel(scene, meta)
        pix = torch.arange(meta.width * meta.height, device=dev)
        before = TTP.intersect_clusters.launches
        acc, fl, rng_ = IPT.trace_pass(scene, meta, RNG.gen_init(pix), pix)
        if dev is cuda:
            assert TTP.intersect_clusters.launches == before + 2 * 3
        out.append((acc.cpu().numpy(), rng_.cpu().numpy()))
    (a_cpu, r_cpu), (a_gpu, r_gpu) = out
    assert np.isfinite(a_gpu).all()
    close = np.isclose(a_gpu, a_cpu, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.99
    assert (r_gpu == r_cpu).all(axis=1).mean() >= 0.99


# ---- motion blur: K4's motion variant ------------------------------------------

def _assert_motion_equal(tl, k, p, q, time, any_hit):
    """K4's motion variant against its plain version on every lane: the hit
    flag; nearest, the triangle, the instance, t, u and v; any-hit, a
    reported pair that occludes its lane."""
    from hydracore3_torch.accel import two_level as TL
    assert torch.equal(k[1] >= 0, p[1] >= 0)
    if any_hit:
        valid = TL.occluder_valid(tl, k[1], k[2], *q, time)
        assert torch.equal(valid, k[1] >= 0)
        return
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize('when', ['t0', 't0.5', 't1', 'pass'])
def test_motion_kernel_on_the_motion_box_queries(cuda, tmp_path, when):
    """K4's motion variant on the motion box's pass queries (128 x 96:
    camera, bounce-0 shadow, first bounce) at the times 0, 0.5, 1 and the
    pass's own (a random time per lane), every lane against the plain
    version; the query counts one launch."""
    import zoo_scenes
    from hydracore3_torch.accel import two_level as TL
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_motion_box(str(tmp_path), 128, 96, 6)
    sc, mt = B.load_scene(path, device=cuda)
    assert mt.use_two_level and mt.has_motion
    queries, time = _motion_pass_queries(sc, mt, cuda)
    if when != 'pass':
        time = torch.full_like(time, float(when[1:]))
    for q, any_hit in queries:
        before = TL.intersect_two_level.launches
        k = TL.intersect_two_level(sc.two_level, *q, time, any_hit)
        assert TL.intersect_two_level.launches == before + 1
        p = TL.intersect_two_level_plain(sc.two_level, *q, time, any_hit)
        _assert_motion_equal(sc.two_level, k, p, q, time, any_hit)


def _motion_pass_queries(sc, mt, cuda):
    """``_pass_queries`` of a moving scene and the lanes' shutter times."""
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    n = mt.width * mt.height
    pix = torch.arange(n, device=cuda)
    time = IPT.kernel_init_eye_ray(sc, mt, RNG.gen_init(pix), pix).time
    return _pass_queries(sc, mt, cuda), time


def test_motion_wrapper_refuses_a_table_without_its_wide_table(cuda,
                                                               tmp_path):
    import zoo_scenes
    from hydracore3_torch.accel import two_level as TL
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_motion_box(str(tmp_path), 16, 12, 2)
    sc, _ = B.load_scene(path, device=cuda)
    bare = dataclasses.replace(sc.two_level, wide=None)
    q = (torch.zeros(4, 3, device=cuda), torch.ones(4, 3, device=cuda),
         torch.zeros(4, device=cuda), torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match='wide'):
        TL.intersect_two_level(bare, *q)


def test_motion_box_pass_on_card_matches_cpu(cuda, tmp_path):
    """One MIS pass of the motion box through K4's motion variant on the
    card against the same pass on the CPU (plain versions), at the bars of
    the other passes' (accumulator within 1e-3 and RNG equal on >= 99% of
    the lanes: the card's and the CPU's transcendental functions round
    apart); no plain version of the walk runs on the card."""
    import zoo_scenes
    from hydracore3_torch import render as R
    from hydracore3_torch.accel import two_level as TL
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_motion_box(str(tmp_path), 32, 24, 3)
    out = []
    plain = TL.intersect_two_level_plain
    for dev in ('cpu', cuda):
        scene, meta = B.load_scene(path, device=dev)
        assert not R.use_megakernel(scene, meta)
        pix = torch.arange(meta.width * meta.height, device=dev)
        before = TL.intersect_two_level.launches
        if dev is cuda:
            TL.intersect_two_level_plain = None
        try:
            acc, fl, rng_ = IPT.trace_pass(scene, meta, RNG.gen_init(pix),
                                           pix)
        finally:
            TL.intersect_two_level_plain = plain
        if dev is cuda:
            assert TL.intersect_two_level.launches == before + 2 * 3
        out.append((acc.cpu().numpy(), rng_.cpu().numpy()))
    (a_cpu, r_cpu), (a_gpu, r_gpu) = out
    assert np.isfinite(a_gpu).all()
    close = np.isclose(a_gpu, a_cpu, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.99
    assert (r_gpu == r_cpu).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize('which', ['box', 'motion'])
def test_whitted_and_gbuffer_on_card_match_cpu(cuda, tmp_path, which):
    """``cast_single_ray``, ``ray_trace`` and ``eval_gbuffer`` of the
    textured box and the motion box (its soup at the shutter's open)
    through K5 on the card against the CPU's plain versions: colours within
    1e-5 on >= 99.9% of the pixels, the G-buffer's ids equal and its fields
    within 1e-5 on >= 99% (a pick may differ where two samples' summed
    dissimilarities tie to the rounding of the card's square roots)."""
    import zoo_scenes
    from hydracore3_torch.models import gbuffer as GB
    from hydracore3_torch.models import integrator_rt as RT
    from hydracore3_torch.scene import build as B
    write = dict(box=zoo_scenes.write_rt_box,
                 motion=zoo_scenes.write_motion_box)[which]
    path = write(str(tmp_path), 64, 48, 4)
    res = []
    for dev in ('cpu', cuda):
        sc, mt = B.load_scene(path, device=dev)
        pix = torch.arange(mt.width * mt.height, device=dev)
        before = TTP.intersect_clusters.launches
        res.append((RT.cast_single_ray(sc, mt, pix).cpu(),
                    RT.ray_trace(sc, mt, pix).cpu(),
                    [f.cpu() for f in GB.eval_gbuffer(sc, mt, pix)]))
        if dev is cuda:
            assert TTP.intersect_clusters.launches > before
    (c0, w0, g0), (c1, w1, g1) = res
    for a, b in ((c1, c0), (w1, w0)):
        close = torch.isclose(a, b, atol=1e-5, rtol=0).all(-1)
        assert close.float().mean() >= 0.999
    same = torch.ones(len(g0[0]), dtype=torch.bool)
    for a, b in zip(g1, g0):
        ok = (torch.isclose(a, b, atol=1e-5, rtol=1e-5)
              if a.dtype.is_floating_point else a == b)
        same &= ok.reshape(len(same), -1).all(-1)
    assert same.float().mean() >= 0.99


def test_qmc_pass_on_card_matches_cpu(cuda, tmp_path):
    """One QMC sample of every pixel of the textured box (the batched
    route: K5 over its rows) on the card against the CPU's: the same
    output pixel on every lane, the contributions within 1e-3 and the RNG
    rows equal on >= 99% of the lanes (the bars of the other passes), and
    ``render_qmc``'s 2-spp image within 1e-3 on >= 99% of the pixels (its
    scatter-adds run in another order on the card)."""
    import zoo_scenes
    from hydracore3_torch import render as R
    from hydracore3_torch.ops import qmc as QMC
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_rt_box(str(tmp_path), 32, 24, 3)
    out = []
    for dev in ('cpu', cuda):
        sc, mt = B.load_scene(path, device=dev)
        n = mt.width * mt.height
        spd, mat, lgt = R._qmc_dims(mt)
        ctx = dict(table=QMC.qmc_table(dev), spd_dim=spd, mat_dim=mat,
                   lgt_dim=lgt, idx=torch.arange(n, device=dev) + 4096)
        before = TTP.intersect_clusters.launches
        c, rng_, px = R._one_sample(sc, mt, RNG.gen_init(
            torch.arange(n, device=dev)), torch.zeros(n, dtype=torch.int64,
                                                      device=dev), 2, 4, 0,
            ctx)
        img = R.render_qmc(sc, mt, spp=2)
        if dev is cuda:
            assert TTP.intersect_clusters.launches > before
        out.append((c.cpu().numpy(), rng_.cpu().numpy(), px.cpu().numpy(),
                    img))
    (c0, r0, p0, i0), (c1, r1, p1, i1) = out
    np.testing.assert_array_equal(p1, p0)
    assert np.isfinite(c1).all() and np.isfinite(i1).all()
    assert np.isclose(c1, c0, rtol=1e-3, atol=1e-3).all(1).mean() >= 0.99
    assert (r1 == r0).all(1).mean() >= 0.99
    assert (np.abs(i1 - i0).max(-1) <= 1e-3).mean() >= 0.99


def test_mlt_step_on_card_matches_cpu(cuda, tmp_path):
    """The Kelemen chains' start and one step (1,024 chains on the
    textured box, K5) on the card against the CPU's: the vectors, pixels
    and accept counts on >= 99% of the chains (a chain parts where an
    accept turns on a last-ulp difference)."""
    import zoo_scenes
    from hydracore3_torch.models import kmlt as KM
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_rt_box(str(tmp_path), 32, 24, 3)
    out = []
    for dev in ('cpu', cuda):
        sc, mt = B.load_scene(path, device=dev)
        before = TTP.intersect_clusters.launches
        chain = KM.init_chains(sc, mt, 1024, 0)
        stats = dict(nonfinite=0)
        chain = KM.mlt_steps(sc, mt, chain, 0, 1, stats)
        assert int(stats['nonfinite']) == 0
        if dev is cuda:
            assert TTP.intersect_clusters.launches > before
        out.append([x.cpu().numpy() for x in chain])
    a, b = out
    for k in (0, 3, 10):        # x_vec, y_px, n_accept
        eq = np.isclose(b[k], a[k], rtol=1e-4, atol=1e-5) if k == 0 \
            else b[k] == a[k]
        assert eq.reshape(len(eq), -1).all(-1).mean() >= 0.99, k
    assert 0 < int(b[10].sum()) < 1024


@pytest.mark.parametrize('tile', [256, 500])
def test_render_resume_on_card_bit_exact(cuda, tmp_path, tile):
    """A checkpointed render on the card, interrupted after 2 of 4
    samples and resumed from its file, equals the uninterrupted one bit
    for bit (the tiles divide the frame, or the last is padded)."""
    import zoo_scenes
    from hydracore3_torch import render as R
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_rt_box(str(tmp_path), 32, 24, 3)
    sc, mt = B.load_scene(path, device=cuda)
    kw = dict(spp=4, tile_size=tile, checkpoint_every=1)
    full = R.render(sc, mt, checkpoint_path=str(tmp_path / 'u.npz'), **kw)
    ck = str(tmp_path / 'c.npz')
    R.render(sc, mt, checkpoint_path=ck, **dict(kw, spp=2))
    before = TTP.intersect_clusters.launches
    resumed = R.render(sc, mt, checkpoint_path=ck, resume=True, **kw)
    assert TTP.intersect_clusters.launches > before
    assert np.isfinite(full).all()
    np.testing.assert_array_equal(resumed, full)


def test_hit_backward_on_card_matches_cpu(cuda, tmp_path):
    """The hit's ``Function`` (accel/hit_grad.py) on K5's camera and
    first-bounce queries of the DR box: on the card (K5 forward) its
    (t, tri, u, v) and its gradient with respect to the rays equal the
    CPU's (the plain version forward) within 1e-4 on >= 99.9% of the
    lanes, and the card's gradient is finite on every lane."""
    import zoo_scenes
    from hydracore3_torch.accel import hit_grad as HG
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_dr_box(str(tmp_path), 64, 48, 6)
    out = []
    for dev in ('cpu', cuda):
        sc, mt = B.load_scene(path, device=dev)
        n = mt.width * mt.height
        pix = torch.arange(n, device=dev)
        st = IPT.kernel_init_eye_ray(sc, mt, RNG.gen_init(pix), pix)
        qs = [(st.ray_pos, st.ray_dir)]
        st = IPT.kernel_ray_trace(sc, mt, st, 0)
        st = IPT.kernel_next_bounce(sc, mt, st, 0, torch.zeros_like(
            st.accum_color), IPT.MAT.make_shading_ctx(
                sc, mt, IPT._extract_mat_id(st.flags), st.hit_norm,
                st.hit_tang, st.hit_uv))
        qs.append((st.ray_pos, st.ray_dir))
        res = []
        for k, (pos, d) in enumerate(qs):
            t_min = torch.zeros(n, device=dev)
            t_max = torch.full((n,), IPT_FLT_MAX, device=dev)
            cot = torch.from_numpy(np.random.default_rng(k).normal(
                size=(3, n)).astype(np.float32)).to(dev)
            p, q = pos.clone().requires_grad_(), d.clone().requires_grad_()
            before = TTP.intersect_clusters.launches
            t, tri, u, v = IPT.soup_nearest_hit(sc, p, q, t_min, t_max,
                                                False)
            if dev is cuda:
                assert TTP.intersect_clusters.launches == before + 1
            loss = sum((torch.where(tri >= 0, x, 0.0) * c).sum()
                       for x, c in zip((t, u, v), cot))
            gp, gq = torch.autograd.grad(loss, (p, q))
            res.append([x.detach().cpu() for x in (t, tri, u, v, gp, gq)])
        out.append(res)
    for a, b in zip(*out):
        assert torch.equal(a[1], b[1])
        for x, y in zip(a[4:], b[4:]):
            assert bool(torch.isfinite(y).all())
            close = torch.isclose(x, y, rtol=1e-4, atol=1e-4).all(-1)
            assert float(close.float().mean()) >= 0.999


def test_dr_loss_and_grad_on_card_matches_cpu(cuda, tmp_path):
    """``models/dr.loss_and_grad`` of the DR box at 32 x 24, depth 6, on the
    card against the CPU from the same texels and streams: loss within
    1e-4 relative, the texel gradient's relative L2 error within 1e-2
    (the DR golden's bars; the card sums the texel gradient by atomic
    adds), K5 launched on the card."""
    import zoo_scenes
    from hydracore3_torch.models import dr as DR
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_dr_box(str(tmp_path), 32, 24, 6)
    out = []
    for dev in ('cpu', cuda):
        sc, mt = B.load_scene(path, device=dev)
        setup = DR.put_diff_tex(sc, zoo_scenes.dr_tex_slot(sc))
        n = mt.width * mt.height
        pix = torch.arange(n, device=dev)
        params = torch.from_numpy(zoo_scenes.dr_gold_params(setup.size)).to(
            dev)
        ref = torch.from_numpy(zoo_scenes.ior_gold_ref(n)).to(dev)
        before = TTP.intersect_clusters.launches
        loss, g, _, _ = DR.loss_and_grad(params, sc, mt, setup,
                                         RNG.gen_init(pix), pix, ref)
        if dev is cuda:
            assert TTP.intersect_clusters.launches > before
        out.append((float(loss), g.cpu().double()))
    (lc, gc), (lg, gg) = out
    assert abs(lg / lc - 1.0) <= 1e-4
    assert float(gc.abs().sum()) > 0
    assert float((gg - gc).norm() / gc.norm()) <= 1e-2


# ---- the two-level hit's gradient and data parallelism ---------------------

def _motion_instanced(seed=13):
    """Three random meshes under ten instances, five of them moving (the
    random scene of scripts/rehearse_motion_cpu.py), two coincident."""
    from hydracore3_torch.accel import two_level as TL2
    rng = np.random.default_rng(seed)

    def mesh(n, scale):
        return tuple(rng.uniform(-w, w, (n, 3)).astype(np.float32) * scale
                     for w in (1.0, 0.3, 0.3))

    def rot(a, t):
        m = np.eye(4, dtype=np.float32)
        c, s = np.cos(a), np.sin(a)
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
        m[:3, 3] = t
        return m

    meshes = [mesh(40, 1.0), mesh(17, 0.5), mesh(64, 0.8)]
    insts = [dict(geom_id=k % 3, m0=rot(rng.uniform(0, 3),
                                        rng.uniform(-2.5, 2.5, 3)),
                  m1=(rot(rng.uniform(0, 3), rng.uniform(-2.5, 2.5, 3))
                      if k % 2 == 0 else None)) for k in range(9)]
    insts.append(dict(geom_id=1, m0=insts[1]['m0'], m1=None))
    return TL2.build_two_level(meshes, insts), rng


@pytest.mark.parametrize('which', ['K4', 'K4m'])
def test_two_level_backward_on_random_instanced_meshes(cuda, which):
    """The two-level hit's ``Function`` (accel/hit_grad.py) on random rays
    through random instanced meshes: on the card (K4 or K4m forward, at
    random times for K4m) its hits equal the CPU's plain walk's and its
    gradient with respect to the rays is finite and within 1e-4 of the
    CPU's on >= 99.9% of the lanes, and of the plain walk's autograd
    gradient (K4m's dense walk; for K4 the walk's Woop test at its hit)."""
    from hydracore3_torch.accel import hit_grad as HG
    from hydracore3_torch.accel import two_level as TL2
    if which == 'K4':
        pk, _ = _instanced(cuda)
        rng = np.random.default_rng(21)
        tables = TTT.tlas_pack(pk)
        pos, d = random_rays(rng, 8192, box=10.0)
        time = None
    else:
        tables, rng = _motion_instanced()
        pos, _ = random_rays(rng, 8192, box=4.0)
        # aimed at the instances' region
        d = rng.uniform(-2.0, 2.0, pos.shape).astype(np.float32) - pos
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        time = torch.tensor(rng.uniform(0, 1, 8192), dtype=torch.float32)
    n = pos.shape[0]
    cot = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    out = {}
    for dev in ('cpu', cuda):
        tab = tables.to(dev)
        p = torch.from_numpy(pos).to(dev).requires_grad_()
        q = torch.from_numpy(d).to(dev).requires_grad_()
        t_min = torch.zeros(n, device=dev)
        t_max = torch.full((n,), IPT_FLT_MAX, device=dev)
        if which == 'K4':
            before = TTT.intersect_stream_tlas.launches
            t, tri, u, v, inst = HG.tlas_with_grad(tab, p, q, t_min, t_max)
            launched = TTT.intersect_stream_tlas.launches - before
        else:
            tm_ = time.to(dev)
            before = TL2.intersect_two_level.launches
            t, tri, inst, u, v = HG.two_level_with_grad(tab, p, q, t_min,
                                                        t_max, tm_)
            launched = TL2.intersect_two_level.launches - before
        assert launched == (1 if dev is cuda else 0)
        c = cot.to(dev)
        loss = sum((torch.where(tri >= 0, x, 0.0) * k_).sum()
                   for x, k_ in zip((t, u, v), c))
        gp, gq = torch.autograd.grad(loss, (p, q))
        out[str(dev)] = [x.detach().cpu() for x in (tri, inst, gp, gq)]
        if dev == 'cpu':
            # the plain walk's autograd gradient
            pp = torch.from_numpy(pos).requires_grad_()
            qq = torch.from_numpy(d).requires_grad_()
            if which == 'K4':
                with torch.no_grad():
                    _, ptri, _, _, pinst = TTT.intersect_tlas_plain(
                        tab, pp, qq, t_min, torch.clamp(
                            t_max, max=TTS.T_MAX_CAP))
                op, od = TTT.to_object_space(
                    tab.inst_f[pinst.clamp(min=0)].T, pp, qq)
                pt, pu, pv, _ = TWB._woop(tab.woop[ptri.clamp(min=0)], op,
                                          od)
            else:
                pt, ptri, pinst, pu, pv = TL2.intersect_two_level_plain(
                    tab, pp, qq, t_min, t_max, time)
            loss = sum((torch.where(ptri >= 0, x, 0.0) * k_).sum()
                       for x, k_ in zip((pt, pu, pv), cot))
            out['plain'] = [ptri, pinst, *torch.autograd.grad(loss,
                                                              (pp, qq))]
    hits = out['cpu'][0] >= 0
    assert int(hits.sum()) > n // 10
    for other in (str(cuda), 'plain'):
        b = out[other]
        both = hits & (b[0] >= 0)
        same = both & (out['cpu'][0] == b[0]) & (out['cpu'][1] == b[1])
        assert float(same.float().sum() / hits.float().sum()) >= 0.999
        for x, y in zip(out['cpu'][2:], b[2:]):
            assert bool(torch.isfinite(y[same]).all())
            close = torch.isclose(x[same], y[same], rtol=1e-4,
                                  atol=1e-4).all(-1)
            assert float(close.float().mean()) >= 0.999, other


def test_two_gloo_ranks_on_one_card_render_the_one_process_image(cuda,
                                                                 tmp_path):
    """``parallel/mesh.render_sharded`` of the textured box (64 x 48, and
    63 x 47, whose pixels pad to a multiple of two) by two gloo processes
    that share the card (NCCL cannot put two ranks on one card), each
    stripe through K5: the image equals the one-process render on the
    card bit for bit."""
    import torch_dist_worker as W
    from hydracore3_torch import api
    from hydracore3_torch.parallel import mesh as M
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth
    sizes = ((64, 48), (63, 47))
    lib = api.write_library(synth.build_box(64, 48, 4, textured=True),
                            str(tmp_path / 'box'))
    ranks = W.run_ranks(dict(mode='render', library=lib, device='cuda:0',
                             backend='gloo', sizes=sizes, spp=2), 2,
                        str(tmp_path))
    mesh = M.make_mesh(device=cuda)
    for w, h in sizes:
        sc, mt = B.load_scene(lib, width=w, height=h, device=cuda)
        before = TTP.intersect_clusters.launches
        img = M.render_sharded(mesh, sc, mt, spp=2)
        assert TTP.intersect_clusters.launches > before
        assert np.isfinite(img).all() and img[..., :3].max() > 0
        for r in ranks:
            np.testing.assert_array_equal(r[f'img_{w}x{h}'], img)


# ---- K5m: the cluster kernel over a moving soup ----------------------------

def _moving_soup(rng, n):
    """A random moving soup: (tris12 [n, 12], (dv0, de1, de2)), every fifth
    triangle still, the last a copy of the first (equal t at every time)."""
    v0, e1, e2 = random_scene(rng, n, 3.0)
    d = [rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
         rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
         rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)]
    for a in d:
        a[::5] = 0.0
    for a in (v0, e1, e2, *d):
        a[-1] = a[0]
    tris12 = np.zeros((n, 12), np.float32)
    tris12[:, 0:3], tris12[:, 3:6], tris12[:, 6:9] = v0, e1, e2
    return tris12, d


def _assert_soup_motion_equal(tris12, motion, k, p, q, any_hit):
    """K5m against its plain version on every lane: the hit flag; nearest,
    the triangle, t, u and v; any-hit, a reported triangle that occludes
    its lane at the lane's time."""
    assert torch.equal(k[1] >= 0, p[1] >= 0)
    if any_hit:
        assert torch.equal(TTP.occluder_valid(tris12, k[1], *q, motion),
                           k[1] >= 0)
        return
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize('when', ['0', '0.25', '0.5', '1', 'random'])
@pytest.mark.parametrize('any_hit', [False, True])
def test_soup_motion_kernel_matches_plain(cuda, when, any_hit):
    """K5m on random moving soups at the times 0, 0.25, 0.5, 1 and a random
    time per lane, every lane against ``intersect_clusters_plain`` with
    ``motion=``; one launch per query, counted by its own wrapper."""
    rng = np.random.default_rng(41)
    for n_tris in (600, 5000):
        tris12, d = _moving_soup(rng, n_tris)
        wide = TWB.pack_wide_clusters(tris12, d).to(cuda)
        pos, dirs = random_rays(rng, 8192, 5.0)
        n = len(pos)
        q = (torch.from_numpy(pos).to(cuda), torch.from_numpy(dirs).to(cuda),
             torch.zeros(n, device=cuda),
             torch.from_numpy(rng.choice([IPT_FLT_MAX, 3.0], n)
                              .astype(np.float32)).to(cuda))
        time = (torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
                if when == 'random' else torch.full((n,), float(when)))
        time = time.to(cuda)
        t12 = torch.from_numpy(tris12).to(cuda)
        motion = tuple(torch.from_numpy(a).to(cuda) for a in d) + (time,)
        before = (TTP.intersect_clusters_motion.launches,
                  TTP.intersect_clusters.launches)
        k = TTP.intersect_clusters(None, None, t12, *q, any_hit=any_hit,
                                   wide=wide, motion=motion)
        assert (TTP.intersect_clusters_motion.launches,
                TTP.intersect_clusters.launches) == (before[0] + 1,
                                                     before[1])
        p = TTP.intersect_clusters_plain(t12, *q, any_hit, motion)
        _assert_soup_motion_equal(t12, motion, k, p, q, any_hit)
        assert int((k[1] >= 0).sum()) > n // 50


def test_soup_motion_kernel_on_the_motion_box_queries(cuda, tmp_path):
    """K5m on the pass's camera, shadow and first-bounce queries of the
    motion box built under ``accel='bvh'`` (128 x 96), each at its lanes'
    times, every lane against the plain version."""
    import zoo_scenes
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_motion_box(str(tmp_path), 128, 96, 6)
    sc, mt = B.load_scene(path, device=cuda, accel='bvh')
    assert mt.has_motion and not mt.use_two_level
    assert sc.cl_wide.drows is not None
    queries, time = _motion_pass_queries(sc, mt, cuda)
    motion = IPT.soup_motion(sc, time)
    for q, any_hit in queries:
        k = TTP.intersect_clusters(None, None, sc.cl_tris12, *q,
                                   any_hit=any_hit, wide=sc.cl_wide,
                                   motion=motion)
        p = TTP.intersect_clusters_plain(sc.cl_tris12, *q, any_hit, motion)
        _assert_soup_motion_equal(sc.cl_tris12, motion, k, p, q, any_hit)


def test_soup_motion_wrapper_refuses_a_static_table(cuda):
    rng = np.random.default_rng(5)
    tris12, d = _moving_soup(rng, 40)
    static = TWB.pack_wide_clusters(tris12).to(cuda)
    q = (torch.zeros(4, 3, device=cuda), torch.ones(4, 3, device=cuda),
         torch.zeros(4, device=cuda), torch.ones(4, device=cuda))
    motion = tuple(torch.from_numpy(a).to(cuda) for a in d) + (
        torch.zeros(4, device=cuda),)
    with pytest.raises(ValueError, match='moving table'):
        TTP.intersect_clusters(None, None, None, *q, wide=static,
                               motion=motion)
    with pytest.raises(ValueError, match='wide'):
        TTP.intersect_clusters(None, None, None, *q, motion=motion)


def test_soup_motion_pass_on_card_matches_cpu(cuda, tmp_path):
    """One MIS pass of the motion box under ``accel='bvh'`` through K5m on
    the card against the same pass on the CPU (plain versions), at the
    other passes' bars; no plain version of the query runs on the card."""
    import zoo_scenes
    from hydracore3_torch import render as R
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    path = zoo_scenes.write_motion_box(str(tmp_path), 32, 24, 3)
    out = []
    plain = TTP.intersect_clusters_plain
    for dev in ('cpu', cuda):
        scene, meta = B.load_scene(path, device=dev, accel='bvh')
        assert not R.use_megakernel(scene, meta)
        pix = torch.arange(meta.width * meta.height, device=dev)
        before = TTP.intersect_clusters_motion.launches
        if dev is cuda:
            TTP.intersect_clusters_plain = None
        try:
            acc, fl, rng_ = IPT.trace_pass(scene, meta, RNG.gen_init(pix),
                                           pix)
        finally:
            TTP.intersect_clusters_plain = plain
        if dev is cuda:
            assert TTP.intersect_clusters_motion.launches == before + 2 * 3
        out.append((acc.cpu().numpy(), rng_.cpu().numpy()))
    (a_cpu, r_cpu), (a_gpu, r_gpu) = out
    assert np.isfinite(a_gpu).all()
    close = np.isclose(a_gpu, a_cpu, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.99
    assert (r_gpu == r_cpu).all(axis=1).mean() >= 0.99
