"""The CUDA kernels against their plain torch version, on the card.

Run on a machine with a CUDA card: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py -q`` (this file imports nothing of JAX, and
``--noconftest`` skips tests/conftest.py, which does).  Without a card every
test skips (the check happens inside the ``cuda`` fixture, never at
import).  Agreement bars: the ray-query kernels' (K2-K6) hit masks equal on
>= 99.9% of rays, t within rtol 2e-4 where both hit (nvcc contracts the
Moller-Trumbore arithmetic into FMAs, so knife-edge lanes may differ), the
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
K1's entry points on every lane, on the box and the tessellated box: RNG,
flags and counts equal and the f32 rows within ``megakernel.KERNEL_TOL``
(built without FMA contraction; rsqrtf, sinf and cosf are the card's, as
in torch's own CUDA ops).
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
