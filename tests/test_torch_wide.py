"""The wide BVHs that the card's cluster and two-level kernels walk.

``hydracore3_torch/accel/wide_bvh.py`` has no JAX counterpart: it derives
4-wide nodes over leaves of at most 4 triangles from the contract tables.
Held here, on inputs made from numpy seeds:

* structure: every triangle once in the fine order, the map back to the
  contract index, leaves of at most 4, every leaf's triangles inside its box
  and every child box inside its parent's, on the small mid-size city, the
  small instanced city and random soups;
* ``walk_wide_plain`` (the kernels' walk in plain torch) against the dense
  plain versions ``intersect_clusters_plain`` / ``intersect_tlas_plain``:
  t, triangle, u, v (and instance) EQUAL on every lane (the same arithmetic
  per triangle, ties settled by the same rule) on camera-like, shadow-like
  and random rays; and against the JAX kernels in Pallas interpret mode at
  the bars of tests/test_torch_clusters.py (triangle ids equal, t within
  rtol 1e-5, u and v within rtol 1e-4 / atol 1e-5) and
  tests/test_torch_tlas.py (hit flags and instance ids equal, t within rtol
  2e-4 / atol 1e-4, u and v within rtol 5e-3 / atol 5e-4);
* ties: coplanar triangles at equal t in different fine leaves, and stacked
  instances: the lower contract index / the instance met first by the
  contract TLAS's DFS wins, for each ray and its mirror;
* any-hit: occlusion flags equal the plain version's on every lane, and the
  one-level walk's reported triangle occludes its lane by the plain
  Moller-Trumbore test;
* the stack guard raises on a deep degenerate tree;
* ``traverse_stream.ray_arrays``, through which the wrappers hand the rays
  to the kernels by raw address, refuses a ray tensor of another shape or on
  another device.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu.accel import traverse_pallas as JTP
from hydracore3_tpu.accel import traverse_tlas as JTT
from hydracore3_torch.accel import build_bvh as TB
from hydracore3_torch.accel import traverse_pallas as TTP
from hydracore3_torch.accel import traverse_stream as TTS
from hydracore3_torch.accel import traverse_tlas as TTT
from hydracore3_torch.accel import wide_bvh as WB
from hydracore3_torch.models import integrator_pt as TIPT
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.scene import synth as tsynth
from test_tlas_stream import _build, _rays
from test_torch_clusters import MID_CITY_KW, packs
from test_torch_tlas import ICITY_KW

T_MAX = 0.99 * TTS.FLT_MAX


def tt(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---- structure -------------------------------------------------------------

def check_tree(nodes, root, corners_of_leaf, seen):
    """Walk a packed tree from ``root``: every child box inside its
    parent's, every leaf's corners inside its box; leaf codes go to
    ``seen``.  Returns the most entries a near-first walk can have
    waiting: over the paths from the root, the sum of each node's children
    less the one entered."""
    refs = WB.node_refs(nodes)
    bmin, bmax = WB.node_boxes(nodes)
    stack, todo = 0, [(root, None, None, 0)]
    while todo:
        w, pmin, pmax, waiting = todo.pop()
        waiting += int((refs[w] != WB.EMPTY).sum()) - 1
        stack = max(stack, waiting)
        for c in range(WB.WIDTH):
            r = int(refs[w, c])
            if r == WB.EMPTY:
                continue
            if pmin is not None:
                assert (bmin[w, c] >= pmin).all()
                assert (bmax[w, c] <= pmax).all()
            if r >= 0:
                todo.append((r, bmin[w, c], bmax[w, c], waiting))
                continue
            code = ~r
            off, cnt = code >> 3, code & 7
            assert 1 <= cnt <= WB.LEAF_MAX
            seen.append((off, cnt))
            pts = corners_of_leaf(off, cnt)
            assert (pts >= bmin[w, c]).all() and (pts <= bmax[w, c]).all()
    return stack


def corners(v0, e1, e2):
    return np.concatenate([v0, v0 + e1, v0 + e2])


@pytest.fixture(scope='module')
def mid_city():
    return tsynth.city_scene(**MID_CITY_KW, device='cpu')


@pytest.fixture(scope='module')
def icity():
    return tsynth.instanced_city_scene(**ICITY_KW, device='cpu')


@pytest.mark.parametrize('source', ['mid_city', 'soup37', 'soup5000', 'one'])
def test_one_level_structure(source, mid_city):
    if source == 'mid_city':
        tris12 = mid_city[0].cl_tris12.numpy()
    else:
        n = dict(soup37=37, soup5000=5000, one=1)[source]
        tris12 = packs(7 + n, n)[2][2]
    w = WB.pack_wide_clusters(tris12)
    T = len(tris12)
    assert w.nodes.shape[1] == WB.NODE_WORDS and w.nodes.dtype == np.float32
    assert w.index.dtype == np.int32 and w.rows.shape == (T, 12)
    # every triangle once, the map sends a fine position to its contract row
    np.testing.assert_array_equal(np.sort(w.index), np.arange(T))
    np.testing.assert_array_equal(w.rows, tris12[w.index])

    def leaf_corners(off, cnt):
        r = w.rows[off:off + cnt]
        return corners(r[:, 0:3], r[:, 3:6], r[:, 6:9])

    seen = []
    assert w.stack == check_tree(w.nodes, 0, leaf_corners, seen)
    # the leaves tile the fine order
    seen.sort()
    assert seen[0][0] == 0 and sum(c for _, c in seen) == T
    assert all(a[0] + a[1] == b[0] for a, b in zip(seen, seen[1:]))


@pytest.mark.parametrize('source', ['icity', 'seed0', 'seed3'])
def test_two_level_structure(source, icity):
    if source == 'icity':
        sd = tsynth.build_instanced_city(
            **{k: v for k, v in ICITY_KW.items() if k != 'depth'})
        meshes = []
        for m in sd.meshes:
            p3 = np.asarray(m.pos, np.float32)
            idx = np.asarray(m.indices).reshape(-1, 3)
            meshes.append((p3[idx[:, 0]], p3[idx[:, 1]] - p3[idx[:, 0]],
                           p3[idx[:, 2]] - p3[idx[:, 0]]))
        # the build adds each area light's quad as one more mesh
        hw, hl = sd.lights[0].half_width, sd.lights[0].half_length
        lq = np.array([[-hw, 0, -hl], [hw, 0, -hl], [hw, 0, hl],
                       [-hw, 0, hl]], np.float32)
        meshes.append((lq[[0, 0]], lq[[1, 2]] - lq[0], lq[[2, 3]] - lq[0]))
        pack = icity[0].tt
        pk = {k: getattr(pack, k).numpy() for k in TTT._TABLES}
        w = dataclasses.replace(pack.wide, **{
            k: v.numpy() for k, v in pack.wide.tensors().items()})
        order_padded = icity[0].tt_prim.numpy()
        tri_mesh = icity[0].tt_geom.numpy()
    else:
        meshes, instances, _, _ = _build(seed=int(source[-1]))
        pk = TTT.pack_stream_tlas(meshes, instances)
        w, order_padded, tri_mesh = pk['wide'], pk['order_padded'], \
            pk['tri_mesh']
    real = np.abs(pk['woop']).sum(1) > 0
    # every real contract slot once; the rows are the contract's Woop rows
    np.testing.assert_array_equal(np.sort(w.index), np.nonzero(real)[0])
    np.testing.assert_array_equal(w.rows, pk['woop'][w.index])
    n_inst = len(pk['inst_i'])
    # ranks: the contract TLAS's DFS leaf order
    leaves = pk['tlas_i'][:, 1]
    np.testing.assert_array_equal(np.argsort(w.inst_i[:, 1]),
                                  leaves[leaves >= 0])

    def inst_corners(inst, cnt):
        # the instance's world box is what the contract TLAS leaf holds
        node = np.nonzero(leaves == inst)[0][0]
        return pk['tlas_f'][node, :6].reshape(2, 3)

    seen = []
    stack_t = check_tree(w.nodes, 0, inst_corners, seen)
    assert sorted(o for o, _ in seen) == list(range(n_inst))

    def leaf_corners(off, cnt):
        slots = w.index[off:off + cnt]
        g = tri_mesh[slots]
        assert (g == g[0]).all()
        v0, e1, e2 = (a[order_padded[slots]] for a in meshes[g[0]])
        return corners(v0, e1, e2)

    stack_m, seen = 0, []
    for root in np.unique(w.inst_i[:, 0]):
        stack_m = max(stack_m, check_tree(w.nodes, int(root), leaf_corners,
                                          seen))
    assert sum(c for _, c in seen) == int(real.sum())
    assert w.stack == stack_t + stack_m


# ---- the walk against the plain versions and the JAX kernels ---------------

def first_bounce_rays(scene, meta):
    """(camera rays, bounce-0 shadow rays) of the scene's pass, each (pos,
    dir, t_min, t_max)."""
    n = meta.width * meta.height
    pix = torch.arange(n)
    st = TIPT.kernel_init_eye_ray(scene, meta, TRNG.gen_init(pix), pix)
    zeros = torch.zeros(n)
    cam = (st.ray_pos, st.ray_dir, zeros, torch.full((n,), T_MAX))
    st = TIPT.kernel_ray_trace(scene, meta, st, 0)
    _, _, _, sr = TIPT.sample_shadow_rays(scene, meta, st)
    return cam, (sr.pos, sr.dir, zeros, sr.t_max)


def random_query(seed, n, spread, t_max):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, t_max, np.float32)
    tmax[::13] = 0.0                                    # dead lanes
    return tt(pos, d, np.zeros(n, np.float32), tmax)


def assert_same(walk, plain, any_hit, one_level):
    """Equal on every lane; under one-level any-hit the triangle may be
    another occluder of the lane (the flag and t must still be equal)."""
    names = ('t', 'tri', 'u', 'v', 'inst')
    for name, a, b in zip(names, walk, plain):
        if any_hit and one_level and name == 'tri':
            np.testing.assert_array_equal(a.numpy() >= 0, b.numpy() >= 0)
            continue
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'anyhit'])
@pytest.mark.parametrize('rays', ['camera', 'shadow', 'random'])
def test_one_level_walk_equals_plain(mid_city, rays, any_hit):
    scene, meta = mid_city
    if rays == 'random':
        q = random_query(3, 1500, 30.0, 20.0 if any_hit else 3.4e38)
    else:
        q = first_bounce_rays(scene, meta)[rays == 'shadow']
    counts = {}
    walk = WB.walk_wide_plain(scene.cl_wide, *q, any_hit, counts=counts)
    plain = TTP.intersect_clusters_plain(scene.cl_tris12, *q, any_hit)
    assert (plain[1] >= 0).any() and not (plain[1] >= 0).all()
    assert_same(walk, plain, any_hit, True)
    # a walk, not a scan: far fewer tests than rays x triangles
    assert counts['tri_tests'] < 0.02 * q[0].shape[0] * meta.num_tris
    if any_hit:
        valid = TTP.occluder_valid(scene.cl_tris12, walk[1], *q)
        assert torch.equal(valid, walk[1] >= 0)


@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'anyhit'])
@pytest.mark.parametrize('rays', ['camera', 'shadow', 'random'])
def test_two_level_walk_equals_plain(icity, rays, any_hit):
    scene, meta = icity
    if rays == 'random':
        q = random_query(4, 1500, 20.0, 15.0 if any_hit else T_MAX)
    else:
        q = first_bounce_rays(scene, meta)[rays == 'shadow']
    counts = {}
    walk = WB.walk_wide_plain(scene.tt.wide, *q, any_hit, counts=counts)
    plain = TTT.intersect_tlas_plain(scene.tt, *q, any_hit)
    assert (plain[1] >= 0).any() and not (plain[1] >= 0).all()
    assert_same(walk, plain, any_hit, False)
    assert counts['instances'] > 0
    if any_hit:
        assert (walk[4] == -1).all() and (walk[1][walk[1] >= 0] == 0).all()


@pytest.mark.parametrize('n_tris,n_rays', [(37, 256), (300, 1500)])
def test_one_level_walk_vs_jax_kernel_nearest(n_tris, n_rays):
    rng, jpk, tpk = packs(42 + n_tris, n_tris)
    pos = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.zeros(n_rays, np.float32)
    tmax = np.full(n_rays, 1e30, np.float32)
    jt, jtri, ju, jv = (np.asarray(x) for x in JTP.intersect_clusters(
        *(jnp.asarray(a) for a in jpk), jnp.asarray(pos), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), interpret=True))
    t, tri, u, v = (x.numpy() for x in WB.walk_wide_plain(
        WB.pack_wide_clusters(tpk[2]), *tt(pos, d, tmin, tmax)))
    hit = tri >= 0
    assert (hit.any() or n_tris < 100) and not hit.all()
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5)
    np.testing.assert_allclose(u[hit], ju[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v[hit], jv[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t[~hit], tmax[~hit])   # t_max not clamped


def test_one_level_walk_vs_jax_kernel_any_hit():
    rng, jpk, tpk = packs(9, 120)
    n = 777
    pos = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin, tmax = np.zeros(n, np.float32), np.full(n, 1e30, np.float32)
    jt, jtri, _, _ = (np.asarray(x) for x in JTP.intersect_clusters(
        *(jnp.asarray(a) for a in jpk), jnp.asarray(pos), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), any_hit=True, interpret=True))
    q = tt(pos, d, tmin, tmax)
    t, tri, _, _ = WB.walk_wide_plain(WB.pack_wide_clusters(tpk[2]), *q, True)
    occ = tri.numpy() >= 0
    np.testing.assert_array_equal(occ, jtri >= 0)
    assert occ.any() and not occ.all()
    np.testing.assert_array_equal(t.numpy(), jt)         # t_min where occluded
    assert torch.equal(TTP.occluder_valid(torch.from_numpy(tpk[2]), tri, *q),
                       tri >= 0)


@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'anyhit'])
def test_two_level_walk_vs_jax_kernel(any_hit):
    seed_scene, seed_rays, t_max = (3, 5, 6.0) if any_hit else (0, 1, 1e30)
    meshes, instances, jpk, _ = _build(seed=seed_scene)
    wide = TTT.pack_stream_tlas(meshes, instances)['wide']
    n = 1024
    pos, d = _rays(n, seed=seed_rays)
    jout = JTT.intersect_stream_tlas(
        *(jnp.asarray(jpk[k]) for k in ('tlas_f', 'tlas_i', 'nodes_f',
                                        'nodes_i', 'inst_f', 'inst_i',
                                        'tris_hbm')),
        pos, d, jnp.zeros((n,)), jnp.full((n,), t_max), any_hit=any_hit,
        interpret=True)
    jt, jtri, ju, jv, jinst = (np.asarray(x) for x in jout)
    t, tri, u, v, inst = (x.numpy() for x in WB.walk_wide_plain(
        wide, *tt(pos, d), torch.zeros(n),
        torch.full((n,), min(t_max, T_MAX)), any_hit))
    hit = tri >= 0
    np.testing.assert_array_equal(hit, jtri >= 0)
    assert hit.sum() > 20 and not hit.all()
    if any_hit:
        np.testing.assert_array_equal(t, jt)             # t_min where occluded
        assert (tri[hit] == 0).all() and (inst == -1).all()
        return
    np.testing.assert_allclose(t[hit], jt[hit], rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(inst[hit], jinst[hit])
    assert (inst[~hit] == -1).all()
    assert (tri[hit] == jtri[hit]).mean() > 0.99
    np.testing.assert_allclose(u[hit], ju[hit], rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(v[hit], jv[hit], rtol=5e-3, atol=5e-4)


# ---- ties -------------------------------------------------------------------

SHEETS = 6


def coincident_sheets():
    """Six coincident 8 x 8 sheets of quads (2 triangles each): every hit
    is a tie between a triangle of rows 0-127 and its five twins, 128 rows
    apart, which leaves of at most 4 cannot all hold together."""
    g = np.arange(8, dtype=np.float32)
    x, z = (a.reshape(-1) for a in np.meshgrid(g, g, indexing='ij'))
    low = np.stack([x, np.zeros_like(x), z], 1)
    sheet = np.zeros((128, 12), np.float32)
    sheet[:64, 0:3], sheet[:64, 3:6], sheet[:64, 6:9] = \
        low, (1, 0, 0), (0, 0, 1)
    sheet[64:, 0:3], sheet[64:, 3:6], sheet[64:, 6:9] = \
        low + (1, 0, 1), (-1, 0, 0), (0, 0, -1)
    return np.concatenate([sheet] * SHEETS)


@pytest.mark.parametrize('mirror', [False, True], ids=['down', 'up'])
def test_tie_between_leaves_goes_to_the_lower_index(mirror):
    tris12 = coincident_sheets()
    wide = WB.pack_wide_clusters(tris12)
    # every triangle has a twin in another leaf
    leaf_of = np.empty(len(tris12), np.int64)
    for r in WB.node_refs(wide.nodes).reshape(-1):
        if r < 0 and r != WB.EMPTY:
            leaf_of[wide.index[(~r) >> 3:((~r) >> 3) + ((~r) & 7)]] = r
    leaf_of = leaf_of.reshape(SHEETS, 128)
    assert (leaf_of != leaf_of[0]).any(axis=0).all()
    rng = np.random.default_rng(5)
    n = 512
    sign = -1.0 if mirror else 1.0
    pos = np.stack([rng.uniform(0.1, 7.9, n), np.full(n, 2.0 * sign),
                    rng.uniform(0.1, 7.9, n)], 1).astype(np.float32)
    d = np.tile(np.array([[0, -sign, 0]], np.float32), (n, 1))
    q = tt(pos, d, np.zeros(n, np.float32), np.full(n, 1e30, np.float32))
    walk = WB.walk_wide_plain(wide, *q)
    plain = TTP.intersect_clusters_plain(torch.from_numpy(tris12), *q)
    assert (walk[1] >= 0).all() and (walk[1] < 128).all()
    assert_same(walk, plain, False, True)
    assert (walk[0] == 2.0).all()


@pytest.mark.parametrize('mirror', [False, True], ids=['down', 'up'])
def test_tie_between_instances_goes_to_the_first_in_dfs_order(mirror):
    """tests/test_torch_tlas.py's stacked quads, three deep."""
    quad = (np.array([[-1, 0, -1], [-1, 0, -1]], np.float32),
            np.array([[2, 0, 0], [2, 0, 2]], np.float32),
            np.array([[2, 0, 2], [0, 0, 2]], np.float32))
    inst = [dict(geom_id=0, m0=np.eye(4, dtype=np.float32)) for _ in range(3)]
    pk = TTT.pack_stream_tlas([quad], inst)
    leaves = pk['tlas_i'][:, 1]
    first = int(leaves[leaves >= 0][0])
    n = 64
    rng = np.random.default_rng(2)
    sign = -1.0 if mirror else 1.0
    pos = np.stack([rng.uniform(-0.9, 0.9, n), np.full(n, 2.0 * sign),
                    rng.uniform(-0.9, 0.9, n)], 1).astype(np.float32)
    d = np.tile(np.array([[0, -sign, 0]], np.float32), (n, 1))
    q = tt(pos, d, np.zeros(n, np.float32), np.full(n, 1e30, np.float32))
    walk = WB.walk_wide_plain(pk['wide'], *q)
    plain = TTT.intersect_tlas_plain(TTT.tlas_pack(pk).to('cpu'), *q)
    assert (walk[1] >= 0).all() and (walk[4] == first).all()
    assert_same(walk, plain, False, False)


# ---- the stack guard --------------------------------------------------------

def chain_bvh(depth):
    """A degenerate binary tree: every inner node has one leaf and one inner
    child, ``depth`` deep."""
    n = 2 * depth + 1
    bvh = TB.FlatBVH(
        bmin=np.zeros((n, 3), np.float32), bmax=np.ones((n, 3), np.float32),
        skip=np.full(n, -1, np.int32), tri_offset=np.zeros(n, np.int32),
        tri_count=np.zeros(n, np.int32), order=np.arange(depth + 1,
                                                         dtype=np.int32))
    for k in range(depth):                    # node 2k: inner; 2k + 1: leaf
        bvh.tri_count[2 * k + 1] = 1
        bvh.tri_offset[2 * k + 1] = k
        bvh.skip[2 * k + 1] = 2 * k + 2
    bvh.tri_count[n - 1] = 1
    bvh.tri_offset[n - 1] = depth
    return bvh


def test_stack_guard_raises_on_a_deep_tree():
    nodes, stack = WB.collapse(chain_bvh(12))
    assert len(nodes) == 4 and stack == 4 * 3  # three leaves wait a level
    WB.require_stack('shallow', stack)
    nodes, stack = WB.collapse(chain_bvh(300))
    assert len(nodes) == 100 and stack == 300
    deep = WB.WidePack(nodes=nodes, rows=np.zeros((301, 12), np.float32),
                       index=np.arange(301, dtype=np.int32), stack=stack)
    assert deep.stack > WB.MAX_STACK
    with pytest.raises(ValueError, match='stack'):
        WB.require_stack('deep', deep.stack)
    q = random_query(1, 8, 1.0, 1e30)
    with pytest.raises(ValueError, match='stack'):
        WB.walk_wide_plain(deep, *q)


def test_collapse_refuses_fat_leaves():
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    e = rng.uniform(-0.1, 0.1, (2, 40, 3)).astype(np.float32)
    with pytest.raises(ValueError, match='leaf'):
        WB.collapse(TB.build(v0, e[0], e[1], max_leaf=16))


def test_scene_carries_the_wide_tables(mid_city, icity):
    scene, meta = mid_city
    assert meta.use_pallas and scene.cl_wide.index.shape[0] == meta.num_tris
    assert scene.cl_wide.nodes.dtype == torch.float32
    assert scene.cl_wide.index.dtype == torch.int32
    assert icity[0].tt.wide.inst_i.shape == icity[0].tt.inst_i.shape
    assert icity[0].cl_wide is None and scene.tt is None
    # the contract's node tables are for the host: no kernel reads them
    assert scene.cl_nodes_f.device.type == 'cpu'
    assert scene.cl_nodes_i.device.type == 'cpu'


def _good_rays(n=16):
    return [torch.zeros(n, 3), torch.ones(n, 3), torch.zeros(n),
            torch.full((n,), 1e30)]


def test_ray_arrays_passes_the_callers_tensors_through():
    rays = _good_rays()
    out = TTS.ray_arrays('query', *rays)
    for a, b in zip(out, rays):
        assert a.data_ptr() == b.data_ptr()              # no copy
    out = TTS.ray_arrays('query', rays[0].double(), rays[1].T.contiguous().T,
                         *rays[2:])
    assert all(x.dtype == torch.float32 and x.is_contiguous() for x in out)
    assert [tuple(x.shape) for x in TTS.ray_arrays(
        'query', *_good_rays(0))] == [(0, 3), (0, 3), (0,), (0,)]


@pytest.mark.parametrize('which,bad', [
    ('ray_pos', lambda n: torch.zeros(n, 4)),
    ('ray_dir', lambda n: torch.ones(n // 2, 3)),
    ('ray_dir', lambda n: torch.ones(n, 3, device='meta')),
    ('t_min', lambda n: torch.zeros(n, 1)),
    ('t_max', lambda n: torch.full((1,), 1e30)),
    ('t_max', lambda n: torch.full((n, 1), 1e30)),
    ('t_max', lambda n: torch.full((n,), 1e30, device='meta')),
])
def test_ray_arrays_refuses_wrong_rays(which, bad):
    rays = _good_rays()
    at = ('ray_pos', 'ray_dir', 't_min', 't_max').index(which)
    rays[at] = bad(16)
    with pytest.raises(ValueError, match=which):
        TTS.ray_arrays('query', *rays)
