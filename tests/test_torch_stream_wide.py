"""The table that the card's streamed kernels K2 and K3 walk.

``wide_bvh.pack_wide_stream`` derives it from the streamed contract tables
(``traverse_stream.pack_stream_bvh``'s nodes and padded Woop rows): a tree of
4-wide nodes over leaves of at most 4 triangles per cluster, rooted at
``cl_root[c]``, under the collapsed stream BVH.  Held here, on the small city
of tests/test_big_scene.py streamed and on random soups of a few hundred
triangles, all made from numpy seeds:

* structure: every real triangle once, under its own cluster's root; the
  rows bit-equal to the contract's Woop rows of their padded slot; no
  padding slot; every child box inside its parent's and every leaf's
  corners inside its box; ``stack`` and ``cl_stack`` equal to the deepest
  waiting count of a near-first walk from node 0 / from any cluster root;
* ``walk_wide_plain`` over the table (K2's walk) against the dense plain
  version ``intersect_plain``: t, triangle, u, v EQUAL on every lane
  (nearest), flags and t equal with tri = 0 on occlusion (any-hit), on
  camera, shadow and random rays;
* the walk from each ``cl_root[c]`` (what K3 does at a cluster) against
  ``intersect_plain`` on that cluster's 64 rows, on every lane;
* the walk against the JAX ``intersect_stream`` and ``intersect_march`` in
  Pallas interpret mode at tests/test_torch_traverse.py's bars: hit masks
  equal, t within rtol 2e-4 / atol 1e-5, the triangle equal on >= 99.9% of
  hits, u and v within rtol 1e-3 / atol 1e-4 where it is;
* ties: coincident triangles in two clusters whose boxes a ray and its
  mirror enter in opposite orders: the lower padded slot wins both ways;
* the stack guards of both stacks, and ``scene.st_wide`` on every streamed
  scene (and on no other).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu.accel import traverse_dda as JTD
from hydracore3_tpu.accel import traverse_stream as JTS
from hydracore3_torch.accel import traverse_stream as TTS
from hydracore3_torch.accel import wide_bvh as WB
from hydracore3_torch.scene import synth as tsynth
from test_torch_clusters import MID_CITY_KW
from test_torch_kernels_cuda import port_pack, twin_clusters
from test_torch_scene import CITY_KW
from test_torch_tlas import ICITY_KW
from test_torch_traverse import (assert_same_hits, jax_pack, random_rays,
                                 random_scene)
from test_torch_wide import check_tree, corners, first_bounce_rays, \
    random_query, tt

TBK = TTS.TBK
T_MAX = TTS.T_MAX_CAP


def stream_tables(v0, e1, e2):
    """(nodes_f, nodes_i, woop, padded soup, pack) of a random soup."""
    nf, ni, woop, _, _, w, soup = port_pack(v0, e1, e2)
    return nf, ni, woop, soup, w


@pytest.fixture(scope='module')
def city():
    scene, meta = tsynth.city_scene(**CITY_KW, device='cpu')
    assert meta.use_stream
    w = scene.st_wide
    host = WB.WidePack(**{k: v.numpy() if isinstance(v, torch.Tensor) else v
                          for k, v in vars(w).items()})
    return scene, meta, host


def soup_source(source, city):
    """(nodes_f, nodes_i, woop, padded soup, pack) of a named source."""
    if source == 'city':
        scene, _, w = city
        tabs = (scene.st_nodes_f.numpy(), scene.st_nodes_i.numpy(),
                scene.st_woop.numpy(),
                tuple(getattr(scene, k).numpy()
                      for k in ('tri_v0', 'tri_e1', 'tri_e2')))
        return (*tabs, w)
    n = dict(soup300=300, soup70=70, soup1=1)[source]
    return stream_tables(*random_scene(np.random.default_rng(n), n))


# ---- structure -------------------------------------------------------------

@pytest.mark.parametrize('source', ['city', 'soup300', 'soup70', 'soup1'])
def test_stream_pack_structure(source, city):
    nf, ni, woop, (v0, e1, e2), w = soup_source(source, city)
    real = np.abs(woop).sum(1) > 0
    slot = ni[ni[:, 1] >= 0, 1]
    count = np.zeros(len(woop) // TBK, np.int64)
    count[slot] = ni[ni[:, 1] >= 0, 2]
    assert w.woop and w.nodes.dtype == np.float32 and w.index.dtype == np.int32
    assert w.cl_root.dtype == np.int32 and len(w.cl_root) == len(count)
    # every real slot once (no padding slot), the rows the contract's bits
    np.testing.assert_array_equal(np.sort(w.index), np.nonzero(real)[0])
    np.testing.assert_array_equal(w.rows.view(np.int32),
                                  woop[w.index].view(np.int32))

    def leaf_corners(off, cnt):
        s = w.index[off:off + cnt]
        return corners(v0[s], e1[s], e2[s])

    # from node 0: every leaf once, and the exact stack
    seen = []
    assert w.stack == check_tree(w.nodes, 0, leaf_corners, seen)
    # the leaves tile the fine order
    seen.sort()
    assert seen[0][0] == 0 and sum(c for _, c in seen) == int(real.sum())
    assert all(a[0] + a[1] == b[0] for a, b in zip(seen, seen[1:]))
    # from each cluster's root: its own slots and nothing else
    cl_stack = 0
    for c, root in enumerate(w.cl_root):
        seen = []
        cl_stack = max(cl_stack, check_tree(w.nodes, int(root), leaf_corners,
                                            seen))
        slots = np.concatenate([w.index[o:o + k] for o, k in seen])
        np.testing.assert_array_equal(np.sort(slots),
                                      np.arange(c * TBK, c * TBK + count[c]))
    assert w.cl_stack == cl_stack
    # the cluster roots hang off the top exactly once each
    refs = WB.node_refs(w.nodes)
    top = refs[:int(w.cl_root.min())]
    np.testing.assert_array_equal(np.sort(top[np.isin(top, w.cl_root)]),
                                  np.sort(w.cl_root))


# ---- the walk against the plain version and the JAX kernels ----------------

@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'anyhit'])
@pytest.mark.parametrize('rays', ['camera', 'shadow', 'random'])
def test_stream_walk_equals_plain(city, rays, any_hit):
    scene, meta, w = city
    if rays == 'random':
        q = random_query(3, 1500, 30.0, 20.0 if any_hit else T_MAX)
        q[0][:, 1] = q[0][:, 1].abs()              # above the ground
    else:
        q = first_bounce_rays(scene, meta)[rays == 'shadow']
    counts = {}
    walk = WB.walk_wide_plain(w, *q, any_hit, counts=counts)
    plain = TTS.intersect_plain(scene.st_woop, *q[:3],
                                torch.clamp(q[3], max=T_MAX), any_hit)
    assert (plain[1] >= 0).any() and not (plain[1] >= 0).all()
    for name, a, b in zip(('t', 'tri', 'u', 'v'), walk, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    if any_hit:
        assert (walk[1][walk[1] >= 0] == 0).all()
    # a walk, not a scan
    real = int((scene.st_woop.abs().sum(1) > 0).sum())
    assert counts['tri_tests'] < 0.05 * q[0].shape[0] * real


def aimed_rays(rng, n, bmin, bmax):
    """Rays from around a box toward random points inside it."""
    c, ext = 0.5 * (bmin + bmax), np.maximum(bmax - bmin, 1e-3)
    pos = c + rng.uniform(-2, 2, (n, 3)) * ext
    to = rng.uniform(bmin, bmax, (n, 3))
    d = to - pos
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tt(pos.astype(np.float32), d.astype(np.float32),
              np.zeros(n, np.float32), np.full(n, T_MAX, np.float32))


@pytest.mark.parametrize('source', ['city', 'soup300'])
def test_cluster_walk_equals_plain_on_its_rows(source, city):
    nf, ni, woop, _, w = soup_source(source, city)
    rng = np.random.default_rng(11)
    leaf = ni[:, 1] >= 0
    woop_t = torch.from_numpy(woop)
    for node in np.nonzero(leaf)[0]:
        c = int(ni[node, 1])
        q = aimed_rays(rng, 96, nf[node, 0:3], nf[node, 3:6])
        walk = WB.walk_wide_plain(w, *q, root=int(w.cl_root[c]))
        t, tri, u, v = TTS.intersect_plain(woop_t[c * TBK:(c + 1) * TBK], *q)
        tri = torch.where(tri >= 0, tri + c * TBK, tri)
        assert (tri >= 0).any()
        for name, a, b in zip(('t', 'tri', 'u', 'v'), walk, (t, tri, u, v)):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f'{name}, cluster {c}')


@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'anyhit'])
def test_stream_walk_vs_jax_stream_kernel(any_hit):
    rng = np.random.default_rng(5)
    v0, e1, e2 = random_scene(rng, 800)
    jnf, jni, jtris, _, _ = jax_pack(v0, e1, e2)
    w = stream_tables(v0, e1, e2)[4]
    pos, d = random_rays(rng, 1024)
    tmin = np.zeros(1024, np.float32)
    tmax = np.full(1024, 3.0 if any_hit else 1e30, np.float32)
    jt, jtri, ju, jv = (np.asarray(x) for x in JTS.intersect_stream(
        jnp.asarray(jnf), jnp.asarray(jni), jnp.asarray(jtris),
        jnp.asarray(pos), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), any_hit=any_hit, interpret=True))
    t, tri, u, v = (x.numpy() for x in WB.walk_wide_plain(
        w, *tt(pos, d, tmin, np.minimum(tmax, T_MAX)), any_hit))
    if any_hit:
        np.testing.assert_array_equal(tri >= 0, jtri >= 0)
        np.testing.assert_array_equal(t, jt)
        assert (tri[tri >= 0] == 0).all() and (tri >= 0).any()
        return
    assert_same_hits(t, tri, jt, jtri)
    same = (tri >= 0) & (tri == jtri)
    np.testing.assert_allclose(u[same], ju[same], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(v[same], jv[same], rtol=1e-3, atol=1e-4)


def test_stream_walk_vs_jax_march_kernel_with_outliers():
    """tests/test_torch_traverse.py's outlier scene: a dense cloud plus a
    far overhead quad that the grid sends to its outlier list."""
    rng = np.random.default_rng(4)
    v0, e1, e2 = random_scene(rng, 600)
    n_far = JTS.TBK
    fx = rng.uniform(-40, 40, n_far).astype(np.float32)
    fz = rng.uniform(-40, 40, n_far).astype(np.float32)
    fv0 = np.stack([fx, np.full(n_far, 120.0, np.float32), fz], -1)
    fe1 = np.tile(np.array([[3.0, 0, 0]], np.float32), (n_far, 1))
    fe2 = np.tile(np.array([[0, 0, 3.0]], np.float32), (n_far, 1))
    v0, e1, e2 = (np.concatenate([a, b]) for a, b in
                  ((v0, fv0), (e1, fe1), (e2, fe2)))
    w = stream_tables(v0, e1, e2)[4]
    _, _, jtris, _, jgrid = jax_pack(v0, e1, e2)
    n = 1024
    pos, d = random_rays(rng, n, box=5.0)
    d[:n // 2, 1] = np.abs(d[:n // 2, 1]) + 2.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    jt, jtri, _, _, jun = (np.asarray(x) for x in JTD.intersect_march(
        jgrid, jnp.asarray(jtris), jnp.asarray(pos), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), interpret=True,
        with_unresolved=True))
    assert int(jun.sum()) == 0
    t, tri, _, _ = (x.numpy() for x in WB.walk_wide_plain(
        w, *tt(pos, d, tmin, np.minimum(tmax, T_MAX))))
    assert_same_hits(t, tri, jt, jtri)
    assert (tri >= 0).any() and (tri >= len(w.rows) - n_far).any()


# ---- ties across clusters ---------------------------------------------------

@pytest.mark.parametrize('mirror', [False, True], ids=['down', 'up'])
def test_tie_between_clusters_goes_to_the_lower_slot(mirror):
    woop, w = (twin_clusters()[k] for k in (2, 5))
    rng = np.random.default_rng(5)
    n = 512
    sign = -1.0 if mirror else 1.0
    pos = np.stack([rng.uniform(0.1, 4.9, n), np.full(n, 2.0 * sign),
                    rng.uniform(0.1, 4.9, n)], 1).astype(np.float32)
    d = np.tile(np.array([[0, -sign, 0]], np.float32), (n, 1))
    q = tt(pos, d, np.zeros(n, np.float32), np.full(n, T_MAX, np.float32))
    plain = TTS.intersect_plain(torch.from_numpy(woop), *q)
    assert (plain[1] >= 0).all() and (plain[1] < 50).all()
    assert (plain[0] == 2.0).all()
    walk = WB.walk_wide_plain(w, *q)
    for name, a, b in zip(('t', 'tri', 'u', 'v'), walk, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


# ---- the stack guards -------------------------------------------------------

def chain_soup(n=64):
    """Triangles whose sizes and places grow geometrically: the SAH build
    peels one off at each split, so one cluster's tree is a chain."""
    s = (1.6 ** np.arange(n)).astype(np.float32)
    v0 = np.stack([s, np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    e1 = np.stack([0.2 * s, np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    e2 = np.stack([np.zeros(n), 0.2 * s, np.zeros(n)], 1).astype(np.float32)
    return v0, e1, e2


def test_stack_guards_refuse_deep_trees():
    _, _, woop, _, w = stream_tables(*chain_soup())
    assert w.cl_stack > WB.MARCH_STACK and w.stack >= w.cl_stack
    WB.require_stack('the walk from node 0', w.stack)
    with pytest.raises(ValueError, match='stack'):
        WB.require_stack('intersect_march', w.cl_stack, WB.MARCH_STACK)
    # the walk of the whole table raises past MAX_STACK
    deep = WB.WidePack(nodes=w.nodes, rows=w.rows, index=w.index,
                       stack=WB.MAX_STACK + 1, woop=True, cl_root=w.cl_root,
                       cl_stack=w.cl_stack)
    with pytest.raises(ValueError, match='stack'):
        WB.walk_wide_plain(deep, *random_query(1, 8, 1.0, 1e30))
    # and the chain still walks right within its stack
    q = random_query(2, 256, 40.0, T_MAX)
    walk = WB.walk_wide_plain(w, *q)
    plain = TTS.intersect_plain(torch.from_numpy(woop), *q)
    for a, b in zip(walk, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---- the scene carries the table --------------------------------------------

@pytest.mark.parametrize('name,kw,streamed', [
    ('city', CITY_KW, True),
    ('mid_city_streamed', dict(MID_CITY_KW, accel='stream'), True),
    ('mid_city', MID_CITY_KW, False),
    ('icity_flattened', dict(ICITY_KW, accel='stream'), True),
    ('icity', ICITY_KW, False),
])
def test_streamed_scenes_carry_st_wide(name, kw, streamed):
    build = (tsynth.instanced_city_scene if name.startswith('icity')
             else tsynth.city_scene)
    scene, meta = build(**kw, device='cpu')
    assert meta.use_stream == streamed
    if not streamed:
        assert scene.st_wide is None
        return
    w = scene.st_wide
    real = int((scene.st_woop.abs().sum(1) > 0).sum())
    assert w.woop and w.rows.shape == (real, 12) and w.index.shape == (real,)
    assert w.cl_root.shape[0] == scene.st_woop.shape[0] // TBK
    assert w.nodes.dtype == torch.float32 and w.cl_root.dtype == torch.int32
    assert 0 < w.cl_stack <= WB.MARCH_STACK and w.stack <= WB.MAX_STACK
    assert torch.equal(w.rows, scene.st_woop[w.index.long()])
