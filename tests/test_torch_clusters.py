"""The port's mid-size (cluster BVH) path against the JAX package's.

``pack_cluster_bvh`` table by table; ``intersect_clusters_plain`` (the plain
torch version of the CUDA kernel: dense Moller-Trumbore in index order)
against ``intersect_clusters`` in Pallas interpret mode at
tests/test_pallas_traverse.py's sizes, nearest (hit flags and triangle ids
equal, t within rtol 1e-5, u and v within rtol 1e-4 / atol 1e-5) and any-hit
(occlusion flags equal), its no-premature-exit scene included; the
``'auto'`` routing at the class boundaries; and the class end to end on a
4,610-triangle city: the build's cluster tables and one ``trace_pass`` lane
by lane against the JAX package (accum within rtol/atol 1e-3 on >= 99.5% of
lanes, flags and RNG state equal on >= 99.9%).  The card-side wide tables
of the build (``scene.cl_wide``): ``walk_wide_plain`` over them against the
JAX kernel in interpret mode on the city's camera rays, at the bars above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu.accel import build_bvh as JB
from hydracore3_tpu.accel import traverse_pallas as JTP
from hydracore3_tpu.models import integrator_pt as JIPT
from hydracore3_tpu.ops import rng as JRNG
from hydracore3_tpu.scene import synth as jsynth
from hydracore3_torch.accel import build_bvh as TB
from hydracore3_torch.accel import traverse_pallas as TTP
from hydracore3_torch.accel import wide_bvh as TWB
from hydracore3_torch.models import integrator_pt as TIPT
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.scene import build as TBUILD
from hydracore3_torch.scene import synth as tsynth
from test_pallas_traverse import random_rays, random_scene
from test_torch_scene import assert_tables_equal, scene_arrays_from_jax

# 64 buildings of 40 triangles, a 2,048-triangle ground, the light's 2
MID_CITY_KW = dict(n_blocks=8, subdiv=2, seed=3, width=32, height=16, depth=2,
                   ground_subdiv=32, textured=True)


def packs(seed, n_tris):
    rng = np.random.default_rng(seed)
    v0, e1, e2 = random_scene(rng, n_tris)
    jb = JB.build(v0, e1, e2, max_leaf=JTP.CLUSTER)
    tb = TB.build(v0, e1, e2, max_leaf=TTP.CLUSTER)
    np.testing.assert_array_equal(jb.order, tb.order)
    o = tb.order
    return (rng, JTP.pack_cluster_bvh(jb, v0[o], e1[o], e2[o]),
            TTP.pack_cluster_bvh(tb, v0[o], e1[o], e2[o]))


@pytest.mark.parametrize('n_tris', [37, 300, 5000])
def test_pack_matches_jax(n_tris):
    _, jpk, tpk = packs(42 + n_tris, n_tris)
    for j, t, name in zip(jpk, tpk, ('nodes_f', 'nodes_i', 'tris12')):
        assert j.dtype == t.dtype and j.shape == t.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert TTP.CLUSTER == JTP.CLUSTER
    assert TTP.VMEM_TRI_LIMIT == JTP.VMEM_TRI_LIMIT


def both(jpk, tpk, pos, d, tmin, tmax, any_hit):
    jout = JTP.intersect_clusters(
        *(jnp.asarray(a) for a in jpk), jnp.asarray(pos), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), any_hit=any_hit, interpret=True)
    tout = TTP.intersect_clusters(
        *(torch.from_numpy(a) for a in tpk), torch.from_numpy(np.array(pos)),
        torch.from_numpy(np.array(d)), torch.from_numpy(tmin),
        torch.from_numpy(tmax), any_hit=any_hit)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


@pytest.mark.parametrize('n_tris,n_rays', [(37, 256), (300, 1500)])
def test_plain_vs_jax_kernel_nearest(n_tris, n_rays):
    rng, jpk, tpk = packs(42 + n_tris, n_tris)
    pos, d = random_rays(rng, n_rays)
    tmin = np.zeros(n_rays, np.float32)
    tmax = np.full(n_rays, 1e30, np.float32)
    (jt, jtri, ju, jv), (t, tri, u, v) = both(jpk, tpk, pos, d, tmin, tmax,
                                              False)
    hit = tri >= 0
    # 37 spread-out triangles may catch none of 256 rays
    assert (hit.any() or n_tris < 100) and not hit.all()
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5)
    np.testing.assert_allclose(u[hit], ju[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v[hit], jv[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t[~hit], tmax[~hit])   # t_max not clamped


def test_plain_vs_jax_kernel_any_hit():
    rng, jpk, tpk = packs(9, 120)
    pos, d = random_rays(rng, 777)
    tmin = np.zeros(777, np.float32)
    tmax = np.full(777, 1e30, np.float32)
    (jt, jtri, _, _), (t, tri, _, _) = both(jpk, tpk, pos, d, tmin, tmax, True)
    occ = tri >= 0
    np.testing.assert_array_equal(occ, jtri >= 0)
    assert occ.any() and not occ.all()
    np.testing.assert_array_equal(t, jt)               # t_min where occluded
    # occlusion agrees with the nearest-hit query on the same rays
    near = TTP.intersect_clusters_plain(
        torch.from_numpy(tpk[2]), torch.from_numpy(np.array(pos)),
        torch.from_numpy(np.array(d)), torch.from_numpy(tmin),
        torch.from_numpy(tmax))
    np.testing.assert_array_equal(occ, near[1].numpy() >= 0)


def test_plain_any_hit_no_premature_exit():
    """tests/test_pallas_traverse.py's two separated leaves: lanes aimed at
    the second leaf only must still come out occluded."""
    tris12 = np.zeros((2, 12), np.float32)
    tris12[0, 0:9] = (-10, -10, 0, 20, 0, 0, 0, 20, 0)
    tris12[1, 0:9] = (90, -10, 0, 20, 0, 0, 0, 20, 0)
    nodes_f = np.zeros((3, 8), np.float32)
    nodes_i = np.zeros((3, 4), np.int32)
    nodes_f[0, 0:6] = (-10, -10, -1, 110, 10, 1)
    nodes_f[1, 0:6] = (-10, -10, -1, 10, 10, 1)
    nodes_f[2, 0:6] = (90, -10, -1, 110, 10, 1)
    nodes_i[0] = (-1, 0, 0, 0)
    nodes_i[1] = (2, 0, 1, 0)
    nodes_i[2] = (-1, 1, 1, 0)
    n = JTP.TILE
    pos = np.zeros((n, 3), np.float32)
    d = np.tile(np.array([0., 0., 1.], np.float32), (n, 1))
    pos[:n // 2] = (0., 0., -5.)
    pos[n // 2:] = (100., 0., -5.)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 10.0, np.float32)
    pk = (nodes_f, nodes_i, tris12)
    (_, jtri, _, _), (t, tri, _, _) = both(pk, pk, pos, d, tmin, tmax, True)
    assert (tri >= 0).all() and (jtri >= 0).all()
    np.testing.assert_array_equal(tri, jtri)           # 0 left, 1 right
    assert (t == 0.0).all()


def test_wrapper_on_cpu_uses_plain_and_counts_nothing():
    rng, _, tpk = packs(5, 200)
    pos, d = (torch.from_numpy(np.array(a)) for a in random_rays(rng, 128))
    tabs = [torch.from_numpy(a) for a in tpk]
    before = TTP.intersect_clusters.launches
    got = TTP.intersect_clusters(*tabs, pos, d, torch.zeros(128),
                                 torch.full((128,), 1e30))
    want = TTP.intersect_clusters_plain(tabs[2], pos, d, torch.zeros(128),
                                        torch.full((128,), 1e30))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert TTP.intersect_clusters.launches == before


def soup_desc(n_tris, seed=1):
    """A description of ``n_tris`` triangles: one random mesh and the area
    light's two."""
    rng = np.random.default_rng(seed)
    T = n_tris - 2
    pos = rng.uniform(-10, 10, (T, 1, 3)) + rng.uniform(-0.2, 0.2, (T, 3, 3))
    sd = TBUILD.SceneDesc(width=8, height=8, trace_depth=2)
    sd.materials.append(TBUILD.MaterialDesc())
    sd.meshes.append(TBUILD.MeshDesc(
        pos=pos.reshape(-1, 3).astype(np.float32),
        indices=np.arange(3 * T).reshape(T, 3), mat_indices=np.zeros(T, int)))
    sd.instances.append((0, None))
    sd.lights.append(TBUILD.AreaLightDesc())
    return sd


@pytest.mark.parametrize('n_tris,route', [
    (4095, 'small'), (4096, 'clusters'), (175_000, 'clusters'),
    (175_001, 'stream')])
def test_auto_routing(n_tris, route):
    """The JAX build's class boundaries (scene/build.py:1348-1352)."""
    scene, meta = TBUILD.build_scene(soup_desc(n_tris), device='cpu')
    assert not meta.use_stream_tlas
    assert meta.use_pallas == (route == 'clusters')
    assert meta.use_stream == (route == 'stream')
    assert (scene.cl_tris12 is not None) == meta.use_pallas
    assert (scene.st_woop is not None) == meta.use_stream
    if route == 'stream':
        assert meta.num_tris % 64 == 0 and meta.num_tris > n_tris   # padded
    else:
        assert meta.num_tris == n_tris
    if meta.use_pallas:
        assert scene.cl_tris12.shape == (n_tris, 12)
        torch.testing.assert_close(scene.cl_tris12[:, 0:3], scene.tri_v0)


def test_accel_stream_still_streams_a_mid_size_scene():
    _, meta = TBUILD.build_scene(soup_desc(5000), device='cpu',
                                  accel='stream')
    assert meta.use_stream and not meta.use_pallas


# ---- the class end to end -------------------------------------------------

@pytest.fixture(scope='module')
def mid_city(tmp_path_factory):
    jscene, jmeta = jsynth.city_scene(
        **MID_CITY_KW, cache_dir=str(tmp_path_factory.mktemp('mid') / 's'))
    return jscene, jmeta, *tsynth.city_scene(**MID_CITY_KW, device='cpu')


def test_mid_city_routes_to_clusters(mid_city):
    _, jmeta, _, tmeta = mid_city
    assert jmeta.use_pallas and tmeta.use_pallas
    assert not tmeta.use_stream and not tmeta.use_stream_tlas
    assert jmeta.num_tris == tmeta.num_tris == 4610


@pytest.mark.parametrize('group', ['cl', 'tri', 'mat', 'light', 'misc'])
def test_mid_city_tables_equal(mid_city, group):
    jscene, jmeta, tscene, _ = mid_city
    ja = scene_arrays_from_jax(jscene, jmeta)
    for k in ('cl_nodes_f', 'cl_nodes_i', 'cl_tris12'):
        ja[k] = np.asarray(getattr(jscene, k))
    assert_tables_equal(ja, tscene.to_numpy(), group)


def test_mid_city_trace_pass_matches_jax(mid_city):
    """The JAX pass runs its Pallas cluster kernel in interpret mode, the
    port the plain version."""
    jscene, jmeta, tscene, tmeta = mid_city
    N = tmeta.width * tmeta.height
    jp = jnp.arange(N, dtype=jnp.int32)
    j_acc, _, j_fl, j_rng, _ = (np.asarray(x) for x in JIPT.trace_pass(
        jscene, jmeta, JRNG.gen_init(jp), jp))
    tp = torch.arange(N)
    t_acc, t_fl, t_rng = (x.numpy() for x in TIPT.trace_pass(
        tscene, tmeta, TRNG.gen_init(tp), tp))
    assert np.isfinite(t_acc).all()
    close = np.isclose(t_acc, j_acc, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.995, f'accum agrees on {close.mean():.4%}'
    assert (t_fl.astype(np.uint32) == j_fl).mean() >= 0.999
    assert (t_rng.astype(np.uint32) == j_rng).all(axis=1).mean() >= 0.999
    assert (t_acc[:, :3].sum(1) > 0).mean() > 0.5


@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'anyhit'])
def test_mid_city_wide_walk_matches_jax_kernel(mid_city, any_hit):
    """The walk over the build's wide tables returns indices into the
    contract tables: the JAX kernel's triangles on the camera rays."""
    jscene, _, tscene, tmeta = mid_city
    n = tmeta.width * tmeta.height
    pix = torch.arange(n)
    st = TIPT.kernel_init_eye_ray(tscene, tmeta, TRNG.gen_init(pix), pix)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 60.0 if any_hit else 1e30, np.float32)
    jt, jtri, ju, jv = (np.asarray(x) for x in JTP.intersect_clusters(
        jscene.cl_nodes_f, jscene.cl_nodes_i, jscene.cl_tris12,
        jnp.asarray(st.ray_pos.numpy()), jnp.asarray(st.ray_dir.numpy()),
        jnp.asarray(tmin), jnp.asarray(tmax), any_hit=any_hit,
        interpret=True))
    q = (st.ray_pos, st.ray_dir, torch.from_numpy(tmin),
         torch.from_numpy(tmax))
    t, tri, u, v = TWB.walk_wide_plain(tscene.cl_wide, *q, any_hit)
    hit = tri.numpy() >= 0
    np.testing.assert_array_equal(hit, jtri >= 0)
    assert hit.any() and not hit.all()
    if any_hit:
        np.testing.assert_array_equal(t.numpy(), jt)
        assert torch.equal(TTP.occluder_valid(tscene.cl_tris12, tri, *q),
                           tri >= 0)
        return
    np.testing.assert_array_equal(tri.numpy(), jtri)
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-5)
    np.testing.assert_allclose(u.numpy()[hit], ju[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v.numpy()[hit], jv[hit], rtol=1e-4, atol=1e-5)


def test_mid_city_matches_streamed_city():
    """The same city through the cluster route and streamed: the port's two
    routes agree."""
    a_scene, a_meta = tsynth.city_scene(**MID_CITY_KW, device='cpu')
    b_scene, b_meta = tsynth.city_scene(**MID_CITY_KW, accel='stream',
                                         device='cpu')
    assert a_meta.use_pallas and b_meta.use_stream
    pix = torch.arange(a_meta.width * a_meta.height)
    a, fa, _ = TIPT.trace_pass(a_scene, a_meta, TRNG.gen_init(pix), pix)
    b, fb, _ = TIPT.trace_pass(b_scene, b_meta, TRNG.gen_init(pix), pix)
    close = np.isclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-3).all(1)
    assert close.mean() >= 0.995
    assert (fa == fb).float().mean() >= 0.99
