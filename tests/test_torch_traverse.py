"""The plain intersector of the port against the JAX traversal functions.

``intersect_plain`` (the plain torch version of both CUDA kernels) is held
against JAX's ``intersect_brute``, ``intersect_stream`` and
``intersect_march`` (Pallas interpret mode, at the sizes of
tests/test_dda_traverse.py), nearest and any-hit, on random soups as that
file builds them and on the small city's soup.  Hit masks must be equal,
t within rtol 2e-4 / atol 1e-5, tri equal on >= 99.9% of hits (the rest
are equal-t ties at shared edges).  The packers must give the JAX tables.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu.accel import build_bvh as JB
from hydracore3_tpu.accel import traverse as JTRV
from hydracore3_tpu.accel import traverse_dda as JTD
from hydracore3_tpu.accel import traverse_stream as JTS
from hydracore3_torch.accel import build_bvh as TB
from hydracore3_torch.accel import traverse_dda as TTD
from hydracore3_torch.accel import traverse_stream as TTS
from hydracore3_torch.models import integrator_pt as TIPT


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


def port_pack(v0, e1, e2):
    """The port's stream BVH + grid over a soup; returns (nodes_f, nodes_i,
    woop, order_padded, grid, leaf-ordered soup)."""
    bvh = TB.build(v0, e1, e2, max_leaf=TTS.TBK)
    o = bvh.order
    nf, ni, woop, op = TTS.pack_stream_bvh(bvh, v0[o], e1[o], e2[o])
    grid = TTD.pack_grid(nf, ni)
    return nf, ni, woop, op, grid, (v0[o], e1[o], e2[o])


def jax_pack(v0, e1, e2):
    bvh = JB.build(v0, e1, e2, max_leaf=JTS.TBK)
    o = bvh.order
    nf, ni, tris, op = JTS.pack_stream_bvh(bvh, v0[o], e1[o], e2[o])
    grid = JTD.pack_grid(nf, ni)
    return nf, ni, tris, op, grid


def plain(woop, pos, d, tmin, tmax, any_hit=False):
    tmax = torch.clamp(torch.as_tensor(tmax), max=0.99 * TTS.FLT_MAX)
    t, tri, u, v = TTS.intersect_plain(torch.as_tensor(woop),
                                       torch.as_tensor(pos),
                                       torch.as_tensor(d),
                                       torch.as_tensor(tmin), tmax, any_hit)
    return t.numpy(), tri.numpy(), u.numpy(), v.numpy()


def assert_same_hits(t_a, tri_a, t_b, tri_b, tri_frac=0.999):
    hit_a, hit_b = tri_a >= 0, tri_b >= 0
    np.testing.assert_array_equal(hit_a, hit_b)
    np.testing.assert_allclose(t_a[hit_a], t_b[hit_b], rtol=2e-4, atol=1e-5)
    if hit_a.any():
        assert (tri_a[hit_a] == tri_b[hit_b]).mean() >= tri_frac


@pytest.mark.parametrize('seed,n_tris', [(31, 1500), (23, 300)])
def test_packers_match_jax(seed, n_tris):
    rng = np.random.default_rng(seed)
    v0, e1, e2 = random_scene(rng, n_tris)
    nf, ni, woop, op, grid, _ = port_pack(v0, e1, e2)
    jnf, jni, jtris, jop, jgrid = jax_pack(v0, e1, e2)
    np.testing.assert_array_equal(nf, jnf)
    np.testing.assert_array_equal(ni, jni)
    np.testing.assert_array_equal(op, jop)
    C = jtris.shape[0]
    jwoop = (jtris[:, 0:4, 0:192].reshape(C, 4, 3, 64)
             .transpose(0, 3, 2, 1).reshape(C * 64, 12))
    np.testing.assert_array_equal(woop, jwoop)
    for k in ('cell_tab', 'cell_cl', 'cl_aabb', 'outliers'):
        np.testing.assert_array_equal(getattr(grid, k),
                                      np.asarray(getattr(jgrid, k)), err_msg=k)
    assert grid.n_outliers == jgrid.n_outliers
    assert grid.dims == jgrid.dims
    np.testing.assert_allclose(grid.lo, jgrid.lo, rtol=0, atol=0)
    np.testing.assert_allclose(grid.h, jgrid.h, rtol=0, atol=0)


@pytest.mark.parametrize('any_hit', [False, True])
def test_plain_vs_brute(any_hit):
    rng = np.random.default_rng(31)
    v0, e1, e2 = random_scene(rng, 1500)
    _, _, woop, op, _, (v0o, e1o, e2o) = port_pack(v0, e1, e2)
    pos, d = random_rays(rng, 1200)
    tmin = np.zeros(1200, np.float32)
    tmax = np.full(1200, 4.0 if any_hit else 1e30, np.float32)
    t, tri, _, _ = plain(woop, pos, d, tmin, tmax, any_hit)
    T = len(v0)
    ref = JTRV.intersect_brute(
        jnp.asarray(v0o), jnp.asarray(e1o), jnp.asarray(e2o),
        jnp.zeros(T, jnp.int32), jnp.zeros(T, jnp.int32),
        jnp.arange(T, dtype=jnp.int32), jnp.asarray(pos), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax))
    hit_r = np.asarray(ref.t) < 1e29
    np.testing.assert_array_equal(tri >= 0, hit_r)
    if any_hit:
        np.testing.assert_array_equal(t[hit_r], tmin[hit_r])
        np.testing.assert_array_equal(tri[hit_r], 0)
        np.testing.assert_allclose(t[~hit_r], tmax[~hit_r], rtol=0)
    else:
        np.testing.assert_allclose(t[hit_r], np.asarray(ref.t)[hit_r],
                                   rtol=2e-4, atol=1e-5)
        hit = tri >= 0
        # padded leaf-order index -> soup index, the brute oracle's id
        assert (op[tri[hit]] == np.asarray(ref.soup_id)[hit]).mean() >= 0.999


@pytest.mark.parametrize('any_hit', [False, True])
def test_plain_vs_stream_kernel(any_hit):
    rng = np.random.default_rng(5)
    v0, e1, e2 = random_scene(rng, 800)
    jnf, jni, jtris, _, _ = jax_pack(v0, e1, e2)
    _, _, woop, _, _, _ = port_pack(v0, e1, e2)
    pos, d = random_rays(rng, 1024)
    tmin = np.zeros(1024, np.float32)
    tmax = np.full(1024, 3.0 if any_hit else 1e30, np.float32)
    jt, jtri, ju, jv = (np.asarray(x) for x in JTS.intersect_stream(
        jnp.asarray(jnf), jnp.asarray(jni), jnp.asarray(jtris),
        jnp.asarray(pos), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), any_hit=any_hit, interpret=True))
    t, tri, u, v = plain(woop, pos, d, tmin, tmax, any_hit)
    if any_hit:
        np.testing.assert_array_equal(tri >= 0, jtri >= 0)
        np.testing.assert_array_equal(t, jt)
    else:
        assert_same_hits(t, tri, jt, jtri)
        same = (tri >= 0) & (tri == jtri)
        np.testing.assert_allclose(u[same], ju[same], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(v[same], jv[same], rtol=1e-3, atol=1e-4)


def test_plain_vs_march_kernel_with_outliers():
    """tests/test_dda_traverse.py's outlier scene: a dense cloud plus a far
    overhead quad that the grid sends to its outlier list."""
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
    _, _, woop, _, grid, _ = port_pack(v0, e1, e2)
    _, _, jtris, _, jgrid = jax_pack(v0, e1, e2)
    assert grid.n_outliers > 0
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
    t, tri, _, _, un = (x.numpy() for x in TTD.intersect_march(
        grid, torch.from_numpy(woop), torch.from_numpy(pos),
        torch.from_numpy(d), torch.from_numpy(tmin), torch.from_numpy(tmax),
        with_unresolved=True))
    assert int(un.sum()) == 0
    assert_same_hits(t, tri, jt, jtri)
    assert (tri >= 0).any()


def test_plain_on_city_soup():
    """Structured wall/ground geometry with grazing rays (the small city's
    soup): plain vs the JAX stream kernel and brute oracle."""
    from hydracore3_torch.scene import synth
    from test_torch_scene import CITY_KW
    scene, _ = synth.city_scene(**CITY_KW)
    woop = scene.st_woop
    rng = np.random.default_rng(0)
    n = 1024
    pos = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(0.5, 25, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    t, tri, _, _ = plain(woop, pos, d, tmin, tmax)
    C = woop.shape[0] // 64
    jtris = np.zeros((C, 8, 256), np.float32)
    jtris[:, 0:4, 0:192] = (woop.numpy().reshape(C, 64, 3, 4)
                            .transpose(0, 3, 2, 1).reshape(C, 4, 192))
    jt, jtri, _, _ = (np.asarray(x) for x in JTS.intersect_stream(
        jnp.asarray(scene.st_nodes_f.numpy()),
        jnp.asarray(scene.st_nodes_i.numpy()), jnp.asarray(jtris),
        jnp.asarray(pos), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), interpret=True))
    assert_same_hits(t, tri, jt, jtri)
    ref = JTRV.intersect_brute(
        *(jnp.asarray(getattr(scene, k).numpy()) for k in
          ('tri_v0', 'tri_e1', 'tri_e2')),
        *(jnp.asarray(getattr(scene, k).numpy().astype(np.int32)) for k in
          ('tri_inst_id', 'tri_geom_id', 'tri_prim_id')),
        jnp.asarray(pos), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax))
    rt, rsoup = np.asarray(ref.t), np.asarray(ref.soup_id)
    rt = np.where(rsoup >= 0, rt, 0.99 * 3.4e38)
    assert_same_hits(t, tri, rt.astype(np.float32), rsoup)
    assert (tri >= 0).mean() > 0.3


def test_wrappers_on_cpu_use_plain_and_count_nothing():
    rng = np.random.default_rng(3)
    nf, ni, woop, _, grid, _ = port_pack(*random_scene(rng, 400))
    pos, d = random_rays(rng, 256)
    args = [torch.from_numpy(a) for a in (pos, d, np.zeros(256, np.float32),
                                          np.full(256, 1e30, np.float32))]
    n_s, n_m = TTS.intersect_stream.launches, TTD.intersect_march.launches
    s = TTS.intersect_stream(torch.from_numpy(nf), torch.from_numpy(ni),
                             torch.from_numpy(woop), *args)
    m = TTD.intersect_march(grid, torch.from_numpy(woop), *args)
    p = TTS.intersect_plain(torch.from_numpy(woop), args[0], args[1],
                            args[2], torch.clamp(args[3], max=0.99 * 3.4e38))
    for a, b in zip(s, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(m, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert TTS.intersect_stream.launches == n_s
    assert TTD.intersect_march.launches == n_m


def test_nearest_hit_retraces_only_unresolved_lanes(monkeypatch):
    """The integrator's nearest-hit query sends the lanes the march reports
    unresolved, and only those, through the BVH walk, and writes the walk's
    answer back into those lanes."""
    rng = np.random.default_rng(8)
    nf, ni, woop, _, grid, _ = port_pack(*random_scene(rng, 400))
    n = 256
    pos, d = (torch.from_numpy(a) for a in random_rays(rng, n))
    tmin = torch.zeros(n)
    tmax = torch.full((n,), 1e30)
    scene = types.SimpleNamespace(st_grid=grid, st_woop=torch.from_numpy(woop),
                                  st_nodes_f=torch.from_numpy(nf),
                                  st_nodes_i=torch.from_numpy(ni))
    un = torch.zeros(n, dtype=torch.int32)
    un[::3] = 1
    bad = un > 0

    def march_leaving_lanes(*args, with_unresolved):
        t, tri, u, v = TTS.intersect_plain(scene.st_woop, pos, d, tmin,
                                           tmax.clamp(max=0.99 * 3.4e38))
        return (torch.where(bad, -1.0, t), torch.where(bad, -7, tri),
                torch.where(bad, -1.0, u), torch.where(bad, -1.0, v), un)

    walked = []
    stream = TTS.intersect_stream

    def recording_stream(*args, **kw):
        walked.append(args[3].shape[0])
        return stream(*args, **kw)

    monkeypatch.setattr(TTD, 'intersect_march', march_leaving_lanes)
    monkeypatch.setattr(TTS, 'intersect_stream', recording_stream)
    got = TIPT.nearest_hit(scene, pos, d, tmin, tmax)
    want = TTS.intersect_plain(scene.st_woop, pos, d, tmin,
                               tmax.clamp(max=0.99 * 3.4e38))
    assert walked == [int(bad.sum())]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (want[1][bad] >= 0).any()


def test_shadow_sort_is_inverted():
    """The shadow query traces its rays in coherence order; the occlusion
    mask must come back in lane order (a wrong inverse still shades)."""
    rng = np.random.default_rng(12)
    nf, ni, woop, _, grid, _ = port_pack(*random_scene(rng, 600))
    n = 512
    pos, d = (torch.from_numpy(a) for a in random_rays(rng, n))
    t_max = torch.from_numpy(rng.uniform(0.0, 6.0, n).astype(np.float32))
    need = t_max > 1.0
    rays = TIPT.ShadowRays(pos, d, torch.where(need, t_max, 0.0), need)
    scene = types.SimpleNamespace(st_grid=grid, st_woop=torch.from_numpy(woop),
                                  st_nodes_f=torch.from_numpy(nf),
                                  st_nodes_i=torch.from_numpy(ni))
    perm, *query = TIPT.sorted_shadow_query(grid, rays)
    assert not torch.equal(perm, torch.arange(n))
    occ = TIPT.shadow_occluded(scene, rays)
    _, tri, _, _ = TTS.intersect_plain(scene.st_woop, pos, d,
                                       torch.zeros(n), rays.t_max, True)
    torch.testing.assert_close(occ, tri >= 0, rtol=0, atol=0)
    assert occ.any() and not occ.all()
