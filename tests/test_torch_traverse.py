"""The plain intersector of the port against the JAX traversal functions.

``intersect_plain`` (the plain torch version of the Woop-row CUDA kernels)
is held against JAX's ``intersect_brute``, ``intersect_stream`` and
``intersect_march`` (Pallas interpret mode, at the sizes of
tests/test_dda_traverse.py), nearest and any-hit, on random soups as that
file builds them and on the small city's soup.  Hit masks must be equal,
t within rtol 2e-4 / atol 1e-5, tri equal on >= 99.9% of hits (the rest
are equal-t ties at shared edges).  The packers must give the JAX tables.
``intersect_dda`` (the round loop over the cell pass, on CPU tensors the
plain version of each round) is held against JAX's ``intersect_dda`` and
against ``intersect_plain`` at the same bars, and against ``intersect_plain``
on every lane where equal-t ties decide the triangle: rays through the
shared edges of a sheet, and a tie met in two cells, where the JAX round
loop keeps the triangle it met first (a recorded tie: hit at the same t).
"""
import dataclasses
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
from torch_scenes import cross_cell_tie_scene, face_tie_scene, tilted_sheet
from torch_scenes import port_pack as card_pack


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
    scene, _ = synth.city_scene(**CITY_KW, device='cpu')
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
    # on the CPU the plain version reads the contract tables alone
    scene = types.SimpleNamespace(st_grid=grid, st_woop=torch.from_numpy(woop),
                                  st_nodes_f=torch.from_numpy(nf),
                                  st_nodes_i=torch.from_numpy(ni),
                                  st_wide=None)
    un = torch.zeros(n, dtype=torch.int32)
    un[::3] = 1
    bad = un > 0

    def march_leaving_lanes(*args, with_unresolved, wide):
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
    # on the CPU the plain version reads the contract tables alone
    scene = types.SimpleNamespace(st_grid=grid, st_woop=torch.from_numpy(woop),
                                  st_nodes_f=torch.from_numpy(nf),
                                  st_nodes_i=torch.from_numpy(ni),
                                  st_wide=None)
    perm, *query = TIPT.sorted_shadow_query(grid, rays)
    assert not torch.equal(perm, torch.arange(n))
    occ = TIPT.shadow_occluded(scene, rays)
    _, tri, _, _ = TTS.intersect_plain(scene.st_woop, pos, d,
                                       torch.zeros(n), rays.t_max, True)
    torch.testing.assert_close(occ, tri >= 0, rtol=0, atol=0)
    assert occ.any() and not occ.all()


# ---- the cell-pass wavefront (intersect_dda) --------------------------------

def dda_scene(name):
    """tests/test_dda_traverse.py's scenes: (soup, rays, t_max, any_hit)."""
    if name == 'staggered':
        # triangles in a thin slab at x in [3, 4]; half the rays march
        # across the grid toward it, half leave the grid at once
        rng = np.random.default_rng(77)
        v0, e1, e2 = random_scene(rng, 500, spread=0.4)
        v0[:, 0] += 3.5
        n = 1024
        pos = rng.uniform(-4, -3, (n, 3)).astype(np.float32)
        pos[:, 1] = rng.uniform(-1, 1, n)
        pos[:, 2] = rng.uniform(-1, 1, n)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d[::2, 0] = np.abs(d[::2, 0]) + 2.0
        d[1::2, 0] = -np.abs(d[1::2, 0]) - 2.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (v0, e1, e2), (pos, d), 1e30, False
    seed, n_tris, n_rays, t_max, any_hit = {
        'small': (23 + 300, 300, 1024, 1e30, False),
        'large': (23 + 2000, 2000, 1500, 1e30, False),
        'any_hit': (5, 800, 1024, 3.0, True)}[name]
    rng = np.random.default_rng(seed)
    soup = random_scene(rng, n_tris)
    return soup, random_rays(rng, n_rays), t_max, any_hit


@pytest.mark.parametrize('name', ['small', 'large', 'any_hit', 'staggered'])
def test_dda_vs_jax_dda_and_plain(name):
    (v0, e1, e2), (pos, d), t_max, any_hit = dda_scene(name)
    n = len(pos)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, t_max, np.float32)
    bvh = TB.build(v0, e1, e2, max_leaf=TTS.TBK)
    o = bvh.order
    nf, ni, woop, _ = TTS.pack_stream_bvh(bvh, v0[o], e1[o], e2[o])
    grid = TTD.pack_grid(nf, ni, robust_aabb=False)
    jnf, jni, jtris, _, _ = jax_pack(v0, e1, e2)
    jgrid = JTD.pack_grid(jnf, jni, robust_aabb=False)
    assert grid.n_outliers == jgrid.n_outliers == 0
    assert grid.dims == jgrid.dims
    for k in ('cell_tab', 'cell_cl', 'cl_aabb'):
        np.testing.assert_array_equal(getattr(grid, k),
                                      np.asarray(getattr(jgrid, k)), err_msg=k)

    jt, jtri, _, _ = (np.asarray(x) for x in JTD.intersect_dda(
        jgrid, jnp.asarray(jtris), jnp.asarray(pos), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), any_hit=any_hit,
        interpret=True))
    stats = {}
    before = TTD.cell_pass.launches
    t, tri, u, v = (x.numpy() for x in TTD.intersect_dda(
        grid.to('cpu'), torch.from_numpy(woop), torch.from_numpy(pos),
        torch.from_numpy(d), torch.from_numpy(tmin), torch.from_numpy(tmax),
        any_hit=any_hit, stats=stats))
    assert TTD.cell_pass.launches == before       # CPU tensors: no launch
    assert stats['live'] == 0 and 1 <= stats['rounds'] <= 48
    pt, ptri, pu, pv = plain(woop, pos, d, tmin, tmax, any_hit)
    if any_hit:
        np.testing.assert_array_equal(tri >= 0, jtri >= 0)
        np.testing.assert_array_equal(tri >= 0, ptri >= 0)
        np.testing.assert_array_equal(t, pt)
        assert (tri >= 0).any() and not (tri >= 0).all()
    else:
        assert_same_hits(t, tri, jt, jtri)
        assert_same_hits(t, tri, pt, ptri)
        same = (tri >= 0) & (tri == ptri)
        np.testing.assert_array_equal(u[same], pu[same])
        np.testing.assert_array_equal(v[same], pv[same])
        assert (tri >= 0).sum() > 20


def test_dda_refuses_a_grid_with_outliers_and_stops_at_max_rounds():
    (v0, e1, e2), (pos, d), _, _ = dda_scene('large')
    n = len(pos)
    args = [torch.from_numpy(a) for a in (pos, d, np.zeros(n, np.float32),
                                          np.full(n, 1e30, np.float32))]
    bvh = TB.build(v0, e1, e2, max_leaf=TTS.TBK)
    o = bvh.order
    nf, ni, woop, _ = TTS.pack_stream_bvh(bvh, v0[o], e1[o], e2[o])
    grid = TTD.pack_grid(nf, ni, robust_aabb=False).to('cpu')
    with pytest.raises(ValueError, match='outlier'):
        TTD.intersect_dda(dataclasses.replace(grid, n_outliers=1),
                          torch.from_numpy(woop), *args)
    # two rounds cannot cross the grid: the lanes left live are counted
    stats = {}
    TTD.intersect_dda(grid, torch.from_numpy(woop), *args, max_rounds=2,
                      stats=stats)
    assert stats['rounds'] == 2 and stats['live'] > 0


@pytest.mark.parametrize('max_rounds', [0, -1])
def test_dda_refuses_fewer_than_one_round(max_rounds):
    """``intersect_dda`` runs at least one round: a cap below one is refused
    on every device (on the card no round would write the lane state)."""
    (v0, e1, e2), (pos, d), _, _ = dda_scene('small')
    n = len(pos)
    args = [torch.from_numpy(a) for a in (pos, d, np.zeros(n, np.float32),
                                          np.full(n, 1e30, np.float32))]
    bvh = TB.build(v0, e1, e2, max_leaf=TTS.TBK)
    o = bvh.order
    nf, ni, woop, _ = TTS.pack_stream_bvh(bvh, v0[o], e1[o], e2[o])
    grid = TTD.pack_grid(nf, ni, robust_aabb=False).to('cpu')
    with pytest.raises(ValueError, match='max_rounds'):
        TTD.intersect_dda(grid, torch.from_numpy(woop), *args,
                          max_rounds=max_rounds)
    TTD.intersect_dda(grid, torch.from_numpy(woop), *args, max_rounds=1)


def test_dda_keeps_hits_at_the_grid_boundary():
    """Shadow rays leaving the ground downward hit it a hair in front of
    their origin, at the grid's lower face: a round loop that re-locates the
    cell from a point stepped past its current t is already outside the
    grid there and drops the hit."""
    from hydracore3_torch.scene import synth
    from test_torch_scene import CITY_KW
    scene, _ = synth.city_scene(**CITY_KW, device='cpu')
    grid = TTD.pack_grid(scene.st_nodes_f.numpy(), scene.st_nodes_i.numpy(),
                         robust_aabb=False).to('cpu')
    rng = np.random.default_rng(21)
    n = 512
    pos = np.stack([rng.uniform(-20, 20, n), np.full(n, 1.1e-4),
                    rng.uniform(-20, 20, n)], 1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = [torch.from_numpy(a) for a in (pos, d, np.zeros(n, np.float32),
                                          np.full(n, 999.5, np.float32))]
    for any_hit in (True, False):
        t, tri, _, _ = TTD.intersect_dda(grid, scene.st_woop, *args,
                                         any_hit=any_hit)
        pt, ptri, _, _ = TTS.intersect_plain(scene.st_woop, *args, any_hit)
        torch.testing.assert_close(tri >= 0, ptri >= 0, rtol=0, atol=0)
        torch.testing.assert_close(t, pt, rtol=2e-4, atol=1e-5)
        assert (tri >= 0).float().mean() > 0.9


def test_march_stop_rule_at_a_face_tie_is_the_reference_rule():
    """An equal-t tie on a cell face, the lower slot listed only in the
    next cell (``torch_scenes.face_tie_scene``): the JAX march
    stops once its best t lies at the cell's exit and keeps the higher slot
    on the rays that meet it first, and the port's march rule (the plain
    rounds of ``intersect_dda``, which K3 and K6 are held to on the card)
    returns the same, t, u, v and triangle, on every lane.  The dense plain
    version, which the port's ``intersect_march`` is on the CPU, returns the
    lower slot there: a deviation from the contract's lowest-index rule
    that the port shares with the reference."""
    nf, ni, woop, soup, grid, (pos, d), bvh = face_tie_scene()
    n = pos.shape[0]
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    v0, e1, e2 = (a[[0, 1, 64, 65]] for a in soup)     # the real slots
    _, _, jtris, _ = JTS.pack_stream_bvh(bvh, v0, e1, e2)
    jgrid = JTD.GridPack(
        cell_tab=jnp.asarray(grid.cell_tab),
        cell_cl=jnp.asarray(grid.cell_cl), cl_aabb=jnp.asarray(grid.cl_aabb),
        outliers=jnp.asarray(grid.outliers), n_outliers=0, lo=grid.lo,
        h=grid.h, dims=grid.dims)
    # one call per direction: the JAX kernel tests the clusters of every
    # cell its tile's lanes stand in against all of the tile's lanes
    jt, jtri, ju, jv = (np.concatenate(x) for x in zip(*(
        [np.asarray(y) for y in JTD.intersect_march(
            jgrid, jnp.asarray(jtris), jnp.asarray(pos[h]),
            jnp.asarray(d[h]), jnp.asarray(tmin[h]), jnp.asarray(tmax[h]),
            interpret=True)]
        for h in (slice(0, n // 2), slice(n // 2, n)))))
    assert (jtri[:n // 2] >= 64).all() and (jtri[n // 2:] < 2).all()
    q = tuple(torch.from_numpy(a) for a in (pos, d, tmin, tmax))
    t, tri, u, v = (x.numpy() for x in TTD.intersect_dda(
        grid.to('cpu'), torch.from_numpy(woop), *q))
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(v, jv)
    dense = TTD.intersect_march(grid, torch.from_numpy(woop), *q)
    assert (dense[1] < 2).all()
    np.testing.assert_array_equal(dense[0].numpy(), jt)


def test_dda_settles_a_tie_met_in_two_cells_as_dense_plain():
    """``torch_scenes.cross_cell_tie_scene``: A (slot 0) and B
    (slot 64) share an edge and are hit at the same t; a +x ray meets B in
    an earlier cell, with the hit beyond that cell's exit, and A only in the
    next.  The plain rounds of ``intersect_dda`` return the dense
    ``intersect_plain`` answer, A, on every lane, t, u, v and triangle: the
    lower slot wins an equal t across rounds.  (Before the rounds compared
    slots at an equal t, a round kept the t found in an earlier cell and
    this test failed on every +x lane, returning B.)  The JAX round loop
    keeps the triangle it met first; its t is the same and its triangle is
    hit at that t by the plain Woop test, so the JAX answer is a tie
    settled the other way, not a wrong hit."""
    nf, ni, woop, soup, grid, (pos, d), bvh = cross_cell_tie_scene()
    n = pos.shape[0]
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    q = tuple(torch.from_numpy(a) for a in (pos, d, tmin, tmax))
    w_t = torch.from_numpy(woop)
    want = TTS.intersect_plain(w_t, *q[:3],
                               torch.clamp(q[3], max=TTS.T_MAX_CAP))
    assert (want[1] == 0).all()
    assert (want[0][:n // 2] == 2.0).all() and (want[0][n // 2:] == 1.0).all()
    got = TTD.intersect_dda(grid.to('cpu'), w_t, *q)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    v0, e1, e2 = (a[[0, 64, 65]] for a in soup)         # the real slots
    _, _, jtris, _ = JTS.pack_stream_bvh(bvh, v0, e1, e2)
    jgrid = JTD.GridPack(
        cell_tab=jnp.asarray(grid.cell_tab),
        cell_cl=jnp.asarray(grid.cell_cl), cl_aabb=jnp.asarray(grid.cl_aabb),
        outliers=jnp.asarray(grid.outliers), n_outliers=0, lo=grid.lo,
        h=grid.h, dims=grid.dims)
    # one call per direction: the JAX kernel tests the clusters of every
    # cell its tile's lanes stand in against all of the tile's lanes
    jt, jtri = (np.concatenate(x) for x in zip(*(
        [np.asarray(y) for y in JTD.intersect_dda(
            jgrid, jnp.asarray(jtris), jnp.asarray(pos[h]),
            jnp.asarray(d[h]), jnp.asarray(tmin[h]), jnp.asarray(tmax[h]),
            interpret=True)[:2]]
        for h in (slice(0, n // 2), slice(n // 2, n)))))
    np.testing.assert_array_equal(jt, want[0].numpy())
    assert (jtri[:n // 2] == 64).all() and (jtri[n // 2:] == 0).all()
    for tri in (0, 64):
        lanes = np.nonzero(jtri == tri)[0]
        own = TTS.intersect_plain(w_t[tri:tri + 1], *(x[lanes] for x in q[:3]),
                                  torch.clamp(q[3][lanes],
                                              max=TTS.T_MAX_CAP))
        assert (own[1] == 0).all()
        np.testing.assert_array_equal(own[0].numpy(), jt[lanes])


def test_dda_settles_edge_ties_as_dense_plain():
    """The CPU twin of ``test_woop_kernels_settle_edge_ties_as_plain``:
    coplanar triangles sharing edges (``tilted_sheet``), rays through the
    edges; the plain rounds of ``intersect_dda`` return the dense plain
    version's t, u, v and triangle on every lane."""
    rng = np.random.default_rng(21)
    soup, edges, normal = tilted_sheet(rng)
    nf, ni, woop, _, _, _, _ = card_pack(*soup)
    n = 4096
    k = rng.integers(0, len(edges), n)
    s_ = rng.uniform(0.05, 0.95, n)[:, None]
    p = (1.0 - s_) * edges[k, 0] + s_ * edges[k, 1]
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0)[:, None]
    org = p + side * (2.0 * normal + rng.uniform(-0.6, 0.6, (n, 3)))
    d = p - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    q = (torch.from_numpy(org.astype(np.float32)),
         torch.from_numpy(d.astype(np.float32)), torch.zeros(n),
         torch.full((n,), float(np.finfo(np.float32).max)))
    w_t = torch.from_numpy(woop)
    want = TTS.intersect_plain(w_t, *q[:3],
                               torch.clamp(q[3], max=TTS.T_MAX_CAP))
    assert (want[1] >= 0).float().mean() > 0.5
    grid = TTD.pack_grid(nf, ni, robust_aabb=False).to('cpu')
    got = TTD.intersect_dda(grid, w_t, *q)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
