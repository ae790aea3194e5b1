"""The port's two-level (TLAS) path against the JAX package's.

On tests/test_tlas_stream.py's scenes (two random meshes, nine rotated and
scaled instances): ``pack_stream_tlas`` field by field, the Woop rows
against ``tris_hbm`` re-laid out, and ``intersect_tlas_plain`` (the plain
torch version of the CUDA kernel) against ``intersect_stream_tlas`` in
Pallas interpret mode, nearest and any-hit, at that file's bars: hit flags
and instance ids equal, t within rtol 2e-4 / atol 1e-4, u and v within rtol
5e-3 / atol 5e-4.  On the small instanced city: every two-level table of
the build against the JAX build's, and one ``trace_pass`` lane by lane
(accum within rtol/atol 1e-3 on >= 99.5% of lanes, flags and RNG state
equal on >= 99%), and ``walk_wide_plain`` over the build's card-side wide
tables against the JAX kernel on the city's camera rays, at the kernel
bars above.  ``_remap_material_id`` and the octant/Morton sort are
held against their JAX functions on inputs from a numpy seed.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu.accel import traverse_tlas as JTT
from hydracore3_tpu.models import integrator_pt as JIPT
from hydracore3_tpu.ops import rng as JRNG
from hydracore3_tpu.scene import synth as jsynth
from hydracore3_torch.accel import traverse_tlas as TTT
from hydracore3_torch.accel import wide_bvh as TWB
from hydracore3_torch.models import integrator_pt as TIPT
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.scene import synth as tsynth
from test_tlas_stream import _build, _mesh_box, _place, _rays
from test_torch_scene import assert_tables_equal, scene_arrays_from_jax

ICITY_KW = dict(n_blocks=3, subdiv=1, seed=5, width=48, height=32, depth=3,
                ground_subdiv=6)


def woop_from_tris_hbm(tris_hbm):
    """[C, 8, WPAD] blocks (row = coefficient, lane = comp * 64 + k) ->
    the port's [C * 64, 12] rows."""
    C = tris_hbm.shape[0]
    return (tris_hbm[:, 0:4, 0:192].reshape(C, 4, 3, 64)
            .transpose(0, 3, 2, 1).reshape(C * 64, 12))


@pytest.fixture(scope='module', params=[0, 3], ids=['seed0', 'seed3'])
def packs(request):
    meshes, instances, jpk, _ = _build(seed=request.param)
    return jpk, TTT.pack_stream_tlas(meshes, instances)


@pytest.mark.parametrize('field', [
    'tlas_f', 'tlas_i', 'nodes_f', 'nodes_i', 'inst_f', 'inst_i', 'inst_nm',
    'order_padded', 'tri_mesh', 'node_base', 'cluster_base', 'woop',
    'mesh_clusters'])
def test_pack_matches_jax(packs, field):
    jpk, tpk = packs
    if field == 'woop':
        np.testing.assert_array_equal(tpk['woop'],
                                      woop_from_tris_hbm(jpk['tris_hbm']))
    elif field == 'mesh_clusters':
        # the port's own table: each mesh's cluster range
        C = jpk['tris_hbm'].shape[0]
        want = np.diff(np.append(jpk['cluster_base'], C))
        np.testing.assert_array_equal(tpk[field][:, 0], jpk['cluster_base'])
        np.testing.assert_array_equal(tpk[field][:, 1], want)
    else:
        assert tpk[field].dtype == jpk[field].dtype
        np.testing.assert_array_equal(tpk[field], jpk[field])


def _query(seed_scene, seed_rays, t_max, any_hit):
    meshes, instances, jpk, _ = _build(seed=seed_scene)
    pack = TTT.tlas_pack(TTT.pack_stream_tlas(meshes, instances)).to('cpu')
    n = 1024
    pos, d = _rays(n, seed=seed_rays)
    tmin = jnp.zeros((n,))
    tmax = jnp.full((n,), t_max)
    jout = JTT.intersect_stream_tlas(
        *(jnp.asarray(jpk[k]) for k in ('tlas_f', 'tlas_i', 'nodes_f',
                                        'nodes_i', 'inst_f', 'inst_i',
                                        'tris_hbm')),
        pos, d, tmin, tmax, any_hit=any_hit, interpret=True)
    tout = TTT.intersect_stream_tlas(
        pack, torch.from_numpy(np.array(pos)),
        torch.from_numpy(np.array(d)), torch.zeros(n),
        torch.full((n,), t_max), any_hit=any_hit)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def test_plain_vs_jax_kernel_nearest():
    (jt, jtri, ju, jv, jinst), (t, tri, u, v, inst) = _query(0, 1, 1e30,
                                                            False)
    hit = tri >= 0
    np.testing.assert_array_equal(hit, jtri >= 0)
    assert hit.sum() > 20
    np.testing.assert_allclose(t[hit], jt[hit], rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(inst[hit], jinst[hit])
    assert (inst[~hit] == -1).all()
    assert (tri[hit] == jtri[hit]).mean() > 0.99
    np.testing.assert_allclose(u[hit], ju[hit], rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(v[hit], jv[hit], rtol=5e-3, atol=5e-4)
    # a miss keeps the clamped t_max
    np.testing.assert_allclose(t[~hit], 1e30, rtol=1e-6)


def test_plain_vs_jax_kernel_any_hit():
    (jt, jtri, _, _, _), (t, tri, _, _, inst) = _query(3, 5, 6.0, True)
    occ = tri >= 0
    np.testing.assert_array_equal(occ, jtri >= 0)
    assert occ.any() and not occ.all()
    np.testing.assert_array_equal(t, jt)        # t_min where occluded
    assert (tri[occ] == 0).all() and (inst == -1).all()


def test_wrapper_on_cpu_uses_plain_and_counts_nothing():
    meshes, instances, _, _ = _build(seed=0)
    pack = TTT.tlas_pack(TTT.pack_stream_tlas(meshes, instances)).to('cpu')
    pos, d = (torch.from_numpy(np.array(a)) for a in _rays(256, seed=2))
    before = TTT.intersect_stream_tlas.launches
    got = TTT.intersect_stream_tlas(pack, pos, d, torch.zeros(256),
                                    torch.full((256,), 3.4e38))
    want = TTT.intersect_tlas_plain(pack, pos, d, torch.zeros(256),
                                    torch.full((256,), 0.99 * 3.4e38))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert TTT.intersect_stream_tlas.launches == before


def test_plain_ties_go_to_the_first_instance_the_tlas_visits():
    """Two instances of one quad at the same place: equal t on every ray;
    the winner is the instance whose TLAS leaf comes first."""
    quad = (np.array([[-1, 0, -1], [-1, 0, -1]], np.float32),
            np.array([[2, 0, 0], [2, 0, 2]], np.float32),
            np.array([[2, 0, 2], [0, 0, 2]], np.float32))
    inst = [dict(geom_id=0, m0=np.eye(4, dtype=np.float32)) for _ in range(2)]
    pk = TTT.pack_stream_tlas([quad], inst)
    leaves = pk['tlas_i'][:, 1]
    first = int(leaves[leaves >= 0][0])
    n = 64
    rng = np.random.default_rng(2)
    pos = np.stack([rng.uniform(-0.9, 0.9, n), np.full(n, 2.0),
                    rng.uniform(-0.9, 0.9, n)], 1).astype(np.float32)
    d = np.tile(np.array([[0, -1, 0]], np.float32), (n, 1))
    out = TTT.intersect_tlas_plain(
        TTT.tlas_pack(pk).to('cpu'), torch.from_numpy(pos),
        torch.from_numpy(d), torch.zeros(n), torch.full((n,), 1e30))
    assert (out[1] >= 0).all()
    assert (out[4] == first).all()


def test_storage_is_o_mesh():
    """1000 instances of one mesh must not replicate triangle storage."""
    mesh = _mesh_box(120, 11)
    instances = [dict(geom_id=0, m0=_place(float(i % 32), 0.0,
                                           float(i // 32), rot=0.1 * i))
                 for i in range(1000)]
    pk = TTT.pack_stream_tlas([mesh], instances)
    assert pk['woop'].shape[0] // TTT.TBK <= -(-120 // TTT.TBK) + 2
    assert pk['inst_f'].shape[0] == 1000
    assert pk['tlas_i'].shape[0] <= 2 * 1000


# ---- the instanced city ---------------------------------------------------

@pytest.fixture(scope='module')
def icity(tmp_path_factory):
    jscene, jmeta = jsynth.instanced_city_scene(
        **ICITY_KW, accel='stream_tlas',
        cache_dir=str(tmp_path_factory.mktemp('icity')))
    return jscene, jmeta, *tsynth.instanced_city_scene(**ICITY_KW,
                                                       device='cpu')


def test_icity_meta(icity):
    _, jmeta, tscene, tmeta = icity
    assert jmeta.use_stream_tlas and tmeta.use_stream_tlas
    assert not tmeta.use_stream and not tmeta.use_pallas
    for f in ('width', 'height', 'trace_depth', 'num_lights', 'num_materials',
              'has_env_map', 'env_enable_sam', 'num_tris'):
        assert getattr(jmeta, f) == getattr(tmeta, f), f
    # no world soup is kept
    assert tscene.tri_v0.shape[0] == 1 and tscene.st_woop is None


@pytest.mark.parametrize('table', [
    'tlas_f', 'tlas_i', 'nodes_f', 'nodes_i', 'inst_f', 'inst_i', 'inst_nm',
    'woop', 'shade', 'geom', 'prim'])
def test_icity_two_level_tables_equal(icity, table):
    jscene, _, tscene, _ = icity
    t = tscene.to_numpy()['tt_' + table]
    if table == 'woop':
        j = woop_from_tris_hbm(np.asarray(jscene.tt_tris))
    else:
        j = np.asarray(getattr(jscene, 'tt_' + table))
    assert j.shape == t.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize('group', ['mat', 'light', 'env', 'cam', 'misc'])
def test_icity_other_tables_equal(icity, group):
    jscene, jmeta, tscene, _ = icity
    assert_tables_equal(scene_arrays_from_jax(jscene, jmeta),
                        tscene.to_numpy(), group)


def test_icity_trace_pass_matches_jax(icity):
    """The whole two-level path: the JAX pass runs its Pallas kernel in
    interpret mode, the port its plain version."""
    jscene, jmeta, tscene, tmeta = icity
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
    assert (t_fl.astype(np.uint32) == j_fl).mean() >= 0.99
    assert (t_rng.astype(np.uint32) == j_rng).all(axis=1).mean() >= 0.99
    assert (t_acc[:, :3].sum(1) > 0).mean() > 0.5


@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'anyhit'])
def test_icity_wide_walk_matches_jax_kernel(icity, any_hit):
    """The walk over the build's wide tables returns the contract's padded
    slots and instance ids: the JAX kernel's on the camera rays."""
    jscene, _, tscene, tmeta = icity
    n = tmeta.width * tmeta.height
    pix = torch.arange(n)
    st = TIPT.kernel_init_eye_ray(tscene, tmeta, TRNG.gen_init(pix), pix)
    t_max = 40.0 if any_hit else 1e30
    jt, jtri, ju, jv, jinst = (np.asarray(x) for x in
                               JTT.intersect_stream_tlas(
        jscene.tt_tlas_f, jscene.tt_tlas_i, jscene.tt_nodes_f,
        jscene.tt_nodes_i, jscene.tt_inst_f, jscene.tt_inst_i, jscene.tt_tris,
        jnp.asarray(st.ray_pos.numpy()), jnp.asarray(st.ray_dir.numpy()),
        jnp.zeros((n,)), jnp.full((n,), t_max), any_hit=any_hit,
        interpret=True))
    t, tri, u, v, inst = (x.numpy() for x in TWB.walk_wide_plain(
        tscene.tt.wide, st.ray_pos, st.ray_dir, torch.zeros(n),
        torch.full((n,), t_max), any_hit))
    hit = tri >= 0
    np.testing.assert_array_equal(hit, jtri >= 0)
    assert hit.sum() > 20 and not hit.all()
    if any_hit:
        np.testing.assert_array_equal(t, jt)
        assert (tri[hit] == 0).all() and (inst == -1).all()
        return
    np.testing.assert_allclose(t[hit], jt[hit], rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(inst[hit], jinst[hit])
    assert (tri[hit] == jtri[hit]).mean() > 0.99
    np.testing.assert_allclose(u[hit], ju[hit], rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(v[hit], jv[hit], rtol=5e-3, atol=5e-4)


def test_icity_matches_flattened_city():
    """The same city flattened and streamed: the port's two routes agree."""
    tl, tl_meta = tsynth.instanced_city_scene(**ICITY_KW, device='cpu')
    flat, flat_meta = tsynth.instanced_city_scene(**ICITY_KW, accel='stream',
                                                  device='cpu')
    assert flat_meta.use_stream and flat_meta.num_tris > tl_meta.num_tris
    pix = torch.arange(tl_meta.width * tl_meta.height)
    a, fa, _ = TIPT.trace_pass(tl, tl_meta, TRNG.gen_init(pix), pix)
    b, fb, _ = TIPT.trace_pass(flat, flat_meta, TRNG.gen_init(pix), pix)
    close = np.isclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-3).all(1)
    assert close.mean() >= 0.995
    assert (fa == fb).float().mean() >= 0.99


def test_auto_routes_big_instanced_city_two_level():
    """209,410 soup triangles against 2,140 unique: two-level under
    'auto'; the 32-block city (94,210) stays a flattened soup."""
    sd = tsynth.build_instanced_city(n_blocks=48, width=16, height=16)
    _, meta = tsynth.B.build_scene(sd, device='cpu')
    assert meta.use_stream_tlas and meta.num_tris == 209_410
    assert not meta.use_stream and not meta.use_pallas


# ---- the pieces of the integrator -----------------------------------------

def test_remap_material_id_matches_jax():
    """Made-up remap tables: three lists of sorted (from, to) pairs, then
    their offsets; instances with and without a list.  The port's lookup
    equals each instance's own list on every lane, and the JAX lookup on
    every lane whose bisection stays inside the list (the JAX package
    bisects over twice the list's pairs, so an id above the list's last
    ``from`` reads the next list)."""
    rng = np.random.default_rng(4)
    lists = [[1, 7, 3, 9, 8, 2], [0, 5], [2, 4, 5, 6, 6, 0, 9, 1]]
    flat, offsets = [], []
    for rl in lists:
        offsets.append(len(flat))
        flat += rl
    offsets.append(len(flat))
    table = np.array(flat + offsets, np.int32)
    remap_inst = np.stack([rng.integers(-1, 3, 40), np.full(40, -1)],
                          axis=1).astype(np.int32)
    n = 2000
    mat_id = rng.integers(0, 11, n).astype(np.int32)
    inst_id = rng.integers(-1, 40, n).astype(np.int32)
    jscene = types.SimpleNamespace(
        remap_inst=jnp.asarray(remap_inst), all_remap_lists=jnp.asarray(table),
        all_remap_lists_size=len(flat))
    tscene = types.SimpleNamespace(
        remap_inst=torch.from_numpy(remap_inst).long(),
        all_remap_lists=torch.from_numpy(table).long(),
        all_remap_lists_size=len(flat))
    want = np.asarray(JIPT._remap_material_id(jscene, jnp.asarray(mat_id),
                                              jnp.asarray(inst_id)))
    got = TIPT._remap_material_id(tscene, torch.from_numpy(mat_id).long(),
                                  torch.from_numpy(inst_id).long()).numpy()
    rl = remap_inst[np.clip(inst_id, 0, 39), 0]
    ref = np.array([dict(zip(lists[r][0::2], lists[r][1::2])).get(m, m)
                    if r >= 0 else m for m, r in zip(mat_id, rl)])
    np.testing.assert_array_equal(got, ref)
    inside = (rl < 0) | (mat_id <= np.array([max(l[0::2]) for l in lists])[rl])
    np.testing.assert_array_equal(got[inside], want[inside])
    assert (~inside).sum() > 100 and (got != want).any()
    assert (got != mat_id).sum() > 100       # some ids were remapped


def test_octant_morton_sort_matches_jax(icity):
    """The sort without a grid: the same permutation as the JAX function
    on the same rays (live rays by octant and origin Morton code, dead
    rays last)."""
    jscene, jmeta, tscene, tmeta = icity
    N = 2048
    rng = np.random.default_rng(6)
    pos = rng.uniform(-40, 40, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dead = rng.random(N) < 0.2
    jp = jnp.arange(N, dtype=jnp.int32)
    jstate, _ = JIPT.kernel_init_eye_ray(jscene, jmeta, JRNG.gen_init(jp), jp)
    jstate = jstate._replace(
        ray_pos=jnp.asarray(pos), ray_dir=jnp.asarray(d),
        flags=jnp.where(jnp.asarray(dead),
                        jnp.uint32(JIPT.C.RAY_FLAG_IS_DEAD), jnp.uint32(0)))
    _, jorig = JIPT._sort_rays_for_trace(jstate, jp, grid=None)
    tp = torch.arange(N)
    tstate = TIPT.kernel_init_eye_ray(tscene, tmeta, TRNG.gen_init(tp), tp)
    tstate = tstate._replace(
        ray_pos=torch.from_numpy(pos), ray_dir=torch.from_numpy(d),
        flags=torch.where(torch.from_numpy(dead), TIPT.C.RAY_FLAG_IS_DEAD, 0))
    tsorted, torig = TIPT._sort_rays_for_trace(tstate, tp, None)
    np.testing.assert_array_equal(torig.numpy(), np.asarray(jorig))
    torch.testing.assert_close(tsorted.ray_pos, torch.from_numpy(pos)[torig])
    assert not torch.equal(torig, tp)
