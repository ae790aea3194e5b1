"""K1's wide BVH (``models/megakernel.wide_table``) against the brute trace
it replaces.

The megakernel walks a 4-wide BVH over leaves of at most 4 of the pack's
Woop rows instead of testing every triangle; the plain version keeps the
brute ``_trace_blocks`` as the contract.  On the box (64 x 48) and on the
box with its five walls cut into grids (``wall_subdiv`` 4 and 20, 32 x 24;
20 gives 4,006 triangles, padded to 4,096 rows), bars:
- the table: rows equal ``pk.woop[index]`` bit for bit, every real
  triangle appears once and no padding row appears, the stack recomputed
  from the packed nodes equals the pack's, every child box holds its
  triangles with the stated margin, and ``pack_from_numpy`` builds the same
  table from the JAX box's arrays and soup;
- ``walk_wide_plain`` over the table equals ``_trace_blocks`` bit for bit
  on (t, tri, u, v), and on the occlusion flag under any-hit, on every
  query of a pass's bounces 0-3 and on rays aimed at the corners, the
  midpoints and other points of every triangle edge (the box's wall edges
  and corners, the grids' shared edges);
- a tree deeper than the kernel's stack is refused;
- ``box_scene(wall_subdiv=1)`` is the box itself, table for table, and the
  tessellated box renders the box's samples.
"""
import dataclasses

import numpy as np
import pytest
import torch

from hydracore3_tpu.models import megakernel as JMK
from hydracore3_torch.accel import wide_bvh as TWB
from hydracore3_torch.models import megakernel as TMK
from hydracore3_torch.scene import synth
import jax_box

SCENES = {'box': (1, 64, 48), 'grid4': (4, 32, 24), 'grid20': (20, 32, 24)}
DEPTH = 4


@pytest.fixture(scope='module', params=list(SCENES))
def box(request):
    sub, w, h = SCENES[request.param]
    scene, meta = synth.box_scene(w, h, DEPTH, textured=True,
                                  wall_subdiv=sub, device='cpu')
    return request.param, scene, meta, TMK.pack(scene, meta)


def test_tessellated_box_goes_to_the_megakernel(box):
    name, scene, meta, pk = box
    sub = SCENES[name][0]
    assert meta.num_tris == 10 * sub * sub + 6
    if sub == 20:
        assert (meta.num_tris, pk.n_tris) == (4006, 4096)
    assert TMK.why_unsupported(scene, meta) is None
    assert not (meta.use_stream or meta.use_pallas or meta.use_stream_tlas)


def test_wide_rows_are_the_contract_rows(box):
    _, _, meta, pk = box
    w, T = pk.wide, meta.num_tris
    index = w.index.numpy()
    assert w.index.dtype == torch.int32 and w.woop
    np.testing.assert_array_equal(np.sort(index), np.arange(T))
    np.testing.assert_array_equal(
        w.rows.numpy().view(np.int32),
        pk.woop.numpy()[index].view(np.int32))


def _stack_need(nodes):
    """The stack a near-first walk of packed nodes needs, from the table
    alone: at a node every hit child but one may wait."""
    refs = TWB.node_refs(nodes)

    def need(k):
        kids = [int(r) for r in refs[k] if r != TWB.EMPTY]
        return len(kids) - 1 + max((need(r) for r in kids if r >= 0),
                                   default=0)
    return need(0)


def test_wide_stack_is_exact(box):
    _, _, _, pk = box
    nodes = pk.wide.nodes.numpy()
    assert pk.wide.stack == _stack_need(nodes)
    assert pk.wide.stack <= TMK.MEGA_STACK


def test_wide_boxes_hold_their_triangles_with_the_margin(box):
    _, scene, meta, pk = box
    v0 = scene.tri_v0.numpy()
    corners = np.stack([v0, v0 + scene.tri_e1.numpy(),
                        v0 + scene.tri_e2.numpy()], 1)
    margin = TWB.MARGIN_REL * max(1.0, float(np.abs(corners).max()))
    assert pk.wide.margin == margin
    nodes = pk.wide.nodes.numpy()
    refs = TWB.node_refs(nodes)
    bmin, bmax = TWB.node_boxes(nodes)
    index = pk.wide.index.numpy()
    seen = 0
    for m in range(len(nodes)):
        for c in range(TWB.WIDTH):
            r = int(refs[m, c])
            if r == TWB.EMPTY or r >= 0:
                continue
            off, cnt = (~r) >> 3, (~r) & 7
            pts = corners[index[off:off + cnt]].reshape(-1, 3)
            assert (pts - bmin[m, c] >= 0.99 * margin).all()
            assert (bmax[m, c] - pts >= 0.99 * margin).all()
            seen += cnt
    assert seen == meta.num_tris


def _pass_queries(pk, meta, monkeypatch):
    """Every trace call of one plain pass (bounces 0..DEPTH-1): (o [3, N],
    d [3, N], tmax [N], any_hit, the brute result)."""
    calls = []
    brute = TMK._trace_blocks

    def record(pk_, o, d, tmin, tmax, any_hit=False):
        out = brute(pk_, o, d, tmin, tmax, any_hit)
        calls.append((o, d, tmax, any_hit, out))
        return out

    monkeypatch.setattr(TMK, '_trace_blocks', record)
    xy, su = TMK.lane_setup(meta, 'cpu')
    TMK.sample_pass_plain(pk, xy, su, DEPTH)
    return calls


def _walk_equals_brute(pk, o, d, tmax, any_hit, brute=None):
    """The walk over the pack's table against ``_trace_blocks`` on the
    lanes whose interval is not empty; returns how many such lanes hit."""
    if brute is None:
        brute = TMK._trace_blocks(pk, o, d, torch.zeros_like(tmax), tmax,
                                  any_hit)
    live = tmax > 0
    n = int(live.sum())
    walk = TWB.walk_wide_plain(pk.wide, o.T[live].contiguous(),
                               d.T[live].contiguous(), torch.zeros(n),
                               tmax[live], any_hit)
    if any_hit:
        assert torch.equal(walk[1] >= 0, brute[live])
        return int(brute[live].sum())
    for a, b in zip(walk, brute):
        assert torch.equal(a, b[live])
    return int((walk[1] >= 0).sum())


def test_walk_equals_trace_blocks_on_the_pass(box, monkeypatch):
    _, _, meta, pk = box
    calls = _pass_queries(pk, meta, monkeypatch)
    assert len(calls) == 2 * DEPTH
    hits = [_walk_equals_brute(pk, o, d, tmax, any_hit, out)
            for o, d, tmax, any_hit, out in calls]
    assert hits[0] > 0 and hits[1] > 0


@pytest.mark.parametrize('any_hit', [False, True])
def test_walk_equals_trace_blocks_on_edge_rays(box, any_hit):
    """Rays from four points inside the box and from the camera, aimed at
    points of every triangle edge (its corners, its midpoint and two more),
    at most 1024 per origin: the knife edges between leaves."""
    _, scene, _, pk = box
    v0 = scene.tri_v0.numpy().astype(np.float64)
    p = np.stack([v0, v0 + scene.tri_e1.numpy(), v0 + scene.tri_e2.numpy()],
                 1)
    s = np.array([0.0, 0.5, 1.0, 0.3, 0.85])
    targets = np.concatenate([
        (1.0 - s[:, None, None]) * p[None, :, a] + s[:, None, None]
        * p[None, :, b] for a, b in ((0, 1), (1, 2), (2, 0))], 1)
    targets = np.unique(targets.reshape(-1, 3).astype(np.float32), axis=0)
    rng = np.random.default_rng(8)
    if len(targets) > 1024:
        targets = targets[rng.choice(len(targets), 1024, replace=False)]
    origins = np.array([[0.0, 0.0, 0.0], [-2.5, 1.5, 2.0], [1.7, -2.2, -1.3],
                        [3.1, 3.3, -3.6], [0.0, 0.0, 6.0]], np.float32)
    o = np.repeat(origins, len(targets), 0)
    q = np.tile(targets, (len(origins), 1))
    d = q - o
    dist = np.linalg.norm(d, axis=1)
    d = (d / dist[:, None]).astype(np.float32)
    keep = dist > 1e-3
    o, d, dist = o[keep], d[keep], dist[keep].astype(np.float32)
    if any_hit:   # short of the target, at it, and just past it
        tmax = np.concatenate([0.9995 * dist, dist, 1.0001 * dist])
        o, d = np.tile(o, (3, 1)), np.tile(d, (3, 1))
    else:
        tmax = np.full(len(o), TMK.FLT_MAX, np.float32)
    o, d = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    hits = _walk_equals_brute(pk, o, d, torch.from_numpy(
        tmax.astype(np.float32)), any_hit)
    assert hits > len(tmax) // 4


def test_wrappers_refuse_a_tree_deeper_than_the_kernel_stack():
    """A table whose walk needs more stack than the kernel provides, or no
    table, is refused before any launch (the C entry points refuse the
    same stack)."""
    scene, meta = synth.box_scene(16, 8, 2, textured=True, device='cpu')
    pk = TMK.pack(scene, meta)
    xy, _ = TMK.lane_setup(meta, 'cpu')
    TMK._device_args('sample_pass', pk, xy, xy.device)
    deep = dataclasses.replace(pk, wide=dataclasses.replace(
        pk.wide, stack=TMK.MEGA_STACK + 1))
    with pytest.raises(ValueError, match='stack'):
        TMK._device_args('sample_pass', deep, xy, xy.device)
    with pytest.raises(ValueError, match='wide'):
        TMK._device_args('regen_pass', dataclasses.replace(pk, wide=None),
                         xy, xy.device)


@pytest.mark.parametrize('textured', [False, True])
def test_box_without_subdivision_is_the_box(textured, tmp_path):
    """``wall_subdiv=1`` builds the box the JAX API builds, table for
    table, and ``pack_from_numpy`` with the JAX scene's soup builds the
    port pack's wide table."""
    tscene, tmeta = synth.box_scene(64, 48, DEPTH, textured=textured,
                                    wall_subdiv=1, device='cpu')
    dflt, _ = synth.box_scene(64, 48, DEPTH, textured=textured,
                              device='cpu')
    for f in ('tri_v0', 'tri_e1', 'tri_e2', 'tri_shade'):
        assert torch.equal(getattr(tscene, f), getattr(dflt, f)), f
    jscene, jmeta = jax_box.box_scene(tmp_path, width=64, height=48,
                                      depth=DEPTH, textured=textured)
    jpk = JMK.pack(jscene, jmeta)
    arrays = {k: np.asarray(getattr(jpk, k)) for k in (
        'wx', 'wy', 'wz', 'shade_t', 'mat_lane', 'light_lane', 'tex_lane',
        'consts')}
    T = jmeta.num_tris
    arrays.update(texels=np.asarray(jscene.textures.texels),
                  n_tris=jpk.n_tris, tex_const=jpk.tex_const,
                  **{k: np.asarray(getattr(jscene, k))[:T]
                     for k in ('tri_v0', 'tri_e1', 'tri_e2')})
    ref = TMK.pack_from_numpy(arrays)
    pk = TMK.pack(tscene, tmeta)
    for f in ('tri_v0', 'tri_e1', 'tri_e2'):
        np.testing.assert_array_equal(getattr(tscene, f).numpy(),
                                      arrays[f], err_msg=f)
    for f in ('woop', 'shade', 'mat', 'light', 'tex', 'consts'):
        a, b = getattr(pk, f).numpy(), getattr(ref, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f)
    assert pk.mat.shape[1] == TMK.MF_NROWS == 40
    assert pk.light.shape[1] == TMK.LF_NROWS == 28
    assert pk.wide.stack == ref.wide.stack
    for f in ('nodes', 'rows', 'index'):
        np.testing.assert_array_equal(
            getattr(pk.wide, f).numpy().view(np.int32),
            getattr(ref.wide, f).numpy().view(np.int32), err_msg=f)


def test_tessellated_box_samples_the_box():
    """The same walls cut into 20 x 20 grids: the same paths up to the
    lanes that meet a grid edge, so the same samples on almost every
    lane of a plain pass."""
    out = []
    for sub in (1, 20):
        scene, meta = synth.box_scene(32, 24, DEPTH, textured=True,
                                      wall_subdiv=sub, device='cpu')
        pk = TMK.pack(scene, meta)
        xy, su = TMK.lane_setup(meta, 'cpu')
        out.append(TMK.sample_pass_plain(pk, xy, su, DEPTH))
    (c1, s1), (c20, s20) = out
    assert torch.isfinite(c20).all()
    close = torch.isclose(c1, c20, rtol=1e-3, atol=1e-3).all(0)
    assert close.float().mean() >= 0.98, close.float().mean()
    assert (s1[:2] == s20[:2]).all(0).float().mean() >= 0.98
