"""The hit's gradient on the two-level classes (``accel/hit_grad.py``).

The zoo box is loaded by both packages with ``accel='stream_tlas'`` (K4's
query, the plain walk ``intersect_tlas_plain`` on the CPU) and with
``accel='two_level'`` (K4m's, ``intersect_two_level_plain``), and the
motion box (``zoo_scenes.write_motion_box``, a cube that moves over the
shutter) goes two-level by time.  On the camera and first-bounce queries
``trace_pass`` sends (at the rays' own times):

* the hit's ``Function`` (K4's or K4m's forward, the backward's
  Moller-Trumbore at the hit instance's object-space rows) against the
  plain version's autograd gradient within 1e-4 on 99.9% of the lanes:
  K4m's plain walk under autograd, and for K4 the plain walk's Woop test at
  the triangle and instance it returns (the dense walk's gradient is NaN:
  its zero padding rows give 0 * inf);
* where the JAX trace is plain XLA (``'two_level'``, its
  ``intersect_two_level``) against the JAX walk's derivatives within 1e-4:
  ``jax.grad`` cannot reverse the walk's ``while_loop``, so they come from
  ``jax.jvp``, six tangents (each coordinate of the origin and the
  direction on every lane at once; the lanes are independent);
* under ``'stream_tlas'``, whose JAX trace is a Pallas kernel with no
  derivative, against central differences along a seeded direction over
  the lanes whose hit stays the same, within 5% (``test_torch_dr``'s bar
  for central differences);
* ``kernel_ray_trace`` and ``integrator_rt.intersect`` on a ray that
  autograd tracks: the forward of an untracked ray, a finite gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu.accel import two_level as JTL
from hydracore3_tpu.scene import build as JB
from hydracore3_torch.accel import hit_grad as HG
from hydracore3_torch.accel import traverse_tlas as TT
from hydracore3_torch.accel import two_level as TL2
from hydracore3_torch.accel import wide_bvh as WB
from hydracore3_torch.models import integrator_pt as TIPT
from hydracore3_torch.models import integrator_rt as TRT
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.scene import build as TB
from hydracore3_torch.utils import lmath as TLM
import zoo_scenes
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H, DEPTH = 32, 24, 4
FD_EPS = 1e-3
FD_REL = 0.05
QUERIES = ('camera', 'bounce')


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    d = tmp_path_factory.mktemp('tl')
    return dict(zoo=zoo_scenes.write_zoo_box(str(d / 'zoo'), W, H, DEPTH),
                motion=zoo_scenes.write_motion_box(str(d / 'motion'), W, H,
                                                   DEPTH))


@pytest.fixture(scope='module')
def scenes(libs):
    """{(library, accel): (scene, meta)} of the port."""
    out = {('zoo', a): TB.load_scene(libs['zoo'], accel=a, device='cpu')
           for a in ('stream_tlas', 'two_level')}
    out[('motion', 'auto')] = TB.load_scene(libs['motion'], device='cpu')
    for (_, a), (_, m) in out.items():
        assert m.use_stream_tlas == (a == 'stream_tlas')
        assert m.use_two_level == (a != 'stream_tlas')
    return out


def queries(scene, meta):
    """{label: (pos, dir, time)}: the camera rays and the first-bounce rays
    as ``trace_pass`` traces them (unsorted), with the lanes' times."""
    n = meta.width * meta.height
    st = TIPT.kernel_init_eye_ray(scene, meta, TRNG.gen_init(torch.arange(n)),
                                  torch.arange(n))
    out = {'camera': (st.ray_pos, st.ray_dir, TIPT.ray_time(st))}
    st = TIPT.kernel_ray_trace(scene, meta, st, 0)
    ctx = TIPT.MAT.make_shading_ctx(scene, meta, TIPT._extract_mat_id(
        st.flags), st.hit_norm, st.hit_tang, st.hit_uv)
    st = TIPT.kernel_next_bounce(scene, meta, st, 0,
                                 torch.zeros_like(st.accum_color), ctx)
    out['bounce'] = (st.ray_pos, st.ray_dir, TIPT.ray_time(st))
    return out


def cotangents(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(3, n)).astype(np.float32))


def grads(fn, pos, d, cot):
    """(tri, inst, d/dpos, d/ddir) of sum(cot . (t, u, v)) over the hit
    lanes; ``fn(p, q) -> (t, tri, u, v, inst)``."""
    p, q = pos.clone().requires_grad_(), d.clone().requires_grad_()
    t, tri, u, v, inst = fn(p, q)
    out = sum((torch.where(tri >= 0, x, 0.0) * c).sum()
              for x, c in zip((t, u, v), cot))
    gp, gq = torch.autograd.grad(out, (p, q))
    return tri, inst, gp, gq


def lanes_close(a, b):
    """``a`` (the Function's gradient) finite on every lane and within 1e-4
    of ``b`` on 99.9% of the lanes where ``b`` is finite: a dense plain
    walk's arithmetic over every row can reach 0 * inf on a lane, where
    the Function differentiates its hit's row alone (``test_torch_dr``)."""
    assert bool(torch.isfinite(a).all())
    fin = torch.isfinite(b).all(-1)
    assert float(fin.float().mean()) >= 0.99
    close = torch.isclose(a[fin], b[fin], rtol=1e-4, atol=1e-4).all(-1)
    assert float(close.float().mean()) >= 0.999, float(close.float().mean())


def k4m(tl, time, t_min, t_max):
    """K4m's query in K4's output order."""
    def fn(p, q):
        t, tri, inst, u, v = HG.two_level_with_grad(tl, p, q, t_min, t_max,
                                                    time)
        return t, tri, u, v, inst
    return fn


@pytest.mark.parametrize('label', QUERIES)
@pytest.mark.parametrize('case', [('zoo', 'two_level'), ('motion', 'auto')],
                         ids=['zoo_box', 'motion_box'])
def test_motion_hit_backward_equals_the_plain_gradient(scenes, case, label):
    ts, tm = scenes[case]
    tl = ts.two_level
    pos, d, time = queries(ts, tm)[label]
    n = pos.shape[0]
    t_min, t_max = torch.zeros(n), torch.full((n,), TLM.FLT_MAX)

    def plain(p, q):
        t, tri, inst, u, v = TL2.intersect_two_level_plain(tl, p, q, t_min,
                                                           t_max, time)
        return t, tri, u, v, inst

    cot = cotangents(n, QUERIES.index(label))
    a = grads(k4m(tl, time, t_min, t_max), pos, d, cot)
    b = grads(plain, pos, d, cot)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int((a[0] >= 0).sum()) > n // 2
    lanes_close(a[2], b[2])
    lanes_close(a[3], b[3])
    if case[0] == 'motion':
        # the moving cube is hit at several times
        moving = tl.inst_has_motion[a[1].clamp(min=0)].bool() & (a[0] >= 0)
        assert int(moving.sum()) > 0 and float(time[moving].std()) > 0


@pytest.mark.parametrize('label', QUERIES)
def test_tlas_hit_backward_equals_the_plain_gradient(scenes, label):
    ts, tm = scenes[('zoo', 'stream_tlas')]
    pack = ts.tt
    pos, d, _ = queries(ts, tm)[label]
    n = pos.shape[0]
    t_min, t_max = torch.zeros(n), torch.full((n,), TLM.FLT_MAX)

    def plain(p, q):
        """The plain walk's hit, then its Woop test there under autograd."""
        with torch.no_grad():
            t, tri, u, v, inst = TT.intersect_tlas_plain(
                pack, p, q, t_min, torch.clamp(t_max, max=TT.T_MAX_CAP))
        op, od = TT.to_object_space(pack.inst_f[inst.clamp(min=0)].T, p, q)
        t2, u2, v2, _ = WB._woop(pack.woop[tri.clamp(min=0)], op, od)
        hit = tri >= 0
        assert torch.equal(t2[hit], t[hit]) and torch.equal(u2[hit], u[hit])
        return t2, tri, u2, v2, inst

    cot = cotangents(n, 7 + QUERIES.index(label))
    a = grads(lambda p, q: HG.tlas_with_grad(pack, p, q, t_min, t_max),
              pos, d, cot)
    b = grads(plain, pos, d, cot)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int((a[0] >= 0).sum()) > n // 2
    lanes_close(a[2], b[2])
    lanes_close(a[3], b[3])


@pytest.mark.parametrize('case', [('zoo', 'two_level'), ('motion', 'auto')],
                         ids=['zoo_box', 'motion_box'])
def test_motion_hit_gradient_matches_the_jax_walk(libs, scenes, case):
    ts, tm = scenes[case]
    js, _ = JB.load_scene(libs[case[0]], accel=case[1])
    pos, d, time = queries(ts, tm)['camera']
    n = pos.shape[0]
    cot = cotangents(n, 11)
    a = grads(k4m(ts.two_level, time, torch.zeros(n),
                  torch.full((n,), TLM.FLT_MAX)), pos, d, cot)
    jt, jmin = jnp.asarray(time.numpy()), jnp.zeros(n)
    jmax = jnp.full((n,), TLM.FLT_MAX)

    def outs(p, q):
        t, tri, inst, u, v = JTL.intersect_two_level(js.two_level, p, q,
                                                     jmin, jmax, time=jt)
        return jnp.stack([t, u, v]), tri, inst

    jvp = jax.jit(lambda p, q, tp, tq: jax.jvp(outs, (p, q), (tp, tq)))
    jp, jq = jnp.asarray(pos.numpy()), jnp.asarray(d.numpy())
    zero = jnp.zeros((n, 3), jnp.float32)
    cols = []
    for arg in range(2):
        for k in range(3):
            e = zero.at[:, k].set(1.0)
            (_, tri, inst), (dout, _, _) = jvp(
                jp, jq, e if arg == 0 else zero, zero if arg == 0 else e)
            cols.append((np.asarray(dout) * cot.numpy()).sum(0)
                        * (np.asarray(tri) >= 0))
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(tri))
    np.testing.assert_array_equal(a[1].numpy(), np.asarray(inst))
    jg = torch.from_numpy(np.stack(cols, -1))
    lanes_close(a[2], jg[:, :3])
    lanes_close(a[3], jg[:, 3:])


def test_tlas_hit_gradient_matches_central_differences(scenes):
    ts, tm = scenes[('zoo', 'stream_tlas')]
    pos, d, _ = queries(ts, tm)['camera']
    n = pos.shape[0]
    t_min, t_max = torch.zeros(n), torch.full((n,), TLM.FLT_MAX)
    cot = cotangents(n, 13).double()
    rs = np.random.default_rng(17)
    dp, dd = (torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
              for _ in range(2))

    def lane_loss(e):
        t, tri, u, v, inst = TT.intersect_stream_tlas(
            ts.tt, pos + e * dp, d + e * dd, t_min, t_max)
        return (sum(x.double() * c for x, c in zip((t, u, v), cot)),
                tri, inst)

    (l_p, tri_p, in_p), (l_m, tri_m, in_m), (_, tri0, in0) = (
        lane_loss(FD_EPS), lane_loss(-FD_EPS), lane_loss(0.0))
    smooth = ((tri0 >= 0) & (tri_p == tri0) & (tri_m == tri0)
              & (in_p == in0) & (in_m == in0))
    assert float(smooth.float().mean()) > 0.5
    fd = ((l_p - l_m) / (2 * FD_EPS))[smooth]
    _, _, gp, gq = grads(lambda p, q: HG.tlas_with_grad(ts.tt, p, q, t_min,
                                                        t_max),
                         pos, d, cot.float())
    ad = ((gp.double() * dp.double()).sum(-1)
          + (gq.double() * dd.double()).sum(-1))[smooth]
    off = float((fd.sum() - ad.sum()).abs() / max(float(ad.abs().sum()),
                                                  1e-3))
    assert off <= FD_REL, (float(fd.sum()), float(ad.sum()))
    # lane by lane, the f32 query's rounding over 2 eps aside
    near = (fd - ad).abs() <= 0.05 * ad.abs() + 0.05
    assert float(near.double().mean()) >= 0.95


@pytest.mark.parametrize('case', [('zoo', 'stream_tlas'),
                                  ('zoo', 'two_level'), ('motion', 'auto')],
                         ids=['stream_tlas', 'two_level', 'motion_box'])
def test_kernel_ray_trace_carries_the_gradient(scenes, case):
    ts, tm = scenes[case]
    n = tm.width * tm.height
    st = TIPT.kernel_init_eye_ray(ts, tm, TRNG.gen_init(torch.arange(n)),
                                  torch.arange(n))
    ref = TIPT.kernel_ray_trace(ts, tm, st, 0)
    d = st.ray_dir.clone().requires_grad_()
    out = TIPT.kernel_ray_trace(ts, tm, st._replace(ray_dir=d), 0)
    for f in ('flags', 'hit_dist', 'hit_pos', 'hit_norm', 'hit_uv',
              'hit_inst'):
        assert torch.equal(getattr(out, f).detach(), getattr(ref, f)), f
    g, = torch.autograd.grad(out.hit_dist.sum() + out.hit_pos.sum(), d)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    if tm.use_stream_tlas:
        hit = TRT.intersect(ts, tm, st.ray_pos, d, torch.full(
            (n,), TLM.FLT_MAX))
        hit0 = TRT.intersect(ts, tm, st.ray_pos, st.ray_dir, torch.full(
            (n,), TLM.FLT_MAX))
        assert torch.equal(hit.t.detach(), hit0.t)
        g, = torch.autograd.grad(torch.where(hit.prim_id >= 0, hit.t,
                                             0.0).sum(), d)
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


@pytest.mark.parametrize('case', [('zoo', 'stream_tlas'),
                                  ('zoo', 'two_level')],
                         ids=['stream_tlas', 'two_level'])
def test_missed_lanes_take_no_gradient(scenes, case):
    """A lane the query misses takes a zero gradient, whatever its ray holds:
    a shadow ray that is not traced (t_max 0) may have a NaN direction (its
    light sample at the hit point), as one lane of the motion box's had on
    the card."""
    ts, tm = scenes[case]
    pos, d, time = queries(ts, tm)['camera']
    n = pos.shape[0]
    d = d.clone()
    d[::7] = float('nan')
    t_max = torch.full((n,), TLM.FLT_MAX)
    t_max[1::7] = 0.0
    if tm.use_stream_tlas:
        def fn(p, q):
            return HG.tlas_with_grad(ts.tt, p, q, torch.zeros(n), t_max)
    else:
        fn = k4m(ts.two_level, time, torch.zeros(n), t_max)
    tri, _, gp, gq = grads(fn, pos, d, cotangents(n, 19))
    missed = tri < 0
    assert bool(missed[::7].all()) and bool(missed[1::7].all())
    assert int((~missed).sum()) > n // 2
    for g in (gp, gq):
        assert bool(torch.isfinite(g).all())
        assert float(g[missed].abs().max()) == 0.0
        assert float(g[~missed].abs().sum()) > 0
