"""Differentiable rendering: the port's ``models/dr.py``, its lmath
gradients and the hit's ``Function`` against the JAX package's.

* ``safe_sqrt`` / ``safe_arccos``: values and ``torch.autograd.grad``
  against ``jax.grad`` of the JAX functions within 1 ulp at the edges of
  their domains;
* the hit's ``Function`` (``accel/hit_grad.py``): its backward against the
  gradient of the differentiable plain version (``intersect_clusters_plain``
  under autograd) on K5's camera and first-bounce queries of the zoo box,
  and on the small city streamed (against the dense Moller-Trumbore plain
  version over the streamed soup's rows, on the lanes whose triangle the
  march agrees on); on the two-level class a ray autograd tracks takes
  the hit's gradient too (``test_torch_two_level_grad`` holds it);
* ``loss_and_grad`` (``mispt``, ``naivept``) and
  ``whitted_loss_and_grad`` on the DR box (``zoo_scenes.write_dr_box``,
  depth 6, drmain's trainable back-wall slot) at 16 x 12 from the same
  non-uniform parameters: loss within 1e-5 relative, gradient relative L2
  within 1e-4; the texel gradient's directional derivative against central
  differences within 5% (JAX's bar);
* the regularisers and the three optimiser steps on seeded arrays (rtol
  1e-6), and 3 iterations of ``optimize_texture`` and
  ``optimize_texture_scan`` against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu.models import dr as JDR
from hydracore3_tpu.ops import rng as JRNG
from hydracore3_tpu.scene import build as JB
from hydracore3_tpu.utils import lmath as JLM
from hydracore3_torch import render as TR
from hydracore3_torch.accel import hit_grad as HG
from hydracore3_torch.accel import traverse_pallas as TPL
from hydracore3_torch.models import dr as TDR
from hydracore3_torch.models import integrator_pt as TIPT
from hydracore3_torch.models import integrator_rt as TRT
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.scene import build as TB
from hydracore3_torch.scene import synth as tsynth
from hydracore3_torch.utils import lmath as TLM
from test_torch_scene import CITY_KW
from test_torch_tlas import ICITY_KW
import zoo_scenes
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H, DEPTH = 16, 12, 6
LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
FD_REL = 0.05            # JAX's bar (tests/test_dr.py)
FD_EPS = 1e-3
EDGE_X = (-1.0, -1e-7, 0.0, 1e-14, 1e-12, 0.25, 1.0 - 1e-7, 1.0, 1.5)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope='module')
def dr_box(tmp_path_factory):
    path = zoo_scenes.write_dr_box(str(tmp_path_factory.mktemp('dr')), W, H,
                                   DEPTH)
    ts, tm = TB.load_scene(path, device='cpu')
    js, jm = JB.load_scene(path)
    slot = zoo_scenes.dr_tex_slot(ts)
    return ts, tm, TDR.put_diff_tex(ts, slot), js, jm, \
        JDR.put_diff_tex(js, slot), zoo_scenes.material_ids(path)


@pytest.fixture(scope='module')
def zoo_box(tmp_path_factory):
    path = zoo_scenes.write_zoo_box(str(tmp_path_factory.mktemp('zoo')), 32,
                                    24, 4)
    return (TB.load_scene(path, device='cpu'), JB.load_scene(path),
            zoo_scenes.material_ids(path))


def inputs(n, size, seed=1):
    rs = np.random.default_rng(seed)
    params = rs.uniform(0.2, 1.0, (size, 4)).astype(np.float32)
    ref = rs.uniform(0.0, 0.5, (n, 3)).astype(np.float32)
    return params, ref


def streams(n):
    return ((TRNG.gen_init(torch.arange(n)), torch.arange(n)),
            (JRNG.gen_init(jnp.arange(n, dtype=jnp.int32)),
             jnp.arange(n, dtype=jnp.int32)))


# ---- repair 1: the bounded gradients --------------------------------------

@pytest.mark.parametrize('x', EDGE_X)
@pytest.mark.parametrize('name', ('safe_sqrt', 'safe_arccos'))
def test_lmath_gradient_equals_jax(name, x):
    jf, tf = getattr(JLM, name), getattr(TLM, name)
    jy, jg = jax.value_and_grad(jf)(jnp.float32(x))
    t = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    ty = tf(t)
    tg, = torch.autograd.grad(ty, t)
    np.testing.assert_array_max_ulp(np.float32(ty.detach()), np.float32(jy),
                                    maxulp=1)
    np.testing.assert_array_max_ulp(np.float32(tg), np.float32(jg), maxulp=1)
    assert np.isfinite(float(tg))


def test_lmath_without_autograd_is_the_plain_op():
    x = torch.tensor(EDGE_X, dtype=torch.float32)
    assert torch.equal(TLM.safe_sqrt(x), torch.sqrt(torch.clamp(x, min=0.0)))
    assert torch.equal(TLM.safe_arccos(x),
                       torch.arccos(torch.clamp(x, -1.0, 1.0)))


# ---- repair 2: the hit's gradient -----------------------------------------

def hit_grads(query_fn, pos, d, cot):
    p = pos.clone().requires_grad_()
    q = d.clone().requires_grad_()
    t, tri, u, v = query_fn(p, q)
    found = tri >= 0
    out = sum((torch.where(found, x, 0.0) * c).sum()
              for x, c in zip((t, u, v), cot))
    gp, gq = torch.autograd.grad(out, (p, q))
    return tri, gp, gq


def k5_queries(scene, meta):
    n = meta.width * meta.height
    st = TIPT.kernel_init_eye_ray(scene, meta, TRNG.gen_init(torch.arange(n)),
                                  torch.arange(n))
    yield st.ray_pos, st.ray_dir
    st = TIPT.kernel_ray_trace(scene, meta, st, 0)
    ctx = TIPT.MAT.make_shading_ctx(scene, meta, TIPT._extract_mat_id(
        st.flags), st.hit_norm, st.hit_tang, st.hit_uv)
    st = TIPT.kernel_next_bounce(scene, meta, st, 0,
                                 torch.zeros_like(st.accum_color), ctx)
    yield st.ray_pos, st.ray_dir


def lanes_close(a, b, frac=0.999):
    """``a`` (the Function's gradient) finite on every lane and within
    1e-4 of ``b`` (the plain version's) on ``frac`` of the lanes where
    ``b`` is finite: the plain version's dense arithmetic over every row
    can reach 0 * inf on a lane (one lane of the zoo box's first bounce),
    where the Function differentiates its hit's row alone."""
    assert bool(torch.isfinite(a).all())
    fin = torch.isfinite(b).all(-1)
    assert float(fin.float().mean()) >= 0.99
    close = torch.isclose(a[fin], b[fin], rtol=1e-4, atol=1e-4).all(-1)
    assert float(close.float().mean()) >= frac, float(close.float().mean())


def test_hit_backward_equals_the_plain_gradient(zoo_box):
    (ts, tm), _, _ = zoo_box
    tris = ts.cl_tris12
    rows = HG.cluster_rows(tris)
    for k, (pos, d) in enumerate(k5_queries(ts, tm)):
        n = pos.shape[0]
        t_min = torch.zeros(n)
        t_max = torch.full((n,), TLM.FLT_MAX)
        cot = torch.from_numpy(np.random.default_rng(k).normal(
            size=(3, n)).astype(np.float32))

        def plain(p, q):
            return TPL.intersect_clusters_plain(tris, p, q, t_min, t_max)

        def through_fn(p, q):
            return HG.nearest_with_grad(
                lambda a, b: TPL.intersect_clusters(None, None, tris, a, b,
                                                    t_min, t_max), rows, p, q)

        tri_a, gp_a, gd_a = hit_grads(through_fn, pos, d, cot)
        tri_b, gp_b, gd_b = hit_grads(plain, pos, d, cot)
        assert torch.equal(tri_a, tri_b) and int((tri_a >= 0).sum()) > n // 2
        lanes_close(gp_a, gp_b)
        lanes_close(gd_a, gd_b)


def test_hit_backward_on_the_streamed_soup():
    ts, tm = tsynth.city_scene(**CITY_KW, device='cpu')
    pos, d = next(k5_queries(ts, tm))
    n = pos.shape[0]
    t_min, t_max = torch.zeros(n), torch.full((n,), TLM.FLT_MAX)
    # the soup without its padding rows (zero triangles, whose 1 / det the
    # dense plain version's gradient turns into 0 * inf on every lane)
    real = torch.nonzero(torch.linalg.cross(ts.tri_e1, ts.tri_e2).abs()
                         .sum(-1) > 0).squeeze(1)
    soup = torch.cat([ts.tri_v0, ts.tri_e1, ts.tri_e2], -1)[real]
    cot = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, n)).astype(np.float32))
    tri_a, gp_a, gd_a = hit_grads(
        lambda p, q: TIPT.soup_nearest_hit(ts, p, q, t_min, t_max, True),
        pos, d, cot)
    tri_b, gp_b, gd_b = hit_grads(
        lambda p, q: TPL.intersect_clusters_plain(soup, p, q, t_min, t_max),
        pos, d, cot)
    tri_b = torch.where(tri_b >= 0, real[tri_b.clamp(min=0)], -1)
    same = (tri_a == tri_b) & (tri_a >= 0)
    assert float(same.float().mean()) > 0.5
    lanes_close(gp_a[same], gp_b[same])
    lanes_close(gd_a[same], gd_b[same])


def test_hit_without_autograd_runs_the_query_itself():
    calls = []

    def query(p, q):
        calls.append((p, q))
        return 'hit'
    pos, d = torch.zeros(2, 3), torch.ones(2, 3)
    assert HG.nearest_with_grad(query, None, pos, d) == 'hit'
    with torch.no_grad():
        assert HG.nearest_with_grad(query, None, pos.requires_grad_(),
                                    d) == 'hit'
    assert len(calls) == 2 and calls[0][0] is pos


def test_two_level_raises_where_a_ray_needs_the_hit_gradient():
    """Nothing raises any more where a ray that autograd tracks meets the
    two-level class: ``kernel_ray_trace`` and ``integrator_rt.intersect``
    return the untracked ray's hit and carry a finite gradient
    (``tests/test_torch_two_level_grad.py`` holds it against the plain
    walks, JAX and central differences)."""
    ts, tm = tsynth.instanced_city_scene(**ICITY_KW, accel='stream_tlas',
                                         device='cpu')
    n = tm.width * tm.height
    st = TIPT.kernel_init_eye_ray(ts, tm, TRNG.gen_init(torch.arange(n)),
                                  torch.arange(n))
    d = st.ray_dir.clone().requires_grad_()
    out = TIPT.kernel_ray_trace(ts, tm, st._replace(ray_dir=d), 0)
    ref = TIPT.kernel_ray_trace(ts, tm, st, 0)
    assert torch.equal(out.hit_dist.detach(), ref.hit_dist)
    assert torch.equal(out.flags, ref.flags)
    g, = torch.autograd.grad(out.hit_dist.sum(), d)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    t_max = torch.full((n,), TLM.FLT_MAX)
    hit = TRT.intersect(ts, tm, st.ray_pos, d, t_max)
    assert torch.equal(hit.t.detach(), TRT.intersect(ts, tm, st.ray_pos,
                                                     st.ray_dir, t_max).t)
    g, = torch.autograd.grad(torch.where(hit.prim_id >= 0, hit.t, 0.0).sum(),
                             d)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


# ---- the DR module against JAX ---------------------------------------------

@pytest.mark.parametrize('integrator', ('mispt', 'naivept'))
def test_loss_and_grad_matches_jax(dr_box, integrator):
    ts, tm, tsu, js, jm, jsu, _ = dr_box
    n = W * H
    params, ref = inputs(n, tsu.size)
    (trng, tpix), (jrng, jpix) = streams(n)
    itype = TIPT.INTEGRATOR_BY_NAME[integrator]
    jl, jg, jc, jr = JDR.loss_and_grad(jnp.asarray(params), js, jm, jsu,
                                       jrng, jpix, jnp.asarray(ref), itype)
    tl, tg, tc, tr = TDR.loss_and_grad(torch.from_numpy(params), ts, tm, tsu,
                                       trng, tpix, torch.from_numpy(ref),
                                       itype)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    jg = np.asarray(jg)
    assert np.abs(jg).sum() > 0 and np.isfinite(tg.numpy()).all()
    assert rel_l2(tg.numpy(), jg) <= GRAD_RL2
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr).astype(np.int64))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-4)


def test_whitted_loss_and_grad_matches_jax(dr_box):
    ts, tm, tsu, js, jm, jsu, _ = dr_box
    n = W * H
    params, ref = inputs(n, tsu.size, seed=3)
    jl, jg = JDR.whitted_loss_and_grad(jnp.asarray(params), js, jm, jsu,
                                       jnp.arange(n, dtype=jnp.int32),
                                       jnp.asarray(ref))
    tl, tg = TDR.whitted_loss_and_grad(torch.from_numpy(params), ts, tm, tsu,
                                       torch.arange(n), torch.from_numpy(ref))
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert np.abs(np.asarray(jg)).sum() > 0
    assert rel_l2(tg.numpy(), jg) <= GRAD_RL2


def lane_losses(ts, tm, scene_fn, p, rng, pix, ref):
    contrib, _, _ = TR._one_sample(scene_fn(p), tm, rng, pix,
                                   TIPT.INTEGRATOR_MIS_PT)
    d = contrib[:, :3].double() - ref.double()
    return (d * d).sum(-1)


def test_texel_directional_derivative_matches_central_differences(dr_box):
    ts, tm, tsu, _, _, _, _ = dr_box
    n = W * H
    params, ref = inputs(n, tsu.size, seed=4)
    (trng, tpix), _ = streams(n)
    p, r = torch.from_numpy(params), torch.from_numpy(ref)
    _, g, _, _ = TDR.loss_and_grad(p, ts, tm, tsu, trng, tpix, r)
    direction = torch.from_numpy(np.random.default_rng(0).normal(
        size=params.shape).astype(np.float32))

    def loss_at(e):
        return float(lane_losses(ts, tm, lambda q: TDR.scene_with_params(
            ts, tsu, q), p + e * direction, trng, tpix, r).sum())

    fd = (loss_at(FD_EPS) - loss_at(-FD_EPS)) / (2 * FD_EPS)
    ad = float((g * direction).sum())
    assert abs(fd - ad) <= FD_REL * max(abs(fd), abs(ad), 1e-3), (fd, ad)


# ---- regularisers, optimisers, loops ---------------------------------------

def test_regularizers_match_jax():
    rs = np.random.default_rng(0)
    d = rs.normal(size=17).astype(np.float32)
    np.testing.assert_allclose(
        float(TDR.reg_loss_image_1d(torch.from_numpy(d))),
        float(JDR.reg_loss_image_1d(jnp.asarray(d))), rtol=1e-6)
    img = rs.normal(size=(8 * 6, 4)).astype(np.float32)
    t = torch.from_numpy(img).requires_grad_()
    tl = TDR.reg_loss_image_2d4f(t, 8, 6)
    tg, = torch.autograd.grad(tl, t)
    jl, jg = jax.value_and_grad(
        lambda q: JDR.reg_loss_image_2d4f(q, 8, 6))(jnp.asarray(img))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('name', ('adam2_step', 'adam_hydra_step',
                                  'gd_step'))
def test_optimizer_steps_match_jax(name):
    rs = np.random.default_rng(7)
    shape = (64, 4)
    p, g = (rs.normal(size=shape).astype(np.float32) for _ in range(2))
    m, v = rs.normal(size=shape).astype(np.float32), rs.uniform(
        0, 1, shape).astype(np.float32)
    tp, (tm_, tv) = TDR.state_from_numpy(p, (m, v), device='cpu')
    jp, jst = jnp.asarray(p), (jnp.asarray(m), jnp.asarray(v))
    tst = (tm_, tv)
    for it in (0, 1, 150):
        jp, jst = getattr(JDR, name)(jp, jnp.asarray(g), jst, it)
        tp, tst = getattr(TDR, name)(tp, torch.from_numpy(g), tst, it)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_state_from_numpy_defaults_to_the_card():
    p, (m, v) = TDR.state_from_numpy(np.ones((2, 4)), device='cpu')
    assert p.dtype == torch.float32 and float(m.abs().sum()) == 0
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            TDR.state_from_numpy(np.ones((2, 4)))


ITERS = 3


@pytest.mark.parametrize('loop', ('optimize_texture', 'optimize_texture_scan'))
def test_optimization_loops_match_jax(dr_box, loop):
    ts, tm, tsu, js, jm, jsu, _ = dr_box
    ref_img = np.random.default_rng(6).uniform(0.0, 0.3, (H, W, 4)).astype(
        np.float32)
    kw = dict(iters=ITERS, spp=1, lr=0.15, init_value=1.0, verbose=False)
    if loop == 'optimize_texture_scan':
        kw['reg_weight'] = 1e-4
    jp, jl = getattr(JDR, loop)(js, jm, jsu, ref_img, **kw)
    tp, tl = getattr(TDR, loop)(ts, tm, tsu, ref_img, **kw)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    assert rel_l2(tp.numpy() - 1.0, np.asarray(jp) - 1.0) <= 1e-3
