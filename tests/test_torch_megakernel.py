"""The port's megakernel (models/megakernel.py) against the JAX package's.

The box of tests/test_api.py:16-42 goes through the JAX API and
``load_scene`` (tests/jax_box.py) and through the port's own build
(``scene.synth.box_scene``), plain (12 triangles, const-texture fold) and
textured (16 triangles: a textured and a glossy quad, a point and a sphere
light).  Bars:
- the port's ``pack`` equals JAX ``MK.pack`` table by table;
- on JAX's own pack (``pack_from_numpy``), ``sample_pass_plain`` equals
  ``sample_pass_ref``: RNG on every lane, contrib within 1e-5 (the
  textured pool bf16-rounded, as the JAX quad pool is);
- on the port-built boxes: contrib within rtol/atol 1e-3 on >= 99.5% of
  lanes, RNG and flags equal on >= 99.9%;
- one interpret-mode ``sample_pass_pallas`` pass against the plain version;
- ``render.render`` at 4 spp against JAX ``R.render`` at >= 45 dB
  (tests/test_megakernel.py:98), regen against the fixed chain at >= 30 dB
  (6 spp, tests/test_megakernel.py:306) with a mean sample count >= spp;
- the router refuses what the slice lacks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu import render as JR
from hydracore3_tpu.models import megakernel as JMK
from hydracore3_tpu.ops import rng as JRNG
from hydracore3_torch import render as TR
from hydracore3_torch.models import megakernel as TMK
from hydracore3_torch.scene import build as TB
from hydracore3_torch.scene import synth
import jax_box

W, H, DEPTH = 64, 48, 4
N_LANES = 2048


def psnr(a, b):
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.max(b)), 1e-9)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


@pytest.fixture(scope='module', params=[False, True], ids=['plain', 'textured'])
def boxes(request, tmp_path_factory):
    textured = request.param
    jscene, jmeta = jax_box.box_scene(tmp_path_factory.mktemp('box'),
                                      width=W, height=H, depth=DEPTH,
                                      textured=textured)
    tscene, tmeta = synth.box_scene(W, H, DEPTH, textured=textured,
                                     device='cpu')
    return textured, (jscene, jmeta, JMK.pack(jscene, jmeta)), (tscene, tmeta)


def bridge(jscene, jpk, bf16):
    """JAX's pack through ``pack_from_numpy``; ``bf16`` rounds the f32
    texels as the JAX quad pool stores them."""
    arrays = {k: np.asarray(getattr(jpk, k)) for k in (
        'wx', 'wy', 'wz', 'shade_t', 'mat_lane', 'light_lane', 'tex_lane',
        'consts')}
    arrays.update(texels=np.asarray(jscene.textures.texels),
                  n_tris=jpk.n_tris, tex_const=jpk.tex_const)
    pk = TMK.pack_from_numpy(arrays)
    if bf16:
        pk = dataclasses.replace(
            pk, texels=pk.texels.to(torch.bfloat16).to(torch.float32))
    return pk


def lanes(n=N_LANES):
    pix = np.arange(n, dtype=np.int32) % (W * H)
    xy = np.stack([(pix % W).astype(np.float32),
                   (pix // W).astype(np.float32)])
    rng0 = np.asarray(JRNG.gen_init(jnp.asarray(pix)))
    return xy, rng0.T.astype(np.int64)


@functools.partial(jax.jit, static_argnames=('depth',))
def jax_ref_pass(pk, xs, ys, rx, ry, depth):
    """``MK.sample_pass_ref``'s stage chain, also returning the flags."""
    st = JMK.stage_init(pk.consts, xs, ys, rx, ry)
    for b in range(depth):
        st = JMK.stage_trace(pk.wx, pk.wy, pk.wz, pk.shade_t, pk.n_tris, st,
                             b)
        md = JMK.fetch_mat(pk.mat_lane, JMK._mat_id(st['flags']))
        if pk.tex_const:
            tex = md['texc']
        else:
            qidx, w4 = JMK.stage_tap_prep(pk.tex_lane, md, st)
            tex = JMK.tex_from_rows(JMK._tap_xla_like(pk, qidx), w4)
        shade, st['rngx'], st['rngy'] = JMK.stage_nee(
            pk.wx, pk.wy, pk.wz, pk.shade_t, pk.n_tris, pk.light_lane,
            pk.consts, md, tex, st, b, JMK.INTEGRATOR_MIS_PT,
            mtypes=pk.mtypes)
        st = JMK.stage_next_bounce(md, tex, st, shade, b,
                                   JMK.INTEGRATOR_MIS_PT, pk.light_lane,
                                   pk.consts, mtypes=pk.mtypes)
    contrib = JMK.stage_env_contribute(pk.consts, st, JMK.INTEGRATOR_MIS_PT)
    return contrib, st['rngx'], st['rngy'], st['flags']


@pytest.fixture(scope='module')
def jax_ref(boxes):
    _, (jscene, jmeta, jpk), _ = boxes
    xy, su = lanes()
    plane = lambda a: jnp.asarray(a.reshape(-1, JMK.L))  # noqa: E731
    u32 = su.astype(np.uint32)
    out = jax_ref_pass(jpk, plane(xy[0]), plane(xy[1]), plane(u32[0]),
                       plane(u32[1]), jmeta.trace_depth)
    c, rx, ry, fl = (np.asarray(a).reshape(a.shape[:-2] + (-1,)) for a in out)
    return xy, su, c, np.stack([rx, ry, fl]).astype(np.int64)


def test_supported(boxes):
    textured, (jscene, jmeta, jpk), (tscene, tmeta) = boxes
    assert JMK.supported(jscene, jmeta)
    assert TMK.supported(tscene, tmeta)
    assert not tmeta.use_stream and tscene.st_woop is None
    assert tmeta.tex0_all_const == jmeta.tex0_all_const == (not textured)
    assert tmeta.num_tris == jmeta.num_tris == (16 if textured else 12)


def test_pack_matches_jax(boxes):
    _, (jscene, _, jpk), (tscene, tmeta) = boxes
    pk = TMK.pack(tscene, tmeta)
    ref = bridge(jscene, jpk, bf16=False)
    assert (pk.n_tris, pk.tex_const) == (ref.n_tris, ref.tex_const)
    for f in ('woop', 'shade', 'mat', 'light', 'tex', 'consts'):
        a, b = getattr(pk, f).numpy(), getattr(ref, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f)
    P = pk.texels.shape[0]
    assert ref.texels.shape[0] >= P   # the JAX pool pads to 32 rows
    np.testing.assert_allclose(pk.texels.numpy(), ref.texels[:P].numpy(),
                               rtol=0, atol=1e-6)


def test_plain_equals_ref_on_jax_pack(boxes, jax_ref):
    """Same tables in, same stage math: RNG on every lane, contrib 1e-5."""
    _, (jscene, jmeta, jpk), _ = boxes
    xy, su, c_ref, su_ref = jax_ref
    pk = bridge(jscene, jpk, bf16=True)
    c, su2 = TMK.sample_pass_plain(pk, torch.from_numpy(xy),
                                   torch.from_numpy(su), jmeta.trace_depth)
    assert (su2.numpy() == su_ref).all()
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-5, atol=1e-5)


def test_port_box_matches_ref(boxes, jax_ref):
    """The port's own build and f32 texels against the JAX stage chain."""
    _, _, (tscene, tmeta) = boxes
    xy, su, c_ref, su_ref = jax_ref
    c, su2 = TMK.sample_pass_plain(TMK.pack(tscene, tmeta),
                                   torch.from_numpy(xy),
                                   torch.from_numpy(su), tmeta.trace_depth)
    c = c.numpy()
    assert np.isfinite(c).all()
    close = np.isclose(c, c_ref, rtol=1e-3, atol=1e-3).all(0)
    assert close.mean() >= 0.995, close.mean()
    su2 = su2.numpy()
    assert (su2[:2] == su_ref[:2]).all(0).mean() >= 0.999
    assert (su2[2] == su_ref[2]).mean() >= 0.999


def test_pallas_interpret_matches_plain(boxes, jax_ref):
    """One interpret-mode pass of the TPU kernel chain (whole_kernel for the
    plain box, the per-bounce chain with taps for the textured one)."""
    _, (jscene, jmeta, jpk), _ = boxes
    xy, su, _, _ = jax_ref
    nb = N_LANES // JMK.RBLK
    blk = lambda a: jnp.asarray(  # noqa: E731
        a.reshape(a.shape[0], nb, JMK.S, JMK.L).transpose(1, 0, 2, 3))
    su3 = np.concatenate([su, np.zeros((1, N_LANES), np.int64)])
    c_pl, su_pl = JMK.sample_pass_pallas(
        jpk, blk(xy), None, blk(su3.astype(np.uint32)), jmeta.trace_depth,
        JMK.INTEGRATOR_MIS_PT, interpret=True)
    unblk = lambda a: np.asarray(a).transpose(1, 0, 2, 3).reshape(  # noqa
        a.shape[1], -1)
    c, su2 = TMK.sample_pass_plain(bridge(jscene, jpk, bf16=True),
                                   torch.from_numpy(xy),
                                   torch.from_numpy(su), jmeta.trace_depth)
    assert (su2.numpy() == unblk(su_pl).astype(np.int64)).all()
    np.testing.assert_allclose(c.numpy(), unblk(c_pl), rtol=1e-5, atol=1e-5)


def test_render_matches_jax(boxes):
    _, (jscene, jmeta, _), (tscene, tmeta) = boxes
    img_j = np.asarray(JR.render(jscene, jmeta, spp=4, integrator='mispt'))
    img_t, timing = TR.render(tscene, tmeta, spp=4, return_timing=True)
    assert img_t.shape == (H, W, 4)
    assert timing['nonfinite'] == 0
    p = psnr(img_t[..., :3], img_j[..., :3])
    assert p >= 45.0, p


def test_regen_matches_fixed(boxes):
    """Persistent lanes against the fixed chain, same estimator and RNG
    streams.  The plain box at 6 spp; the textured box's point light on
    the glossy quad leaves fireflies that two 6-spp estimates at 64x48 do
    not average out (26.2 dB measured), so it is held at 64 spp."""
    textured, _, (tscene, tmeta) = boxes
    spp = 64 if textured else 6
    img_f = TR.render(tscene, tmeta, spp=spp)
    img_r, timing = TR.render(tscene, tmeta, spp=spp, regen=True,
                              return_timing=True)
    assert timing['nonfinite'] == 0
    assert timing['samples'] / (W * H) >= spp
    p = psnr(img_r[..., :3], img_f[..., :3])
    assert p >= 30.0, p


def test_wrappers_take_plain_version_on_cpu():
    scene, meta = synth.box_scene(16, 8, 3, textured=True, device='cpu')
    pk = TMK.pack(scene, meta)
    xy, su = TMK.lane_setup(meta, 'cpu')
    n_s, n_r = TMK.sample_pass.launches, TMK.regen_pass.launches
    a = TMK.sample_pass(pk, xy, su, 3)
    b = TMK.sample_pass_plain(pk, xy, su, 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    sf, su2 = TMK.regen_pass(pk, xy, None, su, 4, 3, first=True)
    sf_p, su_p = TMK.regen_iters_plain(pk, xy, None, su, 4, 3, first=True)
    assert torch.equal(sf, sf_p) and torch.equal(su2, su_p)
    assert (TMK.sample_pass.launches, TMK.regen_pass.launches) == (n_s, n_r)


def test_lanes_agree_holds_every_lane():
    """The card's bar for K1 against its plain version: one lane off in an
    f32 row or a uint32 row is seen."""
    scene, meta = synth.box_scene(16, 8, 3, textured=True, device='cpu')
    pk = TMK.pack(scene, meta)
    xy, su = TMK.lane_setup(meta, 'cpu')
    out = TMK.sample_pass_plain(pk, xy, su, 3)
    assert TMK.lanes_agree(out, out, 3) == (1.0, 1.0, 0.0)
    c, s = out[0].clone(), out[1].clone()
    c[0, 5] += 1e-4 * (1.0 + abs(float(c[0, 5])))
    s[2, 7] ^= 1
    close, equal, err = TMK.lanes_agree((c, s), out, 3)
    n = xy.shape[1]
    assert close == pytest.approx((n - 1) / n)
    assert equal == pytest.approx((n - 1) / n)
    assert err >= 1e-4


def test_router_refuses_what_is_not_ported():
    scene, meta = synth.box_scene(16, 8, 2, textured=True, device='cpu')
    with pytest.raises(NotImplementedError, match='naivept'):
        TR.render(scene, meta, spp=1, integrator='naivept')
    conductor = 2   # MAT_TYPE_CONDUCTOR (include/cmaterial.h)
    meta_c = dataclasses.replace(
        meta, mat_types_present=meta.mat_types_present + (conductor,))
    assert not TMK.supported(scene, meta_c)
    with pytest.raises(NotImplementedError, match='material types'):
        TR.render(scene, meta_c, spp=1)


def test_streamed_box_with_point_and_sphere_lights_matches_jax(tmp_path):
    """The batched path shades point and sphere lights.  The textured box
    built streamed (``accel='stream'``: K2/K3's path) against the JAX
    package's XLA ``trace_pass`` on the same box, lane for lane: accum
    within rtol/atol 1e-3 on >= 99.5% of lanes, the RNG state equal on
    those lanes."""
    from hydracore3_tpu.models import integrator_pt as JIPT
    from hydracore3_torch.models import integrator_pt as TIPT
    from hydracore3_torch.ops import rng as TRNG
    jscene, jmeta = jax_box.box_scene(tmp_path, width=W, height=H,
                                      depth=DEPTH, textured=True)
    assert not (jmeta.use_stream or jmeta.use_pallas)       # the XLA trace
    tscene, tmeta = TB.build_scene(synth.build_box(W, H, DEPTH, textured=True),
                                   device='cpu', accel='stream')
    assert tmeta.use_stream
    assert {TB.LIGHT_GEOM_POINT, TB.LIGHT_GEOM_SPHERE} <= set(
        tmeta.light_geom_types)
    N = W * H
    jp = jnp.arange(N, dtype=jnp.int32)
    j_acc, _, _, j_rng, _ = (np.asarray(x) for x in JIPT.trace_pass(
        jscene, jmeta, JRNG.gen_init(jp), jp))
    tp = torch.arange(N)
    t_acc, _, t_rng = (x.numpy() for x in TIPT.trace_pass(
        tscene, tmeta, TRNG.gen_init(tp), tp))
    assert np.isfinite(t_acc).all()
    close = np.isclose(t_acc, j_acc, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.995, f'accum agrees on {close.mean():.4%}'
    rng_eq = (t_rng.astype(np.uint32) == j_rng).all(axis=1)
    assert rng_eq[close].all(), f'{(~rng_eq[close]).sum()} lanes differ in RNG'


def test_build_refuses_spot_lights():
    sd = synth.build_box(16, 8, 2)
    sd.simple_lights.append(TB.SimpleLightDesc(kind='spot'))
    with pytest.raises(NotImplementedError, match='spot'):
        TB.build_scene(sd, device='cpu')


def test_box_renders_the_same_through_both_paths():
    """The textured box through the megakernel (K1's path) and streamed
    through the batched integrator (K2/K3's path): 64x48, 64 spp, PSNR
    >= 30 dB."""
    sd = synth.build_box(W, H, DEPTH, textured=True)
    small, small_meta = TB.build_scene(sd, device='cpu')
    streamed, streamed_meta = TB.build_scene(sd, device='cpu',
                                             accel='stream')
    assert not small_meta.use_stream and streamed_meta.use_stream
    a = TR.render(small, small_meta, spp=64)[..., :3]
    b = TR.render(streamed, streamed_meta, spp=64)[..., :3]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert psnr(b, a) >= 30.0, f'PSNR {psnr(b, a):.2f} dB'
    assert abs(float(b.mean()) / float(a.mean()) - 1.0) < 0.05
