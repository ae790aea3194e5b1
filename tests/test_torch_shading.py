"""The port's shading math against the JAX package on random inputs.

lmath helpers, texture taps (wrap/clamp/mirror, linear/nearest, texture
matrices), GLTF sample/eval, material dispatch through the shading
context, the rect and env lights' sample/pdf/intensity and
``environment_color``.  Bound rtol 1e-4 / atol 1e-6: transcendentals
differ between XLA and torch in the last ulps.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hydracore3_tpu import lights as JL
from hydracore3_tpu.bsdf import dispatch as JD
from hydracore3_tpu.bsdf import gltf as JG
from hydracore3_tpu.ops import rng as JRNG
from hydracore3_tpu.ops import texture as JT
from hydracore3_tpu.utils import lmath as JM
from hydracore3_torch import lights as TL
from hydracore3_torch.bsdf import dispatch as TD
from hydracore3_torch.bsdf import gltf as TG
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.ops import texture as TT
from hydracore3_torch.scene import build as TB
from hydracore3_torch.scene import synth as tsynth
from hydracore3_torch.utils import lmath as TM
from test_torch_scene import CITY_KW, jax_city

RTOL, ATOL = 1e-4, 1e-6
N = 2048


def close(t, j, rtol=RTOL, atol=ATOL, err_msg=''):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def both(a):
    return torch.from_numpy(np.asarray(a)), jnp.asarray(a)


def test_lmath():
    rng = np.random.default_rng(1)
    n, d = unit(rng, N), unit(rng, N)
    p = rng.uniform(-50, 50, (N, 3)).astype(np.float32)
    r = rng.random((N, 2)).astype(np.float32)
    (tn, jn), (td, jd), (tp, jp), (tr, jr) = map(both, (n, d, p, r))
    for t, j in zip(TM.coordinate_system_v2(tn), JM.coordinate_system_v2(jn)):
        close(t, j)
    close(TM.map_sample_to_cosine_distribution(tr[:, 0], tr[:, 1], tn, td,
                                               1.0),
          JM.map_sample_to_cosine_distribution(jr[:, 0], jr[:, 1], jn, jd,
                                               1.0))
    close(TM.normalize(tp), JM.normalize(jp))
    close(TM.offs_ray_pos(tp, tn, td), JM.offs_ray_pos(jp, jn, jd))
    close(TM.reflect(td, tn), JM.reflect(jd, jn))
    for t, j in zip(TM.sphere_map_to_2d_tex_coord(td),
                    JM.sphere_map_to_2d_tex_coord(jd)):
        close(t, j)
    for t, j in zip(TM.tex_coord_2d_to_sphere_map(tr),
                    JM.tex_coord_2d_to_sphere_map(jr)):
        close(t, j)
    a = rng.uniform(-1, 3, N).astype(np.float32)
    a[::7] = np.inf
    b = rng.uniform(0, 3, N).astype(np.float32)
    (ta, ja), (tb, jb) = both(a), both(b)
    close(TM.mis_weight_heuristic(ta, tb), JM.mis_weight_heuristic(ja, jb))
    close(TM.pdf_a_to_w(tb, tb, ta), JM.pdf_a_to_w(jb, jb, ja))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    (tm, jm) = both(m)
    for t, j in zip(TM.transform_ray3f(tm, tp, td),
                    JM.transform_ray3f(jm, jp, jd)):
        close(t, j, rtol=1e-4, atol=1e-4)
    proj_inv = np.linalg.inv(JM.perspective_matrix(60.0, 2.0, 0.1, 1000.0))
    close(TM.eye_ray_dir_normalized(tr[:, 0], tr[:, 1],
                                    torch.from_numpy(proj_inv)),
          JM.eye_ray_dir_normalized(jr[:, 0], jr[:, 1], jnp.asarray(proj_inv)))
    np.testing.assert_array_equal(
        TM.look_at((1., 2., 3.), (0., 4., 0.), (0., 1., 0.)),
        JM.look_at((1., 2., 3.), (0., 4., 0.), (0., 1., 0.)))
    rows = rng.normal(size=(2, N, 4)).astype(np.float32)
    (t0, j0), (t1, j1) = both(rows[0]), both(rows[1])
    close(TM.mul_rows_2x4(t0, t1, tr), JM.mul_rows_2x4(j0, j1, jr))


@pytest.mark.parametrize('quad', [True, False])
def test_texture_sample(quad):
    rng = np.random.default_rng(2)
    jb, tb = JT.TexturePoolBuilder(), TT.TexturePoolBuilder()
    modes = [(JT.FILTER_LINEAR, JT.ADDR_WRAP, JT.ADDR_WRAP),
             (JT.FILTER_LINEAR, JT.ADDR_CLAMP, JT.ADDR_WRAP),
             (JT.FILTER_NEAREST, JT.ADDR_WRAP, JT.ADDR_CLAMP),
             (JT.FILTER_LINEAR, JT.ADDR_MIRROR, JT.ADDR_MIRROR),
             (JT.FILTER_NEAREST, JT.ADDR_MIRROR, JT.ADDR_WRAP)]
    for k, (f, au, av) in enumerate(modes):
        img = rng.random((5 + k, 7 + 2 * k, 4)).astype(np.float32)
        assert jb.add(img, f, au, av) == tb.add(img, f, au, av)
    jpool = jb.finish(quad_pack_max_texels=(1 << 26) if quad else 0)
    tpool = tb.finish('cpu')
    ids = rng.integers(0, len(modes) + 1, N)
    uv = rng.uniform(-2.5, 2.5, (N, 2)).astype(np.float32)
    close(TT.sample(tpool, torch.from_numpy(ids), torch.from_numpy(uv)),
          JT.sample(jpool, jnp.asarray(ids), jnp.asarray(uv)))


def test_srgb_decode_matches_chunk_decode(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (9, 11, 4)).astype(np.uint8)
    path = tmp_path / 'tex.image4ub'
    path.write_bytes(np.array([11, 9], '<i4').tobytes() + img.tobytes())
    j = JT.decode_chunk(str(path), 11, 9, 4, 8, True)
    np.testing.assert_allclose(TT.decode_image(img), j, rtol=0,
                               atol=1e-6)


def _random_gltf(rng):
    """Random GLTF rows: lambert, metal, coat and plastic lobes, smooth
    (glossiness 1) or rough >= 0.4, viewed at cos >= 0.3.  Sharper GGX
    peaks and grazing views amplify ulp-level direction differences past
    the bound."""
    cflags = rng.choice([1, 4, 1 | 2, 1 | 4], N).astype(np.uint32)
    colors = rng.random((N, 4, 4)).astype(np.float32)
    data = np.zeros((N, 16), np.float32)
    data[:, TB.GLTF_FLOAT_MI_FDR_INT] = rng.uniform(0, 0.9, N)
    data[:, TB.GLTF_FLOAT_ALPHA] = rng.random(N)
    data[:, TB.GLTF_FLOAT_GLOSINESS] = np.where(rng.random(N) < 0.3, 1.0,
                                                rng.uniform(0.1, 0.6, N))
    data[:, TB.GLTF_FLOAT_REFL_COAT] = np.where(rng.random(N) < 0.5, 0.0,
                                                rng.random(N))
    data[:, TB.GLTF_FLOAT_IOR] = np.where(rng.random(N) < 0.5, 0.0, 1.5)
    n = unit(rng, N)
    v = unit(rng, N)
    v = np.where((np.sum(v * n, -1) < 0)[:, None], -v, v)
    v = v + np.maximum(0.3 - np.sum(v * n, -1), 0.0)[:, None] * 1.5 * n
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return dict(cflags=cflags, colors=colors, data=data), n, v


def test_gltf_sample_and_eval():
    rng = np.random.default_rng(4)
    md, n, v = _random_gltf(rng)
    rands = rng.random((N, 4)).astype(np.float32)
    base = rng.random((N, 4)).astype(np.float32)
    four = np.ones((N, 4), np.float32)
    l = unit(rng, N)
    jmd = {k: jnp.asarray(a) for k, a in md.items()}
    tmd = dict(cflags=torch.from_numpy(md['cflags'].astype(np.int64)),
               colors=torch.from_numpy(md['colors']),
               data=torch.from_numpy(md['data']))
    args = [rands, v, n, base, four]
    js = JG.sample_and_eval(jmd, *(jnp.asarray(a) for a in args))
    ts = TG.sample_and_eval(tmd, *(torch.from_numpy(a) for a in args))
    for k in ('val', 'dir', 'pdf'):
        close(ts[k], js[k], err_msg=k)
    np.testing.assert_array_equal(ts['flags'].numpy(), np.asarray(js['flags']))
    args = [l, v, n, base, four]
    je = JG.eval(jmd, *(jnp.asarray(a) for a in args))
    te = TG.eval(tmd, *(torch.from_numpy(a) for a in args))
    for k in ('val', 'pdf'):
        close(te[k], je[k], err_msg=k)


@pytest.fixture(scope='module')
def city(tmp_path_factory):
    return (jax_city(tmp_path_factory),
            tsynth.city_scene(**CITY_KW, device='cpu'))


def test_material_dispatch(city):
    (jscene, jmeta), (tscene, tmeta) = city
    rng = np.random.default_rng(5)
    mat_id = rng.integers(0, tmeta.num_materials, N)
    n, v, l = unit(rng, N), unit(rng, N), unit(rng, N)
    tang = unit(rng, N)
    uv = rng.uniform(-20, 20, (N, 2)).astype(np.float32)
    live = rng.random(N) < 0.8
    pix = np.arange(N, dtype=np.int32)
    jctx = JD.make_shading_ctx(jscene, jmeta, jnp.asarray(mat_id),
                               jnp.asarray(n), jnp.asarray(tang),
                               jnp.asarray(uv))
    tctx = TD.make_shading_ctx(tscene, tmeta, torch.from_numpy(mat_id),
                               torch.from_numpy(n), torch.from_numpy(tang),
                               torch.from_numpy(uv))
    close(tctx['tex_color'], jctx['tex_color'])
    zeros4 = jnp.zeros((N, 4), jnp.float32)
    js, jr, _ = JD.material_sample_and_eval(
        jscene, jmeta, jnp.asarray(mat_id), zeros4,
        JRNG.gen_init(jnp.asarray(pix)), jnp.asarray(live), jnp.asarray(v),
        jnp.asarray(n), jnp.asarray(tang), jnp.asarray(uv),
        jnp.ones(N, jnp.float32), jnp.zeros(N, jnp.uint32), ctx=jctx)
    ts, tr = TD.material_sample_and_eval(
        tctx, TRNG.gen_init(torch.from_numpy(pix)), torch.from_numpy(live),
        torch.from_numpy(v))
    np.testing.assert_array_equal(tr.numpy().astype(np.uint32),
                                  np.asarray(jr))
    for k in ('val', 'dir', 'pdf'):
        close(ts[k], js[k], err_msg=k)
    np.testing.assert_array_equal(ts['flags'].numpy(), np.asarray(js['flags']))
    je = JD.material_eval(jscene, jmeta, jnp.asarray(mat_id), zeros4,
                          jnp.asarray(l), jnp.asarray(v), jnp.asarray(n),
                          jnp.asarray(tang), jnp.asarray(uv), ctx=jctx)
    te = TD.material_eval(tctx, torch.from_numpy(l), torch.from_numpy(v))
    for k in ('val', 'pdf'):
        close(te[k], je[k], err_msg=k)


def test_lights(city):
    (jscene, jmeta), (tscene, tmeta) = city
    rng = np.random.default_rng(6)
    lid = rng.integers(0, tmeta.num_lights, N)
    rands = rng.random((N, 3)).astype(np.float32)
    pt = rng.uniform(-30, 30, (N, 3)).astype(np.float32)
    d = unit(rng, N)
    (tl, jl), (trd, jrd), (tp, jp), (td, jd) = map(both, (lid, rands, pt, d))
    js = JL.light_sample_rev(jscene, jmeta, jl, jrd, jp)
    ts = TL.light_sample_rev(tscene, tmeta, tl, trd, tp)
    for k in ('pos', 'norm', 'pdf'):
        close(ts[k], js[k], rtol=RTOL, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(ts['is_omni'].numpy(),
                                  np.asarray(js['is_omni']))
    assert TL.light_pdf_select_rev(tmeta) == JL.light_pdf_select_rev(jmeta)
    close(TL.light_eval_pdf(tscene, tmeta, tl, tp, td, ts['pos'],
                            ts['norm'], ts['pdf']),
          JL.light_eval_pdf(jscene, jmeta, jl, jp, jd, js['pos'], js['norm'],
                            js['pdf']))
    close(TL.light_intensity(tscene, tmeta, tl, td),
          JL.light_intensity(jscene, jmeta, jl, jnp.zeros((N, 4)), jp, jd))
    for t, j in zip(TL.environment_color(tscene, tmeta, td, True),
                    JL.environment_color(jscene, jmeta, jd,
                                         jnp.zeros((N, 4)), True)):
        close(t, j)
