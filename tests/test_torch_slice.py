"""The MIS slice, end to end, against the JAX package on the small city.

JAX traces its committed scene with ``use_stream=False, use_bvh=False``:
the same padded soup order, an XLA brute-force trace and no Pallas (the
trick of tests/test_big_scene.py).  The port runs its own build through
its own path (grid march + BVH walk plain versions on the CPU).  Same
per-pixel RNG, so one pass must agree lane by lane: accum within rtol/atol
1e-3 on >= 99.5% of lanes, flags and RNG state equal on >= 99.9% (the rest
are knife-edge hits, Woop vs Moller-Trumbore), and a 4-spp render at
>= 45 dB PSNR.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu import render as JRENDER
from hydracore3_tpu.models import integrator_pt as JIPT
from hydracore3_tpu.ops import rng as JRNG
from hydracore3_torch import render as TRENDER
from hydracore3_torch.models import integrator_pt as TIPT
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.scene import synth as tsynth
from test_torch_scene import CITY_KW, jax_city


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    jscene, jmeta = jax_city(tmp_path_factory)
    jmeta_brute = dataclasses.replace(jmeta, use_stream=False, use_bvh=False)
    return (jscene, jmeta_brute), tsynth.city_scene(**CITY_KW)


def test_trace_pass_matches_jax(scenes):
    (jscene, jmeta), (tscene, tmeta) = scenes
    N = tmeta.width * tmeta.height
    pix = np.arange(N, dtype=np.int32)

    @jax.jit
    def jpass(r, p):
        acc, _, fl, r2, _ = JIPT.trace_pass(jscene, jmeta, r, p,
                                            JIPT.INTEGRATOR_MIS_PT,
                                            JIPT.FB_COLOR, None)
        return acc, fl, r2

    jp = jnp.asarray(pix)
    j_acc, j_fl, j_rng = (np.asarray(x) for x in jpass(JRNG.gen_init(jp), jp))
    tp = torch.from_numpy(pix).long()
    t_acc, t_fl, t_rng = TIPT.trace_pass(tscene, tmeta, TRNG.gen_init(tp), tp)
    t_acc, t_fl, t_rng = t_acc.numpy(), t_fl.numpy(), t_rng.numpy()

    assert np.isfinite(t_acc).all()
    close = np.isclose(t_acc, j_acc, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.995, f'accum agrees on {close.mean():.4%}'
    flags_eq = t_fl.astype(np.uint32) == j_fl
    assert flags_eq.mean() >= 0.999, f'flags agree on {flags_eq.mean():.4%}'
    rng_eq = (t_rng.astype(np.uint32) == j_rng).all(axis=1)
    assert rng_eq.mean() >= 0.999, f'rng agrees on {rng_eq.mean():.4%}'
    # the pass did real work: most lanes hit something and some light
    assert (t_acc[:, :3].sum(1) > 0).mean() > 0.5


def test_sort_order_is_inverted():
    """The per-bounce sort permutes rows; the pass must return them to
    pixel order (a wrong inverse still looks like a valid image)."""
    scene, meta = tsynth.city_scene(**CITY_KW)
    N = meta.width * meta.height
    pix = torch.arange(N)
    rng = TRNG.gen_init(pix)
    full, _, _ = TIPT.trace_pass(scene, meta, rng, pix)
    # a pass over a reversed batch is the reversed full pass
    rev = torch.flip(pix, [0])
    part, _, _ = TIPT.trace_pass(scene, meta, rng[rev], rev)
    torch.testing.assert_close(part, full[rev], rtol=0, atol=0)


def test_render_psnr_vs_jax(scenes):
    (jscene, jmeta), (tscene, tmeta) = scenes
    spp = 4
    j_img = np.asarray(JRENDER.render(jscene, jmeta, spp=spp,
                                      integrator='mispt'))[..., :3]
    t_img = TRENDER.render(tscene, tmeta, spp=spp,
                           integrator='mispt')[..., :3]
    assert t_img.shape == j_img.shape == (tmeta.height, tmeta.width, 3)
    assert np.isfinite(t_img).all()
    mse = float(np.mean((t_img - j_img) ** 2))
    peak = float(j_img.max())
    psnr = 10.0 * np.log10(peak * peak / max(mse, 1e-20))
    assert psnr >= 45.0, f'PSNR {psnr:.2f} dB'


def test_unported_options_raise(scenes):
    _, (tscene, tmeta) = scenes
    with pytest.raises(NotImplementedError):
        TRENDER.render(tscene, tmeta, spp=1, integrator='naivept')
    with pytest.raises(NotImplementedError):
        TRENDER.render(tscene, tmeta, spp=1, layer='direct')
    with pytest.raises(NotImplementedError):
        tsynth.city_scene(**dict(CITY_KW, textured=False))
