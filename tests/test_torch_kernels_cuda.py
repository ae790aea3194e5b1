"""The CUDA kernels against their plain torch version, on the card.

Run on a machine with a CUDA card: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py -q`` (this file imports nothing of JAX, and
``--noconftest`` skips tests/conftest.py, which does).  Without a card every
test skips (the check happens inside the ``cuda`` fixture, never at
import).  Agreement bar:
hit masks equal on >= 99.9% of rays, t within rtol 2e-4 where both hit
(nvcc contracts the Woop arithmetic into FMAs, so equal-t ties and
knife-edge lanes may differ).
"""
import numpy as np
import pytest
import torch

from hydracore3_torch.accel import build_bvh as TB
from hydracore3_torch.accel import traverse_dda as TTD
from hydracore3_torch.accel import traverse_stream as TTS

pytestmark = pytest.mark.cuda

# tests/test_big_scene.py's small city, textured
CITY_KW = dict(n_blocks=4, subdiv=1, seed=3, width=32, height=16, depth=2,
               ground_subdiv=8, textured=True)


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
    bvh = TB.build(v0, e1, e2, max_leaf=TTS.TBK)
    o = bvh.order
    nf, ni, woop, op = TTS.pack_stream_bvh(bvh, v0[o], e1[o], e2[o])
    return nf, ni, woop, op, TTD.pack_grid(nf, ni)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _agree(kernel, plain):
    kt, ktri = kernel[0].cpu().numpy(), kernel[1].cpu().numpy()
    pt, ptri = plain[0].cpu().numpy(), plain[1].cpu().numpy()
    kh, ph = ktri >= 0, ptri >= 0
    both = kh & ph
    t_ok = np.isclose(kt[both], pt[both], rtol=2e-4, atol=1e-5)
    return (kh == ph).mean(), (t_ok.mean() if both.any() else 1.0), both


def _soup(cuda, seed=31, n_tris=1500, n_rays=4096):
    rng = np.random.default_rng(seed)
    nf, ni, woop, _, grid = port_pack(*random_scene(rng, n_tris))
    pos, d = random_rays(rng, n_rays)
    dev = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    return (dev(nf), dev(ni), dev(woop), grid.to(cuda), dev(pos), dev(d))


@pytest.mark.parametrize('any_hit', [False, True])
def test_stream_kernel_matches_plain(cuda, any_hit):
    nf, ni, woop, _, pos, d = _soup(cuda)
    n = pos.shape[0]
    tmin = torch.zeros(n, device=cuda)
    tmax = torch.full((n,), 4.0 if any_hit else 1e30, device=cuda)
    before = TTS.intersect_stream.launches
    k = TTS.intersect_stream(nf, ni, woop, pos, d, tmin, tmax, any_hit)
    torch.cuda.synchronize()
    assert TTS.intersect_stream.launches == before + 1
    p = TTS.intersect_plain(woop, pos, d, tmin, torch.clamp(
        tmax, max=0.99 * TTS.FLT_MAX), any_hit)
    hit_eq, t_eq, both = _agree(k, p)
    assert hit_eq >= 0.999 and t_eq >= 0.999, (hit_eq, t_eq)
    assert both.any()
    if any_hit:
        assert (k[0].cpu().numpy()[both] == 0.0).all()


def test_march_kernel_matches_plain(cuda):
    _, _, woop, grid, pos, d = _soup(cuda, seed=9, n_tris=1200)
    n = pos.shape[0]
    # a third of the rays start exactly on interior cell faces in x, where
    # rounding can put the face just behind the origin
    m = n // 3
    k = torch.randint(1, grid.dims[0], (m,), device=cuda)
    pos[:m, 0] = (grid.lo[0] + k * grid.h[0]).float()
    tmin = torch.zeros(n, device=cuda)
    tmax = torch.full((n,), 1e30, device=cuda)
    before = TTD.intersect_march.launches
    *k, un = TTD.intersect_march(grid, woop, pos, d, tmin, tmax,
                                 with_unresolved=True)
    torch.cuda.synchronize()
    assert TTD.intersect_march.launches == before + 1
    assert int(un.sum()) == 0
    p = TTS.intersect_plain(woop, pos, d, tmin,
                            torch.clamp(tmax, max=0.99 * TTS.FLT_MAX))
    hit_eq, t_eq, _ = _agree(k, p)
    assert hit_eq >= 0.999 and t_eq >= 0.999, (hit_eq, t_eq)


def test_slice_on_card_matches_cpu(cuda):
    """One trace pass of the small city on the card (through both kernels)
    against the same pass on the CPU (plain versions)."""
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import synth
    out = []
    for dev in ('cpu', cuda):
        scene, meta = synth.city_scene(**dict(CITY_KW, device=dev))
        pix = torch.arange(meta.width * meta.height, device=dev)
        n_s = TTS.intersect_stream.launches
        n_m = TTD.intersect_march.launches
        acc, fl, _ = IPT.trace_pass(scene, meta, RNG.gen_init(pix), pix)
        if dev is cuda:
            assert TTS.intersect_stream.launches > n_s
            assert TTD.intersect_march.launches > n_m
        out.append((acc.cpu().numpy(), fl.cpu().numpy()))
    (a_cpu, f_cpu), (a_gpu, f_gpu) = out
    assert np.isfinite(a_gpu).all()
    close = np.isclose(a_gpu, a_cpu, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() >= 0.995
    assert (f_gpu == f_cpu).mean() >= 0.999


def test_wrappers_refuse_wrong_inputs(cuda):
    nf, ni, woop, grid, pos, d = _soup(cuda, n_rays=128)
    tmin = torch.zeros(128, device=cuda)
    tmax = torch.full((128,), 1e30, device=cuda)
    with pytest.raises(ValueError):
        TTS.intersect_stream(nf, ni.long(), woop, pos, d, tmin, tmax)
    with pytest.raises(ValueError):
        TTS.intersect_stream(nf.cpu(), ni, woop, pos, d, tmin, tmax)
    with pytest.raises(ValueError):
        TTD.intersect_march(grid, woop.double(), pos, d, tmin, tmax)
