"""Data parallelism: the port's ``parallel/mesh.py`` against itself across
world sizes and against the JAX package's ``parallel/mesh.py``.

The ranks are separate processes (``tests/torch_dist_worker.py``) on the
gloo backend, meeting through a ``file://`` store in the test's temporary
directory (no port for xdist workers to collide on); each has its own
time limit, so a hung rank fails the test.

* ``render_sharded`` of the textured box (``synth.build_box``, written as a
  library both packages load) at 32 x 24, 2 spp, and at 31 x 23, whose
  713 pixels pad to a multiple of two: two ranks give the one-process
  image bit for bit; that image against JAX ``render_sharded`` on 1 and 2
  of conftest's virtual devices at >= 45 dB (``test_torch_slice``'s bar),
  and one pass lane by lane within rtol/atol 1e-3;
* ``sharded_train_step`` on the DR box (``zoo_scenes.write_dr_box``, 16 x
  12): two ranks equal the single-process mean of the two stripes' loss
  and gradient bit for bit (a SUM of two then a halving is the mean's
  arithmetic), and JAX ``sharded_train_step`` on two virtual devices within
  ``test_torch_dr``'s bars (loss 1e-5 relative, gradient 1e-4 relative
  L2);
* ``scaling_report``'s rows for world sizes 1 and 2 carry JAX's keys (no
  speed ratio is asserted: the ranks share the host's cores);
* ``init_distributed`` without torchrun's variables starts no group and
  returns a world of one, and without a card it raises unless
  ``device='cpu'``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from hydracore3_tpu.models import dr as JDR
from hydracore3_tpu.ops import rng as JRNG
from hydracore3_tpu.parallel import mesh as JM
from hydracore3_tpu.scene import build as JB
from hydracore3_torch import api
from hydracore3_torch.models import dr as TDR
from hydracore3_torch.ops import rng as TRNG
from hydracore3_torch.parallel import mesh as M
from hydracore3_torch.scene import build as TB
from hydracore3_torch.scene import synth as tsynth
import zoo_scenes
from torch_dist_worker import dr_inputs, dr_loss_fn, run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = ((32, 24), (31, 23))
SPP = 2
DR_W, DR_H, DR_DEPTH = 16, 12, 6
LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
ROW_KEYS = {'devices', 'msamples_s', 'weak_efficiency', 'overhead_efficiency'}


def psnr(img, ref):
    mse = float(np.mean((img - ref) ** 2))
    peak = float(ref.max())
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope='module')
def box_lib(tmp_path_factory):
    return api.write_library(tsynth.build_box(*SIZES[0], 3, textured=True),
                             str(tmp_path_factory.mktemp('box')))


@pytest.fixture(scope='module')
def cpu_mesh():
    return M.make_mesh(device='cpu')


@pytest.fixture(scope='module')
def one_process(box_lib, cpu_mesh):
    """The one-process images: {(w, h): image}."""
    out = {}
    for w, h in SIZES:
        scene, meta = TB.load_scene(box_lib, width=w, height=h, device='cpu')
        out[(w, h)] = M.render_sharded(cpu_mesh, scene, meta, spp=SPP)
    return out


@pytest.fixture(scope='module')
def two_ranks(box_lib, tmp_path_factory):
    return run_ranks(dict(mode='render', library=box_lib, device='cpu',
                          sizes=SIZES, spp=SPP, scaling=True), 2,
                     str(tmp_path_factory.mktemp('ranks')))


@pytest.mark.parametrize('size', SIZES, ids=['32x24', '31x23'])
def test_two_gloo_ranks_give_the_one_process_image(two_ranks, one_process,
                                                   size):
    img = one_process[size]
    assert img.shape == (size[1], size[0], 4) and np.isfinite(img).all()
    assert img[..., :3].max() > 0
    for r, res in enumerate(two_ranks):
        np.testing.assert_array_equal(res[f'img_{size[0]}x{size[1]}'], img,
                                      err_msg=f'rank {r}')


def test_tiles_within_a_stripe_change_nothing(box_lib, cpu_mesh, one_process):
    scene, meta = TB.load_scene(box_lib, device='cpu')
    img = M.render_sharded(cpu_mesh, scene, meta, spp=SPP, tile_size=100)
    np.testing.assert_array_equal(img, one_process[SIZES[0]])


@pytest.fixture(scope='module')
def jax_box(box_lib):
    return JB.load_scene(box_lib)


@pytest.mark.parametrize('n_dev', (1, 2))
def test_render_sharded_matches_jax(jax_box, one_process, n_dev):
    if len(jax.devices()) < n_dev:
        pytest.skip(f'needs {n_dev} virtual devices')
    js, jm = jax_box
    j_img = JM.render_sharded(JM.make_mesh(jax.devices()[:n_dev]), js, jm,
                              spp=SPP)
    t_img = one_process[SIZES[0]]
    assert j_img.shape == t_img.shape
    p = psnr(t_img[..., :3], np.asarray(j_img)[..., :3])
    assert p >= 45.0, f'PSNR {p:.2f} dB'


def test_one_pass_lane_by_lane_matches_jax(jax_box, box_lib, cpu_mesh):
    js, jm = jax_box
    j_img = np.asarray(JM.render_sharded(JM.make_mesh(jax.devices()[:1]),
                                         js, jm, spp=1))
    scene, meta = TB.load_scene(box_lib, device='cpu')
    t_img = M.render_sharded(cpu_mesh, scene, meta, spp=1)
    close = np.isclose(t_img, j_img, rtol=1e-3, atol=1e-3).all(-1)
    assert close.mean() == 1.0, f'{close.mean():.4%} of the lanes agree'


@pytest.fixture(scope='module')
def dr_box(tmp_path_factory):
    path = zoo_scenes.write_dr_box(str(tmp_path_factory.mktemp('dr')), DR_W,
                                   DR_H, DR_DEPTH)
    ts, tm = TB.load_scene(path, device='cpu')
    slot = zoo_scenes.dr_tex_slot(ts)
    return path, ts, tm, slot


@pytest.fixture(scope='module')
def train_ranks(dr_box, tmp_path_factory):
    path, _, _, slot = dr_box
    return run_ranks(dict(mode='train', library=path, device='cpu',
                          slot=slot), 2, str(tmp_path_factory.mktemp('dr2')))


def test_sharded_train_step_equals_the_stripes_mean(dr_box, train_ranks):
    _, ts, tm, slot = dr_box
    setup = TDR.put_diff_tex(ts, slot)
    n = tm.width * tm.height
    params, ref = dr_inputs(n, setup.size)
    pix = torch.arange(n)
    rng = TRNG.gen_init(pix)
    loss_fn = dr_loss_fn(tm, setup)
    parts = []
    for lo, hi in ((0, n // 2), (n // 2, n)):
        p = torch.from_numpy(params).requires_grad_()
        loss = loss_fn(p, ts, rng[lo:hi], pix[lo:hi],
                       torch.from_numpy(ref[lo:hi]))
        parts.append((loss.detach(), torch.autograd.grad(loss, p)[0]))
    loss = ((parts[0][0] + parts[1][0]) / 2).numpy()
    grad = ((parts[0][1] + parts[1][1]) / 2).numpy()
    assert np.abs(grad).sum() > 0 and np.isfinite(grad).all()
    for res in train_ranks:
        np.testing.assert_array_equal(res['loss'], loss)
        np.testing.assert_array_equal(res['grad'], grad)
    # a world of one is the whole frame's loss_and_grad
    step = M.sharded_train_step(M.make_mesh(device='cpu'), ts, tm, loss_fn)
    l1, g1 = step(torch.from_numpy(params), rng, pix, torch.from_numpy(ref))
    l2, g2, _, _ = TDR.loss_and_grad(torch.from_numpy(params), ts, tm, setup,
                                     rng, pix, torch.from_numpy(ref))
    assert torch.equal(l1, l2) and torch.equal(g1, g2)


def test_sharded_train_step_matches_jax(dr_box, train_ranks):
    if len(jax.devices()) < 2:
        pytest.skip('needs 2 virtual devices')
    path, _, tm, slot = dr_box
    js, jm = JB.load_scene(path)
    jsetup = JDR.put_diff_tex(js, slot)
    n = tm.width * tm.height
    params, ref = dr_inputs(n, jsetup.size)

    def loss_fn(p, scene, rng, pix, ref_px):
        return JDR.pixel_loss(p, scene, jm, jsetup, rng, pix, ref_px)[0]

    jpix = jnp.arange(n, dtype=jnp.int32)
    step = JM.sharded_train_step(JM.make_mesh(jax.devices()[:2]), js, jm,
                                 loss_fn)
    jl, jg = step(jnp.asarray(params), JRNG.gen_init(jpix), jpix,
                  jnp.asarray(ref))
    tl, tg = train_ranks[0]['loss'], train_ranks[0]['grad']
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert np.abs(np.asarray(jg)).sum() > 0
    assert rel_l2(tg, jg) <= GRAD_RL2


@pytest.mark.parametrize('world', (1, 2))
def test_scaling_report_rows(box_lib, cpu_mesh, two_ranks, world):
    if world == 1:
        scene, meta = TB.load_scene(box_lib, width=SIZES[1][0],
                                    height=SIZES[1][1], device='cpu')
        rows = M.scaling_report(cpu_mesh, scene, meta, spp=1)
        ranks = [rows]
    else:
        ranks = [json.loads(str(r['scaling'])) for r in two_ranks]
    for rows in ranks:
        assert [r['devices'] for r in rows] == list(range(1, world + 1))
        for r in rows:
            assert set(r) == ROW_KEYS
            assert r['msamples_s'] > 0 and np.isfinite(r['weak_efficiency'])
        assert rows[0]['weak_efficiency'] == rows[0][
            'overhead_efficiency'] == 1.0
    assert all(rows == ranks[0] for rows in ranks)


def test_init_distributed_without_the_variables_is_a_world_of_one(
        monkeypatch):
    for k in M.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    mesh = M.init_distributed(device='cpu')
    assert (mesh.group, mesh.rank, mesh.world_size) == (None, 0, 1)
    assert mesh.device == torch.device('cpu') and mesh.backend is None
    assert not dist.is_initialized()


def test_init_distributed_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    for k in M.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        M.init_distributed()
    with pytest.raises(RuntimeError, match='no CUDA card'):
        M.make_mesh()
