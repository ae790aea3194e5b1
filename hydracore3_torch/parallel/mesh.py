"""Data parallelism over ``torch.distributed``: one process per device.

The counterpart of ``hydracore3_tpu/parallel/mesh.py`` (SURVEY.md 2.5).
The workload is pure data parallelism over pixels: every rank holds the
whole scene, renders one contiguous stripe of the frame through the
batched route (``render._one_sample``: the scene class's ray-query kernels
on the card, never the megakernel, as JAX's sharded path is its
``_render_tile``), and the stripes are gathered at the end.  The RNG is
keyed by pixel id (``gen_init(pixel_ids)``), so the image is bit for bit
the same for any world size.  The differentiable step runs each rank's
loss and gradient on its stripe with ``torch.autograd`` and all-reduces
both (a SUM, then a division by the world size: gloo has no AVG).

A ``Mesh`` is the JAX mesh's 1-D ``data`` axis: a process group (None
when no group is started: a world of one), the rank in it, its size and
the rank's device.  ``init_distributed`` reads torchrun's variables
(``torchrun --nproc_per_node=N script.py``): the backend is NCCL on the
card and gloo on the CPU; without the variables it starts nothing and
returns a world of one.  Nothing falls back: an NCCL that fails to start
raises.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import render as R
from ..models import integrator_pt as IPT
from ..ops import rng as RNG

DATA_AXIS = 'data'
ENV_VARS = ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK')


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``data`` axis: ``group`` (None: the default group, or a world of
    one when no group is started), this process's ``rank`` in it, its
    ``world_size`` and the rank's ``device``."""
    group: object
    rank: int
    world_size: int
    device: torch.device

    @property
    def backend(self):
        """'nccl', 'gloo', or None for a world of one without a group."""
        if not dist.is_initialized():
            return None
        return dist.get_backend(self.group)


def _device(device):
    """``device`` (a card without an index: the current one), or the card
    of this process's ``LOCAL_RANK``; raises without a card."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError('parallel.mesh: no CUDA card (pass device=\'cpu\' '
                           'to run on the CPU)')
    return torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0')))


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (None: the default group) on ``device`` (None:
    the card of ``LOCAL_RANK``).  Without a started process group it is a
    world of one."""
    dev = _device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError('make_mesh: a group was given, but no process '
                             'group is started')
        return Mesh(None, 0, 1, dev)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev)


def init_distributed(device=None, init_method=None, world_size=None,
                     rank=None, backend=None) -> Mesh:
    """Start the default process group from torchrun's variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``) or from ``init_method`` (``'file://...'``, with
    ``world_size`` and ``rank``), and return its mesh.  The device
    defaults to ``cuda:LOCAL_RANK`` and raises without a card; the backend
    to NCCL on the card and gloo for ``device='cpu'``.  With neither the
    variables nor ``init_method`` it starts nothing and returns a world of
    one, as the JAX function returns the local mesh."""
    dev = _device(device)
    if init_method is None and not any(os.environ.get(k) for k in ENV_VARS):
        return make_mesh(device=dev)
    if not dist.is_initialized():
        if backend is None:
            backend = 'nccl' if dev.type == 'cuda' else 'gloo'
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        ws = world_size if world_size is not None else int(
            os.environ.get('WORLD_SIZE', '1'))
        rk = rank if rank is not None else int(os.environ.get('RANK', '0'))
        dist.init_process_group(backend, init_method=init_method or 'env://',
                                world_size=ws, rank=rk)
    return make_mesh(device=dev)


def _collective_tensor(mesh: Mesh, x):
    """``x`` where the mesh's backend takes it: on the card for NCCL, a host
    copy for gloo."""
    backend = mesh.backend
    if backend == 'nccl':
        return x.to(mesh.device)
    if backend == 'gloo':
        return x.cpu()
    raise ValueError(f'parallel.mesh: backend {backend!r} (nccl, gloo)')


def _all_gather(mesh: Mesh, x):
    """The ranks' ``x`` [n, ...] concatenated in rank order, on x's device."""
    if mesh.world_size == 1:
        return x
    y = _collective_tensor(mesh, x.contiguous())
    out = [torch.empty_like(y) for _ in range(mesh.world_size)]
    dist.all_gather(out, y, group=mesh.group)
    return torch.cat(out).to(x.device)


def _all_reduce(mesh: Mesh, x, op=dist.ReduceOp.SUM):
    """``x`` reduced over the ranks by ``op``, on x's device."""
    if mesh.world_size == 1:
        return x
    y = _collective_tensor(mesh, x.detach().clone())
    dist.all_reduce(y, op=op, group=mesh.group)
    return y.to(x.device)


def _mean(mesh: Mesh, x):
    """The ranks' mean of ``x``: a SUM, then a division by the world size."""
    if mesh.world_size == 1:
        return x
    return _all_reduce(mesh, x) / mesh.world_size


def sharded_render_tile(scene, meta, rng_state, pixel_ids, itype: int,
                        layer: int = IPT.FB_COLOR, channels: int = 4,
                        n_iters: int = 1):
    """``n_iters`` samples of the lanes ``pixel_ids`` (JAX
    ``render._render_tile``): each pass of ``render._one_sample`` added to a
    framebuffer that starts at zero.  Returns (framebuffer sum [N,
    channels], rng)."""
    fb = torch.zeros(pixel_ids.shape + (channels,), dtype=torch.float32,
                     device=pixel_ids.device)
    for _ in range(n_iters):
        contrib, rng_state, _ = R._one_sample(scene, meta, rng_state,
                                              pixel_ids, itype, channels,
                                              layer)
        fb = fb + contrib
    return fb, rng_state


def _stripe(mesh: Mesh, n: int):
    """The lanes [lo, hi) of ``n`` (a multiple of the world size) this
    rank owns."""
    per = n // mesh.world_size
    return mesh.rank * per, (mesh.rank + 1) * per


def render_sharded(mesh: Mesh, scene, meta, spp: int,
                   integrator: str = 'mispt', channels: int = 4,
                   tile_size: int = 1 << 20):
    """A full frame over the mesh: float32 numpy [H, W, channels],
    normalized, the same on every rank.  The N pixels are padded to a
    multiple of the world size with the pixel ids that follow them; rank r
    renders its contiguous stripe in tiles of at most ``tile_size`` lanes,
    each lane's RNG ``gen_init`` of its pixel id, and the stripes are
    gathered."""
    if integrator not in IPT.INTEGRATOR_BY_NAME:
        raise NotImplementedError(f'integrator={integrator!r} is not ported')
    itype = IPT.INTEGRATOR_BY_NAME[integrator]
    dev = scene.proj_inv.device
    if dev != mesh.device:
        raise ValueError(f'render_sharded: the scene is on {dev}, the '
                         f'mesh\'s rank on {mesh.device}')
    W, H = meta.width, meta.height
    N = W * H
    lo, hi = _stripe(mesh, N + (-N) % mesh.world_size)
    pixel_ids = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    rng = RNG.gen_init(pixel_ids)
    parts = [sharded_render_tile(scene, meta, rng[s:s + tile_size],
                                 pixel_ids[s:s + tile_size], itype,
                                 IPT.FB_COLOR, channels, int(spp))[0]
             for s in range(0, hi - lo, tile_size)]
    fb = _all_gather(mesh, torch.cat(parts))
    img = fb[:N].cpu().numpy() / np.float32(spp)
    return img.reshape(H, W, channels)


def _subgroup(mesh: Mesh, n: int):
    """The mesh of the first ``n`` ranks (None on the others); every rank
    of ``mesh`` must call it, as ``dist.new_group`` requires."""
    if n == mesh.world_size:
        return mesh
    ranks = [dist.get_global_rank(mesh.group or dist.group.WORLD, i)
             for i in range(n)]
    group = dist.new_group(ranks)
    if mesh.rank >= n:
        return None
    return Mesh(group, mesh.rank, n, mesh.device)


def scaling_report(mesh: Mesh, scene, meta, spp: int = 4, world_sizes=None):
    """Weak scaling (JAX ``scaling_report``): the first n ranks render the
    frame at n x spp, so each rank's work stays the same; a warm-up, then
    the least of three timed renders, the slowest rank's.  Rows
    dict(devices, msamples_s, weak_efficiency = thr_n / (thr_1 n),
    overhead_efficiency = thr_n / thr_1), the same on every rank.  Ranks
    that share a device or the host's cores make the weak efficiency
    meaningless; the overhead efficiency then says what sharding cost."""
    if world_sizes is None:
        world_sizes = [n for n in (1, 2, 4, 8, 16, 32)
                       if n <= mesh.world_size]
    rows, base = [], None
    for n in world_sizes:
        if not 1 <= n <= mesh.world_size:
            raise ValueError(f'scaling_report: {n} ranks of '
                             f'{mesh.world_size}')
        sub = _subgroup(mesh, n)
        spp_n = spp * n
        dt = 0.0
        if sub is not None:
            render_sharded(sub, scene, meta, spp_n)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                render_sharded(sub, scene, meta, spp_n)
                times.append(time.perf_counter() - t0)
            dt = min(times)
        dt = float(_all_reduce(mesh, torch.tensor([dt], dtype=torch.float64),
                               dist.ReduceOp.MAX)[0])
        thr = meta.width * meta.height * spp_n / dt / 1e6
        base = thr if base is None else base
        rows.append(dict(devices=n, msamples_s=thr,
                         weak_efficiency=thr / (base * n),
                         overhead_efficiency=thr / base))
    return rows


def sharded_train_step(mesh: Mesh, scene, meta, loss_fn):
    """The data-parallel differentiable step (JAX ``sharded_train_step``).

    ``loss_fn(params, scene, rng_state, pixel_ids, ref) -> scalar`` is a
    rank's local loss (for example ``models.dr.pixel_loss``'s first
    output).  Returns ``step(params, rng_state, pixel_ids, ref) -> (loss,
    grads)``: each rank takes its stripe of ``rng_state``, ``pixel_ids``
    and ``ref`` (their length a multiple of the world size), computes its
    loss and gradient with ``torch.autograd``, and the loss and the
    gradient are the ranks' means."""
    def step(params, rng_state, pixel_ids, ref):
        n = pixel_ids.shape[0]
        if n % mesh.world_size:
            raise ValueError(f'sharded_train_step: {n} lanes over '
                             f'{mesh.world_size} ranks')
        lo, hi = _stripe(mesh, n)
        p = params.detach().requires_grad_()
        with torch.enable_grad():
            loss = loss_fn(p, scene, rng_state[lo:hi], pixel_ids[lo:hi],
                           ref[lo:hi])
            g = (torch.autograd.grad(loss, p, allow_unused=True)[0]
                 if loss.requires_grad else None)
        g = torch.zeros_like(p) if g is None else g
        return _mean(mesh, loss.detach()), _mean(mesh, g)

    return step
