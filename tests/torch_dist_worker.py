"""One rank of a ``parallel/mesh.py`` job, for the port's tests (no JAX).

    python tests/torch_dist_worker.py '<json>'

The JSON names the job (``render``: ``render_sharded`` of a library at
each listed size, then ``scaling_report``; ``train``: one
``sharded_train_step`` on the DR box), the library's path, the rank and
the world size, the device and backend, the store file the ranks meet
through (``file://``) and the ``.npz`` the rank writes its results to.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))

from hydracore3_torch.models import dr as TDR  # noqa: E402
from hydracore3_torch.ops import rng as TRNG  # noqa: E402
from hydracore3_torch.parallel import mesh as M  # noqa: E402
from hydracore3_torch.scene import build as TB  # noqa: E402


def dr_inputs(n, size, seed=1):
    """The DR tests' seeded parameters [size, 4] and reference [n, 3]."""
    rs = np.random.default_rng(seed)
    params = rs.uniform(0.2, 1.0, (size, 4)).astype(np.float32)
    ref = rs.uniform(0.0, 0.5, (n, 3)).astype(np.float32)
    return params, ref


def dr_loss_fn(meta, setup):
    """``sharded_train_step``'s local loss: ``dr.pixel_loss``'s sum."""
    def loss_fn(params, scene, rng_state, pixel_ids, ref):
        return TDR.pixel_loss(params, scene, meta, setup, rng_state,
                              pixel_ids, ref)[0]
    return loss_fn


def run_ranks(job: dict, world_size: int, work_dir: str,
              timeout: float = 300.0) -> list:
    """Run ``job`` as ``world_size`` rank processes meeting through a store
    file in ``work_dir``; each process has its own ``timeout``, after which
    every rank is killed and the call raises.  Returns each rank's
    results (a dict of arrays)."""
    store = os.path.join(work_dir, f'store_{job["mode"]}_{world_size}')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs, outs = [], []
    for r in range(world_size):
        out = os.path.join(work_dir, f'{job["mode"]}_{world_size}_{r}.npz')
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), json.dumps(dict(
                job, rank=r, world_size=world_size, store=store, out=out))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f'rank {r} exited {p.returncode}:\n'
                               + (logs[r] if r < len(logs) else ''))
    return [dict(np.load(o)) for o in outs]


def main(job):
    torch.set_num_threads(1)
    mesh = M.init_distributed(
        device=job['device'], init_method='file://' + job['store'],
        world_size=job['world_size'], rank=job['rank'],
        backend=job.get('backend'))
    out = {}
    if job['mode'] == 'render':
        for w, h in job['sizes']:
            scene, meta = TB.load_scene(job['library'], width=w, height=h,
                                        device=job['device'])
            out[f'img_{w}x{h}'] = M.render_sharded(
                mesh, scene, meta, spp=job['spp'],
                tile_size=job.get('tile_size', 1 << 20))
        if job.get('scaling'):
            rows = M.scaling_report(mesh, scene, meta, spp=1)
            out['scaling'] = np.array(json.dumps(rows))
    else:
        scene, meta = TB.load_scene(job['library'], device=job['device'])
        setup = TDR.put_diff_tex(scene, job['slot'])
        n = meta.width * meta.height
        params, ref = dr_inputs(n, setup.size)
        dev = torch.device(job['device'])
        pix = torch.arange(n, device=dev)
        step = M.sharded_train_step(mesh, scene, meta,
                                    dr_loss_fn(meta, setup))
        loss, grad = step(torch.from_numpy(params).to(dev),
                          TRNG.gen_init(pix), pix,
                          torch.from_numpy(ref).to(dev))
        out['loss'] = loss.cpu().numpy()
        out['grad'] = grad.cpu().numpy()
    np.savez(job['out'], **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main(json.loads(sys.argv[1]))
