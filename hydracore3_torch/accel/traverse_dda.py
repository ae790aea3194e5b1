"""Nearest-hit by a 3D-DDA march over a uniform grid of the scene clusters.

The counterpart of ``hydracore3_tpu/accel/traverse_dda.py``'s in-kernel
march (``intersect_march``).  The stream BVH's leaf clusters are binned
into a uniform grid over their robust bound; clusters far outside it (the
overhead area light) go to an outlier list tested first.  The output
contract is ``intersect_stream``'s, plus an ``unresolved`` mask for lanes
the march left live at its iteration cap (the CUDA kernel marches every
lane to its end, so the mask is expected to be all zeros).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import traverse_stream as TST

TARGET_CLUSTERS_PER_CELL = 8.0
MAX_DIM = 64            # cells per axis at most
MAX_OUTLIERS = 32       # more far-flung clusters than this: no outlier list


@dataclasses.dataclass(frozen=True)
class GridPack:
    """Grid tables; arrays are numpy on the host, tensors on a device."""
    cell_tab: object   # [NC, 4] i32: (cluster offset, count, skip radius, 0)
    cell_cl: object    # [K, 4] i32: cluster slot per entry (column 0)
    cl_aabb: object    # [C, 8] f32: per-cluster AABB
    cl_count: object   # [C] i32: real triangles per cluster
    outliers: object   # [O, 4] i32: outlier cluster slots (>= 1 row)
    n_outliers: int
    lo: tuple          # grid origin (3 floats)
    h: tuple           # cell size (3 floats)
    dims: tuple        # cells per axis (3 ints)

    def to(self, device) -> 'GridPack':
        t = {k: torch.as_tensor(getattr(self, k), device=device)
             for k in ('cell_tab', 'cell_cl', 'cl_aabb', 'cl_count',
                       'outliers')}
        return dataclasses.replace(self, **t)


def pack_grid(nodes_f: np.ndarray, nodes_i: np.ndarray) -> GridPack:
    """Bin the stream BVH's leaf clusters into a uniform grid (the JAX
    package's ``pack_grid``, the same numpy steps)."""
    leaf = nodes_i[:, 1] >= 0
    lo3 = nodes_f[leaf, 0:3]
    hi3 = nodes_f[leaf, 3:6]
    slot = nodes_i[leaf, 1]
    C = int(slot.max()) + 1 if len(slot) else 1
    cl_aabb = np.zeros((max(C, 1), 8), np.float32)
    cl_aabb[slot, 0:3] = lo3
    cl_aabb[slot, 3:6] = hi3
    cl_count = np.zeros(max(C, 1), np.int32)
    cl_count[slot] = nodes_i[leaf, 2]

    # dense-grid bound from the 2nd-98th percentile of cluster centres,
    # expanded by 35%: far-flung clusters become outliers
    ctr = 0.5 * (lo3 + hi3)
    p_lo = np.percentile(ctr, 2, axis=0)
    p_hi = np.percentile(ctr, 98, axis=0)
    span = np.maximum(p_hi - p_lo, 1e-3)
    r_lo = p_lo - 0.35 * span
    r_hi = p_hi + 0.35 * span
    out_mask = ((ctr < r_lo) | (ctr > r_hi)).any(axis=1)
    if out_mask.sum() > MAX_OUTLIERS:
        out_mask[:] = False
    inl = ~out_mask
    outlier_slots = slot[out_mask]
    lo3_g = lo3[inl] if inl.any() else lo3
    hi3_g = hi3[inl] if inl.any() else hi3

    glo = lo3_g.min(axis=0) - 1e-3
    ghi = hi3_g.max(axis=0) + 1e-3
    ext = np.maximum(ghi - glo, 1e-3)
    n_cells = max(int(C / TARGET_CLUSTERS_PER_CELL), 8)
    hsz = float((ext.prod() / n_cells) ** (1.0 / 3.0))
    dims = np.clip(np.ceil(ext / hsz).astype(np.int64), 1, MAX_DIM)
    h = ext / dims

    ix0 = np.clip(((lo3 - glo) / h).astype(np.int64), 0, dims - 1)
    ix1 = np.clip(((hi3 - glo) / h).astype(np.int64), 0, dims - 1)
    cells: list[list[int]] = [[] for _ in range(int(dims.prod()))]
    dy = int(dims[2])
    dxy = int(dims[1] * dims[2])
    for c in range(len(slot)):
        if out_mask[c]:
            continue
        for x in range(ix0[c, 0], ix1[c, 0] + 1):
            for y in range(ix0[c, 1], ix1[c, 1] + 1):
                for z in range(ix0[c, 2], ix1[c, 2] + 1):
                    cells[x * dxy + y * dy + z].append(int(slot[c]))
    cell_tab = np.zeros((len(cells), 4), np.int32)
    flat: list[int] = []
    for i, cl in enumerate(cells):
        cell_tab[i, 0] = len(flat)
        cell_tab[i, 1] = len(cl)
        flat.extend(cl)
    # empty-space skipping: chebyshev distance to the nearest occupied
    # cell, capped (proximity clouds)
    R_CAP = 15
    occ = (cell_tab[:, 1] > 0).reshape(tuple(int(v) for v in dims))
    dist = np.where(occ, 0, R_CAP).astype(np.int32)
    for _ in range(R_CAP):
        p = np.pad(dist, 1, constant_values=R_CAP)
        view = np.stack([p[1 + a:1 + a + dist.shape[0],
                           1 + b:1 + b + dist.shape[1],
                           1 + c:1 + c + dist.shape[2]]
                         for a in (-1, 0, 1) for b in (-1, 0, 1)
                         for c in (-1, 0, 1)])
        d2 = np.minimum(dist, view.min(axis=0) + 1)
        if (d2 == dist).all():
            break
        dist = d2
    cell_tab[:, 2] = dist.reshape(-1)
    cell_cl = np.zeros((max(len(flat), 1), 4), np.int32)
    cell_cl[:len(flat), 0] = flat
    n_out = int(len(outlier_slots))
    outliers = np.zeros((max(n_out, 1), 4), np.int32)
    outliers[:n_out, 0] = outlier_slots
    return GridPack(cell_tab=cell_tab, cell_cl=cell_cl, cl_aabb=cl_aabb,
                    cl_count=cl_count, outliers=outliers, n_outliers=n_out,
                    lo=tuple(float(v) for v in glo),
                    h=tuple(float(v) for v in h),
                    dims=tuple(int(v) for v in dims))


def intersect_march(grid: GridPack, woop, ray_pos, ray_dir, t_min, t_max,
                    with_unresolved: bool = False):
    """Nearest hit by marching the grid.  Returns (t, tri, u, v) and, with
    ``with_unresolved``, an int32 [N] mask of lanes left live at the cap."""
    t_max = torch.clamp(t_max, max=0.99 * TST.FLT_MAX)
    dev = ray_pos.device
    N = ray_pos.shape[0]
    if dev.type == 'cpu':
        out = TST.intersect_plain(woop, ray_pos, ray_dir, t_min, t_max)
        un = torch.zeros(N, dtype=torch.int32)
        return out + (un,) if with_unresolved else out
    if dev.type != 'cuda':
        raise ValueError(f'intersect_march: unsupported device {dev}')
    TST.build_kernels()
    i32, f32 = torch.int32, torch.float32
    TST.check_cuda_inputs('intersect_march', dict(
        cell_tab=(grid.cell_tab, i32), cell_cl=(grid.cell_cl, i32),
        cl_aabb=(grid.cl_aabb, f32), cl_count=(grid.cl_count, i32),
        outliers=(grid.outliers, i32), woop=(woop, f32)), dev)
    rays = TST.pack_rays(ray_pos, ray_dir, t_min, t_max)
    t = torch.empty(N, dtype=f32, device=dev)
    tri = torch.empty(N, dtype=i32, device=dev)
    u = torch.empty(N, dtype=f32, device=dev)
    v = torch.empty(N, dtype=f32, device=dev)
    un = torch.empty(N, dtype=i32, device=dev)
    d0, d1, d2 = grid.dims
    if N > 0:
        rc = TST._lib.hc3_intersect_march(
            grid.cell_tab.data_ptr(), grid.cell_cl.data_ptr(),
            grid.cl_aabb.data_ptr(), grid.cl_count.data_ptr(),
            grid.outliers.data_ptr(), grid.n_outliers, woop.data_ptr(),
            rays.data_ptr(), N, *grid.lo, *grid.h, d0, d1, d2,
            4 * (d0 + d1 + d2) + 64,
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            un.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        TST.launch_checked('intersect_march', rc)
        intersect_march.launches += 1
    out = (t, tri.to(torch.int64), u, v)
    return out + (un,) if with_unresolved else out


intersect_march.launches = 0
