"""Ray queries over a uniform grid of the scene clusters.

The counterpart of ``hydracore3_tpu/accel/traverse_dda.py``.  The stream
BVH's leaf clusters are binned into a uniform grid over their robust bound;
clusters far outside it (the overhead area light) go to an outlier list.

``intersect_march`` is the in-kernel 3D-DDA march, the renderer's nearest
hit: outliers first, then the march.  Its output contract is
``intersect_stream``'s, plus an ``unresolved`` mask for lanes the march left
live at its iteration cap (the CUDA kernel marches every lane to its end,
so the mask is expected to be all zeros).  On the card
(``csrc/traverse_wide.cuh``, ``intersect_march_kernel``) it reads the grid
tables and ``wide``, the table ``intersect_stream`` walks
(``wide_bvh.pack_wide_stream``): at each cluster whose box a ray enters it
walks that cluster's subtree from ``wide.cl_root[slot]`` near-first,
instead of testing the cluster's 64 rows.

``intersect_dda`` is the older wavefront: the host steps every ray from
cell to cell in rounds, and one kernel launch per round (``cell_pass``)
intersects each live lane with the clusters of the cell it stands in.  No
renderer path calls it; it answers the same query with the same contract
(nearest or any-hit) and needs a grid without outliers
(``pack_grid(..., robust_aabb=False)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import traverse_stream as TST
from . import wide_bvh as WB

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


def pack_grid(nodes_f: np.ndarray, nodes_i: np.ndarray,
              robust_aabb: bool = True) -> GridPack:
    """Bin the stream BVH's leaf clusters into a uniform grid (the JAX
    package's ``pack_grid``, the same numpy steps).  With
    ``robust_aabb=False`` the grid spans every cluster and the outlier list
    stays empty."""
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
    if not robust_aabb or out_mask.sum() > MAX_OUTLIERS:
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
                    with_unresolved: bool = False, wide=None):
    """Nearest hit by marching the grid.  Returns (t, tri, u, v) and, with
    ``with_unresolved``, an int32 [N] mask of lanes left live at the cap.
    ``woop`` is read by the plain version alone; a query on the card reads
    the grid and ``wide`` (``scene.st_wide``) and raises without it."""
    dev = ray_pos.device
    N = ray_pos.shape[0]
    if dev.type == 'cpu':
        out = TST.intersect_plain(woop, ray_pos, ray_dir, t_min,
                                  torch.clamp(t_max, max=TST.T_MAX_CAP))
        un = torch.zeros(N, dtype=torch.int32)
        return out + (un,) if with_unresolved else out
    if dev.type != 'cuda':
        raise ValueError(f'intersect_march: unsupported device {dev}')
    if wide is None or wide.cl_root is None:
        raise ValueError('intersect_march: a query on the card needs '
                         'wide=scene.st_wide (wide_bvh.pack_wide_stream)')
    WB.require_stack('intersect_march', wide.cl_stack, WB.MARCH_STACK)
    lib = TST.kernel_library()
    i32, f32 = torch.int32, torch.float32
    TST.check_cuda_inputs('intersect_march', dict(
        cell_tab=(grid.cell_tab, i32), cell_cl=(grid.cell_cl, i32),
        cl_aabb=(grid.cl_aabb, f32), outliers=(grid.outliers, i32),
        wide_nodes=(wide.nodes, f32), wide_rows=(wide.rows, f32),
        wide_index=(wide.index, i32), wide_cl_root=(wide.cl_root, i32)), dev)
    rays = TST.ray_arrays('intersect_march', ray_pos, ray_dir, t_min, t_max)
    t = torch.empty(N, dtype=f32, device=dev)
    tri = torch.empty(N, dtype=torch.int64, device=dev)
    u = torch.empty(N, dtype=f32, device=dev)
    v = torch.empty(N, dtype=f32, device=dev)
    un = torch.empty(N, dtype=i32, device=dev)
    d0, d1, d2 = grid.dims
    if N > 0:
        rc = lib.hc3_intersect_march(
            grid.cell_tab.data_ptr(), grid.cell_cl.data_ptr(),
            grid.cl_aabb.data_ptr(), grid.outliers.data_ptr(),
            grid.n_outliers, wide.nodes.data_ptr(), wide.rows.data_ptr(),
            wide.index.data_ptr(), wide.cl_root.data_ptr(), wide.cl_stack,
            wide.margin, *(x.data_ptr() for x in rays), TST.T_MAX_CAP, N, *grid.lo,
            *grid.h, d0, d1, d2, 4 * (d0 + d1 + d2) + 64,
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            un.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        TST.launch_checked('intersect_march', rc)
        intersect_march.launches += 1
    out = (t, tri, u, v)
    return out + (un,) if with_unresolved else out


intersect_march.launches = 0


BIG_I = 0x7FFFFFF0       # cell id of an idle lane


def cell_pass_plain(grid: GridPack, woop, ray_pos, ray_dir, t_min, cell,
                    best, any_hit: bool = False):
    """The plain torch version of one round: the lanes of each distinct
    cell against the rows of that cell's clusters, in the cell's cluster
    order, through the dense Woop ``intersect_plain`` with the lane's
    running best t as ``t_max``.  Returns (best, processed)."""
    best_t, best_i, best_u, best_v = (b.clone() for b in best)
    k = torch.arange(TST.TBK, device=woop.device)
    for c in torch.unique(cell[cell < BIG_I]).tolist():
        lanes = torch.nonzero(cell == c).squeeze(1)
        off, cnt = grid.cell_tab[c, 0:2].tolist()
        if cnt == 0:
            continue
        slots = grid.cell_cl[off:off + cnt, 0].to(torch.int64)
        rows = (slots[:, None] * TST.TBK + k).reshape(-1)
        t, i, u, v = TST.intersect_plain(
            woop[rows], ray_pos[lanes], ray_dir[lanes], t_min[lanes],
            best_t[lanes], any_hit)
        hit = i >= 0
        best_t[lanes] = t
        tri = torch.zeros_like(i) if any_hit else rows[i.clamp(min=0)]
        best_i[lanes] = torch.where(hit, tri, best_i[lanes])
        if not any_hit:
            best_u[lanes] = torch.where(hit, u, best_u[lanes])
            best_v[lanes] = torch.where(hit, v, best_v[lanes])
    return (best_t, best_i, best_u, best_v), cell < BIG_I


def cell_pass(grid: GridPack, woop, rays, cell, best, any_hit: bool = False):
    """One round on the card: ``cell_pass_kernel`` updates ``best`` (t f32,
    tri i32, u, v f32) in place for every lane whose ``cell`` (i32) is not
    ``BIG_I``.  Returns the processed mask (bool)."""
    dev = rays.device
    lib = TST.kernel_library()
    i32, f32 = torch.int32, torch.float32
    best_t, best_i, best_u, best_v = best
    TST.check_cuda_inputs('cell_pass', dict(
        cell_tab=(grid.cell_tab, i32), cell_cl=(grid.cell_cl, i32),
        cl_aabb=(grid.cl_aabb, f32), cl_count=(grid.cl_count, i32),
        woop=(woop, f32), rays=(rays, f32), cell=(cell, i32),
        best_t=(best_t, f32), best_i=(best_i, i32), best_u=(best_u, f32),
        best_v=(best_v, f32)), dev)
    N = rays.shape[0]
    processed = torch.empty(N, dtype=i32, device=dev)
    if N > 0:
        rc = lib.hc3_cell_pass(
            grid.cell_tab.data_ptr(), grid.cell_cl.data_ptr(),
            grid.cl_aabb.data_ptr(), grid.cl_count.data_ptr(),
            woop.data_ptr(), rays.data_ptr(), cell.data_ptr(), N,
            int(any_hit), best_t.data_ptr(), best_i.data_ptr(),
            best_u.data_ptr(), best_v.data_ptr(), processed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        TST.launch_checked('cell_pass', rc)
        cell_pass.launches += 1
    return processed != 0


cell_pass.launches = 0


def intersect_dda(grid: GridPack, woop, ray_pos, ray_dir, t_min, t_max,
                  any_hit: bool = False, max_rounds: int = 48,
                  stats: dict = None):
    """Nearest-hit / any-hit by the cell-by-cell wavefront.  Same output
    contract as ``intersect_stream``: (t, tri, u, v), tri the padded
    leaf-order index or -1; under any-hit ``tri >= 0`` flags occlusion.

    A lane enters at the cell holding its entry point into the grid
    (clamped into it) and walks front to back, one cell per round, across
    the nearest exit plane by an integer step, as the march kernel does.
    (The JAX round loop re-locates the cell each round from the point at
    ``t + 1e-4 min(h)``; that drops a hit lying within that step of the
    grid's boundary, such as a shadow ray leaving the ground downward, and
    can stall a ray nearly parallel to a cell face.)  Each round launches
    ``cell_pass`` (the kernel on the card, its plain version on the CPU) and
    retires a lane once its best hit lies before the cell's exit, it is
    occluded (any-hit), or it leaves the grid or its interval.  With one
    ray per thread a lane's cell is always taken whole, so the rays are not
    re-sorted between rounds.
    ``stats``, when given, receives ``rounds``, ``live`` (lanes still live
    when the rounds ran out) and ``kernel_ms`` (the launches' summed time
    by CUDA events; 0 on the CPU)."""
    if grid.n_outliers != 0:
        raise ValueError('intersect_dda has no outlier pass; build the grid '
                         'with robust_aabb=False for it')
    t_max = torch.clamp(t_max, max=0.99 * TST.FLT_MAX)
    dev = ray_pos.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'intersect_dda: unsupported device {dev}')
    on_card = dev.type == 'cuda'
    N = ray_pos.shape[0]
    f32 = torch.float32
    lo = torch.tensor(grid.lo, dtype=f32, device=dev)
    h = torch.tensor(grid.h, dtype=f32, device=dev)
    dims = torch.tensor(grid.dims, dtype=torch.int64, device=dev)
    d1, d2 = grid.dims[1], grid.dims[2]

    straight = ray_dir.abs() > 1e-20
    inv_d = torch.where(straight, 1.0 / ray_dir, 1e30)
    t0 = (lo - ray_pos) * inv_d
    t1 = (lo + h * dims.to(f32) - ray_pos) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    t_cur = torch.maximum(tn, t_min)
    done = (tn > tf) | (tf < t_min) | (t_max <= t_min)
    # the entry cell, clamped into the grid
    p = ray_pos + ray_dir * torch.where(done, 0.0, t_cur)[:, None]
    q = torch.minimum(torch.clamp(torch.floor((p - lo) / h).to(torch.int64),
                                  min=0), dims - 1)
    forward = (ray_dir > 0).to(torch.int64)
    step = forward * 2 - 1

    idx_dtype = torch.int32 if on_card else torch.int64
    best = (t_max.to(f32).clone(),
            torch.full((N,), -1, dtype=idx_dtype, device=dev),
            torch.zeros(N, dtype=f32, device=dev),
            torch.zeros(N, dtype=f32, device=dev))
    rays = TST.pack_rays(ray_pos, ray_dir, t_min, t_max) if on_card else None
    rounds, kernel_ms = 0, 0.0
    while rounds < max_rounds and not bool(done.all()):
        cell = torch.where(done, BIG_I,
                           q[:, 0] * (d1 * d2) + q[:, 1] * d2 + q[:, 2])
        # the exit plane of each axis
        t_axis = torch.where(
            straight, (lo + (q + forward).to(f32) * h - ray_pos) * inv_d,
            1e30)
        t_exit = t_axis.amin(dim=-1)
        if on_card:
            if stats is not None:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            processed = cell_pass(grid, woop, rays, cell.to(torch.int32),
                                  best, any_hit)
            if stats is not None:
                ev1.record()
        else:
            best, processed = cell_pass_plain(grid, woop, ray_pos, ray_dir,
                                              t_min, cell, best, any_hit)
        if any_hit:
            done = done | (best[1] >= 0)
        else:
            done = done | (processed & (best[0] <= t_exit))
        # one integer step across the nearest plane (x before y before z
        # among equal planes, as the march kernel picks)
        axis = torch.where(
            (t_axis[:, 0] <= t_axis[:, 1]) & (t_axis[:, 0] <= t_axis[:, 2]),
            0, torch.where(t_axis[:, 1] <= t_axis[:, 2], 1, 2))
        moved = torch.nn.functional.one_hot(axis, 3) * step
        q = torch.where((processed & ~done)[:, None], q + moved, q)
        t_cur = torch.where(processed & ~done, torch.maximum(t_exit, t_cur),
                            t_cur)
        done = (done | ((q < 0) | (q >= dims)).any(dim=-1)
                | (t_cur >= t_max))
        rounds += 1
        if on_card and stats is not None:
            torch.cuda.synchronize(dev)
            kernel_ms += ev0.elapsed_time(ev1)
    if stats is not None:
        stats.update(rounds=rounds, live=int((~done).sum()),
                     kernel_ms=kernel_ms)
    best_t, best_i, best_u, best_v = best
    return best_t, best_i.to(torch.int64), best_u, best_v
