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

``intersect_dda`` is the older wavefront: every ray steps from cell to
cell in rounds, one kernel launch a round (``cell_pass``,
``csrc/traverse.cu`` ``cell_pass_kernel``).  A launch visits each live
lane's cell, walking each of the cell's clusters through its subtree of
``wide`` as the march does, then retires the lane or steps it to the next
cell; the lanes' state stays on the card between launches, and the host
reads one count a round.  On the CPU each round is ``cell_pass_plain``.
No renderer path calls it; it answers the same query with the same
contract (nearest or any-hit) and needs a grid without outliers
(``pack_grid(..., robust_aabb=False)``).
"""
from __future__ import annotations

import dataclasses
import typing

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
    outliers: object   # [O, 4] i32: outlier cluster slots (>= 1 row)
    n_outliers: int
    lo: tuple          # grid origin (3 floats)
    h: tuple           # cell size (3 floats)
    dims: tuple        # cells per axis (3 ints)

    def to(self, device) -> 'GridPack':
        t = {k: torch.as_tensor(getattr(self, k), device=device)
             for k in ('cell_tab', 'cell_cl', 'cl_aabb', 'outliers')}
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
                    outliers=outliers, n_outliers=n_out,
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


class DdaState(typing.NamedTuple):
    """What a lane of ``intersect_dda`` carries from round to round; on the
    card it stays there between launches."""
    cell: torch.Tensor    # [N, 3] i32: the grid cell the lane stands in
    t_cur: torch.Tensor   # [N] f32: the t at which it entered that cell
    done: torch.Tensor    # [N] i32: 1 once the lane retired
    best_t: torch.Tensor  # [N] f32: the best hit so far (t_max: none)
    best_i: torch.Tensor  # [N] i64: its padded slot, -1 for none
    best_u: torch.Tensor  # [N] f32
    best_v: torch.Tensor  # [N] f32


def _frame(grid: GridPack, dev):
    """The grid's origin, cell size (f32) and cells per axis (i64)."""
    return (torch.tensor(grid.lo, dtype=torch.float32, device=dev),
            torch.tensor(grid.h, dtype=torch.float32, device=dev),
            torch.tensor(grid.dims, dtype=torch.int64, device=dev))


def _inv_dir(ray_dir):
    return torch.where(ray_dir.abs() > 1e-20, 1.0 / ray_dir, 1e30)


def dda_entry(grid: GridPack, ray_pos, ray_dir, t_min, t_max) -> DdaState:
    """The state before the first round, in plain torch: where each ray
    enters the grid's box (done if it misses it or its interval is empty)
    and the cell holding that point, clamped into the grid.  ``t_max`` must
    already be clamped below the miss sentinel.  The first launch of
    ``cell_pass_kernel`` computes the same, op for op."""
    lo, h, dims = _frame(grid, ray_pos.device)
    inv_d = _inv_dir(ray_dir)
    t0 = (lo - ray_pos) * inv_d
    t1 = (lo + h * dims.to(torch.float32) - ray_pos) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    t_cur = torch.maximum(tn, t_min)
    done = (tn > tf) | (tf < t_min) | (t_max <= t_min)
    p = ray_pos + ray_dir * torch.where(done, 0.0, t_cur)[:, None]
    q = torch.minimum(torch.clamp(torch.floor((p - lo) / h).to(torch.int64),
                                  min=0), dims - 1)
    n = ray_pos.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=ray_pos.device)
    return DdaState(q.to(torch.int32), t_cur, done.to(torch.int32),
                    t_max.to(torch.float32).clone(),
                    torch.full((n,), -1, dtype=torch.int64,
                               device=ray_pos.device), zeros, zeros.clone())


def _visit_plain(grid, woop, ray_pos, ray_dir, t_min, cell, live, best,
                 any_hit):
    """Each live lane against the rows of its cell's clusters, densely:
    nearest takes the lowest t with ``t_min < t <= best t``, the lowest
    padded slot among equal t, and replaces the lane's best when its t is
    lower, or equal with a lower slot; any-hit flags a lane with a hit below
    its best t (t = t_min, tri = 0)."""
    best_t, best_i, best_u, best_v = (b.clone() for b in best)
    k = torch.arange(TST.TBK, device=woop.device)
    for c in torch.unique(cell[live]).tolist():
        off, cnt = grid.cell_tab[c, 0:2].tolist()
        if cnt == 0:
            continue
        lanes = torch.nonzero(live & (cell == c)).squeeze(1)
        slots = grid.cell_cl[off:off + cnt, 0].to(torch.int64).sort().values
        rows = (slots[:, None] * TST.TBK + k).reshape(-1)
        t, u, v = TST.woop_tuv(woop[rows], ray_pos[lanes], ray_dir[lanes])
        bt, bi = best_t[lanes], best_i[lanes]
        tmin = t_min[lanes]
        inside = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t > tmin[:, None]))
        if any_hit:
            occ = (inside & (t < bt[:, None])).any(dim=1)
            best_t[lanes] = torch.where(occ, tmin, bt)
            best_i[lanes] = torch.where(occ, 0, bi)
            continue
        tm = torch.where(inside & (t <= bt[:, None]), t, float('inf'))
        ct = tm.amin(dim=1)
        cols = torch.arange(len(rows), device=woop.device)
        col = torch.where(tm == ct[:, None], cols, len(rows)).amin(
            dim=1).clamp(max=len(rows) - 1)
        ci = rows[col]
        take = (ct < bt) | ((ct == bt) & (bi >= 0) & (ci < bi))
        best_t[lanes] = torch.where(take, ct, bt)
        best_i[lanes] = torch.where(take, ci, bi)
        best_u[lanes] = torch.where(take, u.gather(1, col[:, None])[:, 0],
                                    best_u[lanes])
        best_v[lanes] = torch.where(take, v.gather(1, col[:, None])[:, 0],
                                    best_v[lanes])
    return best_t, best_i, best_u, best_v


def cell_pass_plain(grid: GridPack, woop, ray_pos, ray_dir, t_min, t_max,
                    state: DdaState, any_hit: bool = False) -> DdaState:
    """One round in plain torch, the plain version of one launch of
    ``cell_pass_kernel`` after the first: every live lane's cell against its
    running best (``_visit_plain``, the dense Woop test of the rows of the
    cell's clusters), then the retire rule (nearest: the best t lies at or
    before the cell's exit; any-hit: occluded) and, for a lane that stays,
    one integer step across the nearest exit plane (x before y before z
    among equal planes); a lane retires as well once it leaves the grid or
    its entry t reaches ``t_max`` (clamped).  Returns the new state."""
    lo, h, dims = _frame(grid, ray_pos.device)
    d1, d2 = grid.dims[1], grid.dims[2]
    live = state.done == 0
    q = state.cell.to(torch.int64)
    best_t, best_i, best_u, best_v = _visit_plain(
        grid, woop, ray_pos, ray_dir, t_min, (q[:, 0] * d1 + q[:, 1]) * d2
        + q[:, 2], live, state[3:], any_hit)
    forward = (ray_dir > 0).to(torch.int64)
    t_axis = torch.where(
        ray_dir.abs() > 1e-20,
        (lo + (q + forward).to(torch.float32) * h - ray_pos) * _inv_dir(
            ray_dir), 1e30)
    t_exit = t_axis.amin(dim=-1)
    retire = (best_i >= 0) if any_hit else (best_t <= t_exit)
    go = live & ~retire
    axis = torch.where(
        (t_axis[:, 0] <= t_axis[:, 1]) & (t_axis[:, 0] <= t_axis[:, 2]),
        0, torch.where(t_axis[:, 1] <= t_axis[:, 2], 1, 2))
    moved = torch.nn.functional.one_hot(axis, 3) * (forward * 2 - 1)
    q = torch.where(go[:, None], q + moved, q)
    t_cur = torch.where(go, torch.maximum(t_exit, state.t_cur), state.t_cur)
    done = (~go | ((q < 0) | (q >= dims)).any(dim=-1) | (t_cur >= t_max))
    return DdaState(q.to(torch.int32), t_cur, done.to(torch.int32), best_t,
                    best_i, best_u, best_v)


def cell_pass(grid: GridPack, wide, rays, state: DdaState, n_live,
              any_hit: bool = False, first: bool = False):
    """One launch of ``cell_pass_kernel`` over every lane: advance ``state``
    in place by one round (on the first, write it from the rays:
    ``dda_entry``, then the round); lanes already done return at once.
    ``rays`` are ``ray_arrays``'s (t_max is clamped in the kernel).  The
    kernel adds the lanes still live after the round to ``n_live`` (one i32
    on the card, 0 before the round)."""
    dev = rays[0].device
    N = rays[0].shape[0]
    d0, d1, d2 = grid.dims
    rc = TST.kernel_library().hc3_cell_pass(
        grid.cell_tab.data_ptr(), grid.cell_cl.data_ptr(),
        grid.cl_aabb.data_ptr(), wide.nodes.data_ptr(), wide.rows.data_ptr(),
        wide.index.data_ptr(), wide.cl_root.data_ptr(), wide.cl_stack,
        wide.margin, *(x.data_ptr() for x in rays), TST.T_MAX_CAP, N,
        *grid.lo, *grid.h, d0, d1, d2, int(any_hit), int(first),
        *(x.data_ptr() for x in state), n_live.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    TST.launch_checked('cell_pass', rc)
    if N > 0:
        cell_pass.launches += 1


cell_pass.launches = 0


def _check_card_inputs(grid: GridPack, wide, rays):
    """Refuse what ``cell_pass_kernel`` does not take."""
    if wide is None or wide.cl_root is None:
        raise ValueError('intersect_dda: a query on the card needs '
                         'wide=scene.st_wide (wide_bvh.pack_wide_stream)')
    WB.require_stack('intersect_dda', wide.cl_stack, WB.MARCH_STACK)
    if wide.cl_root.shape[0] != grid.cl_aabb.shape[0]:
        raise ValueError(f'intersect_dda: the grid has '
                         f'{grid.cl_aabb.shape[0]} clusters, wide.cl_root '
                         f'{wide.cl_root.shape[0]}')
    i32, f32 = torch.int32, torch.float32
    TST.check_cuda_inputs('intersect_dda', dict(
        cell_tab=(grid.cell_tab, i32), cell_cl=(grid.cell_cl, i32),
        cl_aabb=(grid.cl_aabb, f32), wide_nodes=(wide.nodes, f32),
        wide_rows=(wide.rows, f32), wide_index=(wide.index, i32),
        wide_cl_root=(wide.cl_root, i32)), rays[0].device)


def empty_state(n: int, device) -> DdaState:
    """Uninitialised lane state for ``n`` lanes on ``device`` (the first
    launch writes it)."""
    i32, f32 = torch.int32, torch.float32
    e = lambda *shape, dtype=f32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=device)
    return DdaState(e(n, 3, dtype=i32), e(n), e(n, dtype=i32), e(n),
                    e(n, dtype=torch.int64), e(n), e(n))


# On the card the host reads the live count after every READ_EVERY-th
# launch only and launches the rounds between blind, since each read waits
# for the card.  Of reading after every 1st, 2nd, 4th, 8th and 16th launch, the 8th
# was the fastest or near it on the bench city's camera and sorted
# first-bounce queries on an H100 (scripts/k6_measure.py; PERF.md
# section 6).
READ_EVERY = 8


def intersect_dda(grid: GridPack, woop, ray_pos, ray_dir, t_min, t_max,
                  any_hit: bool = False, max_rounds: int = 48,
                  stats: dict = None, wide=None):
    """Nearest-hit / any-hit by the cell-by-cell wavefront.  Same output
    contract as ``intersect_stream``: (t, tri, u, v), tri the padded
    leaf-order index (int64) or -1; under any-hit ``tri >= 0`` flags
    occlusion.

    A lane enters at the cell holding its entry point into the grid
    (clamped into it) and walks front to back, one cell per round, across
    the nearest exit plane by an integer step, as the march kernel does.
    (The JAX round loop re-locates the cell each round from the point at
    ``t + 1e-4 min(h)``; that drops a hit lying within that step of the
    grid's boundary, such as a shadow ray leaving the ground downward, and
    can stall a ray nearly parallel to a cell face.)  A lane retires once
    its best hit lies at or before the cell's exit, it is occluded
    (any-hit), or it leaves the grid or its interval.  Among equal t the
    lower padded slot wins, across rounds too; at a tie on a cell face the
    lane stops with what it found before the face (the JAX march's rule).

    On the CPU each round is ``cell_pass_plain`` (``woop`` is read by it
    alone).  On the card the lanes' state stays on the card and each round
    is one launch of ``cell_pass_kernel`` over all lanes (those done return
    at once), which visits each cluster of a lane's cell through its
    subtree of ``wide`` (``scene.st_wide``); between launches the host only
    reads the count of live lanes, after every ``READ_EVERY``-th launch (so
    up to ``READ_EVERY - 1`` launches after the last lane retired find no
    lane).  A query on the card raises without ``wide``.  ``max_rounds``
    must be at least 1.
    ``stats``, when given, receives ``rounds`` (the rounds run; on the card
    the launches), ``live`` (lanes still live when the rounds ran out) and
    ``kernel_ms`` (the launches' summed time by CUDA events; 0 on the
    CPU)."""
    if grid.n_outliers != 0:
        raise ValueError('intersect_dda has no outlier pass; build the grid '
                         'with robust_aabb=False for it')
    if max_rounds < 1:
        raise ValueError(f'intersect_dda: max_rounds {max_rounds} < 1')
    dev = ray_pos.device
    if dev.type == 'cpu':
        t_max = torch.clamp(t_max, max=TST.T_MAX_CAP)
        state = dda_entry(grid, ray_pos, ray_dir, t_min, t_max)
        rounds = 0
        while rounds < max_rounds and not bool(state.done.all()):
            state = cell_pass_plain(grid, woop, ray_pos, ray_dir, t_min,
                                    t_max, state, any_hit)
            rounds += 1
        live, kernel_ms = int((state.done == 0).sum()), 0.0
    elif dev.type == 'cuda':
        rays = TST.ray_arrays('intersect_dda', ray_pos, ray_dir, t_min,
                              t_max)
        _check_card_inputs(grid, wide, rays)
        N = ray_pos.shape[0]
        state = empty_state(N, dev)
        # the lanes each round leaves live, one count per round
        counts = torch.zeros(max_rounds, dtype=torch.int32, device=dev)
        events = []
        rounds, live = 0, N
        while rounds < max_rounds and live > 0:
            if stats is not None:
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            cell_pass(grid, wide, rays, state, counts[rounds:rounds + 1],
                      any_hit, first=rounds == 0)
            if stats is not None:
                events[-1][1].record()
            rounds += 1
            if rounds % READ_EVERY == 0 or rounds == max_rounds:
                live = int(counts[rounds - 1])
        kernel_ms = sum(a.elapsed_time(b) for a, b in events)
    else:
        raise ValueError(f'intersect_dda: unsupported device {dev}')
    if stats is not None:
        stats.update(rounds=rounds, live=live, kernel_ms=kernel_ms)
    return state.best_t, state.best_i, state.best_u, state.best_v
