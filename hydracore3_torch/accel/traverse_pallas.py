"""Nearest-hit and any-hit queries over the cluster BVH of mid-size soups.

The counterpart of ``hydracore3_tpu/accel/traverse_pallas.py`` (whose name
it keeps, so the two packages' modules pair up; nothing of Pallas is left
in it).  The JAX package routes static soups of 4,096 to ``VMEM_TRI_LIMIT``
triangles here: a skip-pointer BVH whose leaves are ranges
``[toff, toff + tcnt)`` of up to ``CLUSTER`` triangles in leaf order, kept
unpadded as ``(v0, e1, e2)`` rows and tested with Moller-Trumbore.

``intersect_clusters`` launches the hand-written CUDA kernel
(``csrc/traverse_wide.cuh``, ``intersect_clusters_kernel``) for tensors on
the card and the plain torch version, ``intersect_clusters_plain``, for
tensors on the CPU.  The kernel walks a tree of its own over the same
triangles (``wide_bvh.pack_wide_clusters``: 4-wide nodes, leaves of at most
4) and reports indices into the tables here.

Output contract (the JAX wrapper's): ``(t, tri, u, v)`` with ``tri`` the
unpadded leaf-order triangle index, -1 on a miss (t is then ``t_max``, which
is NOT clamped); nearest keeps the lowest index among equal t.  Under any-hit
occlusion is boolean: ``tri >= 0`` with ``t = t_min`` marks it, and ``tri``
is then the index of A triangle that occludes the lane: the lowest one from
the plain version, the first one its walk meets from the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from . import traverse_stream as TST
from . import wide_bvh as WB

CLUSTER = 64                 # triangles per leaf at most
VMEM_TRI_LIMIT = 175_000     # the JAX package's upper bound of this route
_BIG_I = 0x7FFFFFF0
_DET_EPS = 1e-12


def pack_cluster_bvh(bvh, v0, e1, e2):
    """Host-side packing of a FlatBVH (max_leaf = CLUSTER) and its
    leaf-ordered triangles: nodes_f [M, 8] f32 (bmin3, bmax3, pad2), nodes_i
    [M, 4] i32 (skip, tri offset, tri count, pad), tris12 [T, 12] f32 (v0,
    e1, e2, pad3)."""
    M = len(bvh.bmin)
    nodes_f = np.zeros((M, 8), np.float32)
    nodes_f[:, 0:3] = bvh.bmin
    nodes_f[:, 3:6] = bvh.bmax
    nodes_i = np.zeros((M, 4), np.int32)
    nodes_i[:, 0] = bvh.skip
    nodes_i[:, 1] = np.maximum(bvh.tri_offset, 0)
    nodes_i[:, 2] = bvh.tri_count
    T = len(v0)
    tris12 = np.zeros((max(T, 1), 12), np.float32)
    tris12[:T, 0:3] = v0
    tris12[:T, 3:6] = e1
    tris12[:T, 6:9] = e2
    return nodes_f, nodes_i, tris12


def intersect_clusters_plain(tris12, ray_pos, ray_dir, t_min, t_max,
                             any_hit: bool = False):
    """Dense Moller-Trumbore intersection of every ray with every triangle,
    in index order: the plain torch version of the cluster kernel, with its
    arithmetic (pvec = d x e2, det = pvec . e1, accepted when |det| > 1e-12,
    u >= 0, v >= 0, u + v <= 1, t_min < t < best t) and its tie rule
    (lowest index among equal t: leaf offsets rise in the walk's DFS
    order).  Under any-hit the lowest valid index is kept with t = t_min."""
    N = ray_pos.shape[0]
    dev = ray_pos.device
    best_t = t_max.to(torch.float32).clone()
    best_i = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(N, dtype=torch.float32, device=dev)
    best_v = torch.zeros(N, dtype=torch.float32, device=dev)
    rows = torch.nonzero(t_max > t_min).squeeze(1)
    R, T = rows.numel(), tris12.shape[0]
    if R == 0:
        return best_t, best_i, best_u, best_v
    # [rays, triangles] temporaries of at most 2^26 (card) / 2^22 elements
    chunk_elems = (1 << 26) if dev.type == 'cuda' else (1 << 22)
    px, py, pz = (ray_pos[rows][:, k, None] for k in range(3))
    dx, dy, dz = (ray_dir[rows][:, k, None] for k in range(3))
    tmin = t_min[rows][:, None]
    bt, bi, bu, bv = best_t[rows], best_i[rows], best_u[rows], best_v[rows]
    step = max(1, chunk_elems // R)
    inf = float('inf')
    for s in range(0, T, step):
        tr = tris12[s:s + step].T                     # [12, Tc]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tr[:9]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = pvx * e1x + pvy * e1y + pvz * e1z
        nondeg = det.abs() > _DET_EPS
        inv = torch.where(nondeg, 1.0 / det, 0.0)
        tvx, tvy, tvz = px - v0x, py - v0y, pz - v0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        valid = (nondeg & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                 & (t > tmin) & (t < bt[:, None]))
        ii = torch.arange(s, s + t.shape[1], device=dev)
        if any_hit:
            li = torch.where(valid, ii, _BIG_I).amin(dim=1)
            occ = (li < _BIG_I) & (bi < 0)
            bi = torch.where(occ, li, bi)
            bt = torch.where(occ, tmin[:, 0], bt)
            continue
        tm = torch.where(valid, t, inf)
        cbt = tm.amin(dim=1)
        li = torch.where(valid & (tm == cbt[:, None]), ii, _BIG_I).amin(dim=1)
        closer = cbt < bt
        col = (li - s).clamp(max=t.shape[1] - 1)[:, None]
        bu = torch.where(closer, u.gather(1, col)[:, 0], bu)
        bv = torch.where(closer, v.gather(1, col)[:, 0], bv)
        bi = torch.where(closer, li, bi)
        bt = torch.minimum(bt, cbt)
    best_t[rows], best_i[rows], best_u[rows], best_v[rows] = bt, bi, bu, bv
    return best_t, best_i, best_u, best_v


def occluder_valid(tris12, tri, ray_pos, ray_dir, t_min, t_max):
    """Per lane: does triangle ``tri`` of ``tris12`` occlude the lane's ray
    by the plain Moller-Trumbore test (non-degenerate, u >= 0, v >= 0,
    u + v <= 1, t_min < t < t_max)?  What an any-hit query's reported
    triangle must satisfy on every occluded lane; False where tri < 0."""
    t, u, v, nondeg = WB.moller_trumbore(tris12[tri.clamp(min=0)], ray_pos,
                                         ray_dir)
    return ((tri >= 0) & nondeg & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > t_min) & (t < t_max))


def intersect_clusters(nodes_f, nodes_i, tris12, ray_pos, ray_dir, t_min,
                       t_max, any_hit: bool = False, wide=None):
    """Nearest-hit / any-hit over the cluster BVH.  Returns (t, tri, u, v);
    tri is int64.  The first three arguments are the JAX wrapper's, the
    contract tables; of them only ``tris12`` is read, by the plain version.
    A query on the card reads ``wide`` alone, the ``wide_bvh.WidePack``
    derived from ``tris12`` (``wide_bvh.pack_wide_clusters``), so there the
    contract tables may stay on the host (or be None)."""
    dev = ray_pos.device
    if dev.type == 'cpu':
        return intersect_clusters_plain(tris12, ray_pos, ray_dir, t_min,
                                        t_max, any_hit)
    if dev.type != 'cuda':
        raise ValueError(f'intersect_clusters: unsupported device {dev}')
    if wide is None:
        raise ValueError('intersect_clusters: a query on the card needs '
                         'wide=wide_bvh.pack_wide_clusters(tris12)')
    WB.require_stack('intersect_clusters', wide.stack)
    lib = TST.kernel_library()
    TST.check_cuda_inputs('intersect_clusters', dict(
        wide_nodes=(wide.nodes, torch.float32),
        wide_rows=(wide.rows, torch.float32),
        wide_index=(wide.index, torch.int32)), dev)
    N = ray_pos.shape[0]
    rays = TST.ray_arrays('intersect_clusters', ray_pos, ray_dir, t_min,
                          t_max)
    t = torch.empty(N, dtype=torch.float32, device=dev)
    tri = torch.empty(N, dtype=torch.int64, device=dev)
    u = torch.empty(N, dtype=torch.float32, device=dev)
    v = torch.empty(N, dtype=torch.float32, device=dev)
    if N > 0:
        rc = lib.hc3_intersect_clusters(
            wide.nodes.data_ptr(), wide.rows.data_ptr(),
            wide.index.data_ptr(), *(x.data_ptr() for x in rays),
            float('inf'), N, int(any_hit), wide.stack, t.data_ptr(),
            tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        TST.launch_checked('intersect_clusters', rc)
        intersect_clusters.launches += 1
    return t, tri, u, v


intersect_clusters.launches = 0
