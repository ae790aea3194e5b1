"""Two-level (TLAS) nearest-hit and any-hit queries: instancing at O(mesh).

The counterpart of ``hydracore3_tpu/accel/traverse_tlas.py``.  Every mesh
keeps one object-space cluster BVH (the layout of ``traverse_stream``: nodes
with skip pointers, clusters of up to ``TBK`` Woop rows), all meshes
concatenated with global skips and cluster slots (-1 ends a mesh's walk).  A
skip-pointer TLAS over the instances' world boxes sits on top.  A ray walks
the TLAS in world space; at a leaf it is taken into the instance's object
space by the inverse matrix without renormalizing its direction, so the
object-space t equals the world-space t and one running best t culls
across instances.

``intersect_stream_tlas`` launches the hand-written CUDA kernel
(``csrc/traverse_wide.cuh``, ``intersect_tlas_kernel``) for tensors on the
card and the plain torch version, ``intersect_tlas_plain``, for tensors on
the CPU.  The kernel walks trees of its own over the same instances and
triangles (``TlasPack.wide``, from ``wide_bvh.pack_wide_tlas``: 4-wide
nodes, leaves of at most 4) and reports indices into the tables here.

Output contract (the JAX wrapper's): ``(t, tri, u, v, inst)`` with ``tri``
the GLOBAL padded leaf-order triangle index (cluster slot * TBK + k), -1 on
a miss, ``u, v`` object-space barycentrics and ``inst`` the instance hit
(-1 on a miss); under any-hit ``tri >= 0`` with ``t = t_min`` marks
occlusion and ``inst`` stays -1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build_bvh
from . import traverse_stream as TST
from . import wide_bvh as WB
from .traverse_stream import TBK, T_MAX_CAP

_TABLES = ('tlas_f', 'tlas_i', 'nodes_f', 'nodes_i', 'inst_f', 'inst_i',
           'woop', 'mesh_clusters', 'rows')


@dataclasses.dataclass(frozen=True)
class TlasPack:
    """The kernel's tables; numpy on the host, tensors on a device."""
    tlas_f: object         # [Mt, 8] f32: TLAS node boxes (bmin3, bmax3, pad2)
    tlas_i: object         # [Mt, 4] i32: (skip, instance or -1, 0, 0)
    nodes_f: object        # [M, 8] f32: per-mesh BVH node boxes, concatenated
    nodes_i: object        # [M, 4] i32: (global skip, global cluster slot
    #                        or -1, triangle count, 0)
    inst_f: object         # [I, 16] f32: 12 inverse-matrix entries, pad 4
    inst_i: object         # [I, 4] i32: (mesh's first node, mesh id, 0, 0)
    woop: object           # [C * TBK, 12] f32: Woop rows, all meshes
    mesh_clusters: object  # [G, 2] i32: (first cluster slot, count) per mesh
    rows: object           # [C * TBK, 12] f32: the Woop rows' triangles as
    #                        object-space (v0, e1, e2, pad) rows, padding 0
    #                        (the hit's gradient, accel/hit_grad.py)
    # what the CUDA kernel walks, derived from the tables above: wide nodes,
    # 4-triangle leaves (wide_bvh.pack_wide_tlas)
    wide: WB.WidePack = None

    def to(self, device) -> 'TlasPack':
        return TlasPack(
            wide=None if self.wide is None else self.wide.to(device),
            **{k: torch.as_tensor(getattr(self, k), device=device)
               for k in _TABLES})


def pack_stream_tlas(mesh_tris: list, instances: list) -> dict:
    """Host-side packing for the two-level kernel (the JAX package's
    ``pack_stream_tlas``, the same numpy steps).

    mesh_tris: per mesh (v0 [N, 3], e1, e2) in OBJECT space.
    instances: dicts {geom_id, m0 [4, 4]} (static transforms).

    Returns a dict: the ``TlasPack`` tables (``woop [C * TBK, 12]`` in place
    of the JAX package's ``tris_hbm [C, 8, WPAD]``), ``inst_nm [I, 16]``
    (inverse-transpose matrices for normals), ``order_padded [C * TBK]``
    (padded slot -> the mesh's ORIGINAL primitive id, -1 for padding),
    ``tri_mesh [C * TBK]`` (mesh id per padded slot, -1 for padding),
    ``node_base [G]``, ``cluster_base [G]``, ``rows [C * TBK, 12]`` (each
    padded slot's object-space (v0, e1, e2) row, zeros for padding) and
    ``wide``, the card-side ``WidePack`` derived from the rest."""
    nodes_f_l, nodes_i_l, woop_l, order_l, mesh_l = [], [], [], [], []
    fine_l = []
    node_base, cluster_base, mesh_bounds = [], [], []
    nbase = cbase = 0
    for g, (v0, e1, e2) in enumerate(mesh_tris):
        v0, e1, e2 = (np.asarray(a, np.float32) for a in (v0, e1, e2))
        b = build_bvh.build(v0, e1, e2, max_leaf=TBK)
        order = b.order
        nf, ni, woop, op = TST.pack_stream_bvh(b, v0[order], e1[order],
                                               e2[order])
        ni = ni.copy()
        ni[ni[:, 0] >= 0, 0] += nbase              # globalize skip
        ni[ni[:, 1] >= 0, 1] += cbase              # globalize cluster slot
        node_base.append(nbase)
        cluster_base.append(cbase)
        nodes_f_l.append(nf)
        nodes_i_l.append(ni)
        woop_l.append(woop)
        # the mesh's triangles in the order of their padded slots, for the
        # wide BVH
        real = np.nonzero(op >= 0)[0]
        at = order[op[real]]
        fine_l.append((v0[at], e1[at], e2[at], real + cbase * TBK))
        # padded slot -> original mesh-local primitive id
        op = np.where(op >= 0, order[np.maximum(op, 0)], -1)
        order_l.append(op)
        mesh_l.append(np.where(op >= 0, g, -1))
        mesh_bounds.append((b.bmin[0], b.bmax[0]))
        nbase += len(nf)
        cbase += len(woop) // TBK

    inst_bmin, inst_bmax, inst_f, inst_i, inst_nm = [], [], [], [], []
    for inst in instances:
        g = inst['geom_id']
        m0 = np.asarray(inst['m0'], np.float64).reshape(4, 4)
        bmn, bmx = mesh_bounds[g]
        corners = np.array([[bmn[0] if i & 1 == 0 else bmx[0],
                             bmn[1] if i & 2 == 0 else bmx[1],
                             bmn[2] if i & 4 == 0 else bmx[2]]
                            for i in range(8)], np.float64)
        w = corners @ m0[:3, :3].T + m0[:3, 3]
        inst_bmin.append(w.min(0).astype(np.float32))
        inst_bmax.append(w.max(0).astype(np.float32))
        mi = np.linalg.inv(m0)
        row = np.zeros(16, np.float32)
        row[:12] = mi[:3, :].reshape(12).astype(np.float32)
        inst_f.append(row)
        inst_i.append([node_base[g], g, 0, 0])
        inst_nm.append(mi.T.astype(np.float32).reshape(16))

    tl = build_bvh.build_from_aabbs(np.array(inst_bmin, np.float32),
                                    np.array(inst_bmax, np.float32),
                                    max_leaf=1)
    Mt = len(tl.bmin)
    tlas_f = np.zeros((Mt, 8), np.float32)
    tlas_f[:, 0:3] = tl.bmin
    tlas_f[:, 3:6] = tl.bmax
    tlas_i = np.zeros((Mt, 4), np.int32)
    tlas_i[:, 0] = tl.skip
    tlas_i[:, 1] = -1
    leaf = tl.tri_count > 0
    tlas_i[leaf, 1] = tl.order[tl.tri_offset[leaf]]

    rows = np.zeros((cbase * TBK, 12), np.float32)
    for v0, e1, e2, slots in fine_l:
        rows[slots, 0:3], rows[slots, 3:6], rows[slots, 6:9] = v0, e1, e2
    cluster_base = np.array(cluster_base, np.int32)
    counts = np.diff(np.append(cluster_base, cbase)).astype(np.int32)
    pk = dict(
        tlas_f=tlas_f, tlas_i=tlas_i,
        nodes_f=np.concatenate(nodes_f_l), nodes_i=np.concatenate(nodes_i_l),
        inst_f=np.array(inst_f, np.float32),
        inst_i=np.array(inst_i, np.int32),
        inst_nm=np.array(inst_nm, np.float32),
        woop=np.concatenate(woop_l), rows=rows,
        mesh_clusters=np.stack([cluster_base, counts], axis=1),
        order_padded=np.concatenate(order_l),
        tri_mesh=np.concatenate(mesh_l),
        node_base=np.array(node_base, np.int32), cluster_base=cluster_base)
    pk['wide'] = WB.pack_wide_tlas(pk, fine_l, tl)
    return pk


def tlas_pack(pk: dict) -> TlasPack:
    """The kernel's tables out of ``pack_stream_tlas``'s dict."""
    return TlasPack(wide=pk['wide'], **{k: pk[k] for k in _TABLES})


def to_object_space(inst_row, ray_pos, ray_dir):
    """World-space rays into an instance's object space by the 12
    inverse-matrix entries of ``inst_row``; the direction is NOT
    renormalized, so t is the same in both spaces.  Each component is
    ((a x + b y) + c z) [+ w], the order the kernel follows."""
    m = inst_row
    px, py, pz = ray_pos[:, 0], ray_pos[:, 1], ray_pos[:, 2]
    dx, dy, dz = ray_dir[:, 0], ray_dir[:, 1], ray_dir[:, 2]
    op = torch.stack([m[0] * px + m[1] * py + m[2] * pz + m[3],
                      m[4] * px + m[5] * py + m[6] * pz + m[7],
                      m[8] * px + m[9] * py + m[10] * pz + m[11]], dim=1)
    od = torch.stack([m[0] * dx + m[1] * dy + m[2] * dz,
                      m[4] * dx + m[5] * dy + m[6] * dz,
                      m[8] * dx + m[9] * dy + m[10] * dz], dim=1)
    return op, od


def intersect_tlas_plain(pack: TlasPack, ray_pos, ray_dir, t_min, t_max,
                         any_hit: bool = False):
    """The plain torch version of the two-level kernel: every instance, in
    the order the TLAS walk meets its leaves (so the first instance visited
    wins among equal t, as in the kernel), takes the rays into its object
    space and runs the dense Woop ``intersect_plain`` over its mesh's rows
    with the running best t as ``t_max``.  ``t_max`` must already be
    clamped below the miss sentinel."""
    N = ray_pos.shape[0]
    dev = ray_pos.device
    best_t = t_max.to(torch.float32).clone()
    best_i = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(N, dtype=torch.float32, device=dev)
    best_v = torch.zeros(N, dtype=torch.float32, device=dev)
    best_n = torch.full((N,), -1, dtype=torch.int64, device=dev)
    leaves = pack.tlas_i[:, 1]
    dfs_order = leaves[leaves >= 0].tolist()
    mesh_of = pack.inst_i[:, 1].tolist()
    clusters = pack.mesh_clusters.tolist()
    for inst in dfs_order:
        c0, cn = clusters[mesh_of[inst]]
        op, od = to_object_space(pack.inst_f[inst], ray_pos, ray_dir)
        t, i, u, v = TST.intersect_plain(
            pack.woop[c0 * TBK:(c0 + cn) * TBK], op, od, t_min, best_t,
            any_hit)
        hit = i >= 0
        best_t = t
        if any_hit:
            best_i = torch.where(hit, 0, best_i)
            continue
        best_i = torch.where(hit, i + c0 * TBK, best_i)
        best_u = torch.where(hit, u, best_u)
        best_v = torch.where(hit, v, best_v)
        best_n = torch.where(hit, inst, best_n)
    return best_t, best_i, best_u, best_v, best_n


def intersect_stream_tlas(pack: TlasPack, ray_pos, ray_dir, t_min, t_max,
                          any_hit: bool = False):
    """Two-level nearest-hit / any-hit.  Returns (t, tri, u, v, inst); tri
    and inst are int64."""
    # t_max stays below the miss sentinel (the JAX wrapper's clamp): here
    # for the plain version, inside the kernel on the card
    dev = ray_pos.device
    if dev.type == 'cpu':
        return intersect_tlas_plain(
            pack, ray_pos, ray_dir, t_min,
            torch.clamp(t_max, max=T_MAX_CAP), any_hit)
    if dev.type != 'cuda':
        raise ValueError(f'intersect_stream_tlas: unsupported device {dev}')
    w = pack.wide
    if w is None:
        raise ValueError('intersect_stream_tlas: a query on the card needs '
                         'the pack\'s wide tables (tlas_pack)')
    WB.require_stack('intersect_stream_tlas', w.stack)
    lib = TST.kernel_library()
    i32, f32 = torch.int32, torch.float32
    TST.check_cuda_inputs('intersect_stream_tlas', dict(
        tlas_f=(pack.tlas_f, f32), tlas_i=(pack.tlas_i, i32),
        nodes_f=(pack.nodes_f, f32), nodes_i=(pack.nodes_i, i32),
        inst_f=(pack.inst_f, f32), inst_i=(pack.inst_i, i32),
        woop=(pack.woop, f32), wide_nodes=(w.nodes, f32),
        wide_rows=(w.rows, f32), wide_index=(w.index, i32),
        wide_inst_f=(w.inst_f, f32), wide_inst_i=(w.inst_i, i32)), dev)
    N = ray_pos.shape[0]
    rays = TST.ray_arrays('intersect_stream_tlas', ray_pos, ray_dir, t_min,
                          t_max)
    t = torch.empty(N, dtype=f32, device=dev)
    tri = torch.empty(N, dtype=torch.int64, device=dev)
    u = torch.empty(N, dtype=f32, device=dev)
    v = torch.empty(N, dtype=f32, device=dev)
    inst = torch.empty(N, dtype=torch.int64, device=dev)
    if N > 0:
        rc = lib.hc3_intersect_tlas(
            w.nodes.data_ptr(), w.rows.data_ptr(), w.index.data_ptr(),
            w.inst_f.data_ptr(), w.inst_i.data_ptr(),
            *(x.data_ptr() for x in rays), T_MAX_CAP, N, int(any_hit),
            w.stack, t.data_ptr(), tri.data_ptr(), u.data_ptr(),
            v.data_ptr(), inst.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        TST.launch_checked('intersect_stream_tlas', rc)
        intersect_stream_tlas.launches += 1
    return t, tri, u, v, inst


intersect_stream_tlas.launches = 0
