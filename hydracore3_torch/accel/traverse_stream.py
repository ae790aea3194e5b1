"""Nearest-hit and any-hit queries over the streamed cluster BVH.

The counterpart of ``hydracore3_tpu/accel/traverse_stream.py``.  The scene
is a skip-pointer BVH whose leaves are clusters of up to ``TBK`` triangles
in Woop form: row ``c * TBK + k`` of the ``[C * TBK, 12]`` table holds the
three affine Woop rows of triangle ``k`` of cluster ``c`` (zeros for
padding).  ``intersect_stream`` launches the hand-written CUDA kernel
(``csrc/traverse.cu``) for tensors on the card and the plain torch version,
``intersect_plain``, for tensors on the CPU.

Output contract (the JAX wrapper's): ``(t, tri, u, v)`` with ``tri`` the
padded leaf-order triangle index, -1 on a miss (t is then the clamped
t_max); under any-hit ``tri >= 0`` with ``t = t_min`` marks occlusion.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..utils.native import PKG_DIR, build_shared_library

FLT_MAX = 3.4e38
TBK = 64                 # triangles per cluster
_BIG_I = 0x7FFFFFF0
_CU_SRC = os.path.join(PKG_DIR, 'csrc', 'traverse.cu')
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC']
_lib = None


def _nvcc() -> str:
    cuda_nvcc = '/usr/local/cuda/bin/nvcc'
    return cuda_nvcc if os.path.exists(cuda_nvcc) else 'nvcc'


def build_kernels() -> float:
    """Compile (at first use) and load ``csrc/traverse.cu``; returns the
    seconds spent compiling (0 when already built or loaded)."""
    global _lib
    if _lib is not None:
        return 0.0
    path, secs = build_shared_library('traverse', [_CU_SRC],
                                      [_nvcc()] + _NVCC_FLAGS)
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hc3_intersect_stream.restype = i
    lib.hc3_intersect_stream.argtypes = [p, p, p, p, i, i, p, p, p, p, p]
    lib.hc3_intersect_march.restype = i
    lib.hc3_intersect_march.argtypes = ([p] * 5 + [i, p, p, i] + [f] * 6
                                        + [i] * 4 + [p] * 6)
    _lib = lib
    return secs


def check_cuda_inputs(name, tensors: dict, device):
    """Refuse what the kernel does not take: every table on the rays'
    card, contiguous, of the dtype the kernel reads."""
    for key, (tensor, dtype) in tensors.items():
        if tensor.device != device:
            raise ValueError(f'{name}: {key} is on {tensor.device}, rays on '
                             f'{device}')
        if tensor.dtype != dtype or not tensor.is_contiguous():
            raise ValueError(f'{name}: {key} must be contiguous {dtype}, got '
                             f'{tensor.dtype}')


def pack_rays(ray_pos, ray_dir, t_min, t_max):
    """[N, 8] f32 rows (pos3, dir3, tmin, tmax) as the kernels read them."""
    return torch.cat([ray_pos, ray_dir, t_min[:, None], t_max[:, None]],
                     dim=1).to(torch.float32).contiguous()


def launch_checked(name, rc: int):
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {rc}')


def intersect_plain(woop, ray_pos, ray_dir, t_min, t_max, any_hit=False):
    """Dense Woop intersection of every ray with every padded triangle.

    The plain torch version of both kernels: the same arithmetic, strict
    bounds and tie rule (lowest padded index among equal t, which is the
    first cluster the BVH walk visits, since leaf slots follow its DFS
    order).  Rays whose interval is empty are skipped.  ``t_max`` must
    already be clamped below the miss sentinel."""
    N = ray_pos.shape[0]
    dev = ray_pos.device
    best_t = t_max.to(torch.float32).clone()
    best_i = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(N, dtype=torch.float32, device=dev)
    best_v = torch.zeros(N, dtype=torch.float32, device=dev)
    rows = torch.nonzero(t_max > t_min).squeeze(1)
    R, T = rows.numel(), woop.shape[0]
    if R == 0:
        return best_t, best_i, best_u, best_v
    # [rays, triangles] temporaries of at most 2^26 (card) / 2^22 elements
    chunk_elems = (1 << 26) if dev.type == 'cuda' else (1 << 22)
    o = ray_pos[rows][:, :, None]                 # [R, 3, 1]
    d = ray_dir[rows][:, :, None]
    tmin = t_min[rows][:, None]
    bt = best_t[rows]
    bi = best_i[rows]
    bu = best_u[rows]
    bv = best_v[rows]
    step = max(1, chunk_elems // R)
    for s in range(0, T, step):
        w = woop[s:s + step].T.reshape(3, 4, -1)   # [comp, coef, Tc]

        def comp(c):
            wc = w[c]
            po = wc[0] * o[:, 0] + wc[1] * o[:, 1] + wc[2] * o[:, 2] + wc[3]
            pd = wc[0] * d[:, 0] + wc[1] * d[:, 1] + wc[2] * d[:, 2]
            return po, pd

        (po_x, pd_x), (po_y, pd_y), (po_z, pd_z) = comp(0), comp(1), comp(2)
        t = -po_z / pd_z
        u = po_x + t * pd_x
        v = po_y + t * pd_y
        valid = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
                 & (t < bt[:, None]))
        if any_hit:
            occ = valid.any(dim=1)
            bi = torch.where(occ, 0, bi)
            bt = torch.where(occ, tmin[:, 0], bt)
            continue
        tm = torch.where(valid, t, FLT_MAX)
        cbt = tm.amin(dim=1)
        ii = torch.arange(s, s + t.shape[1], device=dev)
        li = torch.where(tm == cbt[:, None], ii, _BIG_I).amin(dim=1)
        closer = cbt < bt
        col = (li - s).clamp(max=t.shape[1] - 1)[:, None]
        bu = torch.where(closer, u.gather(1, col)[:, 0], bu)
        bv = torch.where(closer, v.gather(1, col)[:, 0], bv)
        bi = torch.where(closer, li, bi)
        bt = torch.minimum(bt, cbt)
    best_t[rows], best_i[rows], best_u[rows], best_v[rows] = bt, bi, bu, bv
    return best_t, best_i, best_u, best_v


def intersect_stream(nodes_f, nodes_i, woop, ray_pos, ray_dir, t_min, t_max,
                     any_hit: bool = False):
    """Nearest-hit / any-hit over the streamed cluster BVH.

    nodes_f [M, 8] f32 (bmin3, bmax3, pad2); nodes_i [M, 4] i32 (skip,
    cluster slot or -1, tri count, pad); woop [C * TBK, 12] f32.  Returns
    (t, tri, u, v); tri is int64."""
    # below the miss sentinel (the JAX wrapper's clamp, ROADMAP.md §3)
    t_max = torch.clamp(t_max, max=0.99 * FLT_MAX)
    dev = ray_pos.device
    if dev.type == 'cpu':
        return intersect_plain(woop, ray_pos, ray_dir, t_min, t_max, any_hit)
    if dev.type != 'cuda':
        raise ValueError(f'intersect_stream: unsupported device {dev}')
    build_kernels()
    check_cuda_inputs('intersect_stream', dict(
        nodes_f=(nodes_f, torch.float32), nodes_i=(nodes_i, torch.int32),
        woop=(woop, torch.float32)), dev)
    N = ray_pos.shape[0]
    rays = pack_rays(ray_pos, ray_dir, t_min, t_max)
    t = torch.empty(N, dtype=torch.float32, device=dev)
    tri = torch.empty(N, dtype=torch.int32, device=dev)
    u = torch.empty(N, dtype=torch.float32, device=dev)
    v = torch.empty(N, dtype=torch.float32, device=dev)
    if N > 0:
        rc = _lib.hc3_intersect_stream(
            nodes_f.data_ptr(), nodes_i.data_ptr(), woop.data_ptr(),
            rays.data_ptr(), N, int(any_hit), t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        launch_checked('intersect_stream', rc)
        intersect_stream.launches += 1
    return t, tri.to(torch.int64), u, v


intersect_stream.launches = 0


def pack_stream_bvh(bvh, v0, e1, e2):
    """Host-side packing of a FlatBVH (max_leaf = TBK).

    Returns (nodes_f [M, 8] f32, nodes_i [M, 4] i32, woop [C * TBK, 12] f32,
    order_padded [C * TBK] i64), where order_padded maps a padded leaf-order
    index to the builder's leaf-order triangle index (-1 for padding).
    v0/e1/e2 must already be in the builder's leaf order."""
    M = len(bvh.bmin)
    leaf = bvh.tri_count > 0
    C = int(leaf.sum())
    nodes_f = np.zeros((M, 8), np.float32)
    nodes_f[:, 0:3] = bvh.bmin
    nodes_f[:, 3:6] = bvh.bmax
    nodes_i = np.zeros((M, 4), np.int32)
    nodes_i[:, 0] = bvh.skip
    nodes_i[:, 1] = -1
    nodes_i[leaf, 1] = np.arange(C, dtype=np.int32)
    nodes_i[:, 2] = bvh.tri_count

    # Woop rows: M = inv([e1 e2 n] columns), p = M (o - v0), q = M d; the
    # hit is at p + t q = (u, v, 0).  Degenerate rows stay all-zero, so
    # q_z = 0 and t = 0/0 = NaN rejects them.
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    T = len(v0)
    n = np.cross(e1, e2)
    A = np.stack([e1, e2, n], axis=-1)
    det = np.linalg.det(A)
    bad = np.abs(det) < 1e-18
    A[bad] = np.eye(3)
    Minv = np.linalg.inv(A)
    trans = -np.einsum('tij,tj->ti', Minv, v0)
    W = np.zeros((T, 3, 4), np.float32)
    W[:, :, :3] = Minv.astype(np.float32)
    W[:, :, 3] = trans.astype(np.float32)
    W[bad] = 0.0

    woop = np.zeros((max(C, 1) * TBK, 12), np.float32)
    order_padded = np.full(max(C, 1) * TBK, -1, np.int64)
    for c, (o, k) in enumerate(zip(bvh.tri_offset[leaf], bvh.tri_count[leaf])):
        o, k = int(o), int(k)
        woop[c * TBK:c * TBK + k] = W[o:o + k].reshape(k, 12)
        order_padded[c * TBK:c * TBK + k] = np.arange(o, o + k)
    return nodes_f, nodes_i, woop, order_padded
