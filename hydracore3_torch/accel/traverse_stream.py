"""Nearest-hit and any-hit queries over the streamed cluster BVH.

The counterpart of ``hydracore3_tpu/accel/traverse_stream.py``.  The scene
is a skip-pointer BVH whose leaves are clusters of up to ``TBK`` triangles
in Woop form: row ``c * TBK + k`` of the ``[C * TBK, 12]`` table holds the
three affine Woop rows of triangle ``k`` of cluster ``c`` (zeros for
padding).  These contract tables are what the plain torch version,
``intersect_plain``, reads and what every returned index points into.

On the card ``intersect_stream`` launches the hand-written CUDA kernel
(``csrc/traverse_wide.cuh``, ``intersect_stream_kernel``), which reads
``wide`` alone: ``wide_bvh.pack_wide_stream``'s table, derived from the
contract tables at scene build (``scene.st_wide``), of 4-wide nodes over
leaves of at most 4 of the same Woop rows (each cluster a subtree of its
own under the collapsed stream BVH), walked near-first with a stack per
thread.  For tensors on the CPU it is ``intersect_plain``.

Output contract (the JAX wrapper's): ``(t, tri, u, v)`` with ``tri`` the
padded leaf-order triangle index, -1 on a miss (t is then the clamped
t_max); among equal t the lowest index wins; under any-hit ``tri = 0`` with
``t = t_min`` marks occlusion.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..utils.native import PKG_DIR, build_shared_library
from . import wide_bvh as WB

FLT_MAX = 3.4e38
# the largest t_max a query walks with (below the miss sentinel), as float32
T_MAX_CAP = float(np.float32(0.99 * FLT_MAX))
TBK = 64                 # triangles per cluster
_BIG_I = 0x7FFFFFF0
_CU_SRC = os.path.join(PKG_DIR, 'csrc', 'traverse.cu')
# included by traverse.cu: the wide-BVH kernels (K2-K5)
_CU_HEADERS = (os.path.join(PKG_DIR, 'csrc', 'traverse_wide.cuh'),)
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC']
_lib = None


def _nvcc() -> str:
    cuda_nvcc = '/usr/local/cuda/bin/nvcc'
    return cuda_nvcc if os.path.exists(cuda_nvcc) else 'nvcc'


def load_library(defines=(), source=_CU_SRC):
    """Compile (unless already built) and load ``source`` (by default
    ``csrc/traverse.cu``, which includes ``csrc/traverse_wide.cuh``) with
    the given ``-D`` macros; returns (library, seconds spent compiling).
    No macro gives the library every wrapper launches.  ``HC3_COUNT`` gives
    the measuring variant: the same entry points, with every kernel summing
    its box tests, triangle tests, instance entries and grid cells into
    four counters that ``hc3_counts_reset()`` zeroes and
    ``hc3_counts_read(ptr to 4 u64)`` copies out."""
    flags = (_NVCC_FLAGS + ['-I', os.path.dirname(_CU_SRC)]
             + [f'-D{d}' for d in defines])
    name = '-'.join(['traverse', *defines]).lower()
    path, secs = build_shared_library(name, [source], [_nvcc()] + flags,
                                      _CU_HEADERS)
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hc3_intersect_stream.restype = i
    lib.hc3_intersect_stream.argtypes = [p] * 7 + [f, i, i, i] + [p] * 5
    lib.hc3_intersect_march.restype = i
    lib.hc3_intersect_march.argtypes = ([p] * 4 + [i] + [p] * 4 + [i, f]
                                        + [p] * 4 + [f, i] + [f] * 6
                                        + [i] * 4 + [p] * 6)
    lib.hc3_intersect_tlas.restype = i
    lib.hc3_intersect_tlas.argtypes = [p] * 9 + [f, i, i, i] + [p] * 6
    lib.hc3_intersect_clusters.restype = i
    lib.hc3_intersect_clusters.argtypes = [p] * 7 + [f, i, i, i] + [p] * 5
    lib.hc3_cell_pass.restype = i
    lib.hc3_cell_pass.argtypes = ([p] * 7 + [i, f] + [p] * 4 + [f, i]
                                  + [f] * 6 + [i] * 5 + [p] * 9)
    lib.hc3_traverse_attrs.restype = i
    lib.hc3_traverse_attrs.argtypes = [i, p]
    if 'HC3_COUNT' in defines:
        lib.hc3_counts_reset.restype = i
        lib.hc3_counts_reset.argtypes = []
        lib.hc3_counts_read.restype = i
        lib.hc3_counts_read.argtypes = [p]
    return lib, secs


def build_kernels() -> float:
    """Compile (at first use) and load ``csrc/traverse.cu`` with its header
    ``csrc/traverse_wide.cuh``, the source of every ray-query kernel (this
    module's, ``traverse_dda``'s, ``traverse_tlas``'s and
    ``traverse_pallas``'s); returns the seconds
    spent compiling (0 when already built or loaded)."""
    global _lib
    if _lib is not None:
        return 0.0
    _lib, secs = load_library()
    return secs


def kernel_library():
    """The loaded library of ``csrc/traverse.cu`` (built at first use)."""
    build_kernels()
    return _lib


KERNEL_NAMES = ('intersect_stream_kernel<nearest>',
                'intersect_stream_kernel<any-hit>', 'intersect_march_kernel',
                'intersect_tlas_kernel<nearest>',
                'intersect_tlas_kernel<any-hit>',
                'intersect_clusters_kernel<nearest>',
                'intersect_clusters_kernel<any-hit>',
                'cell_pass_kernel<nearest>', 'cell_pass_kernel<any-hit>')


def kernel_attrs(lib=None) -> dict:
    """Registers per thread and local (spill) bytes of every ray-query
    kernel, as the loaded library (the shipped one by default) reports
    them: name -> (registers, local bytes)."""
    lib = lib or kernel_library()
    out = {}
    for k, name in enumerate(KERNEL_NAMES):
        v = (ctypes.c_int * 2)()
        launch_checked(name, lib.hc3_traverse_attrs(k, v))
        out[name] = (v[0], v[1])
    return out


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


def ray_arrays(name, ray_pos, ray_dir, t_min, t_max):
    """The rays as the wide-BVH kernels read them, straight from the
    caller's tensors: contiguous f32 (pos [N, 3], dir [N, 3], t_min [N],
    t_max [N]) on one card; no copy when they already are.  Anything else
    is refused: the kernel reads them by raw address."""
    n, dev = ray_pos.shape[0], ray_pos.device
    want = dict(ray_pos=(ray_pos, (n, 3)), ray_dir=(ray_dir, (n, 3)),
                t_min=(t_min, (n,)), t_max=(t_max, (n,)))
    for key, (tensor, shape) in want.items():
        if tensor.device != dev or tuple(tensor.shape) != shape:
            raise ValueError(f'{name}: {key} must be {shape} on {dev}, got '
                             f'{tuple(tensor.shape)} on {tensor.device}')
    return tuple(x.to(torch.float32).contiguous()
                 for x in (ray_pos, ray_dir, t_min, t_max))


def launch_checked(name, rc: int):
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {rc}')


def woop_tuv(rows, ray_pos, ray_dir):
    """t, u, v [R, T] of R rays (pos, dir [R, 3]) against T Woop rows
    [T, 12], op for op the kernels' ``woop_tuv``: po = M o + w, pd = M d
    (each product and sum rounded alone, in this order), t = -po_z / pd_z,
    u = po_x + t pd_x, v = po_y + t pd_y.  An all-zero row gives t = NaN."""
    w = rows.T.reshape(3, 4, -1)                   # [comp, coef, T]
    o = ray_pos[:, :, None]                        # [R, 3, 1]
    d = ray_dir[:, :, None]

    def comp(c):
        wc = w[c]
        po = wc[0] * o[:, 0] + wc[1] * o[:, 1] + wc[2] * o[:, 2] + wc[3]
        pd = wc[0] * d[:, 0] + wc[1] * d[:, 1] + wc[2] * d[:, 2]
        return po, pd

    (po_x, pd_x), (po_y, pd_y), (po_z, pd_z) = comp(0), comp(1), comp(2)
    t = -po_z / pd_z
    return t, po_x + t * pd_x, po_y + t * pd_y


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
    o = ray_pos[rows]
    d = ray_dir[rows]
    tmin = t_min[rows][:, None]
    bt = best_t[rows]
    bi = best_i[rows]
    bu = best_u[rows]
    bv = best_v[rows]
    step = max(1, chunk_elems // R)
    for s in range(0, T, step):
        t, u, v = woop_tuv(woop[s:s + step], o, d)
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


def hits_agree(kernel, plain, any_hit: bool = False) -> dict:
    """How a kernel's ``(t, tri, u, v, ...)`` stands against its plain
    version's on the same rays; the measure of every card check of a
    ray-query kernel.  Shares: ``hit_eq`` (lanes with the same hit flag),
    ``t_ok`` (both-hit lanes whose t agrees to rtol 2e-4, atol 1e-5) and
    ``tri_eq`` (both-hit lanes reporting the same triangle); maxima over
    the lanes where both report the same triangle: ``max_dt`` and
    ``max_duv`` (the barycentrics; 0 under any-hit, which returns none);
    counts: ``both`` both-hit lanes, ``hit_diff`` lanes whose hit flags
    differ, ``tri_diff`` both-hit lanes with another triangle and
    ``tie_diff`` those of them where both t are equal (a tie settled the
    other way).  Under any-hit occlusion is
    boolean and ``tri >= 0`` only marks it: most kernels report 0, the
    cluster kernel the first occluder its walk meets (any valid one; the
    plain version the lowest), so every both-hit lane counts as the same
    triangle there and ``traverse_pallas.occluder_valid`` holds the
    reported one to its lane."""
    kt, ktri, ku, kv = (x.cpu().numpy() for x in kernel[:4])
    pt, ptri, pu, pv = (x.cpu().numpy() for x in plain[:4])
    kh, ph = ktri >= 0, ptri >= 0
    both = kh & ph
    same = both if any_hit else both & (ktri == ptri)
    n_both = int(both.sum())
    other = both & ~same
    out = dict(hit_eq=float((kh == ph).mean()), t_ok=1.0, tri_eq=1.0,
               max_dt=0.0, max_duv=0.0, both=n_both,
               hit_diff=int((kh != ph).sum()), tri_diff=int(other.sum()),
               tie_diff=int((other & (kt == pt)).sum()))
    if n_both:
        out['t_ok'] = float(np.isclose(kt[both], pt[both], rtol=2e-4,
                                       atol=1e-5).mean())
        out['tri_eq'] = float(same.sum()) / n_both
    if same.any():
        out['max_dt'] = float(np.abs(kt[same] - pt[same]).max())
        if not any_hit:
            out['max_duv'] = float(max(np.abs(ku[same] - pu[same]).max(),
                                       np.abs(kv[same] - pv[same]).max()))
    return out


def intersect_stream(nodes_f, nodes_i, woop, ray_pos, ray_dir, t_min, t_max,
                     any_hit: bool = False, wide=None):
    """Nearest-hit / any-hit over the streamed cluster BVH.

    nodes_f [M, 8] f32 (bmin3, bmax3, pad2); nodes_i [M, 4] i32 (skip,
    cluster slot or -1, tri count, pad); woop [C * TBK, 12] f32: the
    contract tables, of which only ``woop`` is read, by the plain version.
    A query on the card reads ``wide`` alone, the ``wide_bvh.WidePack``
    derived from them (``wide_bvh.pack_wide_stream``, ``scene.st_wide``),
    and raises without it.  Returns (t, tri, u, v); tri is int64."""
    dev = ray_pos.device
    if dev.type == 'cpu':
        return intersect_plain(woop, ray_pos, ray_dir, t_min,
                               torch.clamp(t_max, max=T_MAX_CAP), any_hit)
    if dev.type != 'cuda':
        raise ValueError(f'intersect_stream: unsupported device {dev}')
    if wide is None:
        raise ValueError('intersect_stream: a query on the card needs '
                         'wide=scene.st_wide (wide_bvh.pack_wide_stream)')
    WB.require_stack('intersect_stream', wide.stack)
    lib = kernel_library()
    check_cuda_inputs('intersect_stream', dict(
        wide_nodes=(wide.nodes, torch.float32),
        wide_rows=(wide.rows, torch.float32),
        wide_index=(wide.index, torch.int32)), dev)
    N = ray_pos.shape[0]
    rays = ray_arrays('intersect_stream', ray_pos, ray_dir, t_min, t_max)
    t = torch.empty(N, dtype=torch.float32, device=dev)
    tri = torch.empty(N, dtype=torch.int64, device=dev)
    u = torch.empty(N, dtype=torch.float32, device=dev)
    v = torch.empty(N, dtype=torch.float32, device=dev)
    if N > 0:
        rc = lib.hc3_intersect_stream(
            wide.nodes.data_ptr(), wide.rows.data_ptr(),
            wide.index.data_ptr(), *(x.data_ptr() for x in rays), T_MAX_CAP,
            N, int(any_hit), wide.stack, t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        launch_checked('intersect_stream', rc)
        intersect_stream.launches += 1
    return t, tri, u, v


intersect_stream.launches = 0


def woop_rows(v0, e1, e2) -> np.ndarray:
    """[T, 3, 4] f32 Woop rows: M = inv([e1 e2 n] columns), p = M (o - v0),
    q = M d; the hit is at p + t q = (u, v, 0).  Degenerate rows stay
    all-zero, so q_z = 0 and t = 0/0 = NaN rejects them."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    n = np.cross(e1, e2)
    A = np.stack([e1, e2, n], axis=-1)
    det = np.linalg.det(A)
    bad = np.abs(det) < 1e-18
    A[bad] = np.eye(3)
    Minv = np.linalg.inv(A)
    trans = -np.einsum('tij,tj->ti', Minv, v0)
    W = np.zeros((len(v0), 3, 4), np.float32)
    W[:, :, :3] = Minv.astype(np.float32)
    W[:, :, 3] = trans.astype(np.float32)
    W[bad] = 0.0
    return W


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

    W = woop_rows(v0, e1, e2)
    woop = np.zeros((max(C, 1) * TBK, 12), np.float32)
    order_padded = np.full(max(C, 1) * TBK, -1, np.int64)
    for c, (o, k) in enumerate(zip(bvh.tri_offset[leaf], bvh.tri_count[leaf])):
        o, k = int(o), int(k)
        woop[c * TBK:c * TBK + k] = W[o:o + k].reshape(k, 12)
        order_padded[c * TBK:c * TBK + k] = np.arange(o, o + k)
    return nodes_f, nodes_i, woop, order_padded
