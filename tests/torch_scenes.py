"""Small scenes that the port's CPU tests and its card tests share: no
test lives here, and nothing of JAX is imported (the card tests run
without it)."""
import numpy as np

from hydracore3_torch.accel import build_bvh as TB
from hydracore3_torch.accel import traverse_dda as TTD
from hydracore3_torch.accel import traverse_stream as TTS
from hydracore3_torch.accel import wide_bvh as TWB


def port_pack(v0, e1, e2, bvh=None):
    """The streamed contract tables of a soup (or of ``bvh`` over the soup
    in its leaf order), its grid, the kernels' table
    (``wide_bvh.pack_wide_stream``) and the soup in padded slot order
    (padding zero)."""
    if bvh is None:
        bvh = TB.build(v0, e1, e2, max_leaf=TTS.TBK)
        o = bvh.order
        v0, e1, e2 = v0[o], e1[o], e2[o]
    nf, ni, woop, op = TTS.pack_stream_bvh(bvh, v0, e1, e2)
    sel = np.maximum(op, 0)
    soup = tuple(np.where((op < 0)[:, None], 0.0, a[sel]).astype(np.float32)
                 for a in (v0, e1, e2))
    return (nf, ni, woop, op, TTD.pack_grid(nf, ni),
            TWB.pack_wide_stream(nf, ni, woop, *soup), soup)


def tilted_sheet(rng, n=12):
    """An n x n grid of quads on the tilted plane z = x / 2 + y / 4, its
    vertices jittered on a grid of 2^-6 so that every coordinate and edge
    is exact in f32: 2 n^2 coplanar triangles whose neighbours share edges
    exactly, in a shuffled order.  Returns the soup (v0, e1, e2), the
    shared interior edges that no axis is orthogonal to, as (a, b) vertex
    pairs (their inner points lie inside both triangles' boxes, not on a
    face), and the plane's normal."""
    g = np.arange(n + 1) * 32 - 16 * n
    x = g[:, None] + rng.integers(-8, 9, (n + 1, n + 1))
    y = g[None, :] + rng.integers(-8, 9, (n + 1, n + 1))
    P = np.stack([x, y, 2 * x + y], -1) / 64.0      # z = x / 2 + y / 4
    tris, edges = [], []
    for i in range(n):
        for j in range(n):
            p00, p10, p11, p01 = (P[i, j], P[i + 1, j], P[i + 1, j + 1],
                                  P[i, j + 1])
            tris += [(p00, p10, p11), (p00, p11, p01)]
            edges.append((p00, p11))                  # the quad's diagonal
            if i + 1 < n:
                edges.append((p10, p11))
            if j + 1 < n:
                edges.append((p11, p01))
    tris = np.asarray(tris)[rng.permutation(len(tris))]
    v0 = tris[:, 0].astype(np.float32)
    e1 = (tris[:, 1] - tris[:, 0]).astype(np.float32)
    e2 = (tris[:, 2] - tris[:, 0]).astype(np.float32)
    edges = np.asarray(edges)
    edges = edges[(edges[:, 0] != edges[:, 1]).all(1)]
    return (v0, e1, e2), edges, np.array([0.5, 0.25, -1.0])


def face_tie_scene():
    """Two clusters holding the same quad at x = 2, on the face between
    cells 1 and 2 of a 4 x 1 x 1 grid of unit cells: cluster 0 (slots 0,
    1, the lower) is listed in cell 2 alone, cluster 1 (slots 64, 65) in
    cell 1 alone.  Rays along +x meet cluster 1 first, at t equal to the
    cell's exit; rays along -x meet cluster 0 first.  Returns (nodes_f,
    nodes_i, woop, soup in slot order, grid, rays (pos, dir) of both
    directions, FlatBVH)."""
    v0 = np.array([[2, 0.25, 0.25], [2, 0.75, 0.75]] * 2, np.float32)
    e1 = np.array([[0, 0.5, 0], [0, -0.5, 0]] * 2, np.float32)
    e2 = np.array([[0, 0, 0.5], [0, 0, -0.5]] * 2, np.float32)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    bvh = TB.FlatBVH(
        bmin=np.stack([lo.min(0), lo[:2].min(0), lo[2:].min(0)]),
        bmax=np.stack([hi.max(0), hi[:2].max(0), hi[2:].max(0)]),
        skip=np.array([-1, 2, -1], np.int32),
        tri_offset=np.array([0, 0, 2], np.int32),
        tri_count=np.array([0, 2, 2], np.int32),
        order=np.arange(4, dtype=np.int32))
    nf, ni, woop, op = TTS.pack_stream_bvh(bvh, v0, e1, e2)
    sel = np.maximum(op, 0)
    soup = tuple(np.where((op < 0)[:, None], 0.0, a[sel]).astype(np.float32)
                 for a in (v0, e1, e2))
    cl_aabb = np.zeros((2, 8), np.float32)
    cl_aabb[:, 0:3] = np.minimum(lo[[0, 2]], lo[[1, 3]])
    cl_aabb[:, 3:6] = np.maximum(hi[[0, 2]], hi[[1, 3]])
    grid = TTD.GridPack(
        cell_tab=np.array([[0, 0, 1, 0], [0, 1, 0, 0], [1, 1, 0, 0],
                           [2, 0, 1, 0]], np.int32),
        cell_cl=np.array([[1, 0, 0, 0], [0, 0, 0, 0]], np.int32),
        cl_aabb=cl_aabb, outliers=np.zeros((1, 4), np.int32), n_outliers=0,
        lo=(0.0, 0.0, 0.0), h=(1.0, 1.0, 1.0), dims=(4, 1, 1))
    rng = np.random.default_rng(2)
    n = 256
    yz = rng.uniform(0.3, 0.7, (n, 2)).astype(np.float32)
    x = np.where(np.arange(n) < n // 2, 0.5, 3.5).astype(np.float32)
    pos = np.concatenate([x[:, None], yz], 1)
    d = np.zeros((n, 3), np.float32)
    d[:, 0] = np.where(np.arange(n) < n // 2, 1.0, -1.0)
    return nf, ni, woop, soup, grid, (pos, d), bvh


def cross_cell_tie_scene():
    """Two coplanar triangles sharing an edge at x = 2.5, in cell 2 of a
    4 x 1 x 1 grid of unit cells: A (slot 0) alone in cluster 0, listed in
    cell 2; B (slot 64) in cluster 1 beside a small triangle C (slot 65) at
    x = 1.5, so cluster 1 spans cells 1 and 2 and is listed in both.  Rays
    along the shared edge (y + z = 1, exact in f32) hit A and B at t = 2.0
    exactly.  A ray along +x meets B in cell 1, where the hit lies beyond
    the cell's exit (t = 1.5), and A only in cell 2; a ray along -x meets
    both in cell 2.  The dense plain version returns A (the lower slot) on
    every lane.  Returns (nodes_f, nodes_i, woop, soup in slot order, grid,
    rays (pos, dir) of both directions, FlatBVH)."""
    v0 = np.array([[2.5, 0.25, 0.25], [2.5, 0.75, 0.75],
                   [1.5, 0.9, 0.9]], np.float32)
    e1 = np.array([[0, 0.5, 0], [0, -0.5, 0], [0, 0.05, 0]], np.float32)
    e2 = np.array([[0, 0, 0.5], [0, 0, -0.5], [0, 0, 0.05]], np.float32)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    bvh = TB.FlatBVH(
        bmin=np.stack([lo.min(0), lo[0], lo[1:].min(0)]),
        bmax=np.stack([hi.max(0), hi[0], hi[1:].max(0)]),
        skip=np.array([-1, 2, -1], np.int32),
        tri_offset=np.array([0, 0, 1], np.int32),
        tri_count=np.array([0, 1, 2], np.int32),
        order=np.arange(3, dtype=np.int32))
    nf, ni, woop, op = TTS.pack_stream_bvh(bvh, v0, e1, e2)
    sel = np.maximum(op, 0)
    soup = tuple(np.where((op < 0)[:, None], 0.0, a[sel]).astype(np.float32)
                 for a in (v0, e1, e2))
    cl_aabb = np.zeros((2, 8), np.float32)
    cl_aabb[0, 0:3], cl_aabb[0, 3:6] = lo[0], hi[0]
    cl_aabb[1, 0:3], cl_aabb[1, 3:6] = lo[1:].min(0), hi[1:].max(0)
    grid = TTD.GridPack(
        cell_tab=np.array([[0, 0, 1, 0], [0, 1, 0, 0], [1, 2, 0, 0],
                           [3, 0, 1, 0]], np.int32),
        cell_cl=np.array([[1, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0]],
                         np.int32),
        cl_aabb=cl_aabb, outliers=np.zeros((1, 4), np.int32), n_outliers=0,
        lo=(0.0, 0.0, 0.0), h=(1.0, 1.0, 1.0), dims=(4, 1, 1))
    n = 256
    y = (256 + np.arange(1, n + 1) * 2) / 1024.0      # on the 2^-10 grid
    x = np.where(np.arange(n) < n // 2, 0.5, 3.5)
    pos = np.stack([x, y, 1.0 - y], 1).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    d[:, 0] = np.where(np.arange(n) < n // 2, 1.0, -1.0)
    return nf, ni, woop, soup, grid, (pos, d), bvh
