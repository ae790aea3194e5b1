"""Wide BVHs with small leaves: what the card's ray-query kernels walk.

This module has no counterpart in the JAX package.  That package's cluster
kernels test a whole tile of up to 64 triangles at once, so its tables keep
64-triangle leaves; a CUDA thread tests triangles one after another, and for
it a tree of 4-wide nodes over leaves of at most 4 triangles costs an order
of magnitude fewer tests.  The contract tables stay what they are
(``traverse_pallas.pack_cluster_bvh``'s ``nodes_f / nodes_i / tris12`` and
``traverse_tlas.pack_stream_tlas``'s ``TlasPack``): the plain versions read
them and every triangle index a kernel returns is an index into them.  From
the same triangles in the same order this module derives, in numpy on the
host:

* ``collapse``: a binary ``FlatBVH`` (built with ``max_leaf=LEAF_MAX``) into
  nodes of ``WIDTH`` children.  One node is one 128-byte record of eight
  4-word rows: the children's ``min.x, min.y, min.z, max.x, max.y, max.z``
  (one row each, one column per child, f32, exact), a row of child
  references (int32 bits) and a spare row.  A reference ``>= 0`` is a wide
  node, ``EMPTY`` no child, any other negative value ``~(offset * 8 +
  count)`` a leaf: ``count <= LEAF_MAX`` rows from ``offset`` of the fine
  triangle order (in a TLAS: one instance, ``offset`` its id);
* ``pack_wide_clusters``: the one-level tables of ``intersect_clusters``;
* ``pack_wide_tlas``: the two-level tables of ``intersect_stream_tlas``;
* ``widen_boxes`` / ``box_margin``: every child box grown by a margin
  (``MARGIN_REL``, stated below) in the tables whose walks must return
  what a test of every triangle returns, ties included: the streamed
  scenes' (``pack_wide_stream``) and the megakernel's
  (``models/megakernel.wide_table``);
* ``pack_wide_stream``: one table for both streamed queries,
  ``intersect_stream`` and ``intersect_march``: a tree per cluster of the
  stream BVH (its roots in ``cl_root``, what the march enters at a cluster)
  under the collapsed stream BVH itself, over the contract's Woop rows;
* ``walk_wide_plain``: the kernels' walk in plain torch, batched over rays,
  for the tests: near-first order with a per-lane stack, a popped entry
  culled when its entry distance lies beyond the best t, and ties settled by
  comparison (the lower contract index, and before that the instance met
  first by the contract TLAS's DFS, wins among equal t) instead of by
  visiting order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build_bvh

WIDTH = 4                    # children per node
LEAF_MAX = 4                 # triangles per leaf at most
EMPTY = -0x80000000          # no child / nothing left to visit
NODE_WORDS = 32              # 8 rows of 4 words
REF_ROW = 6                  # the row of child references
MAX_STACK = 64               # entries per ray the kernels provide
MARCH_STACK = 16             # entries per ray the march provides in a cluster
# A walk that settles ties by comparison returns what a test of every
# triangle returns only if it reaches the winner's leaf.  A hit on a box's
# face (a wall or the ground lies on its boxes' faces; neighbouring
# triangles share edges) can lie an ulp outside the box as the slab test
# computes it, while the Woop test takes it: its t and the slab's entry
# distance round differently (on the bench city: a wall's leaf entered at
# 8.081708 for a hit at 8.081695), and the lower-index twin's leaf is
# culled at an equal t.  Both roundings are an ulp or two of the
# coordinates, C * 2^-23 each (C the scene's largest |coordinate|, at least
# 1), times the small conditioning of the Woop rows of these scenes, so the
# tables whose walks must equal the plain version widen every child box on
# each side by C * MARGIN_REL, eight such ulps.  That stays below the
# 1e-5 * |p| and 5e-6 * max(1, ...) by which a bounce or shadow ray leaves
# its surface, so a ray does not re-enter the leaves it starts on; only the
# set of boxes entered grows, the tests stay the plain version's.
MARGIN_REL = 2.0 ** -20
_INF = float('inf')
_DET_EPS = 1e-12


def leaf_ref(offset, count):
    return ~(offset * 8 + count)


def require_stack(name: str, needed: int, provided: int = MAX_STACK):
    """Raise rather than let a walk overflow its stack."""
    if needed > provided:
        raise ValueError(f'{name}: the tree needs a stack of {needed} entries '
                         f'per ray, the walk provides {provided}')


def collapse(bvh: build_bvh.FlatBVH, leaf_offset=None, leaf_count=None,
             leaf_node=None, leaf_stack=None):
    """Collapse a binary BVH in DFS pre-order (left child ``i + 1``, right
    child ``skip[i + 1]``) into WIDTH-wide nodes: a node adopts its child
    of largest surface area's two children until it holds WIDTH or only
    leaves are left.  ``leaf_offset`` / ``leaf_count`` (default: the BVH's
    own) are what a leaf's reference carries.  With ``leaf_node`` (per
    binary node) a leaf becomes instead a reference to the wide node
    ``M + leaf_node[leaf]``, a subtree stored after this tree's M records,
    whose walk needs ``leaf_stack[leaf]`` entries of stack.

    Returns (nodes [M, NODE_WORDS] f32, stack): the records in DFS
    pre-order, root first, and the most entries a near-first walk of the
    tree can hold at once (at a node the nearest hit child is entered and
    the other children wait)."""
    off = bvh.tri_offset if leaf_offset is None else leaf_offset
    cnt = bvh.tri_count if leaf_count is None else leaf_count
    is_leaf = (bvh.tri_count > 0).tolist()
    skip = bvh.skip.tolist()
    ext = (bvh.bmax - bvh.bmin).astype(np.float64)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0]).tolist()
    if leaf_node is None and int(cnt.max(initial=0)) > LEAF_MAX:
        raise ValueError(f'a leaf holds {int(cnt.max())} > {LEAF_MAX} rows')

    kids_of = []             # per wide node: its binary-node children
    todo = [0]               # binary nodes whose children a wide node adopts
    slot_of = {}             # binary node -> wide node made from it
    while todo:
        b = todo.pop()
        slot_of[b] = len(kids_of)
        if is_leaf[b]:       # a tree that is one leaf: a root with one child
            kids_of.append([b])
            continue
        kids = [b + 1, skip[b + 1]]
        while len(kids) < WIDTH:
            inner = [k for k in kids if not is_leaf[k]]
            if not inner:
                break
            k = max(inner, key=area.__getitem__)
            at = kids.index(k)
            kids[at:at + 1] = [k + 1, skip[k + 1]]
        kids_of.append(kids)
        # the first child's subtree follows its parent (a stack: push last)
        todo.extend(k for k in reversed(kids) if not is_leaf[k])

    M = len(kids_of)
    nodes = np.zeros((M, NODE_WORDS), np.float32)
    refs = np.full((M, WIDTH), EMPTY, np.int64)
    for w, kids in enumerate(kids_of):
        for c, k in enumerate(kids):
            nodes[w, c:3 * WIDTH:WIDTH] = bvh.bmin[k]
            nodes[w, 3 * WIDTH + c:6 * WIDTH:WIDTH] = bvh.bmax[k]
            if not is_leaf[k]:
                refs[w, c] = slot_of[k]
            elif leaf_node is None:
                refs[w, c] = leaf_ref(int(off[k]), int(cnt[k]))
            else:
                refs[w, c] = M + int(leaf_node[k])
    nodes.view(np.int32)[:, REF_ROW * 4:REF_ROW * 4 + WIDTH] = refs
    # children follow their parents, so the subtrees' needs are known first
    stack = [0] * M
    for w in range(M - 1, -1, -1):
        below = max((stack[slot_of[k]] if not is_leaf[k] else
                     0 if leaf_node is None else int(leaf_stack[k])
                     for k in kids_of[w]), default=0)
        stack[w] = len(kids_of[w]) - 1 + below
    return nodes, stack[0]


def node_refs(nodes: np.ndarray) -> np.ndarray:
    """[M, WIDTH] int32 child references of packed nodes."""
    return nodes.view(np.int32)[:, REF_ROW * 4:REF_ROW * 4 + WIDTH]


def node_boxes(nodes: np.ndarray):
    """(bmin, bmax), each [M, WIDTH, 3], of packed nodes."""
    b = nodes[:, :6 * WIDTH].reshape(-1, 6, WIDTH).transpose(0, 2, 1)
    return b[:, :, 0:3], b[:, :, 3:6]


def box_margin(v0, e1, e2) -> float:
    """C * MARGIN_REL for a soup (v0, e1, e2 [T, 3]): C its largest
    |coordinate|, at least 1."""
    v0 = np.asarray(v0, np.float32)
    corners = np.concatenate([v0, v0 + np.asarray(e1, np.float32),
                              v0 + np.asarray(e2, np.float32)])
    return max(1.0, float(np.abs(corners).max(initial=0.0))) * MARGIN_REL


def widen_boxes(nodes: np.ndarray, margin: float):
    """Widen every child box of packed nodes by ``margin`` on each side, in
    place (computed in f64, rounded to f32)."""
    b = nodes[:, :6 * WIDTH].astype(np.float64)
    b[:, :3 * WIDTH] -= margin
    b[:, 3 * WIDTH:] += margin
    nodes[:, :6 * WIDTH] = b.astype(np.float32)


_WIDE_TABLES = ('nodes', 'rows', 'index', 'inst_f', 'inst_i', 'cl_root')


@dataclasses.dataclass(frozen=True)
class WidePack:
    """What a wide-BVH kernel walks; numpy on the host, tensors on a
    device.  One level (``inst_f is None``): ``rows`` are (v0, e1, e2)
    rows, tested with Moller-Trumbore, or with ``woop`` the contract's Woop
    rows (the streamed scenes', whose clusters root subtrees of their own:
    ``cl_root``).  Two levels: node 0 roots the TLAS, whose leaves are
    instances, the meshes' trees follow in ``nodes``, and ``rows`` are
    object-space Woop rows."""
    nodes: object          # [M, 32] f32: the node records
    rows: object           # [T, 12] f32: triangle rows in fine leaf order
    index: object          # [T] i32: fine position -> contract index
    stack: int             # stack entries per ray the walk needs
    inst_f: object = None  # [I, 16] f32: the contract's inverse matrices
    inst_i: object = None  # [I, 4] i32: (mesh's root node, the instance's
    #                        rank in the contract TLAS's DFS leaf order, 0, 0)
    woop: bool = False     # one level: rows are Woop rows
    cl_root: object = None  # [C] i32: the wide node that roots cluster c
    cl_stack: int = 0      # stack entries a walk from a cl_root needs
    margin: float = 0.0    # how far every child box was widened

    def to(self, device) -> 'WidePack':
        moved = {k: torch.as_tensor(getattr(self, k), device=device)
                 for k in _WIDE_TABLES if getattr(self, k) is not None}
        return dataclasses.replace(self, **moved)

    def tensors(self) -> dict:
        return {k: getattr(self, k) for k in _WIDE_TABLES
                if getattr(self, k) is not None}


def _fine_bvh(v0, e1, e2):
    """A binary BVH with leaves of at most LEAF_MAX over triangles given in
    contract order; its ``order`` sends a fine position to the contract
    position."""
    return build_bvh.build(v0, e1, e2, max_leaf=LEAF_MAX)


def pack_wide_clusters(tris12: np.ndarray) -> WidePack:
    """The card-side tables of ``intersect_clusters`` from the contract's
    ``tris12`` (unpadded leaf order): the same rows in the fine order, and
    the map back."""
    tris12 = np.asarray(tris12, np.float32)
    fine = _fine_bvh(tris12[:, 0:3], tris12[:, 3:6], tris12[:, 6:9])
    nodes, stack = collapse(fine)
    return WidePack(nodes=nodes, rows=np.ascontiguousarray(tris12[fine.order]),
                    index=fine.order.astype(np.int32), stack=stack)


def pack_wide_tlas(pk: dict, mesh_tris: list, tlas_bvh) -> WidePack:
    """The card-side tables of ``intersect_stream_tlas``.

    pk: ``pack_stream_tlas``'s dict (the contract tables); mesh_tris: per
    mesh (v0, e1, e2, slots): its triangles in object space and the global
    padded contract slot of each; tlas_bvh: the binary BVH over the
    instance boxes that the contract TLAS was packed from."""
    # the TLAS: one instance per leaf, its id where a mesh leaf has its offset
    tleaf = tlas_bvh.tri_count > 0
    inst_of = np.zeros(len(tleaf), np.int64)
    inst_of[tleaf] = tlas_bvh.order[tlas_bvh.tri_offset[tleaf]]
    tlas_nodes, stack_t = collapse(tlas_bvh, leaf_offset=inst_of,
                                   leaf_count=tleaf.astype(np.int64))
    parts, rows, index, roots = [tlas_nodes], [], [], []
    n_nodes = len(tlas_nodes)
    stack_m = n_rows = 0
    for v0, e1, e2, slots in mesh_tris:
        fine = _fine_bvh(v0, e1, e2)
        nodes, stack = collapse(fine, leaf_offset=fine.tri_offset + n_rows)
        refs = node_refs(nodes)
        refs[refs >= 0] += n_nodes                  # globalize node indices
        roots.append(n_nodes)
        parts.append(nodes)
        index.append(np.asarray(slots)[fine.order])
        rows.append(pk['woop'][index[-1]])
        stack_m = max(stack_m, stack)
        n_nodes += len(nodes)
        n_rows += len(slots)
    leaves = pk['tlas_i'][:, 1]
    dfs = leaves[leaves >= 0]
    inst_i = np.zeros((len(pk['inst_i']), 4), np.int32)
    inst_i[:, 0] = np.asarray(roots, np.int32)[pk['inst_i'][:, 1]]
    inst_i[dfs, 1] = np.arange(len(dfs), dtype=np.int32)
    return WidePack(nodes=np.concatenate(parts),
                    rows=np.ascontiguousarray(np.concatenate(rows)),
                    index=np.concatenate(index).astype(np.int32),
                    stack=stack_t + stack_m,
                    inst_f=pk['inst_f'], inst_i=inst_i)


def pack_wide_stream(nodes_f, nodes_i, woop, v0, e1, e2) -> WidePack:
    """The card-side table of both streamed queries, from the contract
    tables of ``traverse_stream.pack_stream_bvh`` (``nodes_f``, ``nodes_i``,
    ``woop`` [C * TBK, 12]) and the soup in the same padded slot order
    (``v0``, ``e1``, ``e2`` [C * TBK, 3]).

    Each cluster's real triangles (slots ``c * TBK`` to ``c * TBK +
    count``) get a tree of their own, rooted at wide node ``cl_root[c]``;
    the stream BVH, collapsed, sits on top (node 0 its root) with each of
    its leaves a reference to its cluster's root.  ``rows`` are the
    contract's Woop rows bit for bit and ``index`` their padded slots, so a
    walk returns the contract's t and triangle; padding slots appear
    nowhere.  ``stack`` is what a walk from node 0 needs, ``cl_stack`` what
    a walk from any cluster root needs.  Every child box is widened by
    ``box_margin`` of the soup (``margin``; the march widens the contract's
    cluster boxes by it as well)."""
    nodes_f = np.asarray(nodes_f, np.float32)
    nodes_i = np.asarray(nodes_i, np.int32)
    woop = np.asarray(woop, np.float32)
    leaf = nodes_i[:, 1] >= 0
    # the stream BVH as the SAH build gave it: a leaf is a cluster, its slot
    # where a triangle leaf has its offset
    top = build_bvh.FlatBVH(
        bmin=nodes_f[:, 0:3], bmax=nodes_f[:, 3:6], skip=nodes_i[:, 0],
        tri_offset=np.where(leaf, nodes_i[:, 1], 0),
        tri_count=np.where(leaf, nodes_i[:, 2], 0), order=None)
    count = np.zeros(int(leaf.sum()), np.int64)
    count[nodes_i[leaf, 1]] = nodes_i[leaf, 2]
    tbk = len(woop) // len(count)            # slots per cluster
    parts, index, roots, stacks = [], [], [], []
    n_nodes = n_rows = 0
    for c, k in enumerate(count.tolist()):
        s = np.arange(c * tbk, c * tbk + k)
        fine = _fine_bvh(v0[s], e1[s], e2[s])
        nodes, stack = collapse(fine, leaf_offset=fine.tri_offset + n_rows)
        parts.append(nodes)
        roots.append(n_nodes)
        stacks.append(stack)
        index.append(s[fine.order])
        n_nodes += len(nodes)
        n_rows += k
    roots, stacks = np.asarray(roots), np.asarray(stacks)
    top_nodes, stack = collapse(top, leaf_node=roots[top.tri_offset],
                                leaf_stack=stacks[top.tri_offset])
    M = len(top_nodes)
    nodes = np.concatenate([top_nodes, *parts])
    # each cluster's references are to its own records: after the top's
    refs = node_refs(nodes)[M:]
    base = np.repeat(roots + M, [len(p) for p in parts])[:, None]
    refs[:] = np.where(refs >= 0, refs + base, refs)
    index = np.concatenate(index)
    margin = box_margin(v0, e1, e2)
    widen_boxes(nodes, margin)
    return WidePack(nodes=nodes, rows=np.ascontiguousarray(woop[index]),
                    index=index.astype(np.int32), stack=stack, woop=True,
                    cl_root=(roots + M).astype(np.int32),
                    cl_stack=int(stacks.max()), margin=margin)


# ---- the walk in plain torch ----------------------------------------------

def _safe_inv(d):
    return torch.where(d.abs() > 1e-20, 1.0 / d, 1e30)


def _slab_entry(bmin, bmax, pos, inv, t_min, best_t):
    """Entry distance of rays into boxes ([n, W, 3] against [n, 3]), +inf
    on a miss: tn = max(mins, t_min), tf = min(maxs, best t), hit when
    tn <= tf (inclusive, so boxes at the best t are still entered)."""
    t0 = (bmin - pos[:, None, :]) * inv[:, None, :]
    t1 = (bmax - pos[:, None, :]) * inv[:, None, :]
    lo, hi = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tn = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]),
                    torch.fmax(lo[..., 2], t_min[:, None]))
    tf = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]),
                    torch.fmin(hi[..., 2], best_t[:, None]))
    return torch.where(tn <= tf, tn, _INF)


# compare-exchanges that sort 4 keys; the kernels run the same network
_SORT4 = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


def _sort_children(t, ref):
    """Sort each row's WIDTH (t, ref) pairs by t; a pair moves only when
    the later key is strictly smaller."""
    t, ref = list(t.unbind(1)), list(ref.unbind(1))
    for a, b in _SORT4:
        swap = t[b] < t[a]
        t[a], t[b] = (torch.where(swap, t[b], t[a]),
                      torch.where(swap, t[a], t[b]))
        ref[a], ref[b] = (torch.where(swap, ref[b], ref[a]),
                          torch.where(swap, ref[a], ref[b]))
    return torch.stack(t, 1), torch.stack(ref, 1)


def moller_trumbore(row, pos, d):
    """(t, u, v, non-degenerate) of rays against (v0, e1, e2) rows, the
    arithmetic of ``intersect_clusters_plain``."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row.T[:9]
    px, py, pz = pos.T
    dx, dy, dz = d.T
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
    return t, u, v, nondeg


def _woop(row, pos, d):
    """(t, u, v, True) of rays against Woop rows, the arithmetic of
    ``traverse_stream.intersect_plain``."""
    w = row.reshape(-1, 3, 4)

    def comp(c):
        wc = w[:, c]
        po = (wc[:, 0] * pos[:, 0] + wc[:, 1] * pos[:, 1]
              + wc[:, 2] * pos[:, 2] + wc[:, 3])
        pd = wc[:, 0] * d[:, 0] + wc[:, 1] * d[:, 1] + wc[:, 2] * d[:, 2]
        return po, pd

    (po_x, pd_x), (po_y, pd_y), (po_z, pd_z) = comp(0), comp(1), comp(2)
    t = -po_z / pd_z
    return t, po_x + t * pd_x, po_y + t * pd_y, torch.ones_like(t, dtype=bool)


def walk_wide_plain(pack: WidePack, ray_pos, ray_dir, t_min, t_max,
                    any_hit: bool = False, counts: dict | None = None,
                    root=0):
    """The wide-BVH kernels' walk in plain torch.

    One level returns ``intersect_clusters``' (t, tri, u, v), or over
    ``pack_wide_stream``'s Woop rows ``intersect_stream``'s; two levels
    ``intersect_stream_tlas``' (t, tri, u, v, inst).  Over Woop rows
    ``t_max`` must already be clamped below the miss sentinel.  Every lane
    keeps a stack of ``MAX_STACK`` (reference, entry distance) pairs; each
    round a lane visits one node (tests its children, enters the nearest
    hit one, pushes the others far to near), tests one leaf, or pops one
    entry.  ``root`` (one node, or one per lane) is where the walks start:
    node 0, or a cluster's root as the march enters it.  ``counts``, when
    given, receives the lanes' child-box tests, triangle tests and instance
    entries."""
    from .traverse_tlas import to_object_space
    require_stack('walk_wide_plain', pack.stack)
    two_level = pack.inst_f is not None
    dev = ray_pos.device
    N = ray_pos.shape[0]
    nodes = torch.as_tensor(pack.nodes, device=dev)
    rows = torch.as_tensor(pack.rows, device=dev)
    index = torch.as_tensor(pack.index, device=dev).to(torch.int64)
    boxes = nodes[:, :6 * WIDTH].reshape(-1, 6, WIDTH).transpose(1, 2)
    refs = nodes.view(torch.int32)[:, REF_ROW * 4:REF_ROW * 4 + WIDTH] \
        .to(torch.int64)
    if two_level:
        inst_f = torch.as_tensor(pack.inst_f, device=dev)
        inst_i = torch.as_tensor(pack.inst_i, device=dev).to(torch.int64)
    ray_pos = ray_pos.to(torch.float32)
    ray_dir = ray_dir.to(torch.float32)
    t_min = t_min.to(torch.float32)

    best_t = t_max.to(torch.float32).clone()
    best_i = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(N, dtype=torch.float32, device=dev)
    best_v = torch.zeros(N, dtype=torch.float32, device=dev)
    best_n = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_rank = torch.full((N,), -1, dtype=torch.int64, device=dev)
    # the ray a lane walks with: the world's, or the entered instance's
    pos, d = ray_pos.clone(), ray_dir.clone()
    inv = _safe_inv(d)
    cur = torch.as_tensor(root, dtype=torch.int64, device=dev) \
        .expand(N).clone()
    sp = torch.zeros(N, dtype=torch.int64, device=dev)
    st_ref = torch.full((N, MAX_STACK), EMPTY, dtype=torch.int64, device=dev)
    st_t = torch.zeros((N, MAX_STACK), dtype=torch.float32, device=dev)
    inst = torch.full((N,), -1, dtype=torch.int64, device=dev)
    base = torch.zeros(N, dtype=torch.int64, device=dev)     # sp at entry
    done = ~(best_t > t_min)              # an empty interval walks nothing
    n_box = n_tri = n_inst = 0
    test = _woop if two_level or pack.woop else moller_trumbore

    while not bool(done.all()):
        # what each live lane holds as the round begins
        live = ~done
        at = torch.nonzero(live & (cur >= 0)).squeeze(1)
        lf = torch.nonzero(live & (cur < 0) & (cur != EMPTY)).squeeze(1)
        pp = torch.nonzero(live & (cur == EMPTY)).squeeze(1)
        # ---- a wide node: test its children, enter the nearest, push the
        # others far to near
        if at.numel():
            c = cur[at]
            r = refs[c]
            bx = boxes[c]                                    # [n, W, 6]
            tn = _slab_entry(bx[..., 0:3], bx[..., 3:6], pos[at], inv[at],
                             t_min[at], best_t[at])
            tn = torch.where(r == EMPTY, _INF, tn)
            n_box += int((r != EMPTY).sum())
            tn, r = _sort_children(tn, r)
            for k in range(WIDTH - 1, 0, -1):
                push = tn[:, k] < _INF
                w = at[push]
                st_ref[w, sp[w]] = r[push, k]
                st_t[w, sp[w]] = tn[push, k]
                sp[w] += 1
            cur[at] = torch.where(tn[:, 0] < _INF, r[:, 0], EMPTY)
        # ---- a leaf: an instance to enter, or triangles to test
        if lf.numel():
            code = ~cur[lf]
            off, cnt = code >> 3, code & 7
            cur[lf] = EMPTY
            if two_level:
                enter = inst[lf] < 0                         # a TLAS leaf
                e, who = lf[enter], off[enter]
                n_inst += int(e.numel())
                # per-lane matrix entries: [16, n] against [n] components
                pos[e], d[e] = to_object_space(inst_f[who].T, ray_pos[e],
                                               ray_dir[e])
                inv[e] = _safe_inv(d[e])
                inst[e] = who
                base[e] = sp[e]
                cur[e] = inst_i[who, 0]
                lf, off, cnt = lf[~enter], off[~enter], cnt[~enter]
            for k in range(LEAF_MAX):
                m = (k < cnt) & ~done[lf]
                w = lf[m]
                if not w.numel():
                    continue
                fine = off[m] + k
                n_tri += int(w.numel())
                t, u, v, ok = test(rows[fine], pos[w], d[w])
                tri, bt, bi = index[fine], best_t[w], best_i[w]
                ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
                    & (t > t_min[w])
                take = ok & (t < bt)
                if any_hit:
                    w = w[take]
                    best_t[w] = t_min[w]
                    best_i[w] = 0 if two_level or pack.woop else tri[take]
                    done[w] = True
                    continue
                # among equal t: the earlier instance, then the lower index
                tie = ok & (t == bt) & (bi >= 0)
                if two_level:
                    rank, br = inst_i[inst[w], 1], best_rank[w]
                    tie = tie & ((rank < br) | ((rank == br) & (tri < bi)))
                    best_n[w[take | tie]] = inst[w[take | tie]]
                    best_rank[w[take | tie]] = rank[take | tie]
                else:
                    tie = tie & (tri < bi)
                take = take | tie
                w = w[take]
                best_t[w], best_u[w], best_v[w] = t[take], u[take], v[take]
                best_i[w] = tri[take]
        # ---- nothing in hand: pop one entry, culled when it lies beyond
        # the best t
        if pp.numel():
            if two_level:
                # the instance's subtree is exhausted: back to the world
                out = pp[(inst[pp] >= 0) & (sp[pp] == base[pp])]
                pos[out], d[out] = ray_pos[out], ray_dir[out]
                inv[out] = _safe_inv(d[out])
                inst[out] = -1
            empty = sp[pp] == 0
            done[pp[empty]] = True
            pp = pp[~empty]
            sp[pp] -= 1
            keep = st_t[pp, sp[pp]] <= best_t[pp]
            cur[pp[keep]] = st_ref[pp[keep], sp[pp[keep]]]
    if counts is not None:
        counts.update(box_tests=n_box, tri_tests=n_tri, instances=n_inst)
    if two_level:
        return best_t, best_i, best_u, best_v, best_n
    return best_t, best_i, best_u, best_v
