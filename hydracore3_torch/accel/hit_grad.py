"""The nearest hit's gradient with respect to the ray, one code on every device.

The JAX package differentiates its small scenes' trace (``intersect_brute``,
plain XLA) with ``jax.grad``: the hit's triangle is discrete, and t, u and v
carry the derivative of the Moller-Trumbore arithmetic at that triangle with
respect to the ray's origin and direction.  The port answers the query with
a kernel on the card, whose outputs autograd cannot see through, and with a
plain version on the CPU, which it can.  ``nearest_with_grad`` puts one
``torch.autograd.Function`` around the query on both devices: its forward is
the query exactly as a render without autograd runs it (the kernel, or the
plain version under ``torch.no_grad()``); its backward recomputes (t, u, v)
by ``wide_bvh.moller_trumbore`` at each lane's returned triangle from the
triangle's world rows and takes their gradient with respect to the ray.
Missed lanes get none.  The triangle index gets no gradient, nor does an
any-hit query's occlusion bit, as in the JAX package.

The two-level classes (``stream_tlas``, moving instances) keep no world
soup.  ``two_level_with_grad`` puts ``_TwoLevelHit`` around their query
(K4, ``traverse_tlas.intersect_stream_tlas``, or K4m,
``two_level.intersect_two_level`` at each ray's time): its backward takes
each lane's ray into its hit instance's object space by the instance's
inverse matrix (K4m's lerped at the ray's time and inverted by
``two_level._inverse4x4``, as the forward does) and recomputes
Moller-Trumbore there on the hit triangle's object-space rows; the
object-space t is the world t, since the direction is not renormalized.
The instance and the time get no gradient.
"""
from __future__ import annotations

import torch

from ..utils.lmath import tracks_grad
from . import traverse_tlas as TT
from . import two_level as TL2
from . import wide_bvh as WB


def _ray_grad(rows, ray_pos, ray_dir, found, cots, to_object=None):
    """The gradient with respect to (ray_pos, ray_dir) of the cotangents
    ``cots`` (of t, u, v; None where not wanted) of Moller-Trumbore
    against ``rows``, the ray first taken through ``to_object(pos, d)``
    when given.  Missed lanes take none, whatever their rays hold (a
    shadow ray that is not traced may have no direction)."""
    with torch.enable_grad():
        pos = ray_pos.detach().requires_grad_()
        d = ray_dir.detach().requires_grad_()
        op, od = (pos, d) if to_object is None else to_object(pos, d)
        t, u, v, _ = WB.moller_trumbore(rows, op, od)
        outs = [(x, g) for x, g in zip((t, u, v), cots) if g is not None]
        if not outs:
            return None, None
        grads = torch.autograd.grad([x for x, _ in outs], (pos, d),
                                    [g for _, g in outs], allow_unused=True)
    return tuple(None if g is None else torch.where(found[:, None], g, 0.0)
                 for g in grads)


class _NearestHit(torch.autograd.Function):
    """(t, tri, u, v) of ``query(ray_pos, ray_dir)``; the backward reads the
    returned triangles' (v0, e1, e2) rows through ``rows_at(tri)``."""

    @staticmethod
    def forward(ctx, ray_pos, ray_dir, query, rows_at):
        t, tri, u, v = query(ray_pos, ray_dir)
        ctx.rows_at = rows_at
        ctx.save_for_backward(ray_pos, ray_dir, tri)
        ctx.mark_non_differentiable(tri)
        return t, tri, u, v

    @staticmethod
    def backward(ctx, g_t, _g_tri, g_u, g_v):
        ray_pos, ray_dir, tri = ctx.saved_tensors
        rows = ctx.rows_at(torch.clamp(tri, min=0))
        g_pos, g_dir = _ray_grad(rows, ray_pos, ray_dir, tri >= 0,
                                 (g_t, g_u, g_v))
        return g_pos, g_dir, None, None


class _TwoLevelHit(torch.autograd.Function):
    """(t, tri, u, v, inst) of a two-level ``query(ray_pos, ray_dir)``;
    the backward reads the returned triangles' object-space rows through
    ``rows_at(tri)`` and takes the rays into the returned instances'
    object space through ``to_object(inst, pos, d)``."""

    @staticmethod
    def forward(ctx, ray_pos, ray_dir, query, rows_at, to_object):
        t, tri, u, v, inst = query(ray_pos, ray_dir)
        ctx.rows_at, ctx.to_object = rows_at, to_object
        ctx.save_for_backward(ray_pos, ray_dir, tri, inst)
        ctx.mark_non_differentiable(tri, inst)
        return t, tri, u, v, inst

    @staticmethod
    def backward(ctx, g_t, _g_tri, g_u, g_v, _g_inst):
        ray_pos, ray_dir, tri, inst = ctx.saved_tensors
        rows = ctx.rows_at(torch.clamp(tri, min=0))
        k = torch.clamp(inst, min=0)
        g_pos, g_dir = _ray_grad(rows, ray_pos, ray_dir,
                                 (tri >= 0) & (inst >= 0), (g_t, g_u, g_v),
                                 lambda p, d: ctx.to_object(k, p, d))
        return g_pos, g_dir, None, None, None


def nearest_with_grad(query, rows_at, ray_pos, ray_dir):
    """``query(ray_pos, ray_dir)`` -> (t, tri, u, v), through the hit's
    ``Function`` when autograd tracks the ray, else the query itself (the
    same ops and launches as a render without autograd).  ``rows_at(idx)``
    gives the [K, >= 9] (v0, e1, e2) world rows of triangles ``idx`` in the
    query's index space."""
    if not tracks_grad(ray_pos, ray_dir):
        return query(ray_pos, ray_dir)
    return _NearestHit.apply(ray_pos, ray_dir, query, rows_at)


def tlas_with_grad(pack, ray_pos, ray_dir, t_min, t_max):
    """K4's nearest hit (``intersect_stream_tlas``): (t, tri, u, v, inst),
    t, u and v carrying the gradient of the ray where autograd tracks
    it.  The backward reads ``pack.rows`` and the instances' inverse
    rows ``pack.inst_f``."""
    def query(pos, d):
        return TT.intersect_stream_tlas(pack, pos, d, t_min, t_max)

    if not tracks_grad(ray_pos, ray_dir):
        return query(ray_pos, ray_dir)

    def to_object(inst, pos, d):
        return TT.to_object_space(pack.inst_f[inst].T, pos, d)

    return _TwoLevelHit.apply(ray_pos, ray_dir, query,
                              lambda idx: pack.rows[idx], to_object)


def two_level_with_grad(tl, ray_pos, ray_dir, t_min, t_max, time):
    """K4m's nearest hit at each ray's ``time``
    (``two_level.intersect_two_level``), in its contract's order (t, tri,
    inst, u, v), t, u and v carrying the gradient of the ray where
    autograd tracks it.  The backward reads ``two_level.obj_rows`` and the
    hit instances' matrices lerped at the rays' times, then inverted."""
    def query(pos, d):
        t, tri, inst, u, v = TL2.intersect_two_level(tl, pos, d, t_min,
                                                     t_max, time=time)
        return t, tri, u, v, inst

    if not tracks_grad(ray_pos, ray_dir):
        t, tri, u, v, inst = query(ray_pos, ray_dir)
        return t, tri, inst, u, v
    rows = TL2.obj_rows(tl)
    tm = (torch.zeros(ray_pos.shape[0], dtype=torch.float32,
                      device=ray_pos.device) if time is None
          else time.detach().to(torch.float32))

    def to_object(inst, pos, d):
        inv = TL2._inverse4x4(TL2.instance_matrix(
            tl.inst_m0[inst], tl.inst_m1[inst], tl.inst_has_motion[inst],
            tm).reshape(-1, 4, 4))
        return TL2.to_object_space(inv, pos, d)

    t, tri, u, v, inst = _TwoLevelHit.apply(
        ray_pos, ray_dir, query, lambda idx: rows[idx], to_object)
    return t, tri, inst, u, v


def cluster_rows(tris12):
    """``rows_at`` over ``cl_tris12`` (the small and mid-size classes)."""
    return lambda idx: tris12[idx]


def soup_rows(scene):
    """``rows_at`` over the streamed soup ``tri_v0 / tri_e1 / tri_e2``."""
    return lambda idx: torch.cat([scene.tri_v0[idx], scene.tri_e1[idx],
                                  scene.tri_e2[idx]], -1)
