"""Binned-SAH BVH2 build through the repo's native builder.

``native/bvh_builder.cpp`` is the builder the JAX package loads
(``hydracore3_tpu/accel/build_bvh.py``); compiling the same source here
gives the same nodes and the same leaf order, so the port's triangle soup
is laid out exactly as the JAX build's.  Nodes are in DFS pre-order: an
internal node's hit-successor is ``i+1``, its miss-successor ``skip[i]``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

from ..utils.native import REPO_DIR, build_shared_library

_SRC = os.path.join(REPO_DIR, 'native', 'bvh_builder.cpp')
_lib = None


def _load():
    global _lib
    if _lib is None:
        path, _ = build_shared_library(
            'bvh_builder', [_SRC], ['g++', '-O3', '-shared', '-fPIC',
                                    '-std=c++17'])
        lib = ctypes.CDLL(path)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.hydra_build_bvh.restype = ctypes.c_int32
        lib.hydra_build_bvh.argtypes = [f32p, f32p, ctypes.c_int32,
                                        ctypes.c_int32, f32p, f32p, i32p,
                                        i32p, i32p, i32p]
        _lib = lib
    return _lib


@dataclasses.dataclass
class FlatBVH:
    bmin: np.ndarray        # [M, 3] f32
    bmax: np.ndarray        # [M, 3] f32
    skip: np.ndarray        # [M] i32: next node on miss / after a leaf
    tri_offset: np.ndarray  # [M] i32: first triangle of a leaf
    tri_count: np.ndarray   # [M] i32: 0 for internal nodes
    order: np.ndarray       # [T] i32: new-to-old triangle permutation


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
          max_leaf: int) -> FlatBVH:
    """Build over triangles (v0, v0 + e1, v0 + e2)."""
    v0 = np.asarray(v0, np.float32)
    v1 = v0 + np.asarray(e1, np.float32)
    v2 = v0 + np.asarray(e2, np.float32)
    tmin = np.ascontiguousarray(np.minimum(np.minimum(v0, v1), v2))
    tmax = np.ascontiguousarray(np.maximum(np.maximum(v0, v1), v2))
    T = len(tmin)
    cap = 2 * T + 1
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    tri_offset = np.empty(cap, np.int32)
    tri_count = np.empty(cap, np.int32)
    order = np.empty(T, np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = _load().hydra_build_bvh(
        tmin.ctypes.data_as(f32p), tmax.ctypes.data_as(f32p),
        ctypes.c_int32(T), ctypes.c_int32(max_leaf),
        bmin.ctypes.data_as(f32p), bmax.ctypes.data_as(f32p),
        skip.ctypes.data_as(i32p), tri_offset.ctypes.data_as(i32p),
        tri_count.ctypes.data_as(i32p), order.ctypes.data_as(i32p))
    if n <= 0:
        raise RuntimeError(f'native BVH build failed ({n}) for {T} triangles')
    return FlatBVH(bmin=bmin[:n].copy(), bmax=bmax[:n].copy(),
                   skip=skip[:n].copy(), tri_offset=tri_offset[:n].copy(),
                   tri_count=tri_count[:n].copy(), order=order)
