"""Hydra's ``.vsgf`` binary triangle mesh: reader and writer.

The counterpart of ``hydracore3_tpu/scene/vsgf.py`` (the reader) and of the
writer in ``hydracore3_tpu/api.py`` (``write_vsgf``).  Layout (the
reference's cmesh4 header and arrays):

  uint64 fileSizeInBytes
  uint32 verticesNum, indicesNum, materialsNum, flags
  float4 vPos4f[verticesNum]
  float4 vNorm4f[verticesNum]        (absent when flags & HAS_NO_NORMALS)
  float4 vTang4f[verticesNum]        (present when flags & HAS_TANGENT)
  float2 vTexCoord2f[verticesNum]
  uint32 indices[indicesNum]
  uint32 matIndices[indicesNum/3]
"""
from __future__ import annotations

import dataclasses

import numpy as np

HAS_TANGENT = 1
HAS_NO_NORMALS = 8

_HEADER = np.dtype([('size', '<u8'), ('verts', '<u4'), ('inds', '<u4'),
                    ('mats', '<u4'), ('flags', '<u4')])


@dataclasses.dataclass
class SimpleMesh:
    v_pos: np.ndarray       # [V, 4] float32
    v_norm: np.ndarray      # [V, 4] float32
    v_tang: np.ndarray      # [V, 4] float32
    v_texc: np.ndarray      # [V, 2] float32
    indices: np.ndarray     # [I] uint32 (3 per triangle)
    mat_indices: np.ndarray  # [I/3] uint32


def load_vsgf(path: str) -> SimpleMesh:
    with open(path, 'rb') as f:
        raw = f.read()
    header = np.frombuffer(raw[:24], dtype=_HEADER)[0]
    v, i, flags = (int(header['verts']), int(header['inds']),
                   int(header['flags']))
    off = 24

    def take(count, dtype, width):
        nonlocal off
        n = count * width
        arr = np.frombuffer(raw, dtype=dtype, count=n,
                            offset=off).reshape(count, width)
        off += n * np.dtype(dtype).itemsize
        return np.ascontiguousarray(arr)

    pos = take(v, '<f4', 4)
    norm = np.zeros_like(pos) if flags & HAS_NO_NORMALS else take(v, '<f4', 4)
    tang = take(v, '<f4', 4) if flags & HAS_TANGENT else np.zeros_like(pos)
    texc = take(v, '<f4', 2)
    ind = take(i, '<u4', 1).reshape(-1)
    mat = take(i // 3, '<u4', 1).reshape(-1)
    return SimpleMesh(pos, norm, tang, texc, ind, mat)


def save_vsgf(path: str, mesh: SimpleMesh):
    """Write ``mesh`` with normals and tangents (flags = HAS_TANGENT)."""
    blob = b''.join(np.ascontiguousarray(a).tobytes() for a in (
        mesh.v_pos, mesh.v_norm, mesh.v_tang, mesh.v_texc, mesh.indices,
        mesh.mat_indices))
    header = np.zeros(1, dtype=_HEADER)
    header['size'] = 24 + len(blob)
    header['verts'] = len(mesh.v_pos)
    header['inds'] = len(mesh.indices)
    header['mats'] = (int(mesh.mat_indices.max()) + 1
                      if len(mesh.mat_indices) else 0)
    header['flags'] = HAS_TANGENT
    with open(path, 'wb') as f:
        f.write(header.tobytes())
        f.write(blob)
