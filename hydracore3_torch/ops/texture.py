"""Flattened texture pool with batched bilinear sampling.

All texture slots' texels live in one flat ``[P, 4]`` float32 tensor; a
per-slot table stores (offset, width, height, filter, addressU, addressV).
Slot 0 is a 1x1 white dummy (MakeWhiteDummy,
integrator_pt_scene_tex.cpp:7-16).  LDR textures are decoded sRGB -> linear
(pow 2.2, as the reference's LDR pipeline) at build time, so the device pool
is linear float.  The counterpart of ``hydracore3_tpu/ops/texture.py``
without its TPU quad-packed pool: a tap is four row fetches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.spans import span

FILTER_NEAREST = 0
FILTER_LINEAR = 1

ADDR_WRAP = 0
ADDR_CLAMP = 1
ADDR_MIRROR = 2
# sampled as clamp, as the JAX package samples them
ADDR_BORDER = 3
ADDR_MIRROR_ONCE = 4

_ADDR_FROM_STR = {
    'wrap': ADDR_WRAP, 'clamp': ADDR_CLAMP, 'mirror': ADDR_MIRROR,
    'border': ADDR_BORDER, 'mirror_once': ADDR_MIRROR_ONCE,
}


def addr_mode_from_string(s: str) -> int:
    return _ADDR_FROM_STR.get(s, ADDR_WRAP)


def decode_image(data: np.ndarray, srgb_to_linear: bool = True
                 ) -> np.ndarray:
    """[H, W, 4] uint8 (sRGB unless ``srgb_to_linear`` is False) or float32
    (linear) -> [H, W, 4] float32 linear."""
    if data.dtype != np.uint8:
        return np.asarray(data, np.float32)
    img = data.astype(np.float32) / 255.0
    if srgb_to_linear:
        img[..., :3] = np.power(img[..., :3], 2.2, dtype=np.float32)
    return img


def decode_chunk(path: str, width: int, height: int, bpp: int, offset: int,
                 srgb_to_linear: bool) -> np.ndarray:
    """A Hydra ``.image4ub`` / ``.image4f`` chunk -> [H, W, 4] float32
    linear (``hydracore3_tpu/ops/texture.py`` ``decode_chunk``).

    A chunk is int32 w, int32 h, then w * h * 4 bytes (u8 RGBA) or
    w * h * 4 float32.  ``offset`` is where the texels start (the library's
    ``offset`` attribute, 8 for a chunk of its own), the 8-byte header just
    before them, so several chunks may share one file; the JAX package
    reads the header at byte 0 whatever the offset, which is the same for
    the offsets 0 and 8 a library of one chunk per file carries.  ``width``
    and ``height`` are the library's; the header's are used."""
    head = max(int(offset) - 8, 0)
    with open(path, 'rb') as f:
        f.seek(head)
        w, h = (int(x) for x in np.frombuffer(f.read(8), '<i4', count=2))
        if w == 0 or h == 0:
            return np.ones((1, 1, 4), np.float32)
        n = w * h * 4
        if bpp == 16:
            data = np.frombuffer(f.read(4 * n), '<f4', count=n)
        else:
            data = np.frombuffer(f.read(n), np.uint8, count=n)
    return decode_image(data.reshape(h, w, 4), srgb_to_linear)


def load_image_file(path: str, srgb_to_linear: bool) -> np.ndarray:
    """A .bmp / .png / .jpg / .exr file through imageio -> [H, W, 4] float32
    linear.  Raises, naming the file, where imageio is missing."""
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError(f'{path}: reading this image format needs imageio, '
                          'which is not installed; only .image4ub / .image4f '
                          'chunks load without it') from e
    img = np.asarray(iio.imread(path))
    if img.dtype == np.uint8:
        imgf = img.astype(np.float32) / 255.0
        if srgb_to_linear:
            imgf = np.power(imgf, 2.2, dtype=np.float32)
    else:
        imgf = img.astype(np.float32)
    if imgf.ndim == 2:
        imgf = imgf[..., None].repeat(3, axis=-1)
    if imgf.shape[-1] == 3:
        imgf = np.concatenate([imgf, np.ones_like(imgf[..., :1])], axis=-1)
    return imgf


class TexturePoolBuilder:
    """Host-side accumulation of texture slots into one flat array."""

    def __init__(self):
        self._texels: list[np.ndarray] = []
        self._table: list[tuple] = []
        self._total = 0
        self.add(np.ones((1, 1, 4), np.float32), filter_mode=FILTER_NEAREST,
                 addr_u=ADDR_CLAMP, addr_v=ADDR_CLAMP)

    def add(self, img: np.ndarray, filter_mode=FILTER_LINEAR,
            addr_u=ADDR_WRAP, addr_v=ADDR_WRAP) -> int:
        """img: [H, W, 4] float32 linear.  Returns the slot id."""
        if img.ndim != 3 or img.shape[2] != 4:
            raise ValueError(f'texture must be [H, W, 4], got {img.shape}')
        h, w = img.shape[:2]
        slot = len(self._table)
        self._table.append((self._total, w, h, filter_mode, addr_u, addr_v))
        self._texels.append(img.reshape(-1, 4).astype(np.float32))
        self._total += w * h
        return slot

    def __len__(self) -> int:
        return len(self._table)

    def slot_image(self, slot: int) -> np.ndarray:
        """[H, W, 4] texels of a slot."""
        _, w, h = self._table[slot][:3]
        return self._texels[slot].reshape(h, w, 4)

    def slot_const_value(self, slot: int):
        """The single texel of a 1x1 slot (for the const-texture fold), or
        None when the slot is larger."""
        if self._table[slot][1:3] != (1, 1):
            return None
        return self._texels[slot][0].copy()

    def finish(self, device) -> 'TexturePool':
        table = torch.as_tensor(np.array(self._table, np.int64), device=device)
        texels = torch.as_tensor(np.concatenate(self._texels, axis=0),
                                 device=device)
        return TexturePool(texels=texels, offset=table[:, 0],
                           width=table[:, 1], height=table[:, 2],
                           filter=table[:, 3], addr_u=table[:, 4],
                           addr_v=table[:, 5])


@dataclasses.dataclass(frozen=True)
class TexturePool:
    texels: torch.Tensor   # [P, 4] f32
    offset: torch.Tensor   # [T] i64
    width: torch.Tensor
    height: torch.Tensor
    filter: torch.Tensor
    addr_u: torch.Tensor
    addr_v: torch.Tensor


def _norm_coord(u, mode):
    """Map a normalized coord into [0,1) (wrap), [0,1] (clamp) or reflected
    [0,1] (mirror) with float ops only."""
    wrapped = u - torch.floor(u)
    clamped = torch.clamp(u, 0.0, 1.0)
    half = 0.5 * u
    m2 = 2.0 * (half - torch.floor(half))
    mirrored = torch.where(m2 < 1.0, m2, 2.0 - m2)
    return torch.where(mode == ADDR_WRAP, wrapped,
                       torch.where(mode == ADDR_MIRROR, mirrored, clamped))


def sample(pool: TexturePool, tex_id, uv):
    """Batched texture tap: tex_id int [...], uv f32 [..., 2] -> [..., 4].

    Bilinear with half-texel centres (LiteImage), or nearest = int(u * w)
    for FILTER_NEAREST slots."""
    with span('hc3.gather.texel'):
        return _tap(pool, tex_id, uv)


def _tap(pool: TexturePool, tex_id, uv):
    off = pool.offset[tex_id]
    w = pool.width[tex_id]
    h = pool.height[tex_id]
    au = pool.addr_u[tex_id]
    av = pool.addr_v[tex_id]
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    nu = _norm_coord(uv[..., 0], au)
    nv = _norm_coord(uv[..., 1], av)
    ffx = nu * wf - 0.5
    ffy = nv * hf - 0.5
    px = torch.floor(ffx)
    py = torch.floor(ffy)
    fx = (ffx - px)[..., None]
    fy = (ffy - py)[..., None]
    px = px.to(torch.int64)   # in [-1, w-1]
    py = py.to(torch.int64)
    w1, h1 = w - 1, h - 1
    wrap_u = au == ADDR_WRAP
    wrap_v = av == ADDR_WRAP

    def wrap_ix(ix):
        ix_w = torch.where(ix < 0, w1, torch.where(ix > w1, 0, ix))
        return torch.where(wrap_u, ix_w, torch.minimum(torch.clamp(ix, min=0),
                                                       w1))

    def wrap_iy(iy):
        iy_w = torch.where(iy < 0, h1, torch.where(iy > h1, 0, iy))
        return torch.where(wrap_v, iy_w, torch.minimum(torch.clamp(iy, min=0),
                                                       h1))

    def fetch(ix, iy):
        return pool.texels[off + iy * w + ix]

    x0, x1 = wrap_ix(px), wrap_ix(px + 1)
    y0, y1 = wrap_iy(py), wrap_iy(py + 1)
    bilinear = (fetch(x0, y0) * (1 - fx) * (1 - fy) + fetch(x1, y0) * fx * (1 - fy)
                + fetch(x0, y1) * (1 - fx) * fy + fetch(x1, y1) * fx * fy)
    nx = torch.minimum(torch.clamp((nu * wf).to(torch.int64), min=0), w1)
    ny = torch.minimum(torch.clamp((nv * hf).to(torch.int64), min=0), h1)
    nearest = fetch(nx, ny)
    return torch.where((pool.filter[tex_id] == FILTER_LINEAR)[..., None],
                       bilinear, nearest)
