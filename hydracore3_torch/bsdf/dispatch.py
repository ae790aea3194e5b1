"""Material dispatch: batched MaterialSampleAndEval / MaterialEval.

The counterpart of ``hydracore3_tpu/bsdf/dispatch.py`` for the materials
the slice covers: GLTF (from the old-Hydra lambert conversion) with a
slot-0 diffuse texture, and the emissive light-source material, which
samples and evaluates to zero.  Scenes with other materials, blends, bump
or four-texture maps are refused at build time (``scene/build.py``).
The JAX package's one-hot gathers become plain indexing.
"""
from __future__ import annotations

import torch

from ..utils.lmath import mul_rows_2x4
from ..ops import rng as RNG
from ..ops import texture as TEX
from ..scene.build import MAT_TYPE_GLTF, GLTF_COLOR_BASE
from . import gltf as GLTF


def gather_material(scene, mat_id):
    """Per-ray material rows (cmaterial.h Material) by plain indexing."""
    return dict(mtype=scene.mat_mtype[mat_id],
                cflags=scene.mat_cflags[mat_id],
                texid=scene.mat_texid[mat_id],
                colors=scene.mat_colors[mat_id],
                row0=scene.mat_row0[mat_id],
                row1=scene.mat_row1[mat_id],
                data=scene.mat_data[mat_id])


def _clamp_tex(scene, texid):
    """Invalid texture ids -> the white dummy slot 0."""
    bad = (texid < 0) | (texid >= scene.textures.offset.shape[0])
    return torch.where(bad, 0, texid)


def slot0_tex_color(scene, md, tc):
    """Material slot-0 texture tap through the slot's texture matrix."""
    tc_t = mul_rows_2x4(md['row0'][..., 0, :], md['row1'][..., 0, :], tc)
    return TEX.sample(scene.textures, _clamp_tex(scene, md['texid'][..., 0]),
                      tc_t)


def make_shading_ctx(scene, meta, mat_id, n, tang, tc):
    """Per-bounce shading data computed once and shared by NEE's
    MaterialEval, the bounce's MaterialSampleAndEval and the emissive-hit
    branch."""
    md = gather_material(scene, mat_id)
    ones = torch.ones(mat_id.shape + (4,), dtype=torch.float32,
                      device=mat_id.device)
    return dict(md=md, shade_normal=n, tex_color=slot0_tex_color(scene, md, tc),
                four_params=ones)


def material_sample_and_eval(ctx, rng_state, live, v):
    """MaterialSampleAndEval (integrator_pt_mat.cpp:109-306), batched.

    Returns (sample dict, new rng state); the light-source material yields
    val 0, dir (0, 1, 0), pdf 1, flags 0."""
    md = ctx['md']
    rng_state, rands = RNG.rnd_mats(rng_state, live)
    base = md['colors'][..., GLTF_COLOR_BASE, :] * ctx['tex_color']
    s = GLTF.sample_and_eval(md, rands, v, ctx['shade_normal'], base,
                             ctx['four_params'])
    sel = md['mtype'] == MAT_TYPE_GLTF
    empty_dir = torch.tensor([0.0, 1.0, 0.0], device=v.device).expand_as(v)
    res = dict(val=torch.where(sel[..., None], s['val'], 0.0),
               dir=torch.where(sel[..., None], s['dir'], empty_dir),
               pdf=torch.where(sel, s['pdf'], 1.0),
               flags=torch.where(sel, s['flags'], 0))
    return res, rng_state


def material_eval(ctx, l, v):
    """MaterialEval (integrator_pt_mat.cpp:308-528). dict(val [N, 4],
    pdf [N]); zero for the light-source material."""
    md = ctx['md']
    base = md['colors'][..., GLTF_COLOR_BASE, :] * ctx['tex_color']
    e = GLTF.eval(md, l, v, ctx['shade_normal'], base, ctx['four_params'])
    sel = md['mtype'] == MAT_TYPE_GLTF
    return dict(val=torch.where(sel[..., None], e['val'], 0.0),
                pdf=torch.where(sel, e['pdf'], 0.0))
