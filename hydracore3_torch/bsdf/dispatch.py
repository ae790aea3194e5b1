"""Material dispatch: batched MaterialSampleAndEval / MaterialEval.

The counterpart of ``hydracore3_tpu/bsdf/dispatch.py`` for the
GLTF, diffuse (Lambert, Oren-Nayar), conductor (smooth, rough), dielectric,
old-Hydra glass, plastic, thin-film and blend materials and the emissive
light-source material, which samples and evaluates to zero.  Each material
type present in the scene (``meta.mat_types_present``) is evaluated for
the whole batch and merged with selects; absent types cost nothing.

A blend descends with masked draws in the sample (the JAX loop of
``max_blend_stack`` rounds, integrator_pt_mat.cpp:125-130) and walks a
fixed-depth stack of (material, weight) in the eval (:317-525); only the
rounds and stack steps that can change a lane of the scene run, each step
evaluating only the material types a lane can be at in it
(``meta.blend_sample_rounds``, ``meta.blend_eval_types``; the rest are
no-ops for every lane).  With a blend in the scene there is no shared
shading context: the rows are gathered per descent step.  A normal map
(``meta.has_bump``) bends the shading normal, with the reference's two
cosine corrections (the sample's and the eval's differ, as in
integrator_pt_mat.cpp); a GLTF's slot-2/3 maps (``meta.has_four_textures``)
scale its glossiness, metalness and coat.  The JAX package's one-hot
gathers become plain indexing.

In spectral mode (``wavelengths`` [N, 4] given) a diffuse's or plastic's
reflectance is its SPD at the hero wavelengths, or its spectral texture's
stack lerped between the wavelengths it names, else its color with no
texture multiply; a conductor's eta and k and a dielectric's interior IOR
are their SPDs' (the dielectric's at the hero wavelength, diverging the
waves where it has one); the thin film takes the hero wavelength.
"""
from __future__ import annotations

import torch

from ..utils.lmath import cross, dot, mul_rows_2x4, normalize
from ..utils.spans import span
from ..ops import rng as RNG
from ..ops import spectrum as SPEC
from ..ops import texture as TEX
from ..scene.build import (MAT_TYPE_GLTF, MAT_TYPE_DIFFUSE,
                           MAT_TYPE_CONDUCTOR, MAT_TYPE_DIELECTRIC,
                           MAT_TYPE_GLASS, MAT_TYPE_PLASTIC, MAT_TYPE_BLEND,
                           MAT_TYPE_THIN_FILM, GLTF_COLOR_BASE,
                           DIFFUSE_COLOR, PLASTIC_COLOR, BLEND_WEIGHT,
                           CONDUCTOR_ETA, CONDUCTOR_K, DIELECTRIC_ETA_INT,
                           FLAG_FOUR_TEXTURES,
                           FLAG_PACK_FOUR_PARAMS_IN_TEXTURE,
                           FLAG_NMAP_INVERT_X, FLAG_NMAP_INVERT_Y,
                           FLAG_NMAP_SWAP_XY)
from . import common as C
from . import conductor as COND
from . import dielectric as DIEL
from . import diffuse as DIFF
from . import film as FILM
from . import glass as GLASS
from . import gltf as GLTF
from . import plastic as PLAST


def gather_material(scene, mat_id):
    """Per-ray material rows (cmaterial.h Material) by plain indexing.  Ids
    past the table clamp to its last row, as the JAX package's gathers do:
    a dead lane's flags keep the event bits of its last sample in the
    material-id field, and its rows are read and discarded."""
    with span('hc3.gather.material'):
        mat_id = torch.clamp(mat_id, 0, scene.mat_mtype.shape[0] - 1)
        return dict(id=mat_id, mtype=scene.mat_mtype[mat_id],
                    cflags=scene.mat_cflags[mat_id],
                    nonlinear=scene.mat_nonlinear[mat_id],
                    texid=scene.mat_texid[mat_id],
                    datai=scene.mat_datai[mat_id],
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


def _spd(scene, md, spec_slot, wavelengths):
    """(has an SPD [N], the SPD at ``wavelengths`` [N, 4], spectrum row
    [N]) of the material's slot ``spec_slot``."""
    spec_id = scene.mat_spdid[md['id'], spec_slot]
    sid = torch.clamp(spec_id, 0, scene.spec_offset_sz.shape[0] - 1)
    return (spec_id != -1, SPEC.sample_uniform_spectrum(
        scene.spec_values, scene.spec_offset_sz[sid, 0], wavelengths), sid)


def sample_mat_color_spectrum(scene, meta, md, wavelengths, color_slot,
                              spec_slot, tc):
    """SampleMatColorParamSpectrum (integrator_spectrum.cpp:4-23) and, for
    a spectral texture, SampleMatColorSpectrumTexture (:127-183): the
    color slot's SPD at the hero wavelengths, or its texture stack (the
    red channel of each texture through the slot-0 matrix, lerped between
    the stack's wavelengths, 0 outside them), else the color as is."""
    spectral = wavelengths[..., 0] > 0.0
    has_spd, sampled, sid = _spd(scene, md, spec_slot, wavelengths)
    out = torch.where((spectral & has_spd)[..., None], sampled,
                      md['colors'][..., color_slot, :])
    if not meta.has_spd_tex:
        return out
    toff = scene.spec_tex_offset_sz[sid]
    tex_off, tex_sz = toff[..., 0], toff[..., 1]
    tc_t = mul_rows_2x4(md['row0'][..., 0, :], md['row1'][..., 0, :], tc)
    last = scene.spec_tex_wl.shape[0] - 1
    base = torch.clamp(tex_off, 0, last)
    wl = scene.spec_tex_wl
    lanes = torch.zeros_like(wavelengths)
    for j in range(max(meta.spd_tex_max_sz - 1, 0)):
        i0 = torch.clamp(base + j, 0, last)
        i1 = torch.clamp(base + j + 1, 0, last)
        w0, w1 = wl[i0], wl[i1]
        c1 = TEX.sample(scene.textures,
                        _clamp_tex(scene, scene.spec_tex_texid[i0]),
                        tc_t)[..., 0]
        c2 = TEX.sample(scene.textures,
                        _clamp_tex(scene, scene.spec_tex_texid[i1]),
                        tc_t)[..., 0]
        seg_ok = ((j + 1) < tex_sz)[..., None]
        w0, w1 = w0[..., None], w1[..., None]
        # the last segment includes its right end
        inseg = seg_ok & (((wavelengths >= w0) & (wavelengths < w1))
                          | (((j + 2) == tex_sz)[..., None]
                             & (wavelengths == w1)))
        t = (wavelengths - w0) / torch.clamp(w1 - w0, min=1e-6)
        lanes = torch.where(inseg, c1[..., None] * (1.0 - t)
                            + c2[..., None] * t, lanes)
    in_range = ((wavelengths >= wl[base][..., None])
                & (wavelengths <= wl[torch.clamp(base + tex_sz - 1, 0,
                                                 last)][..., None]))
    lanes = torch.where(in_range, lanes, 0.0)
    return torch.where((spectral & has_spd & (tex_sz > 0))[..., None], lanes,
                       out)


def sample_mat_param_spectrum(scene, md, wavelengths, param_slot, spec_slot):
    """The data slot ``param_slot`` per hero wavelength: the SPD of the
    material's slot ``spec_slot`` where it has one."""
    spectral = wavelengths[..., 0] > 0.0
    has_spd, sampled, _ = _spd(scene, md, spec_slot, wavelengths)
    return torch.where((spectral & has_spd)[..., None], sampled,
                       md['data'][..., param_slot][..., None].expand(
                           wavelengths.shape))


def _normal_map_transform(mflags, normal_from_tex):
    """NormalMapTransform (integrator_pt_mat.cpp:76-94): the texel to a
    tangent-space normal, inverted and swapped as the flags say."""
    nx = 2.0 * normal_from_tex[..., 0] - 1.0
    ny = 2.0 * normal_from_tex[..., 1] - 1.0
    nx = torch.where((mflags & FLAG_NMAP_INVERT_X) != 0, -nx, nx)
    ny = torch.where((mflags & FLAG_NMAP_INVERT_Y) != 0, -ny, ny)
    swap = (mflags & FLAG_NMAP_SWAP_XY) != 0
    return torch.stack([torch.where(swap, ny, nx), torch.where(swap, nx, ny),
                        normal_from_tex[..., 2]], -1)


def bump_mapping(scene, md, n, tang, tc):
    """BumpMapping (integrator_pt_mat.cpp:96-107): the slot-1 normal map's
    tangent-space normal in the frame (tangent, n x tangent, n)."""
    tc_t = mul_rows_2x4(md['row0'][..., 1, :], md['row1'][..., 1, :], tc)
    normal_tex = TEX.sample(scene.textures,
                            _clamp_tex(scene, md['texid'][..., 1]), tc_t)
    nts = _normal_map_transform(md['cflags'], normal_tex[..., :3])
    return normalize(tang * nts[..., 0:1] + cross(n, tang) * nts[..., 1:2]
                     + n * nts[..., 2:3])


def _four_scalar_params(scene, meta, md, tc):
    """The 4-texture scalar params (integrator_pt_mat.cpp:151-167): with
    FLAG_FOUR_TEXTURES the red channels of the slot-2 and slot-3 maps
    (glossiness, metalness, 1, 1), or the slot-2 texel whole when packed
    (FLAG_PACK_FOUR_PARAMS_IN_TEXTURE); else ones."""
    ones = torch.ones(md['cflags'].shape + (4,), dtype=torch.float32,
                      device=md['cflags'].device)
    if not meta.has_four_textures:
        return ones
    color2, color3 = (TEX.sample(
        scene.textures, _clamp_tex(scene, md['texid'][..., k]),
        mul_rows_2x4(md['row0'][..., k, :], md['row1'][..., k, :], tc))
        for k in (2, 3))
    one = torch.ones_like(color2[..., 0])
    split = torch.stack([color2[..., 0], color3[..., 0], one, one], -1)
    four = torch.where(((md['cflags'] & FLAG_PACK_FOUR_PARAMS_IN_TEXTURE)
                        != 0)[..., None], color2, split)
    return torch.where(((md['cflags'] & FLAG_FOUR_TEXTURES) != 0)[..., None],
                       four, ones)


def _has_nmap(md):
    return md['texid'][..., 1] != -1


def make_shading_ctx(scene, meta, mat_id, n, tang, tc):
    """Per-bounce shading data computed once and shared by NEE's
    MaterialEval, the bounce's MaterialSampleAndEval and the emissive-hit
    branch (a scene with a blend gathers one per descent step instead):
    the material rows, the shading normal (bent by a normal map), the
    slot-0 texel and the four scalar params."""
    md = gather_material(scene, mat_id)
    shade_normal = n
    if meta.has_bump:
        shade_normal = torch.where(_has_nmap(md)[..., None],
                                   bump_mapping(scene, md, n, tang, tc), n)
    return dict(md=md, shade_normal=shade_normal,
                tex_color=slot0_tex_color(scene, md, tc),
                four_params=_four_scalar_params(scene, meta, md, tc))


def _bump_eval_mult(md, l, n, shade_normal):
    """The eval's normal-map correction (integrator_pt_mat.cpp, MaterialEval):
    clamped cosines, 0 where the light is below the geometric normal; 1
    without a normal map."""
    cos1 = torch.clamp(dot(l, n), min=0.0)
    cos2 = torch.clamp(dot(l, shade_normal), min=0.0)
    bm = torch.where(cos1 <= 0.0, 0.0, cos2 / torch.clamp(cos1, min=1e-6))
    return torch.where(_has_nmap(md), bm, 1.0)


def _merge(sel, a, res):
    """Take sample dict ``a`` where ``sel``, else ``res``."""
    return {k: torch.where(sel[..., None] if a[k].dim() > sel.dim()
                           else sel, a[k], res[k]) for k in res}


def _const(value, shape, like, dtype=torch.float32):
    """A constant of ``shape`` as a broadcast view of one element: no
    [N]-sized fill, and no copy from the host (a blocking copy waits for
    the card to drain its queue)."""
    return torch.full((), value, dtype=dtype, device=like.device).expand(
        shape)


def _up(shape, like):
    """The direction (0, 1, 0) of a sample with no material, broadcast."""
    up = torch.zeros(3, device=like.device)
    up[1] = 1.0
    return up.expand(shape)


def material_sample_and_eval(scene, meta, mat_id, ctx, rng_state, live, v, n,
                             tc, mis_ior, ray_flags, wavelengths=None,
                             tang=None, rnd_mats_override=None,
                             rnd_mats_override_full=None):
    """MaterialSampleAndEval (integrator_pt_mat.cpp:109-306), batched, on
    the hit's material ``mat_id`` with geometric normal ``n``, tangent
    ``tang`` (what a normal map reads) and texture coordinates ``tc``;
    ``ctx`` is the shared shading context (None in a scene with a blend).

    Returns (sample dict(val [N, 4], dir, pdf, flags), new rng state, new
    mis_ior); the light-source material yields val 0, dir (0, 1, 0), pdf 1,
    flags 0, and only the dielectric, glass and thin film change the IOR.
    ``wavelengths`` [N, 4]: the hero wavelengths of a spectral scene.
    ``rnd_mats_override_full`` [N, 4] replaces the material's four randoms
    (Kelemen MLT), ``rnd_mats_override`` [N, 2] their first two
    (IntegratorQMC at bounce 0, integrator_qmc.cpp:118-127); the pseudo
    draw is made all the same (JAX ``bsdf/dispatch.py``:266-315)."""
    N = v.shape[0]
    curr = mat_id
    mult = None
    if meta.has_blend:
        # the descent: a draw on every live blend lane, each round
        mult = _const(1.0, (N,), v)
        for _ in range(meta.blend_sample_rounds):
            md_b = gather_material(scene, curr)
            is_blend = (md_b['mtype'] == MAT_TYPE_BLEND) & live
            rng_state, select = RNG.rnd_matb(rng_state, is_blend)
            weight = (md_b['data'][..., BLEND_WEIGHT]
                      * slot0_tex_color(scene, md_b, tc)[..., 0])
            pick2 = select < weight
            m = torch.where(pick2, weight, 1.0 - weight)
            curr = torch.where(is_blend, torch.where(
                pick2, md_b['datai'][..., 1], md_b['datai'][..., 0]), curr)
            mult = torch.where(is_blend, mult * m, mult)
    c = ctx if ctx is not None else make_shading_ctx(scene, meta, curr, n,
                                                     tang, tc)
    # ``n``: the geometric normal (the glass's and the bump correction's),
    # ``sn``: the shading normal
    md, sn, tex = c['md'], c['shade_normal'], c['tex_color']
    rng_state, rands = RNG.rnd_mats(rng_state, live)
    if rnd_mats_override_full is not None:
        rands = rnd_mats_override_full
    elif rnd_mats_override is not None:
        rands = torch.cat([rnd_mats_override, rands[..., 2:4]], -1)
    res = dict(val=_const(0.0, (N, 4), v), dir=_up((N, 3), v),
               pdf=_const(1.0, (N,), v),
               flags=_const(0, (N,), v, torch.int64))
    new_ior = mis_ior
    mtype = md['mtype']
    types = set(meta.mat_types_present)
    if MAT_TYPE_GLTF in types:
        md_, v_, sn_, tex_, fp_ = C.kept(mtype == MAT_TYPE_GLTF, md, v, sn,
                                        tex, c['four_params'])
        base = md_['colors'][..., GLTF_COLOR_BASE, :] * tex_
        s = GLTF.sample_and_eval(md_, rands, v_, sn_, base, fp_)
        res = _merge(mtype == MAT_TYPE_GLTF, s, res)
    w = wavelengths if meta.spectral_mode else None
    if MAT_TYPE_DIFFUSE in types:
        md_, v_, sn_, tex_ = C.kept(mtype == MAT_TYPE_DIFFUSE, md, v, sn,
                                    tex)
        refl = _refl(scene, meta, md_, tex_, tc, w, DIFFUSE_COLOR)
        s = DIFF.sample_and_eval(md_, refl, rands, v_, sn_)
        res = _merge(mtype == MAT_TYPE_DIFFUSE, s, res)
    if MAT_TYPE_CONDUCTOR in types:
        md_, v_, sn_, tex_ = C.kept(mtype == MAT_TYPE_CONDUCTOR, md, v, sn,
                                   tex)
        s = COND.sample_and_eval(md_, rands, v_, sn_, tex_[..., :3],
                                 *_cond_eta_k(scene, md_, w))
        res = _merge(mtype == MAT_TYPE_CONDUCTOR, s, res)
    if MAT_TYPE_DIELECTRIC in types:
        md_, v_, sn_, ior_ = C.kept(mtype == MAT_TYPE_DIELECTRIC, md, v, sn,
                                   mis_ior)
        int_ior = None if w is None else sample_mat_param_spectrum(
            scene, md_, w, DIELECTRIC_ETA_INT, 0)[..., 0]
        s = DIEL.sample_and_eval(md_, ior_, rands, v_, sn_, ray_flags,
                                 int_ior)
        if w is not None:
            # a per-wavelength IOR splits the waves
            # (hydracore3_tpu/bsdf/dispatch.py:343-345)
            s['flags'] = s['flags'] | torch.where(
                scene.mat_spdid[md['id'], 0] != -1,
                C.RAY_FLAG_WAVES_DIVERGED, 0)
        is_diel = mtype == MAT_TYPE_DIELECTRIC
        res = _merge(is_diel, s, res)
        new_ior = torch.where(is_diel, s['ior'], new_ior)
    if MAT_TYPE_GLASS in types:
        is_glass = mtype == MAT_TYPE_GLASS
        md_, v_, n_, ior_ = C.kept(is_glass, md, v, n, mis_ior)
        s = GLASS.sample_and_eval(md_, rands, v_, n_, ior_, ray_flags)
        res = _merge(is_glass, s, res)
        new_ior = torch.where(is_glass, s['ior'], new_ior)
    if MAT_TYPE_PLASTIC in types:
        md_, v_, sn_, tex_ = C.kept(mtype == MAT_TYPE_PLASTIC, md, v, sn, tex)
        refl = _refl(scene, meta, md_, tex_, tc, w, PLASTIC_COLOR)
        s = PLAST.sample_and_eval(scene, md_, refl, rands, v_, sn_)
        res = _merge(mtype == MAT_TYPE_PLASTIC, s, res)
    if MAT_TYPE_THIN_FILM in types:
        md_, v_, sn_, tc_, ior_, tex_ = C.kept(mtype == MAT_TYPE_THIN_FILM,
                                              md, v, sn, tc, mis_ior, tex)
        s = FILM.sample_and_eval(scene, md_, rands, v_, sn_, tc_, ior_,
                                 ray_flags, tex_[..., :3], _hero(w))
        # films always diverge the hero wavelengths
        # (integrator_pt_mat.cpp:248)
        s['flags'] = s['flags'] | C.RAY_FLAG_WAVES_DIVERGED
        is_film = mtype == MAT_TYPE_THIN_FILM
        res = _merge(is_film, s, res)
        new_ior = torch.where(is_film, s['ior'], new_ior)
    if meta.has_bump:
        # the sample's normal-map correction (integrator_pt_mat.cpp:298-303)
        bm = (dot(res['dir'], sn).abs()
              / torch.clamp(dot(res['dir'], n).abs(), min=1e-10))
        res['val'] = torch.where(_has_nmap(md)[..., None],
                                 res['val'] * bm[..., None], res['val'])
    if mult is not None:
        res['val'] = res['val'] * mult[..., None]
        res['pdf'] = res['pdf'] * mult
    return res, rng_state, new_ior


# the spectral helpers take ``w``: the hero wavelengths [N, 4] in spectral
# mode, None in RGB mode

def _refl(scene, meta, md, tex, tc, w, slot):
    """A diffuse's or plastic's reflectance: the color times the slot-0
    texture, or in spectral mode the slot's spectrum with no texture."""
    if w is None:
        return md['colors'][..., slot, :] * tex
    return sample_mat_color_spectrum(scene, meta, md, w, slot, 0, tc)


def _cond_eta_k(scene, md, w):
    """A conductor's (eta, k) per hero wavelength, or (None, None): the
    material's scalars."""
    if w is None:
        return None, None
    return (sample_mat_param_spectrum(scene, md, w, CONDUCTOR_ETA, 0),
            sample_mat_param_spectrum(scene, md, w, CONDUCTOR_K, 1))


def _hero(w):
    """The hero wavelength a thin film takes in spectral mode, else None."""
    return None if w is None else w[..., 0]


def _eval_leaf(scene, meta, types, c, l, v, tc, w=None):
    """Every present type's eval on the whole batch, merged by type."""
    val = _const(0.0, l.shape[:-1] + (4,), l)
    pdf = _const(0.0, l.shape[:-1], l)
    mtype = c['md']['mtype']
    runs = (
        (MAT_TYPE_GLTF, lambda md, l, v, n, tex, tc, fp: GLTF.eval(
            md, l, v, n, md['colors'][..., GLTF_COLOR_BASE, :] * tex, fp)),
        (MAT_TYPE_DIFFUSE, lambda md, l, v, n, tex, tc, fp: DIFF.eval(
            md, _refl(scene, meta, md, tex, tc, w, DIFFUSE_COLOR), l, v, n)),
        (MAT_TYPE_CONDUCTOR, lambda md, l, v, n, tex, tc, fp: COND.eval(
            md, l, v, n, tex[..., :3], *_cond_eta_k(scene, md, w))),
        (MAT_TYPE_PLASTIC, lambda md, l, v, n, tex, tc, fp: PLAST.eval(
            scene, md, _refl(scene, meta, md, tex, tc, w, PLASTIC_COLOR),
            l, v, n)),
        (MAT_TYPE_THIN_FILM, lambda md, l, v, n, tex, tc, fp: FILM.eval(
            scene, md, l, v, n, tc, tex[..., :3], _hero(w))))
    for t, run in runs:
        if t in types:
            sel = mtype == t
            e = run(*C.kept(sel, c['md'], l, v, c['shade_normal'],
                           c['tex_color'], tc, c['four_params']))
            val = torch.where(sel[..., None], e['val'], val)
            pdf = torch.where(sel, e['pdf'], pdf)
    return val, pdf


def material_eval(scene, meta, mat_id, ctx, l, v, n, tc, wavelengths=None,
                  tang=None):
    """MaterialEval (integrator_pt_mat.cpp:308-528): dict(val [N, 4],
    pdf [N]); zero for the light-source material and for the delta
    materials (smooth conductor, dielectric, glass, smooth or non-metal
    thin film).  A blend's leaves are summed with their weights through
    the JAX eval's stack of (material, weight).  ``n``: the geometric
    normal; ``tang``: the tangent a normal map reads."""
    types = set(meta.mat_types_present)
    w = wavelengths if meta.spectral_mode else None
    if not meta.has_blend:
        if ctx is None:
            ctx = make_shading_ctx(scene, meta, mat_id, n, tang, tc)
        val, pdf = _eval_leaf(scene, meta, types, ctx, l, v, tc, w)
        if meta.has_bump:
            val = val * _bump_eval_mult(ctx['md'], l, n,
                                        ctx['shade_normal'])[..., None]
        return dict(val=val, pdf=pdf)
    N, depth = mat_id.shape[0], meta.max_blend_stack
    dev = mat_id.device
    rows = torch.arange(N, device=dev)
    out_val = torch.zeros((N, 4), dtype=torch.float32, device=dev)
    out_pdf = torch.zeros(N, dtype=torch.float32, device=dev)
    stack_ids = torch.zeros((N, depth), dtype=torch.int64, device=dev)
    stack_w = torch.zeros((N, depth), dtype=torch.float32, device=dev)
    top = torch.zeros(N, dtype=torch.int64, device=dev)
    curr_id, curr_w = mat_id, torch.ones(N, dtype=torch.float32, device=dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    for step_types in meta.blend_eval_types:
        c = make_shading_ctx(scene, meta, curr_id, n, tang, tc)
        md = c['md']
        val, pdf = _eval_leaf(scene, meta, types & set(step_types), c, l, v,
                              tc, w)
        is_b = md['mtype'] == MAT_TYPE_BLEND
        leaf = active & ~is_b
        wv = curr_w if not meta.has_bump else curr_w * _bump_eval_mult(
            md, l, n, c['shade_normal'])
        out_val = out_val + torch.where(leaf[..., None],
                                        val * wv[..., None], 0.0)
        out_pdf = out_pdf + torch.where(leaf, pdf * curr_w, 0.0)
        # a blend pushes its bottom child and descends into its top child
        is_blend = active & is_b
        weight = md['data'][..., BLEND_WEIGHT] * c['tex_color'][..., 0]
        push = is_blend & (top < depth)
        idx = torch.clamp(top, 0, depth - 1)
        stack_ids = torch.where(push[..., None], stack_ids.index_put(
            (rows, idx), md['datai'][..., 1]), stack_ids)
        stack_w = torch.where(push[..., None], stack_w.index_put(
            (rows, idx), curr_w * weight), stack_w)
        top = torch.where(push, top + 1, top)
        curr_id = torch.where(is_blend, md['datai'][..., 0], curr_id)
        curr_w = torch.where(is_blend, curr_w * (1.0 - weight), curr_w)
        # a leaf pops
        pop = leaf & (top > 0)
        top = torch.where(pop, top - 1, top)
        idx2 = torch.clamp(top, 0, depth - 1)
        curr_id = torch.where(pop, stack_ids[rows, idx2], curr_id)
        curr_w = torch.where(pop, stack_w[rows, idx2], curr_w)
        active = is_blend | pop
    return dict(val=out_val, pdf=out_pdf)
