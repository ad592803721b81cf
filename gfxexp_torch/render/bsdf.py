"""Branchless batched BSDFs over the closed material set (port of
gfxexp_tpu/render/bsdf.py): Lambert, and diffuse + GGX specular with VNDF
sampling and one-sample MIS between the lobes. Directions are in the local
shading frame (z = shading normal)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gfxexp_torch.core.math import (
    cosine_sample_hemisphere,
    dot,
    length,
    luminance,
    safe_divide,
)
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.scene.textures import sample_bilinear, sample_trilinear
from gfxexp_torch.scene.types import BSDF_LAMBERT

_PI = float(np.pi)


@dataclass
class BSDFParams(TensorData):
    diffuse: torch.Tensor  # [R, 3]
    f0: torch.Tensor  # [R, 3] specular colour at normal incidence
    roughness: torch.Tensor  # [R]
    is_lambert: torch.Tensor  # [R] bool


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _unit(v):
    return v / torch.clamp(length(v, keepdim=True), min=1e-20)


def _unit_exact(v):
    """v / |v| without a floor (the reference divides by the plain norm)."""
    return v / length(v, keepdim=True)


def _half_vec(a, b):
    """The unit half vector of a and b."""
    return _unit(a + b)


def ggx_d(m, alpha):
    temp = m[..., 0] ** 2 + m[..., 1] ** 2 + (m[..., 2] * alpha) ** 2
    d = safe_divide(alpha * alpha, _PI * temp * temp)
    return torch.where(m[..., 2] > 0.0, d, 0.0)


def ggx_smith_g1(v, m, alpha):
    chi = dot(v, m) * v[..., 2] > 0.0
    vz2 = v[..., 2] ** 2
    temp = safe_divide(alpha * alpha * (v[..., 0] ** 2 + v[..., 1] ** 2), vz2)
    return torch.where(chi, 2.0 / (1.0 + torch.sqrt(1.0 + temp)), 0.0)


def ggx_height_correlated_g(v1, v2, m, alpha):
    def lam(v):
        vz2 = v[..., 2] ** 2
        a2t2 = safe_divide(alpha * alpha * (v[..., 0] ** 2 + v[..., 1] ** 2),
                           vz2)
        return 0.5 * (-1.0 + torch.sqrt(1.0 + a2t2))

    chi1 = safe_divide(dot(v1, m), v1[..., 2]) > 0.0
    chi2 = safe_divide(dot(v2, m), v2[..., 2]) > 0.0
    return torch.where(chi1 & chi2, 1.0 / (1.0 + lam(v1) + lam(v2)), 0.0)


def ggx_sample_vndf(v, u0, u1, alpha):
    """Heitz 2014 visible-normal sampling; v in the upper hemisphere.
    Returns (m, pdf_m)."""
    sv = _unit_exact(torch.stack([alpha * v[..., 0], alpha * v[..., 1],
                                  v[..., 2]], dim=-1))
    dist2d = torch.sqrt(sv[..., 0] ** 2 + sv[..., 1] ** 2)
    rec = safe_divide(1.0, dist2d)
    straight = sv[..., 2] >= 0.9999
    zero = torch.zeros_like(rec)
    t1 = torch.where(
        straight[..., None],
        torch.stack([torch.ones_like(rec), zero, zero], dim=-1),
        torch.stack([sv[..., 1] * rec, -sv[..., 0] * rec, zero], dim=-1))
    t2 = torch.stack([t1[..., 1] * sv[..., 2], -t1[..., 0] * sv[..., 2],
                      dist2d], dim=-1)
    aa = 1.0 / (1.0 + sv[..., 2])
    r = torch.sqrt(torch.clamp(u0, min=0.0))
    lower = u1 < aa
    phi = _PI * torch.where(lower, safe_divide(u1, aa),
                            1.0 + safe_divide(u1 - aa, 1.0 - aa))
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi) * torch.where(lower, 1.0, sv[..., 2])
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    m = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * sv
    m = _unit(torch.stack([alpha * m[..., 0], alpha * m[..., 1], m[..., 2]],
                          dim=-1))
    d = ggx_d(m, alpha)
    pdf = ggx_smith_g1(v, m, alpha) * torch.abs(dot(v, m)) * d
    pdf = safe_divide(pdf, torch.abs(v[..., 2]))
    return m, pdf


def ggx_pdf(v, m, alpha):
    d = ggx_d(m, alpha)
    return safe_divide(ggx_smith_g1(v, m, alpha) * torch.abs(dot(v, m)) * d,
                       torch.abs(v[..., 2]))


def _lobe_weights(p: BSDFParams, v_given):
    r = p.roughness
    vz = v_given[..., 2]
    one_minus_vz5 = _pow5(1.0 - torch.abs(vz))
    expected_fd90 = 0.5 * r + 2.0 * r * vz * vz
    expected_diffuse_fresnel = 1.0 + (expected_fd90 - 1.0) * one_minus_vz5
    diffuse_w = (luminance(p.diffuse) * expected_diffuse_fresnel ** 2
                 * (1.0 + (1.0 / 1.51 - 1.0) * r))
    specular_w = luminance(p.f0) + (1.0 - luminance(p.f0)) * one_minus_vz5
    return diffuse_w, specular_w


def _ds_eval_common(p: BSDFParams, dir_v, dir_l, m):
    """Diffuse + specular f for upper-hemisphere V, L and half vector m."""
    alpha = p.roughness * p.roughness
    dot_lh = torch.clamp(dot(dir_l, m), max=1.0)
    one_minus_lh5 = _pow5(1.0 - dot_lh)
    d = ggx_d(m, alpha)
    g = ggx_height_correlated_g(dir_l, dir_v, m, alpha)
    f = p.f0 + (1.0 - p.f0) * one_minus_lh5[..., None]
    denom = 4.0 * dir_l[..., 2] * dir_v[..., 2]
    spec = f * safe_divide(d * g, denom)[..., None]
    spec = torch.where((g > 0.0)[..., None], spec, 0.0)

    r = p.roughness
    fd90 = 0.5 * r + 2.0 * r * dot_lh * dot_lh
    one_minus_vn5 = _pow5(1.0 - dir_v[..., 2])
    one_minus_ln5 = _pow5(1.0 - dir_l[..., 2])
    f_out = 1.0 + (fd90 - 1.0) * one_minus_vn5
    f_in = 1.0 + (fd90 - 1.0) * one_minus_ln5
    diff = p.diffuse * (f_out * f_in * (1.0 + (1.0 / 1.51 - 1.0) * r)
                        / _PI)[..., None]
    return diff + spec


def bsdf_evaluate(p: BSDFParams, v_given, v_sampled):
    """f(V, L) [R, 3], two-sided."""
    same_side = v_given[..., 2] * v_sampled[..., 2] > 0.0
    sign = torch.where(v_given[..., 2] >= 0.0, 1.0, -1.0)[..., None]
    dir_v = v_given * sign
    dir_l = v_sampled * sign
    m = _unit(dir_l + dir_v)
    ds = _ds_eval_common(p, dir_v, dir_l, m)
    f = torch.where(p.is_lambert[..., None], p.diffuse / _PI, ds)
    return torch.where(same_side[..., None], f, 0.0)


def bsdf_pdf(p: BSDFParams, v_given, v_sampled):
    """Solid-angle pdf of sampling L given V (one-sample-MIS mixture)."""
    same_side = v_given[..., 2] * v_sampled[..., 2] > 0.0
    sign = torch.where(v_given[..., 2] >= 0.0, 1.0, -1.0)[..., None]
    dir_v = v_given * sign
    dir_l = v_sampled * sign
    m = _unit(dir_l + dir_v)
    alpha = p.roughness * p.roughness
    common = safe_divide(torch.ones_like(alpha), 4.0 * dot(dir_l, m))
    diffuse_pdf = dir_l[..., 2] / _PI
    specular_pdf = common * ggx_pdf(dir_v, m, alpha)
    dw, sw = _lobe_weights(p, dir_v)
    ds = safe_divide(diffuse_pdf * dw + specular_pdf * sw, dw + sw)
    pdf = torch.where(p.is_lambert, diffuse_pdf, ds)
    return torch.where(same_side, torch.clamp(pdf, min=0.0), 0.0)


def bsdf_sample(p: BSDFParams, v_given, u0, u1):
    """Sample L given V: (v_sampled [R, 3], f [R, 3], pdf [R]). Both lobes
    are sampled for every lane and the pick is a select."""
    sign = torch.where(v_given[..., 2] >= 0.0, 1.0, -1.0)[..., None]
    dir_v = v_given * sign
    alpha = p.roughness * p.roughness

    dw, sw = _lobe_weights(p, dir_v)
    sum_w = dw + sw
    pick_spec = (u1 * sum_w >= dw) & ~p.is_lambert
    u1_diff = safe_divide(u1 * sum_w, dw)
    u1_spec = safe_divide(u1 * sum_w - dw, sw)
    u1_diff = torch.where(p.is_lambert, u1,
                          torch.clamp(u1_diff, 0.0, 1.0 - 1e-7))
    u1_spec = torch.clamp(u1_spec, 0.0, 1.0 - 1e-7)

    l_diff = cosine_sample_hemisphere(u0, u1_diff)
    m_spec, m_pdf = ggx_sample_vndf(dir_v, u0, u1_spec, alpha)
    dot_vh = torch.clamp(dot(dir_v, m_spec), max=1.0)
    l_spec = 2.0 * dot_vh[..., None] * m_spec - dir_v

    ps3 = pick_spec[..., None]
    dir_l = torch.where(ps3, l_spec, l_diff)
    spec_ok = torch.where(pick_spec, dir_l[..., 2] * dir_v[..., 2] > 0.0,
                          True)

    m = torch.where(ps3, m_spec, _half_vec(l_diff, dir_v))
    dot_lh = torch.clamp(dot(dir_l, m), max=1.0)
    common = safe_divide(torch.ones_like(dot_lh), 4.0 * dot_lh)
    diffuse_pdf = dir_l[..., 2] / _PI
    specular_pdf = common * torch.where(pick_spec, m_pdf,
                                        ggx_pdf(dir_v, m, alpha))
    ds_pdf = safe_divide(diffuse_pdf * dw + specular_pdf * sw, sum_w)
    pdf = torch.where(p.is_lambert, diffuse_pdf, ds_pdf)
    pdf = torch.where(spec_ok & (sum_w > 0.0), pdf, 0.0)

    f_ds = _ds_eval_common(p, dir_v, dir_l, m)
    f = torch.where(p.is_lambert[..., None], p.diffuse / _PI, f_ds)
    f = torch.where((pdf > 0.0)[..., None], f, 0.0)
    return dir_l * sign, f, pdf


def bsdf_dh_reflectance(p: BSDFParams, v_given):
    """Directional-hemispherical reflectance estimate [R, 3] (the
    denoiser's albedo)."""
    vz = torch.abs(v_given[..., 2])
    r = p.roughness
    fd90 = 0.5 * r + 2.0 * r * vz * vz
    one_minus_vz5 = _pow5(1.0 - vz)
    f_given = 1.0 + (fd90 - 1.0) * one_minus_vz5
    diffuse_dhr = p.diffuse * (f_given
                               * (1.0 + (1.0 / 1.51 - 1.0) * r))[..., None]
    omvh5 = one_minus_vz5 * (1.0 - r)
    specular_dhr = p.f0 + (1.0 - p.f0) * omvh5[..., None]
    ds = torch.clamp(diffuse_dhr + specular_dhr, max=1.0)
    return torch.where(p.is_lambert[..., None], p.diffuse, ds)


def material_params(materials, mat_idx) -> BSDFParams:
    """Per-lane BSDFParams gathered from the material table."""
    mat_idx = mat_idx.to(torch.int64)
    return BSDFParams(
        diffuse=materials.diffuse_color[mat_idx],
        f0=materials.specular_f0[mat_idx],
        roughness=torch.clamp(materials.roughness[mat_idx], max=0.999),
        is_lambert=materials.bsdf_type[mat_idx] == BSDF_LAMBERT,
    )


def material_params_textured(materials, atlas, mat_idx, uv,
                             lod=None) -> BSDFParams:
    """material_params with the diffuse colour read from the atlas where
    the material has a diffuse texture: trilinear at the per-lane `lod`
    [R] when given and the atlas has mips, else bilinear. An atlas of None
    (or of no layer) keeps the constants."""
    base = material_params(materials, mat_idx)
    if atlas is None or atlas.count == 0:
        return base
    tid = materials.diffuse_tex[mat_idx.to(torch.int64)]
    if lod is not None and atlas.mip_flat is not None:
        texel = sample_trilinear(atlas, tid, uv, lod)
    else:
        texel = sample_bilinear(atlas, tid, uv)
    base.diffuse = torch.where((tid >= 0)[:, None], texel[:, :3],
                               base.diffuse)
    return base
