"""Light sampling and pdfs (port of gfxexp_tpu/scene/lights.py: the surface
and environment lights of single-level and two-level scenes; in a two-level
scene a light triangle is an object-space BLAS triangle brought into world
space through its unit's instance).

Emitters are diffuse (Le = emittance / pi). Surface samples return an area
pdf, environment samples a solid-angle pdf. Environment direction for
(u, v): phi = 2 pi u - rotation, theta = pi v, y up.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gfxexp_torch.core.distributions import (
    continuous_2d_pdf,
    sample_continuous_2d,
    sample_probability_texture,
)
from gfxexp_torch.core.math import cross, dot, length, rotate
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.scene.types import SceneData

_PI = float(np.pi)
PROB_SAMPLE_ENV = 0.25


@dataclass
class LightSample(TensorData):
    position: torch.Tensor  # [R, 3] (env: the unit direction)
    normal: torch.Tensor  # [R, 3]
    emittance: torch.Tensor  # [R, 3]
    pdf: torch.Tensor  # [R] area pdf (surface) or solid-angle pdf (env)
    at_infinity: torch.Tensor  # [R] bool


def _square_to_triangle(u0, u1):
    """Low-distortion square -> triangle map."""
    b_a = 0.5 * u0
    b_b = 0.5 * u1
    offset = b_b - b_a
    b_b2 = torch.where(offset > 0, b_b + offset, b_b)
    b_a2 = torch.where(offset > 0, b_a, b_a - offset)
    return b_a2, b_b2


def _segment_searchsorted(cdf_flat, offset, count, u, max_log2=20):
    """Largest i in [0, count) with cdf_flat[offset + i] <= u (each segment's
    cdf is an exclusive prefix starting at 0)."""
    top = torch.clamp(count - 1, min=0)
    lo = torch.zeros_like(offset)
    hi = top
    for _ in range(max_log2):
        mid = (lo + hi + 1) // 2
        mid_val = cdf_flat[offset + torch.minimum(mid, top)]
        go_right = (mid_val <= u) & (mid <= hi)
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid - 1)
    return lo


def _alias_pick(prob, alias, idx_base, n, u):
    """Walker alias draw over the window of `n` buckets at idx_base in the
    flat (prob, alias) arrays (alias entries are local). Returns (local
    index, remapped uniform)."""
    scaled = u * n.to(torch.float32)
    bucket = torch.minimum(torch.clamp(scaled.to(torch.int64), min=0),
                           torch.clamp(n - 1, min=0))
    frac = scaled - bucket.to(torch.float32)
    p = prob[idx_base + bucket]
    keep = frac < p
    local = torch.where(keep, bucket, alias[idx_base + bucket].to(torch.int64))
    u_re = torch.where(keep, frac / torch.clamp(p, min=1e-12),
                       (frac - p) / torch.clamp(1.0 - p, min=1e-12))
    return local, torch.clamp(u_re, 0.0, 1.0 - 1e-7)


def _select_light_pos(scene: SceneData, u_sel, u_aux=None):
    """Two-level emissive selection (unit, then triangle in the unit). The
    unit comes from the probability texture when the scene has one (its
    2D descent also consumes `u_aux` and hands it back remapped), else the
    alias tables, else a CDF search. Returns (unit, light-order position,
    u_aux)."""
    units = scene.units
    n_units = scene.num_units
    pt = scene.light_unit_probtex
    if pt is not None and u_aux is not None:
        ix, iy, _, u_re, u_aux = sample_probability_texture(pt, u_sel, u_aux)
        unit = torch.clamp(iy * pt.size + ix, 0, n_units - 1)
    elif scene.light_unit_alias_prob is not None:
        unit, u_re = _alias_pick(
            scene.light_unit_alias_prob, scene.light_unit_alias_idx,
            torch.zeros((), dtype=torch.int64, device=u_sel.device),
            torch.full(u_sel.shape, n_units, dtype=torch.int64,
                       device=u_sel.device), u_sel)
    else:
        unit = torch.clamp(torch.searchsorted(scene.light_unit_cdf, u_sel,
                                              right=True) - 1,
                           0, n_units - 1)
        lo = scene.light_unit_cdf[unit]
        width = scene.light_unit_cdf[unit + 1] - lo
        u_re = torch.clamp(
            torch.where(width > 0,
                        (u_sel - lo) / torch.where(width > 0, width, 1.0),
                        0.0), 0.0, 1.0 - 1e-7)
    offset = units.tri_offset[unit].to(torch.int64)
    count = units.tri_count[unit].to(torch.int64)
    if units.light_tri_alias_prob is not None:
        local, _ = _alias_pick(units.light_tri_alias_prob,
                               units.light_tri_alias_local, offset, count,
                               u_re)
    else:
        local = _segment_searchsorted(units.light_tri_cdf, offset, count,
                                      u_re)
    return unit, offset + local, u_aux


def _select_emissive_triangle(scene: SceneData, u_sel, u_aux=None):
    """_select_light_pos resolved to a traversal triangle id and pmfs.
    Returns (unit, tri, unit_pmf, tri_pmf, u_aux)."""
    units = scene.units
    unit, light_pos, u_aux = _select_light_pos(scene, u_sel, u_aux)
    unit_pmf = scene.light_unit_pmf[unit]
    tri = units.light_tri_index[light_pos].to(torch.int64)
    # instanced scenes keep the pmf in light order (a BLAS triangle id is
    # shared by many units)
    tri_pmf = units.light_tri_pmf[light_pos if scene.is_instanced else tri]
    return unit, tri, unit_pmf, tri_pmf, u_aux


def _to_world(scene: SceneData, inst, p0, e1, e2, normals):
    """Object-space triangle(s) of instance `inst` [R] -> world space;
    normals go through the inverse transpose."""
    m = scene.instances.transform[inst]
    ninv = scene.instances.inv_transform[inst][:, :, :3]
    p0 = rotate(m, p0) + m[:, :, 3]
    e1 = rotate(m, e1)
    e2 = rotate(m, e2)
    normals = [(ninv * n[:, :, None]).sum(1) for n in normals]
    return p0, e1, e2, normals


def pack_light_rows(scene: SceneData) -> torch.Tensor:
    """[T, 22] world-space emissive-triangle rows in light order: p0 e1 e2
    n0 n1 n2 (0:18), pdf = unit_pmf * tri_pmf / area (18), emittance
    (19:22). A surface-light sample is then one row gather."""
    units = scene.units
    tris = scene.triangles
    t = units.light_tri_index.shape[0]
    dev = units.light_tri_index.device
    j = torch.arange(t, dtype=torch.int64, device=dev)
    unit = torch.clamp(torch.searchsorted(units.tri_offset.to(torch.int64), j,
                                          right=True) - 1,
                       0, scene.num_units - 1)
    tri = units.light_tri_index.to(torch.int64)
    p0, e1, e2 = tris.p0[tri], tris.e1[tri], tris.e2[tri]
    n0, n1, n2 = tris.n0[tri], tris.n1[tri], tris.n2[tri]
    tri_pmf = units.light_tri_pmf[j if scene.is_instanced else tri]
    if scene.is_instanced:
        inst = units.instance[unit].to(torch.int64)
        p0, e1, e2, (n0, n1, n2) = _to_world(scene, inst, p0, e1, e2,
                                             (n0, n1, n2))
    unit_pmf = scene.light_unit_pmf[unit]
    cr_len = length(cross(e1, e2))
    rec_area = 2.0 / torch.clamp(cr_len, min=1e-20)
    pdf = torch.where(cr_len > 0, unit_pmf * tri_pmf * rec_area, 0.0)
    emit = scene.materials.emittance[units.material[unit].to(torch.int64)]
    return torch.cat([p0, e1, e2, n0, n1, n2, pdf[:, None], emit], dim=1)


def env_dir_from_uv(env, u, v):
    phi = 2.0 * _PI * u - env.rotation
    theta = _PI * v
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                        sin_t * torch.sin(phi)], dim=-1)


def env_uv_from_dir(env, d):
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    u = (phi + env.rotation) / (2.0 * _PI)
    u = u - torch.floor(u)
    v = theta / _PI
    return u, v


def env_radiance(env, d):
    """Bilinear environment lookup (u wraps, v clamps)."""
    u, v = env_uv_from_dir(env, d)
    h, w = env.radiance.shape[:2]
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = x0 % w
    x1w = (x0 + 1) % w
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    r00 = env.radiance[y0c, x0w]
    r10 = env.radiance[y0c, x1w]
    r01 = env.radiance[y1c, x0w]
    r11 = env.radiance[y1c, x1w]
    r = ((1 - ty) * ((1 - tx) * r00 + tx * r10)
         + ty * ((1 - tx) * r01 + tx * r11))
    return r * env.power_coeff


def env_pdf(env, d):
    """Solid-angle pdf of importance-sampling direction d."""
    u, v = env_uv_from_dir(env, d)
    uv_pdf = continuous_2d_pdf(env.importance, u, v)
    sin_t = torch.clamp(torch.sin(_PI * v), min=1e-6)
    return uv_pdf / (2.0 * _PI * _PI * sin_t)


def sample_surface_light(scene: SceneData, u_sel, u0, u1,
                         packed=None) -> LightSample:
    """Emissive-surface sample: unit, triangle, then the square -> triangle
    map. `packed` is the hoisted pack_light_rows table (the path the tracer
    takes): everything after selection is then one row gather."""
    if packed is None:
        return _sample_surface_light_gather(scene, u_sel, u0, u1)
    _, light_pos, u0 = _select_light_pos(scene, u_sel, u0)
    row = packed[light_pos]  # [R, 22]
    b_a, b_b = _square_to_triangle(u0, u1)
    b_c = 1.0 - b_a - b_b
    position = (row[:, 0:3] + b_b[..., None] * row[:, 3:6]
                + b_c[..., None] * row[:, 6:9])
    normal = (b_a[..., None] * row[:, 9:12] + b_b[..., None] * row[:, 12:15]
              + b_c[..., None] * row[:, 15:18])
    normal = normal / torch.clamp(length(normal, keepdim=True), min=1e-20)
    pdf = row[:, 18]
    return LightSample(position=position, normal=normal,
                       emittance=row[:, 19:22], pdf=pdf,
                       at_infinity=torch.zeros(pdf.shape, dtype=torch.bool,
                                               device=pdf.device))


def _sample_surface_light_gather(scene: SceneData, u_sel, u0,
                                 u1) -> LightSample:
    """sample_surface_light without the packed rows: scattered gathers of
    the selected triangle, through its instance in two-level scenes."""
    tris = scene.triangles
    unit, tri, unit_pmf, tri_pmf, u0 = _select_emissive_triangle(
        scene, u_sel, u0)
    b_a, b_b = _square_to_triangle(u0, u1)
    p0, e1, e2 = tris.p0[tri], tris.e1[tri], tris.e2[tri]
    n0, n1, n2 = tris.n0[tri], tris.n1[tri], tris.n2[tri]
    if scene.is_instanced:
        # object -> world through the unit's instance; the pdf uses the
        # world area
        inst = scene.units.instance[unit].to(torch.int64)
        p0, e1, e2, (n0, n1, n2) = _to_world(scene, inst, p0, e1, e2,
                                             (n0, n1, n2))
    b_c = 1.0 - b_a - b_b
    position = p0 + b_b[..., None] * e1 + b_c[..., None] * e2
    cr_len = length(cross(e1, e2))
    pdf = unit_pmf * tri_pmf * (2.0 / torch.clamp(cr_len, min=1e-20))
    normal = (b_a[..., None] * n0 + b_b[..., None] * n1
              + b_c[..., None] * n2)
    normal = normal / torch.clamp(length(normal, keepdim=True), min=1e-20)
    mat = scene.units.material[unit].to(torch.int64)
    return LightSample(position=position, normal=normal,
                       emittance=scene.materials.emittance[mat],
                       pdf=torch.where(cr_len > 0, pdf, 0.0),
                       at_infinity=torch.zeros(pdf.shape, dtype=torch.bool,
                                               device=pdf.device))


def sample_surface_light_solid_angle(scene: SceneData, shading_point,
                                     u_sel, u0, u1) -> LightSample:
    """Uniform sampling of the solid angle the chosen triangle subtends
    from `shading_point` (Arvo's spherical triangle; the barycentrics come
    back from intersecting the sampled direction with the triangle's
    plane). The pdf is turned into the area measure, so it composes with
    the rest of the light code."""
    tris = scene.triangles
    unit, tri, unit_pmf, tri_pmf, u0 = _select_emissive_triangle(
        scene, u_sel, u0)
    light_prob = unit_pmf * tri_pmf
    p_a = tris.p0[tri]
    p_b = p_a + tris.e1[tri]
    p_c = p_a + tris.e2[tri]
    n0, n1, n2 = tris.n0[tri], tris.n1[tri], tris.n2[tri]
    if scene.is_instanced:
        inst = scene.units.instance[unit].to(torch.int64)
        m = scene.instances.transform[inst]
        p_a, p_b, p_c = (rotate(m, p) + m[:, :, 3] for p in (p_a, p_b, p_c))
        ninv = scene.instances.inv_transform[inst][:, :, :3]
        n0, n1, n2 = ((ninv * n[:, :, None]).sum(1) for n in (n0, n1, n2))
    geom_n = cross(p_b - p_a, p_c - p_a)

    def norm(v):
        return v / torch.clamp(length(v, keepdim=True), min=1e-20)

    a = norm(p_a - shading_point)
    b = norm(p_b - shading_point)
    c = norm(p_c - shading_point)
    c_ab = norm(cross(a, b))
    c_bc = norm(cross(b, c))
    c_ca = norm(cross(c, a))
    cos_c = dot(a, b)
    cos_alpha = -dot(c_ab, c_ca)
    cos_beta = -dot(c_bc, c_ab)
    cos_gamma = -dot(c_ca, c_bc)
    alpha = torch.arccos(torch.clamp(cos_alpha, -1.0, 1.0))
    sin_alpha = torch.sqrt(torch.clamp(1.0 - cos_alpha ** 2, min=0.0))
    sph_area = (alpha + torch.arccos(torch.clamp(cos_beta, -1.0, 1.0))
                + torch.arccos(torch.clamp(cos_gamma, -1.0, 1.0)) - _PI)

    def project(va, vb):
        return norm(va - dot(va, vb, keepdim=True) * vb)

    area_hat = sph_area * u0
    s = torch.sin(area_hat - alpha)
    t = torch.cos(area_hat - alpha)
    uu = t - cos_alpha
    vv = s + sin_alpha * cos_c
    denom = (vv * s + uu * t) * sin_alpha
    q = torch.where(torch.abs(denom) > 1e-12,
                    ((vv * t - uu * s) * cos_alpha - vv)
                    / torch.where(denom == 0, 1.0, denom), 0.0)
    q = torch.clamp(q, -1.0, 1.0)
    c_hat = (q[..., None] * a
             + torch.sqrt(torch.clamp(1 - q ** 2, min=0.0))[..., None]
             * project(c, a))
    z = torch.clamp(1.0 - u1 * (1.0 - dot(c_hat, b)), -1.0, 1.0)
    direction = (z[..., None] * b
                 + torch.sqrt(torch.clamp(1 - z ** 2, min=0.0))[..., None]
                 * project(c_hat, b))

    # the barycentrics where the direction meets the triangle's plane
    e_ab = p_b - p_a
    e_ac = p_c - p_a
    pv = cross(direction, e_ac)
    det = dot(e_ab, pv)
    rec_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    tv = shading_point - p_a
    bc_b = dot(tv, pv) * rec_det
    qv = cross(tv, e_ab)
    bc_c = dot(direction, qv) * rec_det
    dist = dot(e_ac, qv) * rec_det
    bc_a = 1.0 - bc_b - bc_c
    position = (bc_a[..., None] * p_a + bc_b[..., None] * p_b
                + bc_c[..., None] * p_c)

    gn = norm(geom_n)
    dir_pdf = torch.where(sph_area > 1e-8,
                          1.0 / torch.clamp(sph_area, min=1e-8), 0.0)
    lp_cos = -dot(direction, gn)
    pdf = torch.where(
        (lp_cos > 0.0) & torch.isfinite(dir_pdf) & (dist > 0.0),
        light_prob * dir_pdf * lp_cos / torch.clamp(dist ** 2, min=1e-12),
        0.0)
    normal = norm(bc_a[..., None] * n0 + bc_b[..., None] * n1
                  + bc_c[..., None] * n2)
    mat = scene.units.material[unit].to(torch.int64)
    return LightSample(position=position, normal=normal,
                       emittance=scene.materials.emittance[mat], pdf=pdf,
                       at_infinity=torch.zeros(pdf.shape, dtype=torch.bool,
                                               device=pdf.device))


def sample_env_light(scene: SceneData, u0, u1) -> LightSample:
    env = scene.env
    u, v, uv_pdf = sample_continuous_2d(env.importance, u1, u0)
    direction = env_dir_from_uv(env, u, v)
    sin_t = torch.clamp(torch.sin(_PI * v), min=1e-6)
    pdf = uv_pdf / (2.0 * _PI * _PI * sin_t)
    # Le = emittance / pi = coeff * tex; bilinear as env_radiance so NEE and
    # implicit hits agree (MIS consistency)
    emittance = _PI * env_radiance(env, direction)
    return LightSample(position=direction, normal=-direction,
                       emittance=emittance, pdf=pdf,
                       at_infinity=torch.ones(pdf.shape, dtype=torch.bool,
                                              device=pdf.device))


def _mix_env(scene: SceneData, u_light, u0, u1, surface):
    """Light sample mixing env and surface lights with the fixed 0.25 env
    probability; u_light picks the family and is remapped into it, and
    `surface(u_surf)` samples the surface lights. The pdf includes the
    selection probability."""
    surface_ok = scene.total_emissive_importance > 0.0
    if scene.env is None:
        surf = surface(u_light)
        surf.pdf = torch.where(surface_ok, surf.pdf, 0.0)
        return surf
    p_env = (torch.where(surface_ok, PROB_SAMPLE_ENV, 1.0)
             * torch.where(scene.env.enabled, 1.0, 0.0))
    pick_env = u_light < p_env
    u_surf = torch.clamp((u_light - p_env) / torch.clamp(1.0 - p_env,
                                                         min=1e-8),
                         0.0, 1.0 - 1e-7)
    surf = surface(u_surf)
    envs = sample_env_light(scene, u0, u1)
    pe3 = pick_env[..., None]
    pdf = torch.where(pick_env, envs.pdf * p_env,
                      torch.where(surface_ok, surf.pdf * (1.0 - p_env), 0.0))
    return LightSample(
        position=torch.where(pe3, envs.position, surf.position),
        normal=torch.where(pe3, envs.normal, surf.normal),
        emittance=torch.where(pe3, envs.emittance, surf.emittance),
        pdf=pdf, at_infinity=pick_env)


def sample_light(scene: SceneData, u_light, u0, u1, packed) -> LightSample:
    """Light sample of the area strategy (`packed`: the hoisted
    pack_light_rows table, or None)."""
    return _mix_env(scene, u_light, u0, u1, lambda u: sample_surface_light(
        scene, u, u0, u1, packed))


def sample_light_solid_angle(scene: SceneData, shading_point, u_light, u0,
                             u1) -> LightSample:
    """sample_light with the solid-angle strategy for surface lights."""
    return _mix_env(scene, u_light, u0, u1,
                    lambda u: sample_surface_light_solid_angle(
                        scene, shading_point, u, u0, u1))


def surface_light_pdf(scene: SceneData, tri_idx, inst=None):
    """Area pdf of sampling triangle `tri_idx`'s surface through
    sample_surface_light (implicit-hit MIS). Two-level scenes need the hit
    instance: the pmf is per (instance, triangle) and the area is the world
    one."""
    tris = scene.triangles
    tri_idx = tri_idx.to(torch.int64)
    if scene.is_instanced:
        inst = torch.clamp(inst.to(torch.int64), min=0)
        unit = (scene.inst_unit_base[inst]
                + tris.unit_id[tri_idx]).to(torch.int64)
        light_pos = (scene.units.tri_offset[unit]
                     + scene.tri_light_local[tri_idx]
                     - scene.unit_tri_base[unit]).to(torch.int64)
        # non-emissive units have no light-order segment: their position
        # falls outside (clamped; their unit pmf is 0), as JAX's clamped
        # gather reads it
        light_pos = torch.clamp(light_pos, 0,
                                scene.units.light_tri_pmf.shape[0] - 1)
        tri_pmf = scene.units.light_tri_pmf[light_pos]
        m = scene.instances.transform[inst]
        e1 = rotate(m, tris.e1[tri_idx])
        e2 = rotate(m, tris.e2[tri_idx])
    else:
        unit = tris.unit_id[tri_idx].to(torch.int64)
        tri_pmf = scene.units.light_tri_pmf[tri_idx]
        e1, e2 = tris.e1[tri_idx], tris.e2[tri_idx]
    cr_len = length(cross(e1, e2))
    rec_area = 2.0 / torch.clamp(cr_len, min=1e-20)
    return scene.light_unit_pmf[unit] * tri_pmf * rec_area


def light_selection_probs(scene: SceneData):
    """(p_env, p_surface) selection probabilities, as 0-d tensors."""
    surface_ok = scene.total_emissive_importance > 0.0
    if scene.env is None:
        return (torch.zeros((), device=surface_ok.device),
                torch.where(surface_ok, 1.0, 0.0))
    p_env = (torch.where(surface_ok, PROB_SAMPLE_ENV, 1.0)
             * torch.where(scene.env.enabled, 1.0, 0.0))
    return p_env, torch.where(surface_ok, 1.0 - p_env, 0.0)
