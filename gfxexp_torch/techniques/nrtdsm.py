"""NRTDSM: nonlinear ray tracing for displacement and shell mapping (port of
gfxexp_tpu/techniques/nrtdsm.py).

A base mesh is displaced along its interpolated vertex normals, exactly:
the shell height h of a world point x solves the cubic det[B(h) - A(h),
C(h) - A(h), x - A(h)] = 0 with A(h) = pA + h nA and so on, and its
barycentrics follow from the in-plane solve (`find_height`). In the shell's
texture space a ray is a rational quadratic curve in h
(`compute_canonical_space_ray_coeffs`, `compute_texture_space_ray_coeffs`).

Intersectors, each streaming a ray's prisms nearest first through TFDM's
candidate iterator (techniques/tfdm.py `iterate_candidates`):
- `intersect_nrtdsm_v2` (the path tracer's, for the bilinear surface and
  the others but two-triangle): a march of n_steps fixed samples of the
  gap between the exact shell height and the displaced height, then
  bisection;
- `intersect_nrtdsm_exact` (two-triangle): the texture-space curve walked
  over the prism's height range in n_h segments; each segment whose
  min/max texel overlaps it solves the exact cubic of the curve against
  the texel's two micro-triangles (`nonlinear_ray_vs_micro_triangle`);
- `intersect_nrtdsm`: v2's march over every base triangle in turn (the
  tests' oracle).
`nonlinear_ray_vs_aabb` bounds the curve with affine arithmetic
(core/interval.py).

The build is numpy on the host, as in the JAX package, and gives the same
arrays. The queries are plain PyTorch on the device that holds the
geometry, op for op the JAX package's arithmetic. Fixed-count loops whose
samples do not depend on one another (a march's samples, a scan's
sub-intervals, the three points of a normal's finite difference) are
evaluated together, stacked on a leading axis, which changes no result;
the bisections run step by step. The data-dependent loop of the exact
intersector is a host loop over the rays still live, one sync a test
(the counter `tfdm.syncs`). A division by a constant rounds as the JAX package's
does: XLA compiles one inside a traced loop (the candidate rounds, every
fori_loop) as a product with the float32 reciprocal (`_rcp`), the eager
v1 intersector's as a division, which the port makes by a tensor on the
rays' device (CUDA divides by a Python number through its reciprocal).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gfxexp_torch.core.math import cross, dot, length_rn
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.techniques import tfdm as _tfdm
from gfxexp_torch.techniques.tfdm import (
    DisplacementParameters,
    MinMaxMipmap,
    PrismBVH,
    _displace,
    _rays,
    _safe_inv_d,
    _sample_height_at,
    _select,
    _uv_transform,
    build_minmax_mipmap,
    iterate_candidates,
)
from gfxexp_torch.utils import trace


def _div(x, n: float):
    """x / n, with the divisor a tensor on x's device."""
    return x / torch.full((), float(n), device=x.device)


def _rcp(n: float) -> float:
    """The float32 reciprocal of n: XLA compiles a division by a constant
    inside a traced loop as a product with it (and CUDA a division by a
    Python number), so the JAX package's loops round x / n as
    x * _rcp(n)."""
    return float(np.float32(1.0) / np.float32(n))


def _first_true(mask, dim: int = 0):
    """The index of the first true entry along `dim` (its size where there
    is none): the first of a stack of fixed-count loop iterations to meet
    its condition."""
    n = mask.shape[dim]
    shape = [1] * mask.ndim
    shape[dim] = n
    iota = torch.arange(n, device=mask.device).reshape(shape)
    return torch.where(mask, iota, n).amin(dim)


def _pick(stack, idx):
    """stack[idx[...], ...] along the leading axis."""
    return torch.gather(stack, 0, idx[None])[0]


def _int_sat(x):
    """float32 -> int64 as XLA converts to int32: NaN to 0, saturated to
    the int32 range."""
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(torch.clamp(x, -3e9, 3e9).to(torch.int64),
                       -2 ** 31, 2 ** 31 - 1)


# ---------------------------------------------------------------------------
# polynomials: the smallest root of a cubic in an interval
# ---------------------------------------------------------------------------


def eval_cubic(coeffs, x):
    """coeffs [..., 4] = (k0, k1, k2, k3) of k0 + k1 x + k2 x^2 + k3 x^3."""
    k0, k1, k2, k3 = (coeffs[..., i] for i in range(4))
    return k0 + x * (k1 + x * (k2 + x * k3))


def solve_cubic_in_interval(coeffs, x_lo, x_hi, n_scan: int = 8,
                            n_bisect: int = 24):
    """The smallest root of the cubic in [x_lo, x_hi]: the first of n_scan
    sub-intervals whose ends differ in sign, then n_bisect bisections.
    (root, found); root = x_hi where none was found."""
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x_lo.shape, x_hi.shape)
    x_lo = x_lo.expand(shape)
    x_hi = x_hi.expand(shape)
    span = x_hi - x_lo
    # the scan's n_scan + 1 points, evaluated together (float32 fractions,
    # as the JAX loop scales its float32 counter)
    fracs = [float(np.float32(i) * np.float32(_rcp(n_scan)))
             for i in range(1, n_scan + 1)]
    xs = torch.stack([x_lo] + [x_lo + span * f for f in fracs])
    sg = torch.sign(eval_cubic(coeffs, xs))
    change = sg[:-1] != sg[1:]  # [n_scan, ...]
    first = _first_true(change)
    found = first < n_scan
    k = torch.clamp(first, max=n_scan - 1)
    lo = torch.where(found, _pick(xs[:-1], k), x_hi)
    hi = torch.where(found, _pick(xs[1:], k), x_hi)

    f_lo = eval_cubic(coeffs, lo)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        f_mid = eval_cubic(coeffs, mid)
        same = torch.sign(f_mid) == torch.sign(f_lo)
        lo, hi, f_lo = (torch.where(same, mid, lo), torch.where(same, hi, mid),
                        torch.where(same, f_mid, f_lo))
    return 0.5 * (lo + hi), found


# ---------------------------------------------------------------------------
# canonical- and texture-space ray coefficients
# ---------------------------------------------------------------------------


def _cross2(u, v):
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def compute_canonical_space_ray_coeffs(ray_org, e0, e1, p_a, p_b, p_c,
                                       n_a, n_b, n_c):
    """The ray's barycentrics as rational quadratics in h: alpha(h) =
    (bc2.x h^2 + bc1.x h + bc0.x) / denom(h), beta(h) likewise with .y,
    denom(h) = denom2 h^2 + denom1 h + denom0; e0, e1 span the plane
    orthogonal to the ray's direction."""
    def proj2(v):
        return torch.stack([dot(v, e0), dot(v, e1)], -1)

    e_ab = proj2(p_b - p_a)
    e_ac = proj2(p_c - p_a)
    f_ab = proj2(n_b - n_a)
    f_ac = proj2(n_c - n_a)
    e_ao = proj2(ray_org - p_a)
    na = proj2(n_a)

    denom2 = _cross2(f_ab, f_ac)
    denom1 = _cross2(e_ab, f_ac) + _cross2(f_ab, e_ac)
    denom0 = _cross2(e_ab, e_ac)
    bc2 = torch.stack([-_cross2(na, f_ac), _cross2(na, f_ab)], -1)
    bc1 = torch.stack(
        [_cross2(e_ao, f_ac) - _cross2(na, e_ac),
         -(_cross2(e_ao, f_ab) - _cross2(na, e_ab))], -1)
    bc0 = torch.stack([_cross2(e_ao, e_ac), -_cross2(e_ao, e_ab)], -1)
    return bc2, bc1, bc0, denom2, denom1, denom0


def compute_texture_space_ray_coeffs(tc_a, tc_b, tc_c, bc2, bc1, bc0,
                                     denom2, denom1, denom0):
    """The ray's texture-space curve: uv(h) = (tc2 h^2 + tc1 h + tc0) /
    denom(h)."""
    def mix(bc, den):
        w = (den - bc[..., 0] - bc[..., 1])[..., None]
        return w * tc_a + bc[..., 0:1] * tc_b + bc[..., 1:2] * tc_c

    return mix(bc2, denom2), mix(bc1, denom1), mix(bc0, denom0)


# ---------------------------------------------------------------------------
# the shell coordinates of a world point
# ---------------------------------------------------------------------------


def height_cubic_coeffs(p_a, p_b, p_c, n_a, n_b, n_c, x):
    """The coefficients [..., 4] of det[B(h) - A(h), C(h) - A(h),
    x - A(h)] = 0, a cubic in h, with A(h) = pA + h nA and so on."""
    e_ab = p_b - p_a
    e_ac = p_c - p_a
    f_ab = n_b - n_a
    f_ac = n_c - n_a
    e_ax = x - p_a
    c0 = cross(e_ab, e_ac)
    c1 = cross(e_ab, f_ac) + cross(f_ab, e_ac)
    c2 = cross(f_ab, f_ac)
    k0 = dot(c0, e_ax)
    k1 = dot(c1, e_ax) - dot(c0, n_a)
    k2 = dot(c2, e_ax) - dot(c1, n_a)
    k3 = -dot(c2, n_a)
    return torch.stack(torch.broadcast_tensors(k0, k1, k2, k3), -1)


def find_height(p_a, p_b, p_c, n_a, n_b, n_c, x, h_lo, h_hi):
    """The shell height and barycentrics of points x [..., 3] (the prism's
    attributes broadcast against them): (h, b1, b2, found)."""
    coeffs = height_cubic_coeffs(p_a, p_b, p_c, n_a, n_b, n_c, x)
    h, found = solve_cubic_in_interval(coeffs, h_lo, h_hi)
    # barycentrics in the plane at height h
    a_h = p_a + h[..., None] * n_a
    b_h = p_b + h[..., None] * n_b
    c_h = p_c + h[..., None] * n_c
    e1 = b_h - a_h
    e2 = c_h - a_h
    rel = x - a_h
    d00 = dot(e1, e1)
    d01 = dot(e1, e2)
    d11 = dot(e2, e2)
    det = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
    qa = dot(rel, e1)
    qb = dot(rel, e2)
    b1 = (d11 * qa - d01 * qb) / det
    b2 = (d00 * qb - d01 * qa) / det
    return h, b1, b2, found


def shell_point(p_a, p_b, p_c, n_a, n_b, n_c, b1, b2, h):
    """The forward shell map S(b1, b2, h)."""
    w = 1.0 - b1 - b2
    base = w[..., None] * p_a + b1[..., None] * p_b + b2[..., None] * p_c
    nrm = w[..., None] * n_a + b1[..., None] * n_b + b2[..., None] * n_c
    return base + h[..., None] * nrm


def test_ray_vs_prism(o, d, p_a, p_b, p_c, n_a, n_b, n_c, h_lo, h_hi,
                      t_min, t_max):
    """A conservative ray-prism interval from the box of the prism's six
    corners: (near, far, near <= far)."""
    stack = torch.stack([p_a + h_lo * n_a, p_b + h_lo * n_b, p_c + h_lo * n_c,
                         p_a + h_hi * n_a, p_b + h_hi * n_b,
                         p_c + h_hi * n_c])
    lo = stack.amin(0) - 1e-5
    hi = stack.amax(0) + 1e-5
    inv_d = _safe_inv_d(d)
    t0 = (lo[None] - o) * inv_d
    t1 = (hi[None] - o) * inv_d
    near = torch.maximum(torch.minimum(t0, t1).amax(-1), t_min)
    far = torch.minimum(torch.maximum(t0, t1).amin(-1), t_max)
    return near, far, near <= far


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@dataclass
class NRTDSMGeometry(TensorData):
    """A displaced base mesh with exact nonlinear shells: the base
    triangles' corners, vertex normals and uvs, the height map and its
    min/max pyramid, the displaced height range [h_lo, h_hi]."""

    p0: torch.Tensor  # [B, 3] (corner A)
    p1: torch.Tensor
    p2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # [B, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    height: torch.Tensor  # [S, S]
    minmax: MinMaxMipmap
    h_lo: float = 0.0
    h_hi: float = 1.0
    material: int = 0
    params: DisplacementParameters = DisplacementParameters()
    # the skip-walk box BVH over the prism boxes, from 2,048 base triangles
    prism_bvh: Optional[PrismBVH] = None


def _prism_corners(positions, normals, i0, i1, i2, dlo, dhi):
    return np.stack([
        positions[i0] + dlo * normals[i0],
        positions[i1] + dlo * normals[i1],
        positions[i2] + dlo * normals[i2],
        positions[i0] + dhi * normals[i0],
        positions[i1] + dhi * normals[i1],
        positions[i2] + dhi * normals[i2],
    ], axis=1)


def _t32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def build_nrtdsm_geometry(positions, indices, uvs, height, params=None,
                          material: int = 0, normals=None) -> NRTDSMGeometry:
    """Host build (numpy; CPU tensors), with the prism BVH from 2,048 base
    triangles up."""
    from gfxexp_torch.scene.builder import compute_smooth_normals
    from gfxexp_torch.techniques.tfdm import build_prism_bvh

    params = params or DisplacementParameters()
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    uvs = np.asarray(uvs, np.float32)
    if normals is None:
        normals = compute_smooth_normals(positions, indices)
    mm = build_minmax_mipmap(height)
    hmin = float(mm.levels[mm.n_levels - 1, 0, 0, 0])
    hmax = float(mm.levels[mm.n_levels - 1, 0, 0, 1])
    d_lo = params.h_offset + params.h_scale * (hmin - params.h_bias)
    d_hi = params.h_offset + params.h_scale * (hmax - params.h_bias)
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    h = np.asarray(height, np.float32)
    if h.ndim == 3:
        h = h[..., 0]
    prism_bvh = None
    if len(i0) >= 2048:
        dlo, dhi = min(d_lo, d_hi) - 1e-5, max(d_lo, d_hi) + 1e-5
        corners = _prism_corners(positions, normals, i0, i1, i2, dlo, dhi)
        prism_bvh = build_prism_bvh(corners.min(axis=1) - 1e-5,
                                    corners.max(axis=1) + 1e-5)
    return NRTDSMGeometry(
        p0=_t32(positions[i0]), p1=_t32(positions[i1]),
        p2=_t32(positions[i2]),
        n0=_t32(normals[i0]), n1=_t32(normals[i1]), n2=_t32(normals[i2]),
        uv0=_t32(uvs[i0]), uv1=_t32(uvs[i1]), uv2=_t32(uvs[i2]),
        height=_t32(h), minmax=mm,
        h_lo=min(d_lo, d_hi) - 1e-5, h_hi=max(d_lo, d_hi) + 1e-5,
        material=int(material), params=params, prism_bvh=prism_bvh)


def nrtdsm_from_numpy(g) -> NRTDSMGeometry:
    """A gfxexp_tpu NRTDSMGeometry (read by attribute name) -> the port's on
    the CPU."""
    from gfxexp_torch.techniques.tfdm import (
        minmax_from_numpy,
        params_from_numpy,
        prism_bvh_from_numpy,
    )

    return NRTDSMGeometry(
        **{k: torch.from_numpy(np.array(getattr(g, k))) for k in (
            "p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
            "height")},
        minmax=minmax_from_numpy(g.minmax), h_lo=float(g.h_lo),
        h_hi=float(g.h_hi), material=int(g.material),
        params=params_from_numpy(g.params),
        prism_bvh=prism_bvh_from_numpy(g.prism_bvh))


def prism_boxes(g):
    """The boxes of the prisms over [h_lo, h_hi] of a geometry with base
    corners p0-p2 and vertex normals n0-n2 (NRTDSM and shells): (lo, hi)
    [B, 3]."""
    corners = torch.stack([
        g.p0 + g.h_lo * g.n0, g.p1 + g.h_lo * g.n1, g.p2 + g.h_lo * g.n2,
        g.p0 + g.h_hi * g.n0, g.p1 + g.h_hi * g.n1, g.p2 + g.h_hi * g.n2,
    ], 1)
    return corners.amin(1) - 1e-5, corners.amax(1) + 1e-5


@dataclass
class NRTDSMHit(TensorData):
    t: torch.Tensor  # [R]
    hit: torch.Tensor
    position: torch.Tensor  # [R, 3]
    normal: torch.Tensor
    uv: torch.Tensor  # [R, 2]
    prim: torch.Tensor  # [R] int32 base triangle
    steps: torch.Tensor  # [R] int32 march steps or exact segments


def _height_field(geom, uv):
    """The displaced height at uv (the texture transform applied first)."""
    p = geom.params
    return _displace(p, _sample_height_at(geom.height, p,
                                          _uv_transform(p, uv)))


class _Prism:
    """One candidate prism a ray ([m, ...] rows, or one base triangle's
    [3] / [2] rows that broadcast): its corners, vertex normals and uvs,
    with the march's gap evaluation over [h_lo, h_hi]."""

    def __init__(self, geom, p, n, uv, o=None, d=None, h_lo=None,
                 h_hi=None):
        self.geom = geom
        self.p, self.n, self.uv = p, n, uv
        self.o, self.d = o, d
        self.h_lo, self.h_hi = h_lo, h_hi

    @classmethod
    def of(cls, geom, b, o=None, d=None, h_lo=None, h_hi=None):
        """Base triangle(s) b of geom."""
        return cls(geom, (geom.p0[b], geom.p1[b], geom.p2[b]),
                   (geom.n0[b], geom.n1[b], geom.n2[b]),
                   (geom.uv0[b], geom.uv1[b], geom.uv2[b]), o, d, h_lo, h_hi)

    def gap_at(self, t):
        """(gap, inside, uv, (b1, b2, h)) of the ray points at t ([..., m]:
        leading axes evaluate several t a ray at once)."""
        x = self.o + t[..., None] * self.d
        h, b1, b2, ok = find_height(*self.p, *self.n, x, self.h_lo,
                                    self.h_hi)
        w = 1.0 - b1 - b2
        inside = ok & (b1 >= -1e-3) & (b2 >= -1e-3) & (w >= -1e-3)
        uv_a, uv_b, uv_c = self.uv
        uv = w[..., None] * uv_a + b1[..., None] * uv_b + b2[..., None] * uv_c
        return h - _height_field(self.geom, uv), inside, uv, (b1, b2, h)

    def surf(self, bb1, bb2):
        """The displaced surface at base barycentrics (bb1, bb2)."""
        w = 1.0 - bb1 - bb2
        uv_a, uv_b, uv_c = self.uv
        uv = (w[..., None] * uv_a + bb1[..., None] * uv_b
              + bb2[..., None] * uv_c)
        return shell_point(*self.p, *self.n, bb1, bb2,
                           _height_field(self.geom, uv))

    def normal(self, b1, b2, eps: float = 1e-3):
        """The displaced surface's normal by finite differences in (b1, b2)
        (its three points together), turned toward the shading normal."""
        s = self.surf(torch.stack([b1, b1 + eps, b1]),
                      torch.stack([b2, b2, b2 + eps]))
        nrm = cross(s[1] - s[0], s[2] - s[0])
        nrm = nrm / torch.clamp(length_rn(nrm, keepdim=True), min=1e-20)
        n_a, n_b, n_c = self.n
        nsh = ((1 - b1 - b2)[..., None] * n_a + b1[..., None] * n_b
               + b2[..., None] * n_c)
        return nrm * torch.sign(dot(nrm, nsh, keepdim=True) + 1e-12)

    def march(self, near, far, dt, active, n_steps: int):
        """The first sign change of the gap among n_steps fixed steps of dt
        from near (all samples together): (found, t_lo, t_hi)."""
        ts = torch.stack([near] + [near + dt * float(k)
                                   for k in range(1, n_steps + 1)])
        gap, inside, _, _ = self.gap_at(ts)
        sg = torch.sign(gap)
        crossing = (active & inside[:-1] & inside[1:]
                    & (sg[:-1] != sg[1:]))  # [n_steps, m]
        first = _first_true(crossing)
        found = first < n_steps
        k = torch.clamp(first, max=n_steps - 1)
        t_lo = torch.where(found, _pick(ts[:-1], k), near)
        t_hi = torch.where(found, _pick(ts[1:], k), far)
        return found, t_lo, t_hi

    def refine(self, t_lo, t_hi, n_refine: int):
        """n_refine bisections of [t_lo, t_hi]: the hit's t."""
        gap_lo = self.gap_at(t_lo)[0]
        for _ in range(n_refine):
            t_mid = 0.5 * (t_lo + t_hi)
            gap_mid = self.gap_at(t_mid)[0]
            same = torch.sign(gap_mid) == torch.sign(gap_lo)
            t_lo, t_hi, gap_lo = (torch.where(same, t_mid, t_lo),
                                  torch.where(same, t_hi, t_mid),
                                  torch.where(same, gap_mid, gap_lo))
        return 0.5 * (t_lo + t_hi)


def intersect_nrtdsm(geom: NRTDSMGeometry, o, d, t_min=1e-4, t_max=1e30,
                     n_steps: int = 48, n_refine: int = 8) -> NRTDSMHit:
    """Curved-ray displacement intersection against every base triangle in
    turn: the prism's box, a march of the gap between the exact shell
    height and the displaced height, and bisection of its first sign
    change (the tests' oracle)."""
    n = o.shape[0]
    dev = o.device
    t_min = _rays(t_min, n, dev)
    best_t = _rays(t_max, n, dev).clone()
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_uv = torch.zeros((n, 2), device=dev)
    best_pos = torch.zeros((n, 3), device=dev)
    best_nrm = torch.zeros((n, 3), device=dev)
    steps_total = torch.zeros((n,), dtype=torch.int32, device=dev)
    h_lo_v = torch.full((n,), geom.h_lo, device=dev)
    h_hi_v = torch.full((n,), geom.h_hi, device=dev)

    for b in range(geom.p0.shape[0]):
        pr = _Prism.of(geom, b, o, d, h_lo_v, h_hi_v)
        near, far, active = test_ray_vs_prism(
            o, d, *pr.p, *pr.n, geom.h_lo, geom.h_hi, t_min, best_t)
        # the JAX package runs this intersector eagerly: a true division
        found, t_lo, t_hi = pr.march(near, far, _div(far - near, n_steps),
                                     active, n_steps)
        t_hit = pr.refine(t_lo, t_hi, n_refine)
        steps_total = steps_total + torch.where(active, n_steps, 0).to(
            torch.int32)
        take = found & (t_hit > t_min) & (t_hit < best_t)
        _, _, uv_hit, (b1, b2, _) = pr.gap_at(t_hit)
        nrm = pr.normal(b1, b2)
        best_prim = torch.where(take, b, best_prim)
        best_t = torch.where(take, t_hit, best_t)
        best_uv = torch.where(take[:, None], uv_hit, best_uv)
        best_pos = torch.where(take[:, None], o + t_hit[:, None] * d,
                               best_pos)
        best_nrm = torch.where(take[:, None], nrm, best_nrm)
    return NRTDSMHit(t=best_t, hit=best_prim >= 0, position=best_pos,
                     normal=best_nrm, uv=best_uv, prim=best_prim,
                     steps=steps_total)


def _state0(n, t_max, dev):
    return (_rays(t_max, n, dev).clone(),  # best_t
            torch.full((n,), -1, dtype=torch.int32, device=dev),  # prim
            torch.zeros((n, 2), device=dev),  # uv
            torch.zeros((n, 3), device=dev),  # normal
            torch.zeros((n,), dtype=torch.int32, device=dev))  # steps


def _scatter(state, sel, best_t, best_prim, best_uv, best_nrm, steps):
    """The state with the selected rays' new values ([m] rows of sel)."""
    st_t, st_prim, st_uv, st_nrm, st_steps = state
    return (st_t.index_put((sel,), best_t),
            st_prim.index_put((sel,), best_prim),
            st_uv.index_put((sel,), best_uv),
            st_nrm.index_put((sel,), best_nrm),
            st_steps.index_add(0, sel, steps))


def _hit(o, d, state) -> NRTDSMHit:
    best_t, best_prim, best_uv, best_nrm, steps = state
    return NRTDSMHit(t=best_t, hit=best_prim >= 0,
                     position=o + best_t[:, None] * d, normal=best_nrm,
                     uv=best_uv, prim=best_prim, steps=steps)


def intersect_nrtdsm_v2(geom: NRTDSMGeometry, o, d, t_min=1e-4, t_max=1e30,
                        k_candidates: int = 4, n_steps: int = 48,
                        n_refine: int = 8) -> NRTDSMHit:
    """The nonlinear-shell intersection over each ray's candidate prisms,
    nearest first, until the next prism box lies past the best hit: in each
    prism the exact height cubic's march and bisection (a round marches
    only the rays that enter a prism; `steps` counts march steps)."""
    trace.count("tfdm.nrtdsm_calls")
    n = o.shape[0]
    dev = o.device
    lo, hi = prism_boxes(geom)
    t_min_v = _rays(t_min, n, dev)

    def process(state, cid, near, far):
        best_t = state[0]
        far = torch.minimum(far, best_t)
        # the rays that march this round; the others keep their state
        sel = _select((cid >= 0) & (near < far))
        if sel.numel() == 0:
            return state
        m = sel.numel()
        cid, near, far, bt = cid[sel], near[sel], far[sel], best_t[sel]
        pr = _Prism.of(geom, cid.to(torch.int64), o[sel], d[sel],
                       torch.full((m,), geom.h_lo, device=dev),
                       torch.full((m,), geom.h_hi, device=dev))
        active = torch.ones((m,), dtype=torch.bool, device=dev)
        found, t_lo, t_hi = pr.march(near, far,
                                     (far - near) * _rcp(n_steps), active,
                                     n_steps)
        steps = torch.full((m,), n_steps, dtype=torch.int32, device=dev)
        if not _tfdm._any(found):
            return _scatter(state, sel, bt, state[1][sel], state[2][sel],
                            state[3][sel], steps)
        t_hit = pr.refine(t_lo, t_hi, n_refine)
        take = found & (t_hit > t_min_v[sel]) & (t_hit < bt)
        _, _, uv_hit, (b1, b2, _) = pr.gap_at(t_hit)
        nrm = pr.normal(b1, b2)
        return _scatter(
            state, sel, torch.where(take, t_hit, bt),
            torch.where(take, cid, state[1][sel]),
            torch.where(take[:, None], uv_hit, state[2][sel]),
            torch.where(take[:, None], nrm, state[3][sel]), steps)

    state = iterate_candidates(lo, hi, o, d, t_min, t_max, k_candidates,
                               _state0(n, t_max, dev), process,
                               lambda st: st[0], prism_bvh=geom.prism_bvh)
    return _hit(o, d, state)


# ---------------------------------------------------------------------------
# exact curved-ray tests
# ---------------------------------------------------------------------------


def nonlinear_ray_vs_aabb(tc2, tc1, tc0, den2, den1, den0, h_lo, h_hi,
                          box_lo, box_hi):
    """A conservative overlap test of the texture-space curve q(h) =
    ((tc2 h^2 + tc1 h + tc0) / den(h), h), h in [h_lo, h_hi], against
    boxes in (u, v, h): the numerators and the denominator are bounded with
    affine arithmetic over the one height symbol, then divided as
    intervals (a denominator straddling 0 overlaps)."""
    from gfxexp_torch.core.interval import (
        aa_poly2,
        aa_to_iv,
        aa_var,
        iv,
        iv_mul,
        iv_overlaps,
        iv_recip,
    )

    h = aa_var(h_lo, h_hi, 0, 1)
    nu = aa_to_iv(aa_poly2(tc2[..., 0], tc1[..., 0], tc0[..., 0], h))
    nv = aa_to_iv(aa_poly2(tc2[..., 1], tc1[..., 1], tc0[..., 1], h))
    dd = aa_to_iv(aa_poly2(den2, den1, den0, h))
    rec = iv_recip(dd)
    u_iv = iv_mul(nu, rec)
    v_iv = iv_mul(nv, rec)
    ok_u = iv_overlaps(u_iv, iv(box_lo[..., 0], box_hi[..., 0]))
    ok_v = iv_overlaps(v_iv, iv(box_lo[..., 1], box_hi[..., 1]))
    ok_h = (h_lo <= box_hi[..., 2]) & (h_hi >= box_lo[..., 2])
    return ok_u & ok_v & ok_h


def nonlinear_ray_vs_micro_triangle(tc2, tc1, tc0, den2, den1, den0,
                                    pa, pb, pc, h_lo, h_hi):
    """The exact first hit of the texture-space curve on a triangle in
    (u, v, h): u(h) = Nu(h) / D(h), v(h) = Nv(h) / D(h) put into the
    triangle's plane n.q = c and multiplied by D(h) give a cubic in h,
    n_u Nu + n_v Nv + n_h h D - c D = 0, whose first root in [h_lo, h_hi]
    is then tested for containment: (hit, h_root, b1, b2)."""
    e1 = pb - pa
    e2 = pc - pa
    n = cross(e1, e2)
    c = dot(n, pa)
    nu_, nv_, nh_ = n[..., 0], n[..., 1], n[..., 2]
    k3 = nh_ * den2
    k2 = nu_ * tc2[..., 0] + nv_ * tc2[..., 1] + nh_ * den1 - c * den2
    k1 = nu_ * tc1[..., 0] + nv_ * tc1[..., 1] + nh_ * den0 - c * den1
    k0 = nu_ * tc0[..., 0] + nv_ * tc0[..., 1] - c * den0
    coeffs = torch.stack(torch.broadcast_tensors(k0, k1, k2, k3), -1)
    h, found = solve_cubic_in_interval(coeffs, h_lo, h_hi, n_scan=16,
                                       n_bisect=24)
    den = den2 * h * h + den1 * h + den0
    den_ok = torch.abs(den) > 1e-12
    safe = torch.where(den_ok, den, 1.0)
    u = (tc2[..., 0] * h * h + tc1[..., 0] * h + tc0[..., 0]) / safe
    v = (tc2[..., 1] * h * h + tc1[..., 1] * h + tc0[..., 1]) / safe
    q = torch.stack([u, v, h], -1)
    d00 = dot(e1, e1)
    d01 = dot(e1, e2)
    d11 = dot(e2, e2)
    det = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
    rel = q - pa
    qa = dot(rel, e1)
    qb = dot(rel, e2)
    b1 = (d11 * qa - d01 * qb) / det
    b2 = (d00 * qb - d01 * qa) / det
    inside = (b1 >= -1e-4) & (b2 >= -1e-4) & (b1 + b2 <= 1.0 + 1e-4)
    return found & den_ok & inside, h, b1, b2


def intersect_nrtdsm_exact(geom: NRTDSMGeometry, o, d, t_min=1e-4,
                           t_max=1e30, k_candidates: int = 4,
                           n_h: int = 64, ordered: bool = True) -> NRTDSMHit:
    """The exact intersection of the two-triangle local surface: in each
    candidate prism the texture-space curve is walked over the displaced
    height range in n_h segments; a segment whose min/max texel (under its
    midpoint) overlaps its height span solves the exact cubic of the curve
    against the texel's two micro-triangles (split along the (u0, v0) -
    (u1, v1) diagonal), so hit heights are exact roots.

    ordered=True (the default) gates all n_h segments at once and then
    visits only the occupied ones, nearest first, in a host loop over the
    rays that still have one (one sync a step; `steps` counts the visits);
    ordered=False runs every segment, predicated on occupancy."""
    trace.count("tfdm.nrtdsm_calls")
    n = o.shape[0]
    dev = o.device
    s = geom.height.shape[0]
    p = geom.params
    lo, hi = prism_boxes(geom)

    # the per-ray basis of the plane orthogonal to the ray
    up = torch.where((torch.abs(d[:, 0]) < 0.8)[:, None],
                     torch.tensor([1.0, 0.0, 0.0], device=dev),
                     torch.tensor([0.0, 1.0, 0.0], device=dev))
    e0 = cross(d, up)
    e0 = e0 / torch.clamp(length_rn(e0, keepdim=True), min=1e-20)
    e1b = cross(d, e0)
    t_min_v = _rays(t_min, n, dev)
    h_span = geom.h_hi - geom.h_lo
    levels0 = geom.minmax.levels[0]

    def process(state, cid, near, far):
        best_t = state[0]
        far = torch.minimum(far, best_t)
        sel = _select((cid >= 0) & (near < far))
        if sel.numel() == 0:
            return state
        m = sel.numel()
        b = cid[sel].to(torch.int64)
        pr = _Prism.of(geom, b)
        o_s = o[sel]
        # the exact test works in transformed texture space
        uv_t = tuple(_uv_transform(p, x) for x in pr.uv)
        bc2, bc1, bc0, d2c, d1c, d0c = compute_canonical_space_ray_coeffs(
            o_s, e0[sel], e1b[sel], *pr.p, *pr.n)
        tc2, tc1, tc0 = compute_texture_space_ray_coeffs(
            *uv_t, bc2, bc1, bc0, d2c, d1c, d0c)
        ray = dict(o=o_s, d=d[sel], p=pr.p, n=pr.n, uv=uv_t,
                   bc=(bc2, bc1, bc0), den=(d2c, d1c, d0c),
                   tc=(tc2, tc1, tc0), cid=cid[sel], near=near[sel],
                   far=far[sel], t_min=t_min_v[sel])
        cur = (best_t[sel], state[1][sel], state[2][sel], state[3][sel])
        steps = torch.zeros((m,), dtype=torch.int32, device=dev)

        if not ordered:
            for kk in range(n_h):
                kk_f = torch.full((m,), float(kk), device=dev)
                h0, h1, gx, gy = _seg_geom(ray, kk_f, geom.h_lo, h_span, n_h,
                                           s)
                occupied = _seg_occupied(levels0, p, h0, h1, gx, gy)
                steps = steps + occupied.to(torch.int32)
                cur = _run_segment(geom, ray, h0, h1, gx, gy, occupied, cur)
            return _scatter(state, sel, *cur, steps)

        # the cheap min/max gate of all n_h segments at once
        iota = torch.arange(n_h, device=dev)
        kk_all = iota.to(torch.float32)
        h0_all = geom.h_lo + h_span * (kk_all * _rcp(n_h))
        h1_all = geom.h_lo + h_span * ((kk_all + 1.0) * _rcp(n_h))
        hm_all = 0.5 * (h0_all + h1_all)
        hm2 = hm_all * hm_all
        den = d2c[:, None] * hm2[None] + d1c[:, None] * hm_all[None] \
            + d0c[:, None]
        den = torch.where(torch.abs(den) > 1e-12, den, 1.0)
        uvm = [(tc2[:, None, i] * hm2[None] + tc1[:, None, i] * hm_all[None]
                + tc0[:, None, i]) / den for i in (0, 1)]
        gx_all = torch.remainder(_int_sat(torch.floor(uvm[0] * s - 0.5)), s)
        gy_all = torch.remainder(_int_sat(torch.floor(uvm[1] * s - 0.5)), s)
        mm = levels0[gy_all, gx_all]  # [m, n_h, 2]
        dlo_a = _displace(p, mm[..., 0])
        dhi_a = _displace(p, mm[..., 1])
        tlo_a = torch.minimum(dlo_a, dhi_a) - 1e-4
        thi_a = torch.maximum(dlo_a, dhi_a) + 1e-4
        span_lo = torch.minimum(h0_all, h1_all)[None]
        span_hi = torch.maximum(h0_all, h1_all)[None]
        occ_mask = (span_lo <= thi_a) & (span_hi >= tlo_a)  # [m, n_h]

        cursor = torch.zeros((m,), dtype=torch.int64, device=dev)
        while True:
            cand = occ_mask & (iota[None] >= cursor[:, None])
            nxt = _first_true(cand, 1)
            live = _select(nxt < n_h)
            if live.numel() == 0:
                break
            trace.count("tfdm.exact_iterations")
            sub = {k: _rows(v, live) for k, v in ray.items()}
            kk = nxt[live]
            h0, h1, gx, gy = _seg_geom(sub, kk.to(torch.float32), geom.h_lo,
                                       h_span, n_h, s)
            occupied = torch.ones((live.numel(),), dtype=torch.bool,
                                  device=dev)
            new = _run_segment(geom, sub, h0, h1, gx, gy, occupied,
                               tuple(x[live] for x in cur))
            cur = tuple(x.index_put((live,), y) for x, y in zip(cur, new))
            steps = steps.index_add(0, live, torch.ones_like(kk, dtype=
                                                             torch.int32))
            cursor = cursor.index_put((live,), kk + 1)
        return _scatter(state, sel, *cur, steps)

    state = iterate_candidates(lo, hi, o, d, t_min, t_max, k_candidates,
                               _state0(n, t_max, dev), process,
                               lambda st: st[0], prism_bvh=geom.prism_bvh)
    return _hit(o, d, state)


def _rows(v, idx):
    """The rows idx of a per-ray tensor, or of each in a tuple."""
    if isinstance(v, tuple):
        return tuple(x[idx] for x in v)
    return v[idx]


def _rational(den, c2, c1, c0, h):
    d2c, d1c, d0c = den
    dd = d2c * h * h + d1c * h + d0c
    safe = torch.where(torch.abs(dd) > 1e-12, dd, 1.0)
    return (c2 * h * h + c1 * h + c0) / safe


def _uv_at(ray, h):
    tc2, tc1, tc0 = ray["tc"]
    return torch.stack([_rational(ray["den"], tc2[..., i], tc1[..., i],
                                  tc0[..., i], h) for i in (0, 1)], -1)


def _seg_geom(ray, kk_f, h_lo, h_span, n_h, s):
    """The height bounds and the midpoint texel of segment kk_f [m]."""
    h0 = h_lo + h_span * (kk_f * _rcp(n_h))
    h1 = h_lo + h_span * ((kk_f + 1.0) * _rcp(n_h))
    uvm = _uv_at(ray, 0.5 * (h0 + h1))
    gx = torch.remainder(_int_sat(torch.floor(uvm[:, 0] * s - 0.5)), s)
    gy = torch.remainder(_int_sat(torch.floor(uvm[:, 1] * s - 0.5)), s)
    return h0, h1, gx, gy


def _seg_occupied(levels0, p, h0, h1, gx, gy):
    """Whether the texel's displaced min/max overlaps the segment's span
    (level 0 bounds the bilinear patch, which holds the two-triangle
    surface)."""
    mm = levels0[gy, gx]
    dlo = _displace(p, mm[..., 0])
    dhi = _displace(p, mm[..., 1])
    tlo = torch.minimum(dlo, dhi) - 1e-4
    thi = torch.maximum(dlo, dhi) + 1e-4
    return (torch.minimum(h0, h1) <= thi) & (torch.maximum(h0, h1) >= tlo)


def _run_segment(geom, ray, h0, h1, gx, gy, occupied, cur):
    """The exact two-triangle solve of one segment a ray: the texel's four
    displaced corners (texel (gx, gy) spans samples [gx, gx+1] x
    [gy, gy+1]), both micro-triangles (split along the c00-c11 diagonal)
    solved together on a leading axis, then taken in turn: the second is
    held to the first one's hit."""
    s = geom.height.shape[0]
    p = geom.params
    hgt = geom.height
    u0 = (gx.to(torch.float32) + 0.5) * _rcp(s)
    v0 = (gy.to(torch.float32) + 0.5) * _rcp(s)
    du = 1.0 / s

    def dval(ix, iy):
        return _displace(p, hgt[torch.remainder(iy, s),
                                torch.remainder(ix, s)])

    c00 = torch.stack([u0, v0, dval(gx, gy)], -1)
    c10 = torch.stack([u0 + du, v0, dval(gx + 1, gy)], -1)
    c01 = torch.stack([u0, v0 + du, dval(gx, gy + 1)], -1)
    c11 = torch.stack([u0 + du, v0 + du, dval(gx + 1, gy + 1)], -1)
    pr = _Prism(geom, ray["p"], ray["n"], ray["uv"])
    bc2, bc1, bc0 = ray["bc"]
    o, d = ray["o"], ray["d"]
    hit, h_r, _, _ = nonlinear_ray_vs_micro_triangle(
        *ray["tc"], *ray["den"], torch.stack([c00, c00]),
        torch.stack([c10, c11]), torch.stack([c11, c01]), h0, h1)
    # the base barycentrics at the roots (rational quadratics)
    a_r = _rational(ray["den"], bc2[..., 0], bc1[..., 0], bc0[..., 0], h_r)
    b_r = _rational(ray["den"], bc2[..., 1], bc1[..., 1], bc0[..., 1], h_r)
    w_r = 1.0 - a_r - b_r
    inside = (a_r >= -1e-3) & (b_r >= -1e-3) & (w_r >= -1e-3)
    t_w = dot(shell_point(*pr.p, *pr.n, a_r, b_r, h_r) - o, d) / torch.clamp(
        dot(d, d), min=1e-20)
    uv_hit = _uv_at(ray, h_r)
    nrm = pr.normal(a_r, b_r)
    bt, bp, buv, bn = cur
    for k in range(2):
        ok = (occupied & hit[k] & inside[k] & (t_w[k] > ray["t_min"])
              & (t_w[k] >= ray["near"] - 1e-4)
              & (t_w[k] < torch.minimum(ray["far"], bt)))
        bt = torch.where(ok, t_w[k], bt)
        bp = torch.where(ok, ray["cid"], bp)
        buv = torch.where(ok[:, None], uv_hit[k], buv)
        bn = torch.where(ok[:, None], nrm[k], bn)
    return bt, bp, buv, bn
