"""Swept-sphere curves (port of gfxexp_tpu/core/curves.py): the evaluators
of the reference's curve types (linear, quadratic and cubic B-spline,
Catmull-Rom, Bezier), the host tessellation into a triangle tube, and the
two direct intersectors the path tracer's displaced hooks run:

- `CurveSegments`: round-linear segments (cone-spheres, the hull of two
  end spheres), intersected exactly (`intersect_round_linear`);
- `CurveSpans`: power-basis spans of any type, intersected by multi-seeded
  damped Newton on the canal surface (`intersect_swept_sphere_span`).

Both stream each ray's candidate boxes nearest first through TFDM's
candidate iterator (techniques/tfdm.py `iterate_candidates`). The builds
are numpy on the host, as in the JAX package, and give the same arrays; the
queries are plain PyTorch on the device that holds the geometry. Integer
powers are written as products, as XLA rewrites them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gfxexp_torch.core.math import dot, length_rn, sqrt_rn
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.techniques.tfdm import _rays, iterate_candidates

CURVE_LINEAR = "linear"
CURVE_QUADRATIC_BSPLINE = "quadratic_bspline"
CURVE_CUBIC_BSPLINE = "cubic_bspline"
CURVE_CATMULL_ROM = "catmull_rom"
CURVE_BEZIER = "bezier"


def _basis(curve_type: str) -> np.ndarray:
    """The power-basis matrix B with p(t) = [1 t t^2 t^3] @ B @ P for the
    4-point types, or the 3- and 2-point equivalents."""
    if curve_type == CURVE_LINEAR:
        return np.array([[1.0, 0.0], [-1.0, 1.0]])
    if curve_type == CURVE_QUADRATIC_BSPLINE:
        return 0.5 * np.array([[1, 1, 0], [-2, 2, 0], [1, -2, 1]], np.float64)
    if curve_type == CURVE_CUBIC_BSPLINE:
        return (1.0 / 6.0) * np.array(
            [[1, 4, 1, 0], [-3, 0, 3, 0], [3, -6, 3, 0], [-1, 3, -3, 1]],
            np.float64)
    if curve_type == CURVE_CATMULL_ROM:
        return 0.5 * np.array(
            [[0, 2, 0, 0], [-1, 0, 1, 0], [2, -5, 4, -1], [-1, 3, -3, 1]],
            np.float64)
    if curve_type == CURVE_BEZIER:
        return np.array(
            [[1, 0, 0, 0], [-3, 3, 0, 0], [3, -6, 3, 0], [-1, 3, -3, 1]],
            np.float64)
    raise ValueError(curve_type)


def _span_stride(curve_type: str) -> int:
    """Control points between consecutive spans: B-splines and Catmull-Rom
    slide their window by one; Bezier spans own their points and share only
    the junction, so the window moves by the degree."""
    return (_basis(curve_type).shape[0] - 1
            if curve_type == CURVE_BEZIER else 1)


def _powers(t, k: int):
    """[1, t, t^2, t^3][:k] as products (XLA's integer powers)."""
    t2 = t * t
    return [torch.ones_like(t), t, t2, t * t2][:k]


def _weights(b: np.ndarray, pw):
    """coeff[k] = sum_j pw[j] * b[j, k], in j order."""
    k = b.shape[0]
    out = []
    for c in range(k):
        acc = pw[0] * float(b[0, c])
        for j in range(1, k):
            acc = acc + pw[j] * float(b[j, c])
        out.append(acc)
    return out


def evaluate(curve_type: str, control_points, t, radii=None):
    """Position (and radius) at parameter t: control_points [..., K, 3]
    with K = 2 (linear), 3 (quadratic) or 4; t [...]; radii optional
    [..., K]. Returns (position [..., 3], radius [...] or None)."""
    b = _basis(curve_type).astype(np.float32)
    coeff = _weights(b, _powers(t, b.shape[0]))
    pos = coeff[0][..., None] * control_points[..., 0, :]
    for k in range(1, len(coeff)):
        pos = pos + coeff[k][..., None] * control_points[..., k, :]
    rad = None
    if radii is not None:
        rad = coeff[0] * radii[..., 0]
        for k in range(1, len(coeff)):
            rad = rad + coeff[k] * radii[..., k]
    return pos, rad


def evaluate_derivative(curve_type: str, control_points, t):
    """dP/dt at parameter t: the curve's (unnormalised) tangent."""
    b = _basis(curve_type).astype(np.float32)
    k = b.shape[0]
    pw = _powers(t, k)
    dpow = [torch.zeros_like(t)] + [i * pw[i - 1] for i in range(1, k)]
    coeff = _weights(b, dpow)
    out = coeff[0][..., None] * control_points[..., 0, :]
    for j in range(1, k):
        out = out + coeff[j][..., None] * control_points[..., j, :]
    return out


def surface_normal(curve_type: str, control_points, t, hit_point,
                   radii=None):
    """The swept-sphere surface normal at a hit point: the part of (hit -
    axis point) orthogonal to the tangent."""
    pos, _ = evaluate(curve_type, control_points, t, radii)
    tang = evaluate_derivative(curve_type, control_points, t)
    tang = tang / torch.clamp(length_rn(tang, keepdim=True), min=1e-20)
    rel = hit_point - pos
    n = rel - dot(rel, tang, keepdim=True) * tang
    return n / torch.clamp(length_rn(n, keepdim=True), min=1e-20)


def _evaluate_np(curve_type: str, cp: np.ndarray, t: np.ndarray, rr=None):
    """evaluate() in float32 numpy on the host: cp [K, 3], t [T]."""
    b = _basis(curve_type).astype(np.float32)
    k = b.shape[0]
    t = np.asarray(t, np.float32)
    t2 = t * t
    pw = [np.ones_like(t), t, t2, t * t2][:k]
    coeff = []
    for c in range(k):
        acc = pw[0] * b[0, c]
        for j in range(1, k):
            acc = acc + pw[j] * b[j, c]
        coeff.append(acc)
    pos = sum(coeff[i][:, None] * cp[i][None] for i in range(k))
    rad = None if rr is None else sum(coeff[i] * rr[i] for i in range(k))
    dpow = [np.zeros_like(t)] + [np.float32(i) * pw[i - 1]
                                 for i in range(1, k)]
    dco = []
    for c in range(k):
        acc = dpow[0] * b[0, c]
        for j in range(1, k):
            acc = acc + dpow[j] * b[j, c]
        dco.append(acc)
    tang = sum(dco[i][:, None] * cp[i][None] for i in range(k))
    return pos, rad, tang


def tessellate_curve(curve_type: str, control_points: np.ndarray,
                     radii: np.ndarray, n_axial: int = 8, n_radial: int = 8):
    """Host tessellation of one curve segment into a triangle tube (the
    path of add_curve(direct=False)): (positions [V, 3], normals [V, 3],
    indices [F, 3]) in numpy."""
    cp = np.asarray(control_points, np.float32)
    rr = np.asarray(radii, np.float32)
    ts = np.linspace(0.0, 1.0, n_axial + 1).astype(np.float32)
    pos_all, rad_all, tang_all = _evaluate_np(curve_type, cp, ts, rr)
    verts, norms = [], []
    for i in range(len(ts)):
        pos = pos_all[i]
        r = float(rad_all[i])
        tg = tang_all[i]
        tn = tg / max(np.linalg.norm(tg), 1e-20)
        # a stable frame about the tangent
        up = (np.array([0.0, 1.0, 0.0]) if abs(tn[1]) < 0.9
              else np.array([1.0, 0.0, 0.0]))
        b1 = np.cross(tn, up)
        b1 /= max(np.linalg.norm(b1), 1e-20)
        b2 = np.cross(tn, b1)
        for a in range(n_radial):
            ang = 2 * np.pi * a / n_radial
            nrm = np.cos(ang) * b1 + np.sin(ang) * b2
            verts.append(pos + r * nrm)
            norms.append(nrm)
    idx = []
    for i in range(n_axial):
        for a in range(n_radial):
            v00 = i * n_radial + a
            v01 = i * n_radial + (a + 1) % n_radial
            v10 = (i + 1) * n_radial + a
            v11 = (i + 1) * n_radial + (a + 1) % n_radial
            idx.append([v00, v10, v01])
            idx.append([v01, v10, v11])
    return (np.asarray(verts, np.float32), np.asarray(norms, np.float32),
            np.asarray(idx, np.int32))


# ---------------------------------------------------------------------------
# round-linear segments (cone-spheres)
# ---------------------------------------------------------------------------


def intersect_round_linear(p0, r0, p1, r1, o, d, t_min=1e-4, t_max=1e30):
    """Exact closest hit of rays o, d [R, 3] against round linear segments
    (the hull of the spheres (p0, r0) and (p1, r1); endpoints [3] or
    [R, 3]): (hit, t, normal [R, 3], s in [0, 1] along the segment). The
    lateral surface solves the quadratic of the offset cone; the caps are
    sphere hits clipped to their cap regions."""
    axis = p1 - p0
    ll = torch.clamp(dot(axis, axis), min=1e-20)
    l = sqrt_rn(ll)
    az = axis / l[..., None] if axis.ndim > 1 else axis / l
    dr = (r1 - r0) / l  # the radius' slope along the axis

    oc = o - p0
    od_a = dot(d, az)
    oc_a = dot(oc, az)
    # lateral surface: |x_perp(t)| = r0 + dr * x_axial(t), squared, as the
    # quadratic A t^2 + B t + C = 0
    dd = dot(d, d)
    ocd = dot(oc, d)
    occ = dot(oc, oc)
    k = 1.0 + dr * dr
    A = dd - k * od_a * od_a
    B = 2.0 * (ocd - k * oc_a * od_a - r0 * dr * od_a)
    C = occ - k * oc_a * oc_a - 2.0 * r0 * dr * oc_a - r0 * r0
    disc = B * B - 4.0 * A * C
    safe_a = torch.where(torch.abs(A) > 1e-12, A, 1.0)
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    t_lat = torch.where(A > 0, (-B - sq) / (2 * safe_a),
                        (-B + sq) / (2 * safe_a))
    x_a = oc_a + t_lat * od_a  # the lateral hit's axial coordinate
    # the lateral surface lies between the caps' tangent points
    lo_a = -r0 * dr
    hi_a = l - r1 * dr
    lat_ok = ((disc >= 0.0) & (torch.abs(A) > 1e-12)
              & (t_lat > t_min) & (t_lat < t_max)
              & (x_a >= lo_a) & (x_a <= hi_a))

    def sphere_hit(center, radius):
        co = o - center
        b = dot(co, d)
        c = dot(co, co) - radius * radius
        disc_s = b * b - dd * c
        sqs = sqrt_rn(torch.clamp(disc_s, min=0.0))
        ts = (-b - sqs) / torch.clamp(dd, min=1e-20)
        return (disc_s >= 0.0) & (ts > t_min) & (ts < t_max), ts

    ok0, t0 = sphere_hit(p0, r0)
    x0_a = oc_a + t0 * od_a
    ok0 = ok0 & (x0_a < lo_a)
    ok1, t1 = sphere_hit(p1, r1)
    x1_a = oc_a + t1 * od_a
    ok1 = ok1 & (x1_a > hi_a)

    t_best = torch.where(lat_ok, t_lat, torch.inf)
    take0 = ok0 & (t0 < t_best)
    t_best = torch.where(take0, t0, t_best)
    take1 = ok1 & (t1 < t_best)
    t_best = torch.where(take1, t1, t_best)
    hit = torch.isfinite(t_best)

    x = o + t_best[..., None] * d
    xa = dot(x - p0, az)
    s = torch.clamp(xa / l, 0.0, 1.0)
    # lateral normal: x - (p0 + (xa + dr (r0 + dr xa)) az)
    closest = p0 + (xa + dr * (r0 + dr * xa))[..., None] * az
    n = x - closest
    # the caps are spheres: normal (x - centre) / r
    n = torch.where(take1[..., None], x - p1, n)
    n = torch.where(take0[..., None], x - p0, n)
    n = n / torch.clamp(length_rn(n, keepdim=True), min=1e-20)
    t_out = torch.where(hit, t_best, t_max)
    return hit, t_out, n, s


@dataclass
class CurveSegments(TensorData):
    """A soup of round-linear segments (cone-spheres)."""

    p0: torch.Tensor  # [C, 3]
    p1: torch.Tensor  # [C, 3]
    r0: torch.Tensor  # [C]
    r1: torch.Tensor  # [C]
    material: int = 0


@dataclass
class CurveHit(TensorData):
    t: torch.Tensor  # [R]
    hit: torch.Tensor
    position: torch.Tensor  # [R, 3]
    normal: torch.Tensor
    uv: torch.Tensor  # [R, 2]: (s along the segment or span, 0.5)
    prim: torch.Tensor  # [R] segment or span index (-1 on a miss)


def _t32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def build_curve_segments(control_points, radii, material: int = 0,
                         curve_type: str = CURVE_LINEAR,
                         n_subdiv: int = 8) -> CurveSegments:
    """Host build: a linear curve is one segment a control-point pair; the
    other types are evaluated at n_subdiv + 1 parameters a span and chained
    into a round-linear polyline."""
    cp = np.asarray(control_points, np.float32)
    rr = np.asarray(radii, np.float32)
    if curve_type == CURVE_LINEAR:
        a, b = cp[:-1], cp[1:]
        ra, rb = rr[:-1], rr[1:]
    else:
        k = _basis(curve_type).shape[0]
        stride = _span_stride(curve_type)
        n_spans = (cp.shape[0] - k) // stride + 1
        if n_spans < 1 or (cp.shape[0] - k) % stride:
            raise ValueError(
                f"{curve_type}: {cp.shape[0]} control points do not make "
                f"whole spans (need k={k} + m*{stride})")
        pts, rads = [], []
        for s in range(n_spans):
            c0 = s * stride
            ts = np.linspace(0.0, 1.0, n_subdiv + 1)
            if s > 0:
                ts = ts[1:]  # the span boundary is the previous span's end
            pos, rad, _ = _evaluate_np(curve_type, cp[c0:c0 + k], ts,
                                       rr[c0:c0 + k])
            pts.append(pos)
            rads.append(rad)
        poly = np.concatenate(pts)
        prad = np.concatenate(rads)
        a, b = poly[:-1], poly[1:]
        ra, rb = prad[:-1], prad[1:]
    return CurveSegments(p0=_t32(a), p1=_t32(b), r0=_t32(ra), r1=_t32(rb),
                         material=int(material))


def _curve_state0(n, t_max, dev):
    return (_rays(t_max, n, dev).clone(),
            torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros((n, 3), device=dev),  # normal
            torch.zeros((n,), device=dev))  # s or u


def _curve_hit(o, d, state) -> CurveHit:
    best_t, best_prim, best_n, best_s = state
    return CurveHit(t=best_t, hit=best_prim >= 0,
                    position=o + best_t[:, None] * d, normal=best_n,
                    uv=torch.stack([best_s, torch.full_like(best_s, 0.5)],
                                   -1),
                    prim=best_prim)


def intersect_curve_segments(geom: CurveSegments, o, d, t_min=1e-4,
                             t_max=1e30, k_candidates: int = 4) -> CurveHit:
    """Closest hit against every segment; the candidates stream nearest
    first by segment-box entry until none lies nearer than the best hit
    (techniques/tfdm.py iterate_candidates)."""
    n = o.shape[0]
    dev = o.device
    r0b = geom.r0[:, None]
    r1b = geom.r1[:, None]
    lo = torch.minimum(geom.p0 - r0b, geom.p1 - r1b) - 1e-6
    hi = torch.maximum(geom.p0 + r0b, geom.p1 + r1b) + 1e-6
    t_min_v = _rays(t_min, n, dev)

    def process(state, cid, near, far):
        best_t, best_prim, best_n, best_s = state
        b = torch.clamp(cid, min=0).to(torch.int64)
        hit, t, nrm, s = intersect_round_linear(
            geom.p0[b], geom.r0[b], geom.p1[b], geom.r1[b], o, d,
            t_min=t_min_v, t_max=best_t)
        take = (cid >= 0) & hit & (t < best_t)
        return (torch.where(take, t, best_t),
                torch.where(take, cid, best_prim),
                torch.where(take[:, None], nrm, best_n),
                torch.where(take, s, best_s))

    state = iterate_candidates(lo, hi, o, d, t_min, t_max, k_candidates,
                               _curve_state0(n, t_max, dev), process,
                               lambda st: st[0])
    return _curve_hit(o, d, state)


# ---------------------------------------------------------------------------
# higher-order spans, intersected exactly: 2D Newton on
# F1(t, u) = |o + t d - P(u)|^2 - r(u)^2 and the envelope condition
# F2(t, u) = (o + t d - P(u)).P'(u) + r(u) r'(u), seeded along u
# ---------------------------------------------------------------------------


@dataclass
class CurveSpans(TensorData):
    """Power-basis spans: P(u) = sum_j coef[s, j] u^j and r(u) = sum_j
    rcoef[s, j] u^j on u in [0, 1] (quadratic types pad the cubic term with
    0), with conservative boxes."""

    coef: torch.Tensor  # [S, 4, 3]
    rcoef: torch.Tensor  # [S, 4]
    lo: torch.Tensor  # [S, 3]
    hi: torch.Tensor  # [S, 3]
    material: int = 0


def build_curve_spans(control_points, radii, material: int = 0,
                      curve_type: str = CURVE_CUBIC_BSPLINE) -> CurveSpans:
    """Host build (float64 numpy): the spans of the control polygon in the
    power basis; each box is the sampled bound widened by the exact sag
    bound of the second derivative (|P''| <= |2 c2| + 6 |c3| on [0, 1]),
    so it holds the swept sphere."""
    cp = np.asarray(control_points, np.float64)
    rr = np.asarray(radii, np.float64)
    B = _basis(curve_type)
    k = B.shape[0]
    stride = _span_stride(curve_type)
    n_spans = (cp.shape[0] - k) // stride + 1
    if n_spans < 1 or (cp.shape[0] - k) % stride:
        raise ValueError(
            f"{curve_type}: {cp.shape[0]} control points do not make whole "
            f"spans (need k={k} + m*{stride})")
    coef = np.zeros((n_spans, 4, 3), np.float64)
    rcoef = np.zeros((n_spans, 4), np.float64)
    for s in range(n_spans):
        c0 = s * stride
        coef[s, :k] = B @ cp[c0:c0 + k]
        rcoef[s, :k] = B @ rr[c0:c0 + k]
    m = 16
    u = np.linspace(0.0, 1.0, m + 1)
    pw = np.stack([u ** j for j in range(4)], axis=-1)  # [m+1, 4]
    pos = np.einsum("uj,sjd->sud", pw, coef)  # [S, m+1, 3]
    rad = np.einsum("uj,sj->su", pw, rcoef)  # [S, m+1]
    sag = (np.abs(2.0 * coef[:, 2]) + 6.0 * np.abs(coef[:, 3])) / (8 * m * m)
    rsag = (np.abs(2.0 * rcoef[:, 2]) + 6.0 * np.abs(rcoef[:, 3])) / (
        8 * m * m)
    pad = sag + (np.max(rad, axis=1) + rsag)[:, None] + 1e-6
    lo = pos.min(axis=1) - pad
    hi = pos.max(axis=1) + pad
    return CurveSpans(coef=_t32(coef), rcoef=_t32(rcoef), lo=_t32(lo),
                      hi=_t32(hi), material=int(material))


def _span_eval(coef, rcoef, u):
    """P, P', P'', r, r', r'' at u: coef [..., 4, 3], rcoef [..., 4],
    u [...]."""
    uu = u[..., None]
    c0, c1, c2, c3 = (coef[..., j, :] for j in range(4))
    p = c0 + uu * (c1 + uu * (c2 + uu * c3))
    dp = c1 + uu * (2.0 * c2 + 3.0 * uu * c3)
    ddp = 2.0 * c2 + 6.0 * uu * c3
    r0, r1, r2, r3 = (rcoef[..., j] for j in range(4))
    r = r0 + u * (r1 + u * (r2 + u * r3))
    dr = r1 + u * (2.0 * r2 + 3.0 * u * r3)
    ddr = 2.0 * r2 + 6.0 * u * r3
    return p, dp, ddp, r, dr, ddr


def intersect_swept_sphere_span(coef, rcoef, o, d, t_min, t_max,
                                n_seeds: int = 8, n_newton: int = 12):
    """Exact closest hit of rays o, d [R, 3] against one swept-sphere span
    a ray (coef [R, 4, 3], rcoef [R, 4]): (hit, t, normal, u). n_seeds
    damped Newton solves of n_newton steps each, unrolled; the end spheres
    at u = 0 and 1 close the caps."""
    eps = 1e-5
    n = o.shape[0]
    dev = o.device
    d2 = dot(d, d)
    best_t = _rays(t_max, n, dev)
    best_u = torch.zeros_like(best_t)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)

    for i in range(n_seeds):
        u = torch.full((n,), (i + 0.5) / n_seeds, device=dev)
        p, dp, _, r, _, _ = _span_eval(coef, rcoef, u)
        # t starts at the entry of the local sphere (the projection of the
        # axis point makes the Jacobian singular for rays across the axis)
        t = (dot(p - o, d) - r * sqrt_rn(d2)) / torch.clamp(d2, min=1e-20)
        for _ in range(n_newton):
            p, dp, ddp, r, dr, ddr = _span_eval(coef, rcoef, u)
            q = o + t[:, None] * d - p
            f1 = dot(q, q) - r * r
            f2 = dot(q, dp) + r * dr
            a11 = 2.0 * dot(q, d)
            a12 = -2.0 * f2
            a21 = dot(d, dp)
            a22 = -dot(dp, dp) + dot(q, ddp) + dr * dr + r * ddr
            det = a11 * a22 - a12 * a21
            safe = torch.where(torch.abs(det) < 1e-12,
                               torch.where(det < 0, -1e-12, 1e-12), det)
            dt = (f1 * a22 - f2 * a12) / safe
            du = (a11 * f2 - a21 * f1) / safe
            du = torch.clamp(du, -0.25, 0.25)  # keep seeds in their basin
            t = t - dt
            u = torch.clamp(u - du, -0.05, 1.05)
        p, dp, _, r, dr, _ = _span_eval(coef, rcoef, u)
        q = o + t[:, None] * d - p
        f1 = dot(q, q) - r * r
        f2 = dot(q, dp) + r * dr
        scale = torch.clamp(r * r, min=1e-12)
        dscale = torch.clamp(sqrt_rn(dot(dp, dp))
                             * torch.clamp(r, min=1e-6), min=1e-12)
        ok = ((torch.abs(f1) < 1e-3 * scale) & (torch.abs(f2) < 1e-3 * dscale)
              & (u > -eps) & (u < 1.0 + eps) & (t > t_min) & (t < best_t))
        best_t = torch.where(ok, t, best_t)
        best_u = torch.where(ok, u, best_u)
        found = found | ok

    # the end spheres (u = 0 and u = 1)
    for ue in (0.0, 1.0):
        u = torch.full((n,), ue, device=dev)
        p, _, _, r, _, _ = _span_eval(coef, rcoef, u)
        oc = o - p
        b = dot(oc, d)
        c = dot(oc, oc) - r * r
        disc = b * b - d2 * c
        sq = sqrt_rn(torch.clamp(disc, min=0.0))
        t0 = (-b - sq) / torch.clamp(d2, min=1e-20)
        t1 = (-b + sq) / torch.clamp(d2, min=1e-20)
        for tc in (t0, t1):
            ok = (disc >= 0) & (tc > t_min) & (tc < best_t)
            best_t = torch.where(ok, tc, best_t)
            best_u = torch.where(ok, u, best_u)
            found = found | ok

    # normal (x - P(u)) / r(u): exact at envelope and cap points alike
    p, _, _, r, _, _ = _span_eval(coef, rcoef, best_u)
    x = o + best_t[:, None] * d
    nrm = (x - p) / torch.clamp(r, min=1e-12)[:, None]
    nrm = nrm / torch.clamp(length_rn(nrm, keepdim=True), min=1e-12)
    return found, best_t, nrm, torch.clamp(best_u, 0.0, 1.0)


def intersect_curve_spans(geom: CurveSpans, o, d, t_min=1e-4, t_max=1e30,
                          k_candidates: int = 4) -> CurveHit:
    """Closest hit against every span, streamed nearest first by span-box
    entry (the candidate loop of intersect_curve_segments)."""
    n = o.shape[0]
    dev = o.device
    t_min_v = _rays(t_min, n, dev)

    def process(state, cid, near, far):
        best_t, best_prim, best_n, best_u = state
        b = torch.clamp(cid, min=0).to(torch.int64)
        hit, t, nrm, u = intersect_swept_sphere_span(
            geom.coef[b], geom.rcoef[b], o, d, t_min=t_min_v, t_max=best_t)
        take = (cid >= 0) & hit & (t < best_t)
        return (torch.where(take, t, best_t),
                torch.where(take, cid, best_prim),
                torch.where(take[:, None], nrm, best_n),
                torch.where(take, u, best_u))

    state = iterate_candidates(geom.lo, geom.hi, o, d, t_min, t_max,
                               k_candidates, _curve_state0(n, t_max, dev),
                               process, lambda st: st[0])
    return _curve_hit(o, d, state)
