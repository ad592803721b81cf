"""The reference's vector math, camera, ray offset and BSDFs: the published
formulas the port implements (Duff et al.'s branchless frame, Wächter and
Binder's integer ray offset, a Lambert BSDF and a diffuse + GGX specular
one with Heitz's visible-normal sampling and one-sample MIS between the
lobes), written once more in plain torch in any float dtype. Nothing here
is imported from the port."""

from __future__ import annotations

import math

import torch

PI = math.pi


def dot(a, b, keepdim=False):
    s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return s.unsqueeze(-1) if keepdim else s


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def length(v, keepdim=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim), min=0.0))


def normalize(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp(dot(v, v, True), min=eps))


def luminance(rgb):
    return (rgb[..., 0] * 0.2126729 + rgb[..., 1] * 0.7151522
            + rgb[..., 2] * 0.0721750)


def safe_divide(a, b):
    return torch.where(b != 0.0, a / torch.where(b == 0.0, 1.0, b), 0.0)


def make_frame(n):
    """(t, b) of the orthonormal frame (t, b, n)."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], -1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def to_local(t, b, n, v):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], -1)


def to_world(t, b, n, v):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def offset_ray_origin(p, n):
    """A secondary ray's origin: p moved off the surface along the
    geometric normal n by 256 float32 ulps a unit of n (by 2^-16 n near
    the origin). The step is defined on float32 positions, so it is taken
    on them and the result is handed back in the reference's dtype."""
    dt = p.dtype
    p32 = p.to(torch.float32)
    n32 = n.to(torch.float32)
    off = (n32 * 256.0)
    pi = p32.view(torch.int32)
    p_int = (pi + torch.where(p32 < 0.0, -off, off).to(torch.int32)).view(
        torch.float32)
    p_float = p + (1.0 / 65536.0) * n
    return torch.where(torch.abs(p) < 1.0 / 32.0, p_float, p_int.to(dt))


def camera_frame(position, target, dtype, device):
    """Camera-to-world columns (left, up, forward) of a camera at
    `position` looking at `target`, y up."""
    pos = torch.tensor(position, dtype=torch.float64)
    fwd = normalize(torch.tensor(target, dtype=torch.float64) - pos)
    right = normalize(cross(fwd, torch.tensor([0.0, 1.0, 0.0],
                                              dtype=torch.float64)))
    up = cross(right, fwd)
    m = torch.stack([-right, up, fwd], -1)
    return pos.to(dtype).to(device), m.to(dtype).to(device)


def primary_rays(cam, width, height, pixel, jx, jy):
    """Directions through pixels `pixel` (row-major ids) at jitter (jx,
    jy); the origin is the camera's."""
    pos, m, fov = cam["position"], cam["frame"], cam["fov_y"]
    px = (pixel % width).to(jx.dtype)
    py = (pixel // width).to(jx.dtype)
    x = (px + jx) / width
    y = (py + jy) / height
    vh = 2.0 * math.tan(fov * 0.5)
    vw = width / height * vh
    cx = vw * (0.5 - x)
    cy = vh * (0.5 - y)
    d = torch.stack([cx * m[i, 0] + cy * m[i, 1] + m[i, 2]
                     for i in range(3)], -1)
    return pos.expand(pixel.shape[0], 3), normalize(d)


def screen_position(cam, width, height, p):
    pos, m, fov = cam["position"], cam["frame"], cam["fov_y"]
    rel = p - pos
    local = [rel[..., 0] * m[0, j] + rel[..., 1] * m[1, j]
             + rel[..., 2] * m[2, j] for j in range(3)]
    z = torch.clamp(local[2], min=1e-8)
    vh = 2.0 * math.tan(fov * 0.5)
    vw = width / height * vh
    return torch.stack([0.5 - local[0] / (z * vw), 0.5 - local[1] / (z * vh)],
                       -1)


def concentric_disk(u0, u1):
    r0 = 2.0 * u0 - 1.0
    r1 = 2.0 * u1 - 1.0
    use_r0 = torch.abs(r0) > torch.abs(r1)
    r = torch.where(use_r0, r0, r1)
    safe = torch.where(r == 0.0, 1.0, r)
    theta = torch.where(use_r0, (PI / 4.0) * (r1 / safe),
                        (PI / 2.0) - (PI / 4.0) * (r0 / safe))
    theta = torch.where(r == 0.0, 0.0, theta)
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_hemisphere(u0, u1):
    x, y = concentric_disk(u0, u1)
    return torch.stack([x, y, torch.sqrt(torch.clamp(1.0 - x * x - y * y,
                                                     min=0.0))], -1)


# ---------------------------------------------------------------------------
# BSDFs: params = dict(diffuse [R, 3], f0 [R, 3], roughness [R] (at most
# 0.999), lambert [R] bool); directions in the shading frame
# ---------------------------------------------------------------------------


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _unit(v):
    return v / torch.clamp(length(v, True), min=1e-20)


def ggx_d(m, alpha):
    temp = m[..., 0] ** 2 + m[..., 1] ** 2 + (m[..., 2] * alpha) ** 2
    d = safe_divide(alpha * alpha, PI * temp * temp)
    return torch.where(m[..., 2] > 0.0, d, 0.0)


def ggx_g1(v, m, alpha):
    chi = dot(v, m) * v[..., 2] > 0.0
    temp = safe_divide(alpha * alpha * (v[..., 0] ** 2 + v[..., 1] ** 2),
                       v[..., 2] ** 2)
    return torch.where(chi, 2.0 / (1.0 + torch.sqrt(1.0 + temp)), 0.0)


def ggx_g2(v1, v2, m, alpha):
    def lam(v):
        a2t2 = safe_divide(alpha * alpha * (v[..., 0] ** 2 + v[..., 1] ** 2),
                           v[..., 2] ** 2)
        return 0.5 * (-1.0 + torch.sqrt(1.0 + a2t2))

    chi1 = safe_divide(dot(v1, m), v1[..., 2]) > 0.0
    chi2 = safe_divide(dot(v2, m), v2[..., 2]) > 0.0
    return torch.where(chi1 & chi2, 1.0 / (1.0 + lam(v1) + lam(v2)), 0.0)


def ggx_vndf(v, u0, u1, alpha):
    sv = torch.stack([alpha * v[..., 0], alpha * v[..., 1], v[..., 2]], -1)
    sv = sv / length(sv, True)
    dist2d = torch.sqrt(sv[..., 0] ** 2 + sv[..., 1] ** 2)
    rec = safe_divide(torch.ones_like(dist2d), dist2d)
    straight = sv[..., 2] >= 0.9999
    zero = torch.zeros_like(rec)
    t1 = torch.where(straight[..., None],
                     torch.stack([torch.ones_like(rec), zero, zero], -1),
                     torch.stack([sv[..., 1] * rec, -sv[..., 0] * rec, zero],
                                 -1))
    t2 = torch.stack([t1[..., 1] * sv[..., 2], -t1[..., 0] * sv[..., 2],
                      dist2d], -1)
    aa = 1.0 / (1.0 + sv[..., 2])
    r = torch.sqrt(torch.clamp(u0, min=0.0))
    lower = u1 < aa
    phi = PI * torch.where(lower, safe_divide(u1, aa),
                           1.0 + safe_divide(u1 - aa, 1.0 - aa))
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi) * torch.where(lower, torch.ones_like(r),
                                          sv[..., 2])
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    m = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * sv
    m = _unit(torch.stack([alpha * m[..., 0], alpha * m[..., 1], m[..., 2]],
                          -1))
    pdf = ggx_g1(v, m, alpha) * torch.abs(dot(v, m)) * ggx_d(m, alpha)
    return m, safe_divide(pdf, torch.abs(v[..., 2]))


def ggx_pdf(v, m, alpha):
    return safe_divide(ggx_g1(v, m, alpha) * torch.abs(dot(v, m))
                       * ggx_d(m, alpha), torch.abs(v[..., 2]))


def _lobe_weights(p, v):
    r = p["roughness"]
    vz = v[..., 2]
    omvz5 = _pow5(1.0 - torch.abs(vz))
    fd90 = 0.5 * r + 2.0 * r * vz * vz
    edf = 1.0 + (fd90 - 1.0) * omvz5
    dw = luminance(p["diffuse"]) * edf ** 2 * (1.0 + (1.0 / 1.51 - 1.0) * r)
    sw = luminance(p["f0"]) + (1.0 - luminance(p["f0"])) * omvz5
    return dw, sw


def _ds_eval(p, dv, dl, m):
    alpha = p["roughness"] ** 2
    dlh = torch.clamp(dot(dl, m), max=1.0)
    d = ggx_d(m, alpha)
    g = ggx_g2(dl, dv, m, alpha)
    f = p["f0"] + (1.0 - p["f0"]) * _pow5(1.0 - dlh)[..., None]
    spec = f * safe_divide(d * g, 4.0 * dl[..., 2] * dv[..., 2])[..., None]
    spec = torch.where((g > 0.0)[..., None], spec, 0.0)
    r = p["roughness"]
    fd90 = 0.5 * r + 2.0 * r * dlh * dlh
    f_out = 1.0 + (fd90 - 1.0) * _pow5(1.0 - dv[..., 2])
    f_in = 1.0 + (fd90 - 1.0) * _pow5(1.0 - dl[..., 2])
    diff = p["diffuse"] * (f_out * f_in * (1.0 + (1.0 / 1.51 - 1.0) * r)
                           / PI)[..., None]
    return diff + spec


def bsdf_eval(p, vg, vs):
    same = vg[..., 2] * vs[..., 2] > 0.0
    sign = torch.where(vg[..., 2] >= 0.0, 1.0, -1.0).to(vg.dtype)[..., None]
    dv, dl = vg * sign, vs * sign
    f = torch.where(p["lambert"][..., None], p["diffuse"] / PI,
                    _ds_eval(p, dv, dl, _unit(dl + dv)))
    return torch.where(same[..., None], f, 0.0)


def bsdf_pdf(p, vg, vs):
    same = vg[..., 2] * vs[..., 2] > 0.0
    sign = torch.where(vg[..., 2] >= 0.0, 1.0, -1.0).to(vg.dtype)[..., None]
    dv, dl = vg * sign, vs * sign
    m = _unit(dl + dv)
    alpha = p["roughness"] ** 2
    common = safe_divide(torch.ones_like(alpha), 4.0 * dot(dl, m))
    dpdf = dl[..., 2] / PI
    spdf = common * ggx_pdf(dv, m, alpha)
    dw, sw = _lobe_weights(p, dv)
    ds = safe_divide(dpdf * dw + spdf * sw, dw + sw)
    pdf = torch.where(p["lambert"], dpdf, ds)
    return torch.where(same, torch.clamp(pdf, min=0.0), 0.0)


def bsdf_sample(p, vg, u0, u1):
    """(direction, f, pdf): both lobes sampled, one picked."""
    sign = torch.where(vg[..., 2] >= 0.0, 1.0, -1.0).to(vg.dtype)[..., None]
    dv = vg * sign
    alpha = p["roughness"] ** 2
    lam = p["lambert"]
    dw, sw = _lobe_weights(p, dv)
    sum_w = dw + sw
    pick_spec = (u1 * sum_w >= dw) & ~lam
    u1d = torch.where(lam, u1, torch.clamp(safe_divide(u1 * sum_w, dw), 0.0,
                                           1.0 - 1e-7))
    u1s = torch.clamp(safe_divide(u1 * sum_w - dw, sw), 0.0, 1.0 - 1e-7)
    l_diff = cosine_hemisphere(u0, u1d)
    m_spec, m_pdf = ggx_vndf(dv, u0, u1s, alpha)
    dvh = torch.clamp(dot(dv, m_spec), max=1.0)
    l_spec = 2.0 * dvh[..., None] * m_spec - dv
    ps3 = pick_spec[..., None]
    dl = torch.where(ps3, l_spec, l_diff)
    spec_ok = torch.where(pick_spec, dl[..., 2] * dv[..., 2] > 0.0, True)
    m = torch.where(ps3, m_spec, _unit(l_diff + dv))
    dlh = torch.clamp(dot(dl, m), max=1.0)
    common = safe_divide(torch.ones_like(dlh), 4.0 * dlh)
    dpdf = dl[..., 2] / PI
    spdf = common * torch.where(pick_spec, m_pdf, ggx_pdf(dv, m, alpha))
    pdf = torch.where(lam, dpdf, safe_divide(dpdf * dw + spdf * sw, sum_w))
    pdf = torch.where(spec_ok & (sum_w > 0.0), pdf, 0.0)
    f = torch.where(lam[..., None], p["diffuse"] / PI, _ds_eval(p, dv, dl, m))
    f = torch.where((pdf > 0.0)[..., None], f, 0.0)
    return dl * sign, f, pdf


def dh_reflectance(p, vg):
    """The denoiser's albedo: the directional-hemispherical reflectance
    estimate."""
    vz = torch.abs(vg[..., 2])
    r = p["roughness"]
    fd90 = 0.5 * r + 2.0 * r * vz * vz
    omvz5 = _pow5(1.0 - vz)
    dif = p["diffuse"] * ((1.0 + (fd90 - 1.0) * omvz5)
                          * (1.0 + (1.0 / 1.51 - 1.0) * r))[..., None]
    spec = p["f0"] + (1.0 - p["f0"]) * (omvz5 * (1.0 - r))[..., None]
    return torch.where(p["lambert"][..., None], p["diffuse"],
                       torch.clamp(dif + spec, max=1.0))
