"""The reference SVGF frame (Schied et al. 2017, as the port configures
it): albedo demodulation; temporal accumulation through a 4-tap
reprojection with unit, material, normal (0.85) and position (0.1) tests,
a cumulative mean for 5 frames then an EMA of 1/5; the variance from the
luminance moments, a 7x7 depth- and normal-weighted estimate while a
pixel's history is under 4 frames; 5 a-trous stages of a 3x3 box kernel at
steps 1, 2, 4, 8, 16 with depth (sigma 1), normal (128) and luminance (4)
edge-stopping weights over a 3x3 Gaussian of the variance; remodulation
(misses keep the raw lighting); and TAA over 8 frames, clamped to the
3x3 neighbourhood. Whole images, in the dtype of its inputs."""

from __future__ import annotations

import torch

from reference.shading import dot, luminance

_EPS = 1e-6
_SPATIAL = [0.00598, 0.060626, 0.241843, 0.383103, 0.241843, 0.060626,
            0.00598]


def _shift(img, dy, dx, fill=0.0):
    h, w = img.shape[:2]
    out = torch.full(img.shape, fill, dtype=img.dtype, device=img.device)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
        img[max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0)]
    return out


def _grid(h, w, dev):
    return torch.meshgrid(torch.arange(h, device=dev),
                          torch.arange(w, device=dev), indexing="ij")


def _reproject(st, gb, dt):
    h, w = gb["depth"].shape
    yy, xx = _grid(h, w, gb["depth"].device)
    prev_x = xx.to(dt) + 0.5 - gb["motion"][..., 0]
    prev_y = yy.to(dt) + 0.5 - gb["motion"][..., 1]
    on = (prev_x >= 0) & (prev_y >= 0) & (prev_x < w) & (prev_y < h)
    bx = torch.clamp(prev_x.to(torch.int64), 0, w - 1)
    by = torch.clamp(prev_y.to(torch.int64), 0, h - 1)
    fdx = prev_x - (bx.to(dt) + 0.5)
    fdy = prev_y - (by.to(dt) + 0.5)
    nx = torch.clamp(bx + torch.where(fdx < 0, -1, 1), 0, w - 1)
    ny = torch.clamp(by + torch.where(fdy < 0, -1, 1), 0, h - 1)
    s, t = torch.abs(fdx), torch.abs(fdy)
    sum_w = torch.zeros_like(s)
    acc_n = torch.zeros_like(st["prev_noisy"])
    acc_m = torch.zeros_like(st["moments"])
    acc_c = torch.zeros_like(s)
    for ty, tx, tw in ((by, bx, (1 - s) * (1 - t)), (by, nx, s * (1 - t)),
                       (ny, bx, (1 - s) * t), (ny, nx, s * t)):
        dp = st["prev_position"][ty, tx] - gb["position"]
        ok = (on & (st["prev_unit"][ty, tx] == gb["unit"])
              & (st["prev_material"][ty, tx] == gb["material"])
              & (dot(st["prev_normal"][ty, tx], gb["normal"]) > 0.85)
              & (dot(dp, dp) <= 0.1))
        wgt = torch.where(ok, tw, 0.0)
        sum_w = sum_w + wgt
        acc_n = acc_n + wgt[..., None] * st["prev_noisy"][ty, tx]
        acc_m = acc_m + wgt[..., None] * st["moments"][ty, tx]
        acc_c = acc_c + wgt * st["sample_count"][ty, tx]
    valid = sum_w > 0
    inv = torch.where(valid, 1.0 / torch.where(valid, sum_w, 1.0), 0.0)
    return (acc_n * inv[..., None], acc_m * inv[..., None],
            torch.round(acc_c * inv), valid)


def _gradients(depth):
    h, w = depth.shape
    dev = depth.device
    sx = torch.where(torch.arange(w, device=dev)[None, :] < w // 2, 1, -1)
    sy = torch.where(torch.arange(h, device=dev)[:, None] < h // 2, 1, -1)
    inf = float("inf")
    hnb = torch.where(sx > 0, _shift(depth, 0, 1, inf),
                      _shift(depth, 0, -1, inf))
    vnb = torch.where(sy > 0, _shift(depth, 1, 0, inf),
                      _shift(depth, -1, 0, inf))
    dzdx = (hnb - depth) * sx
    dzdy = (vnb - depth) * sy
    fin = torch.isfinite(dzdx) & torch.isfinite(dzdy)
    return torch.where(fin, dzdx, 0.0), torch.where(fin, dzdy, 0.0)


def _w_depth(nb, z, dzdx, dzdy, dx, dy):
    return torch.exp(-torch.abs(nb - z)
                     / (1.0 * torch.abs(dzdx * dx + dzdy * dy) + _EPS))


def _w_normal(nb, n):
    return torch.clamp(dot(nb, n), min=0.0) ** 128.0


def _variance(mom, count, depth, normal, hit):
    first, second = mom[..., 0], mom[..., 1]
    inf = float("inf")
    dzdx, dzdy = _gradients(torch.where(hit, depth, inf))
    cw = _SPATIAL[3] ** 2
    sf, ss = cw * first, cw * second
    sw = torch.full_like(first, cw)
    for i in range(-3, 4):
        for j in range(-3, 4):
            if i == 0 and j == 0:
                continue
            wz = _w_depth(_shift(depth, i, j, inf), depth, dzdx, dzdy, j, i)
            wn = _w_normal(_shift(normal, i, j), normal)
            wgt = torch.where(_shift(hit, i, j, False),
                              _SPATIAL[i + 3] * _SPATIAL[j + 3] * wz * wn,
                              0.0)
            sf = sf + wgt * _shift(first, i, j)
            ss = ss + wgt * _shift(second, i, j)
            sw = sw + wgt
    spatial = count < 4.0
    f = torch.where(spatial, sf / sw, first)
    s = torch.where(spatial, ss / sw, second)
    return torch.clamp(s - f * f, min=0.0)


def _atrous(color, var, depth, normal, hit, step):
    dzdx, dzdy = _gradients(torch.where(hit, depth, float("inf")))
    lum = luminance(color)
    g = [0.25, 0.5, 0.25]
    v_acc = torch.zeros_like(var)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            v_acc = v_acc + g[i + 1] * g[j + 1] * _shift(var, i, j)
    std = torch.sqrt(torch.clamp(v_acc / 1.0, min=0.0))
    sum_w = torch.ones_like(lum)
    acc_c = 1.0 * color
    acc_v = 1.0 * var
    inf = float("inf")
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            if i == 0 and j == 0:
                continue
            dy, dx = i * step, j * step
            nbc = _shift(color, dy, dx)
            wz = _w_depth(_shift(depth, dy, dx, inf), depth, dzdx, dzdy, dx,
                          dy)
            wn = _w_normal(_shift(normal, dy, dx), normal)
            wl = torch.exp(-torch.abs(luminance(nbc) - lum)
                           / (4.0 * std + _EPS))
            wgt = torch.where(_shift(hit, dy, dx, False), wz * wn * wl, 0.0)
            acc_c = acc_c + wgt[..., None] * nbc
            acc_v = acc_v + wgt * wgt * _shift(var, dy, dx)
            sum_w = sum_w + wgt
    return acc_c / sum_w[..., None], acc_v / (sum_w * sum_w)


def _taa(color, hist, motion, first, dt):
    h, w = color.shape[:2]
    yy, xx = _grid(h, w, color.device)
    px = xx.to(dt) + 0.5 - motion[..., 0]
    py = yy.to(dt) + 0.5 - motion[..., 1]
    on = (px >= 0) & (py >= 0) & (px < w) & (py < h)
    x0 = torch.clamp(torch.floor(px - 0.5).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(py - 0.5).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(px - 0.5 - x0.to(dt), 0.0, 1.0)
    fy = torch.clamp(py - 0.5 - y0.to(dt), 0.0, 1.0)
    hv = (hist[y0, x0] * ((1 - fx) * (1 - fy))[..., None]
          + hist[y0, x1] * (fx * (1 - fy))[..., None]
          + hist[y1, x0] * ((1 - fx) * fy)[..., None]
          + hist[y1, x1] * (fx * fy)[..., None])
    lo, hi = color, color
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            nb = _shift(color, i, j)
            lo = torch.minimum(lo, nb)
            hi = torch.maximum(hi, nb)
    hv = torch.minimum(torch.maximum(hv, lo), hi)
    blend = torch.where((on & ~first)[..., None], 1.0 - 1.0 / 8, 0.0).to(dt)
    return color * (1.0 - blend) + hv * blend


def svgf_frame(state, gb, lighting, stages=5):
    """(the filtered frame [H, W, 3], the history handed to the next frame:
    prev_noisy, moments, sample_count). state: the program's history as a
    dict (prev_noisy, moments, sample_count, prev_position, prev_normal,
    prev_unit, prev_material, taa_history, first_frame); gb: the frame's
    G-buffer planes; all floats in the reference's dtype."""
    dt = lighting.dtype
    hit = gb["hit"]
    alb = torch.where(gb["albedo"] < 0.001, 0.0, gb["albedo"])
    nz = torch.abs(alb) > 0
    dem = lighting / torch.where(nz, alb, 1.0) * nz
    lum = luminance(dem)
    mom_cur = torch.stack([lum, lum * lum], -1)
    p_noisy, p_mom, p_cnt, valid = _reproject(state, gb, dt)
    reset = state["first_frame"] | ~valid
    p_cnt = torch.where(reset, 0.0, p_cnt)
    count = torch.clamp(p_cnt + 1.0, max=65535.0)
    cur_w = torch.where(count < 5.0, 1.0 / count, 1.0 / 5.0)
    cur_w = torch.where(count <= 1.0, 1.0, cur_w)
    noisy = (1.0 - cur_w)[..., None] * p_noisy + cur_w[..., None] * dem
    mom = (1.0 - cur_w)[..., None] * p_mom + cur_w[..., None] * mom_cur
    var = _variance(mom, count, gb["depth"], gb["normal"], hit)
    color = noisy
    for step in (1, 2, 4, 8, 16)[:stages]:
        color, var = _atrous(color, var, gb["depth"], gb["normal"], hit,
                             step)
    final = torch.where(hit[..., None], color * gb["albedo"], lighting)
    final = _taa(final, state["taa_history"], gb["motion"],
                 state["first_frame"], dt)
    return final, {"prev_noisy": torch.where(hit[..., None], noisy, 0.0),
                   "moments": mom,
                   "sample_count": torch.where(hit, count, 0.0)}
