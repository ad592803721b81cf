"""SVGF: spatiotemporal variance-guided filtering, with TAA (port of
gfxexp_tpu/techniques/svgf.py).

Every pass is an [H, W] image-space stencil over the G-buffer's planes:
albedo demodulation, temporal accumulation through a 4-tap reprojection
with geometry validity tests, variance from the luminance moments (a 7x7
bilateral spatial estimate while a pixel's history is short), a pyramid of
à-trous stages (step widths 1, 2, 4, 8, 16) with depth, normal and
luminance edge-stopping weights, remodulation and a neighbourhood-clamped
TAA. Shifts are a slice written into a tensor of the fill value, so a
neighbour outside the image reads the fill (inf for depth, False for hit)
and the masks drop it before its weight is used. Plain PyTorch, eager.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from gfxexp_torch.core.math import dot, luminance
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.render.gbuffer import GBuffer
from gfxexp_torch.utils import trace

_EPS = 1e-6

ATROUS_BOX3 = "box3x3"
ATROUS_GAUSS3 = "gauss3x3"
ATROUS_GAUSS5 = "gauss5x5"

# kernel taps (dy, dx, weight)
_G3 = {0: 0.25, 1: 0.125, -1: 0.125}  # 1D [1/4, 1/2, 1/4] split per axis
_G5 = {0: 6 / 16, 1: 4 / 16, -1: 4 / 16, 2: 1 / 16, -2: 1 / 16}
_ATROUS_KERNELS = {
    ATROUS_BOX3: [(i, j, 1.0) for i in (-1, 0, 1) for j in (-1, 0, 1)],
    ATROUS_GAUSS3: [(i, j, (2 * _G3[i]) * (2 * _G3[j]))
                    for i in (-1, 0, 1) for j in (-1, 0, 1)],
    ATROUS_GAUSS5: [(i, j, _G5[i] * _G5[j])
                    for i in range(-2, 3) for j in range(-2, 3)],
}


@dataclasses.dataclass(frozen=True)
class SVGFConfig:
    num_filter_stages: int = 5
    feedback_1st_filtered: bool = False
    enable_temporal_accumulation: bool = True
    enable_svgf: bool = True
    enable_taa: bool = True
    taa_history_length: int = 8
    sigma_z: float = 1.0
    sigma_n: float = 128.0
    sigma_l: float = 4.0
    # roughen specular after the first bounce; the lighting pass reads it
    # through PTConfig(mollify_specular=...) (apps/svgf.py)
    mollify_specular: bool = False
    atrous_kernel: str = ATROUS_BOX3


@dataclass
class SVGFState(TensorData):
    """The temporal state carried from frame to frame."""

    prev_noisy: torch.Tensor  # [H, W, 3] demodulated lighting history
    moments: torch.Tensor  # [H, W, 2] luminance moments (first, second)
    sample_count: torch.Tensor  # [H, W] float32
    # the previous frame's planes read by the reprojection's tests
    prev_position: torch.Tensor  # [H, W, 3]
    prev_normal: torch.Tensor  # [H, W, 3]
    prev_unit: torch.Tensor  # [H, W] int32
    prev_material: torch.Tensor  # [H, W] int32
    taa_history: torch.Tensor  # [H, W, 3]
    first_frame: torch.Tensor  # [] bool


def make_svgf_state(width: int, height: int, device="cuda") -> SVGFState:
    """An empty state on `device` (the card unless the caller asks for the
    CPU)."""
    z3 = torch.zeros((height, width, 3), device=device)
    neg = torch.full((height, width), -1, dtype=torch.int32, device=device)
    return SVGFState(
        prev_noisy=z3, moments=torch.zeros((height, width, 2), device=device),
        sample_count=torch.zeros((height, width), device=device),
        prev_position=z3, prev_normal=z3, prev_unit=neg, prev_material=neg,
        taa_history=z3,
        first_frame=torch.ones((), dtype=torch.bool, device=device))


def _shift(img, dy: int, dx: int, fill=0.0):
    """out[y, x] = img[y + dy, x + dx], `fill` outside the image."""
    h, w = img.shape[:2]
    out = torch.full(img.shape, fill, dtype=img.dtype, device=img.device)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
        img[max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0)]
    return out


def _safe_div(a, b):
    nz = torch.abs(b) > 0
    return a / torch.where(nz, b, 1.0) * nz


def demodulate_albedo(lighting, albedo):
    """lighting / albedo, with albedos below 0.001 taken as 0 (and 0 where
    the albedo is 0)."""
    alb = torch.where(albedo < 0.001, 0.0, albedo)
    return _safe_div(lighting, alb)


def _pixel_grid(h: int, w: int, device):
    yy, xx = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return yy, xx


# ---------------------------------------------------------------------------
# temporal reprojection and accumulation
# ---------------------------------------------------------------------------


def _reproject(state: SVGFState, gb: GBuffer, cfg: SVGFConfig):
    """4-tap bilinear history fetch with geometry validity tests. Returns
    (prev_noisy [H, W, 3], prev_moments [H, W, 2], prev_count [H, W],
    any_valid [H, W])."""
    h, w = gb.depth.shape
    yy, xx = _pixel_grid(h, w, gb.depth.device)
    # the previous viewport position (pixels): cur - motion
    prev_x = xx.to(torch.float32) + 0.5 - gb.motion[..., 0]
    prev_y = yy.to(torch.float32) + 0.5 - gb.motion[..., 1]
    in_screen = (prev_x >= 0) & (prev_y >= 0) & (prev_x < w) & (prev_y < h)

    # the integer cast truncates toward zero, as the JAX package's does
    base_x = torch.clamp(prev_x.to(torch.int64), 0, w - 1)
    base_y = torch.clamp(prev_y.to(torch.int64), 0, h - 1)
    fdx = prev_x - (base_x.to(torch.float32) + 0.5)
    fdy = prev_y - (base_y.to(torch.float32) + 0.5)
    nx = torch.clamp(base_x + torch.where(fdx < 0, -1, 1), 0, w - 1)
    ny = torch.clamp(base_y + torch.where(fdy < 0, -1, 1), 0, h - 1)
    s = torch.abs(fdx)
    t = torch.abs(fdy)

    taps = [(base_y, base_x, (1 - s) * (1 - t)), (base_y, nx, s * (1 - t)),
            (ny, base_x, (1 - s) * t), (ny, nx, s * t)]
    sum_w = torch.zeros_like(s)
    acc_noisy = torch.zeros_like(state.prev_noisy)
    acc_mom = torch.zeros_like(state.moments)
    acc_cnt = torch.zeros_like(s)
    for ty, tx, tw in taps:
        nb_normal = state.prev_normal[ty, tx]
        nb_pos = state.prev_position[ty, tx]
        dp = nb_pos - gb.position
        ok = (in_screen
              & (state.prev_unit[ty, tx] == gb.unit)
              & (state.prev_material[ty, tx] == gb.material)
              & (dot(nb_normal, gb.normal) > 0.85)
              & (dot(dp, dp) <= 0.1))
        wgt = torch.where(ok, tw, 0.0)
        sum_w = sum_w + wgt
        acc_noisy = acc_noisy + wgt[..., None] * state.prev_noisy[ty, tx]
        acc_mom = acc_mom + wgt[..., None] * state.moments[ty, tx]
        acc_cnt = acc_cnt + wgt * state.sample_count[ty, tx]

    valid = sum_w > 0
    inv = torch.where(valid, 1.0 / torch.where(valid, sum_w, 1.0), 0.0)
    return (acc_noisy * inv[..., None], acc_mom * inv[..., None],
            torch.round(acc_cnt * inv), valid)


def temporal_accumulate(state: SVGFState, gb: GBuffer, dem_lighting,
                        cfg: SVGFConfig):
    """Blend the demodulated lighting and its luminance moments with the
    reprojected history: a cumulative mean for 5 frames, then an EMA of
    weight 1/5. Returns (noisy [H, W, 3], moments [H, W, 2], count [H, W])."""
    lum = luminance(dem_lighting)
    mom_cur = torch.stack([lum, lum * lum], dim=-1)
    if not cfg.enable_temporal_accumulation:
        return dem_lighting, mom_cur, torch.ones_like(lum)

    prev_noisy, prev_mom, prev_cnt, valid = _reproject(state, gb, cfg)
    reset = state.first_frame | ~valid
    prev_cnt = torch.where(reset, 0.0, prev_cnt)
    count = torch.clamp(prev_cnt + 1.0, max=65535.0)

    cur_w = torch.where(count < 5.0, 1.0 / count, 1.0 / 5.0)
    cur_w = torch.where(count <= 1.0, 1.0, cur_w)
    prev_w = 1.0 - cur_w

    noisy = prev_w[..., None] * prev_noisy + cur_w[..., None] * dem_lighting
    mom = prev_w[..., None] * prev_mom + cur_w[..., None] * mom_cur
    return noisy, mom, count


# ---------------------------------------------------------------------------
# variance estimation
# ---------------------------------------------------------------------------

_SPATIAL_KERNEL = [0.00598, 0.060626, 0.241843, 0.383103, 0.241843,
                   0.060626, 0.00598]


def _depth_gradients(depth):
    """dz/dx, dz/dy by one-sided differences toward the image centre; 0
    where either is not finite."""
    h, w = depth.shape
    dev = depth.device
    dx = torch.where(torch.arange(w, device=dev)[None, :] < w // 2, 1, -1)
    dy = torch.where(torch.arange(h, device=dev)[:, None] < h // 2, 1, -1)
    inf = float("inf")
    hnb = torch.where(dx > 0, _shift(depth, 0, 1, fill=inf),
                      _shift(depth, 0, -1, fill=inf))
    vnb = torch.where(dy > 0, _shift(depth, 1, 0, fill=inf),
                      _shift(depth, -1, 0, fill=inf))
    dzdx = (hnb - depth) * dx
    dzdy = (vnb - depth) * dy
    finite = torch.isfinite(dzdx) & torch.isfinite(dzdy)
    return torch.where(finite, dzdx, 0.0), torch.where(finite, dzdy, 0.0)


def _w_depth(nb_depth, depth, dzdx, dzdy, dx: int, dy: int, sigma_z):
    pred = torch.abs(dzdx * dx + dzdy * dy)
    return torch.exp(-torch.abs(nb_depth - depth) / (sigma_z * pred + _EPS))


def _w_normal(nb_normal, normal, sigma_n):
    d = torch.clamp(dot(nb_normal, normal), min=0.0)
    return d ** sigma_n


def estimate_variance(moments, sample_count, depth, normal, hit,
                      cfg: SVGFConfig):
    """The temporal variance where a pixel's count is >= 4, the 7x7
    depth- and normal-weighted spatial estimate of the moments otherwise."""
    first = moments[..., 0]
    second = moments[..., 1]
    inf = float("inf")

    dzdx, dzdy = _depth_gradients(torch.where(hit, depth, inf))
    center_w = _SPATIAL_KERNEL[3] ** 2
    sum_first = center_w * first
    sum_second = center_w * second
    sum_w = torch.full_like(first, center_w)
    for i in range(-3, 4):
        for j in range(-3, 4):
            if i == 0 and j == 0:
                continue
            hy = _SPATIAL_KERNEL[i + 3]
            hx = _SPATIAL_KERNEL[j + 3]
            wz = _w_depth(_shift(depth, i, j, fill=inf), depth, dzdx, dzdy,
                          j, i, cfg.sigma_z)
            wn = _w_normal(_shift(normal, i, j), normal, cfg.sigma_n)
            wgt = torch.where(_shift(hit, i, j, fill=False),
                              hy * hx * wz * wn, 0.0)
            sum_first = sum_first + wgt * _shift(first, i, j)
            sum_second = sum_second + wgt * _shift(second, i, j)
            sum_w = sum_w + wgt
    use_spatial = sample_count < 4.0
    f = torch.where(use_spatial, sum_first / sum_w, first)
    s = torch.where(use_spatial, sum_second / sum_w, second)
    return torch.clamp(s - f * f, min=0.0)


# ---------------------------------------------------------------------------
# à-trous filtering
# ---------------------------------------------------------------------------

_STEP_WIDTHS = [1, 2, 4, 8, 16]


def atrous_stage(color, variance, depth, normal, hit, step: int,
                 cfg: SVGFConfig):
    """One à-trous stage with edge-stopping weights. Returns (filtered
    colour, filtered variance)."""
    dzdx, dzdy = _depth_gradients(torch.where(hit, depth, float("inf")))
    return _atrous_stage_core(color, variance, depth, normal, hit, dzdx,
                              dzdy, step, cfg)


def _atrous_stage_core(color, variance, depth, normal, hit, dzdx, dzdy,
                       step: int, cfg: SVGFConfig):
    """atrous_stage with the depth gradients passed in. Every tap is a
    shift and pointwise arithmetic, so a row block padded with a halo gives
    the whole image's result once the halo is cropped (the gradients are
    the whole image's: their direction flips at the centre row)."""
    lum = luminance(color)

    # 3x3 Gaussian prefilter of the variance -> local standard deviation
    g = [0.25, 0.5, 0.25]
    v_acc = torch.zeros_like(variance)
    w_acc = 0.0
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            wgt = g[i + 1] * g[j + 1]
            v_acc = v_acc + wgt * _shift(variance, i, j, fill=0.0)
            w_acc = w_acc + wgt
    local_std = torch.sqrt(torch.clamp(v_acc / w_acc, min=0.0))

    taps = _ATROUS_KERNELS[cfg.atrous_kernel]
    center_w = next(wgt for (i, j, wgt) in taps if i == 0 and j == 0)
    sum_w = torch.full_like(lum, center_w)
    acc_c = center_w * color
    acc_v = (center_w * center_w) * variance
    inf = float("inf")
    for i, j, h_w in taps:
        if i == 0 and j == 0:
            continue
        dy, dx = i * step, j * step
        nb_color = _shift(color, dy, dx)
        wz = _w_depth(_shift(depth, dy, dx, fill=inf), depth, dzdx, dzdy,
                      dx, dy, cfg.sigma_z)
        wn = _w_normal(_shift(normal, dy, dx), normal, cfg.sigma_n)
        wl = torch.exp(-torch.abs(luminance(nb_color) - lum)
                       / (cfg.sigma_l * local_std + _EPS))
        wgt = torch.where(_shift(hit, dy, dx, fill=False),
                          h_w * wz * wn * wl, 0.0)
        acc_c = acc_c + wgt[..., None] * nb_color
        acc_v = acc_v + (wgt * wgt) * _shift(variance, dy, dx)
        sum_w = sum_w + wgt
    return acc_c / sum_w[..., None], acc_v / (sum_w * sum_w)


# ---------------------------------------------------------------------------
# TAA
# ---------------------------------------------------------------------------


def taa(color, history, motion, first_frame, cfg: SVGFConfig):
    """Exponential TAA of the bilinearly fetched history, clamped to the
    3x3 neighbourhood's range."""
    h, w = color.shape[:2]
    yy, xx = _pixel_grid(h, w, color.device)
    px = xx.to(torch.float32) + 0.5 - motion[..., 0]
    py = yy.to(torch.float32) + 0.5 - motion[..., 1]
    in_screen = (px >= 0) & (py >= 0) & (px < w) & (py < h)

    x0 = torch.clamp(torch.floor(px - 0.5).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(py - 0.5).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(px - 0.5 - x0.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(py - 0.5 - y0.to(torch.float32), 0.0, 1.0)
    hist = (history[y0, x0] * ((1 - fx) * (1 - fy))[..., None]
            + history[y0, x1] * (fx * (1 - fy))[..., None]
            + history[y1, x0] * ((1 - fx) * fy)[..., None]
            + history[y1, x1] * (fx * fy)[..., None])

    nb_min = color
    nb_max = color
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            nb = _shift(color, i, j, fill=0.0)
            nb_min = torch.minimum(nb_min, nb)
            nb_max = torch.maximum(nb_max, nb)
    hist = torch.minimum(torch.maximum(hist, nb_min), nb_max)

    alpha = 1.0 / cfg.taa_history_length
    blend = torch.where((in_screen & ~first_frame)[..., None], 1.0 - alpha,
                        0.0)
    return color * (1.0 - blend) + hist * blend


# ---------------------------------------------------------------------------
# the whole frame
# ---------------------------------------------------------------------------


def _atrous_pyramid(noisy, variance, gb: GBuffer, cfg: SVGFConfig):
    """The single-device à-trous pyramid: (filtered, first stage's
    output)."""
    color = noisy
    first_filtered = noisy
    for stage, step in enumerate(_STEP_WIDTHS[:cfg.num_filter_stages]):
        with trace.span(f"gfx.svgf.atrous{stage}"):
            color, variance = atrous_stage(color, variance, gb.depth,
                                           gb.normal, gb.hit, step, cfg)
        if stage == 0:
            first_filtered = color
    return color, first_filtered


def svgf_frame(state: SVGFState, gb: GBuffer, lighting,
               cfg: SVGFConfig = SVGFConfig(), pyramid_fn=None):
    """SVGF for one frame. `lighting` is the 1-spp radiance [H, W, 3] (not
    demodulated). Returns (final colour [H, W, 3], new state). Miss pixels
    keep the raw lighting.

    `pyramid_fn(noisy, variance, gb, cfg) -> (filtered, first_filtered)`
    replaces the à-trous pyramid only (a sharded pyramid takes this hook),
    so the temporal, demodulation and TAA steps around it stay shared."""
    with trace.span("gfx.svgf"):
        hit = gb.hit
        with trace.span("gfx.svgf.temporal"):
            dem = demodulate_albedo(lighting, gb.albedo)
            noisy, moments, count = temporal_accumulate(state, gb, dem, cfg)

        if cfg.enable_svgf:
            with trace.span("gfx.svgf.variance"):
                variance = estimate_variance(moments, count, gb.depth,
                                             gb.normal, hit, cfg)
            filtered, first_filtered = (pyramid_fn or _atrous_pyramid)(
                noisy, variance, gb, cfg)
            feedback = first_filtered if cfg.feedback_1st_filtered else noisy
        else:
            filtered = noisy
            feedback = noisy

        # remodulate; miss pixels keep the raw lighting (the environment)
        final = torch.where(hit[..., None], filtered * gb.albedo, lighting)
        if cfg.enable_taa:
            with trace.span("gfx.svgf.taa"):
                final = taa(final, state.taa_history, gb.motion,
                            state.first_frame, cfg)

        new_state = SVGFState(
            prev_noisy=torch.where(hit[..., None], feedback, 0.0),
            moments=moments,
            sample_count=torch.where(hit, count, 0.0),
            prev_position=gb.position,
            prev_normal=gb.normal,
            prev_unit=gb.unit,
            prev_material=gb.material,
            taa_history=final,
            first_frame=torch.zeros_like(state.first_frame),
        )
        return final, new_state
