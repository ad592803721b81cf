"""TFDM: tessellation-free displacement mapping (port of
gfxexp_tpu/techniques/tfdm.py).

A base triangle mesh is displaced along its interpolated vertex normals by a
height map, height = h_offset + h_scale * (h - h_bias), without tessellating
it. Each base triangle bounds its displaced surface by a prism whose
conservative AABB comes from a min/max pyramid of the height map; rays find
the prisms they enter (the broad phase: a top-k slab sweep, then per-round
rescans, or a skip-link walk over a box BVH of the prisms past 2,048 of
them) and march each one nearest first (the narrow phase: a walk over the
pyramid that skips empty texels and resolves occupied base texels exactly,
then bisection). Local surface types: box, two-triangle, bilinear and
bicubic B-spline.

The build is numpy on the host, as in the JAX package, and gives the same
arrays. The queries are plain PyTorch on the device that holds the
geometry. The JAX package's data-dependent loops (its while loops and
conds, ended by an `any` over the rays) are Python loops here, each test of
their condition a host sync on the card; every update in them is masked by
the rays still running, so an iteration past a ray's end changes nothing.
The counters `tfdm.<key>` (utils/trace.py, LOOP_COUNTERS) count the syncs
and iterations. Ties in the candidate order
are broken as in the JAX package: lowest id first among equal entry
distances.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from gfxexp_torch.core.math import cross, dot, length
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.utils import trace

LOCAL_INTERSECTION_BOX = 0
LOCAL_INTERSECTION_TWO_TRIANGLE = 1
LOCAL_INTERSECTION_BILINEAR = 2
LOCAL_INTERSECTION_BSPLINE = 3  # bicubic uniform B-spline surface (16 taps)

_INT32_MAX = 2 ** 31 - 1
# elements of one [rays, prisms] slab test; rays are chunked to stay near it
_SLAB_ELEMS = 1 << 24
# the skip walk of the prism BVH tests whether any ray still walks once
# every this many steps (a step past a ray's end is a no-op for it)
BVH_SYNC_EVERY = 4

# the counters of host syncs and loop iterations, `tfdm.<key>` in
# utils/trace.py: `syncs` (tests of a loop condition that read the device),
# `rounds`
# (candidate rounds of iterate_candidates), `march_iterations` (steps of
# intersect_tfdm_v2's march loop, over all rounds), `bvh_iterations` (steps
# of the prism BVH walk), `calls` (intersect_tfdm_v2 calls); the other
# displaced kinds, which share the candidate rounds: `nrtdsm_calls`
# (intersect_nrtdsm_v2 and _exact, techniques/nrtdsm.py), `exact_iterations`
# (steps of intersect_nrtdsm_exact's loop over occupied segments),
# `shell_calls` (intersect_shell, techniques/shell.py)
LOOP_COUNTERS = ("calls", "syncs", "rounds", "march_iterations",
                 "bvh_iterations", "nrtdsm_calls", "exact_iterations",
                 "shell_calls")


def _any(x) -> bool:
    trace.count("tfdm.syncs")
    return bool(x.any())


def _select(mask):
    """The indices of the set lanes of `mask` (one host sync)."""
    trace.count("tfdm.syncs")
    return torch.nonzero(mask).squeeze(1)


def _ray_chunk(n_boxes: int) -> int:
    """Rays per slab test against n_boxes boxes: [rays, boxes] stays near
    _SLAB_ELEMS elements (about 200 MB per [rays, boxes, 3] temporary)."""
    return max(1, _SLAB_ELEMS // max(int(n_boxes), 1))


@dataclasses.dataclass(frozen=True)
class DisplacementParameters:
    h_offset: float = 0.0
    h_scale: float = 1.0
    h_bias: float = 0.0
    target_mip_level: int = 0
    local_intersection_type: int = LOCAL_INTERSECTION_BILINEAR
    # 2D texture transform uv' = A @ uv + b
    uv_scale: float = 1.0
    uv_rotation: float = 0.0
    uv_offset: tuple = (0.0, 0.0)


@dataclass
class MinMaxMipmap(TensorData):
    """Per-level (min, max), padded to the base resolution so the pyramid
    is one [L, S, S, 2] tensor; level l is valid in [:S >> l, :S >> l]."""

    levels: torch.Tensor  # [L, S, S, 2] float32
    base_size: int = 0
    n_levels: int = 1


def _height_channel0(height) -> np.ndarray:
    """[S, S] or [S, S, C] height map -> [S, S] float32 channel 0."""
    h = np.asarray(height, np.float32)
    if h.ndim == 3:
        h = h[..., 0]
    return h


def _pyramid_np(height, footprint: int = 2) -> np.ndarray:
    """The padded [L, S, S, 2] min/max pyramid. Level 0 holds patch
    bounds: entry (y, x) is the min/max over the `footprint` x `footprint`
    wrapped samples that shape patch [x, x+1] x [y, y+1] (2 for the
    bilinear surface, 4 for the B-spline's 4x4 control neighbourhood,
    samples x-1 .. x+2)."""
    h = _height_channel0(height)
    s = h.shape[0]
    if h.shape != (s, s) or (s & (s - 1)) != 0:
        raise ValueError(f"height map must be square with a power-of-two "
                         f"side, got {h.shape}")
    first = -1 if footprint == 4 else 0
    shifts = range(first, first + footprint)
    p_min = np.full_like(h, np.inf)
    p_max = np.full_like(h, -np.inf)
    for dy in shifts:
        for dx in shifts:
            hs = np.roll(np.roll(h, -dx, axis=1), -dy, axis=0)
            p_min = np.minimum(p_min, hs)
            p_max = np.maximum(p_max, hs)
    levels = [np.stack([p_min, p_max], axis=-1)]
    cur = levels[0]
    while cur.shape[0] > 1:
        mn = cur[..., 0]
        mx = cur[..., 1]
        mn2 = np.minimum(
            np.minimum(mn[0::2, 0::2], mn[1::2, 0::2]),
            np.minimum(mn[0::2, 1::2], mn[1::2, 1::2]))
        mx2 = np.maximum(
            np.maximum(mx[0::2, 0::2], mx[1::2, 0::2]),
            np.maximum(mx[0::2, 1::2], mx[1::2, 1::2]))
        cur = np.stack([mn2, mx2], axis=-1)
        levels.append(cur)
    padded = np.zeros((len(levels), s, s, 2), np.float32)
    for lvl, lv in enumerate(levels):
        k = lv.shape[0]
        padded[lvl, :k, :k] = lv
    return padded


def build_minmax_mipmap(height, footprint: int = 2) -> MinMaxMipmap:
    """The min/max pyramid of a square power-of-two height map (numpy on
    the host, returned as a CPU tensor)."""
    padded = _pyramid_np(height, footprint)
    return MinMaxMipmap(levels=torch.from_numpy(padded),
                        base_size=padded.shape[1], n_levels=padded.shape[0])


@dataclass
class PrismBVH(TensorData):
    """The box BVH over the prism AABBs: skip-link nodes whose leaves hold
    one prism each; leaf `first` indexes `perm`, the original prism id."""

    skip: TensorData  # accel/skiplink.py SkipBVH
    perm: torch.Tensor  # [B] int32


@dataclass
class TFDMGeometry(TensorData):
    """A displaced base mesh: world-space base triangles, their vertex
    normals and uvs, the height map, its pyramid and the prisms' AABBs."""

    p0: torch.Tensor  # [B, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor  # vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # [B, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    height: torch.Tensor  # [S, S]
    minmax: MinMaxMipmap
    aabb_min: torch.Tensor  # [B, 3] conservative displaced bounds
    aabb_max: torch.Tensor
    material: int = 0
    params: DisplacementParameters = DisplacementParameters()
    # built for 2,048 prisms or more; None keeps the slab-sweep broad phase
    prism_bvh: Optional[PrismBVH] = None


def _uv_np(params: DisplacementParameters, uv):
    """The texture transform on the host (float64)."""
    c = np.cos(params.uv_rotation)
    s = np.sin(params.uv_rotation)
    rot = np.asarray([[c, -s], [s, c]], np.float64) * params.uv_scale
    return np.asarray(uv, np.float64) @ rot.T + np.asarray(params.uv_offset)


def _uv_transform(params: DisplacementParameters, uv):
    """uv' = A @ uv + b in float32 ([..., 2]), written out per component
    (no matmul, so no TF32). The identity transform returns uv: u * 1 +
    v * -0 + 0 is u again, but for the sign of a zero, which no later use
    tells apart."""
    if (params.uv_rotation == 0.0 and params.uv_scale == 1.0
            and tuple(params.uv_offset) == (0.0, 0.0)):
        return uv
    c = np.cos(params.uv_rotation)
    s = np.sin(params.uv_rotation)
    rot = np.asarray([[c, -s], [s, c]], np.float32) * np.float32(
        params.uv_scale)
    off = np.asarray(params.uv_offset, np.float32)
    u, v = uv[..., 0], uv[..., 1]
    return torch.stack([u * float(rot[0, 0]) + v * float(rot[0, 1])
                        + float(off[0]),
                        u * float(rot[1, 0]) + v * float(rot[1, 1])
                        + float(off[1])], dim=-1)


def build_prism_bvh(aabb_min, aabb_max, arity: int = 4) -> PrismBVH:
    """The box BVH over the prism AABBs for the skip-walk broad phase
    (host build: the native builder, or its numpy fallback)."""
    from gfxexp_torch.accel.bvh_build import build_bvh_arrays
    from gfxexp_torch.accel.native import build_bvh_arrays_native
    from gfxexp_torch.accel.skiplink import build_skip_links

    result = build_bvh_arrays_native(
        np.asarray(aabb_min, np.float32), np.asarray(aabb_max, np.float32),
        arity=arity, max_leaf=1)
    if result is None:
        result = build_bvh_arrays(
            np.asarray(aabb_min, np.float64),
            np.asarray(aabb_max, np.float64), arity=arity, max_leaf=1)
    cmin, cmax, cidx, ccount, perm, _ = result
    skip = build_skip_links(cmin, cmax, cidx, ccount, max_leaf=1)
    return PrismBVH(skip=skip,
                    perm=torch.from_numpy(np.asarray(perm, np.int32)))


def build_tfdm_geometry(positions, indices, uvs, height, params=None,
                        material: int = 0, normals=None) -> TFDMGeometry:
    """Host build (numpy; CPU tensors): per-triangle conservative AABBs
    over the [h_min, h_max] displacement of the triangle's uv footprint,
    read from the pyramid level where the footprint spans about 4 texels
    (footprints spanning a whole period take the whole map's interval)."""
    from gfxexp_torch.scene.builder import compute_smooth_normals

    params = params or DisplacementParameters()
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    uvs = np.asarray(uvs, np.float32)
    if normals is None:
        normals = compute_smooth_normals(positions, indices)
    normals = np.asarray(normals, np.float32)
    footprint = (4 if params.local_intersection_type
                 == LOCAL_INTERSECTION_BSPLINE else 2)
    levels = _pyramid_np(height, footprint=footprint)
    n_levels = levels.shape[0]
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    p0, p1, p2 = positions[i0], positions[i1], positions[i2]
    n0, n1, n2 = normals[i0], normals[i1], normals[i2]

    s = levels.shape[1]
    hmin_g = float(levels[n_levels - 1, 0, 0, 0])
    hmax_g = float(levels[n_levels - 1, 0, 0, 1])
    uvs_t = np.stack([_uv_np(params, uvs[i]) for i in (i0, i1, i2)], 1)
    uv_lo = uvs_t.min(axis=1)  # [B, 2]
    uv_hi = uvs_t.max(axis=1)
    hmin = np.full(len(i0), hmin_g, np.float64)
    hmax = np.full(len(i0), hmax_g, np.float64)
    span = (uv_hi - uv_lo).max(axis=1)
    fit = span < 1.0 - 1e-6
    if fit.any():
        # a fixed 7x7 window per triangle (a footprint of <= 4 texels, the
        # floor's slack and a 1-texel pad), masked past the footprint
        lvl_all = np.clip(np.ceil(np.log2(np.maximum(span * s, 1e-9)
                                          / 4.0)).astype(np.int64),
                          0, n_levels - 1)
        win = np.arange(7)
        for lvl in np.unique(lvl_all[fit]):
            selb = np.nonzero(fit & (lvl_all == lvl))[0]
            sz = s >> int(lvl)
            x0 = np.floor(uv_lo[selb, 0] * sz).astype(np.int64) - 1
            y0 = np.floor(uv_lo[selb, 1] * sz).astype(np.int64) - 1
            xs = (x0[:, None] + win[None, :]) % sz  # [B_l, 7]
            ys = (y0[:, None] + win[None, :]) % sz
            x1 = np.floor(uv_hi[selb, 0] * sz).astype(np.int64) + 1
            y1 = np.floor(uv_hi[selb, 1] * sz).astype(np.int64) + 1
            mx = (x0[:, None] + win[None, :]) <= x1[:, None]
            my = (y0[:, None] + win[None, :]) <= y1[:, None]
            blk = levels[lvl][ys[:, :, None], xs[:, None, :]]  # [B, 7, 7, 2]
            mwin = my[:, :, None] & mx[:, None, :]
            hmin[selb] = np.where(mwin, blk[..., 0], np.inf) \
                .reshape(len(selb), -1).min(axis=1)
            hmax[selb] = np.where(mwin, blk[..., 1], -np.inf) \
                .reshape(len(selb), -1).max(axis=1)
    d0 = params.h_offset + params.h_scale * (hmin - params.h_bias)
    d1 = params.h_offset + params.h_scale * (hmax - params.h_bias)
    d_lo = np.minimum(d0, d1)[:, None]  # [B, 1]
    d_hi = np.maximum(d0, d1)[:, None]

    corners = []
    for pv, nv in ((p0, n0), (p1, n1), (p2, n2)):
        corners.append(pv + d_lo * nv)
        corners.append(pv + d_hi * nv)
    stack = np.stack(corners, axis=1)  # [B, 6, 3]
    lo = stack.min(axis=1) - 1e-4
    hi = stack.max(axis=1) + 1e-4

    # past ~2k prisms the slab sweep loses to the box BVH's walk
    prism_bvh = build_prism_bvh(lo, hi) if len(i0) >= 2048 else None

    def t32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32))

    return TFDMGeometry(
        p0=t32(p0), e1=t32(p1 - p0), e2=t32(p2 - p0),
        n0=t32(n0), n1=t32(n1), n2=t32(n2),
        uv0=t32(uvs[i0]), uv1=t32(uvs[i1]), uv2=t32(uvs[i2]),
        height=t32(_height_channel0(height)),
        minmax=MinMaxMipmap(levels=torch.from_numpy(levels), base_size=s,
                            n_levels=n_levels),
        aabb_min=t32(lo), aabb_max=t32(hi),
        material=int(material), params=params, prism_bvh=prism_bvh)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def params_from_numpy(p) -> DisplacementParameters:
    """gfxexp_tpu's DisplacementParameters (read by attribute name) -> the
    port's."""
    return DisplacementParameters(
        h_offset=float(p.h_offset), h_scale=float(p.h_scale),
        h_bias=float(p.h_bias), target_mip_level=int(p.target_mip_level),
        local_intersection_type=int(p.local_intersection_type),
        uv_scale=float(p.uv_scale), uv_rotation=float(p.uv_rotation),
        uv_offset=tuple(float(x) for x in p.uv_offset))


def prism_bvh_from_numpy(pb) -> Optional[PrismBVH]:
    """gfxexp_tpu's (SkipBVH, perm) prism BVH, or None -> the port's."""
    from gfxexp_torch.core.tensors import from_numpy

    if pb is None:
        return None
    skip, perm = pb
    return PrismBVH(skip=from_numpy(skip), perm=_t(perm).to(torch.int32))


def minmax_from_numpy(mm) -> MinMaxMipmap:
    return MinMaxMipmap(levels=_t(mm.levels), base_size=int(mm.base_size),
                        n_levels=int(mm.n_levels))


def tfdm_from_numpy(g) -> TFDMGeometry:
    """A gfxexp_tpu TFDMGeometry (read by attribute name) -> the port's on
    the CPU, with its parameters and its prism BVH and permutation."""
    return TFDMGeometry(
        **{k: _t(getattr(g, k)) for k in (
            "p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
            "height", "aabb_min", "aabb_max")},
        minmax=minmax_from_numpy(g.minmax), material=int(g.material),
        params=params_from_numpy(g.params),
        prism_bvh=prism_bvh_from_numpy(g.prism_bvh))


def _sample_height_at(height, params: DisplacementParameters, uv):
    """Height lookup in `height` [S, S] at uv [..., 2] (wrapped, already
    texture-transformed) with the parameters' local surface type."""
    s = height.shape[0]
    u = torch.remainder(uv[..., 0], 1.0) * s - 0.5
    v = torch.remainder(uv[..., 1], 1.0) * s - 0.5
    x0 = torch.floor(u).to(torch.int64)
    y0 = torch.floor(v).to(torch.int64)
    fx = u - x0
    fy = v - y0
    x0w, y0w = torch.remainder(x0, s), torch.remainder(y0, s)
    x1w, y1w = torch.remainder(x0 + 1, s), torch.remainder(y0 + 1, s)
    lit = params.local_intersection_type
    if lit == LOCAL_INTERSECTION_BSPLINE:
        # bicubic uniform B-spline over the 4x4 control neighbourhood
        # (approximating, not interpolating). The divisor is a tensor on
        # the lanes' device: CUDA divides by a Python scalar through its
        # reciprocal, which rounds otherwise than the CPU's division
        six = torch.full((), 6.0, device=uv.device)

        def w_cubic(f):
            f2 = f * f
            f3 = f2 * f
            return ((1.0 - 3.0 * f + 3.0 * f2 - f3) / six,
                    (4.0 - 6.0 * f2 + 3.0 * f3) / six,
                    (1.0 + 3.0 * f + 3.0 * f2 - 3.0 * f3) / six,
                    f3 / six)

        wx = w_cubic(fx)
        wy = w_cubic(fy)
        out = torch.zeros_like(fx)
        for j in range(4):
            yj = torch.remainder(y0 + (j - 1), s)
            row = torch.zeros_like(fx)
            for i in range(4):
                xi = torch.remainder(x0 + (i - 1), s)
                row = row + wx[i] * height[yj, xi]
            out = out + wy[j] * row
        return out
    # the four corner samples in one gather
    rows = torch.stack([y0w, y1w]) * s
    h00, h10, h01, h11 = height.reshape(-1)[torch.stack(
        [rows[0] + x0w, rows[0] + x1w, rows[1] + x0w, rows[1] + x1w])]
    if lit == LOCAL_INTERSECTION_BOX:
        # nearest sample (the box local surface)
        return torch.where(fx < 0.5, torch.where(fy < 0.5, h00, h01),
                           torch.where(fy < 0.5, h10, h11))
    if lit == LOCAL_INTERSECTION_TWO_TRIANGLE:
        # the bilinear patch split into two triangles
        lower = fx + fy <= 1.0
        h_low = h00 + fx * (h10 - h00) + fy * (h01 - h00)
        h_up = h11 + (1 - fx) * (h01 - h11) + (1 - fy) * (h10 - h11)
        return torch.where(lower, h_low, h_up)
    return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
            + h01 * (1 - fx) * fy + h11 * fx * fy)


def sample_height(geom: TFDMGeometry, uv):
    """Height lookup with the configured local surface type; uv [R, 2]
    (wrapped)."""
    return _sample_height_at(geom.height, geom.params, uv)


def _displace(params: DisplacementParameters, hs):
    """h_offset + h_scale * (hs - h_bias), leaving out the terms that are
    0 (or the factor 1): x - 0, x + 0 and 1 * x give x again, but for the
    sign of a zero, which no later use tells apart."""
    if params.h_bias:
        hs = hs - params.h_bias
    if params.h_scale != 1.0:
        hs = params.h_scale * hs
    if params.h_offset:
        hs = params.h_offset + hs
    return hs


def _displaced_height(geom: TFDMGeometry, uv):
    return _displace(geom.params, sample_height(geom, uv))


@dataclass
class TFDMHit(TensorData):
    t: torch.Tensor  # [R]
    hit: torch.Tensor  # [R] bool
    position: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3] displaced-surface shading normal
    uv: torch.Tensor  # [R, 2]
    prim: torch.Tensor  # [R] int32 base triangle
    steps: torch.Tensor  # [R] int32 march steps (the traversal heatmap)


def _safe_inv_d(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d < 0, -1e-12, 1e-12), d)


def _rays(x, n, dev):
    """A scalar or [n] ray parameter as an [n] float32 tensor (a Python
    number is filled on the device: no host copy, no sync)."""
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x.to(device=dev, dtype=torch.float32),
                                  (n,))
    return torch.full((n,), float(x), device=dev)


def _unit(v):
    return v / torch.clamp(length(v, keepdim=True), min=1e-20)


def _tangents(e1, e2, uv0, uv1, uv2):
    """The base triangle's dP/du and dP/dv from its uv parameterization
    (rows of [R, 3], or one [3] triangle)."""
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    safe = torch.where(torch.abs(det) > 1e-12, det, 1.0)[..., None]
    tan_u = (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2) / safe
    tan_v = (-duv2[..., 0:1] * e1 + duv1[..., 0:1] * e2) / safe
    return tan_u, tan_v


def intersect_tfdm(geom: TFDMGeometry, o, d, t_min=1e-4, t_max=1e30,
                   n_steps: int = 48, n_refine: int = 8) -> TFDMHit:
    """Closest displaced-surface hit per ray against every base triangle
    in turn: the prism's AABB slab test, a march of `n_steps` fixed steps
    for a sign change of the gap to the displaced surface, then `n_refine`
    bisections (the first intersector, the oracle of the tests).

    Shell model: a point maps to base barycentrics by projection along the
    face normal, and the displaced surface at (u, v) is base(u, v) +
    h(u, v) * n_shade(u, v)."""
    n_rays = o.shape[0]
    dev = o.device
    inv_d = _safe_inv_d(d)
    best_t = _rays(t_max, n_rays, dev).clone()
    best_prim = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    best_uv = torch.zeros((n_rays, 2), device=dev)
    best_pos = torch.zeros((n_rays, 3), device=dev)
    best_nrm = torch.zeros((n_rays, 3), device=dev)
    steps_total = torch.zeros((n_rays,), dtype=torch.int32, device=dev)
    t_min = _rays(t_min, n_rays, dev)
    s = geom.height.shape[0]
    eps = 1.0 / s

    for b in range(geom.p0.shape[0]):
        p0, e1, e2 = geom.p0[b], geom.e1[b], geom.e2[b]
        n0v, n1v, n2v = geom.n0[b], geom.n1[b], geom.n2[b]
        uv0, uv1, uv2 = geom.uv0[b], geom.uv1[b], geom.uv2[b]
        # the face normal, turned toward the vertex normals
        fn = cross(e1, e2)
        fn = fn / torch.clamp(length(fn), min=1e-20)
        nsum = n0v + n1v + n2v
        fn = fn * torch.sign(torch.clamp(dot(fn, nsum), min=-1.0) + 1e-12)
        d00, d01, d11 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
        det = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)

        t0 = (geom.aabb_min[b][None] - o) * inv_d
        t1 = (geom.aabb_max[b][None] - o) * inv_d
        near = torch.maximum(torch.minimum(t0, t1).amax(-1), t_min)
        far = torch.minimum(torch.maximum(t0, t1).amin(-1), best_t)
        active = near <= far

        def field_gap(t):
            x = o + t[:, None] * d
            rel = x - p0
            h = dot(rel, fn)
            q = rel - h[:, None] * fn
            qa = dot(q, e1)
            qb = dot(q, e2)
            b1 = (d11 * qa - d01 * qb) / det
            b2 = (d00 * qb - d01 * qa) / det
            w = 1.0 - b1 - b2
            inside = (b1 >= -1e-3) & (b2 >= -1e-3) & (w >= -1e-3)
            uv = w[:, None] * uv0 + b1[:, None] * uv1 + b2[:, None] * uv2
            uv_t = _uv_transform(geom.params, uv)
            hf = _displaced_height(geom, uv_t)
            # the shell surface's height along the face normal is
            # hf * dot(n_shade, fn)
            nsh = w[:, None] * n0v + b1[:, None] * n1v + b2[:, None] * n2v
            nsh = _unit(nsh)
            cos_tilt = torch.clamp(dot(nsh, fn), min=1e-3)
            return h - hf * cos_tilt, inside, uv_t

        dt = (far - near) / n_steps
        t_prev = near
        gap_prev, inside_prev, _ = field_gap(near)
        found = torch.zeros((n_rays,), dtype=torch.bool, device=dev)
        t_lo, t_hi = near, far
        for k in range(1, n_steps + 1):
            t_cur = near + dt * float(k)
            gap_cur, inside_cur, _ = field_gap(t_cur)
            crossing = (active & ~found & inside_prev & inside_cur
                        & (torch.sign(gap_prev) != torch.sign(gap_cur)))
            t_lo = torch.where(crossing, t_prev, t_lo)
            t_hi = torch.where(crossing, t_cur, t_hi)
            found = found | crossing
            t_prev, gap_prev, inside_prev = t_cur, gap_cur, inside_cur
        steps_total = steps_total + torch.where(active, n_steps, 0).to(
            torch.int32)

        gap_lo = field_gap(t_lo)[0]
        for _ in range(n_refine):
            t_mid = 0.5 * (t_lo + t_hi)
            gap_mid = field_gap(t_mid)[0]
            same = torch.sign(gap_mid) == torch.sign(gap_lo)
            t_lo, t_hi, gap_lo = (torch.where(same, t_mid, t_lo),
                                  torch.where(same, t_hi, t_mid),
                                  torch.where(same, gap_mid, gap_lo))
        t_hit = 0.5 * (t_lo + t_hi)

        take = found & (t_hit > t_min) & (t_hit < best_t)
        _, _, uv_hit = field_gap(t_hit)
        # the displaced surface's normal from the height gradient:
        # S(u, v) = base(u, v) + h(u, v) fn, normal = dS/du x dS/dv
        h_c = _displaced_height(geom, uv_hit)
        h_u = _displaced_height(geom, torch.stack(
            [uv_hit[:, 0] + eps, uv_hit[:, 1]], -1))
        h_v = _displaced_height(geom, torch.stack(
            [uv_hit[:, 0], uv_hit[:, 1] + eps], -1))
        tan_u, tan_v = _tangents(e1, e2, uv0, uv1, uv2)
        gu = (h_u - h_c) / eps
        gv = (h_v - h_c) / eps
        nrm = cross(tan_u[None] + gu[:, None] * fn[None],
                    tan_v[None] + gv[:, None] * fn[None])
        nrm = _unit(nrm)
        nrm = nrm * torch.sign(dot(nrm, fn))[:, None]

        best_prim = torch.where(take, b, best_prim)
        best_t = torch.where(take, t_hit, best_t)
        best_uv = torch.where(take[:, None], uv_hit, best_uv)
        best_pos = torch.where(take[:, None], o + t_hit[:, None] * d,
                               best_pos)
        best_nrm = torch.where(take[:, None], nrm, best_nrm)

    return TFDMHit(t=best_t, hit=best_prim >= 0, position=best_pos,
                   normal=best_nrm, uv=best_uv, prim=best_prim,
                   steps=steps_total)


# ---------------------------------------------------------------------------
# The second intersector: a broad phase that streams each ray's prisms
# nearest first, and a narrow phase guided by the min/max pyramid.
# ---------------------------------------------------------------------------


def _slabs(lo, hi, o, inv, t_lo, t_hi):
    """(near, far) [R, B] of rays o, inv [R, 3] against boxes lo, hi
    [B, 3], clipped to [t_lo, t_hi] [R]."""
    t0 = (lo[None] - o[:, None, :]) * inv[:, None, :]
    t1 = (hi[None] - o[:, None, :]) * inv[:, None, :]
    near = torch.maximum(torch.minimum(t0, t1).amax(-1), t_lo[:, None])
    far = torch.minimum(torch.maximum(t0, t1).amin(-1), t_hi[:, None])
    return near, far


def _broad_phase(aabb_min, aabb_max, o, d, t_min, t_max, k: int,
                 chunk: Optional[int] = None):
    """The k nearest prism-AABB entries per ray, chunked over rays so the
    [chunk, B] slab tests stay bounded: (ids [R, k] int32, -1 padded;
    near [R, k]; far [R, k]), in entry order. Repeated argmin: the first
    index wins ties. Rays whose t_max is below t_min enter no box and are
    left out of the tests."""
    n = o.shape[0]
    dev = o.device
    t_min = _rays(t_min, n, dev)
    t_max = _rays(t_max, n, dev)
    ids_all = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    nr_all = torch.full((n, k), torch.inf, device=dev)
    fr_all = torch.full((n, k), -torch.inf, device=dev)
    sel = _select(t_max >= t_min)
    if sel.numel() == 0:
        return ids_all, nr_all, fr_all
    o, inv_d, t_min, t_max = o[sel], _safe_inv_d(d[sel]), t_min[sel], \
        t_max[sel]
    chunk = chunk or _ray_chunk(aabb_min.shape[0])
    ids_out, nr_out, fr_out = [], [], []
    for start in range(0, o.shape[0], chunk):
        sl = slice(start, start + chunk)
        near, far = _slabs(aabb_min, aabb_max, o[sl], inv_d[sl], t_min[sl],
                           t_max[sl])
        nears = torch.where(near <= far, near, torch.inf)
        rr = torch.arange(nears.shape[0], device=dev)
        ids, nr, fr = [], [], []
        for _ in range(k):
            j = torch.argmin(nears, dim=1)
            val = nears[rr, j]
            good = torch.isfinite(val)
            ids.append(torch.where(good, j, -1).to(torch.int32))
            nr.append(torch.where(good, val, torch.inf))
            fr.append(torch.where(good, far[rr, j], -torch.inf))
            nears[rr, j] = torch.inf
        ids_out.append(torch.stack(ids, 1))
        nr_out.append(torch.stack(nr, 1))
        fr_out.append(torch.stack(fr, 1))
    ids_all[sel] = torch.cat(ids_out)
    nr_all[sel] = torch.cat(nr_out)
    fr_all[sel] = torch.cat(fr_out)
    return ids_all, nr_all, fr_all


def _next_candidate_scan(aabb_min, aabb_max, o, d, t_min, t_cap, last_near,
                         last_id, ray_chunk: Optional[int] = None,
                         prism_chunk: int = 2048):
    """The nearest unprocessed prism-AABB entry per ray: the smallest
    (near, id) strictly after (last_near, last_id) with near < t_cap, by
    one slab sweep chunked over rays and prisms. (id, near, far), id = -1
    when there is none."""
    n = o.shape[0]
    n_b = aabb_min.shape[0]
    dev = o.device
    inv_d = _safe_inv_d(d)
    t_min = _rays(t_min, n, dev)
    ray_chunk = ray_chunk or _ray_chunk(min(n_b, prism_chunk))
    out_id, out_near, out_far = [], [], []
    for rs in range(0, n, ray_chunk):
        sl = slice(rs, rs + ray_chunk)
        oc, ic, tn = o[sl], inv_d[sl], t_min[sl]
        cap, ln, li = t_cap[sl], last_near[sl], last_id[sl]
        m = oc.shape[0]
        rr = torch.arange(m, device=dev)
        best_near = torch.full((m,), torch.inf, device=dev)
        best_id = torch.full((m,), -1, dtype=torch.int32, device=dev)
        best_far = torch.full((m,), -torch.inf, device=dev)
        for start in range(0, n_b, prism_chunk):
            end = min(start + prism_chunk, n_b)
            near, far = _slabs(aabb_min[start:end], aabb_max[start:end], oc,
                               ic, tn, cap)
            gid = torch.arange(start, end, dtype=torch.int32,
                               device=dev)[None]
            ok = ((near <= far) & (near < cap[:, None])
                  & ((near > ln[:, None])
                     | ((near == ln[:, None]) & (gid > li[:, None]))))
            key = torch.where(ok, near, torch.inf)
            j = torch.argmin(key, dim=1)
            val = key[rr, j]
            # strict <: the smaller id keeps equal nears (ids ascend across
            # chunks; argmin takes the first within one)
            take = torch.isfinite(val) & (val < best_near)
            best_near = torch.where(take, val, best_near)
            best_id = torch.where(take, (start + j).to(torch.int32), best_id)
            best_far = torch.where(take, far[rr, j], best_far)
        out_id.append(best_id)
        out_near.append(best_near)
        out_far.append(best_far)
    return torch.cat(out_id), torch.cat(out_near), torch.cat(out_far)


def _next_candidate_bvh(bvh: PrismBVH, o, d, t_min, t_cap, last_near,
                        last_id):
    """The contract of _next_candidate_scan (the smallest (near, original
    id) entry strictly after (last_near, last_id) with near < t_cap),
    answered by a stackless skip-link walk over the prisms' box BVH. A
    subtree is skipped when its box cannot hold an acceptable candidate: no
    overlap, its near past the best key so far, or its far before
    last_near (every descendant's near is at most its far)."""
    from gfxexp_torch.accel.skiplink import COUNT_SHIFT

    nodes, perm = bvh.skip.node_pack, bvh.perm
    n = o.shape[0]
    dev = o.device
    m = bvh.skip.num_nodes
    inv_d = _safe_inv_d(d)
    t_min = _rays(t_min, n, dev)
    # the packed node rows (lo, hi, first | count << 24, skip; row m an
    # empty sentinel whose skip is m): one gather a step
    cur = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_near = torch.full((n,), torch.inf, device=dev)
    best_id = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=dev)
    best_far = torch.full((n,), -torch.inf, device=dev)
    step = 0
    while True:
        if step % BVH_SYNC_EVERY == 0 and not _any(cur < m):
            break
        step += 1
        trace.count("tfdm.bvh_iterations")
        rows = nodes[cur]
        meta = rows[:, 6:8].contiguous().view(torch.int32)
        cnt = meta[:, 0] >> COUNT_SHIFT
        t0 = (rows[:, 0:3] - o) * inv_d
        t1 = (rows[:, 3:6] - o) * inv_d
        near = torch.maximum(torch.minimum(t0, t1).amax(-1), t_min)
        far = torch.minimum(torch.maximum(t0, t1).amin(-1), t_cap)
        active = cur < m
        overlap = active & (near <= far)
        # node pruning, conservative on ties (<=, >= keep the tie paths)
        explore = overlap & (near <= best_near) & (far >= last_near)
        is_leaf = cnt > 0
        oid = perm[meta[:, 0] & ((1 << COUNT_SHIFT) - 1)]
        after = (near > last_near) | ((near == last_near) & (oid > last_id))
        valid = explore & is_leaf & after & (near < t_cap)
        better = valid & ((near < best_near)
                          | ((near == best_near) & (oid < best_id)))
        best_near = torch.where(better, near, best_near)
        best_id = torch.where(better, oid, best_id)
        best_far = torch.where(better, far, best_far)
        # descend, else skip past the subtree; row m keeps a finished ray
        cur = torch.where(explore & ~is_leaf, cur + 1, meta[:, 1])
    found = torch.isfinite(best_near)
    return (torch.where(found, best_id, -1).to(torch.int32), best_near,
            best_far)


def iterate_candidates(aabb_min, aabb_max, o, d, t_min, t_max, k, state0,
                       process_fn, get_best_t, max_extra: int = None,
                       prism_bvh: Optional[PrismBVH] = None):
    """Drive a narrow phase `process_fn` over each ray's prism-AABB
    candidates nearest first, until no unprocessed entry lies nearer than
    the ray's best hit. The first `k` candidates come from one top-k broad
    phase; later rounds rescan (each round moves every ray's (near, id)
    cursor strictly forward, so the default max_extra, the prism count,
    never cuts a ray short). With a prism BVH every candidate comes from
    its walk. A rescan tests only the rays that still need a candidate
    (the others would find none: their cap is -1).

    process_fn(state, cand_id [R] (-1 = none), near [R], far [R]) -> state;
    get_best_t(state) -> [R]."""
    n = o.shape[0]
    dev = o.device
    if max_extra is None:
        max_extra = int(aabb_min.shape[0])
    if prism_bvh is not None:
        k = 0  # every candidate comes from the walk
        ids = nears = fars = None
    else:
        ids, nears, fars = _broad_phase(aabb_min, aabb_max, o, d, t_min,
                                        t_max, k)
    t_min_v = _rays(t_min, n, dev)
    state = state0
    last_near = torch.full((n,), -torch.inf, device=dev)
    last_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    exhausted = torch.zeros((n,), dtype=torch.bool, device=dev)
    idx = 0
    while True:
        best_t = get_best_t(state)
        if idx < k:
            cid, cnr, cfr = ids[:, idx], nears[:, idx], fars[:, idx]
        else:
            if idx >= k + max_extra:
                break
            sel = _select(~exhausted & (last_near < best_t))
            if sel.numel() == 0:
                break
            args = (o[sel], d[sel], t_min_v[sel], best_t[sel],
                    last_near[sel], last_id[sel])
            if prism_bvh is not None:
                found = _next_candidate_bvh(prism_bvh, *args)
            else:
                found = _next_candidate_scan(aabb_min, aabb_max, *args)
            cid = torch.full((n,), -1, dtype=torch.int32,
                             device=dev).index_put((sel,), found[0])
            cnr = torch.full((n,), torch.inf, device=dev).index_put(
                (sel,), found[1])
            cfr = torch.full((n,), -torch.inf, device=dev).index_put(
                (sel,), found[2])
        trace.count("tfdm.rounds")
        live = (cid >= 0) & (cnr < best_t)
        state = process_fn(state, torch.where(live, cid, -1), cnr, cfr)
        # a round without a candidate means none will follow
        exhausted = exhausted | ~live
        last_near = torch.where(live, cnr, last_near)
        last_id = torch.where(live, cid, last_id)
        idx += 1
    return state




class _Levels(NamedTuple):
    """The pyramid levels a march step consults, coarse to fine, packed
    for one gather over all of them: `flat` [sum size^2, 2] and per level
    ([L, 1]) its offset and size in `flat`, its block of base texels,
    d(grid)/d(uv) and the progress floor's 0.05 / scale_g."""

    flat: torch.Tensor
    offset: torch.Tensor  # int64
    size: torch.Tensor  # int64
    blk: torch.Tensor  # float32
    scale_g: torch.Tensor
    floor_c: torch.Tensor


def _levels(geom: TFDMGeometry, coarse_size, mid_size, fine_size,
            full_pyramid) -> _Levels:
    """full_pyramid takes every level from coarse_size up to the map
    itself; else the three sizes given (each clamped to the map, repeats
    dropped)."""
    s = geom.height.shape[0]
    if full_pyramid:
        wants = []
        wsz = min(max(int(coarse_size), 1), s)
        while wsz <= s:
            wants.append(wsz)
            wsz *= 2
    else:
        wants = (coarse_size, mid_size, fine_size)
    parts, sizes, seen = [], [], set()
    for want in wants:
        wsz = min(max(int(want), 1), s)
        lvl = max(s.bit_length() - wsz.bit_length(), 0)
        sz = s >> lvl
        if sz in seen:
            continue
        seen.add(sz)
        sizes.append(sz)
        parts.append(geom.minmax.levels[lvl, :sz, :sz, :].reshape(-1, 2))
    offsets = np.cumsum([0] + [sz * sz for sz in sizes[:-1]])
    blks = [s // sz for sz in sizes]
    dev = geom.height.device

    def col(vals, dtype):
        return torch.tensor(vals, dtype=dtype).reshape(-1, 1).to(dev)

    return _Levels(
        flat=torch.cat(parts), offset=col(offsets, torch.int64),
        size=col(sizes, torch.int64), blk=col(blks, torch.float32),
        scale_g=col([s / b for b in blks], torch.float32),
        floor_c=col([0.05 / (s / b) for b in blks], torch.float32))


class _Prisms(NamedTuple):
    """Each ray's candidate prism ([R, ...] rows): the ray, the base
    triangle, its face normal turned toward the vertex normals, the Gram
    terms of its barycentric solve, and its uvs and vertex normals."""

    o: torch.Tensor
    d: torch.Tensor
    p0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    fn: torch.Tensor
    d00: torch.Tensor
    d01: torch.Tensor
    d11: torch.Tensor
    det: torch.Tensor
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor


def _uv_of(pr: _Prisms, params, t):
    """The texture-space uv of the ray points at t ([..., R]: the leading
    axes evaluate several t per ray at once) and their shell coordinates
    (b1, b2, w, height along the face normal)."""
    x = pr.o + t[..., None] * pr.d
    rel = x - pr.p0
    h = dot(rel, pr.fn)
    q = rel - h[..., None] * pr.fn
    qa = dot(q, pr.e1)
    qb = dot(q, pr.e2)
    b1 = (pr.d11 * qa - pr.d01 * qb) / pr.det
    b2 = (pr.d00 * qb - pr.d01 * qa) / pr.det
    w = 1.0 - b1 - b2
    uv = (w[..., None] * pr.uv0 + b1[..., None] * pr.uv1
          + b2[..., None] * pr.uv2)
    return _uv_transform(params, uv), b1, b2, w, h


def _gap(pr: _Prisms, height, params, uv, b1, b2, w, h):
    """The ray's height above the displaced surface along the face normal
    (shell height minus the displaced height times the shading normal's
    tilt) and whether the point lies over the base triangle."""
    hf = _displace(params, _sample_height_at(height, params, uv))
    nsh = _unit(w[..., None] * pr.n0 + b1[..., None] * pr.n1
                + b2[..., None] * pr.n2)
    cos_t = torch.clamp(dot(nsh, pr.fn), min=1e-3)
    inside = (b1 >= -1e-3) & (b2 >= -1e-3) & (w >= -1e-3)
    return h - hf * cos_t, inside


def _exit_axis(g_, dg_):
    """Distance in t to the next grid line along one axis (inf when the
    ray does not move along it)."""
    cell = torch.floor(g_)
    nxt = torch.where(dg_ > 0, cell + 1.0, cell)
    small = torch.abs(dg_) < 1e-9
    dist = (nxt - g_) / torch.where(small,
                                    torch.where(dg_ < 0, -1e-9, 1e-9), dg_)
    return torch.where(small, torch.inf, torch.clamp(dist, min=0.0))


def intersect_tfdm_v2(geom: TFDMGeometry, o, d, t_min=1e-4, t_max=1e30,
                      k_candidates: int = 4, max_steps: int = 128,
                      n_refine: int = 8, coarse_size: int = 16,
                      mid_size: int = 64, fine_size: int = 256,
                      full_pyramid: bool = True,
                      conservative: bool = True) -> TFDMHit:
    """Pyramid-guided displaced-surface intersection, vectorized over rays.

    Candidates stream nearest first until the next prism AABB lies past
    the best hit (iterate_candidates). In each prism a loop walks the ray:
    at each position the (epsilon-widened, displacement-mapped) min/max
    texel of every consulted pyramid level is tested against the ray's
    height span across that texel; empty space is skipped to the exit of
    the coarsest empty level. conservative=True (the default) resolves an
    occupied base texel exactly: the gap along the ray is quadratic inside
    one texel, so the quadratic through the gap at entry, middle and exit
    finds end-point sign changes and dips that cross and come back; the
    walk advances texel by texel. conservative=False marches occupied
    texels by fixed fine steps (half a base texel of uv travel). Then
    bisection. `steps` counts march steps per ray.

    The arithmetic is the JAX package's, op for op; values the JAX loop
    computes twice (the gap at a texel's entry is the previous step's gap
    at its exit) are computed once, and points evaluated together are
    stacked on a leading axis, which changes no result."""
    trace.count("tfdm.calls")
    n_rays = o.shape[0]
    dev = o.device
    s = geom.height.shape[0]
    p = geom.params
    height = geom.height
    lv = _levels(geom, coarse_size, mid_size, fine_size, full_pyramid)
    t_min_v = _rays(t_min, n_rays, dev)
    state0 = (
        _rays(t_max, n_rays, dev).clone(),  # best_t
        torch.full((n_rays,), -1, dtype=torch.int32, device=dev),
        torch.zeros((n_rays, 2), device=dev),  # best_uv
        torch.zeros((n_rays, 3), device=dev),  # best_nrm
        torch.zeros((n_rays,), dtype=torch.int32, device=dev),  # steps
    )
    half_texel = torch.full((1,), 0.5 / s, device=dev)
    eps = 1.0 / s

    def process(state, cid, near, far):
        best_t, best_prim, best_uv, best_nrm, steps_total = state
        far = torch.minimum(far, best_t)
        # the rays that march this round; the others keep their state
        sel = _select((cid >= 0) & (near < far))
        if sel.numel() == 0:
            return state
        m = sel.numel()
        cid, near, far, bt = cid[sel], near[sel], far[sel], best_t[sel]
        o_s, d_s = o[sel], d[sel]
        b = cid.to(torch.int64)
        p0, e1, e2 = geom.p0[b], geom.e1[b], geom.e2[b]
        n0v, n1v, n2v = geom.n0[b], geom.n1[b], geom.n2[b]
        fn = cross(e1, e2)
        fn = fn / torch.clamp(length(fn, keepdim=True), min=1e-20)
        fn = fn * torch.sign(dot(fn, n0v + n1v + n2v, keepdim=True) + 1e-12)
        # the least cosine of the vertex normals' tilt against the face
        # normal (the conservative displaced interval)
        ct_min = torch.clamp(torch.minimum(
            torch.minimum(dot(n0v, fn), dot(n1v, fn)), dot(n2v, fn)),
            1e-3, 1.0)
        d00, d01, d11 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
        pr = _Prisms(o_s, d_s, p0, e1, e2, fn, d00, d01, d11,
                     torch.clamp(d00 * d11 - d01 * d01, min=1e-20),
                     geom.uv0[b], geom.uv1[b], geom.uv2[b], n0v, n1v, n2v)
        dh_dt = dot(d_s, fn)  # the shell height is linear along the ray

        # the fine step: half a base texel of uv travel (bounded)
        span = far - near
        span_floor = torch.clamp(span, min=1e-6)
        ends = torch.stack([near, torch.minimum(near + span_floor, far)])
        uv_ends = _uv_of(pr, p, ends)[0]
        duv_span = uv_ends[1] - uv_ends[0]
        uv_rate = torch.sqrt(duv_span[:, 0] * duv_span[:, 0]
                             + duv_span[:, 1] * duv_span[:, 1]) / torch.clamp(
            span, min=1e-9)
        rate_floor = torch.clamp(uv_rate, min=1e-6)
        dt_fine = torch.clamp(half_texel / rate_floor, span * 1e-3 + 1e-7,
                              span_floor)
        dt_div = torch.clamp(dt_fine, min=1e-9)[:, None]

        def levels_test(t, uv, h, duv):
            """(occupied, t_exit) of the texel at uv, descending the
            consulted levels coarse to fine: occupied only where every
            level overlaps the ray's height span; t_exit is the exit of
            the coarsest empty level, else of the finest."""
            gx = (uv[:, 0] * s - 0.5) / lv.blk  # [L, R] grid coordinates
            gy = (uv[:, 1] * s - 0.5) / lv.blk
            xc = torch.remainder(torch.floor(gx).to(torch.int64), lv.size)
            yc = torch.remainder(torch.floor(gy).to(torch.int64), lv.size)
            mm = lv.flat[lv.offset + yc * lv.size + xc]  # [L, R, 2]
            c0 = _displace(p, mm[..., 0])
            c1 = _displace(p, mm[..., 1])
            dlo = torch.minimum(c0, c1)
            dhi = torch.maximum(c0, c1)
            # hull over the tilt range [ct_min, 1], widened by an epsilon
            margin = 1e-3 + 0.002 * (torch.abs(dhi) + torch.abs(dlo))
            ivlo = torch.minimum(dlo, dlo * ct_min) - margin
            ivhi = torch.maximum(dhi, dhi * ct_min) + margin
            tex_dt = torch.minimum(_exit_axis(gx, duv[:, 0] * lv.scale_g),
                                   _exit_axis(gy, duv[:, 1] * lv.scale_g))
            # progress floor: a fraction of this level's texel crossing
            floor_l = torch.minimum(lv.floor_c / rate_floor, span_floor)
            t_exit = torch.minimum(
                t + torch.maximum(tex_dt, torch.clamp(floor_l, min=1e-7))
                + 1e-7, far)
            h2 = h + dh_dt * (t_exit - t)
            occ = ((torch.minimum(h, h2) - 1e-4 <= ivhi)
                   & (torch.maximum(h, h2) + 1e-4 >= ivlo))
            occupied, out = occ[0], t_exit[0]
            for lvl in range(1, occ.shape[0]):
                out = torch.where(occupied, t_exit[lvl], out)
                occupied = occupied & occ[lvl]
            return occupied, out

        t = near
        found = torch.zeros((m,), dtype=torch.bool, device=dev)
        t_lo, t_hi = near, far
        running = torch.ones((m,), dtype=torch.bool, device=dev)
        steps = torch.zeros((m,), dtype=torch.int32, device=dev)
        if conservative:
            # at the loop's top: uv and shell coordinates at t, the gap
            # there, and uv at t + dt_fine
            uv2, b1, b2, w, h = _uv_of(pr, p, torch.stack([t, t + dt_fine]))
            uv, uv_eps = uv2[0], uv2[1]
            g_a = _gap(pr, height, p, uv, b1[0], b2[0], w[0], h[0])[0]
            h = h[0]
        else:
            t_prev = near
            gap_prev = torch.zeros((m,), device=dev)
            prev_valid = torch.zeros((m,), dtype=torch.bool, device=dev)
        while _any(running):
            trace.count("tfdm.march_iterations")
            steps = steps + running.to(torch.int32)
            if not conservative:
                uv2, b1, b2, w, h = _uv_of(pr, p,
                                           torch.stack([t, t + dt_fine]))
                uv, uv_eps = uv2[0], uv2[1]
                b1, b2, w, h = b1[0], b2[0], w[0], h[0]
            duv = (uv_eps - uv) / dt_div
            occupied, t_exit = levels_test(t, uv, h, duv)

            if conservative:
                # the exact quadratic through the gap at the base texel's
                # entry, middle and exit: an end-point sign change brackets
                # the span; else a dip whose true gap changes sign at the
                # vertex brackets [entry, vertex]. The next step starts at
                # the exit, so the exit's uv, gap and uv + dt_fine come
                # along for it.
                tb = t_exit
                tm = 0.5 * (t + tb)
                uv3, b13, b23, w3, h3 = _uv_of(
                    pr, p, torch.stack([tm, tb, tb + dt_fine]))
                g2, in2 = _gap(pr, height, p, uv3[:2], b13[:2], b23[:2],
                               w3[:2], h3[:2])
                g_m, g_b, in_b = g2[0], g2[1], in2[1]
                qa = 2.0 * g_a - 4.0 * g_m + 2.0 * g_b
                qb = -3.0 * g_a + 4.0 * g_m - g_b
                live = running & occupied & ~found
                cross_ends = live & in_b & (torch.sign(g_a)
                                            != torch.sign(g_b))
                qa_small = torch.abs(qa) < 1e-12
                tau_v = -qb / (2.0 * torch.where(qa_small, 1.0, qa))
                valid_v = ~qa_small & (tau_v > 0.0) & (tau_v < 1.0)
                t_v = t + torch.clamp(tau_v, 0.0, 1.0) * (tb - t)
                g_v, in_v = _gap(pr, height, p, *_uv_of(pr, p, t_v))
                cross_vert = (live & ~cross_ends & valid_v & in_v
                              & (torch.sign(g_v) != torch.sign(g_a)))
                crossing = cross_ends | cross_vert
                t_lo = torch.where(crossing, t, t_lo)
                t_hi = torch.where(cross_ends, tb,
                                   torch.where(cross_vert, t_v, t_hi))
                found = found | crossing
                running = (running & ~found & (t < far - 1e-7)
                           & (steps < max_steps))
                # t_exit <= far, so the next t of a running ray is tb
                t = torch.where(running, tb, t)
                uv, uv_eps, g_a, h = uv3[1], uv3[2], g_b, h3[1]
                continue

            gap, inside = _gap(pr, height, p, uv, b1, b2, w, h)
            crossing = (running & prev_valid & inside
                        & (torch.sign(gap_prev) != torch.sign(gap)))
            t_lo = torch.where(crossing & ~found, t_prev, t_lo)
            t_hi = torch.where(crossing & ~found, t, t_hi)
            found = found | crossing
            skip = running & ~occupied & ~found
            fine = running & occupied & ~found
            # clamp to far and still evaluate there: the crossing test runs
            # at the start of an iteration
            t_next = torch.minimum(torch.where(skip, t_exit, t + dt_fine),
                                   far)
            # continuity across fine steps only; `inside` gates the current
            # sample (the entry sample can sit an epsilon outside)
            prev_valid = fine
            gap_prev = gap
            t_prev = t
            running = (running & ~found & (t < far - 1e-7)
                       & (steps < max_steps))
            t = torch.where(running, t_next, t)
        steps_total = steps_total.index_add(0, sel, steps)
        if not _any(found):
            return best_t, best_prim, best_uv, best_nrm, steps_total

        gap_lo = _gap(pr, height, p, *_uv_of(pr, p, t_lo))[0]
        for _ in range(n_refine):
            t_mid = 0.5 * (t_lo + t_hi)
            gap_mid = _gap(pr, height, p, *_uv_of(pr, p, t_mid))[0]
            same = torch.sign(gap_mid) == torch.sign(gap_lo)
            t_lo, t_hi, gap_lo = (torch.where(same, t_mid, t_lo),
                                  torch.where(same, t_hi, t_mid),
                                  torch.where(same, gap_mid, gap_lo))
        t_hit = 0.5 * (t_lo + t_hi)

        take = found & (t_hit > t_min_v[sel]) & (t_hit < bt)
        uv_hit = _uv_of(pr, p, t_hit)[0]
        # the displaced surface's normal from the height gradient
        taps = torch.stack([uv_hit,
                            torch.stack([uv_hit[:, 0] + eps, uv_hit[:, 1]],
                                        -1),
                            torch.stack([uv_hit[:, 0], uv_hit[:, 1] + eps],
                                        -1)])
        h_c, h_u, h_v = _displace(p, _sample_height_at(height, p, taps))
        tan_u, tan_v = _tangents(e1, e2, pr.uv0, pr.uv1, pr.uv2)
        gu = (h_u - h_c) / eps
        gv = (h_v - h_c) / eps
        nrm = _unit(cross(tan_u + gu[:, None] * fn, tan_v + gv[:, None] * fn))
        nrm = nrm * torch.sign(dot(nrm, fn, keepdim=True) + 1e-12)

        best_prim = best_prim.index_put(
            (sel,), torch.where(take, cid, best_prim[sel]))
        best_uv = best_uv.index_put(
            (sel,), torch.where(take[:, None], uv_hit, best_uv[sel]))
        best_nrm = best_nrm.index_put(
            (sel,), torch.where(take[:, None], nrm, best_nrm[sel]))
        best_t = best_t.index_put((sel,), torch.where(take, t_hit, bt))
        return best_t, best_prim, best_uv, best_nrm, steps_total

    best_t, best_prim, best_uv, best_nrm, steps_total = iterate_candidates(
        geom.aabb_min, geom.aabb_max, o, d, t_min, t_max, k_candidates,
        state0, process, lambda st: st[0], prism_bvh=geom.prism_bvh)
    return TFDMHit(t=best_t, hit=best_prim >= 0,
                   position=o + best_t[:, None] * d, normal=best_nrm,
                   uv=best_uv, prim=best_prim, steps=steps_total)
