"""Importance-sampling distributions (port of
gfxexp_tpu/core/distributions.py): discrete CDFs built on the device and
sampled by a search, Walker alias tables built on the host (Vose, O(n)) and
sampled by one gather, the 2D piecewise-constant distribution that samples
the environment light, and the hierarchical probability texture.

Host builders return CPU containers that `.to(device)` moves; the samplers
and `build_discrete_1d` follow their inputs' device.

A prefix sum rounds differently on every backend. The port accumulates its
CDF in float64 and rounds it once, on every device (as PyTorch's CPU
`cumsum` does for float32); XLA's scan runs in float32 in an order of its
own. So a CDF built here agrees with the JAX package's to a few ulps, not
bit for bit, and a uniform within that distance of a CDF edge may pick the
neighbouring item.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gfxexp_torch.core.tensors import TensorData


@dataclass
class DiscreteDistribution1D(TensorData):
    """Discrete PMF over n items: `cdf` [..., n + 1] with cdf[0] = 0 and
    cdf[n] = 1, `pmf` [..., n] normalised, `integral` [...] the sum of the
    raw weights."""

    pmf: torch.Tensor
    cdf: torch.Tensor
    integral: torch.Tensor

    @property
    def size(self):
        return self.pmf.shape[-1]


def build_discrete_1d(weights) -> DiscreteDistribution1D:
    """Build from non-negative weights [..., n], on their device."""
    w = torch.clamp(torch.as_tensor(weights, dtype=torch.float32), min=0.0)
    integral = w.sum(dim=-1)
    safe = torch.where(integral > 0.0, integral, 1.0)
    pmf = w / safe[..., None]
    # prefix sums accumulated in float64 and rounded once, as PyTorch's CPU
    # cumsum forms them (CUDA's float32 scan associates each prefix its own
    # way: it can step down, or give an empty item a bin of an ulp)
    prefix = torch.cumsum(pmf, dim=-1, dtype=torch.float64).to(pmf.dtype)
    # an empty item's edge repeats the one before it, so that it is never
    # picked, and the CDF never decreases
    prefix = torch.cummax(torch.where(pmf > 0.0, prefix, 0.0), dim=-1).values
    cdf = torch.cat([torch.zeros_like(pmf[..., :1]), prefix], dim=-1)
    # exactly 1.0 at the end, so that the search stays in range
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1e-20)
    return DiscreteDistribution1D(pmf=pmf, cdf=cdf, integral=integral)


def sample_discrete_1d(dist: DiscreteDistribution1D, u):
    """Item indices for uniforms u [...] in [0, 1) of a 1D distribution:
    the last i with cdf[i] <= u, so an empty item is never picked. Returns
    (index int64, pmf)."""
    idx = torch.searchsorted(dist.cdf, u, right=True) - 1
    idx = torch.clamp(idx, 0, dist.size - 1)
    return idx, dist.pmf[idx]


def sample_discrete_1d_remapped(dist: DiscreteDistribution1D, u):
    """sample_discrete_1d, and the uniform remapped into the chosen item's
    bin (reused downstream as a fresh uniform). Returns (index, pmf,
    u_remapped in [0, 1))."""
    idx, pmf = sample_discrete_1d(dist, u)
    lo = dist.cdf[idx]
    width = dist.cdf[idx + 1] - lo
    u_re = torch.where(width > 0.0,
                       (u - lo) / torch.where(width > 0.0, width, 1.0), 0.0)
    return idx, pmf, torch.clamp(u_re, 0.0, 1.0 - 1e-7)


# ---------------------------------------------------------------------------
# Walker alias method
# ---------------------------------------------------------------------------


@dataclass
class AliasTable(TensorData):
    pmf: torch.Tensor  # [n] float32
    prob: torch.Tensor  # [n] float32 probability of keeping the bucket's item
    alias: torch.Tensor  # [n] int32 the bucket's other item
    integral: torch.Tensor  # [] float32


def vose_alias_arrays(weights: np.ndarray):
    """Host-side O(n) Vose construction; returns numpy (pmf, prob, alias,
    integral)."""
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    n = w.shape[0]
    integral = w.sum()
    if integral <= 0.0:
        p = np.full(n, 1.0 / n)
    else:
        p = w / integral
    scaled = p * n
    prob = np.ones(n)
    alias = np.arange(n)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return p, prob, alias, integral


def build_alias_table(weights: np.ndarray) -> AliasTable:
    """Vose's O(n) construction from non-negative weights [n], on the host;
    the table's tensors lie on the CPU."""
    p, prob, alias, integral = vose_alias_arrays(weights)
    return AliasTable(pmf=torch.from_numpy(p.astype(np.float32)),
                      prob=torch.from_numpy(prob.astype(np.float32)),
                      alias=torch.from_numpy(alias.astype(np.int32)),
                      integral=torch.tensor(np.float32(integral)))


def sample_alias(table: AliasTable, u):
    """O(1) sampling of uniforms u [...] in [0, 1): bucket int(u * n), kept
    when the fraction left is below its prob, else its alias. Returns
    (index int32, pmf)."""
    n = table.pmf.shape[0]
    scaled = u * n
    bucket = torch.clamp(scaled.to(torch.int32), 0, n - 1)
    frac = scaled - bucket.to(torch.float32)
    keep = frac < table.prob[bucket]
    idx = torch.where(keep, bucket, table.alias[bucket])
    return idx, table.pmf[idx]


@dataclass
class Continuous2D(TensorData):
    """Piecewise-constant 2D pdf over [0,1]^2 from an importance image [H, W]:
    conditional_cdf [H, W+1], marginal_cdf [H+1], pdf [H, W]."""

    conditional_cdf: torch.Tensor
    marginal_cdf: torch.Tensor
    pdf: torch.Tensor
    integral: torch.Tensor


def build_continuous_2d(importance) -> Continuous2D:
    imp = torch.clamp(torch.as_tensor(importance, dtype=torch.float32),
                      min=0.0)
    h, w = imp.shape
    row_sum = imp.sum(dim=1)
    total = row_sum.sum()
    safe_rows = torch.where(row_sum > 0.0, row_sum, 1.0)
    cond_pmf = imp / safe_rows[:, None]
    cond_cdf = torch.cat([torch.zeros((h, 1)), torch.cumsum(cond_pmf, dim=1)],
                         dim=1)
    cond_cdf = cond_cdf / torch.clamp(cond_cdf[:, -1:], min=1e-20)
    safe_total = torch.where(total > 0.0, total, 1.0)
    marg_pmf = row_sum / safe_total
    marg_cdf = torch.cat([torch.zeros(1), torch.cumsum(marg_pmf, dim=0)])
    marg_cdf = marg_cdf / torch.clamp(marg_cdf[-1:], min=1e-20)
    pdf = (marg_pmf[:, None] * cond_pmf) * float(h * w)
    return Continuous2D(conditional_cdf=cond_cdf, marginal_cdf=marg_cdf,
                        pdf=pdf, integral=total / float(h * w))


def _rowwise_searchsorted(cdf_rows, u):
    """Binary search where each lane has its own row: largest i with
    cdf_rows[..., i] <= u. cdf_rows: [..., W+1], u: [...]."""
    wp1 = cdf_rows.shape[-1]
    lo = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    hi = torch.full(u.shape, wp1 - 1, dtype=torch.int64, device=u.device)
    for _ in range(int(np.ceil(np.log2(max(wp1, 2))))):
        mid = (lo + hi) // 2
        mid_val = torch.gather(cdf_rows, -1, mid[..., None])[..., 0]
        go_right = mid_val <= u
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def sample_continuous_2d(dist: Continuous2D, u0, u1):
    """Sample (u, v) in [0,1)^2 plus density: u0 picks the row (v axis), u1
    the column (u axis)."""
    h, w = dist.pdf.shape
    row = torch.clamp(torch.searchsorted(dist.marginal_cdf, u0, right=True)
                      - 1, 0, h - 1)
    row_lo = dist.marginal_cdf[row]
    row_w = dist.marginal_cdf[row + 1] - row_lo
    dv = torch.where(row_w > 0.0,
                     (u0 - row_lo) / torch.where(row_w > 0.0, row_w, 1.0), 0.5)
    cond = dist.conditional_cdf[row]  # [..., W+1]
    col = torch.clamp(_rowwise_searchsorted(cond, u1), 0, w - 1)
    col_lo = torch.gather(cond, -1, col[..., None])[..., 0]
    col_hi = torch.gather(cond, -1, col[..., None] + 1)[..., 0]
    col_w = col_hi - col_lo
    du = torch.where(col_w > 0.0,
                     (u1 - col_lo) / torch.where(col_w > 0.0, col_w, 1.0), 0.5)
    u = (col.to(torch.float32) + du) / w
    v = (row.to(torch.float32) + dv) / h
    return u, v, dist.pdf[row, col]


def continuous_2d_pdf(dist: Continuous2D, u, v):
    """Density at (u, v) in [0,1)^2."""
    h, w = dist.pdf.shape
    col = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    row = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return dist.pdf[row, col]


# ---------------------------------------------------------------------------
# hierarchical probability texture: a sum-mip pyramid sampled by quad
# descent, the alternative to a CDF search for the light units
# ---------------------------------------------------------------------------


@dataclass
class ProbabilityTexture(TensorData):
    """A power-of-two weight image and its sum-mip pyramid: level l is
    [S >> l, S >> l], stored padded in one [L, S, S] tensor."""

    levels: torch.Tensor  # [L, S, S] float32
    integral: torch.Tensor  # []
    size: int = 0
    n_levels: int = 0


def build_probability_texture(weights) -> ProbabilityTexture:
    """Build from a square power-of-two weight image (host, float64 sums)."""
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    s = w.shape[0]
    if w.shape != (s, s) or s & (s - 1):
        raise ValueError(f"expected a square power-of-two image, got "
                         f"{w.shape}")
    levels = [w]
    while levels[-1].shape[0] > 1:
        m = levels[-1]
        levels.append(m[0::2, 0::2] + m[1::2, 0::2] + m[0::2, 1::2]
                      + m[1::2, 1::2])
    padded = np.zeros((len(levels), s, s), np.float64)
    for l, lv in enumerate(levels):
        padded[l, :lv.shape[0], :lv.shape[1]] = lv
    return ProbabilityTexture(
        levels=torch.from_numpy(padded.astype(np.float32)),
        integral=torch.tensor(np.float32(levels[-1][0, 0])),
        size=s, n_levels=len(levels))


def sample_probability_texture(pt: ProbabilityTexture, u0, u1):
    """Mip descent: at each level pick one of the 4 children in proportion
    to its weight (x first, then y within the column), remapping the
    uniforms. Returns (ix, iy, pmf, u0, u1): the texel of the finest level,
    its normalised probability and the remapped uniforms."""
    ix = torch.zeros(u0.shape, dtype=torch.int64, device=u0.device)
    iy = torch.zeros_like(ix)
    for level in range(pt.n_levels - 2, -1, -1):
        x0 = 2 * ix
        y0 = 2 * iy
        lv = pt.levels[level]
        w00 = lv[y0, x0]
        w10 = lv[y0, x0 + 1]
        w01 = lv[y0 + 1, x0]
        w11 = lv[y0 + 1, x0 + 1]
        total = torch.clamp(w00 + w10 + w01 + w11, min=1e-30)
        p_left = (w00 + w01) / total
        go_right = u0 >= p_left
        u0 = torch.where(go_right,
                         (u0 - p_left) / torch.clamp(1.0 - p_left, min=1e-20),
                         u0 / torch.clamp(p_left, min=1e-20))
        u0 = torch.clamp(u0, 0.0, 1.0 - 1e-7)
        top = torch.where(go_right, w10, w00)
        bot = torch.where(go_right, w11, w01)
        col = torch.clamp(top + bot, min=1e-30)
        p_top = top / col
        go_down = u1 >= p_top
        u1 = torch.where(go_down,
                         (u1 - p_top) / torch.clamp(1.0 - p_top, min=1e-20),
                         u1 / torch.clamp(p_top, min=1e-20))
        u1 = torch.clamp(u1, 0.0, 1.0 - 1e-7)
        ix = x0 + go_right.to(torch.int64)
        iy = y0 + go_down.to(torch.int64)
    return ix, iy, probability_texture_pmf(pt, ix, iy), u0, u1


def probability_texture_pmf(pt: ProbabilityTexture, ix, iy):
    return pt.levels[0][iy, ix] / torch.clamp(pt.integral, min=1e-30)
