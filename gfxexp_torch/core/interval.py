"""Interval and affine arithmetic on float32 tensors (port of
gfxexp_tpu/core/interval.py).

The reference rounds each bound outward with directed rounding; here, as in
the JAX package, every operation widens its result outward by a couple of
float32 ulps instead (`_widen`), so the bounds stay conservative supersets.

- Intervals are (lo, hi) tensor pairs; each operation returns a widened
  pair.
- Affine forms are (c0, cs, r): value = c0 + sum_k cs[..., k] * e_k + r * e,
  with independent noise symbols e_k in [-1, 1] and a condensed extra term
  r >= 0. Quantities that share noise symbols stay correlated to first
  order: (h - h) is 0 exactly, where plain intervals give [-w, w].

Used by the curved-ray bound of NRTDSM (techniques/nrtdsm.py
`nonlinear_ray_vs_aabb`). Plain functions on tensors, on whichever device
holds them.
"""

from __future__ import annotations

import torch

from gfxexp_torch.core.math import sqrt_rn

# one operation's outward widening: a couple of float32 ulps
_EPS_REL = 3e-7
_EPS_ABS = 1e-37


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _widen(lo, hi):
    w = _EPS_REL * torch.maximum(torch.abs(lo), torch.abs(hi)) + _EPS_ABS
    return lo - w, hi + w


# ---------------------------------------------------------------------------
# intervals
# ---------------------------------------------------------------------------


def iv(lo, hi=None):
    lo = _f32(lo)
    hi = lo if hi is None else _f32(hi)
    return lo, hi


def iv_add(a, b):
    return _widen(a[0] + b[0], a[1] + b[1])


def iv_sub(a, b):
    return _widen(a[0] - b[1], a[1] - b[0])


def iv_neg(a):
    return -a[1], -a[0]


def iv_mul(a, b):
    p = torch.stack(torch.broadcast_tensors(a[0] * b[0], a[0] * b[1],
                                            a[1] * b[0], a[1] * b[1]))
    return _widen(p.amin(0), p.amax(0))


def iv_scale(a, s):
    lo, hi = a[0] * s, a[1] * s
    return _widen(torch.minimum(lo, hi), torch.maximum(lo, hi))


def iv_sqr(a):
    lo = torch.where((a[0] <= 0.0) & (a[1] >= 0.0), 0.0,
                     torch.minimum(a[0] * a[0], a[1] * a[1]))
    hi = torch.maximum(a[0] * a[0], a[1] * a[1])
    return _widen(lo, hi)


def iv_recip(a):
    """1/[a]; where 0 lies in [a] the bounds are -inf and +inf, which stays
    conservative for overlap tests."""
    straddles = (a[0] <= 0.0) & (a[1] >= 0.0)
    lo = torch.where(straddles, -torch.inf, 1.0 / a[1])
    hi = torch.where(straddles, torch.inf, 1.0 / a[0])
    return _widen(lo, hi)


def iv_sqrt(a):
    return _widen(sqrt_rn(torch.clamp(a[0], min=0.0)),
                  sqrt_rn(torch.clamp(a[1], min=0.0)))


def iv_overlaps(a, b):
    return (a[0] <= b[1]) & (a[1] >= b[0])


# ---------------------------------------------------------------------------
# affine forms: (c0, cs [..., K], r)
# ---------------------------------------------------------------------------


def aa_const(v, n_syms: int):
    v = _f32(v)
    return (v, torch.zeros(v.shape + (n_syms,), dtype=torch.float32,
                           device=v.device), torch.zeros_like(v))


def aa_var(lo, hi, sym: int, n_syms: int):
    """The affine form of [lo, hi] on noise symbol `sym`."""
    lo, hi = _f32(lo), _f32(hi)
    c0 = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    cs = torch.zeros(c0.shape + (n_syms,), dtype=torch.float32,
                     device=c0.device)
    cs[..., sym] = half
    return c0, cs, torch.zeros_like(c0)


def aa_add(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2] + _EPS_REL * (
        torch.abs(a[0]) + torch.abs(b[0]))


def aa_sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] + b[2] + _EPS_REL * (
        torch.abs(a[0]) + torch.abs(b[0]))


def aa_scale(a, s):
    s = _f32(s).to(a[0].device)
    return (a[0] * s, a[1] * s[..., None],
            a[2] * torch.abs(s) + _EPS_REL * torch.abs(a[0] * s))


def aa_rad(a):
    """The total deviation radius."""
    return torch.abs(a[1]).sum(-1) + a[2]


def aa_mul(a, b):
    """First-order affine product: the cross deviation terms condense into
    r."""
    c0 = a[0] * b[0]
    cs = a[0][..., None] * b[1] + b[0][..., None] * a[1]
    r = (torch.abs(a[0]) * b[2] + torch.abs(b[0]) * a[2]
         + aa_rad(a) * aa_rad(b))
    return c0, cs, r + _EPS_REL * torch.abs(c0)


def aa_sqr(a):
    """A tighter square: the e_k^2 self-terms lie in [0, 1], which halves
    the quadratic radius of aa_mul(a, a)."""
    c0 = a[0] * a[0]
    cs = 2.0 * a[0][..., None] * a[1]
    rad = aa_rad(a)
    r = rad * rad * 0.5
    return (c0 + r, cs,
            r + a[2] * (2.0 * torch.abs(a[0])) + _EPS_REL * torch.abs(c0))


def aa_to_iv(a):
    rad = aa_rad(a)
    return _widen(a[0] - rad, a[0] + rad)


def aa_poly2(c2, c1, c0v, x):
    """c2 x^2 + c1 x + c0 of an affine x, with tensor coefficients."""
    n = x[1].shape[-1]
    x2 = aa_sqr(x)
    return aa_add(aa_add(aa_scale(x2, c2), aa_scale(x, c1)),
                  aa_const(torch.broadcast_to(_f32(c0v).to(x[0].device),
                                              x[0].shape), n))
