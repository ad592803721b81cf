"""Perlin noise and its multi-octave fBm sum (port of
gfxexp_tpu/core/noise.py; the reference's PerlinNoise3D and
MultiOctavePerlinNoise3D, used by the displacement demos).

Classic Perlin noise over [..., 3] points, with the JAX package's
permutation table (numpy's default_rng(1), so both packages hash alike).
"""

from __future__ import annotations

import numpy as np
import torch

_PERM_NP = None
_PERM = {}  # the table per device


def _perm_table(device) -> torch.Tensor:
    global _PERM_NP
    if _PERM_NP is None:
        rng = np.random.default_rng(1)  # a fixed table, as Perlin's classic
        p = rng.permutation(256)
        _PERM_NP = np.concatenate([p, p]).astype(np.int64)
    key = str(device)
    if key not in _PERM:
        _PERM[key] = torch.from_numpy(_PERM_NP).to(device)
    return _PERM[key]


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    """The classic 12-gradient scheme."""
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return (torch.where((h & 1) == 0, u, -u)
            + torch.where((h & 2) == 0, v, -v))


def perlin3d(p):
    """Perlin noise at points p [..., 3] float32; values about [-1, 1]."""
    perm = _perm_table(p.device)
    pf = torch.floor(p)
    pi = pf.to(torch.int32).to(torch.int64) & 255
    d = p - pf
    u = _fade(d[..., 0])
    v = _fade(d[..., 1])
    w = _fade(d[..., 2])
    x, y, z = pi[..., 0], pi[..., 1], pi[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    def corner(ox, oy, oz):
        h = perm[perm[perm[x + ox] + y + oy] + z + oz] & 15
        return _grad(h, dx - ox if ox else dx, dy - oy if oy else dy,
                     dz - oz if oz else dz)

    def lerp(a, b, t):
        return a + t * (b - a)

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    return lerp(
        lerp(lerp(c000, c100, u), lerp(c010, c110, u), v),
        lerp(lerp(c001, c101, u), lerp(c011, c111, u), v),
        w,
    )


def multi_octave_perlin3d(p, num_octaves: int = 4, persistence: float = 0.5,
                          frequency: float = 1.0):
    """The fBm sum of `num_octaves` octaves, normalised by the sum of their
    amplitudes (a divisor on p's device: CUDA divides by a Python number
    through its reciprocal, which rounds otherwise than the CPU)."""
    total = 0.0
    amplitude = 1.0
    freq = frequency
    norm = 0.0
    for _ in range(num_octaves):
        total = total + amplitude * perlin3d(p * freq)
        norm += amplitude
        amplitude *= persistence
        freq *= 2.0
    return total / torch.full((), norm, device=p.device)
