"""Vector math over batched `[..., 3]` tensors (port of the parts of
gfxexp_tpu/core/math.py the path tracer uses).

Reductions over the 3 components are written out as `a*b + c*d + e*f`, so
the CPU and the CUDA device round them in the same order.
"""

from __future__ import annotations

import numpy as np
import torch


def dot(a, b, keepdim=False):
    s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return s.unsqueeze(-1) if keepdim else s


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def length(v, keepdim=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=0.0))


def normalize(v, eps=1e-20):
    return v * (1.0 / torch.sqrt(torch.clamp(dot(v, v, keepdim=True),
                                             min=eps)))


def luminance(rgb):
    """Rec.709 luminance."""
    return (rgb[..., 0] * 0.2126729 + rgb[..., 1] * 0.7151522
            + rgb[..., 2] * 0.0721750)


def safe_divide(a, b, eps=0.0):
    return torch.where(b != 0.0, a / torch.where(b == 0.0, 1.0, b), eps)


def make_frame(n):
    """Branchless orthonormal basis from a unit normal (Duff et al. 2017);
    returns (tangent, bitangent) with (t, b, n) right-handed."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]],
                     dim=-1)
    return t, bt


def to_local(t, b, n, v):
    """World direction -> frame-local (z = normal)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(t, b, n, v):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


_RAY_ORG_INT_SCALE = 256.0
_RAY_ORG_FLOAT_SCALE = 1.0 / 65536.0
_RAY_ORG_ORIGIN = 1.0 / 32.0


def offset_ray_origin(p, n):
    """Offset `p` along the geometric normal `n` against self-intersection
    (integer-ulp offset away from the origin, float offset near it)."""
    int_off = n * _RAY_ORG_INT_SCALE
    pi = p.view(torch.int32)
    pi_off = pi + torch.where(p < 0.0, -int_off, int_off).to(torch.int32)
    p_int = pi_off.view(torch.float32)
    p_float = p + _RAY_ORG_FLOAT_SCALE * n
    return torch.where(torch.abs(p) < _RAY_ORG_ORIGIN, p_float, p_int)


def concentric_sample_disk(u0, u1):
    r0 = 2.0 * u0 - 1.0
    r1 = 2.0 * u1 - 1.0
    use_r0 = torch.abs(r0) > torch.abs(r1)
    r = torch.where(use_r0, r0, r1)
    safe = torch.where(r == 0.0, 1.0, r)
    theta = torch.where(use_r0, (np.pi / 4.0) * (r1 / safe),
                        (np.pi / 2.0) - (np.pi / 4.0) * (r0 / safe))
    theta = torch.where(r == 0.0, 0.0, theta)
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_sample_hemisphere(u0, u1):
    """Local direction [..., 3] with z >= 0, pdf = z / pi."""
    x, y = concentric_sample_disk(u0, u1)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def np_normalize(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1e-20)


def rotate(m, v):
    """The 3x3 part of per-row 3x4 matrices m [R, 3, 4] applied to v [R, 3]
    (the JAX package's einsum("nij,nj->ni") at full float32 precision)."""
    return (m[:, :, :3] * v[:, None, :]).sum(-1)
