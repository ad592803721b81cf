"""Vector, transform, sampling and colour math over batched `[..., 3]`
tensors (port of gfxexp_tpu/core/math.py).

Reductions over the 3 components are written out as `a*b + c*d + e*f`, so
the CPU and the CUDA device round them in the same order; the 3x3 products
are written out per component in float32 (JAX's precision=HIGHEST, with no
TF32). Functions follow their inputs' device; those that make a tensor from
Python values only (`identity_transform`, `make_transform`) take a
`device`, None for torch's default.
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


def sqrt_rn(x):
    """The correctly rounded float32 square root on every device: PyTorch's
    vectorized CPU kernel rounds about 1 in 150 float32 roots the other way
    (XLA's, numpy's and CUDA's do not), so on the CPU the root is taken in
    float64 and rounded once (exact for a square root)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


def length_rn(v, keepdim=False):
    """length() with the correctly rounded root (sqrt_rn)."""
    return sqrt_rn(torch.clamp(dot(v, v, keepdim=keepdim), min=0.0))


def length(v, keepdim=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=0.0))


def sq_length(v, keepdim=False):
    return dot(v, v, keepdim=keepdim)


def normalize(v, eps=1e-20):
    return v * (1.0 / torch.sqrt(torch.clamp(dot(v, v, keepdim=True),
                                             min=eps)))


def reflect(v, n):
    """Reflect direction `v` about normal `n` (both pointing away from the
    surface)."""
    return 2.0 * dot(v, n, keepdim=True) * n - v


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


# ---------------------------------------------------------------------------
# octahedral normal encoding
# ---------------------------------------------------------------------------


def octahedral_encode(n):
    """Unit vector [..., 3] -> octahedral [..., 2] in [-1, 1]."""
    denom = torch.abs(n[..., 0]) + torch.abs(n[..., 1]) + torch.abs(n[..., 2])
    p = n[..., :2] / torch.clamp(denom, min=1e-20)[..., None]
    flip = (1.0 - torch.abs(p.flip(-1))) * torch.where(p >= 0.0, 1.0, -1.0)
    return torch.where(n[..., 2:3] < 0.0, flip, p)


def octahedral_decode(e):
    """Octahedral [..., 2] -> unit vector [..., 3]."""
    z = 1.0 - torch.abs(e[..., 0]) - torch.abs(e[..., 1])
    t = torch.clamp(-z, min=0.0)
    xy = e - torch.where(e >= 0.0, 1.0, -1.0) * t[..., None]
    return normalize(torch.stack([xy[..., 0], xy[..., 1], z], dim=-1))


# ---------------------------------------------------------------------------
# AABB helpers
# ---------------------------------------------------------------------------


def aabb_union(mins_a, maxs_a, mins_b, maxs_b):
    return torch.minimum(mins_a, mins_b), torch.maximum(maxs_a, maxs_b)


def aabb_surface_area(mins, maxs):
    d = torch.clamp(maxs - mins, min=0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def ray_aabb_intersect(o, inv_d, t_min, t_max, box_min, box_max):
    """Slab test. o, inv_d [..., 3]; box_min, box_max broadcastable to
    [..., 3]; t_min, t_max numbers or tensors broadcastable to [...].
    Returns (hit [...], t_near [...]) with t_near clamped to t_min."""
    t0 = (box_min - o) * inv_d
    t1 = (box_max - o) * inv_d
    t_lo = torch.minimum(t0, t1)
    t_hi = torch.maximum(t0, t1)
    lo = torch.maximum(torch.maximum(t_lo[..., 0], t_lo[..., 1]), t_lo[..., 2])
    hi = torch.minimum(torch.minimum(t_hi[..., 0], t_hi[..., 1]), t_hi[..., 2])
    near = torch.maximum(lo, torch.as_tensor(t_min, dtype=lo.dtype,
                                             device=lo.device))
    far = torch.minimum(hi, torch.as_tensor(t_max, dtype=hi.dtype,
                                            device=hi.device))
    return near <= far, near


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


def uniform_sample_sphere(u0, u1):
    z = 1.0 - 2.0 * u0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * np.pi * u1
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def power_heuristic(pdf_a, pdf_b):
    """Power heuristic (beta = 2) MIS weight of strategy a; 0 where both
    pdfs are 0."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return safe_divide(a2, a2 + b2)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def simple_tonemap(c):
    """Reinhard-style tonemap by luminance for SDR output."""
    return c / (1.0 + luminance(c))[..., None]


def np_normalize(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1e-20)


def rotate(m, v):
    """The 3x3 part of per-row 3x4 matrices m [R, 3, 4] applied to v [R, 3]
    (the JAX package's einsum("nij,nj->ni") at full float32 precision)."""
    return (m[:, :, :3] * v[:, None, :]).sum(-1)


# ---------------------------------------------------------------------------
# affine transforms [..., 3, 4] (rotation | translation); sums written out so
# the CPU and the card round them alike
# ---------------------------------------------------------------------------


def _device_of(*xs):
    return next((x.device for x in xs if isinstance(x, torch.Tensor)), None)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def identity_transform(device=None):
    """The [3, 4] identity affine."""
    return torch.cat([torch.eye(3, device=device),
                      torch.zeros((3, 1), device=device)], dim=-1)


def make_transform(rotation=None, translation=None, scale=None,
                   device=None):
    """Compose scale, then rotation, then translation into a [3, 4] affine,
    on `device`, else on the device of a tensor argument."""
    if device is None:
        device = _device_of(rotation, translation, scale)
    r = (torch.eye(3, device=device) if rotation is None
         else _f32(rotation, device))
    if scale is not None:
        s = torch.broadcast_to(torch.atleast_1d(_f32(scale, device)), (3,))
        r = r * s[None, :]
    t = (torch.zeros(3, device=device) if translation is None
         else _f32(translation, device))
    return torch.cat([r, t[:, None]], dim=-1)


def transform_vector(m, v):
    """m [..., 3, 4] (or [..., 3, 3]), v [..., 3] -> the 3x3 part applied
    to v."""
    return torch.stack([m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
                        + m[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def transform_point(m, p):
    return transform_vector(m, p) + m[..., 3]


def transform_normal(m_inv, n):
    """A normal through the inverse transform's transpose."""
    return torch.stack([m_inv[..., 0, i] * n[..., 0]
                        + m_inv[..., 1, i] * n[..., 1]
                        + m_inv[..., 2, i] * n[..., 2] for i in range(3)],
                       dim=-1)


def compose_transforms(a, b):
    """The [..., 3, 4] affine that applies b first, then a."""
    r = torch.stack([torch.stack([
        a[..., i, 0] * b[..., 0, k] + a[..., i, 1] * b[..., 1, k]
        + a[..., i, 2] * b[..., 2, k] for k in range(3)], dim=-1)
        for i in range(3)], dim=-2)
    return torch.cat([r, transform_point(a, b[..., 3])[..., None]], dim=-1)


def det3(r):
    """Determinant of [..., 3, 3] by cofactors along the first row."""
    return (r[..., 0, 0] * (r[..., 1, 1] * r[..., 2, 2]
                            - r[..., 1, 2] * r[..., 2, 1])
            - r[..., 0, 1] * (r[..., 1, 0] * r[..., 2, 2]
                              - r[..., 1, 2] * r[..., 2, 0])
            + r[..., 0, 2] * (r[..., 1, 0] * r[..., 2, 1]
                              - r[..., 1, 1] * r[..., 2, 0]))


def inverse3(r):
    """Inverse of [..., 3, 3] as adjugate / determinant (elementwise, so the
    CPU and the card give the same bits; the JAX package uses an LU
    inverse, equal to ~1e-7 on the well-conditioned instance matrices)."""
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            i1, i2 = [k for k in range(3) if k != i]
            j1, j2 = [k for k in range(3) if k != j]
            minor = (r[..., i1, j1] * r[..., i2, j2]
                     - r[..., i1, j2] * r[..., i2, j1])
            c[i][j] = minor if (i + j) % 2 == 0 else -minor
    inv_det = 1.0 / det3(r)
    # inverse[i][j] = cofactor[j][i] / det
    return torch.stack([torch.stack([c[j][i] * inv_det for j in range(3)],
                                    dim=-1) for i in range(3)], dim=-2)


def invert_transform(m):
    """Inverse of a [..., 3, 4] affine."""
    r_inv = inverse3(m[..., :3])
    t = -transform_vector(r_inv, m[..., 3])
    return torch.cat([r_inv, t[..., None]], dim=-1)


def axis_angle_quaternion(axis, angle):
    """Quaternion [..., 4] (x, y, z, w) of a rotation by `angle` radians
    about `axis` [..., 3] (normalised here)."""
    device = _device_of(axis, angle)
    axis = normalize(_f32(axis, device))
    half = _f32(angle, device) * 0.5
    s = torch.sin(half)
    return torch.cat([axis * s[..., None], torch.cos(half)[..., None]],
                     dim=-1)


def look_at(position, target, up):
    """Camera-to-world rotation [3, 3] whose columns are (right, up,
    -forward): the view looks down -z, x right, y up. This is the JAX
    package's convention, kept as it is; render/camera.py `make_camera`
    builds its own orientation, which looks along +z."""
    device = _device_of(position, target, up)
    position, target, up = (_f32(x, device) for x in (position, target, up))
    fwd = normalize(target - position)
    right = normalize(cross(fwd, up))
    true_up = cross(right, fwd)
    return torch.stack([right, true_up, -fwd], dim=-1)


def quaternion_to_matrix(q):
    """Quaternion [..., 4] (x, y, z, w) -> rotation matrix [..., 3, 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def slerp(q0, q1, t):
    """Spherical interpolation of unit quaternions [..., 4] at t [...]."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)[..., None]
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0.0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    den = torch.where(use_lerp, 1.0, sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / den)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / den)
    q = w0 * q0 + w1 * q1
    return q * (1.0 / torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True),
                                             min=1e-20)))


# numpy twins of the two above, in float32, for host code (animation
# controllers); batched over leading dimensions


def np_quaternion_to_matrix(q):
    q = np.asarray(q, np.float32)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one, two = np.float32(1), np.float32(2)
    m = np.stack([
        one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
        two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
        two * (xz - wy), two * (yz + wx), one - two * (xx + yy)], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def np_slerp(q0, q1, t):
    q0 = np.asarray(q0, np.float32)
    q1 = np.asarray(q1, np.float32)
    t = np.asarray(t, np.float32)[..., None]
    one = np.float32(1)
    d = (q0 * q1).sum(-1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d)
    theta = np.arccos(np.clip(d, -one, one))
    sin_theta = np.sin(theta)
    use_lerp = sin_theta < np.float32(1e-5)
    den = np.where(use_lerp, one, sin_theta)
    w0 = np.where(use_lerp, one - t, np.sin((one - t) * theta) / den)
    w1 = np.where(use_lerp, t, np.sin(t * theta) / den)
    q = w0 * q0 + w1 * q1
    return (q / np.sqrt(np.maximum((q * q).sum(-1, keepdims=True),
                                   np.float32(1e-20)))).astype(np.float32)
