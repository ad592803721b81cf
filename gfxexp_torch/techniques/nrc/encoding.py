"""NRC input encodings: TriangleWave, OneBlob, HashGrid (port of
gfxexp_tpu/techniques/nrc/encoding.py).

The reference's tiny-cuda-nn configuration: TriangleWave (12 frequencies)
or a multiresolution HashGrid (16 levels, 2 features, 2^15 entries a level,
base resolution 16, scale 2) on the position, OneBlob (4 bins) on the four
polar direction and normal dims and the roughness, identity on the six
reflectance dims. Every function takes [..., D] values in [0, 1] and is
differentiable; the hash table is a learned parameter.

The constant tables (frequencies, bin centres, level resolutions, corner
offsets) are made on the input's device, exactly, so that no encoding
copies from the host inside a frame.
"""

from __future__ import annotations

import math

import torch

N_FREQUENCIES = 12
ONE_BLOB_BINS = 4
HASH_LEVELS = 16
HASH_FEATURES = 2
LOG2_HASH_SIZE = 15
HASH_BASE_RES = 16
# each level's resolution is HASH_BASE_RES * HASH_PER_LEVEL_SCALE**level;
# hash_grid_encoding makes the powers of 2 exactly (_pow2)
HASH_PER_LEVEL_SCALE = 2

_PRIMES = (1, 2654435761, 805459861)


def _pow2(n: int, device):
    """[2^0, ..., 2^(n-1)] as int64 on `device`."""
    return torch.bitwise_left_shift(
        torch.ones(n, dtype=torch.int64, device=device),
        torch.arange(n, device=device))


def triangle_wave_encoding(x, n_frequencies: int = N_FREQUENCIES):
    """tri(2^l x) for l < n_frequencies, tri of period 1 mapped to [0, 1]
    (tiny-cuda-nn's TriangleWave). [..., D] -> [..., D * n_frequencies]."""
    v = x[..., :, None] * _pow2(n_frequencies, x.device).to(x.dtype)
    tri = torch.abs(2.0 * (v - torch.floor(v + 0.5)))
    return tri.reshape(x.shape[:-1] + (x.shape[-1] * n_frequencies,))


def one_blob_encoding(x, n_bins: int = ONE_BLOB_BINS):
    """OneBlob: a Gaussian kernel of sigma 1 / n_bins evaluated at the bin
    centres and integrated over the bin width. [..., D] -> [..., D *
    n_bins]."""
    centers = (torch.arange(n_bins, dtype=x.dtype, device=x.device)
               + 0.5) / n_bins
    sigma = 1.0 / n_bins
    # sigma * sqrt(2 pi) in float32, as JAX forms it
    norm = sigma * torch.sqrt(torch.full((), 2.0 * math.pi, dtype=x.dtype,
                                         device=x.device))
    d = x[..., :, None] - centers
    blob = torch.exp(-0.5 * (d / sigma) ** 2) / norm
    blob = blob / n_bins
    return blob.reshape(x.shape[:-1] + (x.shape[-1] * n_bins,))


def init_hash_table(generator: torch.Generator, n_levels: int = HASH_LEVELS,
                    features: int = HASH_FEATURES,
                    log2_size: int = LOG2_HASH_SIZE, device="cuda"):
    """[L, T, F] feature table, U(-1e-4, 1e-4) as tiny-cuda-nn initialises
    it, drawn from `generator` (on the generator's device) and moved to
    `device`."""
    gen_dev = generator.device
    table = torch.rand((n_levels, 1 << log2_size, features),
                       generator=generator, device=gen_dev)
    return (table * 2e-4 - 1e-4).to(device)


def hash_grid_encoding(table, p):
    """Multiresolution hash encoding (Muller et al. 2022) of positions
    p [..., 3] in [0, 1] -> [..., L * F].

    Levels and corners are one gather from the flattened [L * T, F] table,
    so that autograd's backward is one index_add. The spatial hash wraps
    as uint32 in JAX; here it runs in int64 (corner coordinates stay below
    16 * 2^15 + 2, so the products fit) and is masked to 32 bits before the
    table mask."""
    n_levels, t_size, n_feat = table.shape
    batch = p.shape[:-1]
    dev = p.device
    res = (HASH_BASE_RES * _pow2(n_levels, dev)).to(p.dtype)
    pf = p[..., None, :] * res[:, None]  # [..., L, 3]
    p0 = torch.floor(pf)
    fw = pf - p0
    # per axis, the two corner coordinates' hash terms and weights [..., L,
    # 2]; corner c = x + 2y + 4z is entry [z, y, x] of their [2, 2, 2]
    # outer combination
    c = p0.to(torch.int64)[..., None] + torch.arange(2, device=dev)
    hx, hy, hz = (c[..., k, :] * _PRIMES[k] for k in range(3))
    idx = (hz[..., :, None, None] ^ hy[..., None, :, None]
           ^ hx[..., None, None, :]).reshape(batch + (n_levels, 8))
    # in place: the index tensors are the encoding's largest temporaries
    idx &= 0xFFFFFFFF
    idx &= t_size - 1
    idx += (torch.arange(n_levels, device=dev) * t_size)[:, None]
    wx, wy, wz = (torch.stack([1.0 - fw[..., k], fw[..., k]], dim=-1)
                  for k in range(3))
    w = ((wx[..., None, None, :] * wy[..., None, :, None])
         * wz[..., :, None, None]).reshape(batch + (n_levels, 8))
    feat = table.reshape(n_levels * t_size, n_feat)[idx]  # one gather
    out = (w[..., None] * feat).sum(dim=-2)  # [..., L, F]
    return out.reshape(batch + (n_levels * n_feat,))
