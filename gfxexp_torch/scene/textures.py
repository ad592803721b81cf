"""Textures (port of gfxexp_tpu/scene/textures.py): the layer atlas with
optional mips, bilinear and trilinear sampling with wrap addressing, the
normal-map readers and bump application, and DDS loading with BC1-5 decode
(BC6H and BC7 in scene/bc67.py).

Images are resampled on the host to one power-of-two layer size and stacked
into [N, S, S, 4]; a material's texture slot of -1 selects its constant
(render/bsdf.py material_params_textured). Sampling is a plain gather, so it
runs on whatever device holds the atlas; the atlas must be on the device of
the lanes that sample it (`scene.to(device)` moves it with the scene).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from gfxexp_torch.core.math import length
from gfxexp_torch.core.tensors import TensorData

ATLAS_SIZE = 512  # layer resolution (loads are resampled to this)


@dataclass
class TextureAtlas(TensorData):
    """Every texture of a scene in one gatherable stack. With mips,
    `mip_flat` packs every level of every layer: level l of layer n spans
    mip_flat[n, mip_offsets[l] : mip_offsets[l] + (S >> l)^2]."""

    layers: torch.Tensor  # [N, S, S, 4] float32 linear (level 0)
    count: int = 0
    mip_flat: Optional[torch.Tensor] = None  # [N, sum_l (S >> l)^2, 4]
    mip_offsets: Optional[torch.Tensor] = None  # [L] int32 texel offsets
    n_levels: int = 0


def empty_atlas() -> TextureAtlas:
    return TextureAtlas(layers=torch.zeros((1, 1, 1, 4)), count=0)


class AtlasBuilder:
    def __init__(self, size: int = ATLAS_SIZE, mips: bool = False):
        self.size = size
        self.mips = mips
        self.images: List[np.ndarray] = []

    def add(self, image: np.ndarray) -> int:
        """image: [H, W, C] float linear (C in 1..4). Returns its id."""
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        c = img.shape[2]
        if c < 4:
            pad = np.ones(img.shape[:2] + (4 - c,), np.float32)
            if c == 1:
                img = np.concatenate([img, img, img, pad[..., :1]], axis=2)
            else:
                img = np.concatenate([img, pad], axis=2)
        self.images.append(_resample(img[:, :, :4], self.size))
        return len(self.images) - 1

    def build(self) -> TextureAtlas:
        """The atlas as CPU tensors (a full average mip chain per layer,
        flattened level-major, when built with mips)."""
        if not self.images:
            return empty_atlas()
        stack = np.stack(self.images)
        if not self.mips:
            return TextureAtlas(layers=torch.from_numpy(stack),
                                count=len(self.images))
        levels = [stack]
        while levels[-1].shape[1] > 1:
            m = levels[-1]
            levels.append(0.25 * (m[:, 0::2, 0::2] + m[:, 1::2, 0::2]
                                  + m[:, 0::2, 1::2] + m[:, 1::2, 1::2]))
        offsets = np.cumsum([0] + [lv.shape[1] * lv.shape[2]
                                   for lv in levels[:-1]])
        flat = np.concatenate(
            [lv.reshape(lv.shape[0], -1, 4) for lv in levels], axis=1)
        return TextureAtlas(
            layers=torch.from_numpy(stack), count=len(self.images),
            mip_flat=torch.from_numpy(flat.astype(np.float32)),
            mip_offsets=torch.from_numpy(offsets.astype(np.int32)),
            n_levels=len(levels))


def _resample(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resample to size x size (host, numpy)."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    return (img[y0][:, x0] * (1 - fy) * (1 - fx)
            + img[y0][:, x1] * (1 - fy) * fx
            + img[y1][:, x0] * fy * (1 - fx)
            + img[y1][:, x1] * fy * fx).astype(np.float32)


def _check_device(atlas: TextureAtlas, uv):
    if atlas.layers.device != uv.device:
        raise ValueError(f"the texture atlas is on {atlas.layers.device} but "
                         f"the lanes sampling it are on {uv.device}: move "
                         f"the scene with .to(device)")


def _wrap_uv(uv):
    """u and v wrapped into [0, 1), v flipped (image row 0 is v = 1)."""
    return uv[:, 0] % 1.0, (1.0 - uv[:, 1] % 1.0) % 1.0


def _bilinear(tex, u, v, s, sf):
    """Bilinear blend of tex(y, x) [R, 4] at (u, v) on an s x s grid (s an
    int or a per-lane tensor, sf its float)."""
    x = u * sf - 0.5
    y = v * sf - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0w = x0 % s
    y0w = y0 % s
    x1w = (x0 + 1) % s
    y1w = (y0 + 1) % s
    return (tex(y0w, x0w) * (1 - fy) * (1 - fx)
            + tex(y0w, x1w) * (1 - fy) * fx
            + tex(y1w, x0w) * fy * (1 - fx)
            + tex(y1w, x1w) * fy * fx)


def _layer(atlas: TextureAtlas, tex_id):
    return torch.clamp(tex_id.to(torch.int64), 0, max(atlas.count - 1, 0))


def sample_bilinear(atlas: TextureAtlas, tex_id, uv):
    """Bilinear wrap sampling. tex_id [R] (-1 allowed, read as layer 0:
    mask at the caller), uv [R, 2]. Returns [R, 4]."""
    _check_device(atlas, uv)
    s = atlas.layers.shape[1]
    layer = _layer(atlas, tex_id)
    u, v = _wrap_uv(uv)
    lay = atlas.layers
    return _bilinear(lambda y, x: lay[layer, y, x], u, v, s, s)


def _sample_mip_level(atlas: TextureAtlas, layer, uv, level):
    """Bilinear sample at the integer mip `level` [R] from the flat pack."""
    level = torch.clamp(level, 0, atlas.n_levels - 1)
    s = atlas.layers.shape[1] >> level
    base = atlas.mip_offsets[level].to(torch.int64)
    u, v = _wrap_uv(uv)
    f = atlas.mip_flat
    return _bilinear(lambda y, x: f[layer, base + y * s + x], u, v, s,
                     s.to(torch.float32))


def sample_trilinear(atlas: TextureAtlas, tex_id, uv, lod):
    """Trilinear sampling: bilinear at the floor and ceil mip levels of the
    per-lane `lod` [R] (0 = full resolution), blended by its fraction. An
    atlas without mips is sampled bilinearly."""
    if atlas.mip_flat is None or atlas.n_levels <= 1:
        return sample_bilinear(atlas, tex_id, uv)
    _check_device(atlas, uv)
    layer = _layer(atlas, tex_id)
    lod = torch.clamp(lod.to(torch.float32), 0.0, float(atlas.n_levels - 1))
    l0 = torch.floor(lod).to(torch.int64)
    f = (lod - l0.to(torch.float32))[:, None]
    c0 = _sample_mip_level(atlas, layer, uv, l0)
    c1 = _sample_mip_level(atlas, layer, uv,
                           torch.clamp(l0 + 1, max=atlas.n_levels - 1))
    return c0 * (1.0 - f) + c1 * f


def build_mip_pyramid(image: np.ndarray) -> List[np.ndarray]:
    """Full average mip chain of an image (host)."""
    mips = [np.asarray(image, np.float32)]
    while min(mips[-1].shape[:2]) > 1:
        m = mips[-1]
        h2, w2 = m.shape[0] // 2, m.shape[1] // 2
        mips.append(0.25 * (m[0:2 * h2:2, 0:2 * w2:2]
                            + m[1:2 * h2:2, 0:2 * w2:2]
                            + m[0:2 * h2:2, 1:2 * w2:2]
                            + m[1:2 * h2:2, 1:2 * w2:2]))
    return mips


# ---------------------------------------------------------------------------
# normal mapping: the three readers (3-channel and 2-channel normal maps, a
# height map by central differences) and the rotation of the shading frame
# ---------------------------------------------------------------------------


def _unit(n):
    return n / length(n, keepdim=True)


def decode_normal_map(texel, two_channel: bool = False):
    """Texel [R, 4] -> local-space modified normal [R, 3] (z up)."""
    nx = texel[:, 0] * 2.0 - 1.0
    ny = texel[:, 1] * 2.0 - 1.0
    if two_channel:
        nz = torch.sqrt(torch.clamp(1.0 - nx * nx - ny * ny, min=0.0))
    else:
        nz = torch.clamp(texel[:, 2] * 2.0 - 1.0, min=1e-3)
    return _unit(torch.stack([nx, ny, nz], dim=-1))


def apply_bump(shading_normal, tangent, bitangent, local_normal):
    """Rotate the shading frame by the tangent-space modified normal."""
    return (local_normal[:, 0:1] * tangent
            + local_normal[:, 1:2] * bitangent
            + local_normal[:, 2:3] * shading_normal)


def normal_from_height_map(atlas: TextureAtlas, tex_id, uv,
                           bump_scale: float = 1.0):
    """Local-space modified normal normalize(-dh/du, -dh/dv, 1) from a
    height texture (channel 0) by central differences one texel apart;
    `bump_scale` scales the gradient."""
    eps = 1.0 / atlas.layers.shape[1]
    u, v = uv[:, 0], uv[:, 1]

    def h(du, dv):
        return sample_bilinear(atlas, tex_id,
                               torch.stack([u + du, v + dv], dim=-1))[:, 0]

    gx = bump_scale * (h(eps, 0.0) - h(-eps, 0.0)) / (2.0 * eps)
    gy = bump_scale * (h(0.0, eps) - h(0.0, -eps)) / (2.0 * eps)
    return _unit(torch.stack([-gx, -gy, torch.ones_like(gx)], dim=-1))


# ---------------------------------------------------------------------------
# DDS loading with BC1 / BC2 / BC3 / BC4 / BC5 decode (BC6H, BC7: bc67.py)
# ---------------------------------------------------------------------------

_DDS_MAGIC = 0x20534444
_FOURCC = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3", b"BC4U": "BC4",
           b"ATI1": "BC4", b"BC5U": "BC5", b"ATI2": "BC5", b"DX10": "DX10"}
_DXGI_TO_BC = {71: "BC1", 72: "BC1", 74: "BC2", 75: "BC2", 77: "BC3",
               78: "BC3", 80: "BC4", 83: "BC5", 95: "BC6H", 98: "BC7",
               99: "BC7"}


def load_dds(path: str) -> np.ndarray:
    """A BC1-7 compressed DDS file -> [H, W, C] float32 (C = 4 for BC1-3
    and BC7, 1 for BC4, 2 for BC5, 3 for BC6H). Other formats raise
    ValueError, as the JAX package's load_dds does."""
    with open(path, "rb") as f:
        data = f.read()
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != _DDS_MAGIC:
        raise ValueError(f"{path}: not a DDS file")
    height, width = struct.unpack_from("<II", data, 12)
    (pf_flags,) = struct.unpack_from("<I", data, 80)
    fourcc = data[84:88]
    off = 128
    fmt = None
    if pf_flags & 0x4:  # DDPF_FOURCC
        fmt = _FOURCC.get(fourcc)
        if fmt == "DX10":
            (dxgi,) = struct.unpack_from("<I", data, 128)
            fmt = _DXGI_TO_BC.get(dxgi)
            off = 148
    if fmt is None:
        raise ValueError(f"{path}: unsupported DDS format {fourcc!r} (BC1-7 "
                         f"only)")
    if fmt in ("BC6H", "BC7"):
        from gfxexp_torch.scene.bc67 import decode_bc6h, decode_bc7

        decode = decode_bc7 if fmt == "BC7" else decode_bc6h
        return decode(data, off, width, height)
    return _decode_bc(data, off, width, height, fmt)


def _decode_bc(data: bytes, off: int, width: int, height: int, fmt: str):
    bw = (width + 3) // 4
    bh = (height + 3) // 4
    block_size = 8 if fmt in ("BC1", "BC4") else 16
    out_c = {"BC1": 4, "BC2": 4, "BC3": 4, "BC4": 1, "BC5": 2}[fmt]
    blocks = np.frombuffer(data, np.uint8, count=bh * bw * block_size,
                           offset=off).reshape(bh * bw, block_size)

    if fmt in ("BC1", "BC2", "BC3"):
        co = 0 if fmt == "BC1" else 8
        c0 = blocks[:, co] | (blocks[:, co + 1].astype(np.uint32) << 8)
        c1 = blocks[:, co + 2] | (blocks[:, co + 3].astype(np.uint32) << 8)
        idx = (blocks[:, co + 4].astype(np.uint32)
               | (blocks[:, co + 5].astype(np.uint32) << 8)
               | (blocks[:, co + 6].astype(np.uint32) << 16)
               | (blocks[:, co + 7].astype(np.uint32) << 24))

        def c565(c):
            return np.stack([((c >> 11) & 31) / 31.0, ((c >> 5) & 63) / 63.0,
                             (c & 31) / 31.0], axis=-1)

        p0, p1 = c565(c0), c565(c1)
        four = (c0 > c1) | (fmt in ("BC2", "BC3"))
        pal = np.zeros((len(blocks), 4, 3), np.float32)
        pal[:, 0] = p0
        pal[:, 1] = p1
        pal[:, 2] = np.where(four[:, None], (2 * p0 + p1) / 3, (p0 + p1) / 2)
        pal[:, 3] = np.where(four[:, None], (p0 + 2 * p1) / 3, 0.0)
        sel = (idx[:, None] >> (2 * np.arange(16)[None, :])) & 3
        rgb = np.take_along_axis(pal, sel[..., None].astype(np.int64), axis=1)
        alpha = np.ones((len(blocks), 16, 1), np.float32)
        if fmt == "BC3":
            alpha = _decode_bc4_channel(blocks[:, 0:8])[..., None]
        elif fmt == "BC2":
            # explicit 4-bit alpha, LSB-first nibbles
            a64 = np.zeros(len(blocks), np.uint64)
            for i in range(8):
                a64 |= blocks[:, i].astype(np.uint64) << np.uint64(8 * i)
            nib = (a64[:, None]
                   >> (4 * np.arange(16, dtype=np.uint64)[None, :])
                   ) & np.uint64(15)
            alpha = (nib.astype(np.float32) / 15.0)[..., None]
        texels = np.concatenate([rgb, alpha], axis=-1)
    elif fmt == "BC4":
        texels = _decode_bc4_channel(blocks[:, 0:8])[..., None]
    else:  # BC5
        texels = np.stack([_decode_bc4_channel(blocks[:, 0:8]),
                           _decode_bc4_channel(blocks[:, 8:16])], axis=-1)

    texels = texels.reshape(bh, bw, 4, 4, out_c).transpose(0, 2, 1, 3, 4)
    return texels.reshape(bh * 4, bw * 4, out_c)[:height, :width]


def _decode_bc4_channel(blocks8: np.ndarray) -> np.ndarray:
    """blocks8 [B, 8] uint8 -> [B, 16] float values in [0, 1]."""
    a0 = blocks8[:, 0].astype(np.float32)
    a1 = blocks8[:, 1].astype(np.float32)
    bits = np.zeros(len(blocks8), np.uint64)
    for i in range(6):
        bits |= blocks8[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    sel = ((bits[:, None] >> (3 * np.arange(16, dtype=np.uint64)[None, :]))
           & np.uint64(7)).astype(np.int64)
    pal = np.zeros((len(blocks8), 8), np.float32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    six = a0 > a1
    for i in range(1, 7):
        pal[:, 1 + i] = np.where(six, ((7 - i) * a0 + i * a1) / 7.0, 0.0)
    for i in range(1, 5):
        pal[:, 1 + i] = np.where(six, pal[:, 1 + i],
                                 ((5 - i) * a0 + i * a1) / 5.0)
    pal[:, 6] = np.where(six, pal[:, 6], 0.0)
    pal[:, 7] = np.where(six, pal[:, 7], 255.0)
    return np.take_along_axis(pal, sel, axis=1) / 255.0
