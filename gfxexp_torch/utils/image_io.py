"""PNG output with the standard library only (zlib + struct)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, image, apply_srgb: bool = True):
    """Write an [H, W, 3] linear float image in [0, 1] as 8-bit RGB PNG
    (sRGB-encoded unless apply_srgb is False)."""
    img = np.clip(np.asarray(image, np.float64), 0.0, 1.0)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    if apply_srgb:
        img = np.where(img <= 0.0031308, img * 12.92,
                       1.055 * np.power(img, 1.0 / 2.4) - 0.055)
    px = np.round(img * 255.0).astype(np.uint8)
    h, w = px.shape[:2]
    raw = b"".join(b"\x00" + px[y].tobytes() for y in range(h))
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
