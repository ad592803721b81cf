"""Image input and output with the standard library and numpy only (port of
gfxexp_tpu/utils/image_io.py): PNG (8-bit) through zlib + struct, and a
minimal scanline OpenEXR codec (no compression, ZIP/ZIPS; float32 and
half) for HDR output and lat-long environment maps."""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, image, apply_srgb: bool = True):
    """Write an [H, W, 3] linear float image in [0, 1] as 8-bit RGB PNG
    (sRGB-encoded unless apply_srgb is False)."""
    data = encode_png(image, apply_srgb)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(image, apply_srgb: bool = True) -> bytes:
    """save_png's file in memory (the live viewer's stream)."""
    img = np.clip(np.asarray(image, np.float64), 0.0, 1.0)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    if apply_srgb:
        img = np.where(img <= 0.0031308, img * 12.92,
                       1.055 * np.power(img, 1.0 / 2.4) - 0.055)
    px = np.round(img * 255.0).astype(np.uint8)
    h, w = px.shape[:2]
    raw = b"".join(b"\x00" + px[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per colour type: grey, RGB, palette, grey + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (None, Sub, Up, Average, Paeth) of
    8-bit samples: [h, w * bpp] uint8."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:  # Up
            cur = (line + prior) & 255
        elif ftype in (3, 4):  # Average, Paeth: left to right by pixel
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - up_left))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, up_left))
                left = (line[x:x + bpp] + pred) & 255
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"PNG filter type {ftype} on row {y}")
        out[y] = cur
        prior = cur
    return out


def load_png(path: str, to_linear: bool = True) -> np.ndarray:
    """An 8-bit, non-interlaced PNG (grey, grey + alpha, RGB, RGBA or
    palette) -> float32 in [0, 1]: [H, W] for grey, [H, W, C] otherwise
    (a palette expands to RGB, or RGBA when it has transparency). With
    to_linear every channel goes from sRGB to linear. Other PNGs raise
    NotImplementedError."""
    with open(path, "rb") as f:
        return decode_png(f.read(), to_linear, path)


def decode_png(data: bytes, to_linear: bool = True,
               name: str = "PNG data") -> np.ndarray:
    """load_png on the bytes of a PNG file (`name` labels the errors)."""
    if data[:8] != _PNG_SIGNATURE:
        raise NotImplementedError(
            f"{name}: not a PNG file; load_png reads PNG only (JPEG and the "
            f"other formats PIL reads are not ported)")
    off = 8
    idat, palette, trns, hdr = [], None, None, None
    while off < len(data):
        (n,) = struct.unpack_from(">I", data, off)
        tag = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        off += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"{name}: PNG with bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}; load_png reads 8-bit non-interlaced "
            f"grey, grey + alpha, RGB, RGBA and palette images")
    c = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, c).reshape(h, w, c)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette image without PLTE")
        idx = px[:, :, 0]
        px = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(palette)]
            px = np.concatenate([px, alpha[idx][:, :, None]], axis=2)
    elif ctype == 0:
        px = px[:, :, 0]
    arr = px.astype(np.float32) / 255.0
    if to_linear:
        arr = np.where(arr <= 0.04045, arr / 12.92,
                       np.power((arr + 0.055) / 1.055, 2.4))
    return arr


# ---------------------------------------------------------------------------
# EXR: a minimal scanline codec
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PIX_UINT, _PIX_HALF, _PIX_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _exr_reorder_decode(data: bytes) -> bytes:
    """EXR zip post-process: undo delta-encoding, then de-interleave
    (first half of the stream -> even byte positions)."""
    arr = np.frombuffer(data, np.uint8).astype(np.int64)
    deltas = arr.copy()
    deltas[1:] -= 128  # t[0] = t[-1] + t[0] - 128 recurrence
    recon = (np.cumsum(deltas) % 256).astype(np.uint8)
    n = len(recon)
    out = np.zeros(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = recon[:half]
    out[1::2] = recon[half:]
    return out.tobytes()


def _exr_reorder_encode(data: bytes) -> bytes:
    """Inverse of _exr_reorder_decode: interleave halves, then delta-encode."""
    arr = np.frombuffer(data, np.uint8)
    inter = np.concatenate([arr[0::2], arr[1::2]]).astype(np.int64)
    d = inter.copy()
    d[1:] = inter[1:] - inter[:-1] + 128
    return (d % 256).astype(np.uint8).tobytes()


def _read_null_str(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def load_exr(path: str) -> np.ndarray:
    """Returns [H, W, C] float32 (channels ordered R,G,B[,A] when present)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    off = 8
    channels = []  # (name, pixel_type)
    compression = _COMP_NONE
    data_window = None
    while True:
        name, off = _read_null_str(buf, off)
        if name == "":
            break
        attr_type, off = _read_null_str(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off : off + size]
        off += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                cname, p = _read_null_str(payload, p)
                ptype, _, _, _ = struct.unpack_from("<iiii", payload, p)
                p += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"EXR compression {compression} not supported")
    x_min, y_min, x_max, y_max = data_window
    width = x_max - x_min + 1
    height = y_max - y_min + 1
    lines_pb = _LINES_PER_BLOCK[compression]
    n_blocks = (height + lines_pb - 1) // lines_pb
    # channel order in file is alphabetical; each scanline stores channels
    # sorted by name
    ch_sorted = sorted(channels, key=lambda c: c[0])
    dtype_of = {_PIX_HALF: np.float16, _PIX_FLOAT: np.float32, _PIX_UINT: np.uint32}
    out = {c[0]: np.zeros((height, width), np.float32) for c in ch_sorted}
    # skip line-offset table
    off += 8 * n_blocks
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        raw = buf[off : off + size]
        off += size
        y0 = y - y_min
        n_lines = min(lines_pb, height - y0)
        uncompressed_size = n_lines * sum(
            width * np.dtype(dtype_of[t]).itemsize for _, t in ch_sorted
        )
        if compression in (_COMP_ZIP, _COMP_ZIPS) and size < uncompressed_size:
            raw = _exr_reorder_decode(zlib.decompress(raw))
        p = 0
        for li in range(n_lines):
            for cname, ptype in ch_sorted:
                dt = dtype_of[ptype]
                nbytes = width * np.dtype(dt).itemsize
                line = np.frombuffer(raw, dt, count=width, offset=p)
                out[cname][y0 + li] = line.astype(np.float32)
                p += nbytes
    order = [c for c in ("R", "G", "B", "A") if c in out]
    if not order:
        order = [c[0] for c in ch_sorted]
    return np.stack([out[c] for c in order], axis=-1)


def save_exr(path: str, image: np.ndarray, half: bool = True):
    """Write a ZIP-compressed scanline EXR. image: [H, W, 3|4] float."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    height, width, n_ch = img.shape
    names = ["R", "G", "B", "A"][:n_ch] if n_ch <= 4 else [f"c{i}" for i in range(n_ch)]
    ptype = _PIX_HALF if half else _PIX_FLOAT
    dt = np.float16 if half else np.float32
    ch_sorted = sorted(zip(names, range(n_ch)))

    def attr(name, atype, payload):
        return name.encode() + b"\x00" + atype.encode() + b"\x00" + struct.pack("<i", len(payload)) + payload

    chan_payload = b""
    for cname, _ in ch_sorted:
        chan_payload += cname.encode() + b"\x00" + struct.pack("<iiii", ptype, 0, 1, 1)
    chan_payload += b"\x00"
    dw = struct.pack("<iiii", 0, 0, width - 1, height - 1)
    header = struct.pack("<ii", _EXR_MAGIC, 2)
    header += attr("channels", "chlist", chan_payload)
    header += attr("compression", "compression", bytes([_COMP_ZIP]))
    header += attr("dataWindow", "box2i", dw)
    header += attr("displayWindow", "box2i", dw)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    lines_pb = _LINES_PER_BLOCK[_COMP_ZIP]
    n_blocks = (height + lines_pb - 1) // lines_pb
    blocks = []
    for b in range(n_blocks):
        y0 = b * lines_pb
        n_lines = min(lines_pb, height - y0)
        parts = []
        for li in range(n_lines):
            for cname, ci in ch_sorted:
                parts.append(img[y0 + li, :, ci].astype(dt).tobytes())
        raw = b"".join(parts)
        comp = zlib.compress(_exr_reorder_encode(raw))
        if len(comp) >= len(raw):
            comp = raw
        blocks.append((y0, comp))

    table_off = len(header) + 8 * n_blocks
    offsets = []
    cursor = table_off
    for y0, comp in blocks:
        offsets.append(cursor)
        cursor += 8 + len(comp)
    with open(path, "wb") as f:
        f.write(header)
        for o in offsets:
            f.write(struct.pack("<Q", o))
        for y0, comp in blocks:
            f.write(struct.pack("<ii", y0, len(comp)))
            f.write(comp)
