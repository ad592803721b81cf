"""Image input and output with the standard library and numpy only (port of
gfxexp_tpu/utils/image_io.py).

Reading: `load_png` (JAX's name) and `decode_image` read what the JAX
package reads through PIL, from the file's signature as PIL picks its
plugin, not from its name: PNG (every bit depth and colour type, Adam7),
JPEG (utils/jpeg.py), TGA, BMP, GIF (the first frame) and PNM P1-P6
(utils/image_formats.py). The samples are PIL's, with three differences,
each where JAX's result is not an image in [0, 1]: palettes expand to RGB
(RGBA with transparency) where JAX hands back the indices / 255; 16-bit
grey (PNG, and PNM with a maxval over 255) is divided by 65535 where JAX
divides by 255; 1-bit grey (PNG, PNM P1 / P4, BMP and TGA) is 0 or 1 where
JAX's is 0 or 1/255. Other formats PIL reads (TIFF, WebP, PSD, ICO, ...)
raise NotImplementedError naming the format.

Writing: `save_png` / `encode_png` ([H, W], [H, W, 2 | 3 | 4], float or
uint8 passthrough) as JAX's do, and a minimal scanline OpenEXR codec (no
compression, ZIP/ZIPS; float32 and half) for HDR output and lat-long
environment maps."""

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
    """Write an image as an 8-bit PNG: [H, W] grey, [H, W, 2] grey + alpha,
    [H, W, 3] RGB or [H, W, 4] RGBA; float linear in [0, 1] (sRGB-encoded
    unless apply_srgb is False) or uint8 written as it is."""
    data = encode_png(image, apply_srgb)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(image, apply_srgb: bool = True) -> bytes:
    """save_png's file in memory (the live viewer's stream). Float images
    are quantised in float32 as the JAX package's are."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.float32)
        if apply_srgb:
            arr = np.where(arr <= 0.0031308, arr * 12.92,
                           1.055 * np.power(np.clip(arr, 0, 1), 1 / 2.4)
                           - 0.055)
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _PNG_CTYPE:
        raise ValueError(f"expected [H, W] or [H, W, 1-4], got {arr.shape}")
    h, w, c = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)],
                         axis=1).tobytes()
    return (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _PNG_CTYPE[c],
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per colour type: grey, RGB, palette, grey + alpha, RGBA; the
# bit depths each allows
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_PNG_CTYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type written
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (None, Sub, Up, Average, Paeth):
    rows [h, 1 + stride] uint8 (filter byte first) -> [h, stride] uint8;
    `bpp` bytes per complete pixel (1 below 8 bits)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:  # Up
            cur = (line + prior) & 255
        elif ftype in (3, 4):  # Average, Paeth: left to right by byte
            ln, up = line.tolist(), prior.tolist()
            c = [0] * stride
            for i in range(stride):
                a = c[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    c[i] = (ln[i] + ((a + b) >> 1)) & 255
                    continue
                cc = up[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                c[i] = (ln[i] + pred) & 255
            cur = np.asarray(c, np.int64)
        else:
            raise ValueError(f"PNG filter type {ftype} on row {y}")
        out[y] = cur
        prior = cur
    return out


def _png_pass(raw: bytes, off: int, w: int, h: int, c: int, depth: int):
    """One image (or Adam7 pass) from `off` of the inflated stream ->
    (samples [h, w, c] uint8 or uint16, offset after it)."""
    stride = (w * c * depth + 7) // 8
    n = h * (stride + 1)
    if off + n > len(raw):
        raise ValueError("PNG image data ends early")
    rows = np.frombuffer(raw, np.uint8, count=n, offset=off).reshape(
        h, stride + 1)
    px = _unfilter(rows, max(1, c * depth // 8))
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    elif depth < 8:
        bits = np.unpackbits(px, axis=1).reshape(h, -1, depth)
        px = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(
            np.uint8)
    return px[:, :w * c].reshape(h, w, c), off + n


def _png_samples(data: bytes, name: str = "PNG data") -> np.ndarray:
    """A PNG file's samples as PIL hands them back, palettes expanded:
    uint8 for 8-bit and smaller depths (grey 2 and 4 bits scaled to 8 bits),
    the high byte of 16-bit colour and grey + alpha (grey + alpha at 16 bits
    becomes RGBA, as in PIL), uint16 for 16-bit grey, bool for 1-bit grey."""
    off = 8
    idat, palette, trns, hdr = [], None, None, None
    while off + 8 <= len(data):
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
    if depth not in _PNG_DEPTHS.get(ctype, ()) or interlace > 1:
        raise ValueError(f"{name}: PNG with bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    c = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        px, _ = _png_pass(raw, 0, w, h, c, depth)
    else:
        px = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:
                px[y0::dy, x0::dx], off = _png_pass(raw, off, pw, ph, c,
                                                    depth)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette image without PLTE")
        full = np.zeros((256, 4), np.uint8)
        full[:, 3] = 255
        full[:len(palette), :3] = palette[:256]
        if trns is not None:
            full[:min(len(trns), 256), 3] = trns[:256]
        return full[px[:, :, 0], :4 if trns is not None else 3]
    if ctype == 0:
        px = px[:, :, 0]
        if depth == 1:
            return px.astype(bool)
        return px if depth == 16 else (px * (255 // ((1 << depth) - 1))
                                       ).astype(np.uint8)
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
        if ctype == 4:  # PIL's LA;16B -> RGBA
            px = px[:, :, [0, 0, 0, 1]]
    return px


def _samples_to_float(px: np.ndarray, to_linear: bool) -> np.ndarray:
    """Samples -> float32 as JAX's load_png computes it: / 255 for uint8,
    / 65535 for uint16, 0 or 1 for bool; with to_linear every channel goes
    from sRGB to linear."""
    if px.dtype == np.bool_:
        arr = px.astype(np.float32)
    elif px.dtype == np.uint16:
        arr = px.astype(np.float32) / 65535.0
    else:
        arr = px.astype(np.float32) / 255.0
    if to_linear:
        arr = np.where(arr <= 0.04045, arr / 12.92,
                       np.power((arr + 0.055) / 1.055, 2.4))
    return arr


def decode_samples(data: bytes, name: str = "image data") -> np.ndarray:
    """The samples of an image file of any format the port reads, found
    from its signature as PIL finds its plugin (see the module's
    docstring): uint8, uint16 (16-bit grey) or bool (1-bit grey); [H, W]
    grey or [H, W, C]."""
    from gfxexp_torch.utils import image_formats as fmt

    kind = fmt.sniff(data)
    if kind == "PNG":
        return _png_samples(data, name)
    if kind == "JPEG":
        from gfxexp_torch.utils.jpeg import decode_jpeg

        return decode_jpeg(data, name)
    if kind in fmt.DECODERS:
        return fmt.DECODERS[kind](data, name)
    raise NotImplementedError(
        f"{name}: {kind} image; the port reads PNG, JPEG, TGA, BMP, GIF and "
        f"PNM (P1-P6), not the other formats PIL reads")


def decode_image(data: bytes, to_linear: bool = True,
                 name: str = "image data") -> np.ndarray:
    """load_png on the bytes of an image file (`name` labels the errors):
    float32 [H, W] for grey, [H, W, C] otherwise."""
    return _samples_to_float(decode_samples(data, name), to_linear)


def load_png(path: str, to_linear: bool = True) -> np.ndarray:
    """An image file of any format the port reads (JAX's name, which reads
    whatever PIL reads) -> float32 in [0, 1]: [H, W] for grey, [H, W, C]
    otherwise. With to_linear every channel goes from sRGB to linear."""
    with open(path, "rb") as f:
        return decode_image(f.read(), to_linear, path)


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
