"""TGA, BMP, GIF and PNM decoding with numpy and the standard library, and
the signature test that picks a decoder (utils/image_io.py decode_samples).

Each decoder hands back the samples PIL's plugin hands back for the file
(uint8, or bool for 1-bit grey, uint16 for PNM grey over 8 bits), except
that a palette expands to RGB, or RGBA where it carries alpha:

* TGA: uncompressed and RLE; grey (1, 8 bits; 16 as grey + alpha), true
  colour 16 (5-5-5 with the attribute bit as alpha), 24 and 32 bits, and
  8-bit colour-mapped with a 16, 24 or 32-bit map; bottom-up or top-down,
  left-to-right or right-to-left. TGA has no signature: as PIL, the port
  tries it when no other format's signature matches.
* BMP: BI_RGB at 1, 4, 8, 16 (5-5-5), 24 and 32 bits (the fourth byte
  ignored, as PIL ignores it), BI_BITFIELDS at 16 and 32 bits, RLE4 and
  RLE8; bottom-up or top-down; the OS/2 and Windows headers PIL reads. A
  palette that is the grey ramp reads as grey, as PIL reads it.
* GIF: the first frame (LZW, interlaced or not) on its logical screen,
  filled with the transparent index where there is one; a palette that is
  the grey ramp reads as grey, as PIL reads it.
* PNM: P1-P6, scaled to 8 bits (16 for grey with a maxval over 255) as
  PIL scales them.
"""

from __future__ import annotations

import re
import struct

import numpy as np

# signatures of the formats PIL reads that the port does not
_UNPORTED = (
    (lambda d: d[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"),
     "TIFF"),
    (lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP", "WebP"),
    (lambda d: d[:4] == b"8BPS", "PSD"),
    (lambda d: d[:4] == b"DDS ", "DDS (read it through load_dds)"),
    (lambda d: d[:4] == b"qoif", "QOI"),
    (lambda d: d[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
     or d[:4] == b"\xff\x4f\xff\x51", "JPEG 2000"),
    (lambda d: d[4:8] == b"ftyp", "AVIF/HEIF"),
    (lambda d: d[:4] == b"icns", "ICNS"),
    (lambda d: d[:4] in (b"%!PS", b"\xc5\xd0\xd3\xc6"), "EPS"),
    (lambda d: d[:4] in (b"BLP1", b"BLP2"), "BLP"),
    (lambda d: d[:2] == b"\x01\xda", "SGI"),
    (lambda d: d[:4] == b"\x59\xa6\x6a\x95", "Sun raster"),
    (lambda d: d[:6] == b"SIMPLE", "FITS"),
    (lambda d: d[:8] == b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1",
     "FlashPix/MIC"),
    (lambda d: d[:4] == b"FTEX", "FTEX"),
    (lambda d: d[:2] in (b"Pf", b"PF"), "PFM"),
    (lambda d: d[:2] in (b"P0", b"Py"), "PIL's PNM extensions"),
)
# weaker signatures, tried after TGA (an uncompressed true-colour TGA
# without an ID field starts as a CUR file does)
_UNPORTED_WEAK = (
    (lambda d: d[:4] == b"\x00\x00\x01\x00", "ICO"),
    (lambda d: d[:4] == b"\x00\x00\x02\x00", "CUR"),
    (lambda d: len(d) > 1 and d[0] == 10 and d[1] in (0, 2, 3, 5), "PCX"),
    (lambda d: d[:7] == b"#define", "XBM"),
    (lambda d: d[:9] == b"/* XPM */", "XPM"),
)


def sniff(data: bytes) -> str:
    """The format of an image file from its first bytes: "PNG", "JPEG",
    "GIF", "BMP", "PNM", "TGA", or the name of a format the port does not
    read, or "unknown"."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "PNG"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:2] == b"BM":
        return "BMP"
    if data[:1] == b"P" and data[1:2] in (b"1", b"2", b"3", b"4", b"5",
                                          b"6"):
        return "PNM"
    for test, fmt in _UNPORTED:
        if test(data):
            return fmt
    if _tga_header(data) is not None:
        return "TGA"
    for test, fmt in _UNPORTED_WEAK:
        if test(data):
            return fmt
    return "unknown"


def _expand(idx: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Indices -> the palette's colours; indices past its end are black
    (PIL's palette is zero there)."""
    full = np.zeros((256, palette.shape[1]), np.uint8)
    full[:min(len(palette), 256)] = palette[:256]
    return full[idx]


def _scale_bits(x: np.ndarray, bits: int) -> np.ndarray:
    """An n-bit channel to 8 bits as PIL's unpackers do: x * 255 // max."""
    return (x.astype(np.int64) * 255 // ((1 << bits) - 1)).astype(np.uint8)


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------


def _tga_header(data: bytes):
    """TGA's 18-byte header if it passes PIL's checks, else None."""
    if len(data) < 18:
        return None
    (id_len, cmap_type, itype, cmap_start, cmap_len, cmap_depth, _, _, w, h,
     depth, flags) = struct.unpack_from("<BBBHHBHHHHBB", data, 0)
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (
            1, 8, 16, 24, 32) or itype not in (1, 2, 3, 9, 10, 11):
        return None
    return (id_len, cmap_type, itype, cmap_start, cmap_len, cmap_depth, w, h,
            depth, flags)


def _bgr15(v: np.ndarray, alpha: bool) -> np.ndarray:
    """16-bit little-endian pixels 5-5-5 (blue lowest) -> RGB or RGBA, the
    top bit as inverted alpha, 0 opaque (PIL's BGR;15 and BGRA;15Z)."""
    ch = [_scale_bits((v >> s) & 31, 5) for s in (10, 5, 0)]
    if alpha:
        ch.append((1 - ((v >> 15) & 1)).astype(np.uint8) * 255)
    return np.stack(ch, axis=-1)


def decode_tga(data: bytes, name: str = "TGA data") -> np.ndarray:
    hdr = _tga_header(data)
    if hdr is None:
        raise ValueError(f"{name}: not a TGA file")
    (id_len, cmap_type, itype, cmap_start, cmap_len, cmap_depth, w, h,
     depth, flags) = hdr
    base = itype & 7
    if (base, depth) not in ((1, 8), (3, 1), (3, 8), (3, 16), (2, 16),
                             (2, 24), (2, 32)) or (base == 1
                                                   and not cmap_type):
        raise NotImplementedError(
            f"{name}: TGA image type {itype} at {depth} bits")
    off = 18 + id_len
    palette = None
    if cmap_type:
        nb = {16: 2, 24: 3, 32: 4}.get(cmap_depth)
        if nb is None:
            raise ValueError(f"{name}: TGA colour map of {cmap_depth} bits")
        raw = np.frombuffer(data, np.uint8, count=nb * cmap_len, offset=off)
        off += nb * cmap_len
        if nb == 2:
            ent = _bgr15(raw.view("<u2"), True)
        else:
            ent = raw.reshape(-1, nb)[:, [2, 1, 0, 3][:nb]]
        palette = np.concatenate([np.zeros((cmap_start, nb if nb > 2 else 4),
                                           np.uint8), ent])
    if depth == 1:
        n = (w + 7) // 8 * h
        rows = np.frombuffer(data, np.uint8, count=n, offset=off)
        px = np.unpackbits(rows.reshape(h, -1), axis=1)[:, :w].astype(bool)
    else:
        bpp = depth // 8
        if itype & 8:
            raw = _tga_rle(data, off, w * h, bpp, name)
        else:
            raw = np.frombuffer(data, np.uint8, count=w * h * bpp,
                                offset=off)
        raw = raw.reshape(h, w, bpp)
        if base == 1:
            px = _expand(raw[:, :, 0], palette)
        elif base == 3:
            px = raw[:, :, 0] if bpp == 1 else raw[:, :, :2].copy()
        elif bpp == 2:
            px = _bgr15(raw[:, :, 0].astype(np.uint16)
                        | (raw[:, :, 1].astype(np.uint16) << 8), True)
        else:
            px = raw[:, :, [2, 1, 0, 3][:bpp]]
    if not flags & 0x20:  # bottom-up
        px = px[::-1]
    if flags & 0x10:  # right-to-left
        px = px[:, ::-1]
    return np.ascontiguousarray(px)


def _tga_rle(data: bytes, off: int, npix: int, bpp: int, name: str):
    """TGA run-length packets -> npix pixels of bpp bytes, runs crossing
    scanlines as they may."""
    out = bytearray()
    need = npix * bpp
    n = len(data)
    while len(out) < need:
        if off >= n:
            raise ValueError(f"{name}: TGA RLE data ends early")
        head = data[off]
        off += 1
        count = (head & 0x7F) + 1
        if head & 0x80:
            out += data[off:off + bpp] * count
            off += bpp
        else:
            out += data[off:off + bpp * count]
            off += bpp * count
    if len(out) < need:
        raise ValueError(f"{name}: TGA RLE data ends early")
    return np.frombuffer(bytes(out[:need]), np.uint8)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def decode_bmp(data: bytes, name: str = "BMP data") -> np.ndarray:
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    hd = data[18:14 + hsize]
    pos = 14 + hsize
    top_down = False
    masks = None
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", hd, 0)
        comp, colors, entry = 0, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        w, h, _, bits, comp = struct.unpack_from("<IIHHI", hd, 0)
        if hd[7] == 0xFF:  # a negative height: top-down rows
            top_down, h = True, 2 ** 32 - h
        (colors,) = struct.unpack_from("<I", hd, 28)
        entry = 4
        if comp == 3:  # BI_BITFIELDS
            if len(hd) >= 48:
                masks = list(struct.unpack_from("<III", hd, 36))
                masks.append(struct.unpack_from("<I", hd, 48)[0]
                             if len(hd) >= 52 else 0)
            else:
                masks = [*struct.unpack_from("<III", data, pos), 0]
                pos += 12
    else:
        raise NotImplementedError(f"{name}: BMP header of {hsize} bytes")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise NotImplementedError(f"{name}: BMP at {bits} bits per pixel")
    if comp not in (0, 1, 2, 3) or (comp == 3 and bits not in (16, 32)) or (
            comp in (1, 2) and bits != (8 if comp == 1 else 4)):
        raise NotImplementedError(
            f"{name}: BMP compression {comp} at {bits} bits")
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    palette, grey = None, None
    if bits <= 8:
        raw = np.frombuffer(data, np.uint8, count=entry * colors, offset=pos)
        palette = raw.reshape(colors, entry)[:, [2, 1, 0]]
        ramp = np.array((0, 255) if colors == 2 else range(colors))
        grey = colors <= 256 and bool((palette == ramp[:, None]).all())
    if comp in (1, 2):
        idx = _bmp_rle(data, offset, w, h, comp == 2, name)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        rows = np.frombuffer(data, np.uint8, count=stride * h,
                             offset=offset).reshape(h, stride)
        if bits < 8:
            idx = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
            idx = (idx * (1 << np.arange(bits - 1, -1, -1))).sum(-1)[:, :w]
        elif bits == 8:
            idx = rows[:, :w]
        elif bits == 24:
            idx = rows[:, :3 * w].reshape(h, w, 3)[:, :, ::-1]
        else:
            nb = bits // 8
            v = rows[:, :nb * w].reshape(h, w, nb).astype(np.uint32)
            v = sum(v[:, :, i] << (8 * i) for i in range(nb))
            idx = _bmp_bitfields(v, bits, masks)
    if not top_down:
        idx = idx[::-1]
    if palette is None:
        return np.ascontiguousarray(idx)
    if grey:
        if colors == 2:
            return np.ascontiguousarray(idx != 0)
        return np.ascontiguousarray(idx.astype(np.uint8))
    return _expand(idx.astype(np.uint8), palette)


def _bmp_bitfields(v: np.ndarray, bits: int, masks):
    """16 and 32-bit pixels by their channel masks (BI_RGB: 5-5-5 at 16
    bits, BGRX at 32); alpha only from a 32-bit mask that has one."""
    if masks is None:
        masks = [0x7C00, 0x3E0, 0x1F, 0] if bits == 16 else [
            0xFF0000, 0xFF00, 0xFF, 0]
    elif bits == 32 and masks == [0, 0, 0, 0]:
        masks = [0xFF0000, 0xFF00, 0xFF, 0xFF000000]  # PIL reads BGRA
    out = []
    for i, m in enumerate(masks):
        if i == 3 and (bits != 32 or not m):
            break
        if not m:
            out.append(np.zeros(v.shape, np.uint8))
            continue
        shift = (m & -m).bit_length() - 1
        width = (m >> shift).bit_length()
        out.append(_scale_bits((v & m) >> shift, width))
    return np.stack(out, axis=-1)


def _bmp_rle(data: bytes, off: int, w: int, h: int, rle4: bool, name: str):
    """RLE8 / RLE4 -> indices [h, w], bottom row first; skipped pixels (end
    of line, delta) are index 0."""
    out = bytearray()
    n = len(data)
    x = 0
    total = w * h
    while len(out) < total and off + 1 < n:
        count, byte = data[off], data[off + 1]
        off += 2
        if count:
            count = min(count, max(0, w - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes((-len(out)) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta
            if off + 1 >= n:
                break
            right, up = data[off], data[off + 1]
            off += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # an absolute run of `byte` pixels, padded to 16 bits
            nbytes = (byte + 1) // 2 if rle4 else byte
            chunk = data[off:off + nbytes]
            off += nbytes + (nbytes & 1)
            if rle4:
                chunk = bytes(v for b in chunk for v in (b >> 4, b & 15))
            out += chunk[:byte]
            x += byte
    out = bytes(out[:total]) + bytes(max(0, total - len(out)))
    return np.frombuffer(out, np.uint8).reshape(h, w)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def _palette_needed(p: bytes) -> bool:
    """PIL's test: a palette that is not the grey ramp 0, 1, 2, ..."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2])
               for i in range(0, len(p), 3))


def _lzw(data: bytes, min_size: int, npix: int, name: str) -> bytes:
    """GIF's variable-width LZW, codes least significant bit first."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    width = min_size + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    prev = None
    acc = nbits = 0
    it = iter(data)
    while len(out) < npix:
        while nbits < width:
            b = next(it, None)
            if b is None:
                return bytes(out)
            acc |= b << nbits
            nbits += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        if code == clear:
            width = min_size + 1
            del table[eoi + 1:]
            prev = None
            continue
        if code == eoi:
            break
        if prev is None:
            if code >= len(table):
                raise ValueError(f"{name}: bad GIF LZW code")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"{name}: bad GIF LZW code")
            if len(table) < 4096:
                table.append(prev + entry[:1])
                if len(table) == 1 << width and width < 12:
                    width += 1
        out += entry
        prev = entry
    return bytes(out)


def decode_gif(data: bytes, name: str = "GIF data") -> np.ndarray:
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    off = 13
    palette = None
    if flags & 0x80:
        p = data[off:off + (3 << ((flags & 7) + 1))]
        off += len(p)
        if _palette_needed(p):
            palette = p
    transparency = None
    n = len(data)
    while True:
        if off >= n:
            raise ValueError(f"{name}: GIF without an image")
        tag = data[off]
        off += 1
        if tag == 0x21:  # extension: label, then sub-blocks
            label = data[off]
            off += 1
            first = True
            while off < n and data[off]:
                block = data[off + 1:off + 1 + data[off]]
                if first and label == 0xF9 and block and block[0] & 1:
                    transparency = block[3]
                first = False
                off += 1 + data[off]
            off += 1
        elif tag == 0x2C:  # image descriptor
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, off)
            off += 9
            if fflags & 0x80:
                p = data[off:off + (3 << ((fflags & 7) + 1))]
                off += len(p)
                palette = p if _palette_needed(p) else None
            min_size = data[off]
            off += 1
            blocks = []
            while off < n and data[off]:
                blocks.append(data[off + 1:off + 1 + data[off]])
                off += 1 + data[off]
            break
        elif tag == 0x3B:
            raise ValueError(f"{name}: GIF without an image")
        else:
            raise ValueError(f"{name}: GIF block {tag:#x}")
    if not 1 <= min_size <= 11:
        raise ValueError(f"{name}: GIF LZW code size {min_size}")
    pix = _lzw(b"".join(blocks), min_size, fw * fh, name)
    fill = transparency if transparency is not None else 0
    frame = np.full(fw * fh, fill, np.uint8)
    frame[:len(pix)] = np.frombuffer(pix, np.uint8)[:fw * fh]
    frame = frame.reshape(fh, fw)
    if fflags & 0x40:  # interlaced: rows in four passes
        order = [y for y0_, dy in ((0, 8), (4, 8), (2, 4), (1, 2))
                 for y in range(y0_, fh, dy)]
        deint = np.empty_like(frame)
        deint[order] = frame
        frame = deint
    h, w = max(sh, y0 + fh), max(sw, x0 + fw)
    idx = np.full((h, w), fill, np.uint8)
    idx[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        return idx
    rgb = np.frombuffer(palette, np.uint8).reshape(-1, 3)
    if transparency is None:
        return _expand(idx, rgb)
    rgba = np.concatenate([rgb, np.full((len(rgb), 1), 255, np.uint8)], 1)
    if transparency < len(rgba):
        rgba[transparency, 3] = 0
    else:
        rgba = np.concatenate([rgba, np.zeros((transparency + 1 - len(rgba),
                                               4), np.uint8)])
    return _expand(idx, rgba)


# ---------------------------------------------------------------------------
# PNM
# ---------------------------------------------------------------------------

_WS = b" \t\n\r\x0b\x0c"


def _pnm_token(data: bytes, off: int):
    """PIL's header token: skip whitespace and comments, read to the next
    whitespace, which it consumes; -> (token, offset after it)."""
    n = len(data)
    tok = bytearray()
    while off < n:
        c = data[off:off + 1]
        off += 1
        if c in _WS and c:
            if tok:
                break
            continue
        if c == b"#":
            while off < n and data[off:off + 1] not in (b"\r", b"\n"):
                off += 1
            off += 1
            continue
        tok += c
    if not tok:
        raise ValueError("PNM header ends early")
    return bytes(tok), off


def decode_pnm(data: bytes, name: str = "PNM data") -> np.ndarray:
    magic = data[:2]
    off = 2
    wt, off = _pnm_token(data, off)
    ht, off = _pnm_token(data, off)
    w, h = int(wt), int(ht)
    bands = 3 if magic in (b"P3", b"P6") else 1
    if magic in (b"P1", b"P4"):
        if magic == b"P4":
            rows = np.frombuffer(data, np.uint8, count=(w + 7) // 8 * h,
                                 offset=off).reshape(h, -1)
            bits = np.unpackbits(rows, axis=1)[:, :w]
        else:
            digits = re.sub(rb"#[^\r\n]*|\s", b"", data[off:])
            bits = np.frombuffer(digits[:w * h], np.uint8) - ord("0")
            if len(bits) < w * h or (bits > 1).any():
                raise ValueError(f"{name}: bad PBM data")
            bits = bits.reshape(h, w)
        return bits == 0  # 1 is black
    mt, off = _pnm_token(data, off)
    maxval = int(mt)
    if not 0 < maxval < 65536:
        raise ValueError(f"{name}: PNM maxval {maxval}")
    wide = maxval > 255 and bands == 1  # PIL's mode I
    out_max = 65535 if wide else 255
    count = w * h * bands
    if magic in (b"P2", b"P3"):
        toks = re.sub(rb"#[^\r\n]*", b"", data[off:]).split()[:count]
        v = np.array([int(t) for t in toks], np.int64)
        if len(v) < count or (v > maxval).any():
            raise ValueError(f"{name}: bad plain PNM data")
        v = np.round(v / maxval * out_max)
    else:
        v = np.frombuffer(data, ">u2" if maxval > 255 else np.uint8,
                          count=count, offset=off).astype(np.int64)
        if maxval not in (255, 65535) or not wide and maxval != 255:
            v = np.minimum(out_max, np.round(v / maxval * out_max))
    v = v.astype(np.uint16 if wide else np.uint8)
    return v.reshape(h, w, bands) if bands == 3 else v.reshape(h, w)


DECODERS = {"TGA": decode_tga, "BMP": decode_bmp, "GIF": decode_gif,
            "PNM": decode_pnm}
