"""Small image writers for the variants PIL cannot write, used by
tests/test_torch_image_formats.py and make_fixtures.py: PNG at every bit
depth and colour type, Adam7 interlaced, with tRNS; TGA 16-bit, colour-
mapped and right-to-left; BMP at 4 and 16 bits, BI_BITFIELDS, RLE4 / RLE8,
top-down and with the OS/2 header; GIF with a local palette, a frame offset
and a transparent index; PNM plain and binary at any maxval; and a baseline
JPEG encoder (Huffman or arithmetic-coded, sequential or progressive,
with a scan script that may stop early) for any sampling factors,
component ids, Adobe marker, quantisation table and scan layout; and a
lossless (SOF3) JPEG encoder.

Each writer returns the file's bytes. Pure numpy and the standard library.
"""

import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filtered_rows(rows, bpp):
    """Scanlines [h, stride] uint8 -> filtered bytes, filters 0-4 in turn."""
    out = b""
    prior = np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows.astype(np.int64)):
        ft = y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - up_left
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, up_left))
        out += bytes([ft]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
        prior = cur
    return out


def _png_image(px, depth):
    """Samples [h, w, c] -> packed scanlines [h, stride] uint8."""
    h, w, c = px.shape
    if depth == 16:
        return px.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return px.astype(np.uint8).reshape(h, w * c)
    bits = ((px.reshape(h, w * c)[:, :, None].astype(np.uint8)
             >> np.arange(depth - 1, -1, -1).astype(np.uint8)) & 1)
    bits = bits.reshape(h, -1)
    pad = (-bits.shape[1]) % 8
    bits = np.concatenate([bits, np.zeros((h, pad), np.uint8)], axis=1)
    return np.packbits(bits, axis=1)


def png(px, depth=8, ctype=None, interlace=0, palette=None, trns=None):
    """A PNG of samples px ([h, w] or [h, w, c], already at `depth`)."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, c = px.shape
    if ctype is None:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    bpp = max(1, c * depth // 8)
    raw = b""
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered_rows(_png_image(sub, depth), bpp)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", bytes(trns))
    z = zlib.compress(raw, 9)
    half = len(z) // 2  # two IDAT chunks
    return (out + _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:])
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------


def _tga_rle(pix, bpp):
    """Run-length packets over a run of pixels of bpp bytes."""
    out = b""
    flat = [pix[i:i + bpp] for i in range(0, len(pix), bpp)]
    i = 0
    while i < len(flat):
        j = i
        while j + 1 < len(flat) and flat[j + 1] == flat[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + flat[i]
            i = j + 1
            continue
        j = i
        while (j + 1 < len(flat) and j - i < 127
               and (j + 2 >= len(flat) or flat[j + 1] != flat[j + 2])):
            j += 1
        out += bytes([j - i]) + b"".join(flat[i:j + 1])
        i = j + 1
    return out


def tga(pixels, itype, depth, flags=0, cmap=None, cmap_depth=24,
        cmap_start=0, ident=b""):
    """A TGA of raw pixel bytes [h, w, bytes per pixel] in file order
    (rows as `flags` orders them); RLE when itype has bit 3."""
    pixels = np.asarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    cmap_len = 0 if cmap is None else len(cmap)
    head = struct.pack("<BBBHHBHHHHBB", len(ident), int(cmap is not None),
                       itype, cmap_start, cmap_len,
                       cmap_depth if cmap is not None else 0, 0, 0, w, h,
                       depth, flags)
    body = pixels.tobytes()
    if itype & 8:  # packets within scanlines, as PIL's decoder needs them
        body = b"".join(_tga_rle(r.tobytes(), max(1, depth // 8))
                        for r in pixels)
    cm = b"" if cmap is None else np.asarray(cmap, np.uint8).tobytes()
    return head + ident + cm + body


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp(rows, bits, width, height, palette=None, compression=0, masks=None,
        header=40, top_down=False):
    """A BMP of rows (bytes per file row, padded here) or of an RLE
    stream (compression 1, 2)."""
    if compression in (1, 2):
        data = rows
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        data = b"".join(r + bytes(stride - len(r)) for r in rows)
    pal = b""
    if palette is not None:
        ent = 3 if header == 12 else 4
        if header == 12:  # the OS/2 header has no colour count
            palette = list(palette) + [(0, 0, 0)] * ((1 << bits)
                                                    - len(palette))
        pal = b"".join(bytes([b, g, r] + [0] * (ent - 3))
                       for r, g, b in palette)
    extra = b""
    if header == 12:
        dib = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        h = -height if top_down else height
        dib = struct.pack("<IiiHHIIiiII", header, width, h, 1, bits,
                          compression, len(data), 2835, 2835,
                          len(palette) if palette is not None else 0, 0)
        if header >= 52:
            m = list(masks or (0, 0, 0, 0)) + [0]
            dib += struct.pack("<IIII", *m[:4])[:header - 40]
        elif masks is not None:
            extra = struct.pack("<III", *masks[:3])
        dib += bytes(header - len(dib))
    offset = 14 + len(dib) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + dib + extra + pal + data)


def bmp_rle(idx, rle4):
    """RLE8 / RLE4 of indices [h, w] (bottom row first in the file): runs
    of equal pixels as encoded runs, the rest as absolute runs of even
    length, an end of line after each row and an end of bitmap."""
    out = b""
    for row in idx[::-1].tolist():
        x = 0
        w = len(row)
        while x < w:
            n = 1
            while x + n < w and row[x + n] == row[x] and n < 254:
                n += 1
            if n >= 2 or w - x < 4:
                v = row[x]
                out += bytes([n, (v << 4) | v if rle4 else v])
                x += n
                continue
            n = min(w - x, 16) & ~1  # an even absolute run
            run = row[x:x + n]
            if rle4:
                body = bytes((run[i] << 4) | run[i + 1]
                             for i in range(0, n, 2))
            else:
                body = bytes(run)
            out += bytes([0, n]) + body + bytes(len(body) & 1)
            x += n
        out += b"\x00\x00"
    return out + b"\x00\x01"


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def _lzw_plain(idx, min_size):
    """LZW codes that never grow the code width: each pixel its own code,
    a clear code before the table would need a wider one."""
    clear, width = 1 << min_size, min_size + 1
    limit = (1 << width) - (clear + 2) - 1
    codes = [clear]
    n = 0
    for v in idx:
        if n == limit:
            codes.append(clear)
            n = 0
        codes.append(int(v))
        n += 1
    codes.append(clear + 1)
    acc = nbits = 0
    out = bytearray()
    for c in codes:
        acc |= c << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def gif(idx, screen, offset=(0, 0), global_palette=None, local_palette=None,
        transparency=None, interlace=False):
    """A GIF89a of one frame of indices [h, w] at `offset` on a `screen`
    (w, h)."""
    idx = np.asarray(idx, np.uint8)
    fh, fw = idx.shape

    def table(p):
        p = np.asarray(p, np.uint8)
        n = max(1, int(np.ceil(np.log2(len(p)))) - 1)
        full = np.zeros((2 << n, 3), np.uint8)
        full[:len(p)] = p
        return n, full.tobytes()

    out = b"GIF89a" + struct.pack("<HH", *screen)
    if global_palette is not None:
        n, t = table(global_palette)
        out += bytes([0x80 | n, 0, 0]) + t
    else:
        out += b"\x00\x00\x00"
    if transparency is not None:
        out += b"\x21\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\x00"
    out += b"\x21\xfe\x03abc\x00"  # a comment extension
    flags = 0x40 if interlace else 0
    lt = b""
    if local_palette is not None:
        n, lt = table(local_palette)
        flags |= 0x80 | n
    out += b"," + struct.pack("<HHHHB", *offset, fw, fh, flags) + lt
    rows = idx
    if interlace:
        order = [y for y0, dy in ((0, 8), (4, 8), (2, 4), (1, 2))
                 for y in range(y0, fh, dy)]
        rows = idx[order]
    min_size = 8
    data = _lzw_plain(rows.reshape(-1), min_size)
    out += bytes([min_size])
    for i in range(0, len(data), 255):
        out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
    return out + b"\x00;"


# ---------------------------------------------------------------------------
# PNM
# ---------------------------------------------------------------------------


def pnm(magic, v, maxval=None):
    """PNM of values v ([h, w] or [h, w, 3]; bits for P1 / P4)."""
    v = np.asarray(v)
    h, w = v.shape[:2]
    head = magic + b"\n# a comment\n" + b"%d %d\n" % (w, h)
    if magic in (b"P1", b"P4"):
        if magic == b"P1":
            return head + b"\n".join(b"".join(b"%d" % x for x in r)
                                     for r in v.tolist()) + b"\n"
        return head + np.packbits(v.astype(np.uint8), axis=1).tobytes()
    head += b"%d\n" % maxval
    if magic in (b"P2", b"P3"):
        return head + b"\n".join(b" ".join(b"%d" % x for x in r)
                                 for r in v.reshape(h, -1).tolist()) + b"\n"
    dt = ">u2" if maxval > 255 else np.uint8
    return head + v.astype(dt).tobytes()


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

_ZZ = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
       33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57,
       50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
       39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    t = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    t[0] /= np.sqrt(2)
    return t


def _coefficients(plane, h, v, hmax, vmax, mcux, mcuy, q):
    """One component: downsample by block means, pad by edge replication
    to whole MCUs, DCT and quantise -> [bh, bw, 64] ints in zigzag order."""
    fy, fx = vmax // v, hmax // h
    H, W = plane.shape
    p = np.pad(plane.astype(np.float64), ((0, (-H) % fy), (0, (-W) % fx)),
               mode="edge")
    p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3))
    bh, bw = mcuy * v, mcux * h
    p = np.pad(p, ((0, bh * 8 - p.shape[0]), (0, bw * 8 - p.shape[1])),
               mode="edge")
    t = _dct_matrix()
    blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
    c = np.einsum("ux,abxy,vy->abuv", t, blocks, t).reshape(bh, bw, 64)
    q = np.asarray(q, np.float64).reshape(64)
    c = np.divide(c, q, out=np.zeros_like(c), where=q != 0)  # 0: step 0
    return np.round(c).astype(np.int64)[:, :, _ZZ]


class _Bits:
    """Huffman-coded bits, MSB first, with 0xFF stuffing."""

    def __init__(self):
        self.bits = []
        self.out = bytearray()

    def put(self, code, n):
        self.bits.extend((code >> (n - 1 - i)) & 1 for i in range(n))

    def extend_bits(self, bits):
        self.bits.extend(bits)

    def flush(self):
        self.bits.extend([1] * ((-len(self.bits)) % 8))
        for i in range(0, len(self.bits), 8):
            b = int("".join(map(str, self.bits[i:i + 8])), 2)
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.bits = []


def _flat_table(symbols):
    """A valid Huffman table giving every symbol the same length."""
    n = len(symbols)
    length = max(1, int(np.ceil(np.log2(n + 1))))
    counts = [0] * 16
    counts[length - 1] = n
    return counts, list(symbols), {s: (i, length)
                                   for i, s in enumerate(symbols)}


_DC_SYMS = list(range(12))
_AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                           for s in range(1, 11)]


def _category(v):
    return int(abs(v)).bit_length()


def _huff_block(bits, zz, pred, dc, ac):
    diff = int(zz[0]) - pred
    s = _category(diff)
    bits.put(*dc[s])
    if s:
        bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
    run = 0
    last = max([k for k in range(1, 64) if zz[k]], default=0)
    for k in range(1, last + 1):
        v = int(zz[k])
        if not v:
            run += 1
            continue
        while run > 15:
            bits.put(*ac[0xF0])
            run -= 16
        s = _category(v)
        bits.put(*ac[(run << 4) | s])
        bits.put(v if v > 0 else v + (1 << s) - 1, s)
        run = 0
    if last < 63:
        bits.put(*ac[0x00])
    return int(zz[0])


def _huff_prog(bits, zz, pred, ss, se, ah, al, dc, ac):
    """One block of a progressive Huffman scan (jcphuff.c), each AC band
    ending in its own EOB (a run of one); returns the new DC prediction."""
    if ss == 0:
        v = int(zz[0]) >> al
        if ah:
            bits.put(v & 1, 1)
            return pred
        diff = v - pred
        s = _category(diff)
        bits.put(*dc[s])
        if s:
            bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
        return v
    mag = [abs(int(zz[k])) >> al for k in range(64)]
    # the last coefficient this scan makes non-zero: no ZRL after it
    last = max([k for k in range(ss, se + 1)
                if mag[k] == 1 or (mag[k] and not ah)], default=-1)
    run, pending = 0, []
    for k in range(ss, se + 1):
        a = mag[k]
        if not a:
            run += 1
            continue
        while run > 15 and k <= last:
            bits.put(*ac[0xF0])
            bits.extend_bits(pending)
            pending = []
            run -= 16
        if ah and a > 1:  # known before: a correction bit, sent later
            pending.append(a & 1)
            continue
        s = 1 if ah else _category(a)
        bits.put(*ac[(run << 4) | s])
        if ah:
            bits.put(int(zz[k] > 0), 1)
        else:
            bits.put(a if zz[k] > 0 else ~a & ((1 << s) - 1), s)
        bits.extend_bits(pending)
        pending, run = [], 0
    if run or pending:
        bits.put(*ac[0x00])
        bits.extend_bits(pending)
    return pred


# the QM coder's table (T.81 Table D.2; jaricom.c): Qe, next LPS, next
# MPS, switch
_QM = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class _QMEncoder:
    """jcarith.c's arith_encode and finish_pass, bytes already stuffed."""

    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1
        self.out = bytearray()

    def _zeros(self):
        while self.zc:
            self.out.append(0)
            self.zc -= 1

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def encode(self, st, i, val):
        sv = st[i]
        qe, nlps, nmps, sw = _QM[sv & 0x7F]
        nl = nlps | (sw << 7)
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        while self.sc:
                            self.out += b"\xff\x00"
                            self.sc -= 1
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                while self.sc:
                    self.out += b"\xff\x00"
                    self.sc -= 1
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_magnitude(enc, st, si, v, mag_bin):
    """Figures F.8 and F.9 for |value| - 1 = v from bin si."""
    m = 0
    if v:
        enc.encode(st, si, 1)
        m = 1
        v2 = v >> 1
        if mag_bin is None:
            si = 20
            while v2:
                enc.encode(st, si, 1)
                m <<= 1
                si += 1
                v2 >>= 1
        elif v2:
            enc.encode(st, si, 1)
            m <<= 1
            si = mag_bin
            v2 >>= 1
            while v2:
                enc.encode(st, si, 1)
                m <<= 1
                si += 1
                v2 >>= 1
    enc.encode(st, si, 0)
    si += 14
    m >>= 1
    while m:
        enc.encode(st, si, 1 if m & v else 0)
        m >>= 1
    return m


class _ArithState:
    def __init__(self, ncomp):
        self.enc = _QMEncoder()
        self.dc = {}
        self.ac = {}
        self.last = [0] * ncomp
        self.ctx = [0] * ncomp
        self.fixed = [113]


def _arith_dc(s, slot, tbl, value):
    st = s.dc.setdefault(tbl, [0] * 64)
    s0 = s.ctx[slot]
    v = value - s.last[slot]
    if v == 0:
        s.enc.encode(st, s0, 0)
        s.ctx[slot] = 0
        return
    s.last[slot] = value
    s.enc.encode(st, s0, 1)
    sign = int(v < 0)
    s.enc.encode(st, s0 + 1, sign)
    s.ctx[slot] = 8 if sign else 4
    v = abs(v) - 1
    m = 0
    si = s0 + 2 + sign
    if v:
        m = 1 << (v.bit_length() - 1)
    # conditioning with L = 0, U = 1 (the default DAC)
    if m < (1 << 0) >> 1:
        s.ctx[slot] = 0
    elif m > (1 << 1) >> 1:
        s.ctx[slot] += 8
    _arith_magnitude(s.enc, st, si, v, None)


def _arith_ac(s, tbl, zz, ss, se, al, kx=5):
    """Sequential AC (ss = 1, se = 63, al = 0) or a first progressive AC
    pass over [ss, se] at point transform al."""
    st = s.ac.setdefault(tbl, [0] * 256)

    def pt(v):
        return (v >> al) if v >= 0 else -((-v) >> al)

    ke = se
    while ke > 0 and (ke < ss or not pt(int(zz[ke]))):
        ke -= 1
        if ke < ss:
            break
    k = ss
    while k <= ke:
        si = 3 * (k - 1)
        s.enc.encode(st, si, 0)
        while not pt(int(zz[k])):
            s.enc.encode(st, si + 1, 0)
            si += 3
            k += 1
        v = pt(int(zz[k]))
        s.enc.encode(st, si + 1, 1)
        s.enc.encode(s.fixed, 0, int(v < 0))
        _arith_magnitude(s.enc, st, si + 2, abs(v) - 1,
                         189 if k <= kx else 217)
        k += 1
    if k <= se:
        s.enc.encode(st, 3 * (k - 1), 1)


def _arith_ac_refine(s, tbl, zz, ss, se, ah, al):
    st = s.ac.setdefault(tbl, [0] * 256)
    ke = se
    while ke > 0 and not (abs(int(zz[ke])) >> al):
        ke -= 1
    kex = ke
    while kex > 0 and not (abs(int(zz[kex])) >> ah):
        kex -= 1
    k = ss
    while k <= ke:
        si = 3 * (k - 1)
        if k > kex:
            s.enc.encode(st, si, 0)
        while True:
            v = int(zz[k])
            a = abs(v) >> al
            if a:
                if a >> 1:
                    s.enc.encode(st, si + 2, a & 1)
                else:
                    s.enc.encode(st, si + 1, 1)
                    s.enc.encode(s.fixed, 0, int(v < 0))
                break
            s.enc.encode(st, si + 1, 0)
            si += 3
            k += 1
        k += 1
    if k <= se:
        s.enc.encode(st, 3 * (k - 1), 1)


def progressive_script(nc):
    """The default scan script of the progressive modes, as (component
    slots, Ss, Se, Ah, Al): DC at Al 1 then 0, AC 1-5 and 6-63 at Al 1,
    then their refinements."""
    every = list(range(nc))
    return ([(every, 0, 0, 0, 1)]
            + [([s], ss, se, 0, 1) for s in every for ss, se in ((1, 5),
                                                                 (6, 63))]
            + [(every, 0, 0, 1, 0)]
            + [([s], 1, 63, 1, 0) for s in every])


def jpeg(planes, factors, ids=None, app=b"", restart=0, interleaved=True,
         sof=0xC0, q=None, scans=None):
    """A JPEG of full-resolution component planes (uint8 [H, W] each, in
    the file's colour space) at sampling factors [(h, v)]: sof 0xC0 / 0xC1
    (Huffman, flat tables), 0xC2 (progressive Huffman), 0xC9 (arithmetic,
    sequential) or 0xCA (arithmetic, progressive). The progressive modes
    follow `scans`, a list of (component slots, Ss, Se, Ah, Al), by default
    progressive_script(nc); a script may stop before the coefficients are
    whole, as a file cut after a scan does. `q` is the quantisation table
    (8x8, natural order; a zero step codes its coefficient as 0), or a
    pair: the first component's and the others'. `app` goes after SOI
    (JFIF, Adobe, ...)."""
    nc = len(planes)
    H, W = planes[0].shape
    ids = ids or list(range(1, nc + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    if q is None:
        q = 2 + np.add.outer(np.arange(8), np.arange(8))
    qs = list(q) if len(q) == 2 else [q, q]  # (first component's, others')
    tq = [0 if i == 0 else 1 for i in range(nc)]
    coefs = [_coefficients(p, h, v, hmax, vmax, mcux, mcuy, qs[t])
             for p, (h, v), t in zip(planes, factors, tq)]
    out = b"\xff\xd8" + app
    for t in (0, 1):
        qz = np.asarray(qs[t], np.int64).reshape(64)[_ZZ]
        out += b"\xff\xdb" + struct.pack(">HB", 67, t) + bytes(qz.tolist())
    out += bytes([0xFF, sof]) + struct.pack(">HBHHB", 8 + 3 * nc, 8, H, W,
                                            nc)
    for i, (h, v) in enumerate(factors):
        out += bytes([ids[i], (h << 4) | v, tq[i]])
    arith = sof in (0xC9, 0xCA)
    if not arith:
        dcc, dcs, dc = _flat_table(_DC_SYMS)
        acc, acs, ac = _flat_table(_AC_SYMS)
        for t in (0, 1):
            out += b"\xff\xc4" + struct.pack(">HB", 3 + 16 + len(dcs), t) \
                + bytes(dcc) + bytes(dcs)
            out += b"\xff\xc4" + struct.pack(">HB", 3 + 16 + len(acs),
                                             0x10 | t) + bytes(acc) \
                + bytes(acs)
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)

    def layout(slots):
        """(slot, by, bx) per block, grouped by MCU."""
        if len(slots) > 1:
            return [[(s, y * factors[s][1] + v, x * factors[s][0] + h)
                     for s in slots for v in range(factors[s][1])
                     for h in range(factors[s][0])]
                    for y in range(mcuy) for x in range(mcux)]
        s = slots[0]
        h, v = factors[s]
        dw, dh = -(-W * h // hmax), -(-H * v // vmax)
        return [[(s, y, x)] for y in range(-(-dh // 8))
                for x in range(-(-dw // 8))]

    def scan(slots, ss, se, ah, al):
        hdr = bytes([len(slots)])
        for s in slots:
            hdr += bytes([ids[s], (tq[s] << 4) | tq[s]])
        hdr += bytes([ss, se, (ah << 4) | al])
        body = bytearray()
        mcus = layout(slots)
        for start in range(0, len(mcus), restart or len(mcus)):
            chunk = mcus[start:start + (restart or len(mcus))]
            if arith:
                s = _ArithState(nc)
                for blocks in chunk:
                    for slot, by, bx in blocks:
                        zz = coefs[slot][by, bx]
                        if sof == 0xC9:
                            _arith_dc(s, slot, tq[slot], int(zz[0]))
                            _arith_ac(s, tq[slot], zz, 1, 63, 0)
                        elif ss == 0 and ah == 0:
                            dcv = int(zz[0]) >> al
                            _arith_dc(s, slot, tq[slot], dcv)
                        elif ss == 0:
                            s.enc.encode(s.fixed, 0, (int(zz[0]) >> al) & 1)
                        elif ah == 0:
                            _arith_ac(s, tq[slot], zz, ss, se, al)
                        else:
                            _arith_ac_refine(s, tq[slot], zz, ss, se, ah, al)
                body += s.enc.finish()
            else:
                bits = _Bits()
                pred = [0] * nc
                for blocks in chunk:
                    for slot, by, bx in blocks:
                        zz = coefs[slot][by, bx]
                        if sof == 0xC2:
                            pred[slot] = _huff_prog(bits, zz, pred[slot], ss,
                                                    se, ah, al, dc, ac)
                        else:
                            pred[slot] = _huff_block(bits, zz, pred[slot],
                                                     dc, ac)
                bits.flush()
                body += bits.out
            if start + (restart or len(mcus)) < len(mcus):
                body += bytes([0xFF, 0xD0 + (start // restart) % 8])
        return (b"\xff\xda" + struct.pack(">H", 2 + len(hdr)) + hdr
                + bytes(body))

    if sof in (0xC2, 0xCA):
        for slots, ss, se, ah, al in scans or progressive_script(nc):
            out += scan(list(slots), ss, se, ah, al)
    elif interleaved and nc > 1:
        out += scan(list(range(nc)), 0, 63, 0, 0)
    else:
        for s in range(nc):
            out += scan([s], 0, 63, 0, 0)
    return out + b"\xff\xd9"


def _lossless_diffs(x, predictor, first_rows, initial):
    """The differences an encoder sends for one component's point-
    transformed samples x [h, w] (jcdiffct.c / jclossls.c): a first row
    (the scan's and each restart's) from `initial` then from the left;
    every other row's first sample from above, the rest by `predictor`."""
    x = x.astype(np.int64)
    ra = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], 1)
    rb = np.concatenate([np.zeros_like(x[:1]), x[:-1]], 0)
    rc = np.concatenate([np.zeros_like(rb[:, :1]), rb[:, :-1]], 1)
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    for r in first_rows:
        pred[r] = ra[r]
        pred[r, 0] = initial
    return (x - pred) & 0xFFFF


def jpeg_lossless(planes, predictor=1, pt=0, ids=None, app=b"", restart=0,
                  interleaved=True, factors=None, precision=8, sof=0xC3):
    """A lossless JPEG (SOF3; `sof` names another marker for a file PIL
    should refuse) of component planes (uint [h, w] each, at the
    component's own size: [ceil(H v / vmax), ceil(W h / hmax)] of the
    frame [H, W] that the first full-size plane sets) at sampling factors
    [(h, v)] (default 1x1), selection value `predictor` (1-7) and point
    transform `pt`: one Huffman table of all 17 difference categories,
    restart markers every `restart` MCUs (a multiple of an MCU row, as
    libjpeg requires), one interleaved scan or one scan per component."""
    nc = len(planes)
    factors = factors or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    full = [i for i, f in enumerate(factors) if f == (hmax, vmax)]
    H, W = planes[full[0] if full else 0].shape
    counts, syms, table = _flat_table(list(range(17)))
    out = b"\xff\xd8" + app
    out += b"\xff\xc4" + struct.pack(">HB", 3 + 16 + len(syms), 0) \
        + bytes(counts) + bytes(syms)
    out += bytes([0xFF, sof]) + struct.pack(">HBHHB", 8 + 3 * nc, precision,
                                            H, W, nc)
    for i, (h, v) in enumerate(factors):
        out += bytes([ids[i], (h << 4) | v, 0])
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    initial = 1 << (precision - pt - 1)

    def scan(slots):
        if len(slots) > 1:
            mx, my = -(-W // hmax), -(-H // vmax)
        else:
            my, mx = planes[slots[0]].shape
        # rows a restart interval spans (at least one, so that a file
        # with a restart inside a row, which libjpeg refuses, is written)
        per = max(1, restart // mx) if restart else my
        diffs = {}
        for s in slots:
            h, v = factors[s] if len(slots) > 1 else (1, 1)
            p = np.asarray(planes[s], np.int64) >> pt
            # interleaved MCUs cover whole MCU rows and columns: pad by
            # replication, as an encoder's edge expansion does
            p = np.pad(p, ((0, my * v - p.shape[0]), (0, mx * h - p.shape[1])),
                       mode="edge")
            # libjpeg restarts the prediction at the first row of each
            # iMCU row that holds a restart: MCU rows of v sample rows
            # when interleaved, v sample rows of a scan of one component
            if len(slots) > 1:
                first = [m * v for m in range(0, my, per)]
            else:
                vs = factors[s][1]
                first = sorted({m - m % vs for m in range(0, my, per)})
            diffs[s] = _lossless_diffs(p, predictor, first, initial)
        hdr = bytes([len(slots)])
        for s in slots:
            hdr += bytes([ids[s], 0])
        hdr += bytes([predictor, 0, pt])
        body = bytearray()
        bits = _Bits()
        n = 0
        for y in range(my):
            for x in range(mx):
                if restart and n and n % restart == 0:
                    bits.flush()
                    body += bits.out + bytes([0xFF, 0xD0 + (n // restart - 1)
                                              % 8])
                    bits = _Bits()
                n += 1
                for s in slots:
                    h, v = factors[s] if len(slots) > 1 else (1, 1)
                    for yy in range(v):
                        for xx in range(h):
                            d = int(diffs[s][y * v + yy, x * h + xx])
                            d = d - 65536 if d > 32768 else d
                            cat = 16 if d == 32768 else _category(d)
                            bits.put(*table[cat])
                            if 0 < cat < 16:
                                bits.put(d if d > 0 else d + (1 << cat) - 1,
                                         cat)
        bits.flush()
        body += bits.out
        return (b"\xff\xda" + struct.pack(">H", 2 + len(hdr)) + hdr
                + bytes(body))

    if interleaved and nc > 1:
        out += scan(list(range(nc)))
    else:
        for s in range(nc):
            out += scan([s])
    return out + b"\xff\xd9"


def jpeg_scan_ends(data):
    """The offset of the marker after each scan's entropy-coded data."""
    pos, ends = 2, []
    while pos < len(data):
        while data[pos] != 0xFF:
            pos += 1
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        pos += struct.unpack_from(">H", data, pos)[0]
        if marker == 0xDA:
            while data[pos] != 0xFF or data[pos + 1] == 0 or (
                    0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
            ends.append(pos)
    return ends


def jpeg_cut(data, scans):
    """A JPEG file cut after its first `scans` scans and closed with EOI,
    as a download stopped at a scan boundary leaves it."""
    return data[:jpeg_scan_ends(data)[scans - 1]] + b"\xff\xd9"
