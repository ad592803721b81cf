"""JPEG decoding with numpy and the standard library: the decoder behind
utils/image_io.py load_png for JPEG files.

The JAX package reads JPEG through PIL, whose decoder is libjpeg-turbo, and
the reference reads it through stb_image. The port reproduces libjpeg-turbo
as PIL drives it, so that both packages hand back the same 8-bit samples:

* frames: SOF0 (baseline), SOF1 (extended Huffman, 8-bit precision), SOF2
  (progressive: spectral selection and successive approximation), SOF3
  (lossless, 8-bit) and SOF9 / SOF10 (sequential and progressive
  arithmetic coding); restart intervals; 1, 3 or 4 components at any
  sampling factors whose ratios to the largest are whole;
* entropy decoding in Python, one lookup per Huffman code (a table of all
  16-bit prefixes, where libjpeg looks 8 bits ahead) and the QM coder of
  jdarith.c; then dequantisation, the `islow` integer IDCT (jidctint.c) with
  its range limit, fancy upsampling (jdsample.c: triangle filters for h2v1,
  h2v2 and h1v2, replication otherwise) and the fixed-point YCbCr to RGB
  tables (jdcolor.c), for all blocks at once in numpy;
* block smoothing (jdcoefct.c decompress_smooth_data), which PIL leaves on:
  where a progressive file's scans leave some of coefficients 1-9
  unrefined (a file cut after a scan, or a script that stops early), each
  still-zero one is predicted from the DC values of the 5x5 blocks around
  it, and where no AC coefficient has arrived the DC is interpolated too;
* lossless frames (jdlhuff.c, jddiffct.c, jdlossls.c): difference
  categories through the same Huffman lookup, undifferenced by the scan's
  predictor modulo 2^16, shifted back by the point transform; subsampled
  components replicated, as libjpeg does without DCT blocks;
* colour spaces as libjpeg guesses them (JFIF or component ids 1, 2, 3:
  YCbCr; an Adobe marker's transform 0: RGB or CMYK; transform 2 or ids
  'R', 'G', 'B' ...; a lossless frame is RGB unless JFIF or Adobe say
  otherwise) and as PIL hands them back: grey [H, W], RGB [H, W, 3], and
  four components as CMYK with every sample inverted (PIL's "CMYK;I", the
  Adobe convention), YCCK converted to CMYK first. EXIF orientation is
  left alone, as PIL leaves it.

What PIL refuses raises NotImplementedError: hierarchical frames (SOF5-7,
SOF13-15), lossless arithmetic coding (SOF11), any precision but 8, a
lossless frame that needs a colour conversion (YCbCr or YCCK), the DNL
marker. A damaged stream raises ValueError.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

# zigzag position -> natural (row-major) position; 16 extra entries keep a
# damaged run inside the block, as jpeg_natural_order does
_NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
            26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
            56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
            45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16

_SOF_NAMES = {0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xCB: "lossless (arithmetic)",
              0xCD: "differential sequential (arithmetic)",
              0xCE: "differential progressive (arithmetic)",
              0xCF: "differential lossless (arithmetic)"}


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qtable", "bw", "bh", "bw_alloc",
                 "bh_alloc", "coef", "dw", "dh", "coef_bits", "samples")


@functools.lru_cache(maxsize=64)
def _huffman_lookup(counts: bytes, symbols: bytes):
    """All 16-bit prefixes -> (code length << 8) | symbol; 0 where no code
    starts (a damaged stream). Cached: a progressive file sends its tables
    again before each scan."""
    tab = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("JPEG: bad Huffman table")
            lo = code << (16 - length)
            tab[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            k += 1
            code += 1
        code <<= 1
    return tuple(tab.tolist())


def _entropy_segments(data: bytes, pos: int):
    """The entropy-coded data from `pos`: (segments split at the restart
    markers, each unstuffed, and the offset of the marker that ends it)."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    stop = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7))]
    end = int(stop[0]) if len(stop) else len(arr)
    ff = ff[ff < end]
    nxt = arr[ff + 1]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    segs, start = [], 0
    for r in [*rst.tolist(), end]:
        seg = arr[start:r]
        stuffed = np.flatnonzero(seg[:-1] == 0xFF) + 1 if len(seg) else seg
        if len(stuffed):
            seg = np.delete(seg, stuffed[seg[stuffed] == 0])
        segs.append(seg)
        start = r + 2
    return segs, pos + end


def _windows(seg: np.ndarray):
    """Big-endian 32-bit words at every byte of a segment (zeros past its
    end, as libjpeg feeds zeros to a stream that runs dry)."""
    b = np.concatenate([seg, np.zeros(8, np.uint8)]).astype(np.int64)
    return ((b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8)
            | b[3:-4]).tolist()


def _mcu_layout(frame, comps, interleaved):
    """Per MCU of a scan, its blocks as (component slot, offset of the
    block's 64 coefficients)."""
    if not interleaved:
        c = comps[0]
        return [[(0, (by * c.bw_alloc + bx) * 64)] for by in range(c.bh)
                for bx in range(c.bw)]
    mx, my = frame["mcux"], frame["mcuy"]
    out = []
    for y in range(my):
        for x in range(mx):
            blocks = []
            for slot, c in enumerate(comps):
                for v in range(c.v):
                    for h in range(c.h):
                        blocks.append((slot, ((y * c.v + v) * c.bw_alloc
                                              + x * c.h + h) * 64))
            out.append(blocks)
    return out


def _check_end(pos, seg, name):
    if pos > 8 * len(seg) + 8:
        raise ValueError(f"{name}: JPEG entropy data ends early")


def _scan_huffman(segs, layout, comps, dc_tabs, ac_tabs, ri, ss, se, ah, al,
                  progressive, name):
    """Decode one Huffman-coded scan into the components' coefficient
    lists (jdhuff.c decode_mcu, jdphuff.c decode_mcu_*)."""
    nat = _NATURAL
    coefs = [c.coef for c in comps]
    nseg = 0
    win = _windows(segs[0])
    pos = 0
    pred = [0] * len(comps)
    eobrun = 0
    first_dc = progressive and ss == 0 and ah == 0
    refine_dc = progressive and ss == 0 and ah > 0
    first_ac = progressive and ss > 0 and ah == 0
    refine_ac = progressive and ss > 0 and ah > 0
    p1, m1 = 1 << al, -1 << al
    for m, blocks in enumerate(layout):
        if ri and m and m % ri == 0:
            _check_end(pos, segs[nseg], name)
            nseg += 1
            if nseg >= len(segs):
                raise ValueError(f"{name}: JPEG restart marker missing")
            win = _windows(segs[nseg])
            pos = 0
            pred = [0] * len(comps)
            eobrun = 0
        for slot, base in blocks:
            co = coefs[slot]
            if not progressive or first_dc:
                e = dc_tabs[slot][(win[pos >> 3] >> (16 - (pos & 7)))
                                  & 0xFFFF]
                if not e:
                    raise ValueError(f"{name}: bad JPEG Huffman code")
                pos += e >> 8
                s = e & 255
                if s:
                    r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & (
                        (1 << s) - 1)
                    pos += s
                    if r < 1 << (s - 1):
                        r -= (1 << s) - 1
                    pred[slot] += r
                if first_dc:
                    co[base] = pred[slot] << al
                    continue
                co[base] = pred[slot]
                tab = ac_tabs[slot]
                k = 1
                while k < 64:
                    e = tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError(f"{name}: bad JPEG Huffman code")
                    pos += e >> 8
                    s = e & 15
                    if s:
                        k += (e >> 4) & 15
                        r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & (
                            (1 << s) - 1)
                        pos += s
                        if r < 1 << (s - 1):
                            r -= (1 << s) - 1
                        co[base + nat[k]] = r
                        k += 1
                    elif (e & 255) == 0xF0:
                        k += 16
                    else:
                        break
            elif refine_dc:
                if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                    co[base] |= p1
                pos += 1
            elif first_ac:
                if eobrun:
                    eobrun -= 1
                    continue
                tab = ac_tabs[slot]
                k = ss
                while k <= se:
                    e = tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError(f"{name}: bad JPEG Huffman code")
                    pos += e >> 8
                    s = e & 15
                    r = (e >> 4) & 15
                    if s:
                        k += r
                        v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & (
                            (1 << s) - 1)
                        pos += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        co[base + nat[k]] = v << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)
                                       ) & ((1 << r) - 1)
                            pos += r
                        eobrun -= 1
                        break
                    k += 1
            else:  # refine_ac
                k = ss
                if not eobrun:
                    tab = ac_tabs[slot]
                    while k <= se:
                        e = tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError(f"{name}: bad JPEG Huffman code")
                        pos += e >> 8
                        s = e & 15
                        r = (e >> 4) & 15
                        if s:
                            s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 \
                                else m1
                            pos += 1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += (win[pos >> 3] >> (
                                    32 - (pos & 7) - r)) & ((1 << r) - 1)
                                pos += r
                            break
                        while k <= se:
                            i = base + nat[k]
                            c = co[i]
                            if c:
                                if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                                    if not c & p1:
                                        co[i] = c + p1 if c >= 0 else c + m1
                                pos += 1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            co[base + nat[k]] = s
                        k += 1
                if eobrun:
                    while k <= se:
                        i = base + nat[k]
                        c = co[i]
                        if c:
                            if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                                if not c & p1:
                                    co[i] = c + p1 if c >= 0 else c + m1
                            pos += 1
                        k += 1
                    eobrun -= 1
    _check_end(pos, segs[nseg], name)


# ---------------------------------------------------------------------------
# arithmetic decoding (jdarith.c)
# ---------------------------------------------------------------------------

# the QM coder's probability estimation state machine (jaricom.c): Qe,
# next state after an LPS, next state after an MPS, switch-MPS flag
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
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1),
    (0x5a1d, 113, 113, 0)]  # 113: the fixed 0.5 of signs and refinements


class _ArithDecoder:
    """The QM decoder of jdarith.c (arith_decode) over one restart
    interval; past its end it reads zeros, as libjpeg does at a marker."""

    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, seg: np.ndarray):
        self.data = seg.tolist()
        self.pos = 0
        self.c = 0
        self.a = 0
        self.ct = -16  # two initial bytes to read

    def decode(self, st, i):
        """One binary decision with the statistics bin st[i]."""
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                data = 0
                if self.pos < len(self.data):
                    data = self.data[self.pos]
                    self.pos += 1
                self.c = (self.c << 8) | data
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000  # 0x10000 after the shift below
            self.a <<= 1
        sv = st[i]
        qe, nlps, nmps, switch = _QM[sv & 0x7F]
        nl = nlps | (switch << 7)
        self.a -= qe
        temp = self.a << self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:  # conditional LPS exchange
                self.a = qe
                st[i] = (sv & 0x80) ^ nmps
            else:
                self.a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:  # conditional MPS exchange
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nmps
        return sv >> 7


def _arith_value(d, st, si, mag_bin):
    """Figures F.21-F.24 after the sign: the magnitude category from bin
    si, then from mag_bin on (DC: bin 20; AC: one more decision at si
    first, then bin 189 or 217), then its bits from 14 bins further;
    returns |v|."""
    m = 0
    if d(st, si):
        m = 1
        if mag_bin == 20 or d(st, si):
            if mag_bin != 20:
                m <<= 1
            si = mag_bin
            while d(st, si):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("JPEG: bad arithmetic code")
                si += 1
    v = m
    si += 14
    m >>= 1
    while m:
        if d(st, si):
            v |= m
        m >>= 1
    return v + 1


def _scan_arith(segs, layout, comps, dc_tbl, ac_tbl, dc_cond, ac_cond, ri,
                ss, se, ah, al, progressive, name):
    """Decode one arithmetic-coded scan (jdarith.c decode_mcu and
    decode_mcu_DC_first / _AC_first / _DC_refine / _AC_refine). The
    statistics belong to the tables, the DC predictions and contexts to
    the components; all restart at each interval."""
    nat = _NATURAL
    ncomp = len(comps)
    coefs = [c.coef for c in comps]
    fixed = [113]
    p1, m1 = 1 << al, -1 << al
    do_dc = ss == 0 and ah == 0
    do_ac = se > 0 and (not progressive or ss > 0)
    k_first = ss if progressive else 1
    nseg = -1
    for m, blocks in enumerate(layout):
        if m == 0 or (ri and m % ri == 0):
            nseg += 1
            if nseg >= len(segs):
                raise ValueError(f"{name}: JPEG restart marker missing")
            dec = _ArithDecoder(segs[nseg])
            d = dec.decode
            dc_stats = {t: [0] * 64 for t in dc_tbl}
            ac_stats = {t: [0] * 256 for t in ac_tbl}
            last_dc = [0] * ncomp
            dc_ctx = [0] * ncomp
        for slot, base in blocks:
            co = coefs[slot]
            if do_dc:
                st = dc_stats[dc_tbl[slot]]
                s0 = dc_ctx[slot]
                if not d(st, s0):
                    dc_ctx[slot] = 0
                else:
                    sign = d(st, s0 + 1)
                    v = _arith_value(d, st, s0 + 2 + sign, 20)
                    # the conditioning category of the next block, from
                    # the magnitude category (the top bit of |v| - 1)
                    mv = 1 << (v - 1).bit_length() >> 1
                    lo, hi = dc_cond[dc_tbl[slot]]
                    if mv < (1 << lo) >> 1:
                        dc_ctx[slot] = 0
                    elif mv > (1 << hi) >> 1:
                        dc_ctx[slot] = 12 + sign * 4
                    else:
                        dc_ctx[slot] = 4 + sign * 4
                    last_dc[slot] += -v if sign else v
                co[base] = last_dc[slot] << al
            elif ss == 0:  # DC refinement
                if d(fixed, 0):
                    co[base] |= p1
            if not do_ac:
                continue
            st = ac_stats[ac_tbl[slot]]
            kx = ac_cond[ac_tbl[slot]]
            if not progressive or ah == 0:
                k = k_first
                while k <= se:
                    si = 3 * (k - 1)
                    if d(st, si):
                        break  # EOB
                    while not d(st, si + 1):
                        si += 3
                        k += 1
                        if k > se:
                            raise ValueError(
                                f"{name}: bad JPEG arithmetic code")
                    sign = d(fixed, 0)
                    v = _arith_value(d, st, si + 2, 189 if k <= kx else 217)
                    co[base + nat[k]] = (-v if sign else v) << al
                    k += 1
            else:  # AC refinement
                kex = se
                while kex > 0 and not co[base + nat[kex]]:
                    kex -= 1
                k = ss
                while k <= se:
                    si = 3 * (k - 1)
                    if k > kex and d(st, si):
                        break  # EOB
                    while True:
                        i = base + nat[k]
                        c = co[i]
                        if c:
                            if d(st, si + 2):
                                co[i] = c + m1 if c < 0 else c + p1
                            break
                        if d(st, si + 1):
                            co[i] = m1 if d(fixed, 0) else p1
                            break
                        si += 3
                        k += 1
                        if k > se:
                            raise ValueError(
                                f"{name}: bad JPEG arithmetic code")
                    k += 1



# ---------------------------------------------------------------------------
# lossless frames (jdlhuff.c, jddiffct.c, jdlossls.c)
# ---------------------------------------------------------------------------


def _scan_lossless(segs, frame, comps, tabs, ri, name):
    """The Huffman-coded differences of one lossless scan (jdlhuff.c), one
    array per component: [MCU rows * v, MCUs per row * h] of an
    interleaved scan (each MCU holds v rows of h samples of each
    component), the component's own [dh, dw] of a scan of one; and per
    component the rows whose prediction restarts."""
    if len(comps) > 1:
        mx, my = frame["mcux"], frame["mcuy"]
        shapes = [(c.v, c.h) for c in comps]
    else:
        my, mx = comps[0].dh, comps[0].dw
        shapes = [(1, 1)]
    if ri % mx:
        raise ValueError(f"{name}: lossless JPEG restart interval {ri} is "
                         f"not a whole number of MCU rows ({mx} MCUs)")
    unit_tabs = [t for t, (v, h) in zip(tabs, shapes) for _ in range(v * h)]
    diffs = []
    nseg = 0
    win = _windows(segs[0])
    pos = 0
    for m in range(mx * my):
        if ri and m and m % ri == 0:
            _check_end(pos, segs[nseg], name)
            nseg += 1
            if nseg >= len(segs):
                raise ValueError(f"{name}: JPEG restart marker missing")
            win = _windows(segs[nseg])
            pos = 0
        for tab in unit_tabs:
            e = tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                raise ValueError(f"{name}: bad JPEG Huffman code")
            pos += e >> 8
            s = e & 255
            if s == 16:
                diffs.append(32768)
            elif s:
                r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                diffs.append(r if r >= 1 << (s - 1) else r - (1 << s) + 1)
            else:
                diffs.append(0)
    _check_end(pos, segs[nseg], name)
    d = np.array(diffs, np.int64).reshape(my, mx, -1)
    out, o = [], 0
    for v, h in shapes:
        u = d[:, :, o:o + v * h].reshape(my, mx, v, h)
        out.append(u.transpose(0, 2, 1, 3).reshape(my * v, mx * h))
        o += v * h
    # the MCU rows that start the scan or a restart interval. jddiffct.c
    # decodes an iMCU row whole before it undifferences its rows, so the
    # predictor restarts at the first row of an iMCU row that holds such
    # an MCU row: one MCU row of v sample rows when interleaved, v rows
    # of one sample row each in a scan of one component
    starts = range(0, my, ri // mx if ri else my)
    if len(comps) > 1:
        return out, [{m * c.v for m in starts} for c in comps]
    v = comps[0].v
    return out, [{m - m % v for m in starts}]


def _undifference(d: np.ndarray, predictor: int, first_rows,
                  initial: int) -> np.ndarray:
    """jdlossls.c on one component's differences [R, C]: the rows in
    `first_rows` (the scan's first and each restart's) from `initial`,
    then from the left; every other row's first sample from above, the
    rest by the selection value (Ra left, Rb above, Rc above left); all
    modulo 2^16. Predictors 1-5 are linear in Ra, so their rows are
    cumulative sums."""
    rows, cols = d.shape
    x = np.empty_like(d)
    for r in range(rows):
        row = d[r]
        if r in first_rows:
            x[r] = (np.cumsum(row) + initial) & 0xFFFF
            continue
        up = x[r - 1]
        if predictor == 2:
            x[r] = (row + up) & 0xFFFF
        elif predictor == 3:
            x[r, 0] = (row[0] + up[0]) & 0xFFFF
            x[r, 1:] = (row[1:] + up[:-1]) & 0xFFFF
        elif predictor in (1, 4, 5):
            step = row.copy()
            if predictor == 4:
                step[1:] += up[1:] - up[:-1]
            elif predictor == 5:
                step[1:] += (up[1:] - up[:-1]) >> 1
            x[r] = (np.cumsum(step) + up[0]) & 0xFFFF
        else:  # 6: Rb + ((Ra - Rc) >> 1), 7: (Ra + Rb) >> 1
            dl, ul = row.tolist(), up.tolist()
            ra = (dl[0] + ul[0]) & 0xFFFF
            out = [ra]
            for i in range(1, cols):
                if predictor == 6:
                    ra = (dl[i] + ul[i] + ((ra - ul[i - 1]) >> 1)) & 0xFFFF
                else:
                    ra = (dl[i] + ((ra + ul[i]) >> 1)) & 0xFFFF
                out.append(ra)
            x[r] = out
    return x


def _lossless_samples(frame, comps, jfif, adobe, transform, name):
    """The samples of a lossless frame as PIL hands them back: libjpeg
    converts no colour in lossless mode, so it refuses a frame whose
    colour space it takes for YCbCr or YCCK, and replicates subsampled
    components (its fancy upsampling needs DCT blocks)."""
    w, h = frame["w"], frame["h"]
    nc = len(comps)
    if nc == 3 and (jfif or (adobe and transform != 0)):
        raise NotImplementedError(
            f"{name}: lossless JPEG in YCbCr (libjpeg converts no colour in "
            f"lossless mode)")
    if nc == 4 and adobe and transform != 0:
        raise NotImplementedError(
            f"{name}: lossless JPEG in YCCK (libjpeg converts no colour in "
            f"lossless mode)")
    hmax, vmax = frame["hmax"], frame["vmax"]
    planes = []
    for c in comps:
        if c.samples is None:
            raise ValueError(f"{name}: a lossless JPEG component has no scan")
        if hmax % c.h or vmax % c.v:
            raise NotImplementedError(
                f"JPEG sampling factors {c.h}x{c.v} against {hmax}x{vmax} "
                f"(libjpeg refuses fractional ratios)")
        p = np.repeat(np.repeat(c.samples, vmax // c.v, axis=0),
                      hmax // c.h, axis=1)
        planes.append(p[:h, :w])
    if nc == 1:
        return planes[0]
    out = np.stack(planes, axis=-1)
    return out if nc == 3 else 255 - out


# ---------------------------------------------------------------------------
# block smoothing (jdcoefct.c smoothing_ok, decompress_smooth_data)
# ---------------------------------------------------------------------------


def _grid(*rows):
    """A 5x5 weight grid over the DC values two blocks around a block (row
    0 two block rows above, column 0 two block columns left); a row given
    as one list of five stands for itself, one number for a row of zeros."""
    return np.array([r if isinstance(r, list) else [0] * 5 for r in rows],
                    np.int64)


# per zigzag coefficient 1-9: the weights of the AC prediction (only 1-5
# are predicted there) and of the DC interpolation, used when no AC
# coefficient of the component has arrived; _DC_WEIGHTS replaces the DC
# then. Each sum is scaled by Q00 and divided by Qk << 8, rounded half
# away from zero.
_AC01 = _grid([-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
              [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1])
_AC20 = _grid([0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
              [0, 2, 7, 2, 0], [0, 0, 1, 0, 0])
_AC03 = _grid(0, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], 0)
_AC12 = _grid(0, [0, 1, -3, 1, 0], 0, [0, -1, 3, -1, 0], 0)
_SMOOTH_AC = [
    None,
    _grid(0, 0, [-7, 50, 0, -50, 7], 0, 0),
    _grid(0, 0, [-7, 50, 0, -50, 7], 0, 0).T,
    _grid(0, 0, [-1, 13, -24, 13, -1], 0, 0).T,
    _grid([0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], 0, [1, -10, 0, 10, -1],
          [0, 1, 0, -1, 0]),
    _grid(0, 0, [-1, 13, -24, 13, -1], 0, 0)]
_SMOOTH_DC = [
    None, _AC01, _AC01.T, _AC20,
    _grid([-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], 0, [0, -9, 0, 9, 0],
          [1, 0, 0, 0, -1]),
    _AC20.T, _AC03, _AC12, _AC12.T, _AC03.T]
_DC_WEIGHTS = _grid([-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                    [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                    [-2, -6, -8, -6, -2])


def _smooth_rows(bh: int, v: int, imcu_rows: int) -> np.ndarray:
    """The block rows [r - 2, r - 1, r, r + 1, r + 2] that
    decompress_smooth_data reads for each block row r < bh of a component
    [bh, 5]: clamped at the image's edges as libjpeg counts them, from
    the block rows of the current iMCU row (fewer in the last one), so a
    row past bh can be read where a component's height is not a whole
    number of iMCU rows."""
    out = []
    for m in range(imcu_rows):
        nrows = v if m < imcu_rows - 1 else (bh % v or v)
        total = nrows * imcu_rows
        for br in range(nrows):
            r, i = m * v + br, m * nrows + br
            up = r - 1 if i > 0 else r
            up2 = r - 2 if i > 1 else up
            down = r + 1 if i < total - 1 else r
            down2 = r + 2 if i < total - 2 else down
            out.append([up2, up, r, down, down2])
    return np.array(out[:bh], np.int64)


def _smoothing_ok(frame, comps) -> bool:
    """jdcoefct.c smoothing_ok, over all components at once: a progressive
    frame, every DC at least partly known, no zero among the quantisation
    steps of coefficients 0-9, and some of coefficients 1-9 of some
    component not yet known to full precision."""
    if not frame["progressive"]:
        return False
    for c in comps:
        if (c.qtable is None or c.coef_bits[0] < 0
                or not all(c.qtable[_NATURAL[:10]])):
            return False
    return any(b for c in comps for b in c.coef_bits[1:10])


def _smooth(c: _Component, coef: np.ndarray, imcu_rows: int) -> np.ndarray:
    """decompress_smooth_data for one component's coefficients [bh_alloc,
    bw_alloc, 64]: each coefficient 1-9 still zero and not known to full
    precision is predicted from the DC values of the 5x5 blocks around it;
    where no AC coefficient has arrived the DC is interpolated too."""
    bits = c.coef_bits
    change_dc = all(b == -1 for b in bits[1:10])
    weights = _SMOOTH_DC if change_dc else _SMOOTH_AC
    rows = _smooth_rows(c.bh, c.v, imcu_rows)
    cols = np.clip(np.arange(c.bw)[:, None] + np.arange(-2, 3), 0, c.bw - 1)
    dcs = coef[..., 0][rows[:, None, :, None], cols[None, :, None, :]]
    coef = coef.copy()
    blocks = coef[:c.bh, :c.bw]
    q = c.qtable
    q00 = int(q[0])

    def predict(w, qk, al):
        num = q00 * np.tensordot(dcs, w, 2)
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        return np.where(num < 0, -pred, pred)

    for k in range(1, len(weights)):
        if bits[k]:
            p = _NATURAL[k]
            cur = blocks[..., p]
            blocks[..., p] = np.where(cur == 0, predict(
                weights[k], int(q[p]), bits[k]), cur)
    if change_dc:
        blocks[..., 0] = predict(_DC_WEIGHTS, q00, 0)
    return coef

# ---------------------------------------------------------------------------
# samples: the islow IDCT, upsampling, colour conversion
# ---------------------------------------------------------------------------


def _idct_pass(x):
    """jidctint.c's butterfly over the first axis of x [8, ...] (int64),
    before the descale."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3])


# the IDCT's output range limit (jdmaster.c prepare_range_limit_table):
# index (x & 1023) -> x + 128 clamped to [0, 255], with x taken mod 1024
# into [-512, 511]
_RANGE = np.clip((np.arange(1024) + 512) % 1024 - 512 + 128, 0,
                 255).astype(np.uint8)


def _idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-transform blocks [N, 64] (natural order) into
    samples [N, 8, 8] uint8, exactly as jpeg_idct_islow."""
    x = coef.astype(np.int64) * qtable.astype(np.int64)
    x = x.reshape(-1, 8, 8).transpose(1, 0, 2)  # [row k, N, column]
    ws = (_idct_pass(x) + (1 << 10)) >> 11  # pass 1 over the columns
    ws = ws.transpose(2, 1, 0)  # [column, N, row]
    out = (_idct_pass(ws) + (1 << 17)) >> 18  # pass 2 over the rows
    return _RANGE[out.transpose(1, 2, 0) & 1023]  # [N, row, column]


def _plane(c: _Component, coef: np.ndarray) -> np.ndarray:
    """A component's samples over its allocated blocks [bh * 8, bw * 8]
    from its coefficients [bh_alloc, bw_alloc, 64]."""
    px = _idct_islow(coef.reshape(-1, 64), c.qtable)
    return px.reshape(c.bh_alloc, c.bw_alloc, 8, 8).transpose(
        0, 2, 1, 3).reshape(c.bh_alloc * 8, c.bw_alloc * 8)


def _fancy_h2(x: np.ndarray, dw: int, b_left: int, b_right: int,
              shift: int) -> np.ndarray:
    """Horizontal triangle filter on columns [0, dw) (edges clamped): out
    2i = (3 x_i + x_{i-1} + b_left) >> shift, out 2i+1 = (3 x_i + x_{i+1}
    + b_right) >> shift."""
    x = x[:, :dw]
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * dw), np.int64)
    out[:, 0::2] = (3 * x + left + b_left) >> shift
    out[:, 1::2] = (3 * x + right + b_right) >> shift
    return out


def _upsample(p: np.ndarray, c: _Component, hmax: int, vmax: int):
    """jdsample.c for one component: the full-resolution plane (at least
    the image's size; the caller crops)."""
    h_in, v_in = c.h, c.v
    dw, dh = c.dw, c.dh
    p = p.astype(np.int64)
    if h_in == hmax and v_in == vmax:
        return p
    if h_in * 2 == hmax and v_in == vmax:  # h2v1
        if dw > 2:
            return _fancy_h2(p[:dh], dw, 1, 2, 2)
        return np.repeat(p, 2, axis=1)
    if h_in == hmax and v_in * 2 == vmax:  # h1v2, always fancy
        x = p[:dh]
        up = np.concatenate([x[:1], x[:-1]])
        down = np.concatenate([x[1:], x[-1:]])
        out = np.empty((2 * dh, x.shape[1]), np.int64)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out
    if h_in * 2 == hmax and v_in * 2 == vmax:  # h2v2
        if dw > 2:
            x = p[:dh, :dw]
            up = np.concatenate([x[:1], x[:-1]])
            down = np.concatenate([x[1:], x[-1:]])
            out = np.empty((2 * dh, 2 * dw), np.int64)
            for r, far in ((0, up), (1, down)):  # over column sums
                out[r::2] = _fancy_h2(3 * x + far, dw, 8, 7, 4)
            return out
        return np.repeat(np.repeat(p, 2, axis=0), 2, axis=1)
    if hmax % h_in == 0 and vmax % v_in == 0:
        return np.repeat(np.repeat(p, vmax // v_in, axis=0), hmax // h_in,
                         axis=1)
    raise NotImplementedError(
        f"JPEG sampling factors {h_in}x{v_in} against {hmax}x{vmax} "
        f"(libjpeg refuses fractional ratios)")


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_to_rgb(y, cb, cr):
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return [np.clip(v, 0, 255) for v in (r, g, b)]


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------


def decode_jpeg(data: bytes, name: str = "JPEG data") -> np.ndarray:
    """The samples of a JPEG file as PIL hands them back: uint8 [H, W]
    (grey), [H, W, 3] (RGB) or [H, W, 4] (CMYK, inverted)."""
    if data[:3] != b"\xff\xd8\xff":
        raise ValueError(f"{name}: not a JPEG file")
    pos = 2
    qtables = {}
    dc_tables, ac_tables = {}, {}
    dc_cond = {i: (0, 1) for i in range(4)}  # (L, U) per DC table
    ac_cond = {i: 5 for i in range(4)}  # Kx per AC table
    frame = None
    comps = []
    ri = 0
    jfif = adobe = False
    transform = None
    layouts = {}  # a scan's MCU layout by its components, reused
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1  # junk between segments, as libjpeg skips it
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            if frame is not None and all(
                    c.qtable is not None or c.samples is not None
                    for c in comps):
                break  # no EOI after the last scan, as libjpeg allows
            raise ValueError(f"{name}: JPEG ends before its image")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        (length,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + length]
        if len(seg) < length - 2:
            raise ValueError(f"{name}: JPEG segment runs past the end")
        pos += length
        if marker == 0xE0 and seg[:5] == b"JFIF\x00" and len(seg) >= 14:
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = True
            transform = seg[11]
        elif marker == 0xDB:  # DQT
            o = 0
            while o < len(seg):
                pq, tq = seg[o] >> 4, seg[o] & 15
                o += 1
                if pq:
                    zz = struct.unpack_from(">64H", seg, o)
                    o += 128
                else:
                    zz = seg[o:o + 64]
                    o += 64
                q = np.zeros(64, np.int64)
                q[_NATURAL[:64]] = list(zz)
                qtables[tq] = q
        elif marker == 0xC4:  # DHT
            o = 0
            while o < len(seg):
                tc, th = seg[o] >> 4, seg[o] & 15
                counts = bytes(seg[o + 1:o + 17])
                syms = bytes(seg[o + 17:o + 17 + sum(counts)])
                o += 17 + sum(counts)
                (ac_tables if tc else dc_tables)[th] = _huffman_lookup(
                    counts, syms)
        elif marker == 0xCC:  # DAC: arithmetic conditioning
            for o in range(0, len(seg) - 1, 2):
                tc, tb, cs = seg[o] >> 4, seg[o] & 15, seg[o + 1]
                if tc:
                    ac_cond[tb] = cs
                else:
                    dc_cond[tb] = (cs & 15, cs >> 4)
        elif marker == 0xDD:  # DRI
            (ri,) = struct.unpack_from(">H", seg, 0)
        elif marker == 0xDC:
            raise NotImplementedError(f"{name}: JPEG with a DNL marker")
        elif marker in _SOF_NAMES:
            raise NotImplementedError(
                f"{name}: {_SOF_NAMES[marker]} JPEG (SOF{marker - 0xC0})")
        elif marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            if frame is not None:
                raise ValueError(f"{name}: JPEG with two frames")
            prec, h, w, nc = struct.unpack_from(">BHHB", seg, 0)
            lossless = marker == 0xC3
            if prec != 8:
                raise NotImplementedError(
                    f"{name}: {prec}-bit {'lossless ' * lossless}JPEG (8-bit "
                    f"samples only, as PIL reads)")
            if nc not in (1, 3, 4) or w == 0 or h == 0:
                raise NotImplementedError(
                    f"{name}: JPEG with {nc} components, size {w}x{h}")
            for i in range(nc):
                c = _Component()
                c.cid, hv, c.tq = seg[6 + 3 * i], seg[7 + 3 * i], \
                    seg[8 + 3 * i]
                c.h, c.v = hv >> 4, hv & 15
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                    raise ValueError(f"{name}: bad JPEG sampling factors")
                c.qtable = None
                comps.append(c)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            unit = 1 if lossless else 8  # a lossless data unit: 1 sample
            mcux = -(-w // (unit * hmax))
            mcuy = -(-h // (unit * vmax))
            for c in comps:
                c.dw = -(-w * c.h // hmax)
                c.dh = -(-h * c.v // vmax)
                c.samples = None
                if lossless:
                    continue
                c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
                c.bw_alloc, c.bh_alloc = mcux * c.h, mcuy * c.v
                c.coef = [0] * (c.bw_alloc * c.bh_alloc * 64)
                c.coef_bits = [-1] * 64
            frame = {"w": w, "h": h, "mcux": mcux, "mcuy": mcuy,
                     "hmax": hmax, "vmax": vmax, "lossless": lossless,
                     "progressive": marker in (0xC2, 0xCA),
                     "arith": marker in (0xC9, 0xCA)}
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame")
            ns = seg[0]
            by_id = {c.cid: c for c in comps}
            scomps, tds, tas = [], [], []
            for i in range(ns):
                c = by_id.get(seg[1 + 2 * i])
                if c is None:
                    raise ValueError(f"{name}: JPEG scan names no component")
                scomps.append(c)
                tds.append(seg[2 + 2 * i] >> 4)
                tas.append(seg[2 + 2 * i] & 15)
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            if frame["lossless"]:  # Ss: the predictor, Al: point transform
                if not 1 <= ss <= 7 or se or ah or al >= 8:
                    raise ValueError(f"{name}: bad lossless JPEG scan")
                try:
                    tabs = [dc_tables[t] for t in tds]
                except KeyError:
                    raise ValueError(f"{name}: JPEG Huffman table missing")
                segs, pos = _entropy_segments(data, pos)
                diffs, firsts = _scan_lossless(segs, frame, scomps, tabs, ri,
                                               name)
                for c, d, first in zip(scomps, diffs, firsts):
                    x = _undifference(d, ss, first, 1 << (7 - al))
                    c.samples = ((x[:c.dh, :c.dw] << al) & 255).astype(
                        np.uint8)
                continue
            progressive = frame["progressive"]
            if not progressive:
                ss, se, ah, al = 0, 63, 0, 0
            elif (ss == 0) != (se == 0) or se > 63 or ss > se or (
                    ss and ns != 1):
                raise ValueError(f"{name}: bad progressive JPEG scan")
            for c in scomps:
                if c.qtable is None:  # latched at its first scan (libjpeg)
                    if c.tq not in qtables:
                        raise ValueError(f"{name}: JPEG quantisation table "
                                         f"{c.tq} missing")
                    c.qtable = qtables[c.tq]
                for k in range(ss, se + 1):
                    c.coef_bits[k] = al
            interleaved = ns > 1
            if interleaved and sum(c.h * c.v for c in scomps) > 10:
                raise ValueError(f"{name}: more than 10 blocks in a JPEG MCU")
            key = tuple(c.cid for c in scomps)
            if key not in layouts:
                layouts[key] = _mcu_layout(frame, scomps, interleaved)
            layout = layouts[key]
            segs, pos = _entropy_segments(data, pos)
            if frame["arith"]:
                _scan_arith(segs, layout, scomps, tds, tas, dc_cond, ac_cond,
                            ri, ss, se, ah, al, progressive, name)
            else:
                try:
                    dct = [dc_tables[t] for t in tds] if ss == 0 else None
                    act = [ac_tables[t] for t in tas] if (
                        se > 0 and not (ss == 0 and progressive)) else None
                except KeyError:
                    raise ValueError(f"{name}: JPEG Huffman table missing")
                _scan_huffman(segs, layout, scomps, dct, act, ri, ss, se, ah,
                              al, progressive, name)
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame")
    if frame["lossless"]:
        return _lossless_samples(frame, comps, jfif, adobe, transform, name)
    return _samples(frame, comps, jfif, adobe, transform, name)


def _samples(frame, comps, jfif, adobe, transform, name):
    w, h = frame["w"], frame["h"]
    if all(c.qtable is None for c in comps):
        raise ValueError(f"{name}: JPEG without a scan")
    smooth = _smoothing_ok(frame, comps)
    for c in comps:
        if c.qtable is None:  # no scan reached it: libjpeg's IDCT has no
            c.qtable = np.zeros(64, np.int64)  # table and gives 128
    hmax, vmax = frame["hmax"], frame["vmax"]
    planes = []
    for c in comps:
        coef = np.asarray(c.coef, np.int64).reshape(c.bh_alloc, c.bw_alloc,
                                                    64)
        if smooth:
            coef = _smooth(c, coef, frame["mcuy"])
        planes.append(_upsample(_plane(c, coef), c, hmax, vmax)[:h, :w])
    nc = len(comps)
    if nc == 1:
        return planes[0].astype(np.uint8)
    if nc == 3:
        ids = tuple(c.cid for c in comps)
        if jfif:
            rgb = False
        elif adobe:
            rgb = transform == 0
        else:
            rgb = ids == (82, 71, 66)
        out = planes if rgb else _ycc_to_rgb(*planes)
        return np.stack(out, axis=-1).astype(np.uint8)
    # four components: CMYK, or YCCK (Adobe transform 2 or other non-zero),
    # handed back inverted as PIL's "CMYK;I" unpacks them
    if adobe and transform != 0:
        r, g, b = _ycc_to_rgb(*planes[:3])
        cmy = [np.clip(255 - v, 0, 255) for v in (r, g, b)]
        out = [*cmy, planes[3]]
    else:
        out = planes
    return (255 - np.stack(out, axis=-1)).astype(np.uint8)
