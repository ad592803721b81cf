"""BC7 and BC6H block decompression (host, numpy; port of
gfxexp_tpu/scene/bc67.py, kept as the port's own copy).

Both formats follow the D3D11 functional specification:

- BC7: 8 modes, 1-3 subsets, per-mode endpoint precisions with optional
  shared/per-endpoint P-bits, 2/3/4-bit palette indices with anchor-bit
  compression, optional channel rotation and dual index sets (modes 4/5).
- BC6H (unsigned, DXGI_FORMAT_BC6H_UF16): 14 modes, half-float endpoints
  with per-mode quantization and optional delta transform, 1 or 2 subsets
  sharing BC7's 2-subset partition/anchor tables (first 32 entries).

Decoders work a block at a time (texture decode is a one-time host-side
load cost); the DDS entry point is scene/textures.py `load_dds`, which
dispatches here for BC6H/BC7 payloads.
"""

from __future__ import annotations

import numpy as np

# 2-subset partition assignments (D3D spec Table P2, 64 patterns x 16 texels)
_P2 = [
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
    0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
    0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
    0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22,
]

# 3-subset partition assignments (2 bits per texel, texel 0 at the LSB pair)
_P3_RAW = [
    [0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 1, 2, 2, 2, 2],
    [0, 0, 0, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 2, 1],
    [0, 0, 0, 0, 2, 0, 0, 1, 2, 2, 1, 1, 2, 2, 1, 1],
    [0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2],
    [0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 2, 2],
    [0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2],
    [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2],
    [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2],
    [0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2],
    [0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2],
    [0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2, 1, 2, 2, 2],
    [0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0, 2, 2, 2, 0],
    [0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2],
    [0, 1, 1, 1, 0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0],
    [0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2],
    [0, 0, 2, 2, 0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1],
    [0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2, 0, 2, 2, 2],
    [0, 0, 0, 1, 0, 0, 0, 1, 2, 2, 2, 1, 2, 2, 2, 1],
    [0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2],
    [0, 0, 0, 0, 1, 1, 0, 0, 2, 2, 1, 0, 2, 2, 1, 0],
    [0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1, 0, 0, 0, 0],
    [0, 0, 1, 2, 0, 0, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2],
    [0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1, 0, 1, 1, 0],
    [0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1],
    [0, 0, 2, 2, 1, 1, 0, 2, 1, 1, 0, 2, 0, 0, 2, 2],
    [0, 1, 1, 0, 0, 1, 1, 0, 2, 0, 0, 2, 2, 2, 2, 2],
    [0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1],
    [0, 0, 0, 0, 2, 0, 0, 0, 2, 2, 1, 1, 2, 2, 2, 1],
    [0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 2, 2, 2],
    [0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 2, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 2, 0, 2, 2, 2],
    [0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0],
    [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0],
    [0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0],
    [0, 1, 2, 0, 2, 0, 1, 2, 1, 2, 0, 1, 0, 1, 2, 0],
    [0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2, 2, 0, 0, 1, 1],
    [0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0, 1, 1],
    [0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1],
    [0, 0, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2, 1, 1, 2, 2],
    [0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 1, 1],
    [0, 2, 2, 0, 1, 2, 2, 1, 0, 2, 2, 0, 1, 2, 2, 1],
    [0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 0, 1, 0, 1],
    [0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1],
    [0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2],
    [0, 2, 2, 2, 0, 1, 1, 1, 0, 2, 2, 2, 0, 1, 1, 1],
    [0, 0, 0, 2, 1, 1, 1, 2, 0, 0, 0, 2, 1, 1, 1, 2],
    [0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2],
    [0, 2, 2, 2, 0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2],
    [0, 0, 0, 2, 1, 1, 1, 2, 1, 1, 1, 2, 0, 0, 0, 2],
    [0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2],
    [0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2],
    [0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2],
    [0, 0, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2],
    [0, 0, 0, 2, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 1],
    [0, 2, 2, 2, 1, 2, 2, 2, 0, 2, 2, 2, 1, 2, 2, 2],
    [0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 1, 1, 1, 2, 0, 1, 1, 2, 2, 0, 1, 2, 2, 2, 0],
]

# anchor index of the SECOND subset in 2-subset modes
_ANCHOR2 = [
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 6, 15, 15, 15, 2, 2, 15,
]
# anchor indices of the second/third subsets in 3-subset modes
_ANCHOR3A = [
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3,
]
_ANCHOR3B = [
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8,
]

_W2 = [0, 21, 43, 64]
_W3 = [0, 9, 18, 27, 37, 46, 55, 64]
_W4 = [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64]
_WEIGHTS = {2: _W2, 3: _W3, 4: _W4}


class _BitReader:
    """LSB-first reader over a 16-byte block."""

    def __init__(self, block: bytes):
        self.v = int.from_bytes(block, "little")
        self.pos = 0

    def get(self, n: int) -> int:
        r = (self.v >> self.pos) & ((1 << n) - 1)
        self.pos += n
        return r


def _subset_of(n_subsets: int, partition: int, texel: int) -> int:
    if n_subsets == 1:
        return 0
    if n_subsets == 2:
        return (_P2[partition] >> texel) & 1
    return _P3_RAW[partition][texel]


def _anchor_of(n_subsets: int, partition: int, subset: int) -> int:
    if subset == 0:
        return 0
    if n_subsets == 2:
        return _ANCHOR2[partition]
    return _ANCHOR3A[partition] if subset == 1 else _ANCHOR3B[partition]


def _expand8(v: int, bits: int) -> int:
    v = v << (8 - bits)
    return v | (v >> bits)


def _interp(e0: int, e1: int, w: int) -> int:
    return ((64 - w) * e0 + w * e1 + 32) >> 6


# (subsets, partition_bits, rotation_bits, idx_mode_bits, color_bits,
#  alpha_bits, p_mode, index_bits, index2_bits) — p_mode: 0 none,
#  1 per-endpoint, 2 shared-per-subset
_BC7_MODES = {
    0: (3, 4, 0, 0, 4, 0, 1, 3, 0),
    1: (2, 6, 0, 0, 6, 0, 2, 3, 0),
    2: (3, 6, 0, 0, 5, 0, 0, 2, 0),
    3: (2, 6, 0, 0, 7, 0, 1, 2, 0),
    4: (1, 0, 2, 1, 5, 6, 0, 2, 3),
    5: (1, 0, 2, 0, 7, 8, 0, 2, 2),
    6: (1, 0, 0, 0, 7, 7, 1, 4, 0),
    7: (2, 6, 0, 0, 5, 5, 1, 2, 0),
}


def decode_bc7_block(block: bytes) -> np.ndarray:
    """One 16-byte BC7 block -> [16, 4] float32 RGBA in [0, 1]."""
    first = block[0]
    if first == 0:  # reserved: undefined block decodes to transparent black
        return np.zeros((16, 4), np.float32)
    mode = 0
    while not (first >> mode) & 1:
        mode += 1
    br = _BitReader(block)
    br.get(mode + 1)
    (ns, pb, rb, imb, cb, ab, pmode, ib, ib2) = _BC7_MODES[mode]

    partition = br.get(pb) if pb else 0
    rotation = br.get(rb) if rb else 0
    idx_mode = br.get(imb) if imb else 0

    n_ep = 2 * ns
    # endpoints channel-major: all R, all G, all B[, all A]
    eps = np.zeros((n_ep, 4), np.int64)
    for c in range(3):
        for e in range(n_ep):
            eps[e, c] = br.get(cb)
    if ab:
        for e in range(n_ep):
            eps[e, 3] = br.get(ab)
    # P-bits
    if pmode == 1:
        pbits = [br.get(1) for _ in range(n_ep)]
    elif pmode == 2:
        shared = [br.get(1) for _ in range(ns)]
        pbits = [shared[e // 2] for e in range(n_ep)]
    else:
        pbits = None

    # expand endpoints to 8 bits per channel
    for e in range(n_ep):
        for c in range(4):
            bits = cb if c < 3 else ab
            if c == 3 and not ab:
                eps[e, 3] = 255
                continue
            v = int(eps[e, c])
            if pbits is not None:
                v = (v << 1) | pbits[e]
                bits += 1
            eps[e, c] = _expand8(v, bits)

    # index planes (anchor texels drop their MSB)
    def read_indices(nbits: int) -> list:
        out = []
        for t in range(16):
            sub = _subset_of(ns, partition, t)
            n = nbits - (1 if t == _anchor_of(ns, partition, sub) else 0)
            out.append(br.get(n))
        return out

    idx0 = read_indices(ib)
    idx1 = read_indices(ib2) if ib2 else None

    out = np.zeros((16, 4), np.float32)
    w0 = _WEIGHTS[ib]
    w1 = _WEIGHTS[ib2] if ib2 else None
    for t in range(16):
        sub = _subset_of(ns, partition, t)
        e0 = eps[2 * sub]
        e1 = eps[2 * sub + 1]
        if ib2:
            # mode 4/5: separate color and alpha index planes;
            # idx_mode swaps which plane carries which (mode 4 only)
            ci, ai = (idx0[t], idx1[t])
            cw, aw = w0, w1
            if idx_mode:
                ci, ai = ai, ci
                cw, aw = aw, cw
            rgba = [_interp(int(e0[c]), int(e1[c]), cw[ci]) for c in range(3)]
            rgba.append(_interp(int(e0[3]), int(e1[3]), aw[ai]))
        else:
            w = w0[idx0[t]]
            rgba = [_interp(int(e0[c]), int(e1[c]), w) for c in range(4)]
        if rotation:  # swap A with R/G/B
            c = rotation - 1
            rgba[3], rgba[c] = rgba[c], rgba[3]
        out[t] = rgba
    return out / 255.0


# ---------------------------------------------------------------------------
# BC6H (unsigned half-float)
# ---------------------------------------------------------------------------

# Per-mode field scatter, D3D11 spec "BC6H bit layout" table. Each entry:
# (field, lo_bit, n) = next n stream bits go into field bits [lo : lo+n),
# or with n negative: |n| stream bits written in REVERSED order ending at
# lo (used by the 16.4 mode whose extension bits arrive 15..10).
# Fields: r0 g0 b0 (endpoint A of subset 0), r1 g1 b1 (B of subset 0),
# r2 g2 b2 / r3 g3 b3 (subset 1). (epb, delta, layout) per mode value.
_BC6_MODES = {
    0x00: (10, (5, 5, 5), [
        ("g2", 4, 1), ("b2", 4, 1), ("b3", 4, 1),
        ("r0", 0, 10), ("g0", 0, 10), ("b0", 0, 10),
        ("r1", 0, 5), ("g3", 4, 1), ("g2", 0, 4),
        ("g1", 0, 5), ("b3", 0, 1), ("g3", 0, 4),
        ("b1", 0, 5), ("b3", 1, 1), ("b2", 0, 4),
        ("r2", 0, 5), ("b3", 2, 1), ("r3", 0, 5), ("b3", 3, 1)]),
    0x01: (7, (6, 6, 6), [
        ("g2", 5, 1), ("g3", 4, 1), ("g3", 5, 1),
        ("r0", 0, 7), ("b3", 0, 1), ("b3", 1, 1), ("b2", 4, 1),
        ("g0", 0, 7), ("b2", 5, 1), ("b3", 2, 1), ("g2", 4, 1),
        ("b0", 0, 7), ("b3", 3, 1), ("b3", 5, 1), ("b3", 4, 1),
        ("r1", 0, 6), ("g2", 0, 4), ("g1", 0, 6), ("g3", 0, 4),
        ("b1", 0, 6), ("b2", 0, 4), ("r2", 0, 6), ("r3", 0, 6)]),
    0x02: (11, (5, 4, 4), [
        ("r0", 0, 10), ("g0", 0, 10), ("b0", 0, 10),
        ("r1", 0, 5), ("r0", 10, 1), ("g2", 0, 4),
        ("g1", 0, 4), ("g0", 10, 1), ("b3", 0, 1), ("g3", 0, 4),
        ("b1", 0, 4), ("b0", 10, 1), ("b3", 1, 1), ("b2", 0, 4),
        ("r2", 0, 5), ("b3", 2, 1), ("r3", 0, 5), ("b3", 3, 1)]),
    0x06: (11, (4, 5, 4), [
        ("r0", 0, 10), ("g0", 0, 10), ("b0", 0, 10),
        ("r1", 0, 4), ("r0", 10, 1), ("g3", 4, 1), ("g2", 0, 4),
        ("g1", 0, 5), ("g0", 10, 1), ("g3", 0, 4),
        ("b1", 0, 4), ("b0", 10, 1), ("b3", 1, 1), ("b2", 0, 4),
        ("r2", 0, 4), ("b3", 0, 1), ("b3", 2, 1),
        ("r3", 0, 4), ("g2", 4, 1), ("b3", 3, 1)]),
    0x0A: (11, (4, 4, 5), [
        ("r0", 0, 10), ("g0", 0, 10), ("b0", 0, 10),
        ("r1", 0, 4), ("r0", 10, 1), ("b2", 4, 1), ("g2", 0, 4),
        ("g1", 0, 4), ("g0", 10, 1), ("b3", 0, 1), ("g3", 0, 4),
        ("b1", 0, 5), ("b0", 10, 1), ("b2", 0, 4),
        ("r2", 0, 4), ("b3", 1, 1), ("b3", 2, 1),
        ("r3", 0, 4), ("b3", 4, 1), ("b3", 3, 1)]),
    0x0E: (9, (5, 5, 5), [
        ("r0", 0, 9), ("b2", 4, 1), ("g0", 0, 9), ("g2", 4, 1),
        ("b0", 0, 9), ("b3", 4, 1),
        ("r1", 0, 5), ("g3", 4, 1), ("g2", 0, 4),
        ("g1", 0, 5), ("b3", 0, 1), ("g3", 0, 4),
        ("b1", 0, 5), ("b3", 1, 1), ("b2", 0, 4),
        ("r2", 0, 5), ("b3", 2, 1), ("r3", 0, 5), ("b3", 3, 1)]),
    0x12: (8, (6, 5, 5), [
        ("r0", 0, 8), ("g3", 4, 1), ("b2", 4, 1),
        ("g0", 0, 8), ("b3", 2, 1), ("g2", 4, 1),
        ("b0", 0, 8), ("b3", 3, 1), ("b3", 4, 1),
        ("r1", 0, 6), ("g2", 0, 4), ("g1", 0, 5), ("b3", 0, 1),
        ("g3", 0, 4), ("b1", 0, 5), ("b3", 1, 1), ("b2", 0, 4),
        ("r2", 0, 6), ("r3", 0, 6)]),
    0x16: (8, (5, 6, 5), [
        ("r0", 0, 8), ("b3", 0, 1), ("b2", 4, 1),
        ("g0", 0, 8), ("g2", 5, 1), ("g2", 4, 1),
        ("b0", 0, 8), ("g3", 5, 1), ("b3", 4, 1),
        ("r1", 0, 5), ("g3", 4, 1), ("g2", 0, 4),
        ("g1", 0, 6), ("g3", 0, 4),
        ("b1", 0, 5), ("b3", 1, 1), ("b2", 0, 4),
        ("r2", 0, 5), ("b3", 2, 1), ("r3", 0, 5), ("b3", 3, 1)]),
    0x1A: (8, (5, 5, 6), [
        ("r0", 0, 8), ("b3", 1, 1), ("b2", 4, 1),
        ("g0", 0, 8), ("b2", 5, 1), ("g2", 4, 1),
        ("b0", 0, 8), ("b3", 5, 1), ("b3", 4, 1),
        ("r1", 0, 5), ("g3", 4, 1), ("g2", 0, 4),
        ("g1", 0, 5), ("b3", 0, 1), ("g3", 0, 4),
        ("b1", 0, 6), ("b2", 0, 4),
        ("r2", 0, 5), ("b3", 2, 1), ("r3", 0, 5), ("b3", 3, 1)]),
    0x1E: (6, (6, 6, 6), [
        ("r0", 0, 6), ("g3", 4, 1), ("b3", 0, 1), ("b3", 1, 1),
        ("b2", 4, 1),
        ("g0", 0, 6), ("g2", 5, 1), ("b2", 5, 1), ("b3", 2, 1),
        ("g2", 4, 1),
        ("b0", 0, 6), ("g3", 5, 1), ("b3", 3, 1), ("b3", 5, 1),
        ("b3", 4, 1),
        ("r1", 0, 6), ("g2", 0, 4), ("g1", 0, 6), ("g3", 0, 4),
        ("b1", 0, 6), ("b2", 0, 4), ("r2", 0, 6), ("r3", 0, 6)]),
    # one-subset modes
    0x03: (10, (10, 10, 10), [
        ("r0", 0, 10), ("g0", 0, 10), ("b0", 0, 10),
        ("r1", 0, 10), ("g1", 0, 10), ("b1", 0, 10)]),
    0x07: (11, (9, 9, 9), [
        ("r0", 0, 10), ("g0", 0, 10), ("b0", 0, 10),
        ("r1", 0, 9), ("r0", 10, 1), ("g1", 0, 9), ("g0", 10, 1),
        ("b1", 0, 9), ("b0", 10, 1)]),
    0x0B: (12, (8, 8, 8), [
        ("r0", 0, 10), ("g0", 0, 10), ("b0", 0, 10),
        ("r1", 0, 8), ("r0", 10, -2), ("g1", 0, 8), ("g0", 10, -2),
        ("b1", 0, 8), ("b0", 10, -2)]),
    0x0F: (16, (4, 4, 4), [
        ("r0", 0, 10), ("g0", 0, 10), ("b0", 0, 10),
        ("r1", 0, 4), ("r0", 10, -6), ("g1", 0, 4), ("g0", 10, -6),
        ("b1", 0, 4), ("b0", 10, -6)]),
}
# delta (transformed-endpoint) modes: all except the two untransformed ones
_BC6_NO_DELTA = {0x1E, 0x03}
_BC6_ONE_SUBSET = {0x03, 0x07, 0x0B, 0x0F}


def _bc6_unquantize(x: int, prec: int) -> int:
    # unsigned unquantization (D3D spec): map [0, 2^prec) -> [0, 0x10000)
    if prec >= 15:
        return x
    if x == 0:
        return 0
    if x == (1 << prec) - 1:
        return 0xFFFF
    return ((x << 16) + 0x8000) >> prec


def _half_to_float(h: np.ndarray) -> np.ndarray:
    return np.frombuffer(
        np.asarray(h, np.uint16).tobytes(), np.float16).astype(np.float32)


def decode_bc6h_block(block: bytes, signed: bool = False) -> np.ndarray:
    """One 16-byte BC6H block -> [16, 3] float32 (HDR; unsigned variant)."""
    if signed:
        raise ValueError("BC6H_SF16 (signed) decode not implemented")
    br = _BitReader(block)
    mode = br.get(2)
    if mode >= 2:
        mode = (mode | (br.get(3) << 2))
    if mode not in _BC6_MODES:
        return np.zeros((16, 3), np.float32)  # reserved mode: black
    epb, dbits, layout = _BC6_MODES[mode]
    one = mode in _BC6_ONE_SUBSET
    fields = {k: 0 for k in
              ("r0", "g0", "b0", "r1", "g1", "b1",
               "r2", "g2", "b2", "r3", "g3", "b3")}
    for name, lo, n in layout:
        if n < 0:  # reversed extension bits: (lo+|n|-1) down to lo
            for i in range(-n):
                fields[name] |= br.get(1) << (lo + (-n) - 1 - i)
        else:
            fields[name] |= br.get(n) << lo
    partition = 0 if one else br.get(5)

    n_sub = 1 if one else 2
    mask = (1 << epb) - 1
    eps = []  # [(e0 rgb), (e1 rgb)] per subset, quantized
    base = [fields["r0"], fields["g0"], fields["b0"]]
    names = [("r1", "g1", "b1"), ("r2", "g2", "b2"), ("r3", "g3", "b3")]
    deltas_all = [[fields[n] for n in names[i]] for i in range(3)]
    delta_mode = mode not in _BC6_NO_DELTA
    sub_eps = [[base]]
    # endpoint list order: e1 (subset0 B), e2 (subset1 A), e3 (subset1 B)
    for i, raw in enumerate(deltas_all[: 2 * n_sub - 1]):
        if delta_mode:
            db = [dbits[c] for c in range(3)]
            val = []
            for c in range(3):
                d = raw[c]
                if d & (1 << (db[c] - 1)):  # sign-extend the delta
                    d -= 1 << db[c]
                val.append((base[c] + d) & mask)
        else:
            val = [raw[c] & mask for c in range(3)]
        if i == 0:
            sub_eps[0].append(val)
        elif i == 1:
            sub_eps.append([val])
        else:
            sub_eps[1].append(val)

    uq = [[[_bc6_unquantize(v, epb) for v in ep] for ep in pair]
          for pair in sub_eps]

    ib = 4 if one else 3
    weights = _WEIGHTS[ib]
    idx = []
    for t in range(16):
        sub = 0 if one else ((_P2[partition] >> t) & 1)
        anchor = 0 if sub == 0 else _ANCHOR2[partition]
        n = ib - (1 if t == anchor else 0)
        idx.append((br.get(n), sub))
    out16 = np.zeros((16, 3), np.uint16)
    for t in range(16):
        i, sub = idx[t]
        w = weights[i]
        e0, e1 = uq[sub]
        for c in range(3):
            v = ((64 - w) * e0[c] + w * e1[c] + 32) >> 6
            out16[t, c] = (v * 31) >> 6  # final unsigned scale -> half bits
    return _half_to_float(out16.reshape(-1)).reshape(16, 3)


def decode_bc7(data: bytes, off: int, width: int, height: int) -> np.ndarray:
    """BC7 payload -> [H, W, 4] float32."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    out = np.zeros((bh * 4, bw * 4, 4), np.float32)
    for by in range(bh):
        for bx in range(bw):
            block = data[off + (by * bw + bx) * 16:][:16]
            texels = decode_bc7_block(block).reshape(4, 4, 4)
            out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = texels
    return out[:height, :width]


def decode_bc6h(data: bytes, off: int, width: int, height: int,
                signed: bool = False) -> np.ndarray:
    """BC6H payload -> [H, W, 3] float32 HDR."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    out = np.zeros((bh * 4, bw * 4, 3), np.float32)
    for by in range(bh):
        for bx in range(bw):
            block = data[off + (by * bw + bx) * 16:][:16]
            texels = decode_bc6h_block(block, signed).reshape(4, 4, 3)
            out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = texels
    return out[:height, :width]
