"""A frozen copy of the counter-based random numbers the port draws
(PCG4D / PCG3D, Jarzynski and Olano 2020, keyed by pixel, sample and
stream), so the reference follows the port's paths sample for sample.
Values are int32 tensors holding uint32 bits: add and multiply wrap alike,
and every right shift is masked to be logical. A draw is a float32 in
[0, 1) with 24 bits, handed out in the reference's dtype."""

from __future__ import annotations

import torch

_MUL = 1664525
_ADD = 1013904223


def _i32(x, like=None):
    if not isinstance(x, torch.Tensor):
        x = int(x) & 0xFFFFFFFF
        x = x - (1 << 32) if x >= (1 << 31) else x
        return torch.full((), x, dtype=torch.int32,
                          device=None if like is None else like.device)
    if x.dtype == torch.int32:
        return x
    return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.int32)


def _shr16(x):
    return (x >> 16) & 0xFFFF


def pcg4d(v0, v1, v2, v3):
    like = next(v for v in (v0, v1, v2, v3) if isinstance(v, torch.Tensor))
    x, y, z, w = (_i32(v, like) for v in (v0, v1, v2, v3))
    x = x * _MUL + _ADD
    y = y * _MUL + _ADD
    z = z * _MUL + _ADD
    w = w * _MUL + _ADD
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ _shr16(x)
    y = y ^ _shr16(y)
    z = z ^ _shr16(z)
    w = w ^ _shr16(w)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def pcg3d(v0, v1, v2):
    like = next(v for v in (v0, v1, v2) if isinstance(v, torch.Tensor))
    x, y, z = (_i32(v, like) for v in (v0, v1, v2))
    x = x * _MUL + _ADD
    y = y * _MUL + _ADD
    z = z * _MUL + _ADD
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ _shr16(x)
    y = y ^ _shr16(y)
    z = z ^ _shr16(z)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


class Stream:
    """Draws for keys `lane` [R] at (sample, stream): four a hash, in
    order, as the port's SampleStream hands them out."""

    def __init__(self, lane, sample, stream, dtype):
        self.lane = _i32(lane)
        self.sample = _i32(sample, self.lane)
        self.stream = _i32(stream, self.lane)
        self.dtype = dtype
        self.dim = 0
        self.buf = []

    def bits(self):
        if not self.buf:
            self.buf = list(pcg4d(self.lane, self.sample, self.stream,
                                  self.dim))
            self.dim += 1
        return self.buf.pop(0)

    def next(self):
        b = self.bits()
        return (((b >> 8) & 0xFFFFFF).to(torch.float32)
                * (1.0 / 16777216.0)).to(self.dtype)

    def next2(self):
        return self.next(), self.next()
