"""Counter-based per-lane RNG (PCG4D / PCG3D hashes, Jarzynski & Olano 2020).

Port of gfxexp_tpu/core/rng.py, bit-exact. torch has no uint32 add or
shift on the CPU, so values are carried as int32 tensors holding the uint32
bit pattern: add and multiply wrap identically, and every right shift is
masked to make it logical.
"""

from __future__ import annotations

import torch

_MUL = 1664525
_ADD = 1013904223


def _as_i32(x, like=None) -> torch.Tensor:
    """Integer tensor or Python int -> int32 tensor of the same uint32 bits."""
    if not isinstance(x, torch.Tensor):
        x = int(x) & 0xFFFFFFFF
        x = x - (1 << 32) if x >= (1 << 31) else x
        device = like.device if like is not None else None
        # a fill, not a host-to-device copy: no stream synchronisation
        return torch.full((), x, dtype=torch.int32, device=device)
    if x.dtype == torch.int32:
        return x
    return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.int32)


def _shr16(x):
    return (x >> 16) & 0xFFFF


def pcg4d(v0, v1, v2, v3):
    """PCG4D hash: four u32 (as int32 bits) in, four decorrelated out."""
    like = next((v for v in (v0, v1, v2, v3) if isinstance(v, torch.Tensor)),
                None)
    x, y, z, w = (_as_i32(v, like) for v in (v0, v1, v2, v3))
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
    like = next((v for v in (v0, v1, v2) if isinstance(v, torch.Tensor)),
                None)
    x, y, z = (_as_i32(v, like) for v in (v0, v1, v2))
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


def bits_to_unit_float(bits):
    """u32 bits -> float32 in [0, 1) with 24-bit precision."""
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * (1.0 / 16777216.0)


def uniform4(v0, v1, v2, v3):
    """Four independent U[0, 1) floats from a 4D counter."""
    return tuple(bits_to_unit_float(x) for x in pcg4d(v0, v1, v2, v3))


class SampleStream:
    """A (lane, sample, stream) counter plus a dimension index; each pcg4d
    evaluation yields four draws, buffered (gfxexp_tpu SampleStream)."""

    def __init__(self, lane, sample, stream=0):
        self._lane = _as_i32(lane)
        self._sample = _as_i32(sample, self._lane)
        self._stream = _as_i32(stream, self._lane)
        self._dim = 0
        self._buf = []

    def _next_raw(self):
        if not self._buf:
            self._buf = list(pcg4d(self._lane, self._sample, self._stream,
                                   self._dim))
            self._dim += 1
        return self._buf.pop(0)

    def next(self):
        return bits_to_unit_float(self._next_raw())

    def next2(self):
        return self.next(), self.next()

    def next3(self):
        return self.next(), self.next(), self.next()

    def next_bits(self):
        return self._next_raw()

    def skip(self, k: int):
        """Consume k draws without converting them (the stream stays in
        step with one that draws them)."""
        for _ in range(k):
            self._next_raw()
