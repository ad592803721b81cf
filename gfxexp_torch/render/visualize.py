"""Debug views of the G-buffer planes and the beauty image, and the eight
generic debug flags (port of gfxexp_tpu/render/visualize.py)."""

from __future__ import annotations

import dataclasses

import torch

from gfxexp_torch.core.math import linear_to_srgb

BUFFER_BEAUTY = "beauty"
BUFFER_ALBEDO = "albedo"
BUFFER_NORMAL = "normal"
BUFFER_MOTION = "motion"
BUFFER_DEPTH = "depth"
BUFFER_TEXCOORD = "texcoord"
BUFFER_EMITTANCE = "emittance"
ALL_BUFFERS = (BUFFER_BEAUTY, BUFFER_ALBEDO, BUFFER_NORMAL, BUFFER_MOTION,
               BUFFER_DEPTH, BUFFER_TEXCOORD, BUFFER_EMITTANCE)


@dataclasses.dataclass(frozen=True)
class DebugSwitches:
    """Eight generic debug flags. The port's path tracer does not read them
    yet: a non-zero `debug_switches` raises there."""

    flags: int = 0

    def get(self, i: int) -> bool:
        return bool((self.flags >> i) & 1)

    def as_uint32(self) -> torch.Tensor:
        """The flags as a 0-d int32 tensor holding their uint32 bits."""
        v = self.flags & 0xFFFFFFFF
        return torch.tensor(v - (1 << 32) if v >= 1 << 31 else v,
                            dtype=torch.int32)


def visualize(mode: str, beauty=None, gbuffer=None, brightness: float = 1.0):
    """A display-ready [H, W, 3] image of the selected buffer."""
    if mode == BUFFER_BEAUTY:
        return linear_to_srgb(torch.clamp(beauty * brightness, 0.0, 1.0))
    gb = gbuffer
    if mode == BUFFER_ALBEDO:
        return linear_to_srgb(torch.clamp(gb.albedo, 0.0, 1.0))
    if mode == BUFFER_NORMAL:
        return 0.5 * (gb.normal + 1.0)
    if mode == BUFFER_MOTION:
        m = gb.motion
        return torch.stack([0.5 + 0.05 * m[..., 0], 0.5 + 0.05 * m[..., 1],
                            torch.zeros_like(m[..., 0])], dim=-1)
    if mode == BUFFER_DEPTH:
        d = torch.where(torch.isfinite(gb.depth), gb.depth, 0.0)
        d = d / torch.clamp(d.max(), min=1e-6)
        return torch.stack([d, d, d], dim=-1)
    if mode == BUFFER_TEXCOORD:
        tc = torch.remainder(gb.texcoord, 1.0)
        return torch.stack([tc[..., 0], tc[..., 1],
                            torch.zeros_like(tc[..., 0])], dim=-1)
    if mode == BUFFER_EMITTANCE:
        e = gb.emittance
        return e / (1.0 + e)
    raise ValueError(f"unknown buffer {mode!r} (choose from {ALL_BUFFERS})")
