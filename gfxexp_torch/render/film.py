"""Film: progressive accumulation buffers and display mapping (port of
gfxexp_tpu/render/film.py)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from gfxexp_torch.core.math import linear_to_srgb
from gfxexp_torch.core.tensors import TensorData


@dataclass
class Film(TensorData):
    """Progressive accumulation state carried across frames."""

    beauty: torch.Tensor  # [H, W, 3] running mean radiance
    albedo: torch.Tensor  # [H, W, 3]
    normal: torch.Tensor  # [H, W, 3]
    num_accum: torch.Tensor  # [] int32


def make_film(width: int, height: int, device="cuda") -> Film:
    """An empty film on `device` (the card unless the caller asks for the
    CPU)."""
    z = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    return Film(beauty=z, albedo=z, normal=z,
                num_accum=torch.zeros((), dtype=torch.int32, device=device))


def add_sample(film: Film, beauty, albedo=None, normal=None) -> Film:
    """Running-mean update."""
    w = 1.0 / (1.0 + film.num_accum.to(torch.float32))

    def mix(old, new):
        return old if new is None else (1.0 - w) * old + w * new

    return Film(beauty=mix(film.beauty, beauty),
                albedo=mix(film.albedo, albedo),
                normal=mix(film.normal, normal),
                num_accum=film.num_accum + 1)


def reset(film: Film) -> Film:
    return dataclasses.replace(
        film, beauty=torch.zeros_like(film.beauty),
        albedo=torch.zeros_like(film.albedo),
        normal=torch.zeros_like(film.normal),
        num_accum=torch.zeros_like(film.num_accum))


def to_display(hdr, brightness: float = 1.0):
    """Linear HDR -> sRGB display values in [0, 1]."""
    return linear_to_srgb(torch.clamp(hdr * brightness, 0.0, 1.0))
