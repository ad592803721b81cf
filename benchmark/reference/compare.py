"""The numbers that decide `correct`: how many of the compared pixels the
program got wrong, each pixel judged against the reference by a relative
error with a floor for dark pixels."""

from __future__ import annotations

import torch

RTOL = 1e-3  # a pixel is wrong when it is off by more than this share


def pixel_errors(cand, ref):
    """Per-pixel error [P] of colours [P, C]: the largest channel's
    difference over the pixel's own magnitude plus 1% of the mean
    magnitude of all compared pixels; inf where the candidate is not
    finite."""
    cand = cand.to(torch.float64).reshape(ref.shape[0], -1)
    ref = ref.to(torch.float64).reshape(ref.shape[0], -1)
    mag = ref.abs().amax(-1)
    floor = 0.01 * mag.mean() + 1e-30
    err = (cand - ref).abs().amax(-1) / (mag + floor)
    return torch.where(torch.isfinite(cand).all(-1), err, float("inf"))


def mismatch(cand, ref):
    """[P] bool: the pixels whose error exceeds RTOL."""
    return pixel_errors(cand, ref) > RTOL


def mismatch_share(cand, ref):
    """Share of the pixels whose error exceeds RTOL."""
    return share(mismatch(cand, ref))


def fields_mismatch(cand: dict, ref: dict):
    """[P] bool: the pixels where any of the fields of `ref` (each judged
    on its own scale) is off."""
    bad = None
    for key, r in ref.items():
        m = mismatch(cand[key].reshape(r.shape[0], -1),
                     r.reshape(r.shape[0], -1))
        bad = m if bad is None else bad | m
    return bad


def share(mask):
    return float(mask.to(torch.float64).mean())


def gbuffer_mismatch_share(prog, ref):
    """Share of pixels where the program's G-buffer disagrees with the
    reference's: a different hit, unit or material, or a position, normal,
    albedo, depth or motion vector off by more than RTOL (positions and
    motion relative to their size plus 1)."""
    f64 = torch.float64
    bad = (prog["hit"] != ref["hit"])
    hit = prog["hit"] & ref["hit"]
    bad |= hit & ((prog["unit"] != ref["unit"])
                  | (prog["material"] != ref["material"]))
    for key in ("position", "normal", "albedo", "motion"):
        a, b = prog[key].to(f64), ref[key].to(f64)
        e = (a - b).abs().amax(-1) / (b.abs().amax(-1) + 1.0)
        bad |= hit & ~(e <= RTOL)
    dz = (prog["depth"].to(f64) - ref["depth"].to(f64)).abs() \
        / ref["depth"].to(f64).abs().clamp(min=1e-6)
    bad |= hit & ~(dz <= RTOL)
    return float(bad.to(f64).mean())
