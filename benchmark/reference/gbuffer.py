"""The reference G-buffer at a set of pixels: the primary hit (the jittered
camera ray of the frame's sample index), its position, shading and
geometric normals, the denoiser's albedo (the directional-hemispherical
reflectance estimate), emittance, depth, unit, material and the motion
vector (the hit taken back through its instance's current inverse and
forward through its previous transform, both projected with the static
camera, in pixels)."""

from __future__ import annotations

import torch

from reference import intersect
from reference.pathtrace import camera_rays, surface
from reference.shading import dh_reflectance, make_frame, screen_position, \
    to_local


def _apply(m, p):
    return torch.stack([m[..., i, 0] * p[..., 0] + m[..., i, 1] * p[..., 1]
                        + m[..., i, 2] * p[..., 2] + m[..., i, 3]
                        for i in range(3)], -1)


def gbuffer(scene, cam, width, height, pixel, sample, jitter=True):
    """dict of [R, ...] planes."""
    o, d = camera_rays(scene, cam, width, height, pixel, sample, jitter)
    t, tri, u, v, hit = intersect.closest(scene, o, d, 0.0, 1e30)
    pos, gn, sn, unit, mat, emit = surface(scene, tri, u, v)
    tt, bb = make_frame(sn)
    albedo = dh_reflectance(scene.material_params(mat),
                            to_local(tt, bb, sn, -d))
    inst = scene.unit_instance[unit]
    obj = _apply(scene.inv_transform[inst], pos)
    prev = _apply(scene.prev_transform[inst], obj)
    size = torch.tensor([width, height], dtype=pos.dtype, device=pos.device)
    motion = (screen_position(cam, width, height, pos)
              - screen_position(cam, width, height, prev)) * size
    h3 = hit[..., None]
    return dict(position=torch.where(h3, pos, 0.0),
                normal=torch.where(h3, sn, 0.0),
                geom_normal=torch.where(h3, gn, 0.0),
                albedo=torch.where(h3, albedo, 0.0),
                emittance=torch.where(h3, emit, 0.0),
                motion=torch.where(hit[..., None], motion, 0.0),
                depth=torch.where(hit, t, float("inf")),
                unit=torch.where(hit, unit, -1),
                material=torch.where(hit, mat, -1), hit=hit, view_dir=d)
