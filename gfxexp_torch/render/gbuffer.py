"""G-buffer pass: primary visibility, surface attributes and motion vectors
(port of gfxexp_tpu/render/gbuffer.py).

One batched primary trace in the path tracer's block-major lane order, then
[H, W] planes in row-major pixel order. Motion vectors take each hit point
back to object space (the instance's inverse transform), forward through the
instance's previous transform, and project it with the previous camera.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gfxexp_torch.accel.traverse import intersect_closest
from gfxexp_torch.core.math import make_frame, to_local, transform_point
from gfxexp_torch.core.rng import SampleStream
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.render.bsdf import (
    bsdf_dh_reflectance,
    material_params_textured,
)
from gfxexp_torch.render.camera import (
    Camera,
    generate_rays_for_lanes,
    lane_from_pixel,
    pixel_from_lane,
    screen_position,
)
from gfxexp_torch.render.pathtrace import compute_surface_point
from gfxexp_torch.scene.types import SceneData
from gfxexp_torch.utils import trace


@dataclass
class GBuffer(TensorData):
    """Per-pixel primary-hit attributes, [H, W, ...] planes."""

    position: torch.Tensor  # [H, W, 3] world position (0 on miss)
    normal: torch.Tensor  # [H, W, 3] shading normal
    geom_normal: torch.Tensor  # [H, W, 3]
    albedo: torch.Tensor  # [H, W, 3] DH-reflectance estimate
    emittance: torch.Tensor  # [H, W, 3]
    texcoord: torch.Tensor  # [H, W, 2]
    motion: torch.Tensor  # [H, W, 2] screen motion (cur - prev), pixels
    depth: torch.Tensor  # [H, W] hit distance (inf on miss)
    tri: torch.Tensor  # [H, W] int32 triangle id (-1 on miss)
    bary: torch.Tensor  # [H, W, 2] barycentrics (u, v)
    unit: torch.Tensor  # [H, W] int32 unit slot (-1 on miss)
    material: torch.Tensor  # [H, W] int32 material slot (-1 on miss)
    hit: torch.Tensor  # [H, W] bool
    view_dir: torch.Tensor  # [H, W, 3] unit direction from the camera


def render_gbuffer(scene: SceneData, bvh, camera: Camera,
                   prev_camera: Camera, width: int, height: int, sample_idx,
                   enable_jitter: bool = True) -> GBuffer:
    """The G-buffer of one frame on the device that holds `scene`. The
    jitter draws the path tracer's camera numbers (stream 0xFFFF), so a
    G-buffer and a path-traced sample of the same index see the same
    primary rays."""
    with trace.span("gfx.gbuffer"):
        dev = scene.triangles.p0.device
        n = width * height
        lane = torch.arange(n, dtype=torch.int64, device=dev)
        pixel = pixel_from_lane(lane, width, height)
        if enable_jitter:
            rs = SampleStream(pixel, int(sample_idx), stream=0xFFFF)
            jx, jy = rs.next2()
        else:
            jx = torch.full((n,), 0.5, device=dev)
            jy = torch.full((n,), 0.5, device=dev)
        ray_o, ray_d = generate_rays_for_lanes(camera, width, height, pixel,
                                               jx, jy)

        hit = intersect_closest(bvh, scene.triangles, ray_o, ray_d, t_min=0.0,
                                t_max=1e30)
        sp = compute_surface_point(scene, hit.tri, hit.u, hit.v, inst=hit.inst)
        hm = hit.hit
        hm1 = hm[..., None]

        # the denoiser's albedo: the DH-reflectance estimate
        t, b = make_frame(sp.shading_normal)
        v_out_local = to_local(t, b, sp.shading_normal, -ray_d)
        params = material_params_textured(scene.materials, scene.textures,
                                          sp.material, sp.texcoord)
        albedo = bsdf_dh_reflectance(params, v_out_local)

        # motion: world -> object (current inverse) -> previous world
        # (previous transform) -> previous screen position
        inst = scene.units.instance[sp.unit].to(torch.int64)
        obj_p = transform_point(scene.instances.inv_transform[inst],
                                sp.position)
        prev_p = transform_point(scene.instances.prev_transform[inst], obj_p)
        cur_uv = screen_position(camera, sp.position)
        prev_uv = screen_position(prev_camera, prev_p)
        size = torch.tensor([width, height], dtype=torch.float32, device=dev)
        motion = torch.where(hm1, (cur_uv - prev_uv) * size, 0.0)

        order = lane_from_pixel(torch.arange(n, dtype=torch.int64, device=dev),
                                width, height)

        def img(x):
            return x[order].reshape(height, width, *x.shape[1:])

        i32 = torch.int32
        return GBuffer(
            position=img(torch.where(hm1, sp.position, 0.0)),
            normal=img(torch.where(hm1, sp.shading_normal, 0.0)),
            geom_normal=img(torch.where(hm1, sp.geom_normal, 0.0)),
            albedo=img(torch.where(hm1, albedo, 0.0)),
            emittance=img(torch.where(hm1, sp.emittance, 0.0)),
            texcoord=img(torch.where(hm1, sp.texcoord, 0.0)),
            motion=img(motion),
            depth=img(torch.where(hm, hit.t, torch.inf)),
            tri=img(torch.where(hm, hit.tri, -1).to(i32)),
            bary=img(torch.stack([hit.u, hit.v], dim=-1)),
            unit=img(torch.where(hm, sp.unit, -1).to(i32)),
            material=img(torch.where(hm, sp.material, -1).to(i32)),
            hit=img(hm),
            view_dir=img(ray_d),
        )
