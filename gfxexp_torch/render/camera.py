"""Perspective camera and the lane <-> pixel orders (port of
gfxexp_tpu/render/camera.py).

Camera space has +z forward; pixel (px, py) with jitter (jx, jy) maps to the
direction orientation @ (vw * (0.5 - x), vh * (0.5 - y), 1), normalised, with
x = (px+jx)/W, y = (py+jy)/H, vh = 2 tan(fov_y/2), vw = aspect * vh.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gfxexp_torch.core.math import normalize
from gfxexp_torch.core.tensors import TensorData


@dataclass
class Camera(TensorData):
    position: torch.Tensor  # [3]
    orientation: torch.Tensor  # [3, 3] camera-to-world (left, up, fwd)
    fov_y: torch.Tensor  # [] radians
    aspect: torch.Tensor  # [] width / height


def make_camera(position, fov_y, aspect, orientation=None, target=None,
                up=(0.0, 1.0, 0.0)) -> Camera:
    """Camera on the CPU; move it with `.to(device)`."""
    position = torch.as_tensor(np.asarray(position, np.float32))
    if orientation is None:
        fwd = normalize(torch.as_tensor(np.asarray(target, np.float32))
                        - position)
        right = normalize(torch.linalg.cross(
            fwd, torch.as_tensor(np.asarray(up, np.float32))))
        true_up = torch.linalg.cross(right, fwd)
        orientation = torch.stack([-right, true_up, fwd], dim=-1)
    return Camera(
        position=position,
        orientation=torch.as_tensor(np.asarray(orientation, np.float32)),
        fov_y=torch.tensor(float(fov_y), dtype=torch.float32),
        aspect=torch.tensor(float(aspect), dtype=torch.float32),
    )


BLOCK_W = 16
BLOCK_H = 16


def blocked_order(width: int, height: int) -> bool:
    return width % BLOCK_W == 0 and height % BLOCK_H == 0


def _morton_blocks(width: int, height: int) -> bool:
    """Z-curve block order applies on square power-of-two block grids."""
    bx = width // BLOCK_W
    by = height // BLOCK_H
    return bx == by and bx > 1 and (bx & (bx - 1)) == 0


def _part1by1(x):
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _compact1by1(x):
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def pixel_from_lane(lane, width: int, height: int):
    """Lane (render order) -> linear pixel index (int64). Lanes are
    block-major over 16x16 screen blocks, the blocks along a Morton curve on
    square power-of-two grids and row-major otherwise; raw row-major when
    the size is not block-divisible."""
    lane = lane.to(torch.int64)
    if not blocked_order(width, height):
        return lane
    per_block = BLOCK_W * BLOCK_H
    blocks_x = width // BLOCK_W
    block = lane // per_block
    within = lane % per_block
    if _morton_blocks(width, height):
        bx = _compact1by1(block)
        by = _compact1by1(block >> 1)
    else:
        bx = block % blocks_x
        by = block // blocks_x
    px = bx * BLOCK_W + within % BLOCK_W
    py = by * BLOCK_H + within // BLOCK_W
    return py * width + px


def lane_from_pixel(pixel, width: int, height: int):
    """Inverse of pixel_from_lane."""
    pixel = pixel.to(torch.int64)
    if not blocked_order(width, height):
        return pixel
    px = pixel % width
    py = pixel // width
    blocks_x = width // BLOCK_W
    if _morton_blocks(width, height):
        block = _part1by1(px // BLOCK_W) | (_part1by1(py // BLOCK_H) << 1)
    else:
        block = (py // BLOCK_H) * blocks_x + px // BLOCK_W
    within = (py % BLOCK_H) * BLOCK_W + px % BLOCK_W
    return block * (BLOCK_W * BLOCK_H) + within


def generate_rays(camera: Camera, width: int, height: int, jx, jy):
    """Primary rays for every pixel in linear (row-major) order, on the
    camera's device. jx, jy: [H*W] jitter in [0, 1) (0.5 for the pixel
    centres). Returns (origins [N, 3], directions [N, 3])."""
    lane = torch.arange(width * height, device=camera.position.device)
    return generate_rays_for_lanes(camera, width, height, lane, jx, jy)


def generate_rays_for_lanes(camera: Camera, width: int, height: int, lane,
                            jx, jy):
    """Primary rays for linear pixel indices `lane`. The 3x3 rotation is
    written out per component (full float32, the same rounding on the CPU
    and the GPU; no TF32)."""
    n = lane.shape[0]
    px = (lane % width).to(torch.float32)
    py = (lane // width).to(torch.float32)
    x = (px + jx) / width
    y = (py + jy) / height
    vh = 2.0 * torch.tan(camera.fov_y * 0.5)
    vw = camera.aspect * vh
    cx = vw * (0.5 - x)
    cy = vh * (0.5 - y)
    m = camera.orientation
    d_world = torch.stack(
        [cx * m[i, 0] + cy * m[i, 1] + m[i, 2] for i in range(3)], dim=-1)
    o = torch.broadcast_to(camera.position, (n, 3))
    return o, normalize(d_world)


def screen_position(camera: Camera, p):
    """World points p [..., 3] -> screen uv [..., 2] in [0, 1]^2 (the
    motion vectors' projection). The inverse rotation (the transpose of
    the orthonormal orientation) is written out per component: full
    float32, no TF32."""
    rel = p - camera.position
    m = camera.orientation
    local = [rel[..., 0] * m[0, j] + rel[..., 1] * m[1, j]
             + rel[..., 2] * m[2, j] for j in range(3)]
    z = torch.clamp(local[2], min=1e-8)
    vh = 2.0 * torch.tan(camera.fov_y * 0.5)
    vw = camera.aspect * vh
    x = 0.5 - local[0] / (z * vw)
    y = 0.5 - local[1] / (z * vh)
    return torch.stack([x, y], dim=-1)
