"""The Cornell box from its published data (configs/cornellbox_1080p.json):
five walls, two blocks and the light, each surface a geometry of its
quads in the data page's order, normals facing into the box (blocks: out
of the block), scaled from millimetres to scene units; one Lambert
material a surface, the light emitting pi times its radiance (the port's
emittance is exitance); the camera at the data page's position and
direction with the film height's vertical field of view. Nothing in it is
random: the seed draws only the frames and pixels the check compares."""

from __future__ import annotations

import math

import numpy as np

from scenes.shapes import Recipe, quad

SURFACES = ("light", "floor", "ceiling", "back_wall", "right_wall",
            "left_wall", "short_block", "tall_block")


def build(cfg: dict, seed: int) -> Recipe:
    r = Recipe()
    scale = cfg["scale"]
    mats = {}
    for name, m in cfg["materials"].items():
        emit = [math.pi * x for x in m.get("radiance", (0.0, 0.0, 0.0))]
        mats[name] = r.material("lambert", m["reflectance"], emittance=emit)
    centre = np.concatenate([np.asarray(cfg[s]["quads"]).reshape(-1, 3)
                             for s in SURFACES]).mean(0)
    for s in SURFACES:
        quads = np.asarray(cfg[s]["quads"], np.float64)
        own = quads.reshape(-1, 3).mean(0)
        # a wall faces the box's centre; a block's face, away from its own
        meshes = [quad(q, centre if cfg[s]["facing"] == "box"
                       else 2 * q.mean(0) - own) for q in quads]
        pos = np.concatenate([m[0] for m in meshes]) * np.float32(scale)
        idx = np.concatenate([m[3] + 4 * i for i, m in enumerate(meshes)])
        r.instance(r.geometry((pos, np.concatenate([m[1] for m in meshes]),
                               np.concatenate([m[2] for m in meshes]), idx),
                              mats[cfg[s]["material"]]))
    cam = cfg["camera"]
    pos = np.asarray(cam["position"]) * scale
    r.camera = dict(position=pos.tolist(),
                    target=(pos + np.asarray(cam["direction"])).tolist(),
                    fov_y_deg=math.degrees(2 * math.atan(
                        cam["film_height"] / 2 / cam["focal_length"])))
    return r
