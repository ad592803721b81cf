"""The meshes the benchmark's scenes are made of, as numpy arrays of its
own: a quadrilateral given by its corners, an affine transform, and the
Recipe that holds a scene. The benchmark hands these arrays to the port
(SceneBuilder.add_geometry), so a later change to the port's builders does
not move the scenes, and the reference reads the same arrays."""

from __future__ import annotations

import numpy as np


def quad(corners, towards):
    """(positions [4, 3], normals [4, 3], texcoords [4, 2], indices [2, 3])
    of the quadrilateral with `corners` in order, as two triangles (0, 1, 2)
    and (0, 2, 3) wound so that cross(e1, e2) and the normal (the
    diagonals' cross product) face the side of the point `towards`."""
    p = np.asarray(corners, np.float64)
    n = np.cross(p[2] - p[0], p[3] - p[1])
    n /= np.linalg.norm(n)
    if np.dot(n, np.asarray(towards, np.float64) - p.mean(0)) < 0:
        p = p[::-1].copy()
        n = -n
    normals = np.tile(n[None].astype(np.float32), (4, 1))
    texcoords = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return p.astype(np.float32), normals, texcoords, indices


def affine(rotation=None, translation=None) -> np.ndarray:
    """[3, 4] float32 object-to-world transform."""
    r = np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
    t = (np.zeros(3) if translation is None
         else np.asarray(translation, np.float64))
    return np.concatenate([r, t[:, None]], axis=1).astype(np.float32)


class Recipe:
    """A scene as plain arrays: materials (dicts of bsdf "lambert" or
    "diffuse_specular", diffuse, f0, roughness, emittance), geometries
    (positions, normals, texcoords, indices, material), instances (a list
    of geometry ids and a [3, 4] transform), controllers (dicts of the
    keyframe fields, t = frame / 60) and the camera (position, target,
    vertical fov in degrees)."""

    def __init__(self):
        self.materials = []
        self.geometries = []
        self.instances = []
        self.controllers = []
        self.camera = None

    def material(self, bsdf, diffuse, f0=(0.04, 0.04, 0.04), roughness=0.3,
                 emittance=(0.0, 0.0, 0.0)) -> int:
        self.materials.append(dict(
            bsdf=bsdf, diffuse=tuple(float(x) for x in diffuse),
            f0=tuple(float(x) for x in f0), roughness=float(roughness),
            emittance=tuple(float(x) for x in emittance)))
        return len(self.materials) - 1

    def geometry(self, mesh, material: int) -> int:
        pos, nrm, uv, idx = mesh
        self.geometries.append(dict(positions=pos, normals=nrm,
                                    texcoords=uv, indices=idx,
                                    material=material))
        return len(self.geometries) - 1

    def instance(self, geometry: int, transform=None) -> int:
        self.instances.append(dict(
            geometries=[geometry],
            transform=affine() if transform is None else transform))
        return len(self.instances) - 1
