"""Scene compilation: SceneBuilder -> (SceneData in traversal order, BVH)
(port of gfxexp_tpu/scene/compile.py for the wide-row and the two-level
traversals)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gfxexp_torch.accel.widerow import build_widerow
from gfxexp_torch.scene.builder import SceneBuilder
from gfxexp_torch.scene.types import SceneData


def apply_triangle_permutation(scene: SceneData, perm) -> SceneData:
    """Reorder the triangles by `perm` (new[i] = old[perm[i]]) and remap the
    light-order indirection to the new ids."""
    p = torch.as_tensor(np.asarray(perm), dtype=torch.int64)
    inv = torch.empty_like(p)
    inv[p] = torch.arange(p.shape[0])
    tris = scene.triangles
    new_tris = dataclasses.replace(tris, **{
        f.name: getattr(tris, f.name)[p] for f in dataclasses.fields(tris)})
    units = dataclasses.replace(
        scene.units,
        light_tri_index=inv[scene.units.light_tri_index.long()].to(
            torch.int32),
        light_tri_pmf=scene.units.light_tri_pmf[p])
    return dataclasses.replace(scene, triangles=new_tris, units=units)


def compile_scene(builder: SceneBuilder, arity: int = 4, max_leaf: int = 4,
                  traversal: str = "widerow",
                  use_probability_texture: bool = False,
                  spatial_splits: bool = False, rebraid: float = 0.0):
    """Compile to (SceneData, WideRowBVH) on the CPU, or with
    traversal="instanced" to (SceneData, InstancedAccel): per-group BLAS
    tables shared by the instances (`rebraid` > 1 opens the largest
    instances into subtree entries). Other traversal structures raise."""
    if traversal == "instanced":
        return builder.compile_instanced(arity=arity, max_leaf=max_leaf,
                                         rebraid=rebraid)
    if traversal != "widerow":
        raise NotImplementedError(
            f"traversal={traversal!r} is not ported; use 'widerow' or "
            f"'instanced'")
    scene = builder.compile(use_probability_texture=use_probability_texture)
    tris = scene.triangles
    wrow, perm = build_widerow(tris.p0.numpy(), tris.e1.numpy(),
                               tris.e2.numpy(), arity=arity,
                               max_leaf=max_leaf,
                               spatial_splits=spatial_splits)
    return apply_triangle_permutation(scene, perm), wrow
