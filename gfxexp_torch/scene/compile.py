"""Scene compilation: SceneBuilder -> (SceneData in traversal order, BVH)
(port of gfxexp_tpu/scene/compile.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gfxexp_torch.accel.bvh_build import build_bvh
from gfxexp_torch.accel.qrow import build_qrow
from gfxexp_torch.accel.skiplink import build_skip_links, pack_tables
from gfxexp_torch.accel.widerow import build_widerow
from gfxexp_torch.scene.builder import SceneBuilder
from gfxexp_torch.scene.types import SceneData


def apply_triangle_permutation(scene: SceneData, perm) -> SceneData:
    """Reorder the triangles by `perm` (new[i] = old[perm[i]]) and remap the
    light-order indirection to the new ids. An SBVH perm repeats the
    triangles it split: an emitter then maps to its last copy (numpy's
    scatter order, as the JAX package computes it), and every copy keeps
    the emitter's pmf, as in JAX."""
    p = torch.as_tensor(np.asarray(perm), dtype=torch.int64)
    # the last position of each old id: index_put_ leaves repeated indices
    # to any order
    inv = torch.full_like(p, -1).scatter_reduce(
        0, p, torch.arange(p.shape[0]), "amax")
    tris = scene.triangles
    new_tris = dataclasses.replace(tris, **{
        f.name: getattr(tris, f.name)[p] for f in dataclasses.fields(tris)})
    units = dataclasses.replace(
        scene.units,
        light_tri_index=inv[scene.units.light_tri_index.long()].to(
            torch.int32),
        light_tri_pmf=scene.units.light_tri_pmf[p])
    ot = scene.object_triangles
    if ot is not None:
        ot = dataclasses.replace(ot, **{
            f.name: getattr(ot, f.name)[p] for f in dataclasses.fields(ot)})
    return dataclasses.replace(scene, triangles=new_tris, units=units,
                               object_triangles=ot)


def compile_scene(builder: SceneBuilder, arity: int = 4, max_leaf: int = 4,
                  traversal: str = "skip",
                  use_probability_texture: bool = False,
                  spatial_splits: bool = False, rebraid: float = 0.0):
    """Compile a scene on the CPU to (SceneData, structure), as the JAX
    package does:
    - traversal="skip" (the default): a SkipBVH, the refittable structure
      of animated scenes, its walk tables packed;
    - "widerow": a WideRowBVH, one table or, over 13,000 rows, Morton-
      ordered chunk tables;
    - "qrow": a QRowBVH of quantized arity-8 rows (chunked over 26,000
      rows); the scene's triangles become the dequantized ones, in
      traversal order, so shading sees the geometry that is traced;
    - "instanced": an InstancedAccel, per-group BLAS tables shared by the
      instances (`rebraid` > 1 opens the largest instances into subtree
      entries);
    - "wide": the stack-based wide BVH (a `BVH`, walked in plain torch).
    `spatial_splits` builds the wide-row and quantized tables with SBVH
    spatial splits (the permuted triangles then repeat the split ones); the
    other traversals ignore it, as in the JAX package."""
    if traversal == "instanced":
        return builder.compile_instanced(arity=arity, max_leaf=max_leaf,
                                         rebraid=rebraid)
    if traversal not in ("widerow", "qrow", "skip", "wide"):
        raise ValueError(
            f"unknown traversal {traversal!r}: use 'skip', 'widerow', "
            f"'qrow', 'instanced' or 'wide'")
    scene = builder.compile(use_probability_texture=use_probability_texture)
    tris = scene.triangles
    if traversal in ("skip", "wide"):
        bvh, perm = build_bvh(tris.p0.numpy(), tris.e1.numpy(),
                              tris.e2.numpy(), arity=arity,
                              max_leaf=max_leaf)
        scene = apply_triangle_permutation(scene, perm)
        if traversal == "wide":
            return scene, bvh
        skip = build_skip_links(bvh.child_min, bvh.child_max, bvh.child_idx,
                                bvh.child_count, max_leaf=max_leaf)
        return scene, pack_tables(skip, scene.triangles)
    if traversal == "qrow":
        qb, perm, (dq0, dqe1, dqe2) = build_qrow(
            tris.p0.numpy(), tris.e1.numpy(), tris.e2.numpy(),
            spatial_splits=spatial_splits)
        scene = apply_triangle_permutation(scene, perm)
        return dataclasses.replace(scene, triangles=dataclasses.replace(
            scene.triangles, p0=torch.from_numpy(dq0),
            e1=torch.from_numpy(dqe1), e2=torch.from_numpy(dqe2))), qb
    wrow, perm = build_widerow(tris.p0.numpy(), tris.e1.numpy(),
                               tris.e2.numpy(), arity=arity,
                               max_leaf=max_leaf,
                               spatial_splits=spatial_splits)
    return apply_triangle_permutation(scene, perm), wrow
