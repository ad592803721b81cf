"""Animation: keyframed instance controllers and the per-frame device update
(port of gfxexp_tpu/scene/animation.py).

A frame of a flattened (skip-link) scene: new instance transforms from the
controllers (host, small), world geometry from the object-space triangles
(one batched transform on the device), a bottom-up refit of the skip-link
BVH over its fixed topology (one sweep per level) with its walk tables
repacked, and a rebuild of the light distributions with segment sums. A
two-level scene only refreshes its entries' inverse transforms and world
boxes and rescales the unit-level light distribution (rigid motion).

None of this was a Pallas kernel in the JAX package: it is plain torch on
the scene's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from gfxexp_torch.accel.skiplink import SkipBVH, pack_tables
from gfxexp_torch.core.math import (
    cross,
    det3,
    invert_transform,
    length,
    luminance,
    np_quaternion_to_matrix,
    np_slerp,
    normalize,
    transform_normal,
    transform_point,
    transform_vector,
)
from gfxexp_torch.scene.types import SceneData

# ---------------------------------------------------------------------------
# host-side keyframe controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class InstanceController:
    instance: int
    begin_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    end_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    begin_orientation: Tuple[float, float, float, float] = (0, 0, 0, 1)  # xyzw
    end_orientation: Tuple[float, float, float, float] = (0, 0, 0, 1)
    begin_scale: float = 1.0
    end_scale: float = 1.0
    frequency: float = 1.0  # cycles per second
    initial_time: float = 0.0

    def transform_at(self, t: float) -> np.ndarray:
        """[3, 4] affine at time t (a triangle wave over the cycle)."""
        return _transforms_at([self], t)[0]


def _transforms_at(controllers, t: float) -> np.ndarray:
    """[C, 3, 4] float32 transforms of the controllers at time t, batched
    (the reference's per-controller arithmetic: the blend factor, position
    and scale in float64, the slerp and rotation matrix in float32)."""
    c = controllers
    cycle = np.asarray([(k.initial_time + t) * k.frequency % 1.0 for k in c],
                       np.float64)
    s = 1.0 - np.abs(2.0 * cycle - 1.0)  # 0 -> 1 -> 0 over one cycle
    q = np_slerp(np.asarray([k.begin_orientation for k in c], np.float32),
                 np.asarray([k.end_orientation for k in c], np.float32),
                 s.astype(np.float32))
    rot = np_quaternion_to_matrix(q)
    scale = ((1.0 - s) * np.asarray([k.begin_scale for k in c], np.float64)
             + s * np.asarray([k.end_scale for k in c], np.float64))
    pos = ((1.0 - s)[:, None] * np.asarray([k.begin_position for k in c],
                                           np.float64)
           + s[:, None] * np.asarray([k.end_position for k in c], np.float64))
    m = np.zeros((len(c), 3, 4), np.float32)
    m[:, :, :3] = rot * scale.astype(np.float32)[:, None, None]
    m[:, :, 3] = pos
    return m


def controller_transforms(scene: SceneData, controllers,
                          t: float) -> torch.Tensor:
    """The [I, 3, 4] transform stack at time t, on the scene's device: the
    controlled instances' transforms replaced."""
    m = scene.instances.transform.clone()
    if controllers:
        idx = torch.as_tensor([c.instance for c in controllers],
                              dtype=torch.int64)
        m[idx.to(m.device)] = torch.from_numpy(
            _transforms_at(controllers, t)).to(m.device)
    return m


# ---------------------------------------------------------------------------
# device-side per-frame update
# ---------------------------------------------------------------------------


def set_instance_transforms(scene: SceneData, new_transforms) -> SceneData:
    """New instance transforms; the previous ones become prev_transform
    (motion vectors)."""
    det = det3(new_transforms[:, :, :3])
    scale = torch.clamp(torch.abs(det), min=1e-30) ** (1.0 / 3.0)
    return dataclasses.replace(scene, instances=dataclasses.replace(
        scene.instances, prev_transform=scene.instances.transform,
        transform=new_transforms,
        inv_transform=invert_transform(new_transforms),
        uniform_scale=scale))


def update_world_geometry(scene: SceneData) -> SceneData:
    """World-space triangles from the object-space copy and the instance
    transforms."""
    ot = scene.object_triangles
    if ot is None:
        raise ValueError("the scene keeps no object-space triangles "
                         "(compile it flattened, not instanced)")
    inst = ot.instance.to(torch.int64)
    m = scene.instances.transform[inst]  # [T, 3, 4]
    mi = scene.instances.inv_transform[inst]
    tris = dataclasses.replace(
        scene.triangles,
        p0=transform_point(m, ot.p0), e1=transform_vector(m, ot.e1),
        e2=transform_vector(m, ot.e2),
        n0=normalize(transform_normal(mi, ot.n0)),
        n1=normalize(transform_normal(mi, ot.n1)),
        n2=normalize(transform_normal(mi, ot.n2)))
    return dataclasses.replace(scene, triangles=tris)


def refit_skip_bvh(bvh: SkipBVH, tris) -> SkipBVH:
    """Bottom-up box refit over the fixed skip-link topology, and the walk
    tables repacked for `tris`.

    Leaves take their triangles' bounds, padded by 1e-7 max(1, |hi|);
    internal nodes at depth d union their children (all at depth d+1) along
    the sibling chain, `arity` steps with clamped indices, one sweep per
    level from the deepest up. Each sweep touches only that level's internal
    nodes (the reference masks the whole node array: same result); the
    per-level node lists come with the structure, so a frame does not wait
    for the host."""
    m = bvh.num_nodes
    dev = bvh.first.device
    skip = bvh.skip.to(torch.int64)
    t_count = tris.p0.shape[0]

    leaves = bvh.leaf_ids
    first = bvh.first.to(torch.int64)[leaves]
    count = bvh.count[leaves]
    lo = torch.full((leaves.numel(), 3), torch.inf, device=dev)
    hi = torch.full((leaves.numel(), 3), -torch.inf, device=dev)
    for j in range(bvh.max_leaf):
        idx = torch.clamp(first + j, 0, t_count - 1)
        valid = (j < count)[:, None]
        p0 = tris.p0[idx]
        p1 = p0 + tris.e1[idx]
        p2 = p0 + tris.e2[idx]
        tlo = torch.minimum(torch.minimum(p0, p1), p2)
        thi = torch.maximum(torch.maximum(p0, p1), p2)
        lo = torch.where(valid, torch.minimum(lo, tlo), lo)
        hi = torch.where(valid, torch.maximum(hi, thi), hi)
    pad = 1e-7 * torch.clamp(torch.abs(hi), min=1.0)
    amin = bvh.aabb_min.clone()
    amax = bvh.aabb_max.clone()
    amin[leaves] = lo - pad
    amax[leaves] = hi + pad

    groups = torch.split(bvh.level_ids, list(bvh.level_sizes))
    for sel in reversed(groups):  # deepest level first
        if not sel.numel():
            continue
        node_lo = torch.full((sel.numel(), 3), torch.inf, device=dev)
        node_hi = torch.full((sel.numel(), 3), -torch.inf, device=dev)
        end = skip[sel]
        c = sel + 1
        for _ in range(bvh.arity):
            cc = torch.clamp(c, 0, m - 1)
            valid = (c < end)[:, None]
            node_lo = torch.where(valid, torch.minimum(node_lo, amin[cc]),
                                  node_lo)
            node_hi = torch.where(valid, torch.maximum(node_hi, amax[cc]),
                                  node_hi)
            c = skip[cc]
        amin[sel] = node_lo
        amax[sel] = node_hi

    node_pack = bvh.node_pack.clone()  # the topology columns stay
    node_pack[:m, 0:3] = amin
    node_pack[:m, 3:6] = amax
    return pack_tables(dataclasses.replace(
        bvh, aabb_min=amin, aabb_max=amax, node_pack=node_pack), tris)


def rebuild_light_distributions(scene: SceneData) -> SceneData:
    """The light pmfs and cdfs rebuilt from the current world triangles
    (per-triangle importance = world area x emittance luminance; segment
    sums per unit with index_add_, exclusive prefixes by one cumsum). The
    alias tables are built on the host, so they are dropped: light
    selection then takes the CDF search."""
    tris = scene.triangles
    units = scene.units
    n_units = units.material.shape[0]
    unit_id = tris.unit_id.to(torch.int64)
    light_idx = units.light_tri_index.to(torch.int64)

    area = 0.5 * length(cross(tris.e1, tris.e2))
    emit = scene.materials.emittance[units.material.to(torch.int64)[unit_id]]
    imp = area * luminance(emit)

    imp_lo = imp[light_idx]
    seg = unit_id[light_idx]  # unit of each light-order position
    seg_sum = torch.zeros(n_units, device=imp.device).index_add_(
        0, seg, imp_lo)
    denom = torch.where(seg_sum > 0, seg_sum, 1.0)
    pmf_lo = imp_lo / denom[seg]
    g = torch.cumsum(pmf_lo, 0) - pmf_lo  # exclusive prefix
    seg_start = g[torch.clamp(units.tri_offset.to(torch.int64), 0,
                              g.shape[0] - 1)]
    cdf_lo = g - seg_start[seg]
    pmf_traversal = torch.zeros_like(imp).index_copy_(0, light_idx, pmf_lo)

    total = seg_sum.sum()
    unit_pmf = torch.where(total > 0,
                           seg_sum / torch.where(total > 0, total, 1.0), 0.0)
    unit_cdf = torch.cat([torch.zeros(1, device=imp.device),
                          torch.cumsum(unit_pmf, 0)])
    unit_cdf = unit_cdf / torch.clamp(unit_cdf[-1:], min=1e-20)
    return dataclasses.replace(
        scene,
        units=dataclasses.replace(
            units, light_tri_cdf=cdf_lo, light_tri_pmf=pmf_traversal,
            emissive_importance=seg_sum, light_tri_alias_prob=None,
            light_tri_alias_local=None),
        light_unit_cdf=unit_cdf, light_unit_pmf=unit_pmf,
        light_unit_alias_prob=None, light_unit_alias_idx=None,
        total_emissive_importance=total)


def advance_frame(scene: SceneData, bvh: SkipBVH, controllers, t: float):
    """One frame of animation: transforms -> world geometry -> BVH refit ->
    light distributions. Returns (scene, bvh)."""
    scene = set_instance_transforms(
        scene, controller_transforms(scene, controllers, t))
    scene = update_world_geometry(scene)
    bvh = refit_skip_bvh(bvh, scene.triangles)
    scene = rebuild_light_distributions(scene)
    return scene, bvh


# ---------------------------------------------------------------------------
# two-level scenes: rigid transforms only (BLAS tables untouched)
# ---------------------------------------------------------------------------


def update_instanced_accel(acc, new_transforms):
    """An InstancedAccel refreshed for new [I, 3, 4] transforms: the
    entries' world->object inverses and world boxes, from the stored
    object-space bounds (an entry's subtree box when rebraided, else its
    BLAS's root box)."""
    m = new_transforms[acc.inst_of_chunk.to(torch.int64)]  # [C, 3, 4]
    inv = invert_transform(m)
    n_c = m.shape[0]
    inv16 = torch.zeros((n_c, 16), dtype=torch.float32, device=m.device)
    inv16[:, 0:12] = inv.reshape(n_c, 12)
    if acc.obj_lo is not None:
        blo, bhi = acc.obj_lo, acc.obj_hi
    else:
        ids = acc.blas_ids.to(torch.int64)
        blo, bhi = acc.blas_lo[ids], acc.blas_hi[ids]
    c = 0.5 * (blo + bhi)
    e = 0.5 * (bhi - blo)
    wc = transform_point(m, c)
    we = transform_vector(torch.abs(m), e)
    return dataclasses.replace(acc, inv_transforms=inv16, chunk_lo=wc - we,
                               chunk_hi=wc + we)


def _rebuild_unit_distribution_instanced(scene: SceneData, old_scale):
    """The unit-level light distribution under new instance scales: a rigid
    motion with uniform scale s scales every triangle area of a unit by
    s^2, so each unit's triangle pmf (and alias table) stays valid and only
    the unit importances rescale."""
    units = scene.units
    inst = units.instance.to(torch.int64)
    s_new = scene.instances.uniform_scale[inst]
    s_old = old_scale[inst]
    ratio = (s_new / torch.clamp(s_old, min=1e-30)) ** 2
    seg_sum = units.emissive_importance * ratio
    total = seg_sum.sum()
    unit_pmf = torch.where(total > 0,
                           seg_sum / torch.where(total > 0, total, 1.0), 0.0)
    unit_cdf = torch.cat([torch.zeros(1, device=seg_sum.device),
                          torch.cumsum(unit_pmf, 0)])
    unit_cdf = unit_cdf / torch.clamp(unit_cdf[-1:], min=1e-20)
    return dataclasses.replace(
        scene, units=dataclasses.replace(units, emissive_importance=seg_sum),
        light_unit_cdf=unit_cdf, light_unit_pmf=unit_pmf,
        light_unit_alias_prob=None, light_unit_alias_idx=None,
        total_emissive_importance=total)


def advance_frame_instanced(scene: SceneData, acc, controllers, t: float):
    """One frame of rigid animation of a two-level scene: new transforms,
    the unit-level light rescale, and the entries' inverses and world
    boxes. Nothing is rebuilt: the instances keep sharing their BLAS."""
    old_scale = scene.instances.uniform_scale
    tf = controller_transforms(scene, controllers, t)
    scene = set_instance_transforms(scene, tf)
    scene = _rebuild_unit_distribution_instanced(scene, old_scale)
    return scene, update_instanced_accel(acc, tf)
