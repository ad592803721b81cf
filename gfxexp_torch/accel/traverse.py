"""Ray queries (port of gfxexp_tpu/accel/traverse.py): the closest-hit record,
the dispatch on the acceleration structure, and the brute-force oracle."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from gfxexp_torch.core.math import cross, dot
from gfxexp_torch.core.tensors import TensorData


@dataclass
class HitInfo(TensorData):
    """Closest-hit record, SoA over rays."""

    t: torch.Tensor  # [R] hit distance (= t_max when missed)
    tri: torch.Tensor  # [R] int32 triangle index, -1 on miss
    u: torch.Tensor  # [R] barycentric of corner 1
    v: torch.Tensor  # [R] barycentric of corner 2
    hit: torch.Tensor  # [R] bool
    # [R] int32 instance of the hit (two-level structures only; -1 on miss,
    # None for single-level structures)
    inst: Optional[torch.Tensor] = None


def _check_structure(bvh) -> str:
    """"widerow", "qrow", "instanced" or "skip"; raises for other
    structures."""
    from gfxexp_torch.accel.instanced import InstancedAccel
    from gfxexp_torch.accel.qrow import QRowBVH
    from gfxexp_torch.accel.skiplink import SkipBVH
    from gfxexp_torch.accel.widerow import WideRowBVH

    for kind, cls in (("widerow", WideRowBVH), ("qrow", QRowBVH),
                      ("instanced", InstancedAccel), ("skip", SkipBVH)):
        if isinstance(bvh, cls):
            return kind
    raise NotImplementedError(
        f"the port traverses WideRowBVH (one table or chunked), QRowBVH, "
        f"InstancedAccel and SkipBVH structures, got {type(bvh).__name__} "
        f"(the stack-based wide BVH of traversal='wide' is not ported)")


def intersect_closest(bvh, tris, o, d, t_min=1e-4, t_max=1e30) -> HitInfo:
    """Closest-hit query for a ray batch; o, d: [R, 3]. `tris` (the world
    triangles in traversal order) is read by the skip-link walk only: the
    row tables bake their triangles. Two-level structures also return the
    hit instance."""
    from gfxexp_torch.accel.instanced import intersect_closest_instanced
    from gfxexp_torch.accel.persistent import intersect_closest_widerow
    from gfxexp_torch.accel.qrow import intersect_closest_qrow
    from gfxexp_torch.accel.skip_traverse import intersect_closest_pallas

    kind = _check_structure(bvh)
    if kind == "instanced":
        hit, inst = intersect_closest_instanced(bvh, o, d, t_min, t_max)
        hit.inst = inst
        return hit
    if kind == "skip":
        return intersect_closest_pallas(bvh, tris, o, d, t_min, t_max)
    if kind == "qrow":
        return intersect_closest_qrow(bvh, tris, o, d, t_min, t_max)
    return intersect_closest_widerow(bvh, o, d, t_min, t_max)


def intersect_any(bvh, tris, o, d, t_min=1e-4, t_max=1e30) -> torch.Tensor:
    """Shadow-ray query: occluded [R] bool."""
    from gfxexp_torch.accel.instanced import intersect_any_instanced
    from gfxexp_torch.accel.persistent import intersect_any_widerow
    from gfxexp_torch.accel.qrow import intersect_any_qrow
    from gfxexp_torch.accel.skip_traverse import intersect_any_pallas

    kind = _check_structure(bvh)
    if kind == "instanced":
        return intersect_any_instanced(bvh, o, d, t_min, t_max)
    if kind == "skip":
        return intersect_any_pallas(bvh, tris, o, d, t_min, t_max)
    if kind == "qrow":
        return intersect_any_qrow(bvh, tris, o, d, t_min, t_max)
    return intersect_any_widerow(bvh, o, d, t_min, t_max)


def intersect_closest_brute(tris, o, d, t_min=1e-4, t_max=1e30,
                            chunk: int = 1024) -> HitInfo:
    """O(R x T) brute-force closest hit (Moller-Trumbore, both faces) — the
    correctness oracle. Chunked over triangles to bound memory."""
    n_rays = o.shape[0]
    dev = o.device
    best_t = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev),
        (n_rays,)).clone()
    best_tri = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n_rays, device=dev)
    best_v = torch.zeros(n_rays, device=dev)
    t_min = torch.broadcast_to(
        torch.as_tensor(t_min, dtype=torch.float32, device=dev), (n_rays,))
    ob = o[:, None, :]
    db = d[:, None, :]
    for start in range(0, tris.count, chunk):
        p0 = tris.p0[None, start:start + chunk]
        e1 = tris.e1[None, start:start + chunk]
        e2 = tris.e2[None, start:start + chunk]
        pv = cross(db, e2)
        det = dot(e1, pv)
        inv_det = torch.where(torch.abs(det) > 1e-12,
                              1.0 / torch.where(det == 0, 1.0, det), 0.0)
        tv = ob - p0
        u = dot(tv, pv) * inv_det
        qv = cross(tv, e1)
        v = dot(db, qv) * inv_det
        t = dot(e2, qv) * inv_det
        ok = ((torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1.0)
              & (t > t_min[:, None]) & (t < best_t[:, None]))
        t_masked = torch.where(ok, t, torch.inf)
        j = torch.argmin(t_masked, dim=1, keepdim=True)
        anyhit = torch.gather(ok, 1, j)[:, 0]
        tj = torch.gather(t_masked, 1, j)[:, 0]
        take = anyhit & (tj < best_t)
        best_t = torch.where(take, tj, best_t)
        best_tri = torch.where(take, (start + j[:, 0]).to(torch.int32),
                               best_tri)
        best_u = torch.where(take, torch.gather(u, 1, j)[:, 0], best_u)
        best_v = torch.where(take, torch.gather(v, 1, j)[:, 0], best_v)
    return HitInfo(t=best_t, tri=best_tri, u=best_u, v=best_v,
                   hit=best_tri >= 0)
