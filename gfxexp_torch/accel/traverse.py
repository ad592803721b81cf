"""Ray queries (port of gfxexp_tpu/accel/traverse.py): the closest-hit record,
the dispatch on the acceleration structure, the stack-based walk of the wide
BVH (traversal="wide") and the brute-force oracle.

The wide BVH is walked in plain torch, as the JAX package walks it in plain
jnp: every ray keeps a stack of `max_depth * (arity - 1) + 2` node ids, and
one step pops a node per ray, tests its K child boxes, pushes the hit
internal children unordered and tests the hit leaves' triangles. JAX's
`while_loop` becomes a host loop: every update is masked by the ray's stack
being non-empty, so the loop tests its condition (one host sync) every
WIDE_SYNC_EVERY steps without changing a result. The counters `wide.queries`,
`wide.syncs` and `wide.steps` (utils/trace.py) count the queries, the tests
of the loop condition and the loop steps of all queries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from gfxexp_torch.core.math import cross, dot
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.utils import trace

WIDE_SYNC_EVERY = 4  # steps of the wide walk between tests of its condition


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
    """"widerow", "qrow", "instanced", "skip" or "wide"; raises for other
    structures."""
    from gfxexp_torch.accel.bvh_build import BVH
    from gfxexp_torch.accel.instanced import InstancedAccel
    from gfxexp_torch.accel.qrow import QRowBVH
    from gfxexp_torch.accel.skiplink import SkipBVH
    from gfxexp_torch.accel.widerow import WideRowBVH

    for kind, cls in (("widerow", WideRowBVH), ("qrow", QRowBVH),
                      ("instanced", InstancedAccel), ("skip", SkipBVH),
                      ("wide", BVH)):
        if isinstance(bvh, cls):
            return kind
    raise TypeError(
        f"the port traverses WideRowBVH (one table or chunked), QRowBVH, "
        f"InstancedAccel, SkipBVH and BVH structures, got "
        f"{type(bvh).__name__}")


def intersect_tris(tris, idx, o, d, t_min, t_cur):
    """Moller-Trumbore for gathered triangle indices, both faces. idx [R,
    M]; o, d [R, 1, 3]; t_min, t_cur [R, 1]. Returns (ok, t, u, v) [R, M]
    with ok requiring t_min < t < t_cur."""
    p0 = tris.p0[idx]
    e1 = tris.e1[idx]
    e2 = tris.e2[idx]
    pv = cross(d, e2)
    det = dot(e1, pv)
    inv_det = torch.where(torch.abs(det) > 1e-12,
                          1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tv = o - p0
    u = dot(tv, pv) * inv_det
    qv = cross(tv, e1)
    v = dot(d, qv) * inv_det
    t = dot(e2, qv) * inv_det
    ok = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > t_min) & (t < t_cur))
    return ok, t, u, v


def _traverse(bvh, tris, o, d, t_min, t_max, any_hit: bool) -> HitInfo:
    """The stack-based walk of a wide BVH (gfxexp_tpu/accel/traverse.py
    `_traverse`), closest or any hit. A leaf holds up to `bvh.max_leaf`
    triangles (JAX's walk tests 4 unless told otherwise). A step tests a
    node's leaf triangles k-major, then j, against the ray's best t before
    the step: the first of the nearest ones wins, as JAX's sequence of
    strict `t < best_t` updates picks it. A push past the stack is
    dropped, and a pop past it reads the last entry, as JAX's scatter and
    gather do."""
    n = o.shape[0]
    dev = o.device
    arity, max_leaf = bvh.arity, bvh.max_leaf
    depth = bvh.max_depth * (arity - 1) + 2
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)
    lane = torch.arange(n, device=dev)
    t_min = torch.broadcast_to(
        torch.as_tensor(t_min, dtype=torch.float32, device=dev), (n,))
    best_t = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev),
        (n,)).clone()
    # one spare column takes the dropped pushes
    stack = torch.zeros((n, depth + 1), dtype=torch.int32, device=dev)
    sp = torch.ones(n, dtype=torch.int32, device=dev)  # the root at slot 0
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    o3, d3 = o[:, None, :], d[:, None, :]
    inv3 = inv_d[:, None, :]
    jj = torch.arange(max_leaf, device=dev)
    trace.count("wide.queries")
    step = 0
    while True:
        if step % WIDE_SYNC_EVERY == 0:
            trace.count("wide.syncs")
            if not bool((sp > 0).any()):
                break
        step += 1
        active = sp > 0
        sp1 = torch.clamp(sp - 1, min=0)
        node = torch.where(
            active, stack[lane, torch.clamp(sp1, max=depth - 1).long()],
            0).long()
        sp = torch.where(active, sp1, sp)
        cmin = bvh.child_min[node]  # [R, K, 3]
        cmax = bvh.child_max[node]
        ccount = bvh.child_count[node]  # [R, K]
        cidx = bvh.child_idx[node]
        t0 = (cmin - o3) * inv3
        t1 = (cmax - o3) * inv3
        near = torch.maximum(torch.minimum(t0, t1).amax(-1), t_min[:, None])
        far = torch.minimum(torch.maximum(t0, t1).amin(-1), best_t[:, None])
        box_hit = (near <= far) & active[:, None] & (ccount >= 0)

        internal = box_hit & (ccount == 0)
        offs = torch.cumsum(internal.to(torch.int32), dim=1)
        pos = torch.where(internal, sp[:, None] + offs - 1, depth)
        stack.scatter_(1, torch.clamp(pos, max=depth).long(), cidx)
        sp = sp + offs[:, -1].to(torch.int32)

        # leaf children: every (k, j) test at once against the best t
        # before the step, the first nearest taken
        leaf = box_hit & (ccount > 0)
        valid = (leaf[:, :, None]
                 & (jj[None, None, :] < ccount[:, :, None])).reshape(n, -1)
        tri_i = torch.where(valid, (cidx[:, :, None] + jj).reshape(n, -1),
                            0).long()
        ok, t, u, v = intersect_tris(tris, tri_i, o3, d3, t_min[:, None],
                                     best_t[:, None])
        ok = ok & valid
        tm = torch.where(ok, t, torch.inf)
        j = torch.argmin(tm, dim=1, keepdim=True)
        take = ok.any(dim=1)
        best_t = torch.where(take, torch.gather(tm, 1, j)[:, 0], best_t)
        best_tri = torch.where(take, torch.gather(tri_i, 1, j)[:, 0].to(
            torch.int32), best_tri)
        best_u = torch.where(take, torch.gather(u, 1, j)[:, 0], best_u)
        best_v = torch.where(take, torch.gather(v, 1, j)[:, 0], best_v)
        if any_hit:
            sp = torch.where(best_tri >= 0, 0, sp)
    trace.count("wide.steps", step)
    return HitInfo(t=best_t, tri=best_tri, u=best_u, v=best_v,
                   hit=best_tri >= 0)


def walk_library(bvh) -> Optional[str]:
    """The csrc library (csrc/<name>.cu) whose kernel walks `bvh` on the
    card, so that a caller can build it with its own kernels at once; None
    for the wide BVH, whose walk is plain torch."""
    from gfxexp_torch.accel import persistent

    kind = _check_structure(bvh)
    if kind == "widerow":
        return persistent.walk_library(bvh)
    return {"qrow": "qrow_traverse", "instanced": "instanced_traverse",
            "skip": "skiplink_traverse"}.get(kind)


def intersect_closest(bvh, tris, o, d, t_min=1e-4, t_max=1e30) -> HitInfo:
    """Closest-hit query for a ray batch; o, d: [R, 3]. `tris` (the world
    triangles in traversal order) is read by the skip-link and wide BVH
    walks only: the row tables bake their triangles. Two-level structures
    also return the hit instance. Span `gfx.walk.closest`: the routing,
    the rays' preparation and the walk's launch."""
    from gfxexp_torch.accel.instanced import intersect_closest_instanced
    from gfxexp_torch.accel.persistent import intersect_closest_widerow
    from gfxexp_torch.accel.qrow import intersect_closest_qrow
    from gfxexp_torch.accel.skip_traverse import intersect_closest_pallas

    with trace.span("gfx.walk.closest"):
        kind = _check_structure(bvh)
        if kind == "wide":
            return _traverse(bvh, tris, o, d, t_min, t_max, any_hit=False)
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
    """Shadow-ray query: occluded [R] bool. Span `gfx.walk.any`, as
    intersect_closest's."""
    from gfxexp_torch.accel.instanced import intersect_any_instanced
    from gfxexp_torch.accel.persistent import intersect_any_widerow
    from gfxexp_torch.accel.qrow import intersect_any_qrow
    from gfxexp_torch.accel.skip_traverse import intersect_any_pallas

    with trace.span("gfx.walk.any"):
        kind = _check_structure(bvh)
        if kind == "wide":
            return _traverse(bvh, tris, o, d, t_min, t_max, any_hit=True).hit
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
