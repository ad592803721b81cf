"""Host-side wide-BVH construction (port of gfxexp_tpu/accel/bvh_build.py).

Binned-SAH BVH2 (numpy) -> collapse to arity-K wide nodes -> flat arrays with
leaf triangles contiguous. With spatial splits (SBVH) straddling triangles
are clipped into several leaves, so the permutation may repeat triangle ids.
The native C++ builder (accel/native.py) is used when it builds, with the
same output layout; this numpy path is the fallback. The selection is the
JAX package's, so both packages build the same tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gfxexp_torch.core.tensors import TensorData

_N_BINS = 16


@dataclass
class BVH(TensorData):
    """Arity-K wide BVH, SoA tensors (the structure of traversal="wide",
    walked by accel/traverse.py). child_count: -1 empty slot, 0 internal
    (child_idx = node index), >0 leaf (child_idx = first triangle in leaf
    order, child_count = its triangles)."""

    child_min: torch.Tensor  # [N, K, 3] float32
    child_max: torch.Tensor  # [N, K, 3] float32
    child_idx: torch.Tensor  # [N, K] int32
    child_count: torch.Tensor  # [N, K] int32
    max_depth: int = 32
    arity: int = 4
    max_leaf: int = 4

    @property
    def num_nodes(self):
        return self.child_idx.shape[0]


class _Bvh2(NamedTuple):
    mins: np.ndarray  # [N, 3]
    maxs: np.ndarray  # [N, 3]
    left: np.ndarray  # [N]
    right: np.ndarray  # [N]
    count: np.ndarray  # [N] leaf if > 0 (left = first primitive)
    perm: np.ndarray  # [T] primitive permutation


def _build_bvh2(tri_min: np.ndarray, tri_max: np.ndarray,
                max_leaf: int) -> _Bvh2:
    n_tris = tri_min.shape[0]
    centroid = 0.5 * (tri_min + tri_max)
    perm = np.arange(n_tris)

    mins, maxs, left, right, count = [], [], [], [], []

    def alloc():
        mins.append(None)
        maxs.append(None)
        left.append(0)
        right.append(0)
        count.append(0)
        return len(mins) - 1

    root = alloc()
    stack = [(root, 0, n_tris)]
    while stack:
        node, start, end = stack.pop()
        ids = perm[start:end]
        bmin = tri_min[ids].min(axis=0)
        bmax = tri_max[ids].max(axis=0)
        mins[node] = bmin
        maxs[node] = bmax
        n = end - start
        if n <= max_leaf:
            left[node] = start
            count[node] = n
            continue
        cen = centroid[ids]
        cmin = cen.min(axis=0)
        cmax = cen.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            order = np.argsort(cen[:, axis], kind="stable")
            mid = n // 2
        else:
            scale = _N_BINS * (1.0 - 1e-6) / extent[axis]
            bins = np.clip(((cen[:, axis] - cmin[axis]) * scale)
                           .astype(np.int32), 0, _N_BINS - 1)
            bin_count = np.bincount(bins, minlength=_N_BINS)
            bin_min = np.full((_N_BINS, 3), np.inf)
            bin_max = np.full((_N_BINS, 3), -np.inf)
            for b in range(_N_BINS):
                sel = bins == b
                if bin_count[b]:
                    bin_min[b] = tri_min[ids[sel]].min(axis=0)
                    bin_max[b] = tri_max[ids[sel]].max(axis=0)
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                d[~np.isfinite(d)] = 0.0
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                              + d[:, 2] * d[:, 0])

            lcnt = np.cumsum(bin_count)
            cost = (area(lmin, lmax)[:-1] * lcnt[:-1]
                    + area(rmin, rmax)[1:] * (n - lcnt[:-1]))
            best = int(np.argmin(cost))
            go_left = bins <= best
            mid = int(go_left.sum())
            if mid == 0 or mid == n:
                order = np.argsort(cen[:, axis], kind="stable")
                mid = n // 2
            else:
                order = np.argsort(~go_left, kind="stable")
        perm[start:end] = ids[order]
        l_node = alloc()
        r_node = alloc()
        left[node] = l_node
        right[node] = r_node
        stack.append((l_node, start, start + mid))
        stack.append((r_node, start + mid, end))

    return _Bvh2(mins=np.stack(mins), maxs=np.stack(maxs),
                 left=np.asarray(left, np.int64),
                 right=np.asarray(right, np.int64),
                 count=np.asarray(count, np.int64), perm=perm)


def _clip_tri_to_slab(v0, v1, v2, box_min, box_max, axis, lo, hi):
    """AABB of each triangle clipped to the axis slab [lo, hi], intersected
    with the reference's current box (conservative re-clip for references
    already narrowed on other axes). Vectorized over the leading dim.

    Reference: bvh_builder.cpp:506 splitTriangle does exact polygon
    clipping; this clips via the 9 candidate points (3 verts + 3 edges x 2
    planes) which yields the same AABB for a single slab clip and a
    conservative (possibly looser) box when composed across axes."""
    pts = []  # (point [n, 3], valid [n])
    for v in (v0, v1, v2):
        pts.append((v, (v[:, axis] >= lo) & (v[:, axis] <= hi)))
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        da = b[:, axis] - a[:, axis]
        safe = np.abs(da) > 1e-30
        for plane in (lo, hi):
            t = (plane - a[:, axis]) / np.where(safe, da, 1.0)
            ok = safe & (t >= 0.0) & (t <= 1.0)
            p = a + t[:, None] * (b - a)
            pts.append((p, ok))
    cmin = np.full_like(v0, np.inf)
    cmax = np.full_like(v0, -np.inf)
    for p, ok in pts:
        okn = ok[:, None]
        cmin = np.minimum(cmin, np.where(okn, p, np.inf))
        cmax = np.maximum(cmax, np.where(okn, p, -np.inf))
    # numerical safety: clamp the slab axis exactly and intersect with the
    # reference's current box
    cmin[:, axis] = np.maximum(cmin[:, axis], lo)
    cmax[:, axis] = np.minimum(cmax[:, axis], hi)
    cmin = np.maximum(cmin, box_min)
    cmax = np.minimum(cmax, box_max)
    # degenerate clips (no candidate point survived) collapse to the box
    bad = ~np.isfinite(cmin).all(axis=1) | ~np.isfinite(cmax).all(axis=1)
    cmin[bad] = box_min[bad]
    cmax[bad] = box_max[bad]
    return cmin, cmax


def _build_bvh2_spatial(tri_min, tri_max, max_leaf: int, verts,
                        alpha: float = 1e-5,
                        split_budget: float = 0.3) -> _Bvh2:
    """SBVH-style BVH2 build: binned SAH object splits plus spatial splits
    with triangle clipping and reference duplication (reference:
    bvh_builder.cpp:313 findBestSpatialSplit, :506 splitTriangle).

    A spatial split is only evaluated when the best object split's child
    overlap exceeds `alpha` x the root surface area (the SBVH paper's
    restriction, mirrored by the reference's splittingBudget config), and
    total duplicated references are capped at split_budget x n_tris.

    Returns _Bvh2 whose perm may contain DUPLICATE triangle ids (length
    >= n_tris); callers gather per-triangle arrays by perm as usual."""
    v0, v1, v2 = (np.asarray(v, np.float64) for v in verts)
    n_tris = tri_min.shape[0]
    # growable reference arrays
    cap = n_tris + int(split_budget * n_tris) + 8
    ref_tri = np.empty(cap, np.int64)
    ref_min = np.empty((cap, 3), np.float64)
    ref_max = np.empty((cap, 3), np.float64)
    ref_tri[:n_tris] = np.arange(n_tris)
    ref_min[:n_tris] = tri_min
    ref_max[:n_tris] = tri_max
    n_refs = n_tris

    root_d = np.maximum(tri_max.max(axis=0) - tri_min.min(axis=0), 0.0)
    root_area = 2.0 * (root_d[0] * root_d[1] + root_d[1] * root_d[2]
                       + root_d[2] * root_d[0])
    alpha_area = alpha * max(root_area, 1e-30)

    mins, maxs, left, right, count = [], [], [], [], []
    leaf_refs = []  # per-leaf ref-id arrays, in creation order

    def alloc():
        mins.append(None)
        maxs.append(None)
        left.append(0)
        right.append(0)
        count.append(0)
        return len(mins) - 1

    def area_of(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    root = alloc()
    stack = [(root, np.arange(n_tris))]
    while stack:
        node, refs = stack.pop()
        rmin = ref_min[refs]
        rmax = ref_max[refs]
        bmin = rmin.min(axis=0)
        bmax = rmax.max(axis=0)
        mins[node] = bmin
        maxs[node] = bmax
        n = refs.shape[0]
        if n <= max_leaf:
            left[node] = len(leaf_refs)  # patched to a range later
            count[node] = n
            leaf_refs.append(refs)
            continue
        cen = 0.5 * (rmin + rmax)
        cmin_c = cen.min(axis=0)
        cmax_c = cen.max(axis=0)
        extent = cmax_c - cmin_c
        axis = int(np.argmax(extent))

        # ---- object split (binned SAH over reference centroids) --------
        obj_cost = np.inf
        obj_sel = None
        obj_overlap = np.inf
        if extent[axis] > 1e-12:
            scale = _N_BINS * (1.0 - 1e-6) / extent[axis]
            bins = np.clip(((cen[:, axis] - cmin_c[axis]) * scale)
                           .astype(np.int32), 0, _N_BINS - 1)
            bin_count = np.bincount(bins, minlength=_N_BINS)
            bin_min = np.full((_N_BINS, 3), np.inf)
            bin_max = np.full((_N_BINS, 3), -np.inf)
            for bb in range(_N_BINS):
                sel = bins == bb
                if bin_count[bb]:
                    bin_min[bb] = rmin[sel].min(axis=0)
                    bin_max[bb] = rmax[sel].max(axis=0)
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmn = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmx = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]

            def areas(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                d[~np.isfinite(d)] = 0.0
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                              + d[:, 2] * d[:, 0])

            lcnt = np.cumsum(bin_count)
            cost = (areas(lmin, lmax)[:-1] * lcnt[:-1]
                    + areas(rmn, rmx)[1:] * (n - lcnt[:-1]))
            bi = int(np.argmin(cost))
            if 0 < lcnt[bi] < n:
                obj_cost = cost[bi]
                obj_sel = bins <= bi
                ov_min = np.maximum(lmin[bi], rmn[bi + 1])
                ov_max = np.minimum(lmax[bi], rmx[bi + 1])
                obj_overlap = (area_of(ov_min, ov_max)
                               if (ov_max > ov_min).all() else 0.0)

        # ---- spatial split (chopped binning + clipping) -----------------
        sp_cost = np.inf
        sp_plane = None
        node_ext = bmax[axis] - bmin[axis]
        budget_left = cap - n_refs
        if (obj_sel is None or obj_overlap > alpha_area) and \
                node_ext > 1e-12 and budget_left > 0:
            sscale = _N_BINS * (1.0 - 1e-6) / node_ext
            entry = np.clip(((rmin[:, axis] - bmin[axis]) * sscale)
                            .astype(np.int32), 0, _N_BINS - 1)
            exit_ = np.clip(((rmax[:, axis] - bmin[axis]) * sscale)
                            .astype(np.int32), 0, _N_BINS - 1)
            sbin_min = np.full((_N_BINS, 3), np.inf)
            sbin_max = np.full((_N_BINS, 3), -np.inf)
            tid = ref_tri[refs]
            for bb in range(_N_BINS):
                span = (entry <= bb) & (exit_ >= bb)
                if not span.any():
                    continue
                blo = bmin[axis] + bb * node_ext / _N_BINS
                bhi = bmin[axis] + (bb + 1) * node_ext / _N_BINS
                s = np.nonzero(span)[0]
                cmn, cmx = _clip_tri_to_slab(
                    v0[tid[s]], v1[tid[s]], v2[tid[s]],
                    rmin[s], rmax[s], axis, blo, bhi)
                sbin_min[bb] = np.minimum(sbin_min[bb], cmn.min(axis=0))
                sbin_max[bb] = np.maximum(sbin_max[bb], cmx.max(axis=0))
            ent_cnt = np.bincount(entry, minlength=_N_BINS)
            ex_cnt = np.bincount(exit_, minlength=_N_BINS)
            slmin = np.minimum.accumulate(sbin_min, axis=0)
            slmax = np.maximum.accumulate(sbin_max, axis=0)
            srmin = np.minimum.accumulate(sbin_min[::-1], axis=0)[::-1]
            srmax = np.maximum.accumulate(sbin_max[::-1], axis=0)[::-1]

            def areas2(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                d[~np.isfinite(d)] = 0.0
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                              + d[:, 2] * d[:, 0])

            nl = np.cumsum(ent_cnt)[:-1]  # refs entering before plane i+1
            nr = n - np.cumsum(ex_cnt)[:-1]  # refs exiting at/after plane
            scost = areas2(slmin, slmax)[:-1] * nl + areas2(srmin, srmax)[1:] * nr
            ok = (nl > 0) & (nr > 0)
            if ok.any():
                scost = np.where(ok, scost, np.inf)
                sbi = int(np.argmin(scost))
                n_dup = int(((entry <= sbi) & (exit_ > sbi)).sum())
                if n_dup <= budget_left:
                    sp_cost = scost[sbi]
                    sp_plane = (sbi, entry, exit_)

        if sp_plane is not None and sp_cost < obj_cost:
            sbi, entry, exit_ = sp_plane
            plane = bmin[axis] + (sbi + 1) * node_ext / _N_BINS
            go_l = exit_ <= sbi
            go_r = entry > sbi
            strad = ~go_l & ~go_r
            l_refs = [refs[go_l]]
            r_refs = [refs[go_r]]
            si = np.nonzero(strad)[0]
            if si.size:
                tid = ref_tri[refs[si]]
                lmin_c, lmax_c = _clip_tri_to_slab(
                    v0[tid], v1[tid], v2[tid], rmin[si], rmax[si],
                    axis, bmin[axis], plane)
                rmin_c, rmax_c = _clip_tri_to_slab(
                    v0[tid], v1[tid], v2[tid], rmin[si], rmax[si],
                    axis, plane, bmax[axis])
                # straddlers keep their ref id on the left, duplicate right
                ref_min[refs[si]] = lmin_c
                ref_max[refs[si]] = lmax_c
                new_ids = np.arange(n_refs, n_refs + si.size)
                ref_tri[new_ids] = tid
                ref_min[new_ids] = rmin_c
                ref_max[new_ids] = rmax_c
                n_refs += si.size
                l_refs.append(refs[si])
                r_refs.append(new_ids)
            l_ids = np.concatenate(l_refs)
            r_ids = np.concatenate(r_refs)
        elif obj_sel is not None:
            l_ids = refs[obj_sel]
            r_ids = refs[~obj_sel]
        else:
            order = np.argsort(cen[:, axis], kind="stable")
            mid = n // 2
            l_ids = refs[order[:mid]]
            r_ids = refs[order[mid:]]

        l_node = alloc()
        r_node = alloc()
        left[node] = l_node
        right[node] = r_node
        stack.append((l_node, l_ids))
        stack.append((r_node, r_ids))

    # assign contiguous leaf ranges in leaf-creation order
    perm_parts = []
    offset = 0
    leaf_start = np.empty(len(leaf_refs), np.int64)
    for i, lr in enumerate(leaf_refs):
        leaf_start[i] = offset
        perm_parts.append(ref_tri[lr])
        offset += lr.shape[0]
    count_arr = np.asarray(count, np.int64)
    left_arr = np.asarray(left, np.int64)
    is_leaf = count_arr > 0
    left_arr[is_leaf] = leaf_start[left_arr[is_leaf]]
    return _Bvh2(
        mins=np.stack(mins),
        maxs=np.stack(maxs),
        left=left_arr,
        right=np.asarray(right, np.int64),
        count=count_arr,
        perm=(np.concatenate(perm_parts) if perm_parts
              else np.empty(0, np.int64)),
    )


def _collapse_to_wide(b2: _Bvh2, arity: int) -> Tuple[np.ndarray, ...]:
    """Collapse BVH2 to arity-K by pulling up children, largest area
    first."""

    def area(i):
        d = np.maximum(b2.maxs[i] - b2.mins[i], 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    child_min, child_max, child_idx, child_count = [], [], [], []

    def alloc():
        child_min.append(np.zeros((arity, 3), np.float32))
        child_max.append(np.zeros((arity, 3), np.float32))
        child_idx.append(np.zeros(arity, np.int32))
        child_count.append(np.full(arity, -1, np.int32))
        return len(child_idx) - 1

    root = alloc()
    max_depth = 1
    stack = [(root, 0, 1)]  # (wide node, bvh2 node, depth)
    while stack:
        wnode, b2node, depth = stack.pop()
        max_depth = max(max_depth, depth)
        group = ([b2node] if b2.count[b2node] > 0
                 else [b2.left[b2node], b2.right[b2node]])
        while len(group) < arity:
            candidates = [g for g in group if b2.count[g] == 0]
            if not candidates:
                break
            pick = max(candidates, key=area)
            group.remove(pick)
            group.extend([b2.left[pick], b2.right[pick]])
        for k, g in enumerate(group):
            child_min[wnode][k] = b2.mins[g]
            child_max[wnode][k] = b2.maxs[g]
            if b2.count[g] > 0:
                child_idx[wnode][k] = b2.left[g]
                child_count[wnode][k] = b2.count[g]
            else:
                sub = alloc()
                child_idx[wnode][k] = sub
                child_count[wnode][k] = 0
                stack.append((sub, g, depth + 1))

    return (np.stack(child_min), np.stack(child_max), np.stack(child_idx),
            np.stack(child_count), max_depth)


def build_bvh_arrays(tri_min: np.ndarray, tri_max: np.ndarray,
                     arity: int = 4, max_leaf: int = 4, verts=None):
    """Pure-numpy build; returns (child_min, child_max, child_idx,
    child_count, perm, max_depth).

    `verts=(p0, p1, p2)` builds with SBVH spatial splits: the perm may then
    hold duplicate triangle ids and be longer than the triangle count
    (references clipped into several leaves)."""
    tri_min = np.asarray(tri_min, np.float64)
    tri_max = np.asarray(tri_max, np.float64)
    if verts is not None:
        b2 = _build_bvh2_spatial(tri_min, tri_max, max_leaf, verts)
    else:
        b2 = _build_bvh2(tri_min, tri_max, max_leaf)
    cmin, cmax, cidx, ccount, max_depth = _collapse_to_wide(b2, arity)
    return cmin, cmax, cidx, ccount, b2.perm, max_depth


def build_bvh(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray, arity: int = 4,
              max_leaf: int = 4, use_native: bool = True,
              spatial_splits: bool = False):
    """Build from a triangle soup (p0, e1 = p1-p0, e2 = p2-p0). Returns
    (BVH on the CPU, perm): callers permute their per-triangle arrays by
    `perm`. With spatial_splits=True (SBVH) `perm` may hold duplicates and
    be longer than the soup: gathering by it copies the straddling
    triangles, whose attributes are identical.

    The native builder is used when `use_native` and its library loads;
    the numpy builder otherwise (native/ fails to build: the loader says
    so on stderr)."""
    p0 = np.asarray(p0)
    p1 = p0 + np.asarray(e1)
    p2 = p0 + np.asarray(e2)
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    # epsilon-pad degenerate (axis-aligned flat) boxes
    pad = 1e-7 * np.maximum(1.0, np.abs(tri_max))
    result = None
    if spatial_splits:
        if use_native:
            from gfxexp_torch.accel.native import build_bvh_arrays_native_sbvh

            result = build_bvh_arrays_native_sbvh(
                tri_min - pad, tri_max + pad, (p0, p1, p2), arity=arity,
                max_leaf=max_leaf)
        if result is None:
            result = build_bvh_arrays(tri_min - pad, tri_max + pad,
                                      arity=arity, max_leaf=max_leaf,
                                      verts=(p0, p1, p2))
    if result is None and use_native:
        from gfxexp_torch.accel.native import build_bvh_arrays_native

        result = build_bvh_arrays_native(tri_min - pad, tri_max + pad,
                                         arity=arity, max_leaf=max_leaf)
    if result is None:
        result = build_bvh_arrays(tri_min - pad, tri_max + pad, arity=arity,
                                  max_leaf=max_leaf)
    cmin, cmax, cidx, ccount, perm, max_depth = result
    bvh = BVH(child_min=torch.from_numpy(np.asarray(cmin, np.float32)),
              child_max=torch.from_numpy(np.asarray(cmax, np.float32)),
              child_idx=torch.from_numpy(np.asarray(cidx, np.int32)),
              child_count=torch.from_numpy(np.asarray(ccount, np.int32)),
              max_depth=int(max_depth), arity=int(arity),
              max_leaf=int(max_leaf))
    return bvh, perm
