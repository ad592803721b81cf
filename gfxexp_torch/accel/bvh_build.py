"""Host-side wide-BVH construction (port of gfxexp_tpu/accel/bvh_build.py,
without SBVH spatial splits).

Binned-SAH BVH2 (numpy) -> collapse to arity-K wide nodes -> flat arrays with
leaf triangles contiguous. The native C++ builder (accel/native.py) is used
when it builds, with the same output layout; this numpy path is the fallback.
The selection is the JAX package's, so both packages build the same tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np

_N_BINS = 16


@dataclass
class BVH:
    """Arity-K wide BVH on the host, SoA numpy. child_count: -1 empty slot,
    0 internal (child_idx = node index), >0 leaf (child_idx = first
    triangle in leaf order)."""

    child_min: np.ndarray  # [N, K, 3] float32
    child_max: np.ndarray  # [N, K, 3] float32
    child_idx: np.ndarray  # [N, K] int32
    child_count: np.ndarray  # [N, K] int32
    max_depth: int = 32
    arity: int = 4
    max_leaf: int = 4


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
                     arity: int = 4, max_leaf: int = 4):
    """Pure-numpy build; returns (child_min, child_max, child_idx,
    child_count, perm, max_depth)."""
    b2 = _build_bvh2(np.asarray(tri_min, np.float64),
                     np.asarray(tri_max, np.float64), max_leaf)
    cmin, cmax, cidx, ccount, max_depth = _collapse_to_wide(b2, arity)
    return cmin, cmax, cidx, ccount, b2.perm, max_depth


def build_bvh(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray, arity: int = 4,
              max_leaf: int = 4, use_native: bool = True,
              spatial_splits: bool = False):
    """Build from a triangle soup (p0, e1 = p1-p0, e2 = p2-p0). Returns
    (BVH, perm): callers permute their per-triangle arrays by `perm`."""
    if spatial_splits:
        raise NotImplementedError("SBVH spatial splits are not ported yet")
    p0 = np.asarray(p0)
    p1 = p0 + np.asarray(e1)
    p2 = p0 + np.asarray(e2)
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    # epsilon-pad degenerate (axis-aligned flat) boxes
    pad = 1e-7 * np.maximum(1.0, np.abs(tri_max))
    result = None
    if use_native:
        from gfxexp_torch.accel.native import build_bvh_arrays_native

        result = build_bvh_arrays_native(tri_min - pad, tri_max + pad,
                                         arity=arity, max_leaf=max_leaf)
    if result is None:
        result = build_bvh_arrays(tri_min - pad, tri_max + pad, arity=arity,
                                  max_leaf=max_leaf)
    cmin, cmax, cidx, ccount, perm, max_depth = result
    bvh = BVH(child_min=np.asarray(cmin, np.float32),
              child_max=np.asarray(cmax, np.float32),
              child_idx=np.asarray(cidx, np.int32),
              child_count=np.asarray(ccount, np.int32),
              max_depth=int(max_depth), arity=int(arity),
              max_leaf=int(max_leaf))
    return bvh, perm
