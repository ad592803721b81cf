"""The wide-row BVH table (port of gfxexp_tpu/accel/pallas_widestack.py:85-304)
and the routing switch of the single- and two-level walks (:777-804).

One [64] float32 row per node, in [C, R, 64] chunk tables:
- internal row (col 63 == 0): child k at cols [7k, 7k+7) = lo.xyz hi.xyz
  bitcast(child row within the chunk), -1 for an empty slot;
- leaf row (col 63 == 1): triangle j at cols [12j, 12j+12) in Baldwin-Weber
  form n.xyz d0 U.xyz Ud V.xyz Vd (t = -(n.o + d0)/(n.d); P = o + t d;
  u = U.P + Ud; v = V.P + Vd); col 60 = bitcast(first | count << 24) with
  global triangle ids.

A scene whose table exceeds `max_rows` rows (13,000 by default, about 35k
triangles) is split into Morton-ordered chunks, one BVH each, with a world
AABB per chunk (`chunk_lo`, `chunk_hi`), exactly as the JAX package splits
it: both packages give the same tables, triangle order and chunk boxes. A
single-chunk table (C = 1) has no chunk boxes. accel/persistent.py walks
single-chunk tables with kernel 1 and chunked ones (or any table with the
switch below off) with kernel 2.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gfxexp_torch.accel.bvh_build import BVH, build_bvh
from gfxexp_torch.core.tensors import TensorData

WIDTH = 64
COUNT_SHIFT = 24
MAX_ROWS_PER_CHUNK = 13000

# Routing of the walks, one switch for single- and two-level tables as in
# the JAX package: on (the default), single-chunk tables take kernel 1 and
# two-level tables the nearest-first entry walk; off, every single-level
# table takes kernel 2 and two-level tables the build-order walk. None
# defers to the environment variable GFXEXP_PERSIST ("1" is on), read at
# call time.
PERSISTENT: Optional[bool] = None


def set_persistent(on: Optional[bool]) -> None:
    """Override the routing (None = environment GFXEXP_PERSIST)."""
    global PERSISTENT
    PERSISTENT = on


def persist_on() -> bool:
    on = PERSISTENT
    if on is None:
        on = os.environ.get("GFXEXP_PERSIST", "1") == "1"
    return on


@dataclass
class WideRowBVH(TensorData):
    nodes: torch.Tensor  # [C, R, 64] float32 chunk tables
    arity: int = 4
    width: int = WIDTH
    max_leaf: int = 4
    max_depth: int = 32
    # per-chunk world AABBs; None on single-chunk tables
    chunk_lo: Optional[torch.Tensor] = None  # [C, 3]
    chunk_hi: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.nodes.dim() != 3:
            raise ValueError(f"nodes must be [C, R, {WIDTH}], got "
                             f"{tuple(self.nodes.shape)}")

    @property
    def num_chunks(self) -> int:
        return self.nodes.shape[0]

    @property
    def rows_per_chunk(self) -> int:
        return self.nodes.shape[1]

    @property
    def num_nodes(self) -> int:
        """Rows of all chunks, padding rows included."""
        return self.nodes.shape[0] * self.nodes.shape[1]

    def flat(self) -> "WideRowBVH":
        """The chunks as one [1, C*R, 64] table (a view, no chunk boxes):
        child rows of chunk c then count from row c * R."""
        c, r, w = self.nodes.shape
        return WideRowBVH(nodes=self.nodes.reshape(1, c * r, w),
                          arity=self.arity, width=self.width,
                          max_leaf=self.max_leaf, max_depth=self.max_depth)


def _pack_one(bvh: BVH, p0, e1, e2, tri_offset: int = 0) -> np.ndarray:
    """Flatten a wide BVH and its leaf-order triangles into an [r, 64]
    numpy row table (leaf rows carry global ids tri_offset + first)."""
    child_min = np.asarray(bvh.child_min, np.float32)
    child_max = np.asarray(bvh.child_max, np.float32)
    child_idx = np.asarray(bvh.child_idx, np.int32)
    child_count = np.asarray(bvh.child_count, np.int32)
    n_int, arity = child_idx.shape
    max_leaf = int(bvh.max_leaf)
    if not (arity <= 8 and max_leaf * 12 + 4 <= WIDTH):
        raise ValueError(f"row format holds arity <= 8 and max_leaf <= 5, "
                         f"got {arity}, {max_leaf}")

    # leaf child slots become rows appended after the internal rows
    is_leaf = child_count > 0
    leaf_id = np.cumsum(is_leaf.ravel()).reshape(is_leaf.shape) - 1
    n_leaf = int(is_leaf.sum())
    meta = np.where(
        is_leaf, n_int + leaf_id,
        np.where(child_count == 0, child_idx, -1)).astype(np.int32)
    leaf_first = child_idx[is_leaf].astype(np.int32)
    leaf_count = child_count[is_leaf].astype(np.int32)

    r = n_int + n_leaf
    tab = np.zeros((r, WIDTH), np.float32)
    for k in range(arity):
        tab[:n_int, 7 * k + 0:7 * k + 3] = child_min[:, k]
        tab[:n_int, 7 * k + 3:7 * k + 6] = child_max[:, k]
        tab[:n_int, 7 * k + 6] = meta[:, k].view(np.float32)
    if n_leaf:
        top = int(leaf_first.max(initial=0)) + tri_offset
        if top >= (1 << COUNT_SHIFT):
            raise ValueError(f"triangle id {top} exceeds the 24-bit leaf "
                             "packing")
        n_tris = p0.shape[0]
        for j in range(max_leaf):
            ti = np.minimum(leaf_first + j, n_tris - 1)
            # Baldwin-Weber rows in float64 so the float32 barycentrics stay
            # accurate for small and sliver triangles
            P = p0[ti].astype(np.float64)
            E1 = e1[ti].astype(np.float64)
            E2 = e2[ti].astype(np.float64)
            Nn = np.cross(E1, E2)
            nn2 = np.maximum((Nn * Nn).sum(-1, keepdims=True), 1e-300)
            U = np.cross(E2, Nn) / nn2
            V = np.cross(Nn, E1) / nn2
            base = 12 * j
            tab[n_int:, base + 0:base + 3] = Nn
            tab[n_int:, base + 3] = -(Nn * P).sum(-1)
            tab[n_int:, base + 4:base + 7] = U
            tab[n_int:, base + 7] = -(U * P).sum(-1)
            tab[n_int:, base + 8:base + 11] = V
            tab[n_int:, base + 11] = -(V * P).sum(-1)
        tab[n_int:, WIDTH - 4] = (
            (leaf_first + tri_offset)
            | (leaf_count << COUNT_SHIFT)).view(np.float32)
    tab[n_int:, WIDTH - 1] = 1.0  # tag: leaf
    return tab


def pack_widerows(bvh: BVH, tris) -> WideRowBVH:
    """Single-chunk table [1, R, 64] of one wide BVH and its triangles
    (a TriangleSoA in the BVH's leaf order), on the host."""
    tab = _pack_one(bvh, *(np.asarray(x.cpu(), np.float32)
                           for x in (tris.p0, tris.e1, tris.e2)))
    return WideRowBVH(nodes=torch.from_numpy(tab[None]), arity=int(bvh.arity),
                      width=WIDTH, max_leaf=int(bvh.max_leaf),
                      max_depth=int(bvh.max_depth))


def morton_chunks(p0, e1, e2, est_rows: int, max_rows: int, min_tris: int,
                  pack):
    """The chunked build shared by the wide-row and quantized tables
    (pallas_widestack.py:244-292, pallas_qrow.py:238-284): triangles in
    Morton order of their centroids (10 bits an axis) are cut into ranges of
    about n * max_rows / est_rows; `pack(sel, tri_offset)` builds one
    range's table and returns (table, leaf-order global ids, extra). A
    table over max_rows rows is split in half and retried. A chunk's
    triangles start at the sum of the earlier chunks' ids (its leaf-order
    references, duplicates included). Returns the chunks' (table, ids,
    extra) in order."""
    n = p0.shape[0]
    c0 = p0 + (e1 + e2) / 3.0  # centroids
    lo = c0.min(axis=0)
    span = np.maximum(c0.max(axis=0) - lo, 1e-12)
    q = np.minimum(((c0 - lo) / span) * 1024.0, 1023.0).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    order = np.argsort(morton, kind="stable")

    tris_per_chunk = max(int(n * max_rows / est_rows), min_tris)
    n_chunks = -(-n // tris_per_chunk)
    work = [(c * tris_per_chunk, min((c + 1) * tris_per_chunk, n))
            for c in range(n_chunks)]
    work.reverse()  # pop() takes the ranges in ascending order
    out = []
    tri_offset = 0
    while work:
        start, end = work.pop()
        tab, gsel, extra = pack(order[start:end], tri_offset)
        if tab.shape[0] > max_rows and end - start > min_tris:
            mid = (start + end) // 2
            work.append((mid, end))
            work.append((start, mid))
            continue
        out.append((tab, gsel, extra))
        # a chunk built with spatial splits holds more references than
        # its range has triangles
        tri_offset += len(gsel)
    return out


def stack_chunks(tabs, width: int, pad_leaf: bool) -> np.ndarray:
    """[C, R, width] float32 with R the largest chunk's rows; padding rows
    are zeros, leaf-tagged with count 0 when pad_leaf (unreachable)."""
    r_max = max(t.shape[0] for t in tabs)
    stacked = np.zeros((len(tabs), r_max, width), np.float32)
    for c, t in enumerate(tabs):
        stacked[c, :t.shape[0]] = t
        if pad_leaf:
            stacked[c, t.shape[0]:, width - 1] = 1.0
    return stacked


def build_widerow(p0, e1, e2, arity: int = 4, max_leaf: int = 4,
                  max_rows: int = MAX_ROWS_PER_CHUNK,
                  spatial_splits: bool = False):
    """Build the wide-row table for a triangle soup: one chunk when its
    table fits max_rows rows, else Morton-ordered chunks of one BVH each.
    Returns (WideRowBVH with nodes [C, R, 64], perm); callers permute their
    per-triangle arrays by `perm`."""
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    n = p0.shape[0]
    # rows ~ leaves + internals; leaves ~ n / max_leaf * fill slack
    est_rows = int(n / max_leaf * 1.5 * (1.0 + 1.0 / max(arity - 1, 1))) + 64
    if est_rows <= max_rows:
        bvh, perm = build_bvh(p0, e1, e2, arity=arity, max_leaf=max_leaf,
                              spatial_splits=spatial_splits)
        tab = _pack_one(bvh, p0[perm], e1[perm], e2[perm])
        # the estimate is a heuristic: a poorly filled build can exceed it
        if tab.shape[0] <= max_rows:
            return WideRowBVH(nodes=torch.from_numpy(tab[None]), arity=arity,
                              width=WIDTH, max_leaf=max_leaf,
                              max_depth=int(bvh.max_depth)), perm
        est_rows = tab.shape[0]

    depths = []

    def pack(sel, tri_offset):
        bvh, lperm = build_bvh(p0[sel], e1[sel], e2[sel], arity=arity,
                               max_leaf=max_leaf)
        gsel = sel[lperm]
        depths.append(int(bvh.max_depth))
        return (_pack_one(bvh, p0[gsel], e1[gsel], e2[gsel],
                          tri_offset=tri_offset), gsel, len(depths) - 1)

    chunks = morton_chunks(p0, e1, e2, est_rows, max_rows, max_leaf, pack)
    lo, hi = [], []
    for _, gsel, _ in chunks:
        q0, q1, q2 = p0[gsel], p0[gsel] + e1[gsel], p0[gsel] + e2[gsel]
        lo.append(np.minimum(np.minimum(q0, q1), q2).min(axis=0))
        hi.append(np.maximum(np.maximum(q0, q1), q2).max(axis=0))
    # the deepest chunk kept (chunks split and retried do not count)
    max_depth = max([1] + [depths[d] for _, _, d in chunks])
    nodes = stack_chunks([t for t, _, _ in chunks], WIDTH, pad_leaf=True)
    perm = np.concatenate([g for _, g, _ in chunks])
    return WideRowBVH(
        nodes=torch.from_numpy(nodes), arity=arity, width=WIDTH,
        max_leaf=max_leaf, max_depth=max_depth,
        chunk_lo=torch.from_numpy(np.stack(lo).astype(np.float32)),
        chunk_hi=torch.from_numpy(np.stack(hi).astype(np.float32))), perm
