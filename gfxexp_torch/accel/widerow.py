"""The wide-row BVH table (port of gfxexp_tpu/accel/pallas_widestack.py:85-304).

One [R, 64] float32 row per node, walked by accel/persistent.py:
- internal row (col 63 == 0): child k at cols [7k, 7k+7) = lo.xyz hi.xyz
  bitcast(child row), -1 for an empty slot;
- leaf row (col 63 == 1): triangle j at cols [12j, 12j+12) in Baldwin-Weber
  form n.xyz d0 U.xyz Ud V.xyz Vd (t = -(n.o + d0)/(n.d); P = o + t d;
  u = U.P + Ud; v = V.P + Vd); col 60 = bitcast(first | count << 24).

The JAX package splits large scenes into chunks to fit the TPU's VMEM; on
the GPU the table stays in HBM, so the port always builds one table.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gfxexp_torch.accel.bvh_build import BVH, build_bvh
from gfxexp_torch.core.tensors import TensorData

WIDTH = 64
COUNT_SHIFT = 24


@dataclass
class WideRowBVH(TensorData):
    nodes: torch.Tensor  # [R, 64] float32
    arity: int = 4
    width: int = WIDTH
    max_leaf: int = 4
    max_depth: int = 32

    @classmethod
    def _adapt(cls, fields):
        nodes = fields["nodes"]
        if nodes.dim() == 3:  # gfxexp_tpu keeps [chunks, R, 64]
            if nodes.shape[0] != 1:
                raise NotImplementedError(
                    "multi-chunk wide-row tables are not ported")
            fields["nodes"] = nodes[0].contiguous()
        return fields


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


def build_widerow(p0, e1, e2, arity: int = 4, max_leaf: int = 4,
                  spatial_splits: bool = False):
    """Build the wide-row table for a triangle soup. Returns (WideRowBVH,
    perm); callers permute their per-triangle arrays by `perm`."""
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    bvh, perm = build_bvh(p0, e1, e2, arity=arity, max_leaf=max_leaf,
                          spatial_splits=spatial_splits)
    tab = _pack_one(bvh, p0[perm], e1[perm], e2[perm])
    return WideRowBVH(nodes=torch.from_numpy(tab), arity=arity, width=WIDTH,
                      max_leaf=max_leaf, max_depth=int(bvh.max_depth)), perm
