"""Skip-link ("threaded") BVH: the refittable structure of animated scenes
(port of gfxexp_tpu/accel/skiplink.py), its packed walk tables and the plain
PyTorch version of its walk.

Nodes are laid out in DFS preorder, each with a `skip` link to the next
preorder node outside its subtree, so a walk keeps one cursor and no stack:

    box hit and internal -> cur + 1   (descend)
    otherwise            -> skip      (past the subtree)

plus the leaf's triangle tests. The walk tables are packed once, never per
launch:
- nodes [M+1, 8] float32, 32 bytes a row: lo.xyz hi.xyz,
  bitcast(first | count << 24), bitcast(skip); row M is a sentinel (empty
  box, skip -> M). Packed when the structure is made (build, from_numpy)
  and by every refit;
- triangles [T+max_leaf, 12] float32, 48 bytes a row: p0 e1 e2, 3 floats of
  padding (Moller-Trumbore form, as the TPU kernels read them). Packed from
  the triangles the walk is given, once per triangle set: compile_scene and
  every refit pack it for the scene's triangles, and a walk given other
  triangles (a structure from from_numpy, or one moved to another device
  apart from its scene) packs it for those and keeps it on the structure.

`walk_skip_plain` is the plain version of csrc/skiplink_traverse.cu (and so
of the TPU kernels it replaces, gfxexp_tpu/accel/pallas_traverse.py and
pallas_rowcursor.py): the same arithmetic in the same order, so on the card
the two agree bit for bit.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gfxexp_torch.accel.persistent import _safe_inv, prepare_rays
from gfxexp_torch.accel.traverse import HitInfo
from gfxexp_torch.core.tensors import TensorData

COUNT_SHIFT = 24  # node column 6: first | count << 24
MAX_LEAF = 127  # the count field's bound


@dataclass
class SkipBVH(TensorData):
    """DFS-preorder nodes with skip links. count > 0: a leaf with triangles
    [first, first + count); count == 0: internal (its first child is the
    next node). `depth` and `n_levels` drive the bottom-up refit: the
    children of an internal node at depth d sit at depth d + 1 and form the
    sibling chain i+1, skip[i+1], skip[skip[i+1]], ... below skip[i].

    The node table and the refit's per-level node lists depend on the
    topology only and are made with the structure; the triangle table is
    packed for the triangles `tri_src` names (see `packed`)."""

    aabb_min: torch.Tensor  # [M, 3] float32
    aabb_max: torch.Tensor  # [M, 3]
    first: torch.Tensor  # [M] int32 (leaf triangle offset; 0 if internal)
    count: torch.Tensor  # [M] int32
    skip: torch.Tensor  # [M] int32 (M = past the end)
    depth: torch.Tensor  # [M] int32 (root children = 0)
    max_leaf: int = 4
    n_levels: int = 1
    arity: int = 4
    # the walk tables: nodes (pack_nodes) and the triangles tri_src names
    # (pack_triangles, weak references to their p0, e1, e2)
    node_pack: Optional[torch.Tensor] = None  # [M+1, 8] float32
    tri_pack: Optional[torch.Tensor] = None  # [T+max_leaf, 12] float32
    tri_src: Optional[tuple] = None
    # the refit's node lists: the leaves, and the internal nodes grouped by
    # depth (level_sizes[d] of them at depth d, shallowest first)
    leaf_ids: Optional[torch.Tensor] = None  # [L] int64
    level_ids: Optional[torch.Tensor] = None  # [M - L] int64
    level_sizes: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.node_pack is None:
            self.node_pack = pack_nodes(self)
        if self.leaf_ids is None:
            is_leaf = self.count > 0
            self.leaf_ids = torch.nonzero(is_leaf).squeeze(1)
            internal = torch.nonzero(~is_leaf).squeeze(1)
            depth = self.depth.to(torch.int64)[internal]
            self.level_ids = internal[torch.argsort(depth, stable=True)]
            self.level_sizes = tuple(torch.bincount(
                depth, minlength=self.n_levels).tolist())

    @property
    def num_nodes(self) -> int:
        return self.first.shape[0]


def build_skip_links(child_min, child_max, child_idx, child_count,
                     max_leaf: int = 4) -> SkipBVH:
    """Flatten a wide BVH (accel/bvh_build.py arrays) into preorder skip-link
    nodes on the CPU. An explicit stack replaces the reference's recursion;
    the output is the same, node for node."""
    child_min = np.asarray(child_min, np.float32)
    child_max = np.asarray(child_max, np.float32)
    cidx = np.asarray(child_idx).tolist()
    ccount = np.asarray(child_count).tolist()
    arity = len(cidx[0])

    src_node, src_slot, first, count, skip, depth = [], [], [], [], [], []
    # frames: [wide node, next slot, depth, emitted node to patch at the end]
    stack = [[0, 0, 0, -1]]
    while stack:
        frame = stack[-1]
        wnode, k, d, me = frame
        if k == arity:
            stack.pop()
            if me >= 0:
                skip[me] = len(skip)  # past my whole subtree
            continue
        frame[1] = k + 1
        ct = ccount[wnode][k]
        if ct < 0:
            continue  # empty slot
        src_node.append(wnode)
        src_slot.append(k)
        depth.append(d)
        if ct > 0:
            first.append(cidx[wnode][k])
            count.append(ct)
            skip.append(len(skip) + 1)  # leaf: the next emitted node
        else:
            first.append(0)
            count.append(0)
            skip.append(-1)
            stack.append([cidx[wnode][k], 0, d + 1, len(skip) - 1])

    if skip:
        amin = child_min[src_node, src_slot]
        amax = child_max[src_node, src_slot]
    else:  # degenerate single-leaf scene
        amin = amax = np.zeros((1, 3), np.float32)
        first, count, skip, depth = [0], [0], [1], [0]

    def i32(x):
        return torch.from_numpy(np.asarray(x, np.int32))

    return SkipBVH(
        aabb_min=torch.from_numpy(np.ascontiguousarray(amin)),
        aabb_max=torch.from_numpy(np.ascontiguousarray(amax)),
        first=i32(first), count=i32(count), skip=i32(skip), depth=i32(depth),
        max_leaf=int(max_leaf), n_levels=int(max(depth)) + 1,
        arity=int(arity))


def pack_nodes(bvh: SkipBVH) -> torch.Tensor:
    """The [M+1, 8] node table (see the module docstring)."""
    m = bvh.num_nodes
    dev = bvh.first.device
    if not 0 < bvh.max_leaf <= MAX_LEAF:
        raise ValueError(f"max_leaf must be in [1, {MAX_LEAF}], got "
                         f"{bvh.max_leaf}")
    if m and int(bvh.first.max()) >= (1 << COUNT_SHIFT):
        raise ValueError(f"triangle ids reach {int(bvh.first.max())}: the "
                         f"node packing holds fewer than 2**{COUNT_SHIFT}")
    nf = torch.zeros((m + 1, 8), dtype=torch.float32, device=dev)
    nf[:m, 0:3] = bvh.aabb_min
    nf[:m, 3:6] = bvh.aabb_max
    nf[m, 0:3] = 1.0  # sentinel: empty box, skip -> m
    nf[m, 3:6] = -1.0
    ni = nf.view(torch.int32)
    ni[:m, 6] = bvh.first | (bvh.count << COUNT_SHIFT)
    ni[:m, 7] = bvh.skip
    ni[m, 7] = m
    return nf


def pack_triangles(tris, max_leaf: int) -> torch.Tensor:
    """The [T+max_leaf, 12] triangle table: p0 e1 e2 and padding."""
    t = tris.p0.shape[0]
    if t + max_leaf >= (1 << COUNT_SHIFT):
        raise ValueError(f"{t} triangles: the node packing holds fewer than "
                         f"2**{COUNT_SHIFT}")
    tp = torch.zeros((t + max_leaf, 12), dtype=torch.float32,
                     device=tris.p0.device)
    tp[:t, 0:3] = tris.p0
    tp[:t, 3:6] = tris.e1
    tp[:t, 6:9] = tris.e2
    return tp


def _source(tris) -> tuple:
    return tuple(weakref.ref(x) for x in (tris.p0, tris.e1, tris.e2))


def packed_for(bvh: SkipBVH, tris) -> bool:
    """Whether the triangle table of `bvh` was packed from `tris`."""
    return bvh.tri_src is not None and all(
        r() is x for r, x in zip(bvh.tri_src, (tris.p0, tris.e1, tris.e2)))


def pack_tables(bvh: SkipBVH, tris) -> SkipBVH:
    """`bvh` with its triangle table packed for `tris` (the scene's
    world-space TriangleSoA in traversal order)."""
    return replace(bvh, tri_pack=pack_triangles(tris, bvh.max_leaf),
                   tri_src=_source(tris))


def packed(bvh: SkipBVH, tris) -> SkipBVH:
    """`bvh`, its triangle table packed from `tris`. The walk reads the
    triangles it is given: when the table was packed from others, it is
    packed anew from these, once, and kept on `bvh`."""
    if not isinstance(bvh, SkipBVH):
        raise TypeError(f"expected SkipBVH, got {type(bvh).__name__}")
    if tris is None:
        raise ValueError("the skip-link walk needs the triangles")
    if not packed_for(bvh, tris):
        bvh.tri_pack = pack_triangles(tris, bvh.max_leaf)
        bvh.tri_src = _source(tris)
    return bvh


class SkipStats(NamedTuple):
    """What a plain walk visited: per ray, the nodes, the triangle tests and
    the leaves where it tested a triangle; over the tables, the rows read at
    least once; and every (ray, node) visit, each ray's in preorder (a warp's
    shared cursor walks the union of its rays' nodes)."""

    nodes: torch.Tensor  # [N] int64
    tris: torch.Tensor  # [N] int64
    node_rows: torch.Tensor  # [M+1] bool
    tri_rows: torch.Tensor  # [T+max_leaf] bool
    leaves: torch.Tensor  # [N] int64
    visits: Optional[torch.Tensor] = None  # [V, 2] int64: ray, node


def walk_skip_plain(bvh: SkipBVH, tris, o, d, t_min, t_max, any_hit: bool,
                    with_stats: bool = False):
    """The skip-link walk as tensor code, one cursor per ray: each iteration
    loads the current node of every active ray, slab-tests it against
    [t_min, best_t], runs the leaf's Moller-Trumbore tests, and descends or
    skips. A ray with t_max < 0 does no work; any hit stops at the first
    accepted triangle. Misses return t = t_max, tri = -1, u = v = 0.

    with_stats=True returns (HitInfo, SkipStats): the nodes, triangles and
    leaves each ray visited, the table rows the walk read, and the visits
    themselves."""
    bvh = packed(bvh, tris)
    o, d, t_min, t_max = prepare_rays(o, d, t_min, t_max)
    nodes, tp = bvh.node_pack, bvh.tri_pack
    if nodes.device != o.device:
        raise ValueError(f"tables on {nodes.device}, rays on {o.device}")
    nodes_i = nodes.view(torch.int32)
    m, n, dev = bvh.num_nodes, o.shape[0], o.device
    inv = _safe_inv(d)
    best_t = t_max.clone()
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    nodes_seen = torch.zeros(n, dtype=torch.int64, device=dev)
    tris_seen = torch.zeros(n, dtype=torch.int64, device=dev)
    leaves_seen = torch.zeros(n, dtype=torch.int64, device=dev)
    node_rows = torch.zeros(nodes.shape[0], dtype=torch.bool, device=dev)
    tri_rows = torch.zeros(tp.shape[0], dtype=torch.bool, device=dev)

    visits = []
    act = torch.nonzero(t_max >= 0.0).squeeze(1)  # rays still walking
    cur = torch.zeros_like(act)  # and their cursors
    while act.numel():
        if with_stats:
            nodes_seen[act] += 1
            node_rows[cur] = True
            visits.append(torch.stack([act, cur], 1))
        row = nodes[cur]
        row_i = nodes_i[cur]
        ox, oy, oz = o[act].unbind(1)
        dx, dy, dz = d[act].unbind(1)
        ix, iy, iz = inv[act].unbind(1)
        tmin = t_min[act]
        bt = best_t[act]
        tx0 = (row[:, 0] - ox) * ix
        tx1 = (row[:, 3] - ox) * ix
        ty0 = (row[:, 1] - oy) * iy
        ty1 = (row[:, 4] - oy) * iy
        tz0 = (row[:, 2] - oz) * iz
        tz1 = (row[:, 5] - oz) * iz
        near = torch.maximum(
            torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
            torch.maximum(torch.minimum(tz0, tz1), tmin))
        far = torch.minimum(
            torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
            torch.minimum(torch.maximum(tz0, tz1), bt))
        box_hit = near <= far
        packed_fc = row_i[:, 6]
        fst = packed_fc & ((1 << COUNT_SHIFT) - 1)
        cnt = packed_fc >> COUNT_SHIFT
        leaf = cnt > 0
        if with_stats:  # a hit leaf tests its first triangle at least
            leaves_seen[act] += (box_hit & leaf).to(torch.int64)

        bu, bv, btri = best_u[act], best_v[act], best_tri[act]
        done = torch.zeros(act.shape, dtype=torch.bool, device=dev)
        for j in range(bvh.max_leaf):
            valid = box_hit & (j < cnt)
            if with_stats:  # the kernel reads the rows it tests
                tested = valid & ~done
                tris_seen[act] += tested.to(torch.int64)
                tri_rows[(fst + j)[tested].to(torch.int64)] = True
            r = tp[(fst + j).to(torch.int64)]
            p0x, p0y, p0z = r[:, 0], r[:, 1], r[:, 2]
            e1x, e1y, e1z = r[:, 3], r[:, 4], r[:, 5]
            e2x, e2y, e2z = r[:, 6], r[:, 7], r[:, 8]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            det_ok = torch.abs(det) > 1e-12
            inv_det = 1.0 / torch.where(det_ok, det, 1.0)
            tvx = ox - p0x
            tvy = oy - p0y
            tvz = oz - p0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            ok = (valid & det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t > tmin) & (t < bt))
            if any_hit:
                ok = ok & ~done  # the kernel stops at the first accept
                done = done | ok
            bt = torch.where(ok, t, bt)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
            btri = torch.where(ok, (fst + j).to(torch.int32), btri)
        best_t[act], best_u[act], best_v[act], best_tri[act] = bt, bu, bv, btri

        nxt = torch.where(box_hit & ~leaf, cur + 1,
                          row_i[:, 7].to(torch.int64))
        keep = (nxt < m) & ~done
        act, cur = act[keep], nxt[keep]
    hit = HitInfo(t=best_t, tri=best_tri, u=best_u, v=best_v,
                  hit=best_tri >= 0)
    if with_stats:
        seq = (torch.cat(visits) if visits else
               torch.zeros((0, 2), dtype=torch.int64, device=dev))
        return hit, SkipStats(nodes_seen, tris_seen, node_rows, tri_rows,
                              leaves_seen, seq)
    return hit


def skip_trips(stats: SkipStats, leaf_batch: bool = True):
    """Dependent round trips to memory per ray of the skip-link walk's
    per-ray scope, from a plain walk's stats on the same rays
    (walk_skip_plain(..., with_stats=True)). Returns (parent, new), [N]
    int64 each:
    - parent: one trip per node and one per triangle tested (each load
      waits for the last);
    - new (csrc/skiplink_traverse.cu): with `leaf_batch` (closest hit) a hit
      leaf's triangle rows come in one batch, one trip a leaf; without it
      (any hit) the parent's schedule."""
    parent = stats.nodes + stats.tris
    return parent, (stats.nodes + stats.leaves if leaf_batch else parent)
