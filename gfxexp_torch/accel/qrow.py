"""Quantized wide rows (port of gfxexp_tpu/accel/pallas_qrow.py): the QRowBVH
table and its host build, the plain walk, and the wrappers of the CUDA
kernel.

Replaces the TPU kernel `_make_kernel_q` (gfxexp_tpu/accel/pallas_qrow.py:
302, launched by `_run_q` :560), closest and any hit, reached through
compile_scene(traversal="qrow").

Row format ([32] float32, 128 bytes, arity 8, up to 5 triangles a leaf):
- internal row: cols 0-2 parent lo, col 3 the scale exponents
  ex | ey << 8 | ez << 16 (scale 2^(e-127), decoded by moving the exponent
  byte into a float32: (e & 0xFF) << 23), cols 4-11 the child entries (-1
  empty; bit 30 = the child is a leaf), cols 12-27 the 8-bit child boxes
  (qlo.xyz | qhi.x << 24 and qhi.y | qhi.z << 8): lo = plo + q s,
  hi = plo + (qhi + 1) s (qhi is stored as ceil - 1);
- leaf row: cols 0-2 base, cols 3-5 scale (extent / 65535), cols 6-28 up
  to 5 triangles of 9 uint16 vertex coordinates (two a column), col 29
  first | count << 24 (global triangle ids).
Leafness rides bit 30 of the parent's entry and of the stack entries: no
tag column. Every node box is rebuilt from the dequantized leaf vertices,
so the boxes cover what is traced; compile_scene gives the scene the
dequantized triangles. Scenes over `max_rows` rows (26,000) are split into
Morton-ordered chunks as accel/widerow.py splits them.

The kernel (csrc/qrow_traverse.cu) runs one thread per ray, the chunks
nearest first as kernel 2 takes them; a step reads one 128-byte row as 8
float4, dequantizes and slab-tests 8 children (sorted with the 8-wide
network, pushed far to near) or dequantizes and Moller-Trumbore-tests the
leaf's triangles (`det_ok = |det| > 1e-12`, `t > t_min & t < best_t`). Any
hit stops at the first accepted triangle. A ray does no work when t_max < 0
(closest hit) or t_max <= 0 (any hit, the TPU kernel's rule).

On a CUDA tensor the wrappers launch the kernel or raise; the plain version
runs only for tensors on the CPU (and in tests and chip_smoke.py, which
compare the two).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gfxexp_torch.accel.bvh_build import BVH, build_bvh
from gfxexp_torch.accel.persistent import (
    _NET8,
    _check_depth,
    _chunk_boxes,
    _launch_walk,
    _safe_inv,
    _walk_fields,
    order_children,
    prepare_rays,
    walk_entries_plain,
)
from gfxexp_torch.accel.traverse import HitInfo
from gfxexp_torch.accel.widerow import morton_chunks, stack_chunks
from gfxexp_torch.core.tensors import TensorData

WIDTH = 32
ARITY = 8
MAX_LEAF = 5
COUNT_SHIFT = 24
LEAF_BIT = 1 << 30
MAX_ROWS_PER_CHUNK = 26000

@dataclass
class QRowBVH(TensorData):
    nodes: torch.Tensor  # [C, R, 32] float32 chunk tables
    max_depth: int = 32
    # per-chunk world AABBs of the dequantized triangles; None on
    # single-chunk tables
    chunk_lo: Optional[torch.Tensor] = None  # [C, 3]
    chunk_hi: Optional[torch.Tensor] = None

    @property
    def num_chunks(self) -> int:
        return self.nodes.shape[0]

    @property
    def rows_per_chunk(self) -> int:
        return self.nodes.shape[1]


def stack_depth(bvh: QRowBVH) -> int:
    """Ordered-descent stack bound: at most 7 pushes per level."""
    return int(bvh.max_depth + 2) * (ARITY - 1)


# ---------------------------------------------------------------------------
# host build (numpy, float64 as in the JAX package: identical tables)
# ---------------------------------------------------------------------------


def _pack_one_q(bvh: BVH, p0, e1, e2, tri_offset: int = 0):
    """Flatten one arity-8 BVH and its leaf-order triangles into a quantized
    [r, 32] row table. Returns (table, dequantized (p0, e1, e2)): the
    triangles the kernel intersects."""
    child_min = np.asarray(bvh.child_min, np.float64).copy()
    child_max = np.asarray(bvh.child_max, np.float64).copy()
    child_idx = np.asarray(bvh.child_idx, np.int64)
    child_count = np.asarray(bvh.child_count, np.int64)
    n_int, arity = child_idx.shape
    if arity != ARITY or bvh.max_leaf > MAX_LEAF:
        raise ValueError(f"quantized rows hold arity {ARITY} and max_leaf <= "
                         f"{MAX_LEAF}, got {arity}, {bvh.max_leaf}")
    n_tris = p0.shape[0]
    v0 = np.asarray(p0, np.float64)
    v1 = v0 + np.asarray(e1, np.float64)
    v2 = v0 + np.asarray(e2, np.float64)

    is_leaf = child_count > 0
    leaf_id = np.cumsum(is_leaf.ravel()).reshape(is_leaf.shape) - 1
    n_leaf = int(is_leaf.sum())
    leaf_first = child_idx[is_leaf]
    leaf_count = child_count[is_leaf]
    top = int(leaf_first.max(initial=0)) + tri_offset
    if top >= (1 << COUNT_SHIFT):
        raise ValueError(f"triangle id {top} exceeds the 24-bit leaf packing")

    # leaf rows: vertices quantized to 16 bits against the leaf's box; slot
    # j of a leaf holds triangle min(first + j, n - 1)
    ti = np.minimum(leaf_first[:, None] + np.arange(MAX_LEAF)[None, :],
                    n_tris - 1)  # [L, 5]
    slot_live = np.arange(MAX_LEAF)[None, :] < leaf_count[:, None]
    verts = np.stack([v0[ti], v1[ti], v2[ti]], axis=2)  # [L, 5, 3, 3]
    live_verts = np.where(slot_live[:, :, None, None], verts, np.nan)
    base = np.nanmin(live_verts.reshape(n_leaf, -1, 3), axis=1)  # [L, 3]
    top_v = np.nanmax(live_verts.reshape(n_leaf, -1, 3), axis=1)
    base = np.where(np.isfinite(base), base, 0.0)
    top_v = np.where(np.isfinite(top_v), top_v, 0.0)
    scale = np.maximum(top_v - base, 1e-12) / 65535.0  # [L, 3]
    q = np.clip(np.rint((verts - base[:, None, None, :])
                        / scale[:, None, None, :]), 0, 65535
                ).astype(np.uint64)  # [L, 5, 3, 3]
    deq = base[:, None, None, :] + q.astype(np.float64) \
        * scale[:, None, None, :]

    # the dequantized soup in leaf order (what the kernel intersects)
    dq0 = v0.copy()
    dq1 = v1.copy()
    dq2 = v2.copy()
    li, si = np.nonzero(slot_live)
    dq0[ti[li, si]] = deq[li, si, 0]
    dq1[ti[li, si]] = deq[li, si, 1]
    dq2[ti[li, si]] = deq[li, si, 2]

    # leaf boxes from the dequantized vertices
    lv = np.where(slot_live[:, :, None, None],
                  np.stack([dq0[ti], dq1[ti], dq2[ti]], 2), np.nan)
    leaf_lo = np.nanmin(lv.reshape(n_leaf, -1, 3), axis=1)
    leaf_hi = np.nanmax(lv.reshape(n_leaf, -1, 3), axis=1)
    leaf_lo = np.where(np.isfinite(leaf_lo), leaf_lo, 0.0)
    leaf_hi = np.where(np.isfinite(leaf_hi), leaf_hi, 0.0)

    # bottom-up box fix-up over the wide tree, one level of nodes a pass:
    # every box covers the dequantized leaves below it
    node_lo = np.zeros((n_int, 3))
    node_hi = np.zeros((n_int, 3))
    is_int_child = child_count == 0  # [N, K]
    empty_child = child_count < 0
    lid = np.where(is_leaf, leaf_id, 0)
    child_min = np.where(is_leaf[:, :, None], leaf_lo[lid], child_min)
    child_max = np.where(is_leaf[:, :, None], leaf_hi[lid], child_max)
    resolved = np.zeros(n_int, bool)
    cidx = np.where(is_int_child, child_idx, 0)
    for _ in range(n_int + 1):
        ready = ~resolved & np.all(
            np.where(is_int_child, resolved[cidx], True), axis=1)
        if not ready.any():
            break
        sub_lo = node_lo[cidx]  # [N, K, 3]
        sub_hi = node_hi[cidx]
        upd = ready[:, None] & is_int_child
        child_min = np.where(upd[:, :, None], sub_lo, child_min)
        child_max = np.where(upd[:, :, None], sub_hi, child_max)
        occ = ~empty_child[:, :, None]
        lo = np.where(occ, child_min, np.inf).min(axis=1)
        hi = np.where(occ, child_max, -np.inf).max(axis=1)
        node_lo[ready] = np.where(np.isfinite(lo[ready]), lo[ready], 0.0)
        node_hi[ready] = np.where(np.isfinite(hi[ready]), hi[ready], 0.0)
        resolved |= ready
    if not (resolved.all() or n_int == 0):
        raise RuntimeError("box fix-up did not converge")

    # internal rows: 8-bit child boxes against the parent's lo
    tab = np.zeros((n_int + n_leaf, WIDTH), np.float32)
    valid = child_count >= 0
    plo = np.where(valid[:, :, None], child_min, np.inf).min(axis=1)
    plo = np.where(np.isfinite(plo), plo, 0.0)  # [N, 3]
    phi = np.where(valid[:, :, None], child_max, -np.inf).max(axis=1)
    phi = np.where(np.isfinite(phi), phi, 0.0)
    extent = np.maximum(phi - plo, 0.0)
    # exponent-only scale: the smallest power of two with extent / s <= 255
    e = np.where(extent > 0,
                 np.ceil(np.log2(np.maximum(extent, 1e-300) / 255.0)),
                 -126.0).astype(np.int64) + 127
    e = np.clip(e, 1, 254)  # [N, 3]
    s = np.exp2(e - 127).astype(np.float64)
    rel_lo = np.maximum(child_min - plo[:, None, :], 0.0) / s[:, None, :]
    rel_hi = np.maximum(child_max - plo[:, None, :], 0.0) / s[:, None, :]
    qlo = np.clip(np.floor(rel_lo), 0, 255).astype(np.uint64)
    qhi = np.clip(np.ceil(rel_hi) - 1, 0, 255).astype(np.uint64)

    meta = np.where(
        is_leaf, (n_int + leaf_id) | LEAF_BIT,
        np.where(child_count == 0, child_idx, -1)).astype(np.int64)

    tab[:n_int, 0:3] = plo.astype(np.float32)
    tab[:n_int, 3] = (e[:, 0] | (e[:, 1] << 8) | (e[:, 2] << 16)) \
        .astype(np.uint32).view(np.float32)
    for k in range(arity):
        tab[:n_int, 4 + k] = meta[:, k].astype(np.int32).view(np.float32)
        c0 = (qlo[:, k, 0] | (qlo[:, k, 1] << 8) | (qlo[:, k, 2] << 16)
              | (qhi[:, k, 0] << 24))
        c1 = qhi[:, k, 1] | (qhi[:, k, 2] << 8)
        tab[:n_int, 12 + 2 * k] = c0.astype(np.uint32).view(np.float32)
        tab[:n_int, 13 + 2 * k] = c1.astype(np.uint32).view(np.float32)

    # leaf rows
    lrow = np.zeros((n_leaf, WIDTH), np.float32)
    lrow[:, 0:3] = base.astype(np.float32)
    lrow[:, 3:6] = scale.astype(np.float32)
    shorts = q.reshape(n_leaf, MAX_LEAF * 9)  # [L, 45] uint64
    lo16 = shorts[:, 0::2]
    hi16 = np.zeros_like(lo16)
    hi16[:, : shorts[:, 1::2].shape[1]] = shorts[:, 1::2]
    packed = (lo16 | (hi16 << 16)).astype(np.uint32)  # [L, 23]
    lrow[:, 6:6 + packed.shape[1]] = packed.view(np.float32)
    lrow[:, 29] = ((leaf_first + tri_offset)
                   | (leaf_count << COUNT_SHIFT)) \
        .astype(np.uint32).view(np.float32)
    tab[n_int:] = lrow
    return tab, (dq0.astype(np.float32),
                 (dq1 - dq0).astype(np.float32),
                 (dq2 - dq0).astype(np.float32))


def build_qrow(p0, e1, e2, max_rows: int = MAX_ROWS_PER_CHUNK,
               spatial_splits: bool = False):
    """Build the quantized row structure: one chunk when its table fits
    max_rows rows, else Morton-ordered chunks. Returns (QRowBVH on the CPU,
    perm, dequantized (p0, e1, e2) in permuted order)."""
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    n = p0.shape[0]
    est_rows = int(n / MAX_LEAF * 1.5 * (1.0 + 1.0 / (ARITY - 1))) + 64
    if est_rows <= max_rows:
        bvh, perm = build_bvh(p0, e1, e2, arity=ARITY, max_leaf=MAX_LEAF,
                              spatial_splits=spatial_splits)
        tab, dq = _pack_one_q(bvh, p0[perm], e1[perm], e2[perm])
        if tab.shape[0] <= max_rows:
            return QRowBVH(nodes=torch.from_numpy(tab[None]),
                           max_depth=int(bvh.max_depth)), perm, dq
        est_rows = tab.shape[0]

    depths = []

    def pack(sel, tri_offset):
        bvh, lperm = build_bvh(p0[sel], e1[sel], e2[sel], arity=ARITY,
                               max_leaf=MAX_LEAF,
                               spatial_splits=spatial_splits)
        gsel = sel[lperm]
        tab, dq = _pack_one_q(bvh, p0[gsel], e1[gsel], e2[gsel],
                              tri_offset=tri_offset)
        depths.append(int(bvh.max_depth))
        return tab, gsel, (dq, len(depths) - 1)

    chunks = morton_chunks(p0, e1, e2, est_rows, max_rows, MAX_LEAF, pack)
    lo, hi = [], []
    for _, _, (dq, _) in chunks:
        q0, q1, q2 = dq[0], dq[0] + dq[1], dq[0] + dq[2]
        lo.append(np.minimum(np.minimum(q0, q1), q2).min(axis=0))
        hi.append(np.maximum(np.maximum(q0, q1), q2).max(axis=0))
    max_depth = max([1] + [depths[k] for _, _, (_, k) in chunks])
    nodes = stack_chunks([t for t, _, _ in chunks], WIDTH, pad_leaf=False)
    perm = np.concatenate([g for _, g, _ in chunks])
    dq = tuple(np.concatenate([x[2][0][i] for x in chunks])
               for i in range(3))
    return QRowBVH(
        nodes=torch.from_numpy(nodes), max_depth=max_depth,
        chunk_lo=torch.from_numpy(np.stack(lo).astype(np.float32)),
        chunk_hi=torch.from_numpy(np.stack(hi).astype(np.float32))), perm, dq


# ---------------------------------------------------------------------------
# plain PyTorch version: every active ray takes one step per iteration
# ---------------------------------------------------------------------------


def _prepare(bvh: QRowBVH, o, d, t_min, t_max):
    if not isinstance(bvh, QRowBVH):
        raise TypeError(f"expected QRowBVH, got {type(bvh).__name__}")
    nodes = bvh.nodes
    if (nodes.dim() != 3 or nodes.shape[2] != WIDTH
            or nodes.dtype != torch.float32 or not nodes.is_contiguous()):
        raise ValueError(f"nodes must be a contiguous float32 "
                         f"[C, R, {WIDTH}] tensor, got "
                         f"{tuple(nodes.shape)} {nodes.dtype}")
    if nodes.device != o.device:
        raise ValueError(f"rays on {o.device}, table on {nodes.device}")
    return (nodes.reshape(-1, WIDTH), *prepare_rays(o, d, t_min, t_max))


def _live(t_max, any_hit: bool):
    """The rays that walk: t_max >= 0, and t_max > 0 under any hit."""
    return t_max > 0.0 if any_hit else t_max >= 0.0


def _walk_one(nodes, depth: int, o, d, t_min, t_max, any_hit: bool,
              base=None, with_stats: bool = False):
    """The kernel's walk of one table from its root row: `nodes` is the
    flat [C*R, 32] table, `base` [N] the row each ray's table starts at
    (chunk c * R; default 0). Same arithmetic in the same order as the
    kernel."""
    nodes_i = nodes.view(torch.int32)
    n, dev = o.shape[0], o.device
    n_rows = nodes.shape[0]
    inv = _safe_inv(d)
    best_t = t_max.clone()
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.full((n, depth), -1, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    rows_visited = torch.zeros(n, dtype=torch.int64, device=dev)

    act = torch.nonzero(_live(t_max, any_hit)).squeeze(1)
    cur = torch.zeros_like(act)  # the root, an internal row
    a_base = (torch.zeros_like(act) if base is None
              else base.to(device=dev, dtype=torch.int64)[act])
    while act.numel():
        if with_stats:
            rows_visited[act] += 1
        leaf = (cur & LEAF_BIT) != 0
        ridx = torch.clamp(a_base + (cur & (LEAF_BIT - 1)), 0, n_rows - 1)
        row = nodes[ridx]
        row_i = nodes_i[ridx]
        ox, oy, oz = o[act].unbind(1)
        dx, dy, dz = d[act].unbind(1)
        ix, iy, iz = inv[act].unbind(1)
        tmin = t_min[act]
        bt = best_t[act]
        a_sp = sp[act]
        done = torch.zeros(act.shape, dtype=torch.bool, device=dev)

        # internal rows: dequantize and slab-test the 8 children
        plx, ply, plz = row[:, 0], row[:, 1], row[:, 2]
        sc = row_i[:, 3]
        sx = ((sc & 0xFF) << 23).view(torch.float32)
        sy = (((sc >> 8) & 0xFF) << 23).view(torch.float32)
        sz = (((sc >> 16) & 0xFF) << 23).view(torch.float32)
        nears, metas, valids = [], [], []
        for k in range(ARITY):
            meta = row_i[:, 4 + k].to(torch.int64)
            c0 = row_i[:, 12 + 2 * k]
            c1 = row_i[:, 13 + 2 * k]
            lox = plx + (c0 & 0xFF).to(torch.float32) * sx
            loy = ply + ((c0 >> 8) & 0xFF).to(torch.float32) * sy
            loz = plz + ((c0 >> 16) & 0xFF).to(torch.float32) * sz
            hix = plx + (((c0 >> 24) & 0xFF) + 1).to(torch.float32) * sx
            hiy = ply + ((c1 & 0xFF) + 1).to(torch.float32) * sy
            hiz = plz + (((c1 >> 8) & 0xFF) + 1).to(torch.float32) * sz
            tx0 = (lox - ox) * ix
            tx1 = (hix - ox) * ix
            ty0 = (loy - oy) * iy
            ty1 = (hiy - oy) * iy
            tz0 = (loz - oz) * iz
            tz1 = (hiz - oz) * iz
            near = torch.maximum(
                torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                torch.maximum(torch.minimum(tz0, tz1), tmin))
            far = torch.minimum(
                torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                torch.minimum(torch.maximum(tz0, tz1), bt))
            ok = ~leaf & (near <= far) & (meta >= 0)
            nears.append(torch.where(ok, near, torch.inf))
            metas.append(meta)
            valids.append(ok)
        nxt, a_sp = order_children(nears, metas, valids, _NET8, stack, act,
                                   a_sp)

        # leaf rows: dequantize the triangles, Moller-Trumbore
        bx, by, bz = row[:, 0], row[:, 1], row[:, 2]
        qx, qy, qz = row[:, 3], row[:, 4], row[:, 5]
        packed = row_i[:, 29]
        fst = packed & ((1 << COUNT_SHIFT) - 1)
        cnt = torch.where(leaf, packed >> COUNT_SHIFT, 0)

        def short(i):
            w = row_i[:, 6 + (i >> 1)]
            return ((w >> (16 * (i & 1))) & 0xFFFF).to(torch.float32)

        bu, bv, btri = best_u[act], best_v[act], best_tri[act]
        for j in range(MAX_LEAF):
            o9 = 9 * j
            ax = bx + short(o9 + 0) * qx
            ay = by + short(o9 + 1) * qy
            az = bz + short(o9 + 2) * qz
            e1x = (bx + short(o9 + 3) * qx) - ax
            e1y = (by + short(o9 + 4) * qy) - ay
            e1z = (bz + short(o9 + 5) * qz) - az
            e2x = (bx + short(o9 + 6) * qx) - ax
            e2y = (by + short(o9 + 7) * qy) - ay
            e2z = (bz + short(o9 + 8) * qz) - az
            px = dy * e2z - dz * e2y  # d x e2
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            det_ok = torch.abs(det) > 1e-12
            inv_det = 1.0 / torch.where(det_ok, det, 1.0)
            tx = ox - ax
            ty = oy - ay
            tz = oz - az
            u = (tx * px + ty * py + tz * pz) * inv_det
            qvx = ty * e1z - tz * e1y  # (o - a) x e1
            qvy = tz * e1x - tx * e1z
            qvz = tx * e1y - ty * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            ok = ((j < cnt) & det_ok & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > tmin) & (t < bt))
            if any_hit:
                ok = ok & ~done  # the kernel returns on the first accept
                done = done | ok
            bt = torch.where(ok, t, bt)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
            btri = torch.where(ok, (fst + j).to(torch.int32), btri)
        best_t[act], best_u[act], best_v[act], best_tri[act] = bt, bu, bv, btri

        # descend, else pop, else retire
        pop = (nxt < 0) & (a_sp > 0) & ~done
        a_sp = a_sp - pop.to(torch.int64)
        popped = stack[act, torch.clamp(a_sp, 0, depth - 1)]
        nxt = torch.where(pop, popped, nxt)
        sp[act] = a_sp
        keep = nxt >= 0
        act, cur, a_base = act[keep], nxt[keep], a_base[keep]
    hit = HitInfo(t=best_t, tri=best_tri, u=best_u, v=best_v,
                  hit=best_tri >= 0)
    return (hit, rows_visited) if with_stats else hit


def walk_qrow_plain(bvh: QRowBVH, o, d, t_min, t_max, any_hit: bool,
                    with_stats: bool = False):
    """The kernel's walk as tensor code: a table without chunk boxes walked
    whole, else each ray's chunks nearest first (walk_entries_plain), chunk
    c from row c * R, best_t carried across chunks. with_stats=True returns
    (HitInfo, rows visited [N], chunks visited [N])."""
    nodes, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    depth = stack_depth(bvh)
    boxes = _chunk_boxes(bvh, o.device)
    if boxes is None:
        out = _walk_one(nodes, depth, o, d, t_min, t_max, any_hit,
                        with_stats=with_stats)
        if with_stats:
            return out[0], out[1], _live(t_max, any_hit).to(torch.int64)
        return out
    r = bvh.rows_per_chunk

    def visit(rays, chunks, best_t):
        return _walk_one(nodes, depth, o[rays], d[rays], t_min[rays], best_t,
                         any_hit, base=chunks * r, with_stats=with_stats)

    out = walk_entries_plain(*boxes, o, d, t_min, t_max, any_hit, True,
                             visit, with_stats)
    return (out[0], out[2], out[3]) if with_stats else out[0]


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


class _QrowArgs(ctypes.Structure):
    """csrc/qrow_traverse.cu's QrowArgs."""

    _fields_ = _walk_fields(("any_hit", "n_chunks", "rows_per_chunk",
                             "stack_depth", "n"), ("nodes", "lo", "hi"))


def walk_qrow_cuda(bvh: QRowBVH, o, d, t_min, t_max,
                   any_hit: bool) -> HitInfo:
    """Launch csrc/qrow_traverse.cu on PyTorch's current stream. Raises if
    the kernel cannot be built or the launch is refused."""
    nodes, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"walk_qrow_cuda needs CUDA tensors, got {o.device}")
    lo, hi = _chunk_boxes(bvh, o.device) or (None, None)
    depth = _check_depth(stack_depth(bvh), "kQMaxStack", "qrow_traverse.cu")
    return _launch_walk(
        "qrow_traverse", "qrow_walk", _QrowArgs, dict(
            any_hit=int(any_hit), n_chunks=bvh.num_chunks,
            rows_per_chunk=bvh.rows_per_chunk, stack_depth=depth), dict(
            nodes=(nodes, torch.float32, None),
            lo=(lo, torch.float32, None), hi=(hi, torch.float32, None)),
        (o, d, t_min, t_max),
        "walk.qrow.any" if any_hit else "walk.qrow.closest")


def _walk(bvh, o, d, t_min, t_max, any_hit):
    if o.device.type == "cuda":
        return walk_qrow_cuda(bvh, o, d, t_min, t_max, any_hit)
    if o.device.type == "cpu":
        return walk_qrow_plain(bvh, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no quantized-row walk for device {o.device}")


def intersect_closest_qrow(bvh: QRowBVH, tris, o, d, t_min=1e-4,
                           t_max=1e30) -> HitInfo:
    """Closest hit of rays o, d [N, 3] against the quantized rows (`tris`
    is unused: the rows hold their triangles)."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=False)


def intersect_any_qrow(bvh: QRowBVH, tris, o, d, t_min=1e-4,
                       t_max=1e30) -> torch.Tensor:
    """Occlusion [N] bool: any triangle with t_min < t < t_max."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=True).hit
