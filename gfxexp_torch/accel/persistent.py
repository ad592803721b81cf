"""Single-level wide-row walks: the wrappers of the two CUDA kernels, their
plain versions, and the routing between them.

Replaces two TPU kernels:
- kernel 1, `_make_persistent_kernel` (gfxexp_tpu/accel/pallas_persistent.py:
  102, launched by `_run_persistent` :352), closest and any hit over a
  single-chunk table: csrc/widerow_traverse.cu;
- kernel 2, `_make_kernel` (gfxexp_tpu/accel/pallas_widestack.py:307,
  launched by `_run` :659), closest and any hit over the C chunk tables of
  a large scene, chunks nearest first: csrc/chunked_traverse.cu.

Kernel 1 walks each ray on its own, with a per-lane stack, over the row
table in HBM. A walk step is one dependent load of a 256-byte row followed
by a few dozen FLOPs, so the kernel is bound by the latency of those
dependent loads and by lanes that have nothing to do, not by arithmetic;
the design keeps every lane's loads independent of the others (no packets),
leans on the 50 MB L2, which holds the bench scene's table whole, and runs a
persistent grid whose lanes take a new ray as theirs ends (the fed grid's
counters are kept per stream here, `grid_counters`). The TPU kernel's
pools, row slots, `sched_k` batching and 128-lane packets existed to keep
VMEM busy and carry no meaning here.

Kernel 2 runs kernel 1's walk per chunk, one thread per ray: each step
scans the C chunk boxes and takes the chunk with the smallest (entry
distance, index) after the last one taken, among the boxes the ray enters
within [t_min, best_t]; the walk stops when that distance is >= best_t, and
best_t carries across chunks (the pick is the two-level walk's, shared
through csrc/widerow_walk.cuh). The TPU kernel's per-tile worklists, step
skip and double-buffered chunk DMA streamed the chunk tables through VMEM;
here the tables stay in HBM and every ray culls for itself. A table without
chunk boxes (one chunk, reached with the switch off) is walked whole.

Semantics shared by kernels and plain versions (and the TPU kernels): slab
tests against [t_min, best_t] with `_safe_inv` reciprocals, hit children
descended nearest first (a 4- or 8-wide sorting network on the entry
distance, the rest pushed far to near), Baldwin-Weber leaf tests
`den_ok & u>=0 & v>=0 & u+v<=1 & t>t_min & t<best_t`. Any hit stops at the
first accepted triangle. A ray with t_max < 0 does no work. Misses return
t = t_max, tri = -1, u = v = 0.

Routing, as in the JAX package (`_use_persistent`, pallas_widestack.py:798):
a single-chunk table with the switch on (widerow.set_persistent,
GFXEXP_PERSIST, the default) takes kernel 1; a chunked table, or any table
with the switch off, takes kernel 2.

On a CUDA tensor the wrappers launch a kernel or raise; the plain versions
run only for tensors on the CPU (and in tests and chip_smoke.py, which
compare the two).
"""

from __future__ import annotations

import ctypes

import torch

from gfxexp_torch.accel.traverse import HitInfo
from gfxexp_torch.accel.widerow import (
    COUNT_SHIFT,
    WIDTH,
    WideRowBVH,
    persist_on,
)
from gfxexp_torch.csrc.build import header_constant, launch
from gfxexp_torch.utils import trace

# the persistent grids' counters (kernels 1, 2 and the two-level walk in
# build order), one pair per (device, stream): zeroed once here, left at
# zero by every launch (its last warp resets them), so the kernels of one
# stream share them
_grid_counters: dict = {}

# rays per slice of the [n, C] box slab tests: bounds the temporaries
_SLAB_ELEMS = 1 << 24

# sorting networks (ascending), pairs applied in sequence; the kernel
# applies the same ones so ties order identically
_NET4 = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))
_NET8 = (
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6), (0, 4), (3, 7),
    (1, 5), (2, 6), (3, 6), (2, 4), (1, 2), (3, 5), (4, 5), (3, 4),
)


def stack_depth(bvh: WideRowBVH) -> int:
    """Ordered-descent stack bound: at most arity-1 pushes per level."""
    return int(bvh.max_depth + 2) * max(bvh.arity - 1, 1)


def _safe_inv(v):
    tiny = torch.where(v < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(v) < 1e-12, tiny, v)


def _prepare(bvh: WideRowBVH, o, d, t_min, t_max):
    if not isinstance(bvh, WideRowBVH):
        raise TypeError(f"expected WideRowBVH, got {type(bvh).__name__}")
    if bvh.arity not in (4, 8):
        raise ValueError(f"wide-row walk supports arity 4 or 8, got "
                         f"{bvh.arity}")
    if bvh.width != WIDTH or bvh.max_leaf * 12 + 4 > WIDTH:
        raise ValueError(f"bad row format width={bvh.width} "
                         f"max_leaf={bvh.max_leaf}")
    nodes = bvh.nodes
    if (nodes.dim() != 3 or nodes.shape[2] != WIDTH
            or nodes.dtype != torch.float32 or not nodes.is_contiguous()):
        raise ValueError(f"nodes must be a contiguous float32 "
                         f"[C, R, {WIDTH}] tensor, got "
                         f"{tuple(nodes.shape)} {nodes.dtype}")
    if nodes.device != o.device:
        raise ValueError(f"rays on {o.device}, table on {nodes.device}")
    # the chunks as one flat [C*R, 64] table (a view)
    return (nodes.reshape(-1, WIDTH), *prepare_rays(o, d, t_min, t_max))


def prepare_rays(o, d, t_min, t_max):
    """Checks shared by the walks' kernels and plain versions: o, d [N, 3]
    float32 on one device, made contiguous, and t_min, t_max as contiguous
    [N] float32 (a scalar is filled on the rays' device)."""
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o, d must be [N, 3], got {tuple(o.shape)} "
                         f"{tuple(d.shape)}")
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError("o, d must be float32")
    dev = o.device
    if d.device != dev:
        raise ValueError(f"rays on {dev}, directions on {d.device}")
    n = o.shape[0]

    def per_ray(x):
        if not isinstance(x, torch.Tensor):  # a fill: no host-device copy
            return torch.full((n,), float(x), device=dev)
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"t_min/t_max must be float32 on {dev}")
        return torch.broadcast_to(x, (n,)).contiguous()

    return o.contiguous(), d.contiguous(), per_ray(t_min), per_ray(t_max)


# ---------------------------------------------------------------------------
# plain PyTorch version: every active ray takes one step per iteration
# ---------------------------------------------------------------------------


def order_children(nears, metas, valids, net, stack, rows, sp):
    """The ordered descent of the rows being walked: sort the children
    (entry distances, child entries and valid masks, one [A] tensor per
    child) with the sorting network `net` (ties keep their order), push
    every valid child but the nearest onto stack[rows] far to near, and
    return (the nearest valid child or -1, the new stack pointers), [A]
    each."""
    for a, b in net:
        swap = nears[a] > nears[b]
        nears[a], nears[b] = (torch.where(swap, nears[b], nears[a]),
                              torch.where(swap, nears[a], nears[b]))
        metas[a], metas[b] = (torch.where(swap, metas[b], metas[a]),
                              torch.where(swap, metas[a], metas[b]))
        valids[a], valids[b] = (torch.where(swap, valids[b], valids[a]),
                                torch.where(swap, valids[a], valids[b]))
    for s in range(len(nears) - 1, 0, -1):
        push = torch.nonzero(valids[s]).squeeze(1)
        stack[rows[push], sp[push]] = metas[s][push]
        sp = sp + valids[s].to(torch.int64)
    return torch.where(valids[0], metas[0], -1), sp


def walk_plain(bvh: WideRowBVH, o, d, t_min, t_max, any_hit: bool,
               base=None, start=None, with_stats: bool = False,
               leaf_tests=None):
    """The kernel's walk written as tensor code: each iteration loads the
    current row of every active ray, tests its children or triangles, and
    descends, pops or retires the ray. Same arithmetic, same order.

    `start` [N] is the row each ray starts at and `base` [N] the row its
    child indices count from (a BLAS's first row in a flat table of several
    BLAS, as the two-level walk uses it); both default to 0. with_stats=True
    also returns the number of rows each ray visited [N] int64. Given
    `leaf_tests` ([N, max_leaf + 1] int64), the walk adds one to
    leaf_tests[i, c] for each leaf row ray i visits where it tests c
    triangles."""
    nodes, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    nodes_i = nodes.view(torch.int32)
    K, L = bvh.arity, bvh.max_leaf
    net = _NET4 if K == 4 else _NET8
    n, dev = o.shape[0], o.device
    n_rows = nodes.shape[0]
    inv = _safe_inv(d)
    best_t = t_max.clone()
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.full((n, stack_depth(bvh)), -1, dtype=torch.int64,
                       device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)

    rows_visited = torch.zeros(n, dtype=torch.int64, device=dev)

    act = torch.nonzero(t_max >= 0.0).squeeze(1)  # ray ids still walking
    # their current rows, and the rows those count from
    cur = (torch.zeros_like(act) if start is None
           else start.to(device=dev, dtype=torch.int64)[act])
    a_base = (torch.zeros_like(act) if base is None
              else base.to(device=dev, dtype=torch.int64)[act])
    while act.numel():
        if with_stats:
            rows_visited[act] += 1
        ridx = torch.clamp(a_base + cur, 0, n_rows - 1)
        row = nodes[ridx]
        row_i = nodes_i[ridx]
        ox, oy, oz = o[act].unbind(1)
        dx, dy, dz = d[act].unbind(1)
        ix, iy, iz = inv[act].unbind(1)
        tmin = t_min[act]
        bt = best_t[act]
        a_sp = sp[act]
        done = torch.zeros(act.shape, dtype=torch.bool, device=dev)
        leaf = row[:, WIDTH - 1] > 0.5

        # internal rows: slab-test the K children, push all but the nearest
        nears, metas, valids = [], [], []
        for k in range(K):
            c = row[:, 7 * k:7 * k + 6]
            tx0 = (c[:, 0] - ox) * ix
            tx1 = (c[:, 3] - ox) * ix
            ty0 = (c[:, 1] - oy) * iy
            ty1 = (c[:, 4] - oy) * iy
            tz0 = (c[:, 2] - oz) * iz
            tz1 = (c[:, 5] - oz) * iz
            near = torch.maximum(
                torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                torch.maximum(torch.minimum(tz0, tz1), tmin))
            far = torch.minimum(
                torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                torch.minimum(torch.maximum(tz0, tz1), bt))
            meta = row_i[:, 7 * k + 6].to(torch.int64)
            ok = ~leaf & (near <= far) & (meta >= 0)
            nears.append(torch.where(ok, near, torch.inf))
            metas.append(meta)
            valids.append(ok)
        nxt, a_sp = order_children(nears, metas, valids, net, stack, act,
                                   a_sp)

        # leaf rows: Baldwin-Weber tests of the row's triangles
        packed = row_i[:, WIDTH - 4]
        fst = packed & ((1 << COUNT_SHIFT) - 1)
        cnt = torch.where(leaf, packed >> COUNT_SHIFT, 0)
        bu, bv, btri = best_u[act], best_v[act], best_tri[act]
        n_tested = None if leaf_tests is None else torch.zeros_like(cnt)
        for j in range(L):
            if n_tested is not None:
                n_tested += ((j < cnt) & ~done).to(n_tested.dtype)
            r = row[:, 12 * j:12 * j + 12]
            den = r[:, 0] * dx + r[:, 1] * dy + r[:, 2] * dz
            num = r[:, 0] * ox + r[:, 1] * oy + r[:, 2] * oz + r[:, 3]
            den_ok = torch.abs(den) > 1e-12
            t = -num / torch.where(den_ok, den, 1.0)
            px = ox + t * dx
            py = oy + t * dy
            pz = oz + t * dz
            u = r[:, 4] * px + r[:, 5] * py + r[:, 6] * pz + r[:, 7]
            v = r[:, 8] * px + r[:, 9] * py + r[:, 10] * pz + r[:, 11]
            ok = ((j < cnt) & den_ok & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > tmin) & (t < bt))
            if any_hit:
                ok = ok & ~done  # the kernel returns on the first accept
                done = done | ok
            bt = torch.where(ok, t, bt)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
            btri = torch.where(ok, (fst + j).to(torch.int32), btri)
        best_t[act], best_u[act], best_v[act], best_tri[act] = bt, bu, bv, btri
        if leaf_tests is not None:
            leaf_tests.index_put_(
                (act[leaf], n_tested[leaf].to(torch.int64)),
                torch.ones((), dtype=leaf_tests.dtype, device=dev),
                accumulate=True)

        # descend, else pop, else retire
        pop = (nxt < 0) & (a_sp > 0) & ~done
        a_sp = a_sp - pop.to(torch.int64)
        popped = stack[act, torch.clamp(a_sp, 0, stack.shape[1] - 1)]
        nxt = torch.where(pop, popped, nxt)
        sp[act] = a_sp
        keep = nxt >= 0
        act, cur, a_base = act[keep], nxt[keep], a_base[keep]
    hit = HitInfo(t=best_t, tri=best_tri, u=best_u, v=best_v,
                  hit=best_tri >= 0)
    return (hit, rows_visited) if with_stats else hit


# ---------------------------------------------------------------------------
# plain PyTorch version of the entry loop: chunks (kernel 2) and two-level
# entries (accel/instanced.py) picked one per live ray per iteration
# ---------------------------------------------------------------------------


def entry_slabs(lo, hi, o, inv, t_min, t_max):
    """Entry distance and hit mask of rays [n] against boxes [C]: the
    kernels' slab test, [n, C] each."""
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    mn = torch.minimum(t0, t1)
    mx = torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]),
                         torch.maximum(mn[..., 2], t_min[:, None]))
    far = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]),
                        torch.minimum(mx[..., 2], t_max[:, None]))
    return near, near <= far


def slab_rows(n_c: int) -> int:
    """Rays per slice of an [n, n_c] slab test."""
    return max(1, _SLAB_ELEMS // max(n_c, 1))


def _pick(lo, hi, o, inv, t_min, best_t, nearest, last_near, last_c, nxt_c):
    """The next entry of each ray, as the kernels pick it. Returns (entry,
    its distance, found) [n] each."""
    n_c = lo.shape[0]
    cidx = torch.arange(n_c, device=o.device)
    outs = []
    step = slab_rows(n_c)
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        near, cand = entry_slabs(lo, hi, o[sl], inv[sl], t_min[sl],
                                 best_t[sl])
        if nearest:
            ln = last_near[sl, None]
            cand = cand & ((near > ln)
                           | ((near == ln) & (cidx > last_c[sl, None])))
            masked = torch.where(cand, near, torch.inf)
            pick = torch.argmin(masked, dim=1)  # first index among ties
        else:
            cand = cand & (cidx >= nxt_c[sl, None])
            pick = torch.argmax(cand.to(torch.uint8), dim=1)  # first True
        pnear = torch.gather(near, 1, pick[:, None])[:, 0]
        outs.append((pick, pnear, cand.any(dim=1)))
    return tuple(torch.cat(x) for x in zip(*outs))


def walk_entries_plain(lo, hi, o, d, t_min, t_max, any_hit: bool,
                       nearest: bool, visit, with_stats: bool = False):
    """The kernels' entry loop as tensor code, over prepared rays (o, d
    [N, 3], t_min, t_max [N]) and boxes lo, hi [C, 3]. Each iteration picks
    the next entry of every live ray: nearest-first, the smallest (entry
    distance, index) after the last one taken among the boxes the ray
    enters within [t_min, best_t], ending the ray's walk when that distance
    is >= best_t; else build order, the next box the ray enters. Then
    `visit(rays, entries, best_t)` walks the picked entries of those rays
    (rays [n] indices, returning a HitInfo, and rows visited [n] when
    with_stats) and the hits are merged: best_t carries across entries, and
    any hit stops at the first accepted triangle. Returns (HitInfo, entry
    [N] int32), with_stats=True adds (rows visited [N], entries visited
    [N], and the visits in the order they were made: (ray, entry, rows
    walked) [V] int64 each, so each ray's visits are in its own order)."""
    n, dev = o.shape[0], o.device
    inv = _safe_inv(d)
    best_t = t_max.clone()
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_ent = torch.full((n,), -1, dtype=torch.int32, device=dev)
    last_near = torch.full((n,), -torch.inf, device=dev)
    last_c = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nxt_c = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.zeros(n, dtype=torch.int64, device=dev)
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    seq = ([], [], [])

    live = torch.nonzero(t_max >= 0.0).squeeze(1)
    if lo.shape[0] == 0:  # no boxes: no ray visits anything
        live = live[:0]
    while live.numel():
        pick, pnear, found = _pick(lo, hi, o[live], inv[live], t_min[live],
                                   best_t[live], nearest, last_near[live],
                                   last_c[live], nxt_c[live])
        go = found & (pnear < best_t[live]) if nearest else found
        live, pick, pnear = live[go], pick[go], pnear[go]
        if not live.numel():
            break
        out = visit(live, pick, best_t[live])
        h = out[0] if with_stats else out
        if with_stats:
            rows[live] += out[1]
            visits[live] += 1
            for log, x in zip(seq, (live, pick, out[1])):
                log.append(x.to(torch.int64))
        took = h.hit
        idx = live[took]
        best_t[idx] = h.t[took]
        best_u[idx] = h.u[took]
        best_v[idx] = h.v[took]
        best_tri[idx] = h.tri[took]
        best_ent[idx] = pick[took].to(torch.int32)
        if any_hit:  # the kernels return on the first accepted triangle
            live, pick, pnear = live[~took], pick[~took], pnear[~took]
        last_near[live] = pnear
        last_c[live] = pick
        nxt_c[live] = pick + 1
    hit = HitInfo(t=best_t, tri=best_tri, u=best_u, v=best_v,
                  hit=best_tri >= 0)
    if with_stats:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return hit, best_ent, rows, visits, tuple(
            torch.cat(log) if log else empty for log in seq)
    return hit, best_ent


def _chunk_boxes(bvh, dev):
    """The chunk boxes [C, 3] each, checked; None for a table walked whole
    (one chunk without boxes)."""
    if bvh.chunk_lo is None or bvh.chunk_hi is None:
        if bvh.num_chunks != 1:
            raise ValueError(f"a table of {bvh.num_chunks} chunks needs its "
                             "chunk boxes (chunk_lo, chunk_hi)")
        return None
    shape = (bvh.num_chunks, 3)
    for x in (bvh.chunk_lo, bvh.chunk_hi):
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(
                f"chunk boxes must be contiguous float32 {shape} tensors on "
                f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return bvh.chunk_lo, bvh.chunk_hi


def walk_chunked_plain(bvh: WideRowBVH, o, d, t_min, t_max, any_hit: bool,
                       with_stats: bool = False):
    """Kernel 2's walk as tensor code: walk_plain over each ray's chunks in
    its nearest-first order (walk_entries_plain), chunk c from row c * R of
    the flat table, best_t carried across chunks; a table without chunk
    boxes is walked whole. with_stats=True returns (HitInfo, rows visited
    [N], chunks visited [N], leaf tests [N, max_leaf + 1]: the leaf rows
    each ray visited by the number of triangles it tested there)."""
    _, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    flat = bvh.flat()
    boxes = _chunk_boxes(bvh, o.device)
    tests = (torch.zeros((o.shape[0], bvh.max_leaf + 1), dtype=torch.int64,
                         device=o.device) if with_stats else None)
    if boxes is None:
        out = walk_plain(flat, o, d, t_min, t_max, any_hit,
                         with_stats=with_stats, leaf_tests=tests)
        if with_stats:
            return out[0], out[1], (t_max >= 0.0).to(torch.int64), tests
        return out
    r = bvh.rows_per_chunk

    def visit(rays, chunks, best_t):
        here = None if tests is None else torch.zeros_like(tests[rays])
        out = walk_plain(flat, o[rays], d[rays], t_min[rays], best_t,
                         any_hit, base=chunks * r, with_stats=with_stats,
                         leaf_tests=here)
        if here is not None:
            tests[rays] += here
        return out

    out = walk_entries_plain(*boxes, o, d, t_min, t_max, any_hit, True,
                             visit, with_stats)
    return (out[0], out[2], out[3], tests) if with_stats else out[0]


def chunked_trips(rows, leaf_tests, arity: int):
    """Dependent round trips to memory per ray of kernel 2's walk, from a
    plain walk's counts on the same rays (walk_chunked_plain(...,
    with_stats=True): rows visited [N], leaf tests [N, max_leaf + 1]).
    Returns (parent, new), [N] int64 each:
    - parent: an internal row loads its tail, then its children (two
      trips); a leaf row loads its tail, then one triangle at a time (one
      trip and one a triangle tested);
    - new (csrc/widerow_walk.cuh `walk` with kBatch): a row's tail and its
      first 7 * arity / 4 float4 come in one batch (one trip a row); a leaf
      that tests a triangle past those float4 waits for one more batch."""
    n_tests = torch.arange(leaf_tests.shape[1], device=rows.device)
    leaves = leaf_tests.sum(1)
    tris = (leaf_tests * n_tests).sum(1)
    parent = 2 * (rows - leaves) + leaves + tris
    head_tris = (7 * arity // 4) // 3  # triangles wholly in the first batch
    new = rows + leaf_tests[:, head_tris + 1:].sum(1)
    return parent, new


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _outputs(n, dev):
    """Empty (t, u, v, tri, hit) tensors a walk kernel writes."""
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev))


# the rays and the results (_outputs), the last pointers of each walk's
# argument struct (csrc/*_traverse.cu)
_RAY_PTRS = ("o", "d", "tmin", "tmax", "t", "u", "v", "tri", "hit")


def _walk_fields(ints, ptrs) -> list:
    """The ctypes fields of a walk's argument struct: the ints, then the
    pointers, then _RAY_PTRS."""
    return ([(f, ctypes.c_int) for f in ints]
            + [(f, ctypes.c_void_p) for f in (*ptrs, *_RAY_PTRS)])


def _check_depth(depth: int, bound: str = "kMaxStack",
                 header: str = "widerow_walk.cuh") -> int:
    """`depth`, a table's stack bound, checked against the kernel's:
    `bound` of csrc/<header>."""
    limit = header_constant(bound, header)
    if depth > limit:
        raise ValueError(f"stack depth {depth} exceeds the kernel's bound "
                         f"{limit}")
    return depth


def _launch_walk(library: str, kernel: str, args_type, ints: dict,
                 tensors: dict, rays, counter: str) -> HitInfo:
    """build.launch of a walk kernel over the rays (o, d, t_min, t_max),
    unless there are none, counted as trace counter `counter`: its own
    fields (`ints`, `tensors`), then n and the addresses of _RAY_PTRS, the
    rays as prepare_rays checked them and the results _outputs makes.
    Returns the results."""
    o, d, t_min, t_max = rays
    n = o.shape[0]
    t, u, v, tri, hit = out = _outputs(n, o.device)
    if n:
        addresses = {k: x.data_ptr() for k, x in
                     zip(_RAY_PTRS, (o, d, t_min, t_max, *out))}
        launch(library, kernel, args_type, {**ints, "n": n, **addresses},
               tensors, o.device)
        trace.count(counter)
    return HitInfo(t=t, tri=tri, u=u, v=v, hit=hit)


def grid_counters(dev: torch.device) -> torch.Tensor:
    """The two counters of a persistent grid on the current stream of
    device `dev`, zeroed at the first call; every launch leaves them at
    zero."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    counters = _grid_counters.get(key)
    if counters is None:
        counters = _grid_counters[key] = torch.zeros(2, dtype=torch.int32,
                                                     device=dev)
    return counters


class _WiderowArgs(ctypes.Structure):
    """csrc/widerow_traverse.cu's WiderowArgs."""

    _fields_ = _walk_fields(("any_hit", "arity", "n_rows", "max_leaf",
                             "stack_depth", "n"), ("nodes", "counters"))


class _ChunkedArgs(ctypes.Structure):
    """csrc/chunked_traverse.cu's ChunkedArgs."""

    _fields_ = _walk_fields(("any_hit", "arity", "n_chunks", "rows_per_chunk",
                             "max_leaf", "stack_depth", "n"),
                            ("nodes", "lo", "hi", "counters"))


def walk_cuda(bvh: WideRowBVH, o, d, t_min, t_max, any_hit: bool) -> HitInfo:
    """Launch kernel 1 (csrc/widerow_traverse.cu) on PyTorch's current
    stream over a single-chunk table. Raises if the kernel cannot be built
    or the launch is refused."""
    nodes, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"walk_cuda needs CUDA tensors, got {o.device}")
    if bvh.num_chunks != 1:
        raise ValueError(f"kernel 1 walks one table, got {bvh.num_chunks} "
                         "chunks (walk_chunked_cuda walks them)")
    depth = _check_depth(stack_depth(bvh))
    return _launch_walk(
        "widerow_traverse", "widerow_walk", _WiderowArgs, dict(
            any_hit=int(any_hit), arity=bvh.arity, n_rows=nodes.shape[0],
            max_leaf=bvh.max_leaf, stack_depth=depth), dict(
            nodes=(nodes, torch.float32, None),
            counters=(grid_counters(o.device), torch.int32, (2,))),
        (o, d, t_min, t_max),
        "walk.kernel1.any" if any_hit else "walk.kernel1.closest")


def walk_chunked_cuda(bvh: WideRowBVH, o, d, t_min, t_max,
                      any_hit: bool) -> HitInfo:
    """Launch kernel 2 (csrc/chunked_traverse.cu) on PyTorch's current
    stream: the chunks nearest first, or the one table of a table without
    chunk boxes. Raises if the kernel cannot be built or the launch is
    refused."""
    nodes, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"walk_chunked_cuda needs CUDA tensors, got "
                         f"{o.device}")
    lo, hi = _chunk_boxes(bvh, o.device) or (None, None)
    depth = _check_depth(stack_depth(bvh))
    return _launch_walk(
        "chunked_traverse", "chunked_walk", _ChunkedArgs, dict(
            any_hit=int(any_hit), arity=bvh.arity, n_chunks=bvh.num_chunks,
            rows_per_chunk=bvh.rows_per_chunk, max_leaf=bvh.max_leaf,
            stack_depth=depth), dict(
            nodes=(nodes, torch.float32, None),
            lo=(lo, torch.float32, None), hi=(hi, torch.float32, None),
            counters=(grid_counters(o.device), torch.int32, (2,))),
        (o, d, t_min, t_max),
        "walk.chunked.any" if any_hit else "walk.chunked.closest")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def persistent_supported(bvh) -> bool:
    """Kernel 1 walks single-chunk wide-row tables."""
    return (isinstance(bvh, WideRowBVH) and bvh.num_chunks == 1
            and bvh.width == WIDTH)


def use_kernel1(bvh: WideRowBVH) -> bool:
    """Kernel 1 for a table it walks with the switch on, else kernel 2
    (pallas_widestack.py `_use_persistent`)."""
    return persist_on() and persistent_supported(bvh)


def walk_library(bvh: WideRowBVH) -> str:
    """The csrc library whose kernel _walk launches for `bvh` on the
    card."""
    return "widerow_traverse" if use_kernel1(bvh) else "chunked_traverse"


def _walk(bvh, o, d, t_min, t_max, any_hit):
    one = use_kernel1(bvh)
    if o.device.type == "cuda":
        walk = walk_cuda if one else walk_chunked_cuda
    elif o.device.type == "cpu":
        walk = walk_plain if one else walk_chunked_plain
    else:
        raise ValueError(f"no wide-row walk for device {o.device}")
    return walk(bvh, o, d, t_min, t_max, any_hit)


def intersect_closest_widerow(bvh: WideRowBVH, o, d, t_min=1e-4,
                              t_max=1e30) -> HitInfo:
    """Closest hit of rays o, d [N, 3] against the wide-row table."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=False)


def intersect_any_widerow(bvh: WideRowBVH, o, d, t_min=1e-4,
                          t_max=1e30) -> torch.Tensor:
    """Occlusion [N] bool: any triangle with t_min < t < t_max."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=True).hit
