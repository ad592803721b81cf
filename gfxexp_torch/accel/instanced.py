"""Two-level (instanced) scenes: the InstancedAccel tables and their host
build (port of gfxexp_tpu/accel/pallas_widestack.py:853-1061), the query
routing (:785-815, :1250-1266, :1361-1454), and the wrappers of the CUDA
two-level walk and its plain version.

Replaces the TPU kernels of the two-level path, which compute one function:
`pallas_persistent_inst.py:378` `_run` (nearest-first entries, the default),
`pallas_widestack.py:1068` `_run_instanced` (the static grid, build order)
and `pallas_widestack.py:1189` `_run_instanced_pass` behind
`_run_tlas_wavefront` :1273 (rays sorted by their nearest entry). The kernel
(csrc/instanced_traverse.cu) walks each ray on its own: it visits the TLAS
entries whose world AABB the ray enters, transforms the ray into each
entry's object space and walks the entry's BLAS with kernel 1's walk
(csrc/widerow_walk.cuh); in build order on a persistent grid whose lanes
each visit their own candidates of a window of 32 entries, the window
skipped where no lane enters its union box (group_boxes, built once per
InstancedAccel). It is bound by the latency of the dependent row loads and
by the O(C) entry scan; see the source's note.

Routing, as in the JAX package: `tlas=True` or `acc.use_tlas` -> the rays
are argsorted by their nearest entry and walked nearest-first (the same
function; on the GPU its point is coherence); else the switch of the
single-level walks (`widerow.set_persistent`, GFXEXP_PERSIST) on (the
default) -> nearest-first; off -> build order. The
JAX package also leaves the persistent route when the tables exceed 24 MB
of VMEM; the GPU has no such limit, so the port does not.

On a CUDA tensor the wrappers launch the kernel or raise; the plain version
runs only for tensors on the CPU (and in tests and chip_smoke.py, which
compare the two).
"""

from __future__ import annotations

import ctypes
import heapq
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gfxexp_torch.accel.bvh_build import build_bvh
from gfxexp_torch.accel.persistent import (
    _check_depth,
    _launch_walk,
    _prepare,
    _safe_inv,
    _walk_fields,
    entry_slabs,
    grid_counters,
    slab_rows,
    stack_depth,
    walk_entries_plain,
    walk_plain,
)
from gfxexp_torch.accel.traverse import HitInfo
from gfxexp_torch.accel.widerow import (  # noqa: F401 (set_persistent)
    WIDTH,
    WideRowBVH,
    _pack_one,
    persist_on,
    set_persistent,
)
from gfxexp_torch.core.tensors import TensorData

# entries under one union box for the build-order kernel: its windows
# (kWindow in csrc/instanced_traverse.cu) and the runs inside them (kSub)
GROUP = 32
SUB_GROUP = 8
# The walk's routes, one per TPU kernel it replaces: "nearest" (nearest-
# first entries), "build" (entries in build order) and "sorted" (nearest-
# first over rays the tlas route has sorted by their nearest entry).
ROUTES = ("nearest", "build", "sorted")


@dataclass
class InstancedAccel(TensorData):
    """Per-BLAS wide-row tables shared by the instances, and one TLAS entry
    per instance (or per opened subtree, after rebraiding). Entries are
    sorted by BLAS id. Triangle ids baked into the leaves are global across
    the concatenated BLAS triangle arrays."""

    # [B, R, 64] per-BLAS row tables; rows past a BLAS's own count are
    # padding: leaf rows of count 0
    nodes: torch.Tensor
    blas_ids: torch.Tensor  # [C] int32 BLAS of each entry
    inv_transforms: torch.Tensor  # [C, 16] world -> object 3x4, row-major
    inst_of_chunk: torch.Tensor  # [C] int32 entry -> instance id
    arity: int = 4
    width: int = WIDTH
    max_leaf: int = 4
    max_depth: int = 32
    chunk_lo: Optional[torch.Tensor] = None  # [C, 3] entry world AABBs
    chunk_hi: Optional[torch.Tensor] = None
    blas_lo: Optional[torch.Tensor] = None  # [B, 3] BLAS object AABBs
    blas_hi: Optional[torch.Tensor] = None
    # rebraided builds only: the BLAS row each entry starts at and the
    # entry's object-space subtree AABB
    start_rows: Optional[torch.Tensor] = None  # [C] int32
    obj_lo: Optional[torch.Tensor] = None  # [C, 3]
    obj_hi: Optional[torch.Tensor] = None
    use_tlas: bool = False  # route every query through the ray-sorted pass

    def __post_init__(self):
        # the JAX package walks a width-32 table as 64-wide rows; refuse it
        if self.width != WIDTH:
            raise ValueError(f"InstancedAccel rows must be {WIDTH} wide, got "
                             f"{self.width}")

    @property
    def num_entries(self) -> int:
        return self.blas_ids.shape[0]

    # the JAX package's name: the TLAS entry count, which exceeds the
    # instance count after rebraiding
    num_instances = num_entries


# ---------------------------------------------------------------------------
# host build (numpy)
# ---------------------------------------------------------------------------


def _row_children(tab, row, arity):
    """Child (row, lo, hi) triples of an internal packed row."""
    out = []
    for k in range(arity):
        meta = int(tab[row, 7 * k + 6:7 * k + 7].view(np.int32)[0])
        if meta >= 0:
            out.append((meta, tab[row, 7 * k:7 * k + 3].copy(),
                        tab[row, 7 * k + 3:7 * k + 6].copy()))
    return out


def _rebraid_entries(entries, tabs, transforms, arity, budget):
    """Greedily open the largest-world-area entries into their BLAS children
    until the entry count reaches `budget`. entries are (blas, inst, row,
    obj_lo, obj_hi); transforms[inst] is the 3x4 object->world matrix (f64)."""

    def world_area(inst, lo, hi):
        m = transforms[inst]
        e = 0.5 * (hi - lo).astype(np.float64)
        we = np.abs(m[:, :3]) @ e
        return 2.0 * (we[0] * we[1] + we[1] * we[2] + we[2] * we[0])

    seq = 0
    heap = []
    for ent in entries:
        heapq.heappush(heap, (-world_area(ent[1], ent[3], ent[4]), seq, ent))
        seq += 1
    done = []
    total = len(heap)
    while heap and total < budget:
        _, _, (b, i, row, lo, hi) = heapq.heappop(heap)
        tab = tabs[b]
        if tab[row, WIDTH - 1] > 0.5:  # leaf row: cannot open further
            done.append((b, i, row, lo, hi))
            continue
        children = _row_children(tab, row, arity)
        if total - 1 + len(children) > budget or len(children) <= 1:
            done.append((b, i, row, lo, hi))
            continue
        total += len(children) - 1
        for crow, clo, chi in children:
            heapq.heappush(
                heap, (-world_area(i, clo, chi), seq, (b, i, crow, clo, chi)))
            seq += 1
    done.extend(ent for _, _, ent in heap)
    return done


def build_instanced(blas_geoms, instances, arity: int = 4, max_leaf: int = 4,
                    rebraid: float = 0.0):
    """blas_geoms: list of (p0, e1, e2) object-space triangle arrays.
    instances: list of (blas_id, 3x4 object->world transform).

    rebraid > 1 opens the largest instances' BLAS roots into subtree
    entries until there are about rebraid * n_instances entries.

    Returns (InstancedAccel on the CPU, perms) with perms[b] the triangle
    permutation applied to BLAS b's arrays."""
    tabs, perms = [], []
    blas_lo, blas_hi = [], []
    off = 0
    max_depth = 1
    for (p0, e1, e2) in blas_geoms:
        p0 = np.asarray(p0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        bvh, perm = build_bvh(p0, e1, e2, arity=arity, max_leaf=max_leaf)
        tabs.append(_pack_one(bvh, p0[perm], e1[perm], e2[perm],
                              tri_offset=off))
        perms.append(perm)
        off += p0.shape[0]
        max_depth = max(max_depth, int(bvh.max_depth))
        q1, q2 = p0 + e1, p0 + e2
        blas_lo.append(np.minimum(np.minimum(p0, q1), q2).min(axis=0))
        blas_hi.append(np.maximum(np.maximum(p0, q1), q2).max(axis=0))
    r_max = max(t.shape[0] for t in tabs)
    stacked = np.zeros((len(tabs), r_max, WIDTH), np.float32)
    for b, t in enumerate(tabs):
        stacked[b, :t.shape[0]] = t
        stacked[b, t.shape[0]:, WIDTH - 1] = 1.0  # padding: leaf, count 0

    mats = [np.asarray(t, np.float64).reshape(3, 4) for _, t in instances]
    entries = [(b, i, 0, np.asarray(blas_lo[b], np.float32),
                np.asarray(blas_hi[b], np.float32))
               for i, (b, _) in enumerate(instances)]
    rebraided = bool(rebraid and rebraid > 1 and len(instances) >= 1)
    if rebraided:
        entries = _rebraid_entries(entries, tabs, mats, arity,
                                   int(rebraid * len(instances)))
    order = np.argsort([e[0] for e in entries], kind="stable")
    entries = [entries[j] for j in order]

    n_c = len(entries)
    blas_ids = np.asarray([e[0] for e in entries], np.int32)
    inst_of_chunk = np.asarray([e[1] for e in entries], np.int32)
    start_rows = np.asarray([e[2] for e in entries], np.int32)
    obj_lo = np.stack([e[3] for e in entries]).astype(np.float32)
    obj_hi = np.stack([e[4] for e in entries]).astype(np.float32)
    inv = np.zeros((n_c, 16), np.float32)
    chunk_lo = np.zeros((n_c, 3), np.float32)
    chunk_hi = np.zeros((n_c, 3), np.float32)
    for j, (b, i, row, lo, hi) in enumerate(entries):
        m = mats[i]
        r_inv = np.linalg.inv(m[:, :3])
        t_inv = -r_inv @ m[:, 3]
        inv[j, 0:12] = np.concatenate(
            [np.concatenate([r_inv[k], [t_inv[k]]]) for k in range(3)])
        # world AABB of the entry's subtree (affine AABB transform)
        c = 0.5 * (lo + hi)
        e = 0.5 * (hi - lo)
        wc = m[:, :3] @ c + m[:, 3]
        we = np.abs(m[:, :3]) @ e
        chunk_lo[j] = wc - we
        chunk_hi[j] = wc + we
    t = torch.from_numpy
    return InstancedAccel(
        nodes=t(stacked), blas_ids=t(blas_ids), inv_transforms=t(inv),
        inst_of_chunk=t(inst_of_chunk), arity=arity, width=WIDTH,
        max_leaf=max_leaf, max_depth=max_depth,
        chunk_lo=t(chunk_lo), chunk_hi=t(chunk_hi),
        blas_lo=t(np.stack(blas_lo).astype(np.float32)),
        blas_hi=t(np.stack(blas_hi).astype(np.float32)),
        start_rows=t(start_rows) if rebraided else None,
        obj_lo=t(obj_lo) if rebraided else None,
        obj_hi=t(obj_hi) if rebraided else None,
    ), perms


# ---------------------------------------------------------------------------
# checks shared by the kernel and the plain version
# ---------------------------------------------------------------------------


def _flat(acc: InstancedAccel) -> WideRowBVH:
    """The BLAS tables as one flat [1, B*R, 64] table (a view)."""
    b, r, w = acc.nodes.shape
    return WideRowBVH(nodes=acc.nodes.reshape(1, b * r, w), arity=acc.arity,
                      width=acc.width, max_leaf=acc.max_leaf,
                      max_depth=acc.max_depth)


def _prepare_inst(acc: InstancedAccel, o, d, t_min, t_max, route):
    """Checked, contiguous inputs: (flat table, entries, o, d, t_min, t_max)
    with entries = (blas_ids, start_rows, inv_transforms, chunk_lo,
    chunk_hi) on the rays' device."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if not isinstance(acc, InstancedAccel):
        raise TypeError(f"expected InstancedAccel, got {type(acc).__name__}")
    if acc.nodes.dim() != 3:
        raise ValueError(f"nodes must be [B, R, {WIDTH}], got "
                         f"{tuple(acc.nodes.shape)}")
    if acc.chunk_lo is None or acc.chunk_hi is None:
        raise ValueError("the two-level walk needs the entries' world AABBs "
                         "(chunk_lo, chunk_hi)")
    flat = _flat(acc)
    nodes, o, d, t_min, t_max = _prepare(flat, o, d, t_min, t_max)
    dev = o.device
    n_c = acc.num_entries
    start = (torch.zeros(n_c, dtype=torch.int32, device=dev)
             if acc.start_rows is None else acc.start_rows)
    ents = (acc.blas_ids, start, acc.inv_transforms, acc.chunk_lo,
            acc.chunk_hi)
    shapes = ((n_c,), (n_c,), (n_c, 16), (n_c, 3), (n_c, 3))
    dtypes = (torch.int32, torch.int32, torch.float32, torch.float32,
              torch.float32)
    for x, shape, dtype in zip(ents, shapes, dtypes):
        if (tuple(x.shape) != shape or x.dtype != dtype or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(
                f"entry table must be a contiguous {dtype} {shape} tensor on "
                f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return flat, ents, o, d, t_min, t_max


def _instance_entry_dists(chunk_lo, chunk_hi, o, d, t_min, t_max):
    """Entry distance of every ray into every entry's world AABB: [N, C]
    float32, +inf where the slab test misses."""
    near, ok = entry_slabs(chunk_lo, chunk_hi, o, _safe_inv(d), t_min,
                           t_max)
    return torch.where(ok, near, torch.inf)


# ---------------------------------------------------------------------------
# plain PyTorch version: one entry per live ray per iteration
# ---------------------------------------------------------------------------


def walk_instanced_plain(acc: InstancedAccel, o, d, t_min, t_max,
                         any_hit: bool, route: str,
                         with_stats: bool = False):
    """The kernel's two-level walk as tensor code: each iteration picks the
    next entry of every live ray (build order for route "build", else
    nearest-first, as the kernel does), transforms the rays into the
    entries' object spaces and walks the BLAS with walk_plain, starting at
    the entries' start rows with t_max = best t, then merges the hits.
    Returns (HitInfo, entry [N] int32); with_stats=True adds (rows visited
    [N], entries visited [N], the visits in order: (ray, entry, rows walked)
    [V] each, walk_entries_plain)."""
    flat, ents, o, d, t_min, t_max = _prepare_inst(acc, o, d, t_min, t_max,
                                                   route)
    blas, start, tf, lo, hi = ents
    n_blas_rows = acc.nodes.shape[1]

    def visit(rays, pick, best_t):
        m = tf[pick]
        ox, oy, oz = o[rays].unbind(1)
        dx, dy, dz = d[rays].unbind(1)
        o2 = torch.stack([m[:, 4 * k] * ox + m[:, 4 * k + 1] * oy
                          + m[:, 4 * k + 2] * oz + m[:, 4 * k + 3]
                          for k in range(3)], 1)
        d2 = torch.stack([m[:, 4 * k] * dx + m[:, 4 * k + 1] * dy
                          + m[:, 4 * k + 2] * dz for k in range(3)], 1)
        return walk_plain(flat, o2, d2, t_min[rays], best_t, any_hit,
                          base=blas[pick].to(torch.int64) * n_blas_rows,
                          start=start[pick], with_stats=with_stats)

    return walk_entries_plain(lo, hi, o, d, t_min, t_max, any_hit,
                              route != "build", visit, with_stats)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def group_boxes(lo, hi, group: int = GROUP):
    """The union box of each run of `group` consecutive entry boxes lo, hi
    [C, 3]: (glo, ghi) [ceil(C / group), 3] each, exact (min and max of the
    corners)."""
    n_c = lo.shape[0]
    n_g = -(-n_c // group)
    pad = n_g * group - n_c
    glo = torch.cat([lo, lo[-1:].expand(pad, 3)]).reshape(n_g, group, 3)
    ghi = torch.cat([hi, hi[-1:].expand(pad, 3)]).reshape(n_g, group, 3)
    return glo.amin(1).contiguous(), ghi.amax(1).contiguous()


def _cached_groups(acc: InstancedAccel, lo, hi):
    """The union boxes of the entry boxes' windows of GROUP, then of their
    runs of SUB_GROUP (group_boxes), as the build-order kernel takes them:
    (glo, ghi) [ceil(C / GROUP) + ceil(C / SUB_GROUP), 3]. Built once per
    InstancedAccel and again only when lo or hi is replaced or written in
    place."""
    key = (lo.data_ptr(), lo._version, hi.data_ptr(), hi._version)
    cached = acc.__dict__.get("_group_boxes")
    if cached is None or cached[0] != key:
        levels = [group_boxes(lo, hi, g) for g in (GROUP, SUB_GROUP)]
        cached = acc.__dict__["_group_boxes"] = (
            key, *(torch.cat(x).contiguous() for x in zip(*levels)))
    return cached[1:]


class _InstancedArgs(ctypes.Structure):
    """csrc/instanced_traverse.cu's InstancedArgs."""

    _fields_ = _walk_fields(
        ("any_hit", "nearest", "arity", "n_rows", "n_blas_rows", "max_leaf",
         "stack_depth", "n_entries", "n"),
        ("nodes", "blas_ids", "start_rows", "inv_transforms", "entry_lo",
         "entry_hi", "entry", "counters", "group_lo", "group_hi"))


def walk_instanced_cuda(acc: InstancedAccel, o, d, t_min, t_max,
                        any_hit: bool, route: str):
    """Launch csrc/instanced_traverse.cu on PyTorch's current stream, in
    its build-order instantiation for route "build", else nearest-first.
    Returns (HitInfo, entry [N] int32). Raises if the kernel cannot be built
    or the launch is refused."""
    flat, ents, o, d, t_min, t_max = _prepare_inst(acc, o, d, t_min, t_max,
                                                   route)
    if o.device.type != "cuda":
        raise ValueError(f"walk_instanced_cuda needs CUDA tensors, got "
                         f"{o.device}")
    if acc.arity not in (4, 8):
        raise ValueError(f"two-level walk supports arity 4 or 8, got "
                         f"{acc.arity}")
    blas, start, tf, lo, hi = ents
    if tf.data_ptr() % 16:
        raise ValueError("inv_transforms must be 16-byte aligned")
    depth = _check_depth(stack_depth(acc))
    n, dev = o.shape[0], o.device
    entry = torch.empty(n, dtype=torch.int32, device=dev)
    nodes = flat.nodes  # [1, B*R, 64]
    glo = ghi = counters = None
    if route == "build" and n:
        glo, ghi = _cached_groups(acc, lo, hi)
        counters = grid_counters(dev)
    f32, i32 = torch.float32, torch.int32
    h = _launch_walk(
        "instanced_traverse", "instanced_walk", _InstancedArgs,
        dict(any_hit=int(any_hit), nearest=int(route != "build"),
             arity=acc.arity, n_rows=nodes.shape[1],
             n_blas_rows=acc.nodes.shape[1], max_leaf=acc.max_leaf,
             stack_depth=depth, n_entries=acc.num_entries),
        dict(nodes=(nodes, f32, None), blas_ids=(blas, i32, None),
             start_rows=(start, i32, None), inv_transforms=(tf, f32, None),
             entry_lo=(lo, f32, None), entry_hi=(hi, f32, None),
             entry=(entry, i32, (n,)), counters=(counters, i32, (2,)),
             group_lo=(glo, f32, None), group_hi=(ghi, f32, None)),
        (o, d, t_min, t_max),
        f"walk.instanced.{'any' if any_hit else 'closest'}_{route}")
    return h, entry


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _walker(o):
    if o.device.type == "cuda":
        return walk_instanced_cuda
    if o.device.type == "cpu":
        return walk_instanced_plain
    raise ValueError(f"no two-level walk for device {o.device}")


def _per_ray(x, n, dev):
    if not isinstance(x, torch.Tensor):
        return torch.full((n,), float(x), device=dev)
    return torch.broadcast_to(x, (n,))


def _nearest_entry(acc: InstancedAccel, o, d, t_min, t_max):
    """Each ray's nearest entry and whether it enters any, chunked over
    rays."""
    firsts, has = [], []
    step = slab_rows(acc.num_entries)
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        nears = _instance_entry_dists(acc.chunk_lo, acc.chunk_hi, o[sl],
                                      d[sl], t_min[sl], t_max[sl])
        mn, first = torch.min(nears, dim=1)
        firsts.append(first)
        has.append(torch.isfinite(mn))
    return torch.cat(firsts), torch.cat(has)


def walk_tlas(walk, acc: InstancedAccel, o, d, t_min, t_max, any_hit: bool):
    """The ray-sorted route: argsort the rays by their nearest entry (rays
    with none last), walk them nearest-first with `walk` (the kernel's
    wrapper or its plain version), undo the permutation."""
    n, dev = o.shape[0], o.device
    t_min = _per_ray(t_min, n, dev)
    t_max = _per_ray(t_max, n, dev)
    first, has = _nearest_entry(acc, o, d, t_min, t_max)
    perm = torch.argsort(torch.where(has, first, acc.num_entries),
                         stable=True)
    # rays with no candidate carry t_max = -1 (no work) and get theirs back
    tm = torch.where(has, t_max, -1.0)
    h, ent = walk(acc, o[perm].contiguous(), d[perm].contiguous(),
                  t_min[perm].contiguous(), tm[perm].contiguous(), any_hit,
                  route="sorted")

    def unperm(x):
        out = torch.empty_like(x)
        out[perm] = x
        return out

    hit = HitInfo(t=torch.where(has, unperm(h.t), t_max), tri=unperm(h.tri),
                  u=unperm(h.u), v=unperm(h.v), hit=unperm(h.hit))
    return hit, unperm(ent)


def persistent_inst_supported(acc) -> bool:
    """The nearest-first route walks every two-level table (its rows are
    64 wide by construction; the TPU kernel's bound on the tables' size is
    its on-chip memory, and the CUDA walk reads them from device
    memory)."""
    return isinstance(acc, InstancedAccel)


def _traverse(acc: InstancedAccel, o, d, t_min, t_max, any_hit: bool,
              tlas: bool):
    walk = _walker(o)
    tlas = tlas or acc.use_tlas
    if tlas and acc.chunk_lo is not None and acc.num_entries > 1:
        hit, ent = walk_tlas(walk, acc, o, d, t_min, t_max, any_hit)
    else:
        nearest = persist_on() and persistent_inst_supported(acc)
        hit, ent = walk(acc, o, d, t_min, t_max, any_hit,
                        route="nearest" if nearest else "build")
    inst = torch.where(ent >= 0,
                       acc.inst_of_chunk[torch.clamp(ent, min=0).long()],
                       -1).to(torch.int32)
    return hit, inst


def intersect_closest_instanced(acc: InstancedAccel, o, d, t_min=1e-4,
                                t_max=1e30, tlas: bool = False):
    """Closest hit through the two-level structure. Returns (HitInfo with
    global BLAS triangle ids, instance id per ray [N] int32, -1 on miss)."""
    return _traverse(acc, o, d, t_min, t_max, any_hit=False, tlas=tlas)


def intersect_any_instanced(acc: InstancedAccel, o, d, t_min=1e-4,
                            t_max=1e30, tlas: bool = False) -> torch.Tensor:
    """Occlusion [N] bool: any triangle of any instance with
    t_min < t < t_max."""
    hit, _ = _traverse(acc, o, d, t_min, t_max, any_hit=True, tlas=tlas)
    return hit.hit
