"""Lane-group wide-row walk (port of gfxexp_tpu/accel/pallas_lanegroup.py):
closest hit over a single-chunk wide-row table with one cursor and one
stack shared by each group of 128 / G consecutive rays, G in {1, 2, 4}.

Replaces the TPU kernel `_make_kernel` (gfxexp_tpu/accel/pallas_lanegroup.py
:49, launched by `_run` :241), which only tests and `perf/` reach, in the
JAX package as here: no user path takes it.

The walk (csrc/lanegroup_traverse.cu, one thread per ray, 128-thread
blocks): a group visits one row at a time. At an internal row each lane
that takes part slab-tests the K children against its own [t_min, best_t]
(on the card the (ray, child) pairs of those lanes are spread over the
warp); a child is valid when a lane of the group hits it, and the valid
children are ordered by the group's smallest entry distance (the K-wide
sorting network), the nearest descended and the rest pushed far to near.
With G = 4 a group is a warp; with G = 2 or 1 it is 2 or 4 warps, which
vote through shared memory behind one barrier a step. Every stack entry
keeps the lanes whose own box test hit that child, and a lane takes part in
a row (votes, tests a leaf's Baldwin-Weber triangles, counts the row) only
where its test did, so its result is the closest hit the per-ray walk
finds; only ties in t may pick another triangle. Rays past the end of the
batch and rays with t_max < 0 take part as dead rays. with_stats counts,
per ray, the rows it took part in.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version runs only for tensors on the CPU (and in tests and chip_smoke.py,
which compare the two).
"""

from __future__ import annotations

import ctypes

import torch

from gfxexp_torch.accel.persistent import (
    _NET4,
    _NET8,
    _check_depth,
    _launch_walk,
    _prepare,
    _safe_inv,
    _walk_fields,
    stack_depth,
)
from gfxexp_torch.accel.traverse import HitInfo
from gfxexp_torch.accel.widerow import COUNT_SHIFT, WIDTH, WideRowBVH

LANES = 128  # rays of a block, split into G groups
GROUPS = (1, 2, 4)  # the kernel's group counts


def _check(bvh: WideRowBVH, groups: int):
    if bvh.num_chunks != 1:
        raise ValueError(f"the lane-group walk takes single-chunk tables, "
                         f"got {bvh.num_chunks} chunks")
    if groups < 1 or LANES % groups:
        raise ValueError(f"groups must divide {LANES}, got {groups}")


def walk_lanegroup_plain(bvh: WideRowBVH, o, d, t_min, t_max, groups: int,
                         with_stats: bool = False, with_steps: bool = False):
    """The kernel's walk as tensor code, every active group one row per
    iteration; the rays are cut into groups of 128 / groups consecutive
    lanes, the last padded with dead rays. Same arithmetic in the same
    order as the kernel. with_stats=True also returns the rows each ray
    took part in [N] int64; with_steps=True (with with_stats) then also
    the rows each group stepped through [ceil(N / 128) * groups] int64."""
    _check(bvh, groups)
    nodes, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    nodes_i = nodes.view(torch.int32)
    K, L = bvh.arity, bvh.max_leaf
    net = _NET4 if K == 4 else _NET8
    n, dev = o.shape[0], o.device
    lanes = LANES // groups
    n_pad = -(-n // LANES) * LANES
    ng = n_pad // lanes

    def lane_tensor(x, fill):
        out = torch.full((n_pad,) + x.shape[1:], fill, dtype=x.dtype,
                         device=dev)
        out[:n] = x
        return out.reshape((ng, lanes) + x.shape[1:])

    o_g = lane_tensor(o, 0.0)
    d_g = lane_tensor(d, 1.0)
    inv_g = _safe_inv(d_g)
    tmin_g = lane_tensor(t_min, 0.0)
    best_t = lane_tensor(t_max, -1.0)
    best_u = torch.zeros((ng, lanes), device=dev)
    best_v = torch.zeros((ng, lanes), device=dev)
    best_tri = torch.full((ng, lanes), -1, dtype=torch.int32, device=dev)
    rows = torch.zeros((ng, lanes), dtype=torch.int64, device=dev)
    depth = stack_depth(bvh)
    stack = torch.full((ng, depth), -1, dtype=torch.int64, device=dev)
    # per lane and stack entry: the lane's own box test hit that child
    own_stack = torch.zeros((ng, depth, lanes), dtype=torch.bool,
                            device=dev)
    sp = torch.zeros(ng, dtype=torch.int64, device=dev)
    cur = torch.zeros(ng, dtype=torch.int64, device=dev)
    steps = torch.zeros(ng, dtype=torch.int64, device=dev)
    here = best_t >= 0.0  # the lane takes part in its group's current row

    act = torch.arange(ng, device=dev)
    while act.numel():
        ridx = torch.clamp(cur[act], 0, nodes.shape[0] - 1)
        row = nodes[ridx]
        row_i = nodes_i[ridx]
        hr = here[act]
        rows[act] += hr.to(torch.int64)
        steps[act] += 1
        leaf = row[:, WIDTH - 1] > 0.5
        ox, oy, oz = o_g[act].unbind(2)
        dx, dy, dz = d_g[act].unbind(2)
        ix, iy, iz = inv_g[act].unbind(2)
        tmin = tmin_g[act]
        bt = best_t[act]
        a_sp = sp[act]

        # internal rows: each lane tests the K children, the group votes
        nears, metas, valids, owns = [], [], [], []
        for k in range(K):
            c = row[:, 7 * k:7 * k + 6, None]
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
            own = (hr & ~leaf[:, None] & (near <= far)
                   & (meta >= 0)[:, None])
            valid = own.any(dim=1)
            nears.append(torch.where(own, near, torch.inf).amin(dim=1))
            metas.append(meta)
            valids.append(valid)
            owns.append(own)
        for a, b in net:
            swap = nears[a] > nears[b]
            for xs in (nears, metas, valids):
                xs[a], xs[b] = (torch.where(swap, xs[b], xs[a]),
                                torch.where(swap, xs[a], xs[b]))
            sw = swap[:, None]
            owns[a], owns[b] = (torch.where(sw, owns[b], owns[a]),
                                torch.where(sw, owns[a], owns[b]))
        for s in range(K - 1, 0, -1):
            push = torch.nonzero(valids[s]).squeeze(1)
            stack[act[push], a_sp[push]] = metas[s][push]
            own_stack[act[push], a_sp[push]] = owns[s][push]
            a_sp = a_sp + valids[s].to(torch.int64)
        nxt = torch.where(valids[0], metas[0], -1)
        here_nxt = owns[0]

        # leaf rows: the lanes that took part test the row's triangles
        packed = row_i[:, WIDTH - 4, None]
        fst = packed & ((1 << COUNT_SHIFT) - 1)
        cnt = torch.where(leaf[:, None] & hr, packed >> COUNT_SHIFT, 0)
        bu, bv, btri = best_u[act], best_v[act], best_tri[act]
        for j in range(L):
            r = row[:, 12 * j:12 * j + 12, None]
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
            bt = torch.where(ok, t, bt)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
            btri = torch.where(ok, (fst + j).to(torch.int32), btri)
        best_t[act], best_u[act], best_v[act], best_tri[act] = bt, bu, bv, btri

        # descend, else pop, else the group is done
        pop = (nxt < 0) & (a_sp > 0)
        a_sp = a_sp - pop.to(torch.int64)
        slot = torch.clamp(a_sp, 0, depth - 1)
        nxt = torch.where(pop, stack[act, slot], nxt)
        here[act] = torch.where(pop[:, None], own_stack[act, slot], here_nxt)
        sp[act] = a_sp
        cur[act] = nxt
        act = act[nxt >= 0]

    def flat(x):
        return x.reshape(n_pad)[:n]

    hit = HitInfo(t=flat(best_t), tri=flat(best_tri), u=flat(best_u),
                  v=flat(best_v), hit=flat(best_tri) >= 0)
    if not with_stats:
        return hit
    return (hit, flat(rows), steps) if with_steps else (hit, flat(rows))


class _LanegroupArgs(ctypes.Structure):
    """csrc/lanegroup_traverse.cu's LanegroupArgs."""

    _fields_ = _walk_fields(("groups", "arity", "n_rows", "max_leaf",
                             "stack_depth", "n"), ("nodes", "rows"))


def walk_lanegroup_cuda(bvh: WideRowBVH, o, d, t_min, t_max, groups: int,
                        with_stats: bool = False):
    """Launch csrc/lanegroup_traverse.cu on PyTorch's current stream.
    Raises if the kernel cannot be built, the group count is not 1, 2 or 4,
    or the launch is refused."""
    _check(bvh, groups)
    nodes, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"walk_lanegroup_cuda needs CUDA tensors, got "
                         f"{o.device}")
    if groups not in GROUPS:
        raise ValueError(f"the kernel takes groups in {GROUPS}, got "
                         f"{groups}")
    depth = _check_depth(stack_depth(bvh))
    n = o.shape[0]
    rows = (torch.empty(n, dtype=torch.int32, device=o.device)
            if with_stats else None)
    h = _launch_walk("lanegroup_traverse", "lanegroup_walk", _LanegroupArgs,
                     dict(groups=groups, arity=bvh.arity,
                          n_rows=nodes.shape[0], max_leaf=bvh.max_leaf,
                          stack_depth=depth),
                     dict(nodes=(nodes, torch.float32, None),
                          rows=(rows, torch.int32, (n,))),
                     (o, d, t_min, t_max), f"walk.lanegroup.{groups}")
    return (h, rows.to(torch.int64)) if with_stats else h


def intersect_closest_lanegroup(bvh: WideRowBVH, tris, o, d, t_min=1e-4,
                                t_max=1e30, rows: int = 32, groups: int = 2,
                                with_stats: bool = False):
    """Closest hit with one cursor per group of 128 / groups rays (`tris`
    is unused: the rows hold their triangles; `rows`, the TPU kernel's
    128-lane rows per tile, is accepted and has no meaning here). Single-
    chunk tables only."""
    if o.device.type == "cuda":
        return walk_lanegroup_cuda(bvh, o, d, t_min, t_max, groups,
                                   with_stats)
    if o.device.type == "cpu":
        return walk_lanegroup_plain(bvh, o, d, t_min, t_max, groups,
                                    with_stats)
    raise ValueError(f"no lane-group walk for device {o.device}")
