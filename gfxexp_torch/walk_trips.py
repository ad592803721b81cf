"""What the walks' schedules cost on bench rays, from the plain walks alone:
runs on the CPU (no kernel is launched) or on a card.

    python -m gfxexp_torch.walk_trips [--device cpu] [--stride 64]
        [--band 4096] [--out out/walk_trips.json]

Dependent round trips to memory per live ray of kernel 2 (chunked wide
rows) and of the skip-link walk's per-ray scope: builds `big` and `city`
flattened as chunked wide rows and as skip-link scenes (animated, frame 0),
makes bench.walk_rays' rays through every --stride-th pixel of the 512x512
image (512 * 512 / stride rays a batch, the primary hits from the plain
walk), and on the first bounce batch (closest hit) and its shadow rays (any
hit) counts, per live ray, the round trips under the parent's schedule and
under the kernel's (persistent.chunked_trips, skiplink.skip_trips). Prints
mean, p99 and max per scene, walk and kind.

Lane utilisation of kernel 1 (the small scene's one table) and of the
two-level walk in build order (kernel 3, `big` and `city`), on --band
rays through consecutive pixels of the image's middle rows (so the 32
lanes of a warp hold neighbouring pixels, as on the card): the rows each
lane walks, over 32 times the steps its warp takes (lane_steps,
build_order_costs). Prints each schedule's warp steps and utilisation.

On the same --band rays: the skip-link walk's warp scope (kernel 8, `big`
and `city` as skip-link scenes) per warp, the union of its rays' nodes
and the windows of 32 nodes the kernel loads (warp_windows); and the
lane-group walk (kernel 9, the small scene, 1, 2 and 4 groups a block),
its steps per group and the share of lanes that take part (group_steps).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from gfxexp_torch import bench
from gfxexp_torch.accel.instanced import (
    GROUP,
    group_boxes,
    walk_instanced_plain,
)
from gfxexp_torch.accel.persistent import (
    _safe_inv,
    chunked_trips,
    entry_slabs,
    slab_rows,
    walk_chunked_plain,
    walk_plain,
)
from gfxexp_torch.accel.lanegroup import GROUPS, walk_lanegroup_plain
from gfxexp_torch.accel.skiplink import skip_trips, walk_skip_plain

WARP = 32
REFILLS = (1, 8, 16, 32)  # kernel 1's idle lanes before a refill


def static_steps(rows) -> int:
    """Warp steps of one thread per ray on a static grid: each warp of 32
    consecutive rays takes as many steps as its longest ray (rows [N])."""
    r = np.asarray(rows, np.int64)
    r = np.concatenate([r, np.zeros(-len(r) % WARP, np.int64)])
    return int(r.reshape(-1, WARP).max(1).sum())


def refill_steps(rows, refill: int) -> int:
    """Warp steps of kernel 1's schedule for one warp taking every ray
    (rows [N]): 32 lanes, each walking one ray a row a step; when `refill`
    lanes are idle (or all are) the warp takes the next rays for its idle
    lanes, in order. A ray of 0 rows (t_max < 0) ends as it is taken. A
    step counts where some lane walks a row."""
    queue = np.asarray(rows, np.int64)
    rem = np.zeros(WARP, np.int64)
    nxt = steps = 0
    while True:
        idle = rem == 0
        n_idle = int(idle.sum())
        if nxt < len(queue) and (n_idle >= refill or n_idle == WARP):
            take = queue[nxt:nxt + n_idle]
            rem[np.flatnonzero(idle)[:len(take)]] = take
            nxt += n_idle
        busy = rem > 0
        if busy.any():
            steps += 1
            rem -= busy
        elif nxt >= len(queue):
            return steps


def lane_steps(rows, refills=REFILLS) -> dict:
    """Kernel 1's warp steps and lane utilisation (rows walked / (32 x warp
    steps)) on one batch (rows visited per ray [N]): the static grid and
    per-lane refill for each count of idle lanes in `refills` (32 is
    per-warp feeding)."""
    total = int(np.asarray(rows).sum())
    out = {"rows": total, "static": static_steps(rows)}
    for k in refills:
        out[f"refill{k}"] = refill_steps(rows, k)
    return {name: {"warp_steps": v,
                   "utilisation": total / max(WARP * v, 1)}
            for name, v in out.items() if name != "rows"} | {"rows": total}


def _runs(x, last=False):
    """Where each run of equal values of x starts (or, with last, ends)."""
    edge = np.ones(len(x), bool)
    if last:
        edge[:-1] = x[1:] != x[:-1]
    else:
        edge[1:] = x[1:] != x[:-1]
    return edge


def _reduce_max(key, val):
    """Max of val per distinct key: (keys, maxima)."""
    order = np.lexsort((val, key))
    k, v = key[order], val[order]
    last = _runs(k, last=True)
    return k[last], v[last]


def build_order_costs(seq, n_rays: int, n_entries: int, live,
                      stopped) -> dict:
    """What the two-level walk in build order costs warps of 32
    consecutive rays, from the plain walk's visits (walk_instanced_plain
    with_stats: ray, entry, rows walked [V], each ray's in its order),
    live [N] (t_max >= 0) and stopped [N] (an any hit that ended the
    ray's list early). Scan steps count box tests a warp issues in step;
    walk steps rows. Schedules:
    - lockstep (the parent): the warp runs through the entries together
      until every lane is done; at each entry some lane visits, the
      visiting lanes walk and the rest wait: scan steps the furthest entry
      a lane reaches, walk steps the longest walk at each such entry;
    - candidate (each lane on its own cursor over all boxes): at the k-th
      round each lane scans to its k-th visit (or to the end) and then the
      lanes visit together: scan steps the longest scan of each round,
      walk steps the longest k-th walk;
    - window (the kernel, without its union boxes): the warp tests a
      window of GROUP boxes in step into each lane's mask, then each lane
      visits its own candidates of the window: scan steps GROUP a window
      the warp reaches, walk steps the longest k-th walk of each window.
    Utilisation: rows walked / (32 x walk steps)."""
    ray, ent, rows = (np.asarray(x, np.int64) for x in seq)
    live = np.asarray(live, bool)
    stopped = np.asarray(stopped, bool)
    order = np.argsort(ray, kind="stable")
    ray, ent, rows = ray[order], ent[order], rows[order]
    warp = ray // WARP
    first = _runs(ray)
    start = np.maximum.accumulate(np.where(first, np.arange(len(ray)), 0))
    k = np.arange(len(ray)) - start  # each visit's rank in its ray's list
    prev = np.where(first, -1, np.r_[-1, ent[:-1]])
    # where each live ray's list ends: the entry it stopped at, else all
    last = _runs(ray, last=True)
    last_ent = np.full(n_rays, -1, np.int64)
    last_ent[ray[last]] = ent[last]
    n_vis = np.bincount(ray, minlength=n_rays)
    end = np.where(stopped, last_ent + 1, n_entries)
    n_warps = -(-n_rays // WARP)
    lw = np.arange(n_rays) // WARP
    reach = np.zeros(n_warps, np.int64)
    np.maximum.at(reach, lw[live], end[live])
    total = int(rows.sum())
    out = {"rows": total, "visits": int(len(ray)),
           "live_rays": int(live.sum())}

    def sched(scan, walk):
        return {"scan_steps": int(scan), "walk_steps": int(walk),
                "utilisation": total / max(WARP * walk, 1)}

    # lockstep: the longest walk at each (warp, entry)
    _, m = _reduce_max(warp * n_entries + ent, rows)
    out["lockstep"] = sched(reach.sum(), m.sum())
    # candidate: the longest scan and the longest walk of each (warp, k)
    # round, the last round (to the end of the list) after each ray's last
    # visit
    ends = np.flatnonzero(live)
    r_key = np.r_[warp * (n_entries + 1) + k,
                  lw[ends] * (n_entries + 1) + n_vis[ends]]
    r_scan = np.r_[ent - prev,
                   np.where(stopped[ends], 0,
                            end[ends] - 1 - np.where(n_vis[ends] > 0,
                                                     last_ent[ends], -1))]
    _, scan = _reduce_max(r_key, r_scan)
    _, walk = _reduce_max(warp * (n_entries + 1) + k, rows)
    out["candidate"] = sched(scan.sum(), walk.sum())
    # window: per (warp, window), the k-th visit in the window
    window = GROUP
    win = ent // window
    wfirst = _runs(ray) | _runs(win)
    wstart = np.maximum.accumulate(np.where(wfirst, np.arange(len(ray)), 0))
    wk = np.arange(len(ray)) - wstart
    n_win = -(-n_entries // window)
    _, walk = _reduce_max((warp * n_win + win) * (window + 1) + wk, rows)
    scan = sum(min(window * -(-int(x) // window), n_entries) for x in reach)
    out["window"] = sched(scan, walk.sum())
    return out


def group_shares(lo, hi, o, d, t_min, t_max, group: int = GROUP) -> dict:
    """Of the groups of `group` consecutive entries (boxes lo, hi [C, 3]),
    the share whose union box a live ray enters within [t_min, t_max]
    (per ray), and the share some live lane of a warp of 32 consecutive
    rays enters (per warp): how much a test of each group's box before its
    members could skip."""
    glo, ghi = group_boxes(lo, hi, group)
    n_g = glo.shape[0]
    live = t_max >= 0
    inv = _safe_inv(d)
    hits = []
    step = slab_rows(n_g)
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        _, ok = entry_slabs(glo, ghi, o[sl], inv[sl], t_min[sl], t_max[sl])
        hits.append(ok)
    hit = torch.cat(hits) & live[:, None]
    n = o.shape[0]
    pad_rays = -n % WARP
    warp_hit = torch.cat([hit, hit.new_zeros(pad_rays, n_g)]).reshape(
        -1, WARP, n_g).any(1)
    warp_live = torch.cat([live, live.new_zeros(pad_rays)]).reshape(
        -1, WARP).any(1)
    return {"groups": n_g,
            "per_ray": float(hit[live].double().mean()) if live.any()
            else 0.0,
            "per_warp": float(warp_hit[warp_live].double().mean())
            if warp_live.any() else 0.0}


def _windows(key, span, seg_start, seg_end, window, prefetch):
    """Windows each warp enters walking its sorted node keys (warp * span +
    node), and how many of the window changes land in the next window: a
    window opens at the first node; when the cursor passes its end, the next
    one opens at the cursor or, with `prefetch` and a cursor inside the
    next window, is that next window."""
    n_warps = len(seg_start)
    windows = (seg_end > seg_start).astype(np.int64)
    nexts = np.zeros(n_warps, np.int64)
    idx = np.flatnonzero(windows)
    base = key[seg_start[idx]] % span
    while len(idx):
        at = np.searchsorted(key, idx * span + base + window)
        more = at < seg_end[idx]
        idx, base, at = idx[more], base[more], at[more]
        node = key[at] % span
        land = node < base + 2 * window
        windows[idx] += 1
        nexts[idx] += land
        base = np.where(land & prefetch, base + window, node)
    return windows, nexts


def warp_windows(visits, n_rays: int, window: int = WARP) -> dict:
    """What kernel 8 (the skip-link walk's warp scope) costs warps of 32
    consecutive rays, from the plain per-ray walk's visits (SkipStats.visits:
    ray, node pairs, a tensor or an array). The warp's cursor walks the union of its rays' nodes
    in preorder, one step a node: the parent's dependent node loads. The
    kernel holds a window of `window` consecutive nodes and loads another
    when the cursor passes its end: at the cursor, or, with the next window
    prefetched, that window where the cursor lands in it (the `next` share
    of the changes; those loads were issued a window earlier). Per warp with
    a live ray: union steps, windows entered with and without the prefetch,
    and the dependent loads left with it (windows not served by it)."""
    v = torch.as_tensor(visits).to(torch.int64).reshape(-1, 2)
    n_warps = -(-n_rays // WARP)
    if not len(v):
        return {"warps": 0, "steps": 0.0, "windows": 0.0,
                "windows_at_cursor": 0.0, "next_share": 0.0,
                "dependent_loads": 0.0}
    span = int(v[:, 1].max()) + 2 * window + 1
    # the union per warp, sorted, on the visits' device
    key = torch.unique(v[:, 0] // WARP * span + v[:, 1]).cpu().numpy()
    warps = np.arange(n_warps)
    seg_start = np.searchsorted(key, warps * span)
    seg_end = np.searchsorted(key, (warps + 1) * span)
    steps = seg_end - seg_start
    live = int((steps > 0).sum())
    win, nxt = _windows(key, span, seg_start, seg_end, window, True)
    at_cur, _ = _windows(key, span, seg_start, seg_end, window, False)
    changes = int((win - (steps > 0)).sum())
    return {"warps": live, "steps": float(steps.sum()) / live,
            "windows": float(win.sum()) / live,
            "windows_at_cursor": float(at_cur.sum()) / live,
            "next_share": float(nxt.sum()) / max(changes, 1),
            "dependent_loads": float((win - nxt).sum()) / live}


def group_steps(rows, steps, groups: int) -> dict:
    """What kernel 9 (the lane-group walk) costs, from its plain version's
    rows per ray [N] and rows stepped per group (walk_lanegroup_plain
    with_stats and with_steps): group steps per group, warp steps (a group
    of 128 / groups lanes spans 4 / groups warps, each of which runs every
    step) and the share of lanes that take part in a step (rows / (lanes x
    steps))."""
    rows = np.asarray(rows, np.int64)
    steps = np.asarray(steps, np.int64)
    lanes = 128 // groups
    total = int(steps.sum())
    return {"groups": int(len(steps)), "steps": total,
            "steps_per_group": total / max(len(steps), 1),
            "warp_steps": total * max(lanes // WARP, 1),
            "rows": int(rows.sum()),
            "share": int(rows.sum()) / max(lanes * total, 1)}


def summary(x: torch.Tensor, live: torch.Tensor) -> dict:
    x = x[live].double()
    return {"mean": float(x.mean()), "p99": float(torch.quantile(x, 0.99)),
            "max": float(x.max())}


def _batch(rays, n):
    o, d, t_min, t_max, sd, s_max = rays
    b = slice(n, 2 * n)
    return {"closest": (o[b], d[b], t_min[b], t_max[b]),
            "any": (o[b], sd[b], t_min[b], s_max[b])}


def chunked(which: str, dev, stride: int) -> dict:
    bvh = bench.build_bench_scene(which, traversal="widerow")[1].to(dev)

    def first_hit(o0, d0):
        h = walk_chunked_plain(bvh, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    n = 512 * 512 // stride
    rays = bench.walk_rays(first_hit, which, dev, batch=n, stride=stride)
    out = {}
    for kind, args in _batch(rays, n).items():
        _, rows, _, tests = walk_chunked_plain(bvh, *args, kind == "any",
                                               with_stats=True)
        parent, new = chunked_trips(rows, tests, bvh.arity)
        live = args[3] >= 0
        out[kind] = {"rows": summary(rows, live),
                     "parent": summary(parent, live),
                     "batched": summary(new, live)}
    return out


def skip(which: str, dev, stride: int) -> dict:
    scene, bvh = bench.build_bench_scene(which, traversal="skip")
    scene, bvh = scene.to(dev), bvh.to(dev)
    tris = scene.triangles

    def first_hit(o0, d0):
        h = walk_skip_plain(bvh, tris, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    n = 512 * 512 // stride
    rays = bench.walk_rays(first_hit, which, dev, batch=n, stride=stride)
    out = {}
    for kind, args in _batch(rays, n).items():
        _, st = walk_skip_plain(bvh, tris, *args, kind == "any",
                                with_stats=True)
        live = args[3] >= 0
        # the kernel batches a hit leaf's rows for closest hit only
        parent, new = skip_trips(st, leaf_batch=kind == "closest")
        out[kind] = {"nodes": summary(st.nodes, live),
                     "tris": summary(st.tris, live),
                     "parent": summary(parent, live),
                     "kernel": summary(new, live)}
    return out


def _band(first_hit, which, dev, band):
    """The first bounce batch (closest) and its shadow rays (any hit)
    through `band` consecutive pixels of the image's middle rows."""
    first = (512 * 512 - band) // 2
    rays = bench.walk_rays(first_hit, which, dev, batch=band, first=first)
    return _batch(rays, band)


def widerow_lanes(dev, band: int) -> dict:
    """Kernel 1's lane utilisation on the small scene (lane_steps)."""
    bvh = bench.build_bench_scene()[1].to(dev)

    def first_hit(o0, d0):
        h = walk_plain(bvh, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    out = {}
    for kind, args in _band(first_hit, "small", dev, band).items():
        _, rows = walk_plain(bvh, *args, kind == "any", with_stats=True)
        out[kind] = lane_steps(rows.cpu().numpy())
        out[kind]["rows_per_live_ray"] = summary(rows, args[3] >= 0)
    return out


def build_lanes(which: str, dev, band: int) -> dict:
    """The two-level walk in build order: each schedule's warp steps
    (build_order_costs) and the share of entry groups rays enter
    (group_shares)."""
    acc = bench.build_bench_scene(which)[1].to(dev)

    def first_hit(o0, d0):
        h, _ = walk_instanced_plain(acc, o0, d0, 0.0, 1e30, False, "nearest")
        return h.t, h.hit

    out = {}
    for kind, args in _band(first_hit, which, dev, band).items():
        any_hit = kind == "any"
        h, _, _, _, seq = walk_instanced_plain(acc, *args, any_hit, "build",
                                               with_stats=True)
        live = (args[3] >= 0).cpu().numpy()
        stopped = (h.hit if any_hit else torch.zeros_like(h.hit)).cpu()
        out[kind] = build_order_costs(
            [x.cpu().numpy() for x in seq], args[0].shape[0],
            acc.num_entries, live, stopped.numpy())
        out[kind]["groups"] = group_shares(acc.chunk_lo, acc.chunk_hi,
                                           *args)
    return out


def skip_windows(which: str, dev, band: int) -> dict:
    """Kernel 8's union steps and windows per warp (warp_windows) on `big`
    or `city` as a skip-link scene (animated, frame 0)."""
    scene, bvh = bench.build_bench_scene(which, traversal="skip")
    scene, bvh = scene.to(dev), bvh.to(dev)
    tris = scene.triangles

    def first_hit(o0, d0):
        h = walk_skip_plain(bvh, tris, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    out = {}
    for kind, args in _band(first_hit, which, dev, band).items():
        _, st = walk_skip_plain(bvh, tris, *args, kind == "any",
                                with_stats=True)
        out[kind] = warp_windows(st.visits, args[0].shape[0])
    return out


def lanegroup_groups(dev, band: int) -> dict:
    """Kernel 9's steps and the share of lanes that take part
    (group_steps), for each group count, on the small scene's table."""
    bvh = bench.build_bench_scene()[1].to(dev)

    def first_hit(o0, d0):
        h = walk_plain(bvh, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    args = _band(first_hit, "small", dev, band)["closest"]
    out = {}
    for g in GROUPS:
        _, rows, steps = walk_lanegroup_plain(bvh, *args, g, with_stats=True,
                                              with_steps=True)
        out[f"g{g}"] = group_steps(rows.cpu().numpy(), steps.cpu().numpy(),
                                   g)
    return out


def window_line(e) -> str:
    """One line of warp_windows' counts."""
    return (f"{e['warps']} warps: {e['steps']:.1f} union steps a warp "
            f"(the parent's dependent node loads); windows of {WARP} "
            f"{e['windows']:.1f} ({e['next_share']:.3f} of changes into the "
            f"next window; {e['windows_at_cursor']:.1f} opened at the "
            f"cursor), {e['dependent_loads']:.1f} not prefetched")


def group_line(e) -> str:
    """One line of group_steps' counts."""
    return (f"{e['steps_per_group']:.1f} steps a group ({e['groups']} "
            f"groups, {e['warp_steps']} warp steps), {e['rows']} rows, "
            f"share of lanes taking part {e['share']:.3f}")


def lane_line(e) -> str:
    """One line of the warp steps and lane utilisation of each schedule
    (lane_steps, or build_order_costs with its group_shares)."""
    if "static" in e:
        return f"rows {e['rows']}; " + "; ".join(
            f"{name} {v['warp_steps']} warp steps ({v['utilisation']:.3f})"
            for name, v in e.items() if isinstance(v, dict)
            and "warp_steps" in v)
    g = e["groups"]
    return (f"rows {e['rows']} in {e['visits']} visits; " + "; ".join(
        f"{name} scan {e[name]['scan_steps']} walk {e[name]['walk_steps']} "
        f"({e[name]['utilisation']:.3f})"
        for name in ("lockstep", "candidate", "window"))
        + f"; groups of {GROUP} entered per ray {g['per_ray']:.3f}, per "
        f"warp {g['per_warp']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--band", type=int, default=4096)
    ap.add_argument("--out", default=os.path.join("out", "walk_trips.json"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    res = {}
    for which in ("big", "city"):
        for name, fn in (("chunked", chunked), ("skip", skip)):
            key = f"{name} {which}"
            res[key] = fn(which, dev, args.stride)
            for kind, e in res[key].items():
                print(f"walk_trips: {key} {kind}: " + "; ".join(
                    f"{k} {v['mean']:.2f}/{v['p99']:.0f}/{v['max']:.0f}"
                    for k, v in e.items()), flush=True)
    lanes = {"widerow small": widerow_lanes(dev, args.band)}
    for which in ("big", "city"):
        lanes[f"instanced_build {which}"] = build_lanes(which, dev, args.band)
    for key, per in lanes.items():
        for kind, e in per.items():
            print(f"walk_trips: {key} {kind}: {lane_line(e)}", flush=True)
    for which in ("big", "city"):
        key = f"skip_warp {which}"
        lanes[key] = skip_windows(which, dev, args.band)
        for kind, e in lanes[key].items():
            print(f"walk_trips: {key} {kind}: {window_line(e)}", flush=True)
    lanes["lanegroup small"] = lanegroup_groups(dev, args.band)
    for g, e in lanes["lanegroup small"].items():
        print(f"walk_trips: lanegroup small {g}: {group_line(e)}",
              flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": str(dev), "stride": args.stride,
                   "rays_per_batch": 512 * 512 // args.stride,
                   "mean_p99_max": res, "band": args.band,
                   "lanes": lanes}, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
