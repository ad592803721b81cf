"""Dependent round trips to memory per live ray of kernel 2 (chunked wide
rows) and of the skip-link walk's per-ray scope, on bench rays, from the
plain walks alone: runs on the CPU (no kernel is launched) or on a card.

    python -m gfxexp_torch.walk_trips [--device cpu] [--stride 64]
        [--out out/walk_trips.json]

Builds `big` and `city` flattened as chunked wide rows and as skip-link
scenes (animated, frame 0), makes bench.walk_rays' rays through every
--stride-th pixel of the 512x512 image (512 * 512 / stride rays a batch,
the primary hits from the plain walk), and on the first bounce batch
(closest hit) and its shadow rays (any hit) counts, per live ray, the round
trips under the parent's schedule and under the kernel's
(persistent.chunked_trips, skiplink.skip_trips). Prints mean, p99 and max
per scene, walk and kind.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from gfxexp_torch import bench
from gfxexp_torch.accel.persistent import chunked_trips, walk_chunked_plain
from gfxexp_torch.accel.skiplink import skip_trips, walk_skip_plain

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stride", type=int, default=1)
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
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": str(dev), "stride": args.stride,
                   "rays_per_batch": 512 * 512 // args.stride,
                   "mean_p99_max": res}, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
