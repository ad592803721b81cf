"""Time the wide-row, two-level, chunked, quantized and skip-link walks of
several CUDA source trees on the same rays, in turns, on one CUDA device.

    python -m gfxexp_torch.walk_ab parent=/path/to/parent/gfxexp_torch/csrc \\
        change=gfxexp_torch/csrc [--reps 20] [--only chunked,skip]
        [--out out/walk_ab.json]

Each NAME=DIR names a directory that holds widerow_traverse.cu,
instanced_traverse.cu, chunked_traverse.cu, qrow_traverse.cu,
skiplink_traverse.cu and lanegroup_traverse.cu (and their headers) with
the C interface of gfxexp_torch/csrc, or one that takes fewer trailing arguments (a parent's:
the C calling convention ignores the rest); the first tree is the
reference. Every source is built
with build.NVCC_FLAGS, one nvcc each, up to 16 at once, into
build/walk_ab/<NAME>/. One process then builds bench.py's small scene (one
wide-row table, walked by kernel 1 and, whole, by kernel 2), `big`, `city`
and `city rebraid4` two-level (nearest-first and build order on each; the
ray-sorted route on `city`), `big` and `city` flattened (chunked wide
rows, quantized rows) and `big` and `city` as skip-link scenes (animated,
frame 0; the per-ray scope, and the warp scope as `skip <scene> warp`),
and the lane-group walk with 1, 2 and 4 groups on the small table
(`lanegroup small g<G>`, closest hit, its rows per ray compared too), makes
bench.walk_rays' rays, and times each walk on one 262,144-ray bounce batch
(closest hit) and its shadow rays (any hit) with CUDA events, in turns: the
trees in order, then in reverse (parent, change, change, parent for two
trees). A reading is the mean of --reps launches, each timed by its own
event pair after a spin of the card (so no host time between launches
counts). Warm readings leave the last launch's rows in L2; the `widerow
small`, `instanced_build city`, `chunked city` and `skip city` cases add a
cold reading, where a 256 MB scratch tensor is written before each launch
(outside the timed events, so the tables' rows are no longer in the 50 MB
L2). Every tree's results must
equal the reference's bit for bit (t, u, v, tri, hit, and the entry of the
two-level walk). --only keeps the cases whose name starts with one of the
given words. Prints one line per case and writes the times, nvcc's -Xptxas
-v reports and SASS instruction counts (conversions I2F*, local loads and
stores, all instructions and a digest of the opcode sequence, of each
library and of each __global__ instantiation, where cuobjdump is found)
to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import zlib

import torch

from gfxexp_torch import bench
from gfxexp_torch.accel import instanced
from gfxexp_torch.accel.instanced import walk_instanced_cuda, walk_tlas
from gfxexp_torch.accel.lanegroup import GROUPS, walk_lanegroup_cuda
from gfxexp_torch.accel.persistent import walk_chunked_cuda, walk_cuda
from gfxexp_torch.accel.qrow import walk_qrow_cuda
from gfxexp_torch.accel.skip_traverse import walk_skip_cuda
from gfxexp_torch.csrc import build

KERNELS = ("widerow_traverse", "instanced_traverse", "chunked_traverse",
           "qrow_traverse", "skiplink_traverse", "lanegroup_traverse")
BATCH = 512 * 512
SEED = 7
MAX_NVCC = 16  # nvcc processes at once
# cases (their names without the kind) with a cold-L2 reading too
COLD = ("widerow small", "instanced_build city", "chunked city", "skip city")
SCRATCH_BYTES = 256 << 20  # written before each cold launch: > 5x the L2
_SASS_OPS = ("I2F", "LDL", "STL")


def build_trees(trees: dict) -> tuple[dict, dict]:
    """Build every kernel of every tree ({name: csrc dir}) with one nvcc
    each, up to MAX_NVCC at once. Returns ({name: {kernel: CDLL}}, {name:
    {kernel: ptxas lines}}); raises when a build fails."""
    nvcc = build._nvcc()
    root = os.path.join(os.path.dirname(build.build_dir()), "walk_ab")
    jobs = []
    for name, src_dir in trees.items():
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for k in KERNELS:
            jobs.append((name, k, os.path.join(root, name, f"lib{k}.so"),
                         os.path.join(src_dir, k + ".cu")))
    errs = {}
    for i in range(0, len(jobs), MAX_NVCC):
        procs = [(name, k, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for name, k, so, src in jobs[i:i + MAX_NVCC]]
        for name, k, proc in procs:
            errs[name, k] = proc.communicate()[1]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {trees[name]}/{k}.cu:\n"
                                   f"{errs[name, k]}")
    libs, ptxas = {}, {}
    for name, k, so, _ in jobs:
        err = errs[name, k]
        lib = ctypes.CDLL(so)
        build._declare(k, lib)
        libs.setdefault(name, {})[k] = lib
        ptxas.setdefault(name, {})[k] = [
            ln.strip() for ln in err.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]
    return libs, ptxas


def _kernel_name(mangled: str) -> str:
    """A __global__ function's mangled name without the hash of its
    source's path that nvcc puts in the anonymous namespace, so that the
    same instantiation has the same name in every tree."""
    return re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]{8}",
                  r"\1::", mangled.strip())


def _digest(ops) -> int:
    return zlib.crc32(" ".join(ops).encode()) if ops else 0


def sass_counts(trees: dict) -> dict:
    """{name: {kernel: {opcode: count}}} from cuobjdump -sass of each built
    library, with `all` (every instruction), `digest` (a hash of the
    opcode sequence: equal where two trees compiled a kernel alike) and
    `functions` (that digest per __global__ instantiation, by its mangled
    name); empty when cuobjdump is not found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    root = os.path.join(os.path.dirname(build.build_dir()), "walk_ab")
    out = {}
    for name in trees:
        for k in KERNELS:
            sass = subprocess.run(
                [tool, "-sass", os.path.join(root, name, f"lib{k}.so")],
                capture_output=True, text=True).stdout
            op_re = (r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)")
            ops = re.findall(op_re, sass)
            funcs = {}
            for part in re.split(r"\n\s*Function : ", sass)[1:]:
                fn, body = part.split("\n", 1)
                funcs[_kernel_name(fn)] = _digest(re.findall(op_re, body))
            out.setdefault(name, {})[k] = {
                **{op: len(re.findall(rf"\b{op}[.A-Z0-9]*\s", sass))
                   for op in _SASS_OPS},
                "all": len(ops), "digest": _digest(ops),
                "functions": funcs}
    return out


def use(libs: dict, name: str):
    """Route the wrappers to tree `name`'s libraries."""
    for k, lib in libs[name].items():
        build._libs[k] = lib


def _bounce_args(rays):
    o, d, t_min, t_max, sd, s_max = rays
    b = slice(BATCH, 2 * BATCH)
    return {"closest": (o[b], d[b], t_min[b], t_max[b]),
            "any": (o[b], sd[b], t_min[b], s_max[b])}


def cases(dev, only=None):
    """[(case name, (closure) -> results)] over every scene, walk and
    kind, with the reference tree's libraries in use for the rays; with
    `only`, the cases whose name starts with one of its words (scenes no
    case needs are not built)."""
    def wanted(*prefixes):
        return only is None or any(p.startswith(w) or w.startswith(p)
                                   for p in prefixes for w in only)

    out = []
    if wanted("widerow", "chunked small"):
        out += _small_cases(dev)
    if wanted("lanegroup"):
        out += _lanegroup_cases(dev)
    if wanted("instanced"):
        out += _instanced_cases(dev)
    for which in ("big", "city"):
        for fmt in ("widerow", "qrow"):
            name = "chunked" if fmt == "widerow" else "qrow"
            if wanted(f"{name} {which}"):
                out += _flat_cases(dev, which, fmt, name)
        if wanted(f"skip {which}"):
            out += _skip_cases(dev, which)
    if only is not None:
        out = [(c, fn) for c, fn in out
               if any(c.startswith(w) for w in only)]
    return out


def _small_cases(dev):
    out = []
    small = bench.build_bench_scene()[1].to(dev)

    def small_hit(o0, d0):
        h = walk_cuda(small, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    rays = bench.walk_rays(small_hit, "small", dev, SEED, BATCH)
    for kind, args in _bounce_args(rays).items():
        # kernel 1, and kernel 2 walking the one table whole (the route
        # with the persistent switch off)
        for name, walk in (("widerow", walk_cuda),
                           ("chunked", walk_chunked_cuda)):
            def fn(a=args, any_hit=kind == "any", walk=walk):
                h = walk(small, *a, any_hit)
                return (h.t, h.u, h.v, h.tri, h.hit)

            out.append((f"{name} small {kind}", fn))
    return out


def _lanegroup_cases(dev):
    """Kernel 9 with each group count on the small scene's table, closest
    hit on the bounce batch, rows per ray included."""
    small = bench.build_bench_scene()[1].to(dev)

    def small_hit(o0, d0):
        h = walk_cuda(small, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    rays = bench.walk_rays(small_hit, "small", dev, SEED, BATCH)
    args = _bounce_args(rays)["closest"]
    out = []
    for g in GROUPS:
        def fn(g=g):
            h, rows = walk_lanegroup_cuda(small, *args, g, with_stats=True)
            return (h.t, h.u, h.v, h.tri, h.hit, rows)

        out.append((f"lanegroup small g{g} closest", fn))
    return out


def _instanced_cases(dev):
    out = []
    for key, which, rb in (("city", "city", 0.0),
                           ("city_rebraid4", "city", 4.0),
                           ("big", "big", 0.0)):
        acc = bench.build_bench_scene(which, rb)[1].to(dev)

        def first_hit(o0, d0, acc=acc):
            h, _ = walk_instanced_cuda(acc, o0, d0, 0.0, 1e30, False,
                                       "nearest")
            return h.t, h.hit

        rays = bench.walk_rays(first_hit, which, dev, SEED, BATCH)
        for kind, args in _bounce_args(rays).items():
            any_hit = kind == "any"
            routes = ("nearest", "sorted", "build") if key == "city" else (
                "nearest", "build")
            for route in routes:
                a = args
                if route == "sorted":
                    # the kernel on the rays the tlas route has sorted
                    ob, dd, tmin, tm = args
                    first, has = instanced._nearest_entry(acc, ob, dd, tmin,
                                                          tm)
                    perm = torch.argsort(torch.where(has, first,
                                                     acc.num_entries),
                                         stable=True)
                    a = (ob[perm].contiguous(), dd[perm].contiguous(),
                         tmin[perm].contiguous(),
                         torch.where(has, tm, -1.0)[perm].contiguous())

                def fn(acc=acc, a=a, any_hit=any_hit, route=route):
                    h, ent = walk_instanced_cuda(acc, *a, any_hit, route)
                    return (h.t, h.u, h.v, h.tri, h.hit, ent)

                out.append((f"instanced_{route} {key} {kind}", fn))
        del rays
    return out


def _flat_cases(dev, which, fmt, name):
    walk = walk_chunked_cuda if fmt == "widerow" else walk_qrow_cuda
    bvh = bench.build_bench_scene(which, traversal=fmt)[1].to(dev)

    def first_hit(o0, d0):
        h = walk(bvh, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    rays = bench.walk_rays(first_hit, which, dev, SEED, BATCH)
    out = []
    for kind, args in _bounce_args(rays).items():
        def fn(a=args, any_hit=kind == "any"):
            h = walk(bvh, *a, any_hit)
            return (h.t, h.u, h.v, h.tri, h.hit)

        out.append((f"{name} {which} {kind}", fn))
    return out


def _skip_cases(dev, which):
    """The skip-link walk on the animated scene at frame 0: the per-ray
    scope (what every query of a skip-link scene launches) and the warp
    scope (kernel 8)."""
    scene, bvh = bench.build_bench_scene(which, traversal="skip")
    scene, bvh = scene.to(dev), bvh.to(dev)
    tris = scene.triangles

    def first_hit(o0, d0):
        h = walk_skip_cuda(bvh, tris, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    rays = bench.walk_rays(first_hit, which, dev, SEED, BATCH)
    out = []
    for kind, args in _bounce_args(rays).items():
        def fn(a=args, any_hit=kind == "any"):
            h = walk_skip_cuda(bvh, tris, *a, any_hit, "thread")
            return (h.t, h.u, h.v, h.tri, h.hit)

        def warp_fn(a=args, any_hit=kind == "any"):
            h = walk_skip_cuda(bvh, tris, *a, any_hit, "warp")
            return (h.t, h.u, h.v, h.tri, h.hit)

        out.append((f"skip {which} {kind}", fn))
        out.append((f"skip {which} warp {kind}", warp_fn))
    return out


def launch_ms(fn, reps: int, scratch: torch.Tensor = None) -> float:
    """Mean device time in ms of fn() over reps launches (after one warm
    call), each timed by its own event pair. A spin of the card before each
    start event gives the host time to enqueue the launch, so the pair
    holds the launch alone, however long the wrapper takes on the host.
    With `scratch`, it is written before each launch (outside the events),
    so the launch starts with none of its rows in L2 (cold); without, the
    last launch's rows stay there (warm)."""
    fn()
    pairs = []
    for i in range(reps):
        if scratch is not None:
            scratch.fill_(float(i))
        torch.cuda._sleep(1 << 20)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="NAME=CSRC_DIR, reference first")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="comma-separated case name prefixes")
    ap.add_argument("--out", default=os.path.join("out",
                                                  "walk_ab.json"))
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.trees)
    names = list(trees)
    if not torch.cuda.is_available():
        raise RuntimeError("gfxexp_torch.walk_ab needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"walk_ab: {smi}; trees {trees}", flush=True)
    libs, ptxas = build_trees(trees)
    for name in names:
        for k in KERNELS:
            print(f"walk_ab: {name} {k}: {' | '.join(ptxas[name][k])}",
                  flush=True)
    sass = sass_counts(trees)
    for name, per in sass.items():
        print(f"walk_ab: {name} SASS " + str({
            k: {op: n for op, n in c.items() if op != "functions"}
            for k, c in per.items()}), flush=True)
        if name != names[0]:
            ref = {fn: dg for c in sass[names[0]].values()
                   for fn, dg in c["functions"].items()}
            got = {fn: dg for c in per.values()
                   for fn, dg in c["functions"].items()}
            same = sorted(fn for fn, dg in got.items() if ref.get(fn) == dg)
            print(f"walk_ab: {name} SASS of {len(same)} of {len(got)} "
                  f"instantiations equal to {names[0]}'s; differ or new: "
                  f"{sorted(set(got) - set(same))}", flush=True)
    use(libs, names[0])
    only = args.only.split(",") if args.only else None
    scratch = torch.empty(SCRATCH_BYTES // 4, device=dev)
    rows = {}
    order = names + names[::-1]
    for case, fn in cases(dev, only):
        use(libs, names[0])
        ref = fn()
        readings = {"": launch_ms}
        if case.rsplit(" ", 1)[0] in COLD:
            readings[" cold"] = lambda f, reps: launch_ms(f, reps, scratch)
        times = {tag: {name: [] for name in names} for tag in readings}
        for name in order:
            use(libs, name)
            got = fn()
            torch.cuda.synchronize()
            for x, y in zip(got, ref):
                if not torch.equal(x, y):
                    raise RuntimeError(f"walk_ab: {case}: tree {name} differs "
                                       f"from {names[0]}")
            for tag, timer in readings.items():
                times[tag][name].append(timer(fn, args.reps))
        for tag, per in times.items():
            rows[case + tag] = per
            base = sum(per[names[0]]) / len(per[names[0]])
            print(f"walk_ab: {case}{tag}: " + "; ".join(
                f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms "
                f"(x{sum(ts) / len(ts) / base:.3f})"
                for name, ts in per.items()), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"nvidia_smi": smi, "trees": trees, "order": order,
                   "reps": args.reps, "ms": rows, "ptxas": ptxas,
                   "sass": sass}, f, indent=1)
    print(f"walk_ab: every tree equals {names[0]} on every case; "
          f"{args.out}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
