#!/usr/bin/env python3
"""Smoke run of the gfxexp_torch port on one CUDA device.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: the CUDA kernels from gfxexp_torch/csrc (one nvcc per source,
     all at once) and the native BVH builder with g++, then the small bench
     scene on the host;
  3. kernel 1 vs plain: the wide-row walk (closest and any hit) on ~1M small
     bench scene rays against its plain PyTorch version, and both against
     brute force on a 64k-ray subset; times and bounds at the main path's
     batch size;
  4. slice: a 64x64, 2-sample render of the small scene on the card against
     the same render on the CPU (mean relative image difference < 5e-3, rays
     within 0.5%);
  5. main path: gfxexp_torch.bench.measure at 512x512 and 1920x1080 with
     kernel 1's launch counts, image checks and out/torch_bench_512.png;
  6. two-level build: bench.py's `big` and `city` (and `city rebraid4`)
     compiled instanced on the host;
  7. two-level kernel vs plain: the instanced walk on ~1M `city` rays, with
     and without rebraid, for each route (nearest-first, build order, the
     ray-sorted tlas route), closest and any hit, against the plain version
     (exactly equal), the routes against each other, and brute force over
     the flattened world triangles on a 4,096-ray subset; times and bounds
     at one 262,144-ray bounce batch;
  8. two-level slice: `big` at 64x64, 2 samples, card against CPU;
  9. two-level main path: gfxexp_torch.bench.measure on `big` and `city`
     (nearest-first), `big nopersist` (build order) and `city tlas` (ray
     sorted) at 512x512 with the instanced kernels' launch counts (kernel
     1's must be 0 there), image checks, out/torch_bench_{big,city}.png, the
     walk kernels' share of device time (torch.profiler) and peak memory.
The last lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gfxexp_torch import bench
from gfxexp_torch.accel import instanced, native, persistent
from gfxexp_torch.accel.instanced import (
    ROUTES,
    walk_instanced_cuda,
    walk_instanced_plain,
    walk_tlas,
)
from gfxexp_torch.accel.persistent import walk_cuda, walk_plain
from gfxexp_torch.accel.traverse import HitInfo, intersect_closest_brute
from gfxexp_torch.csrc import build
from gfxexp_torch.render.camera import generate_rays_for_lanes
from gfxexp_torch.render.pathtrace import PTConfig, render_accumulate
from gfxexp_torch.utils.image_io import save_png

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 7
BATCH = 512 * 512  # the main path's ray batch at 512x512
IMAGE_BAR = 5e-3  # mean relative image difference (golden-test bar)
KERNELS = ("widerow_traverse", "instanced_traverse")
# the H100 SXM's published peaks (NVIDIA's data sheet: HBM3, fp32 without
# the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per walk step, for the bounds: a visited row is charged the
# slab tests of 4 children (25 each: 6 sub, 6 mul, 12 min/max, 1 compare;
# a leaf's 2-4 triangle tests of 39 each cost more); a visited entry its
# ray transform (33) and reciprocals (3); an entry scan 25 per entry
OPS_ROW = 100
OPS_VISIT = 36
OPS_SLAB = 25
RAY_IN, RAY_OUT, ENTRY_OUT = 32, 17, 4  # bytes per ray (o, d, tmin, tmax)
ENTRY_BYTES = 96  # AABB 24, transform 64, BLAS id 4, start row 4
# the TPU kernel (function reaching pl.pallas_call) each route replaces
REPLACES = {
    "nearest": "gfxexp_tpu/accel/pallas_persistent_inst.py:378",
    "build": "gfxexp_tpu/accel/pallas_widestack.py:1068",
    "sorted": "gfxexp_tpu/accel/pallas_widestack.py:1189",
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps, warm=True):
    """Mean device time of fn() over reps launches (after one warm call)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """(least time in ms, what bounds it) for moving nbytes through HBM and
    doing ops float32 operations on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_environment(report):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" | {smi}", flush=True)


def phase_build(report):
    t0 = time.time()
    build.load_libraries(KERNELS)
    secs = time.time() - t0
    t0 = time.time()
    check(native.native_available(), "native BVH builder did not build")
    native_secs = time.time() - t0
    report["build"] = {"seconds": secs, "native_bvh_seconds": native_secs,
                       "nvcc_seconds": dict(build.build_seconds),
                       "ptxas": {}}
    for name in KERNELS:
        ptxas = [ln.strip() for ln in build.build_log.get(name, "")
                 .splitlines() if "registers" in ln or "spill" in ln]
        report["build"]["ptxas"][name] = ptxas
        print(f"[2 build] gfxexp_torch/csrc/{name}.cu: nvcc "
              f"{build.build_seconds[name]:.2f}s; ptxas: "
              f"{' | '.join(ptxas)}", flush=True)
    print(f"[2 build] both kernels in {secs:.2f}s (parallel nvcc); native "
          f"BVH builder (g++) {native_secs:.2f}s", flush=True)


def _scene_rays(first_hit, which, dev):
    """~1M rays over a bench scene: one batch of jittered primary rays at
    512x512, three batches of random bounce directions from the primary
    hits; every 7th ray dead (t_max < 0). Shadow rays from the same origins
    to random points on the light, every 5th dead. `first_hit(o, d)` gives
    the primary hits' t and hit mask."""
    rng = np.random.default_rng(SEED)
    cam = bench.bench_camera(512, 512, which).to(dev)
    jit = torch.from_numpy(rng.random((2, BATCH), np.float32)).to(dev)
    lane = torch.arange(BATCH, device=dev)
    o0, d0 = generate_rays_for_lanes(cam, 512, 512, lane, jit[0], jit[1])
    t0, h0 = first_hit(o0, d0)
    p = torch.where(h0[:, None], o0 + t0[:, None] * d0, o0)
    dirs = rng.normal(size=(3 * BATCH, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = torch.cat([o0, p, p, p]).contiguous()
    d = torch.cat([d0, torch.from_numpy(dirs).to(dev)]).contiguous()
    n = o.shape[0]
    idx = torch.arange(n, device=dev)
    t_min = torch.where(idx < BATCH, 0.0, 1e-4)
    t_max = torch.where(idx % 7 == 3, -1.0, 1e30)
    # shadow rays towards the light: 0.3 x the floor's side, at y = 1.5
    half = 0.3 * bench._LAYOUT[which][0] / 2
    xz = torch.from_numpy(rng.uniform(-half, half, (n, 2)).astype(np.float32))
    target = torch.stack([xz[:, 0], torch.full((n,), 1.5), xz[:, 1]], 1)
    vec = target.to(dev) - o
    dist = torch.linalg.vector_norm(vec, dim=1)
    sd = (vec / dist[:, None]).contiguous()
    s_max = torch.where(idx % 5 == 1, -1.0, dist * 0.9999)
    return o, d, t_min, t_max, sd, s_max


def phase_kernels(report, scene, bvh, dev):
    def first_hit(o0, d0):
        h = walk_cuda(bvh, o0, d0, 0.0, 1e30, any_hit=False)
        return h.t, h.hit

    o, d, t_min, t_max, sd, s_max = _scene_rays(first_hit, "small", dev)
    n = o.shape[0]
    kc = walk_cuda(bvh, o, d, t_min, t_max, any_hit=False)
    pc = walk_plain(bvh, o, d, t_min, t_max, any_hit=False)
    ka = walk_cuda(bvh, o, sd, t_min, s_max, any_hit=True)
    pa = walk_plain(bvh, o, sd, t_min, s_max, any_hit=True)
    torch.cuda.synchronize()
    check(torch.equal(kc.hit, pc.hit), "closest: hit differs from plain")
    check(torch.equal(kc.tri, pc.tri), "closest: tri differs from plain")
    m = kc.hit
    rel_t = float(((kc.t[m] - pc.t[m]).abs()
                   / pc.t[m].abs().clamp(min=1e-30)).max())
    err_c = float(torch.stack([(kc.t[m] - pc.t[m]).abs().max(),
                               (kc.u[m] - pc.u[m]).abs().max(),
                               (kc.v[m] - pc.v[m]).abs().max()]).max())
    err_u = float((kc.u[m] - pc.u[m]).abs().max())
    check(rel_t <= 1e-4 and err_u <= 2e-3,
          f"closest: t rel {rel_t} / u abs {err_u} over the bar")
    check(torch.equal(ka.hit, pa.hit), "any: hit differs from plain")
    err_a = float((ka.hit != pa.hit).float().max())
    check(not ka.hit[s_max < 0].any(), "any: a dead ray hit")

    # brute force on a 64k subset (every 16th ray)
    sub = torch.arange(0, n, 16, device=dev)
    bc = intersect_closest_brute(scene.triangles, o[sub], d[sub],
                                 t_min[sub], t_max[sub])
    hit_mis = int((kc.hit[sub] != bc.hit).sum())
    tri_diff = (kc.tri[sub] != bc.tri) & bc.hit & kc.hit[sub]
    tie_ok = bool(((kc.t[sub] - bc.t).abs()[tri_diff]
                   <= 1e-4 * bc.t.abs()[tri_diff]).all())
    ba = intersect_closest_brute(scene.triangles, o[sub], sd[sub],
                                 t_min[sub], s_max[sub])
    any_mis = int((ka.hit[sub] != ba.hit).sum())
    allowed = sub.numel() // 10000  # rays grazing a shared edge
    check(hit_mis <= allowed and tie_ok and any_mis <= allowed,
          f"brute: {hit_mis} closest hit mismatches, ties ok {tie_ok}, "
          f"{any_mis} any-hit mismatches (allowed {allowed})")

    # times and bounds at the main path's batch: one 512x512 batch of
    # bounce rays
    b = slice(BATCH, 2 * BATCH)
    args = {"closest": (o[b], d[b], t_min[b], t_max[b]),
            "any": (o[b], sd[b], t_min[b], s_max[b])}
    table = bvh.nodes.numel() * 4
    out = {}
    for kind, a in args.items():
        any_hit = kind == "any"
        ms = time_ms(lambda: walk_cuda(bvh, *a, any_hit), 20)
        plain_ms = time_ms(lambda: walk_plain(bvh, *a, any_hit), 2)
        _, rows = walk_plain(bvh, *a, any_hit, with_stats=True)
        live = int((a[3] >= 0).sum())
        bms, by = bound(BATCH * (RAY_IN + RAY_OUT) + table,
                        int(rows.sum()) * OPS_ROW)
        out[kind] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "rows_per_live_ray":
                     int(rows.sum()) / max(live, 1)}
    prim = time_ms(lambda: walk_cuda(bvh, o[:BATCH], d[:BATCH],
                                     t_min[:BATCH], t_max[:BATCH], False), 20)
    report["kernels"] = {
        "rays": n, "closest_max_abs_err": err_c, "closest_t_rel": rel_t,
        "any_max_abs_err": err_a, "brute_subset": sub.numel(),
        "brute_closest_hit_mismatch": hit_mis,
        "brute_closest_tri_ties": int(tri_diff.sum()),
        "brute_any_mismatch": any_mis, "batch": out,
        "primary_closest_ms": prim,
    }
    c, a = out["closest"], out["any"]
    print(f"[3 kernels] {n} rays: closest == plain (max abs err {err_c:.3g},"
          f" t rel {rel_t:.3g}), any == plain; brute {sub.numel()} rays: "
          f"{hit_mis} hit / {any_mis} any mismatches, "
          f"{int(tri_diff.sum())} tri ties; {BATCH}-ray bounce batch: "
          f"closest {c['ms']:.4f} ms (plain {c['plain_ms']:.1f} ms, bound "
          f"{c['bound_ms']:.4f} ms by {c['bound_by']}, "
          f"{c['rows_per_live_ray']:.1f} rows/ray), any {a['ms']:.4f} ms "
          f"(plain {a['plain_ms']:.1f} ms, bound {a['bound_ms']:.4f} ms by "
          f"{a['bound_by']}), primary closest {prim:.4f} ms", flush=True)
    return {kind: dict(v, max_abs_err=err_c if kind == "closest" else err_a)
            for kind, v in out.items()}


def _render_pair(scene, bvh, which, dev, tag):
    """64x64, 2-sample render on the card and on the CPU; fails unless they
    agree."""
    cfg = PTConfig(max_path_length=5, count_rays=True)
    cam = bench.bench_camera(64, 64, which)
    out = {}
    for where, s, bv, c in (("cuda", scene, bvh, cam.to(dev)),
                            ("cpu", scene.to("cpu"), bvh.to("cpu"), cam)):
        img, rays = render_accumulate(s, bv, c, 64, 64, 0, 2, cfg)
        out[where] = (img.cpu().numpy(), float(rays))
    a, ra = out["cuda"]
    b, rb = out["cpu"]
    rel = float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6))
    ray_rel = abs(ra - rb) / max(rb, 1.0)
    check(np.isfinite(a).all(), f"{tag}: non-finite pixels on the card")
    check(rel < IMAGE_BAR and ray_rel < 5e-3,
          f"{tag}: image rel diff {rel} / ray count rel {ray_rel}")
    return {"image_rel_diff": rel, "rays_cuda": ra, "rays_cpu": rb}


def phase_slice(report, scene, bvh, dev):
    r = _render_pair(scene, bvh, "small", dev, "slice")
    report["slice"] = r
    print(f"[4 slice] 64x64 2spp cuda vs cpu: image rel diff "
          f"{r['image_rel_diff']:.3g} (bar {IMAGE_BAR}), rays "
          f"{r['rays_cuda']:.0f} vs {r['rays_cpu']:.0f}", flush=True)


def _check_bench_row(r, tag):
    check(r["finite"], f"{tag}: non-finite pixels")
    check(r["image"].shape == (r["width"] * r["height"], 3),
          f"{tag}: image shape {tuple(r['image'].shape)}")
    check(r["mean_radiance"] > 0.0, f"{tag}: black image")


def _save(r, name):
    img = r["image"].reshape(r["height"], r["width"], 3).cpu().numpy()
    save_png(os.path.join(REPO, "out", name), img / (1.0 + img))


def phase_main(report, scene, bvh, dev):
    persistent.reset_launch_counts()
    instanced.reset_launch_counts()
    rows = {size: bench.measure(size, scene, bvh, device=dev)
            for size in ("512", "1080p")}
    launches = dict(persistent.launch_counts)
    check(not any(instanced.launch_counts.values()),
          f"small scene launched the two-level walk: "
          f"{instanced.launch_counts}")
    report["main"] = {s: {k: v for k, v in r.items() if k != "image"}
                      for s, r in rows.items()}
    report["main_launches"] = launches
    for size, r in rows.items():
        _check_bench_row(r, f"main {size}")
        lc = r["launches"]
        check(lc["widerow_closest"] > 0 and lc["widerow_any"] > 0,
              f"main {size}: kernel launches {lc}")
        print(f"[5 main {size}] {r['value']} Mrays/s, {r['rays']:.0f} rays "
              f"in {r['seconds']:.3f}s, mean radiance "
              f"{r['mean_radiance']:.5f}, timed-run launches "
              f"widerow closest {lc['widerow_closest']} any "
              f"{lc['widerow_any']}", flush=True)
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"main path did not launch both kernels: {launches}")
    _save(rows["512"], "torch_bench_512.png")
    report["main_profile"] = _print_profile(
        "5 main profile small", _profile_sample(scene, bvh, "small", dev))
    return launches


def phase_inst_build(report):
    out, secs = {}, {}
    for key, which, rb in (("big", "big", 0.0), ("city", "city", 0.0),
                           ("city_rebraid4", "city", 4.0)):
        t0 = time.time()
        out[key] = bench.build_bench_scene(which, rb)
        secs[key] = time.time() - t0
    t0 = time.time()
    world = bench.bench_scene_builder(scene="city").compile().triangles
    secs["city_flattened"] = time.time() - t0
    report["inst_build"] = {
        "seconds": secs, "city_world_triangles": world.count,
        **{k: {"entries": a.num_entries, "blas_rows": list(a.nodes.shape),
               "blas_triangles": s.num_triangles, "max_depth": a.max_depth}
           for k, (s, a) in out.items()}}
    for k, (s, a) in out.items():
        print(f"[6 inst build] {k}: {a.num_entries} entries, BLAS tables "
              f"{tuple(a.nodes.shape)} ({a.nodes.numel() * 4 / 1e6:.2f} MB),"
              f" {s.num_triangles} BLAS triangles, built in "
              f"{secs[k]:.3f}s", flush=True)
    print(f"[6 inst build] city flattened: {world.count} world triangles in "
          f"{secs['city_flattened']:.2f}s", flush=True)
    return out, world


def _walk_route(acc, route, o, d, t_min, t_max, any_hit, plain=False):
    walk = walk_instanced_plain if plain else walk_instanced_cuda
    if route == "sorted":
        h, ent = walk_tlas(walk, acc, o, d, t_min, t_max, any_hit)
    else:
        h, ent = walk(acc, o, d, t_min, t_max, any_hit, route=route)
    return h, ent


def _edge_margin(h):
    """Distance of each hit's barycentrics from the triangle's edges."""
    return torch.minimum(torch.minimum(h.u, h.v), 1.0 - h.u - h.v)


def _brute_mismatches(world, kc, ka, sub, o, d, sd, t_min, t_max, s_max):
    """Closest and any-hit mismatches of the walk against brute force over
    the world triangles on the rays `sub`; t agrees within 1e-4 relative
    plus 1e-4 absolute (the rays' t_min). A mismatch is explained when the
    hit that the other side missed lies within 1e-4 (barycentric) of a
    triangle edge, where Baldwin-Weber tests are not watertight (a ray from
    9 units away resolves a small sphere's edge only to ~1e-5), or within
    1e-2 of the ray's origin: bounce rays leave a surface inside an
    overlapping sphere, and at |p| ~ 5 float32 positions resolve such short,
    often grazing, distances only to ~1e-6 / |cos|."""
    bc = intersect_closest_brute(world, o[sub], d[sub], t_min[sub],
                                 t_max[sub])
    k = HitInfo(t=kc.t[sub], tri=kc.tri[sub], u=kc.u[sub], v=kc.v[sub],
                hit=kc.hit[sub])
    both = bc.hit & k.hit
    t_mis = both & ((k.t - bc.t).abs() > 1e-4 * bc.t.abs() + 1e-4)
    walk_missed = (bc.hit & ~k.hit) | (t_mis & (bc.t < k.t))
    brute_missed = (k.hit & ~bc.hit) | (t_mis & (k.t < bc.t))
    near = (k.hit & (k.t < 1e-2)) | (bc.hit & (bc.t < 1e-2))
    closest = walk_missed | brute_missed
    explained = near | (walk_missed & (_edge_margin(bc) < 1e-4)) | (
        brute_missed & (_edge_margin(k) < 1e-4))
    ba = intersect_closest_brute(world, o[sub], sd[sub], t_min[sub],
                                 s_max[sub])
    a = HitInfo(t=ka.t[sub], tri=ka.tri[sub], u=ka.u[sub], v=ka.v[sub],
                hit=ka.hit[sub])
    any_mis = a.hit != ba.hit
    any_explained = (
        (ba.hit & ((_edge_margin(ba) < 1e-4) | (ba.t < 1e-2)))
        | (a.hit & ((_edge_margin(a) < 1e-4) | (a.t < 1e-2))))
    return {"closest": int(closest.sum()), "any": int(any_mis.sum()),
            "total": int(closest.sum() + any_mis.sum()),
            "unexplained": int((closest & ~explained).sum()
                               + (any_mis & ~any_explained).sum()),
            "phase3_allowance": sub.numel() // 10000}


def _inst_kernels_one(acc, world, dev, tag, timing):
    def first_hit(o0, d0):
        h, _ = walk_instanced_cuda(acc, o0, d0, 0.0, 1e30, False, "nearest")
        return h.t, h.hit

    o, d, t_min, t_max, sd, s_max = _scene_rays(first_hit, "city", dev)
    n = o.shape[0]
    allowed = math.ceil(n / 10000)
    res, errs = {}, {}
    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        dd, tm = (sd, s_max) if any_hit else (d, t_max)
        for route in ROUTES:
            k, ke = _walk_route(acc, route, o, dd, t_min, tm, any_hit)
            p, pe = _walk_route(acc, route, o, dd, t_min, tm, any_hit,
                                plain=True)
            torch.cuda.synchronize()
            key = f"{kind}_{route}"
            check(torch.equal(k.hit, p.hit), f"{tag} {key}: hit != plain")
            check(not k.hit[tm < 0].any(), f"{tag} {key}: a dead ray hit")
            if any_hit:
                errs[key] = float((k.hit != p.hit).float().max())
            else:
                for f in ("t", "u", "v", "tri"):
                    check(torch.equal(getattr(k, f), getattr(p, f)),
                          f"{tag} {key}: {f} != plain")
                check(torch.equal(ke, pe), f"{tag} {key}: entry != plain")
                m = k.hit
                errs[key] = float(torch.stack([
                    (getattr(k, f)[m] - getattr(p, f)[m]).abs().max()
                    for f in ("t", "u", "v")]).max()) if m.any() else 0.0
            res[key] = k
    # the routes compute one function: they agree up to exact ties in t
    route_mis = {}
    for kind in ("closest", "any"):
        a = res[f"{kind}_nearest"]
        for route in ("build", "sorted"):
            b = res[f"{kind}_{route}"]
            mis = int((a.hit != b.hit).sum())
            if kind == "closest":
                both = a.hit & b.hit
                mis += int(((a.t - b.t).abs() > 1e-6 * a.t.abs())[both].sum())
            route_mis[f"{kind}_{route}"] = mis
    check(all(v <= allowed for v in route_mis.values()),
          f"{tag}: routes disagree {route_mis} (allowed {allowed})")

    # brute force over the flattened world triangles, 4,096-ray subset
    sub = torch.arange(0, n, n // 4096, device=dev)[:4096]
    brute = _brute_mismatches(world, res["closest_nearest"],
                              res["any_nearest"], sub, o, d, sd, t_min,
                              t_max, s_max)
    b_allowed = max(1, sub.numel() // 1000)
    check(brute["unexplained"] == 0 and brute["total"] <= b_allowed,
          f"{tag} brute: {brute} (allowed {b_allowed}, all explained)")
    out = {"rays": n, "allowed": allowed, "route_mismatches": route_mis,
           "max_abs_err": errs, "brute_subset": sub.numel(),
           "brute": brute, "brute_allowed": b_allowed, "times": {}}

    # times at one 262,144-ray bounce batch
    b = slice(BATCH, 2 * BATCH)
    tables = acc.nodes.numel() * 4 + acc.num_entries * ENTRY_BYTES
    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        dd, tm = (sd[b], s_max[b]) if any_hit else (d[b], t_max[b])
        ob, tmin = o[b], t_min[b]
        for route in ROUTES:
            if route == "sorted":
                # the kernel alone on rays the tlas route has sorted; the
                # whole route (glue included) is timed beside it
                route_ms = time_ms(lambda: walk_tlas(
                    walk_instanced_cuda, acc, ob, dd, tmin, tm, any_hit), 5)
                first, has = instanced._nearest_entry(acc, ob, dd, tmin, tm)
                perm = torch.argsort(torch.where(has, first,
                                                 acc.num_entries),
                                     stable=True)
                args = (ob[perm].contiguous(), dd[perm].contiguous(),
                        tmin[perm].contiguous(),
                        torch.where(has, tm, -1.0)[perm].contiguous())
            else:
                route_ms = None
                args = (ob, dd, tmin, tm)
            ms = time_ms(lambda: walk_instanced_cuda(
                acc, *args, any_hit, route), 10)
            entry = {"ms": ms, "route_ms": route_ms}
            if timing:
                entry["plain_ms"] = time_ms(lambda: walk_instanced_plain(
                    acc, *args, any_hit, route), 1, warm=False)
                _, _, rows, visits = walk_instanced_plain(
                    acc, *args, any_hit, route, with_stats=True)
                live = int((args[3] >= 0).sum())
                scans = live if route == "build" else live + int(
                    visits.sum())
                ops = (int(rows.sum()) * OPS_ROW
                       + int(visits.sum()) * OPS_VISIT
                       + scans * acc.num_entries * OPS_SLAB)
                bms, by = bound(BATCH * (RAY_IN + RAY_OUT + ENTRY_OUT)
                                + tables, ops)
                entry.update(bound_ms=bms, bound_by=by,
                             rows_per_live_ray=int(rows.sum()) / max(live, 1),
                             entries_per_live_ray=int(visits.sum())
                             / max(live, 1))
            out["times"][f"{kind}_{route}"] = entry
    return out


def phase_inst_kernels(report, built, world, dev):
    world = world.to(dev)
    out = {}
    for key in ("city", "city_rebraid4"):
        acc = built[key][1].to(dev)
        out[key] = _inst_kernels_one(acc, world, dev, key,
                                     timing=key == "city")
        r = out[key]
        t = r["times"]
        print(f"[7 inst kernels {key}] {r['rays']} rays: every route == "
              f"plain (closest t/u/v/tri/entry identical, any hit "
              f"identical); routes disagree on {r['route_mismatches']} "
              f"(allowed {r['allowed']}); brute {r['brute_subset']} rays: "
              f"{r['brute']} (allowed {r['brute_allowed']}, each at an edge "
              f"or within 1e-2 of the origin)", flush=True)
        for name, e in t.items():
            extra = (f", plain {e['plain_ms']:.1f} ms, bound "
                     f"{e['bound_ms']:.4f} ms by {e['bound_by']}, "
                     f"{e['rows_per_live_ray']:.1f} rows and "
                     f"{e['entries_per_live_ray']:.2f} entries per live ray"
                     if "plain_ms" in e else "")
            route = (f", whole route {e['route_ms']:.3f} ms"
                     if e["route_ms"] is not None else "")
            print(f"[7 inst kernels {key}] {BATCH}-ray bounce batch "
                  f"{name}: {e['ms']:.4f} ms{route}{extra}", flush=True)
    report["inst_kernels"] = out
    return out


def phase_inst_slice(report, built, dev):
    scene, acc = built["big"]
    r = _render_pair(scene.to(dev), acc.to(dev), "big", dev, "inst slice")
    report["inst_slice"] = r
    print(f"[8 inst slice] big 64x64 2spp cuda vs cpu: image rel diff "
          f"{r['image_rel_diff']:.3g} (bar {IMAGE_BAR}), rays "
          f"{r['rays_cuda']:.0f} vs {r['rays_cpu']:.0f}", flush=True)


def _profile_sample(scene, acc, which, dev):
    """One 512x512 sample under torch.profiler: CUDA kernels, device busy
    time (union of kernel intervals) and the walk kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    cam = bench.bench_camera(512, 512, which).to(dev)
    cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH, count_rays=True)
    render_accumulate(scene, acc, cam, 512, 512, 0, 1, cfg)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_accumulate(scene, acc, cam, 512, 512, 1, 1, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_accumulate(scene, acc, cam, 512, 512, 1, 1, cfg)
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {"wall_ms": wall * 1e3, "kernels": "not measured"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    walk = [e for e in kern if "_walk" in e.name]
    walk_us = sum(e.time_range.end - e.time_range.start for e in walk)
    return {"wall_ms": wall * 1e3, "kernels": len(kern),
            "device_busy_ms": busy / 1e3, "walk_ms": walk_us / 1e3,
            "walk_launches": len(walk),
            "walk_share_of_busy": walk_us / busy if busy else None,
            "idle_share": 1.0 - busy / 1e3 / (wall * 1e3)}


def _print_profile(tag, p):
    if p["kernels"] == "not measured":
        print(f"[{tag}] torch.profiler showed no device time: not measured",
              flush=True)
    else:
        print(f"[{tag}] one 512x512 sample: wall {p['wall_ms']:.2f} ms, "
              f"{p['kernels']} CUDA kernels, device busy "
              f"{p['device_busy_ms']:.2f} ms (idle share "
              f"{p['idle_share']:.3f}), walk kernels {p['walk_ms']:.3f} ms "
              f"in {p['walk_launches']} launches = "
              f"{p['walk_share_of_busy']:.4f} of busy time", flush=True)
    return p


def phase_inst_main(report, built, dev):
    runs = (("big", "big", None, False), ("city", "city", None, False),
            ("big_nopersist", "big", False, False),
            ("city_tlas", "city", None, True))
    persistent.reset_launch_counts()
    instanced.reset_launch_counts()
    rows = {}
    try:
        for key, which, persist, tlas in runs:
            scene, acc = built[which]
            acc.use_tlas = tlas
            instanced.set_persistent(persist)
            torch.cuda.reset_peak_memory_stats(dev)
            rows[key] = bench.measure("512", scene, acc, device=dev,
                                      which=which)
            rows[key]["peak_memory_bytes"] = \
                torch.cuda.max_memory_allocated(dev)
    finally:
        instanced.set_persistent(None)
        for _, acc in built.values():
            acc.use_tlas = False
    launches = dict(instanced.launch_counts)
    check(not any(persistent.launch_counts.values()),
          f"two-level scenes launched kernel 1: {persistent.launch_counts}")
    check(all(v > 0 for v in launches.values()),
          f"two-level main path left a route unlaunched: {launches}")
    for key, r in rows.items():
        _check_bench_row(r, f"inst main {key}")
        lc = {k: v for k, v in r["launches"].items() if v}
        print(f"[9 inst main {key}] {r['metric']} {r['value']} Mrays/s, "
              f"{r['rays']:.0f} rays in {r['seconds']:.3f}s, mean radiance "
              f"{r['mean_radiance']:.5f}, peak memory "
              f"{r['peak_memory_bytes'] / 1e9:.2f} GB, timed-run launches "
              f"{lc}", flush=True)
    _save(rows["big"], "torch_bench_big.png")
    _save(rows["city"], "torch_bench_city.png")
    prof = {}
    for which in ("big", "city"):
        scene, acc = built[which]
        prof[which] = _print_profile(f"9 inst profile {which}",
                                     _profile_sample(scene, acc, which, dev))
    report["inst_main"] = {k: {f: v for f, v in r.items() if f != "image"}
                           for k, r in rows.items()}
    report["inst_main_launches"] = launches
    report["inst_profile"] = prof
    return launches


def main():
    t_start = time.time()
    report = {}
    phase_environment(report)
    dev = torch.device("cuda", 0)
    phase_build(report)
    t0 = time.time()
    scene, bvh = bench.build_bench_scene()
    secs = time.time() - t0
    report["scene_build_seconds"] = secs
    print(f"[2 scene] small bench scene built on the host in {secs:.3f}s: "
          f"{scene.num_triangles} triangles, {bvh.nodes.shape[0]} rows, "
          f"max depth {bvh.max_depth}", flush=True)
    scene, bvh = scene.to(dev), bvh.to(dev)
    k1 = phase_kernels(report, scene, bvh, dev)
    phase_slice(report, scene, bvh, dev)
    launches = phase_main(report, scene, bvh, dev)
    built, world = phase_inst_build(report)
    built = {k: (s.to(dev), a.to(dev)) for k, (s, a) in built.items()}
    inst = phase_inst_kernels(report, built, world, dev)
    phase_inst_slice(report, built, dev)
    inst_launches = phase_inst_main(report, built, dev)

    kernels = [
        {"name": f"widerow_walk_{kind}", "route": "cuda",
         "source": "gfxexp_torch/csrc/widerow_traverse.cu",
         "replaces": "gfxexp_tpu/accel/pallas_persistent.py:352",
         "launches": launches[kind], "max_abs_err": k1[kind]["max_abs_err"],
         "ms": k1[kind]["ms"], "plain_ms": k1[kind]["plain_ms"],
         "bound_ms": k1[kind]["bound_ms"], "bound_by": k1[kind]["bound_by"],
         "library_ms": None}
        for kind in ("closest", "any")]
    times = inst["city"]["times"]
    for kind in ("closest", "any"):
        for route in ROUTES:
            key = f"{kind}_{route}"
            t = times[key]
            kernels.append({
                "name": f"instanced_walk_{key}", "route": "cuda",
                "source": "gfxexp_torch/csrc/instanced_traverse.cu",
                "replaces": REPLACES[route],
                "launches": inst_launches[key],
                "max_abs_err": max(inst[s]["max_abs_err"][key]
                                   for s in inst),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None})
    report["seconds"] = time.time() - t_start
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({**report, "kernel_records": kernels}, f, indent=1,
                  default=str)
    print(f"[done] all phases passed in {report['seconds']:.1f}s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(report["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
