#!/usr/bin/env python3
"""Smoke run of the gfxexp_torch port on one CUDA device.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: the CUDA kernels from gfxexp_torch/csrc with nvcc and the
     native BVH builder with g++, then the bench scene on the host;
  3. kernel vs plain: the wide-row walk (closest and any hit) on ~1M bench
     scene rays against its plain PyTorch version, and both against brute
     force on a 64k-ray subset; times at the main path's batch size;
  4. slice: a 64x64, 2-sample render on the card against the same render on
     the CPU (mean relative image difference < 5e-3, rays within 0.5%);
  5. main path: gfxexp_torch.bench.measure at 512x512 and 1920x1080 with the
     kernels' launch counts, image checks and out/torch_bench_512.png.
The last lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gfxexp_torch import bench
from gfxexp_torch.accel import native, persistent
from gfxexp_torch.accel.persistent import walk_cuda, walk_plain
from gfxexp_torch.accel.traverse import intersect_closest_brute
from gfxexp_torch.csrc import build
from gfxexp_torch.render.camera import generate_rays_for_lanes
from gfxexp_torch.render.pathtrace import PTConfig, render_accumulate
from gfxexp_torch.utils.image_io import save_png

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 7
BATCH = 512 * 512  # the main path's ray batch at 512x512
IMAGE_BAR = 5e-3  # mean relative image difference (golden-test bar)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm call."""
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
    check(native.native_available(), "native BVH builder did not build")
    native_secs = time.time() - t0
    t0 = time.time()
    build.load_library("widerow_traverse")
    secs = time.time() - t0
    ptxas = [ln.strip() for ln in build.build_log.get(
        "widerow_traverse", "").splitlines()
        if "registers" in ln or "spill" in ln]
    report["build"] = {"seconds": secs, "ptxas": ptxas,
                       "native_bvh_seconds": native_secs}
    print(f"[2 build] gfxexp_torch/csrc/widerow_traverse.cu built in "
          f"{secs:.2f}s (nvcc {build.build_seconds['widerow_traverse']:.2f}s)"
          f"; ptxas: {' | '.join(ptxas)}; native BVH builder (g++) "
          f"{native_secs:.2f}s", flush=True)


def _bench_rays(bvh, dev):
    """1M rays over the bench scene: one batch of jittered primary rays at
    512x512, three batches of random bounce directions from the primary
    hits; every 7th ray dead (t_max < 0). Shadow rays from the same origins
    to random points on the light, every 5th dead."""
    rng = np.random.default_rng(SEED)
    cam = bench.bench_camera(512, 512).to(dev)
    jit = torch.from_numpy(rng.random((2, BATCH), np.float32)).to(dev)
    lane = torch.arange(BATCH, device=dev)
    o0, d0 = generate_rays_for_lanes(cam, 512, 512, lane, jit[0], jit[1])
    h0 = walk_cuda(bvh, o0, d0, 0.0, 1e30, any_hit=False)
    p = torch.where(h0.hit[:, None], o0 + h0.t[:, None] * d0, o0)
    dirs = rng.normal(size=(3 * BATCH, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = torch.cat([o0, p, p, p]).contiguous()
    d = torch.cat([d0, torch.from_numpy(dirs).to(dev)]).contiguous()
    n = o.shape[0]
    idx = torch.arange(n, device=dev)
    t_min = torch.where(idx < BATCH, 0.0, 1e-4)
    t_max = torch.where(idx % 7 == 3, -1.0, 1e30)
    # shadow rays towards the 0.6 x 0.6 light at y = 1.5
    xz = torch.from_numpy(rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32))
    target = torch.stack([xz[:, 0], torch.full((n,), 1.5), xz[:, 1]], 1)
    vec = target.to(dev) - o
    dist = torch.linalg.vector_norm(vec, dim=1)
    sd = (vec / dist[:, None]).contiguous()
    s_max = torch.where(idx % 5 == 1, -1.0, dist * 0.9999)
    return o, d, t_min, t_max, sd, s_max


def phase_kernels(report, scene, bvh, dev):
    o, d, t_min, t_max, sd, s_max = _bench_rays(bvh, dev)
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

    # times at the main path's batch: one 512x512 batch of bounce rays
    b = slice(BATCH, 2 * BATCH)
    args_c = (o[b], d[b], t_min[b], t_max[b])
    args_a = (o[b], sd[b], t_min[b], s_max[b])
    times = {
        "closest": (time_ms(lambda: walk_cuda(bvh, *args_c, False), 20),
                    time_ms(lambda: walk_plain(bvh, *args_c, False), 2)),
        "any": (time_ms(lambda: walk_cuda(bvh, *args_a, True), 20),
                time_ms(lambda: walk_plain(bvh, *args_a, True), 2)),
    }
    prim = time_ms(lambda: walk_cuda(bvh, o[:BATCH], d[:BATCH],
                                     t_min[:BATCH], t_max[:BATCH], False), 20)
    report["kernels"] = {
        "rays": n, "closest_max_abs_err": err_c, "closest_t_rel": rel_t,
        "any_max_abs_err": err_a, "brute_subset": sub.numel(),
        "brute_closest_hit_mismatch": hit_mis,
        "brute_closest_tri_ties": int(tri_diff.sum()),
        "brute_any_mismatch": any_mis, "times_ms": times,
        "primary_closest_ms": prim,
    }
    print(f"[3 kernels] {n} rays: closest == plain (max abs err {err_c:.3g},"
          f" t rel {rel_t:.3g}), any == plain; brute {sub.numel()} rays: "
          f"{hit_mis} hit / {any_mis} any mismatches, "
          f"{int(tri_diff.sum())} tri ties; {BATCH}-ray bounce batch: "
          f"closest {times['closest'][0]:.3f} ms (plain "
          f"{times['closest'][1]:.1f} ms), any {times['any'][0]:.3f} ms "
          f"(plain {times['any'][1]:.1f} ms), primary closest {prim:.3f} ms",
          flush=True)
    return err_c, err_a, times


def phase_slice(report, scene, bvh, dev):
    cfg = PTConfig(max_path_length=5, count_rays=True)
    cam = bench.bench_camera(64, 64)
    out = {}
    for where, s, bv, c in (("cuda", scene, bvh, cam.to(dev)),
                            ("cpu", scene.to("cpu"), bvh.to("cpu"), cam)):
        img, rays = render_accumulate(s, bv, c, 64, 64, 0, 2, cfg)
        out[where] = (img.cpu().numpy(), float(rays))
    a, ra = out["cuda"]
    b, rb = out["cpu"]
    rel = float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6))
    ray_rel = abs(ra - rb) / max(rb, 1.0)
    report["slice"] = {"image_rel_diff": rel, "rays_cuda": ra,
                       "rays_cpu": rb}
    check(np.isfinite(a).all(), "slice: non-finite pixels on the card")
    check(rel < IMAGE_BAR and ray_rel < 5e-3,
          f"slice: image rel diff {rel} / ray count rel {ray_rel}")
    print(f"[4 slice] 64x64 2spp cuda vs cpu: image rel diff {rel:.3g} "
          f"(bar {IMAGE_BAR}), rays {ra:.0f} vs {rb:.0f}", flush=True)


def phase_main(report, scene, bvh, dev):
    persistent.reset_launch_counts()
    rows = {size: bench.measure(size, scene, bvh, device=dev)
            for size in ("512", "1080p")}
    launches = dict(persistent.launch_counts)
    report["main"] = {s: {k: v for k, v in r.items() if k != "image"}
                      for s, r in rows.items()}
    report["main_launches"] = launches
    for size, r in rows.items():
        check(r["finite"], f"main {size}: non-finite pixels")
        check(r["image"].shape == (r["width"] * r["height"], 3),
              f"main {size}: image shape {tuple(r['image'].shape)}")
        check(r["mean_radiance"] > 0.0, f"main {size}: black image")
        check(r["launches"]["closest"] > 0 and r["launches"]["any"] > 0,
              f"main {size}: kernel launches {r['launches']}")
        print(f"[5 main {size}] {r['value']} Mrays/s, {r['rays']:.0f} rays "
              f"in {r['seconds']:.3f}s, mean radiance "
              f"{r['mean_radiance']:.5f}, timed-run launches "
              f"{r['launches']}", flush=True)
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"main path did not launch both kernels: {launches}")
    r = rows["512"]
    img = r["image"].reshape(r["height"], r["width"], 3).cpu().numpy()
    save_png(os.path.join(REPO, "out", "torch_bench_512.png"),
             img / (1.0 + img))
    report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return launches


def main():
    report = {}
    phase_environment(report)
    dev = torch.device("cuda", 0)
    phase_build(report)
    t0 = time.time()
    scene, bvh = bench.build_bench_scene()
    secs = time.time() - t0
    report["scene_build_seconds"] = secs
    print(f"[2 scene] bench scene built on the host in {secs:.3f}s: "
          f"{scene.num_triangles} triangles, {bvh.nodes.shape[0]} rows, "
          f"max depth {bvh.max_depth}", flush=True)
    scene, bvh = scene.to(dev), bvh.to(dev)
    err_c, err_a, times = phase_kernels(report, scene, bvh, dev)
    phase_slice(report, scene, bvh, dev)
    launches = phase_main(report, scene, bvh, dev)

    kernels = [
        {"name": f"widerow_walk_{kind}", "route": "cuda",
         "source": "gfxexp_torch/csrc/widerow_traverse.cu",
         "replaces": "gfxexp_tpu/accel/pallas_persistent.py:102",
         "launches": launches[kind], "max_abs_err": err,
         "ms": times[kind][0], "plain_ms": times[kind][1]}
        for kind, err in (("closest", err_c), ("any", err_a))]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({**report, "kernel_records": kernels}, f, indent=1,
                  default=str)
    print(json.dumps({"kernels": kernels}))
    print(report["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
