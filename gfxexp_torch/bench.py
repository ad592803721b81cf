"""Path-tracing ray throughput of the port on one CUDA device.

The configuration is bench.py's (the JAX package's benchmark), procedural
branch: floor + area light + two spheres, NEE+MIS path tracing with max path
length 5, 16 timed samples, at 512x512 (render_accumulate) and at 1920x1080
(8 tiles of 259,200 lanes through render_tile_accumulate). Mrays/s counts the
closest-hit and shadow rays the integrator traced (cfg.count_rays), divided
by the wall time of the timed run fenced with torch.cuda.synchronize().

    python -m gfxexp_torch.bench            # both sizes, bench.py's line
    python -m gfxexp_torch.bench 512        # one size
    python -m gfxexp_torch.bench 1080p

Prints one JSON line of bench.py's shape: metric, value, unit, vs_baseline.
Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from gfxexp_torch.accel import persistent
from gfxexp_torch.render.camera import make_camera
from gfxexp_torch.render.pathtrace import (
    PTConfig,
    render_accumulate,
    render_tile_accumulate,
)
from gfxexp_torch.scene.builder import SceneBuilder, affine
from gfxexp_torch.scene.compile import compile_scene

MAX_PATH_LENGTH = 5
TIMED_SAMPLES = 16
TARGET_MRAYS = 100.0  # bench.py's north-star, Mrays/s per device
HD_TILES = 8
SIZES = {"512": (512, 512), "1080p": (1920, 1080)}


def bench_scene_builder(b=None):
    """Populate a SceneBuilder (the port's by default) with bench.py's
    procedural scene: a 2x2 floor, a 0.6x0.6 light of emittance 300 facing
    down at y = 1.5, a diffuse-specular sphere (r 0.25) and a Lambert sphere
    (r 0.2). Any builder with the same API works, so tests can build the
    identical scene in the JAX package."""
    b = SceneBuilder() if b is None else b
    floor = b.add_lambert_material((0.8, 0.8, 0.8))
    light = b.add_lambert_material((0.0, 0.0, 0.0),
                                   emittance=(300.0, 300.0, 300.0))
    side = 2.0
    b.add_instance(b.add_rectangle(side, side, floor))
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    b.add_instance(b.add_rectangle(0.6 * side / 2, 0.6 * side / 2, light),
                   affine(rotation=flip, translation=[0.0, 1.5, 0.0]))
    mat_a = b.add_diffuse_specular_material((0.7, 0.4, 0.2), (0.2,) * 3, 0.7)
    b.add_instance(b.add_sphere(0.25, mat_a),
                   affine(translation=[-0.3, 0.25, 0.0]))
    mat_b = b.add_lambert_material((0.3, 0.6, 0.3))
    b.add_instance(b.add_sphere(0.2, mat_b),
                   affine(translation=[0.35, 0.2, 0.0]))
    return b


def build_bench_scene():
    """(SceneData, WideRowBVH) of the bench scene on the CPU."""
    return compile_scene(bench_scene_builder(), arity=4, max_leaf=4,
                         traversal="widerow")


def bench_camera(width: int, height: int):
    return make_camera([0.0, 0.8, 1.6], fov_y=np.deg2rad(45),
                       aspect=width / height, target=[0.0, 0.2, 0.0])


def render_frame(scene, bvh, camera, width, height, start_idx, n_samples,
                 cfg):
    """Mean radiance [H*W, 3] and total rays of n_samples samples, the way
    bench.py drives each size: one render_accumulate at 512x512, a loop of
    render_tile_accumulate over HD_TILES tiles at 1080p (lane order there is
    raw row-major, since 1080 is not a multiple of the 16-pixel block)."""
    if (width, height) == SIZES["512"]:
        return render_accumulate(scene, bvh, camera, width, height,
                                 start_idx, n_samples, cfg)
    n = width * height
    lanes = n // HD_TILES
    assert lanes * HD_TILES == n
    imgs, rays = [], torch.zeros((), device=scene.device)
    for ti in range(HD_TILES):
        img, nr = render_tile_accumulate(scene, bvh, camera, width, height,
                                         ti * lanes, lanes, start_idx,
                                         n_samples, cfg)
        imgs.append(img)
        rays = rays + nr
    return torch.cat(imgs) / n_samples, rays


def measure(size: str, scene=None, bvh=None, device="cuda") -> dict:
    """Time TIMED_SAMPLES samples at `size` ('512' or '1080p') on `device`.
    Returns bench.py's JSON fields plus the run's details."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("gfxexp_torch.bench measures on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    width, height = SIZES[size]
    if scene is None:
        scene, bvh = build_bench_scene()
    scene, bvh = scene.to(dev), bvh.to(dev)
    camera = bench_camera(width, height).to(dev)
    cfg = PTConfig(max_path_length=MAX_PATH_LENGTH, count_rays=True)

    # warm-up: nothing compiles in the port, but the first sample builds
    # the kernel and fills the caching allocator
    render_frame(scene, bvh, camera, width, height, 0, 1, cfg)
    torch.cuda.synchronize(dev)
    before = dict(persistent.launch_counts)
    t0 = time.perf_counter()
    img, rays = render_frame(scene, bvh, camera, width, height, 100,
                             TIMED_SAMPLES, cfg)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    launches = {k: persistent.launch_counts[k] - before[k] for k in before}
    total_rays = float(rays)
    mrays = total_rays / elapsed / 1e6
    return {
        "metric": f"pt_ray_throughput_{size}",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / TARGET_MRAYS, 4),
        "seconds": elapsed,
        "rays": total_rays,
        "mean_radiance": float(img.mean()),
        "finite": bool(torch.isfinite(img).all()),
        "launches": launches,  # kernel launches of the timed run
        "device": torch.cuda.get_device_name(dev),
        "image": img,
        "width": width,
        "height": height,
    }


def _line(row: dict) -> dict:
    return {k: row[k] for k in ("metric", "value", "unit", "vs_baseline")}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sizes = [s for s in SIZES if s in argv] or list(SIZES)
    scene, bvh = build_bench_scene()
    rows = {}
    for size in sizes:
        rows[size] = measure(size, scene, bvh)
        r = rows[size]
        sys.stderr.write(
            f"bench: {size} {scene.num_triangles} tris, {TIMED_SAMPLES} "
            f"samples in {r['seconds']:.3f}s, {r['rays'] / 1e6:.2f} Mrays, "
            f"mean radiance {r['mean_radiance']:.4f}, launches "
            f"{r['launches']} on {r['device']}\n")
    if len(sizes) == 1:
        print(json.dumps(_line(rows[sizes[0]])))
        return
    hd = rows["1080p"]
    print(json.dumps({
        "metric": "pt_ray_throughput",
        "value": hd["value"],
        "unit": "Mrays/s",
        "vs_baseline": hd["vs_baseline"],
        "extra": {"resolution": "1920x1080",
                  "mrays_512": rows["512"]["value"]},
    }))


if __name__ == "__main__":
    main()
