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
     brute force on a 64k-ray subset; times (the card alone: it spins
     while the host enqueues, since a launch takes longer on the host) and
     bounds at the main path's batch size, and the lane utilisation of its schedules on that batch
     (walk_trips.lane_steps: static grid, per-lane refill);
  4. slice: a 64x64, 2-sample render of the small scene on the card against
     the same render on the CPU (mean relative image difference < 5e-3, rays
     within 0.5%);
  5. main path: gfxexp_torch.bench.measure at 512x512 and 1920x1080 with
     kernel 1's launch counts, image checks and out/torch_bench_512.png;
  6. two-level build: bench.py's `big` and `city` (and `city rebraid4`)
     compiled instanced on the host;
  7. two-level kernel vs plain: the instanced walk on ~1M rays of `city`,
     with and without rebraid, and of `big`, for each route (nearest-first,
     build order, the ray-sorted tlas route), closest and any hit, against
     the plain version (exactly equal), the routes against each other, and
     brute force over the flattened world triangles on a 4,096-ray subset;
     each route's ms on one 262,144-ray bounce batch; on `city` (the
     kernels line's scene; only there) the plain version's ms,
     the bounds, the candidate entry
     boxes per live ray against the pick's kPick, the build order's lane
     utilisation under each schedule and the share of 32-entry union boxes
     rays enter (walk_trips.build_order_costs, group_shares), and ptxas's
     registers, spills and shared memory;
  8. two-level slice: `big` at 64x64, 2 samples, card against CPU;
  9. two-level main path: gfxexp_torch.bench.measure on `big` and `city`
     (nearest-first), `big nopersist` (build order) and `city tlas` (ray
     sorted) at 512x512 with the instanced kernels' launch counts (kernel
     1's must be 0 there), image checks, out/torch_bench_{big,city}.png, the
     walk kernels' share of device time (torch.profiler) and peak memory;
 10. skip build: `big` and `city` flattened into world triangles and
     compiled with traversal="skip" on the host (nodes, levels, table MB);
 11. skip kernels: the skip-link walk on ~1M `big` and `city` rays, every
     cursor scope (thread, warp, block), closest and any hit, against the
     plain version (t, u, v, tri exactly equal), the plain version against
     brute force over the world triangles on 4,096 rays, all again after 8
     frames of advance_frame (refit boxes); ms per 262,144-ray bounce batch
     per scope; on `city` before the refit (only there) the
     plain version's ms, nodes and triangles visited per ray, the node and
     triangle
     rows the batch reads (the bound's bytes), and the per-ray scope's
     dependent round trips to memory per live ray (mean, p99, max) under
     the parent's schedule and the kernel's (skiplink.skip_trips), and the
     warp scope's union steps and windows of 32 nodes per warp
     (walk_trips.warp_windows);
 12. animated slice: `big` after advance_frame at t = 0.5, 64x64, 2 samples,
     card against CPU (image rel diff < 5e-3, identical ray counts);
 13. animated main path: the path_tracing app's frame loop (advance_frame,
     render_sample, film) at 512x512 for 4 frames on `city` and `big`:
     update and pathTrace ms per frame, Mrays/s, peak memory, the skip
     kernel's launch counts (the thread scope's; kernels 1 and 3-5 must be
     0, and the warp and block scopes, which no user path takes, are 0 too),
     the update's per-step breakdown, one frame
     under torch.profiler, out/torch_anim_{city,big}.png;
 14. app CLI: `python -m gfxexp_torch.apps.path_tracing` at 128x128, 4
     frames, -stats, on a DSL scene with one animated instance; its PNG;
 15. single-level build: `big` and `city` flattened into world triangles,
     compiled as chunked wide rows and as quantized rows on the host
     (chunks, rows, table MB, host seconds);
 16. single-level kernels vs plain: kernel 2 (chunked wide rows) and the
     quantized walk, closest and any hit, on ~1M `big` and `city` rays
     against their plain versions (t, u, v, tri exactly equal), the plain
     versions against brute force over the world (for quantized rows the
     dequantized) triangles on 4,096 rays (rays that run within the plane
     of the triangle either side reports counted apart, at most one in
     100); the lane-group walk with 1, 2
     and 4 groups on ~1M small-scene rays against its plain version
     (exactly equal) and against the per-ray walk (equal t, tri only on
     ties), with its steps per group and the share of lanes that take
     part on the timed batch (walk_trips.group_steps); ms per 262,144-ray
     bounce batch, rows and chunks per ray; on `city` only, the plain
     version's ms, the rows the batch reads, the bound, the candidate
     chunk boxes per live ray against kPick, kernel 2's dependent round
     trips to memory per live ray (mean, p99, max) under the parent's
     schedule and the kernel's
     (persistent.chunked_trips), and ptxas's report of both kernels;
 17. single-level slice: `big` as chunked wide rows and as quantized rows at
     64x64, 2 samples, card against CPU;
 18. single-level main path: gfxexp_torch.bench.measure at 512x512 on `big
     widerow`, `big qrow`, `city qrow`, the small scene as quantized rows
     and the small scene with the switch off (`nopersist`), with the
     launch counts (kernels 2 and the quantized walk launched, kernel 1 and
     the lane-group walk not), image checks, peak memory and
     torch.profiler shares;
 19. G-buffer: render_gbuffer at 256x256 on the small scene (kernel 1) and
     on `big` animated after one advance_frame (kernel 6), the previous
     camera moved, on the card against the CPU: hit equal, tri, unit and
     material equal on >= 0.999 of pixels (the rest ties in t), position,
     normal, albedo and motion within GB_BARS; the walk's route and its
     launches;
 20. SVGF: 8 frames of svgf_frame at 128x128 on the card and on the CPU
     from the same G-buffers and lighting (mean relative difference <
     SVGF_BAR); the svgf app's frame loop at 1920x1080, 8 frames, on the
     small scene (static, kernel 1) and `big` animated (kernel 6): ms per
     frame of update, gbuffer, pathTrace and svgf (fenced), the walks'
     launches, one svgf and one gbuffer pass under torch.profiler (CUDA
     kernels, idle share), out/torch_svgf_{small,big_animated}.png;
 21. ReSTIR DI on 256 emitters over a floor with 16 spheres (built here):
     the classic and the rearchitected pipelines, 4 frames at 64x64 on the
     card against the CPU (image mean relative difference < 5e-3); at
     1920x1080, 4 frames each: ms per frame of gbuffer and restir, shadow
     rays per frame, kernel 1's launches per frame, the stages' routes
     (restir.kernel.* / restir.eager.*: the classic initial stream plain,
     the rearchitected one and every spatial pass by their kernels), one
     frame under torch.profiler, out/torch_restir_{classic,rearch}.png;
     then the svgf, restir_di -rearch and path_tracing -denoise CLIs at
     64x64, 4 frames, all three at once; their PNGs;
 22. ReGIR: 4 frames of build_cell_reservoirs and render_sample_regir at
     64x64, grid (8, 4, 8) x 64 slots, on the card against the CPU from the
     same inputs (each device its own state; selections equal on >= 0.999
     of slots, reservoir numbers within rtol 1e-4, images within 5e-3, ray
     and touch counts within 0.5%) on the 256-emitter scene (kernel 1) and
     on `big` animated, advanced on the CPU and copied (kernel 6); then the
     regir app's frame loop at 1920x1080 with the defaults (16^3 cells x
     512 slots) on the 256-emitter scene, 4 frames: ms per frame of
     buildCellReservoirs and pathTrace, one pass of each under
     torch.profiler, shadow rays and walk launches per frame, active
     cells, peak memory, out/torch_regir.png;
 23. NRC on the app's box: render_sample_nrc at 64x64 on the card against
     the CPU from the same weights (training masks, radiance, targets) and
     one train_on_frame with the same permutation (loss, parameters); the
     app's frame loop at 1920x1080, 16 frames with the triangle wave (the
     loss must fall) and 4 with the hash grid: ms per frame of
     pathTrace+infer and train, one pass of each profiled, walk launches,
     peak memory, the loss by frame, out/torch_nrc_*.png;
 24. the regir and neural_radiance_caching (-checkpoint) CLIs at 64x64, 4
     frames, at once; then neural_radiance_caching -resume from that
     checkpoint; their PNGs;
 25. textures and PTConfig: the textured scene (bench.build_textured_scene;
     its PNG and DDS files written here and loaded through load_texture)
     at 128x128, 2 samples, on the card against the CPU (image mean
     relative difference < 5e-3, ray counts equal) as wide rows (kernel 1)
     and skip links (kernel 6), plain and with bump mapping, texture LOD,
     solid-angle NEE and fused shadow rays together, with the probability
     texture and debug switches 0b1000_0101, and with 0xFF; fused against
     unfused on the card (rtol 1e-5, atol 1e-6, equal rays, 5 closest and
     no any-hit walks a sample); ReGIR's world-space grid and one frame on
     `big` two-level (kernel 5) against the same scene flattened;
 26. costs: the path_tracing app's frame loop on the textured scene at
     1920x1080, 4 frames plain and with -bump -texture-lod (ms per
     pathTrace, walk launches per frame, one frame under torch.profiler:
     CUDA kernels, idle share); the small scene at 512x512 with fused
     shadow rays off, on, on, off (Mrays/s, kernels and walk launches per
     sample: 5 + 4 unfused, 5 + 0 fused), and kernel 1 timed on one
     batch of bounce and shadow rays as N closest + N any against one
     closest over 2N; the default sample's kernels and kernel-launch
     calls, by the shading kernel's route equal to SAMPLE_LAUNCHES and by
     the eager stages to the parent's 5,824;
 27. on the card at 64x64: path_tracing -bump -texture-lod -debug-switches
     133 -exr (the EXR read back) and path_tracing -env-texture on an EXR
     written here; the svgf and restir_di frame loops on the textured
     scene, whose G-buffer albedo carries the checker;
 28. TFDM and the loaders, card against CPU: intersect_tfdm_v2 on 65,536
     camera and bounce rays over the tfdm app's scene at -base-res 24
     (1,152 prisms, the slab sweep) and 32 (2,048 prisms, the prism BVH's
     walk): hits agree on >= 0.999 of rays, t within rtol 1e-5 on >= 0.999
     of the rays both hit, steps equal on >= 0.99, with the card's time,
     peak memory, host syncs, rounds and march iterations; kernel 1 and
     kernel 6 (-traversal skip) against their plain versions on those rays
     and on shadow rays from their hits to the lamp (equal hits and
     triangles); the demo scene at
     128x128, 1 sample, displaced shadows on and off (image mean relative
     difference < 5e-3, rays within 0.5%: a march step can round across a
     texel edge on one device only); an OBJ + MTL (through -obj, with and
     without a convention word), a binary PLY and a GLB (through load_mesh)
     written here, rendered at 64x64, card against CPU;
 29. TFDM costs: the tfdm app's frame loop at 512x512 (ridges, -h-scale
     0.25, bilinear) at -base-res 24, one frame (the app renders 32;
     TFDM_FRAMES): ms per pathTrace, kernel 1's launches a
     frame, intersect_tfdm_v2's calls a frame and host syncs, rounds, march
     iterations and prism-BVH steps a call, peak memory, one frame under
     torch.profiler (CUDA kernels, launch calls, idle share, the TFDM
     calls' device time) whose calls record their steps (mean over the
     rays that march, max); then the tfdm CLI with -heatmap at 64x64, 4
     frames, and its two PNGs.
 30. NRTDSM, shells and curves, card against CPU, on the nrtdsm app's
     scene at its defaults (-base-res 16, -normal-tilt 0.3):
     intersect_nrtdsm_v2 and intersect_curve_spans (eight curves over the
     patch) on 65,536 camera and bounce rays, intersect_nrtdsm_exact on
     16,384, intersect_shell (-shell, the torus OBJ tiled 3 x 3) on 65,536
     of its own: hits agree on >= 0.999 of rays, t within rtol 1e-4 on
     >= 0.999 of the rays both hit; kernel 6 against walk_skip_plain on
     every chord batch one card shell call sends (t_min 0, t_max = -1 on
     idle lanes), t, u, v, tri and hit equal, its launches equal to the
     batches; kernels 1 and 6 against their plain versions on the scene's
     rays and shadow rays; the scene and its -shell form at 64x64, 1
     sample, card against CPU (< 5e-3, rays within 0.5%; the CPU's in a
     process of its own); the nrtdsm CLI at 64x64, 4 frames, with -heatmap
     and with -shell, beside it;
 31. NRTDSM costs: the nrtdsm app's frame loop at 512x512, one frame of the
     bilinear scene and one of -shell: ms per pathTrace, each displaced
     call fenced (ms, host syncs, rounds, exact steps), their share of the
     frame, kernel 1's and kernel 6's launches a frame, peak memory; the
     -shell cell's second frame's ops dispatched and walk launches; one
     call on the
     primary rays fenced, its ops counted and under torch.profiler (CUDA
     kernels, CUDA kernels an op, launch calls, idle share); the CLIs'
     PNGs and stats.
 32. SBVH: `small` as wide rows and `big` flattened as quantized rows
     (chunked), with and without spatial splits (references, rows, chunks,
     host seconds; the numpy SBVH of `small` in a process of its own beside
     the card's work); kernel 1 on small's SBVH table and kernel 7 on big's
     chunked SBVH table, closest and any hit, on ~1M rays against their
     plain versions (exactly equal) and against brute force over the
     duplicated references on 4,096 rays (hits, t and the source triangle
     perm[tri]); ms per 262,144-ray bounce batch on the SBVH tables beside
     the tables without splits, timed in turns (without, SBVH, SBVH,
     without) after the card spins ~10 ms, so that the calls the host
     enqueues meanwhile run back to back, with the host's ms to enqueue a
     launch beside each reading;
     gfxexp_torch.bench.measure at 512x512 and
     1920x1080 with and without splits (kernel 1's launches); a 64x64,
     2-sample SBVH render, card against CPU;
 33. wide: `small` compiled traversal="wide" (the stack-based wide BVH in
     plain torch): a 64x64, 2-sample render, card against CPU; one 512x512
     sample: ms, CUDA kernels (torch.profiler), host syncs and loop steps a
     query, no walk kernel launched;
 34. sharded, on a one-rank NCCL group (file:// rendezvous):
     render_sample_sharded at 512x512 on small (kernel 1) and `big` as skip
     links (kernel 6) equal to render_sample bit for bit; svgf_frame_sharded
     on a 1920x1080 frame equal to svgf_frame; nrc_train_step_dp on 65,536
     records on the card against train_step on the CPU (phase 23's bars);
     the ms of each beside the unsharded call;
 35. options and utilities: sort_secondary_rays and compact_rays on small
     and `city` flattened (wide rows) at 512x512 through bench.measure,
     default, sort, compact, default: images and ray counts equal bit for
     bit, Mrays/s of each; the path_tracing app at 128x128 with -live 0, an
     orbit and a pick POSTed, the pick read back over localhost; a
     DebugDraw PLY of small's top two BVH levels (chiprun_out/);
 36. images, on a machine without PIL: every fixture of tests/torch_images
     (JPEG baseline, progressive, cut after a scan (block smoothing),
     lossless, CMYK and arithmetic-coded; 16-bit PNGs, one Adam7; TGA RLE;
     BMP; GIF; PPM) decoded by the port and held to the sha256 of PIL's
     decode (digests.json); the textured scene with a 512^2 progressive
     4:2:0 JPEG, a 16-bit Adam7 PNG normal map and an RLE TGA in place of
     its DDS and PNG files, TEX_RES^2, TEX_SAMPLES samples as wide rows
     (kernel 1), card against CPU; the host's decode ms per megapixel of
     that JPEG and of its copy cut after the first AC scan (best of
     IMAGE_REPS);
 37. core toolkit, card against CPU at full width: generate_rays at
     1920x1080 (origins equal, directions within 1e-6); an alias table
     over 2^20 weights built on the host, 2^22 samples equal bit for bit;
     a discrete distribution over 2^16 weights built on the card, its CDF
     within CORE_CDF_ULPS of the CPU's, 2^22 sampled indices equal but
     where u lies within the CDFs' largest difference of an edge (counted,
     against the mass between the two CDFs; beside it, how often a float32
     scan on the card steps down or gives an empty item a bin); octahedral round trips of
     2^22 normals (encode equal, decode within 4 ulps); power_heuristic
     and simple_tonemap equal, srgb_to_linear within 8 ulps; device ms of
     each call;
 38. the path tracer's shading kernel (csrc/shade_bounce.cu) at 1920x1080
     on the box and lamp: the kernel shades each of SHADE_BOUNCES bounces
     from bounce 1, its plain version a copy of the same state after the
     same walks (the share of bit-identical lanes of every output, the
     largest difference in contribution, the pixels off by over 1e-3
     within 1e-4 of them); the kernel's and the plain version's device ms
     on bounce 2 against the bound (SHADE_LANE_BYTES a lane / 3.35 TB/s),
     registers and spills; render_sample by the kernel and by the eager
     stages (ms a sample, launches, the images within 1e-4 of the pixels),
     the counters `pathtrace.shade.kernel` (one a bounce) and
     `pathtrace.shade.eager` (none);
 39. ReSTIR DI's resampling kernels (csrc/restir_resample.cu) at 1920x1080
     on phase 21's scene with the benchmark's configuration (rearchitected,
     8 candidates, 2 spatial passes of 3 neighbours): the initial stream and
     each spatial pass by the kernel and by the plain version on the same
     inputs (the share of bit-identical pixels of every reservoir field, the
     largest difference, the pixels off by over 1e-3 within 1e-4 of them);
     each kernel's device ms from the profiler and the plain version's
     against the bound (RESTIR_INITIAL_BYTES and RESTIR_SPATIAL_BYTES a
     pixel / 3.35 TB/s), registers and spills; restir_di_frame by the
     kernel route and by the plain versions (ms a frame, launches, the
     images within 1e-4 of the pixels), the counters
     `restir.kernel.initial` (one a frame), `restir.kernel.spatial` (one a
     pass) and no `restir.eager.*`.
The last lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import struct
import subprocess
import sys
import time
import types
import zlib

import numpy as np
import torch

from gfxexp_torch import bench
from gfxexp_torch.accel import (
    instanced,
    lanegroup,
    native,
    persistent,
    qrow,
    widerow,
)
from gfxexp_torch.accel.instanced import (
    ROUTES,
    walk_instanced_cuda,
    walk_instanced_plain,
    walk_tlas,
)
from gfxexp_torch.accel.lanegroup import (
    walk_lanegroup_cuda,
    walk_lanegroup_plain,
)
from gfxexp_torch.accel.persistent import (
    chunked_trips,
    walk_chunked_cuda,
    walk_chunked_plain,
    walk_cuda,
    walk_plain,
)
from gfxexp_torch.accel.qrow import walk_qrow_cuda, walk_qrow_plain
from gfxexp_torch.accel.skip_traverse import SCOPES, walk_skip_cuda
from gfxexp_torch.accel.skiplink import skip_trips, walk_skip_plain
from gfxexp_torch.accel.traverse import HitInfo, intersect_closest_brute
from gfxexp_torch.apps.common import PassTimer
from gfxexp_torch.apps.path_tracing import frame_loop
from gfxexp_torch.bench import device_ms as time_ms
from gfxexp_torch.csrc import build
from gfxexp_torch.render.pathtrace import (
    PTConfig,
    render_accumulate,
    render_sample,
)
from gfxexp_torch.scene import animation
from gfxexp_torch.utils import jpeg as jpeg_decoder
from gfxexp_torch.utils import trace
from gfxexp_torch.utils.image_io import decode_samples, save_png
from gfxexp_torch.utils.runtime import enable_compile_cache
from gfxexp_torch.walk_trips import (
    build_order_costs,
    group_line,
    group_shares,
    group_steps,
    lane_line,
    lane_steps,
    warp_windows,
    window_line,
)

REPO = os.path.dirname(os.path.abspath(__file__))
BRUTE_SUB = 4096  # rays of the brute-force subsets (phases 7 and 11)
SEED = 7
BATCH = 512 * 512  # the main path's ray batch at 512x512
IMAGE_BAR = 5e-3  # mean relative image difference (golden-test bar)
KERNELS = ("widerow_traverse", "instanced_traverse", "skiplink_traverse",
           "chunked_traverse", "qrow_traverse", "lanegroup_traverse",
           "shade_bounce", "restir_resample")
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
# the skip-link walk: a node's slab test (6 sub, 6 mul, 12 min/max, 1
# compare) and a triangle's Moller-Trumbore test (27 mul, 17 add/sub, 1 div,
# 8 compares and selects)
OPS_NODE = 25
OPS_TRI = 53
# a quantized row: 8 children dequantized (6 conversions, 6 multiplies, 6
# adds) and slab-tested (25), about 43 each; a leaf's 5 triangles cost
# about as much (27 to dequantize, 53 for Moller-Trumbore, each)
OPS_QROW = 350
RAY_IN, RAY_OUT, ENTRY_OUT = 32, 17, 4  # bytes per ray (o, d, tmin, tmax)
ROW_BYTES = {"widerow": 256, "qrow": 128}  # a wide row, a quantized row
CHUNK_BYTES = 24  # a chunk box
NODE_BYTES, TRI_BYTES = 32, 48  # a skip node row and a triangle row
ENTRY_BYTES = 96  # AABB 24, transform 64, BLAS id 4, start row 4
# the TPU kernel (function reaching pl.pallas_call) each route replaces
REPLACES = {
    "nearest": "gfxexp_tpu/accel/pallas_persistent_inst.py:378",
    "build": "gfxexp_tpu/accel/pallas_widestack.py:1068",
    "sorted": "gfxexp_tpu/accel/pallas_widestack.py:1189",
    # the skip-link walk's cursor scopes: per ray (what every query of a
    # skip-link scene launches, where the TPU ran kernel 6), per warp
    # (kernel 8's row cursor), per block (kernel 6's tile cursor)
    "thread": "gfxexp_tpu/accel/pallas_traverse.py:178",
    "warp": "gfxexp_tpu/accel/pallas_rowcursor.py:206",
    "block": "gfxexp_tpu/accel/pallas_traverse.py:178",
    # the single-level walks of this slice
    "chunked": "gfxexp_tpu/accel/pallas_widestack.py:659",
    "qrow": "gfxexp_tpu/accel/pallas_qrow.py:560",
    "lanegroup": "gfxexp_tpu/accel/pallas_lanegroup.py:241",
}
SL_SCENES = ("big", "city")  # flattened, phases 15-18
SL_FORMATS = ("widerow", "qrow")
SL_WALKS = {"widerow": (walk_chunked_cuda, walk_chunked_plain),
            "qrow": (walk_qrow_cuda, walk_qrow_plain)}
ANIM_FRAMES = 4  # frames of the animated main path (phase 13)
ANIM_RES = 512  # its resolution
# phase 14's scene: a floor, an emissive sphere, and a sphere that moves
APP_DSL = ["-cam-pos", "0", "1", "3.2", "-cam-pitch", "-12",
           "-name", "floor", "-rectangle", "4", "4", "-inst", "floor",
           "-name", "ball", "-sphere", "0.4", "-inst", "ball",
           "-begin-pos", "0", "0.4", "0", "-end-pos", "0.3", "0.9", "0",
           "-freq", "2",
           "-name", "lamp", "-emittance", "30", "30", "30", "-sphere", "0.3",
           "-inst", "lamp", "-position", "0", "2", "0"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _trips(parent, new, live):
    """Round trips per live ray, mean / p99 / max, under the parent's
    schedule and the kernel's."""
    out = {}
    for name, x in (("parent", parent), ("kernel", new)):
        x = x[live].double()
        out[name] = ({"mean": float(x.mean()),
                      "p99": float(torch.quantile(x, 0.99)),
                      "max": float(x.max())} if x.numel() else
                     {"mean": 0.0, "p99": 0.0, "max": 0.0})
    return out


def _trip_line(t):
    return "round trips per live ray mean/p99/max: parent " + "; kernel ".join(
        f"{e['mean']:.2f}/{e['p99']:.0f}/{e['max']:.0f}"
        for e in (t["parent"], t["kernel"]))


def bound(nbytes, ops):
    """(least time in ms, what bounds it) for moving nbytes through HBM and
    doing ops float32 operations on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


SPIN_CYCLES = 20_000_000  # ~10 ms of the card's clock: the host's head start


def _device_and_host_ms(fn, reps: int) -> tuple[float, float, bool]:
    """(device ms per call, host ms per call to enqueue it, whether the host
    finished enqueuing before the card reached the first call) over reps
    calls after one warm call. The card spins for SPIN_CYCLES first, so
    calls the host enqueues meanwhile run back to back: the events then
    time the card alone, even where a call is shorter than the wrapper's
    host work."""
    fn()
    torch.cuda.synchronize()
    spun = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spun.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    h1 = time.perf_counter()
    end.record()
    torch.cuda.synchronize()
    host_ms = (h1 - h0) * 1e3
    return (start.elapsed_time(end) / reps, host_ms / reps,
            host_ms < spun.elapsed_time(start))


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


def _ptxas(name):
    """nvcc's -Xptxas -v report of a kernel's build: registers, spills,
    stack and static shared memory per instantiation."""
    return [ln.strip() for ln in build.build_log.get(name, "").splitlines()
            if "registers" in ln or "spill" in ln]


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
        ptxas = _ptxas(name)
        report["build"]["ptxas"][name] = ptxas
        print(f"[2 build] gfxexp_torch/csrc/{name}.cu: nvcc "
              f"{build.build_seconds[name]:.2f}s; ptxas: "
              f"{' | '.join(ptxas)}", flush=True)
    print(f"[2 build] {len(KERNELS)} kernels in {secs:.2f}s (parallel nvcc); "
          f"native BVH builder (g++) {native_secs:.2f}s", flush=True)


def _scene_rays(first_hit, which, dev):
    """~1M rays over a bench scene (bench.walk_rays): primary rays at
    512x512 and three batches of bounce rays, every 7th dead; shadow rays
    to the light, every 5th dead."""
    return bench.walk_rays(first_hit, which, dev, SEED, BATCH)


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
        # a launch takes less time on the card than on the host: the card
        # spins while the host enqueues, so the events time the card alone
        ms, host_ms, ahead = _device_and_host_ms(
            lambda: walk_cuda(bvh, *a, any_hit), 20)
        plain_ms = time_ms(lambda: walk_plain(bvh, *a, any_hit), 2)
        _, rows = walk_plain(bvh, *a, any_hit, with_stats=True)
        live = int((a[3] >= 0).sum())
        bms, by = bound(BATCH * (RAY_IN + RAY_OUT) + table,
                        int(rows.sum()) * OPS_ROW)
        out[kind] = {"ms": ms, "host_ms_per_launch": host_ms,
                     "host_ahead_of_card": ahead,
                     "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "rows_per_live_ray":
                     int(rows.sum()) / max(live, 1),
                     "lanes": lane_steps(rows.cpu().numpy())}
    prim = _device_and_host_ms(lambda: walk_cuda(
        bvh, o[:BATCH], d[:BATCH], t_min[:BATCH], t_max[:BATCH], False),
        20)[0]
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
          f"closest {c['ms']:.4f} ms (host {c['host_ms_per_launch']:.4f} "
          f"ms a launch; plain {c['plain_ms']:.1f} ms, bound "
          f"{c['bound_ms']:.4f} ms by {c['bound_by']}, "
          f"{c['rows_per_live_ray']:.1f} rows/ray), any {a['ms']:.4f} ms "
          f"(host {a['host_ms_per_launch']:.4f} ms a launch; plain "
          f"{a['plain_ms']:.1f} ms, bound {a['bound_ms']:.4f} ms by "
          f"{a['bound_by']}), primary closest {prim:.4f} ms", flush=True)
    for kind, e in out.items():
        print(f"[3 kernels] {BATCH}-ray bounce batch {kind}: "
              f"lanes {lane_line(e['lanes'])}", flush=True)
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
    _reset_counts()
    rows = {size: bench.measure(size, scene, bvh, device=dev)
            for size in ("512", "1080p")}
    counts = _all_counts()
    launches = counts["kernel1"]
    check(not any(counts["instanced"].values()),
          f"small scene launched the two-level walk: "
          f"{counts['instanced']}")
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
    worlds = {}
    for which in ("big", "city"):
        t0 = time.time()
        worlds[which] = bench.bench_scene_builder(
            scene=which).compile().triangles
        secs[f"{which}_flattened"] = time.time() - t0
    report["inst_build"] = {
        "seconds": secs,
        **{f"{w}_world_triangles": t.count for w, t in worlds.items()},
        **{k: {"entries": a.num_entries, "blas_rows": list(a.nodes.shape),
               "blas_triangles": s.num_triangles, "max_depth": a.max_depth}
           for k, (s, a) in out.items()}}
    for k, (s, a) in out.items():
        print(f"[6 inst build] {k}: {a.num_entries} entries, BLAS tables "
              f"{tuple(a.nodes.shape)} ({a.nodes.numel() * 4 / 1e6:.2f} MB),"
              f" {s.num_triangles} BLAS triangles, built in "
              f"{secs[k]:.3f}s", flush=True)
    for w, t in worlds.items():
        print(f"[6 inst build] {w} flattened: {t.count} world triangles in "
              f"{secs[w + '_flattened']:.2f}s", flush=True)
    return out, worlds


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


def _coplanar(world, h, o, d):
    """Rays that start on the plane of the triangle h reports and run
    within it: |n.(o - p0)| < 1e-4 and |n.d| < 1e-3, n the unit normal,
    computed in float64 so that the test itself does not round."""
    tri = h.tri.clamp(min=0).long()
    e1, e2 = world.e1[tri].double(), world.e2[tri].double()
    n = torch.linalg.cross(e1, e2, dim=1)
    n = n / torch.linalg.vector_norm(n, dim=1, keepdim=True).clamp(min=1e-300)
    off = ((o.double() - world.p0[tri].double()) * n).sum(1).abs()
    cos = (d.double() * n).sum(1).abs()
    return h.hit & (off < 1e-4) & (cos < 1e-3)


def _brute_mismatches(world, kc, ka, sub, o, d, sd, t_min, t_max, s_max,
                      coplanar_apart=False):
    """Closest and any-hit mismatches of the walk against brute force over
    the world triangles on the rays `sub`; t agrees within 1e-4 relative
    plus 1e-4 absolute (the rays' t_min). A mismatch is explained when the
    hit that the other side missed lies within 1e-4 (barycentric) of a
    triangle edge, where Baldwin-Weber tests are not watertight (a ray from
    9 units away resolves a small sphere's edge only to ~1e-5), or within
    1e-2 of the ray's origin: bounce rays leave a surface inside an
    overlapping sphere, and at |p| ~ 5 float32 positions resolve such short,
    often grazing, distances only to ~1e-6 / |cos|.

    With coplanar_apart (the walk's triangle ids index `world`), a mismatch
    on a ray that starts on the plane of the triangle either side reports
    and runs within it (a shadow ray from the light's top face to a point of
    the light) is counted apart, as "coplanar", and not as a mismatch: there
    the Baldwin-Weber plane test divides a rounding error by a rounding
    error, so t is noise, and Moller-Trumbore rounds otherwise. The caller
    caps that count (_check_brute)."""
    O, D, SD = o[sub], d[sub], sd[sub]
    bc = intersect_closest_brute(world, O, D, t_min[sub], t_max[sub])
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
    ba = intersect_closest_brute(world, O, SD, t_min[sub], s_max[sub])
    a = HitInfo(t=ka.t[sub], tri=ka.tri[sub], u=ka.u[sub], v=ka.v[sub],
                hit=ka.hit[sub])
    any_mis = a.hit != ba.hit
    any_explained = (
        (ba.hit & ((_edge_margin(ba) < 1e-4) | (ba.t < 1e-2)))
        | (a.hit & ((_edge_margin(a) < 1e-4) | (a.t < 1e-2))))
    out = {"phase3_allowance": sub.numel() // 10000}
    if coplanar_apart:
        closest_cop = closest & (_coplanar(world, bc, O, D)
                                 | _coplanar(world, k, O, D))
        any_cop = any_mis & (_coplanar(world, ba, O, SD)
                             | _coplanar(world, a, O, SD))
        closest, any_mis = closest & ~closest_cop, any_mis & ~any_cop
        out["coplanar"] = int(closest_cop.sum() + any_cop.sum())
    out.update(closest=int(closest.sum()), any=int(any_mis.sum()),
               total=int(closest.sum() + any_mis.sum()),
               unexplained=int((closest & ~explained).sum()
                               + (any_mis & ~any_explained).sum()))
    return out


def _check_brute(brute, sub, tag):
    """Fails unless every brute-force mismatch is explained, there are at
    most one per 1,000 rays, and (where counted) at most one coplanar ray
    per 100. Returns the mismatch allowance."""
    allowed = max(1, sub.numel() // 1000)
    cop_allowed = max(1, sub.numel() // 100)
    check(brute["unexplained"] == 0 and brute["total"] <= allowed
          and brute.get("coplanar", 0) <= cop_allowed,
          f"{tag} brute: {brute} (allowed {allowed}, all explained; "
          f"coplanar allowed {cop_allowed})")
    return allowed


def _candidates(lo, hi, o, d, t_min, t_max, visits):
    """The boxes lo, hi a live ray enters within [t_min, t_max), the keys
    the pick's first scan keeps (from the plain entry distances): p50, p90,
    p99 and max per live ray, the share of live rays with more than kPick
    (their buffer overflows) and the share that visited more than kPick
    boxes (`visits`, so the walk took keys of a refill)."""
    counts = []
    step = persistent.slab_rows(lo.shape[0])
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        near = instanced._instance_entry_dists(lo, hi, o[sl], d[sl],
                                               t_min[sl], t_max[sl])
        counts.append((near < t_max[sl, None]).sum(1))
    live = t_max >= 0
    c = torch.cat(counts)[live].double()
    k = build.header_constant("kPick")
    q = torch.quantile(c, torch.tensor([0.5, 0.9, 0.99], dtype=c.dtype,
                                       device=c.device)).tolist()
    return {"p50": q[0], "p90": q[1], "p99": q[2], "max": int(c.max()),
            "k": k, "over_k_share": float((c > k).double().mean()),
            "visited_over_k_share": float((visits[live] > k).double()
                                          .mean())}


def _cand_line(c):
    return (f"candidate boxes per live ray p50/p90/p99/max {c['p50']:.0f}/"
            f"{c['p90']:.0f}/{c['p99']:.0f}/{c['max']}, over kPick="
            f"{c['k']}: {c['over_k_share']:.4f} of live rays, "
            f"{c['visited_over_k_share']:.5f} visited more than kPick")


def _pick_smem_line(what, count):
    """The shared memory a block of the pick stages `count` boxes in
    (pick_smem_bytes in widerow_walk.cuh: 32 B a box, kBoxTile at a time);
    ptxas reports only static shared memory."""
    tile = build.header_constant("kBoxTile")
    return (f"{count} {what}: {32 * min(count, tile)} B of dynamic shared "
            f"memory per block, {math.ceil(count / tile)} tile(s)")


def _inst_kernels_one(acc, world, dev, tag, which, detail=True):
    """Every route against its plain version on ~1M rays, the routes
    against each other, brute force on 4,096; the kernel's ms per route on
    one bounce batch and, with `detail` (the scene the kernels line
    reports), the plain version's ms, the bound, rows and entries per ray,
    the candidate boxes and the build order's lane costs."""
    def first_hit(o0, d0):
        h, _ = walk_instanced_cuda(acc, o0, d0, 0.0, 1e30, False, "nearest")
        return h.t, h.hit

    o, d, t_min, t_max, sd, s_max = _scene_rays(first_hit, which, dev)
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
            check(not k.hit[tm < 0].any(), f"{tag} {key}: a dead ray hit")
            for f in ("hit", "t", "u", "v", "tri"):
                diff = getattr(k, f) != getattr(p, f)
                check(not bool(diff.any()),
                      f"{tag} {key}: {f} differs from plain on "
                      f"{int(diff.sum())} rays")
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
    b_allowed = _check_brute(brute, sub, tag)
    out = {"rays": n, "allowed": allowed, "route_mismatches": route_mis,
           "max_abs_err": errs, "brute_subset": sub.numel(),
           "brute": brute, "brute_allowed": b_allowed, "times": {},
           "candidates": {}}

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
            out["times"][f"{kind}_{route}"] = entry
            if not detail:
                continue
            entry["plain_ms"] = time_ms(lambda: walk_instanced_plain(
                acc, *args, any_hit, route), 1, warm=False)
            p_hit, _, rows, visits, seq = walk_instanced_plain(
                acc, *args, any_hit, route, with_stats=True)
            # the entry boxes need one scan per live ray, whatever the
            # route rescans
            live = int((args[3] >= 0).sum())
            ops = (int(rows.sum()) * OPS_ROW
                   + int(visits.sum()) * OPS_VISIT
                   + live * acc.num_entries * OPS_SLAB)
            bms, by = bound(BATCH * (RAY_IN + RAY_OUT + ENTRY_OUT)
                            + tables, ops)
            entry.update(bound_ms=bms, bound_by=by,
                         rows_per_live_ray=int(rows.sum()) / max(live, 1),
                         entries_per_live_ray=int(visits.sum())
                         / max(live, 1))
            if route == "build":
                # an any hit that was accepted ended its ray's list
                stopped = p_hit.hit & any_hit
                entry["lanes"] = build_order_costs(
                    [x.cpu().numpy() for x in seq], BATCH, acc.num_entries,
                    (args[3] >= 0).cpu().numpy(), stopped.cpu().numpy())
                entry["lanes"]["groups"] = group_shares(
                    acc.chunk_lo, acc.chunk_hi, *args)
            if route == "nearest":
                out["candidates"][kind] = _candidates(
                    acc.chunk_lo, acc.chunk_hi, *args, visits)
    return out


def phase_inst_kernels(report, built, worlds, dev):
    worlds = {w: t.to(dev) for w, t in worlds.items()}
    out = {}
    print(f"[7 inst kernels] ptxas instanced_traverse: "
          f"{' | '.join(_ptxas('instanced_traverse'))}", flush=True)
    for key, which in (("city", "city"), ("city_rebraid4", "city"),
                       ("big", "big")):
        acc = built[key][1]
        out[key] = _inst_kernels_one(acc, worlds[which], dev, key, which,
                                     detail=key == "city")
        r = out[key]
        t = r["times"]
        print(f"[7 inst kernels {key}] {r['rays']} rays: every route == "
              f"plain (t/u/v/tri/entry identical, closest and any hit); "
              f"routes disagree on {r['route_mismatches']} "
              f"(allowed {r['allowed']}); brute {r['brute_subset']} rays: "
              f"{r['brute']} (allowed {r['brute_allowed']}, each at an edge "
              f"or within 1e-2 of the origin)", flush=True)
        print(f"[7 inst kernels {key}] pick: "
              f"{_pick_smem_line('entries', acc.num_entries)}", flush=True)
        for kind, c in r["candidates"].items():
            print(f"[7 inst kernels {key}] {BATCH}-ray bounce batch {kind}: "
                  f"{_cand_line(c)}", flush=True)
        for name, e in t.items():
            route = (f", whole route {e['route_ms']:.3f} ms"
                     if e["route_ms"] is not None else "")
            more = (f", plain {e['plain_ms']:.1f} ms, bound "
                    f"{e['bound_ms']:.4f} ms by {e['bound_by']}, "
                    f"{e['rows_per_live_ray']:.1f} rows and "
                    f"{e['entries_per_live_ray']:.2f} entries per live ray"
                    if "plain_ms" in e else "")
            print(f"[7 inst kernels {key}] {BATCH}-ray bounce batch "
                  f"{name}: {e['ms']:.4f} ms{route}{more}", flush=True)
            if "lanes" in e:
                print(f"[7 inst kernels {key}] {BATCH}-ray bounce batch "
                      f"{name}: lanes {lane_line(e['lanes'])}", flush=True)
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
    """One 512x512 sample under torch.profiler (see _profile)."""
    cam = bench.bench_camera(512, 512, which).to(dev)
    cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH, count_rays=True)
    return _profile(lambda s: render_accumulate(scene, acc, cam, 512, 512, s,
                                                1, cfg))


def _profile(fn):
    """fn(1) under torch.profiler after a warm fn(0) and a timed fn(1): CUDA
    kernels, device busy time (union of kernel intervals), the walk
    kernels' share and the device's idle share of the unprofiled wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(1)
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    # the host's launch calls (the CUDA runtime's, seen on the CPU side):
    # one per kernel launched, whatever the device trace kept
    calls = sum(1 for e in prof.events() if e.name in LAUNCH_CALLS)
    if not kern:
        return {"wall_ms": wall * 1e3, "kernels": "not measured",
                "launch_calls": calls}
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
            "idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
            "launch_calls": calls}


def _print_profile(tag, p, what="one 512x512 sample"):
    if p["kernels"] == "not measured":
        print(f"[{tag}] torch.profiler showed no device time: not measured",
              flush=True)
    else:
        print(f"[{tag}] {what}: wall {p['wall_ms']:.2f} ms, "
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
    _reset_counts()
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
    counts = _all_counts()
    launches = counts["instanced"]
    check(not any(counts["kernel1"].values()),
          f"two-level scenes launched kernel 1: {counts['kernel1']}")
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


def phase_skip_build(report):
    built, rep = {}, {}
    for which in ("big", "city"):
        t0 = time.time()
        scene, bvh = bench.build_bench_scene(which, traversal="skip")
        secs = time.time() - t0
        built[which] = (scene, bvh)
        node_mb = bvh.node_pack.numel() * 4 / 1e6
        tri_mb = bvh.tri_pack.numel() * 4 / 1e6
        rep[which] = {"world_triangles": scene.num_triangles,
                      "nodes": bvh.num_nodes, "levels": bvh.n_levels,
                      "node_table_mb": node_mb, "tri_table_mb": tri_mb,
                      "seconds": secs}
        print(f"[10 skip build] {which}: {scene.num_triangles} world "
              f"triangles, {bvh.num_nodes} skip nodes, {bvh.n_levels} "
              f"levels, tables {node_mb:.2f} MB nodes + {tri_mb:.2f} MB "
              f"triangles, built on the host in {secs:.2f}s", flush=True)
    report["skip_build"] = rep
    return built


def _skip_rays(scene, bvh, which, dev):
    def first_hit(o0, d0):
        h = walk_skip_cuda(bvh, scene.triangles, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    return _scene_rays(first_hit, which, dev)


def _skip_check(scene, bvh, which, dev, tag):
    """Every scope == plain (closest and any hit) on ~1M rays, and the
    plain version against brute force on 4,096 of them. Returns the max
    abs errors, the brute-force record and the visit counts."""
    tris = scene.triangles
    o, d, t_min, t_max, sd, s_max = _skip_rays(scene, bvh, which, dev)
    n = o.shape[0]
    plain, errs, visits = {}, {}, {}
    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        dd, tm = (sd, s_max) if any_hit else (d, t_max)
        p, st = walk_skip_plain(bvh, tris, o, dd, t_min, tm, any_hit,
                                with_stats=True)
        live = max(int((tm >= 0).sum()), 1)
        visits[kind] = {"nodes_per_live_ray": int(st.nodes.sum()) / live,
                        "tris_per_live_ray": int(st.tris.sum()) / live,
                        "max_nodes": int(st.nodes.max())}
        for scope in SCOPES:
            k = walk_skip_cuda(bvh, tris, o, dd, t_min, tm, any_hit, scope)
            torch.cuda.synchronize()
            for f in ("hit", "t", "u", "v", "tri"):
                diff = getattr(k, f) != getattr(p, f)
                check(not bool(diff.any()),
                      f"{tag} {kind} {scope}: {f} differs from plain on "
                      f"{int(diff.sum())} rays, e.g. "
                      f"{torch.nonzero(diff)[:8, 0].tolist()}")
            check(not k.hit[tm < 0].any(), f"{tag} {kind}: a dead ray hit")
            m = k.hit
            errs[f"{kind}_{scope}"] = float(torch.stack([
                (getattr(k, f)[m] - getattr(p, f)[m]).abs().max()
                for f in ("t", "u", "v")]).max()) if m.any() else 0.0
        plain[kind] = p
    sub = torch.arange(0, n, n // BRUTE_SUB, device=dev)[:BRUTE_SUB]
    brute = _brute_mismatches(tris, plain["closest"], plain["any"], sub, o,
                              d, sd, t_min, t_max, s_max)
    b_allowed = _check_brute(brute, sub, tag)
    return {"rays": n, "max_abs_err": errs, "brute": brute,
            "brute_allowed": b_allowed, "visits": visits}, (
        o, d, t_min, t_max, sd, s_max)


def _skip_times(scene, bvh, rays, detail=True):
    """Each scope's ms on one 262,144-ray bounce batch; with `detail` (the
    case the kernels line reports) also the plain version's, and the bound
    from what the plain version read on those rays: each ray once, each
    node and triangle row it touched once (32 and 48 bytes), and the
    operations of its node and triangle tests."""
    o, d, t_min, t_max, sd, s_max = rays
    tris = scene.triangles
    b = slice(BATCH, 2 * BATCH)
    out = {}
    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        args = ((o[b], sd[b], t_min[b], s_max[b]) if any_hit
                else (o[b], d[b], t_min[b], t_max[b]))
        if not detail:
            for scope in SCOPES:
                out[f"{kind}_{scope}"] = {"ms": time_ms(
                    lambda: walk_skip_cuda(bvh, tris, *args, any_hit,
                                           scope), 10)}
            continue
        plain_ms = time_ms(lambda: walk_skip_plain(bvh, tris, *args,
                                                   any_hit), 1, warm=False)
        _, st = walk_skip_plain(bvh, tris, *args, any_hit, with_stats=True)
        # the kernel batches a hit leaf's rows for closest hit only
        trips = _trips(*skip_trips(st, leaf_batch=not any_hit),
                       args[3] >= 0)
        node_rows, tri_rows = int(st.node_rows.sum()), int(st.tri_rows.sum())
        bms, by = bound(BATCH * (RAY_IN + RAY_OUT) + node_rows * NODE_BYTES
                        + tri_rows * TRI_BYTES,
                        int(st.nodes.sum()) * OPS_NODE
                        + int(st.tris.sum()) * OPS_TRI)
        live = max(int((args[3] >= 0).sum()), 1)
        for scope in SCOPES:
            ms = time_ms(lambda: walk_skip_cuda(bvh, tris, *args, any_hit,
                                                scope), 10)
            out[f"{kind}_{scope}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by,
                "nodes_per_live_ray": int(st.nodes.sum()) / live,
                "tris_per_live_ray": int(st.tris.sum()) / live,
                "node_rows_read": node_rows, "tri_rows_read": tri_rows}
        out[f"{kind}_thread"]["trips"] = trips
        # the warp scope's union steps and windows per warp
        out[f"{kind}_warp"]["windows"] = warp_windows(st.visits, BATCH)
    return out


def phase_skip_kernels(report, built, dev):
    out = {}
    for which in ("big", "city"):
        scene, bvh = built[which]
        ctl = bench.bench_controllers(which)
        for state in ("frame0", "refit8"):
            if state == "refit8":
                t0 = time.perf_counter()
                for f in range(1, 9):
                    scene, bvh = animation.advance_frame(scene, bvh, ctl,
                                                         f / 60.0)
                torch.cuda.synchronize()
                refit_s = time.perf_counter() - t0
            key = f"{which}_{state}"
            r, rays = _skip_check(scene, bvh, which, dev, key)
            r["times"] = _skip_times(scene, bvh, rays,
                                     detail=key == "city_frame0")
            if state == "refit8":
                r["advance_8_frames_s"] = refit_s
            out[key] = r
            v = r["visits"]
            print(f"[11 skip kernels {key}] {r['rays']} rays: thread, warp "
                  f"and block scopes == plain (t/u/v/tri identical, closest "
                  f"and any hit); brute {BRUTE_SUB} rays: {r['brute']} "
                  f"(allowed {r['brute_allowed']}); per live ray: closest "
                  f"{v['closest']['nodes_per_live_ray']:.1f} nodes "
                  f"(max {v['closest']['max_nodes']}), "
                  f"{v['closest']['tris_per_live_ray']:.2f} triangles; any "
                  f"{v['any']['nodes_per_live_ray']:.1f} nodes, "
                  f"{v['any']['tris_per_live_ray']:.2f} triangles",
                  flush=True)
            t = r["times"]
            if "plain_ms" not in t["closest_thread"]:
                print(f"[11 skip kernels {key}] {BATCH}-ray bounce batch: "
                      + "; ".join(f"{k} {e['ms']:.4f} ms"
                                  for k, e in t.items()), flush=True)
                continue
            print(f"[11 skip kernels {key}] {BATCH}-ray bounce batch: " +
                  "; ".join(f"{k} {e['ms']:.4f} ms" for k, e in t.items())
                  + f"; plain closest {t['closest_thread']['plain_ms']:.1f}"
                  f" / any {t['any_thread']['plain_ms']:.1f} ms; bound "
                  f"{t['closest_thread']['bound_ms']:.4f} / "
                  f"{t['any_thread']['bound_ms']:.4f} ms by "
                  f"{t['closest_thread']['bound_by']} / "
                  f"{t['any_thread']['bound_by']} (rows read: "
                  f"{t['closest_thread']['node_rows_read']} / "
                  f"{t['any_thread']['node_rows_read']} of {bvh.num_nodes} "
                  f"nodes, {t['closest_thread']['tri_rows_read']} / "
                  f"{t['any_thread']['tri_rows_read']} of "
                  f"{scene.num_triangles} triangles); per live bounce ray "
                  f"closest {t['closest_thread']['nodes_per_live_ray']:.1f}"
                  f" nodes, {t['closest_thread']['tris_per_live_ray']:.2f} "
                  f"triangles, any {t['any_thread']['nodes_per_live_ray']:.1f}"
                  f" nodes, {t['any_thread']['tris_per_live_ray']:.2f} "
                  f"triangles", flush=True)
            for kind in ("closest", "any"):
                e = t[f"{kind}_thread"]
                print(f"[11 skip kernels {key}] {BATCH}-ray bounce batch "
                      f"{kind}, thread scope: {e['ms']:.4f} ms; "
                      f"{_trip_line(e['trips'])}", flush=True)
                e = t[f"{kind}_warp"]
                print(f"[11 skip kernels {key}] {BATCH}-ray bounce batch "
                      f"{kind}, warp scope: {e['ms']:.4f} ms; "
                      f"{window_line(e['windows'])}", flush=True)
    report["skip_kernels"] = out
    return out


def phase_skip_slice(report, built, dev):
    scene, bvh = built["big"]
    scene, bvh = animation.advance_frame(
        scene, bvh, bench.bench_controllers("big"), 0.5)
    r = _render_pair(scene, bvh, "big", dev, "animated slice")
    check(r["rays_cuda"] == r["rays_cpu"],
          f"animated slice: ray counts differ {r}")
    report["skip_slice"] = r
    print(f"[12 animated slice] big after advance_frame(t=0.5), 64x64 2spp "
          f"cuda vs cpu: image rel diff {r['image_rel_diff']:.3g} (bar "
          f"{IMAGE_BAR}), rays {r['rays_cuda']:.0f} vs {r['rays_cpu']:.0f}",
          flush=True)


def phase_anim_main(report, built, dev):
    runs = (("city", "city"), ("big", "big"))
    cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH, count_rays=True)
    res = ANIM_RES
    _reset_counts()
    rows = {}
    frames = ANIM_FRAMES
    for key, which in runs:
        scene, bvh = built[which]
        ctl = bench.bench_controllers(which)
        cam = bench.bench_camera(res, res, which).to(dev)
        # one warm-up frame (the caching allocator fills up)
        frame_loop(scene, bvh, cam, ctl, "skip", res, res, 1, cfg,
                   PassTimer(device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        timer = PassTimer(device=dev)
        t0 = time.perf_counter()
        film, _, _, rays = frame_loop(scene, bvh, cam, ctl, "skip", res, res,
                                      frames, cfg, timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        img = film.beauty.reshape(-1, 3)
        pt = timer.samples["pathTrace"]
        rows[key] = {
            "frames": frames, "wall_s": wall,
            "update_ms": timer.mean_ms("update"),
            "pathtrace_ms": timer.mean_ms("pathTrace"),
            "rays": float(rays),
            "mrays_per_s": float(rays) / (sum(pt) / 1e3) / 1e6,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "mean_radiance": float(img.mean()),
            "finite": bool(torch.isfinite(img).all()),
            "image": img, "width": res, "height": res}
        r = rows[key]
        _check_bench_row(r, f"animated main {key}")
        print(f"[13 animated main {key}] {frames} frames at {res}x{res}: "
              f"update {r['update_ms']:.2f} ms/frame, "
              f"pathTrace {r['pathtrace_ms']:.2f} ms/frame, "
              f"{r['mrays_per_s']:.2f} Mrays/s ({r['rays']:.0f} rays), "
              f"wall {r['wall_s']:.3f}s, peak memory "
              f"{r['peak_memory_bytes'] / 1e9:.2f} GB, mean radiance "
              f"{r['mean_radiance']:.5f}", flush=True)
    counts = _all_counts()
    launches = counts["skip"]
    check(not any(counts["kernel1"].values())
          and not any(counts["instanced"].values()),
          f"animated scenes launched kernels 1/3-5: "
          f"{counts['kernel1']} {counts['instanced']}")
    # the main path queries through intersect_*_pallas: the thread scope;
    # the shared scopes are reached only by their direct entry points
    check(launches["closest_thread"] > 0 and launches["any_thread"] > 0,
          f"animated main path left a skip kernel unlaunched: {launches}")
    print(f"[13 animated main] skip kernel launches: {launches}", flush=True)
    _save(rows["city"], "torch_anim_city.png")
    _save(rows["big"], "torch_anim_big.png")
    prof = {}
    for which in ("city", "big"):
        scene, bvh = built[which]
        ctl = bench.bench_controllers(which)
        cam = bench.bench_camera(res, res, which).to(dev)

        def frame(f):
            s, b = animation.advance_frame(scene, bvh, ctl, (f + 1) / 60.0)
            return render_sample(s, b, cam, res, res, f + 1, cfg)

        prof[which] = _print_profile(f"13 animated profile {which}",
                                     _profile(frame),
                                     "one frame (update + pathTrace)")
    breakdown = {which: _update_breakdown(*built[which], which)
                 for which in ("city", "big")}
    for which, b in breakdown.items():
        print(f"[13 animated update {which}] ms per frame (mean of 4, "
              f"synchronised after each step; the last, outside the frame, "
              f"is the refit with its level lists made anew): " +
              ", ".join(f"{k} {v:.2f}" for k, v in b.items()), flush=True)
    report["anim_update_breakdown"] = breakdown
    report["anim_main"] = {k: {f: v for f, v in r.items() if f != "image"}
                           for k, r in rows.items()}
    report["anim_launches"] = launches
    report["anim_profile"] = prof
    return launches


def _update_breakdown(scene, bvh, which):
    """advance_frame's steps timed one by one (host clock, each ended by
    torch.cuda.synchronize()), mean over 4 frames after a warm one. Not part
    of a frame, timed beside it: the refit with its per-level node lists
    made anew (what it did each frame before they came with the
    structure)."""
    ctl = bench.bench_controllers(which)
    steps = {"controllers": [], "set_transforms": [], "world_geometry": [],
             "refit_repack": [], "lights": [],
             "refit_repack_with_level_lists": []}

    def timed(name, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        if name is not None:
            steps[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for f in range(5):
        t = (f + 1) / 60.0

        def rec(name):
            return name if f else None  # frame 0 warms up

        tf = timed(rec("controllers"), animation.controller_transforms, scene,
                   ctl, t)
        scene = timed(rec("set_transforms"), animation.set_instance_transforms,
                      scene, tf)
        scene = timed(rec("world_geometry"), animation.update_world_geometry,
                      scene)
        timed(rec("refit_repack_with_level_lists"),
              lambda: animation.refit_skip_bvh(
                  dataclasses.replace(bvh, leaf_ids=None), scene.triangles))
        bvh = timed(rec("refit_repack"), animation.refit_skip_bvh, bvh,
                    scene.triangles)
        scene = timed(rec("lights"), animation.rebuild_light_distributions,
                      scene)
    return {k: sum(v) / len(v) for k, v in steps.items()}


def _png_pixels(path):
    """[H, W, 3] uint8 pixels of an RGB PNG written by save_png."""
    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:
                               data.index(b"IEND") - 8])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), f"{path}: unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 3)


def phase_app_cli(report):
    out = os.path.join(REPO, "out", "app_cli")
    if os.path.exists(out + ".png"):
        os.remove(out + ".png")
    cmd = [sys.executable, "-m", "gfxexp_torch.apps.path_tracing", "-width",
           "128", "-height", "128", "-frames", "4", "-stats", "-output", out,
           *APP_DSL]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    secs = time.time() - t0
    check(proc.returncode == 0,
          f"app CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    px = _png_pixels(out + ".png")
    check(px.shape == (128, 128, 3) and px.any(),
          f"app CLI: PNG {px.shape}, all black {not px.any()}")
    stats = [ln for ln in proc.stderr.splitlines() if ln.startswith("final:")]
    check(stats, "app CLI printed no -stats line")
    report["app_cli"] = {"seconds": secs, "stats": stats[0],
                         "mean_pixel": float(px.mean())}
    print(f"[14 app CLI] python -m gfxexp_torch.apps.path_tracing 128x128, "
          f"4 frames, one animated instance: rc 0 in {secs:.1f}s, "
          f"out/app_cli.png mean pixel {px.mean():.1f}; {stats[0]}",
          flush=True)


def phase_sl_build(report):
    built, rep = {}, {}
    for which in SL_SCENES:
        for fmt in SL_FORMATS:
            t0 = time.time()
            scene, bvh = bench.build_bench_scene(which, traversal=fmt)
            secs = time.time() - t0
            key = f"{which}_{fmt}"
            built[key] = (scene, bvh)
            mb = bvh.nodes.numel() * 4 / 1e6
            rep[key] = {"world_triangles": scene.num_triangles,
                        "chunks": bvh.num_chunks,
                        "rows_per_chunk": bvh.rows_per_chunk,
                        "max_depth": bvh.max_depth, "table_mb": mb,
                        "seconds": secs}
            print(f"[15 single-level build] {key}: {scene.num_triangles} "
                  f"world triangles, {bvh.num_chunks} chunks of up to "
                  f"{bvh.rows_per_chunk} rows ({mb:.2f} MB), max depth "
                  f"{bvh.max_depth}, built on the host in {secs:.2f}s",
                  flush=True)
    report["sl_build"] = rep
    return built


class _RowLog(torch.Tensor):
    """A row table that marks, in `read`, every row indexed out of a 2-D
    view of it: the rows a plain walk reads at least once, for the bounds.
    Its reshapes and views mark too; every other result is a plain
    tensor."""

    read = None  # bool [rows of the flat table]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **(kwargs or {}))
            if (func is torch.Tensor.__getitem__ and args[0].dim() == 2
                    and isinstance(args[1], torch.Tensor)):
                cls.read[args[1]] = True
            elif func in (torch.Tensor.reshape, torch.Tensor.view):
                out = out.as_subclass(cls)
        return out


def _row_log(bvh):
    """(a copy of bvh whose node table marks the rows read, the marks)."""
    n_rows = bvh.nodes.numel() // bvh.nodes.shape[-1]
    _RowLog.read = torch.zeros(n_rows, dtype=torch.bool,
                               device=bvh.nodes.device)
    return (dataclasses.replace(bvh, nodes=bvh.nodes.as_subclass(_RowLog)),
            _RowLog.read)


def _sl_check(scene, bvh, which, fmt, dev, tag):
    """The kernel == its plain version (closest and any hit) on ~1M rays;
    the plain version against brute force on 4,096 of them."""
    kwalk, pwalk = SL_WALKS[fmt]

    def first_hit(o0, d0):
        h = kwalk(bvh, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    rays = _scene_rays(first_hit, which, dev)
    o, d, t_min, t_max, sd, s_max = rays
    plain, errs, stats = {}, {}, {}
    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        dd, tm = (sd, s_max) if any_hit else (d, t_max)
        k = kwalk(bvh, o, dd, t_min, tm, any_hit)
        # kernel 2's plain version adds each ray's leaf tests
        p, *stats[kind] = pwalk(bvh, o, dd, t_min, tm, any_hit,
                                with_stats=True)
        torch.cuda.synchronize()
        for f in ("hit", "t", "u", "v", "tri"):
            diff = getattr(k, f) != getattr(p, f)
            check(not bool(diff.any()),
                  f"{tag} {kind}: {f} differs from plain on "
                  f"{int(diff.sum())} rays, e.g. "
                  f"{torch.nonzero(diff)[:8, 0].tolist()}")
        check(not k.hit[tm < 0].any(), f"{tag} {kind}: a dead ray hit")
        m = k.hit
        errs[kind] = float(torch.stack([
            (getattr(k, f)[m] - getattr(p, f)[m]).abs().max()
            for f in ("t", "u", "v")]).max()) if m.any() else 0.0
        plain[kind] = p
    n = o.shape[0]
    sub = torch.arange(0, n, n // BRUTE_SUB, device=dev)[:BRUTE_SUB]
    brute = _brute_mismatches(scene.triangles, plain["closest"],
                              plain["any"], sub, o, d, sd, t_min, t_max,
                              s_max, coplanar_apart=True)
    b_allowed = _check_brute(brute, sub, tag)
    return {"rays": n, "max_abs_err": errs, "brute": brute,
            "brute_allowed": b_allowed}, rays, stats


def _sl_times(bvh, fmt, rays, stats, detail=True):
    """ms of the kernel on one 262,144-ray bounce batch, its plain
    version's (marking the rows it reads), and the bound from what the
    plain version read: each ray once, each row it touched once, the chunk
    boxes; the operations of its row visits and of one scan of the chunk
    boxes per live ray, however often the walk rescans them (`stats`: rows
    and chunks per ray of every ray, from _sl_check). Without `detail` (a
    scene the kernels line does not report) only the kernel's ms and the
    rows and chunks per live ray."""
    kwalk, pwalk = SL_WALKS[fmt]
    o, d, t_min, t_max, sd, s_max = rays
    b = slice(BATCH, 2 * BATCH)
    n_c = bvh.num_chunks
    out = {}
    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        args = ((o[b], sd[b], t_min[b], s_max[b]) if any_hit
                else (o[b], d[b], t_min[b], t_max[b]))
        ms = time_ms(lambda: kwalk(bvh, *args, any_hit), 10)
        rows, chunks, *tests = (x[b] for x in stats[kind])
        live = max(int((args[3] >= 0).sum()), 1)
        out[kind] = {"ms": ms, "rows_per_live_ray": int(rows.sum()) / live,
                     "chunks_per_live_ray": int(chunks.sum()) / live}
        if not detail:
            continue
        logged, read = _row_log(bvh)
        plain_ms = time_ms(lambda: pwalk(logged, *args, any_hit), 1,
                           warm=False)
        rows_read = int(read.sum())
        ops = (int(rows.sum()) * (OPS_ROW if fmt == "widerow" else OPS_QROW)
               + live * n_c * OPS_SLAB)
        bms, by = bound(BATCH * (RAY_IN + RAY_OUT) + rows_read
                        * ROW_BYTES[fmt] + n_c * CHUNK_BYTES, ops)
        out[kind].update(plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         rows_read=rows_read,
                         candidates=_candidates(bvh.chunk_lo, bvh.chunk_hi,
                                                *args, chunks))
        if tests:
            out[kind]["trips"] = _trips(
                *chunked_trips(rows, tests[0], bvh.arity), args[3] >= 0)
    return out


def _lanegroup_check(bvh, dev):
    """Kernel 9 with each group count on ~1M small-scene rays: equal to its
    plain version, and to the per-ray walk in hits and t (tri only on
    ties); times at one bounce batch beside kernel 1's."""
    def first_hit(o0, d0):
        h = walk_cuda(bvh, o0, d0, 0.0, 1e30, any_hit=False)
        return h.t, h.hit

    o, d, t_min, t_max, _, _ = _scene_rays(first_hit, "small", dev)
    ref = walk_plain(bvh, o, d, t_min, t_max, any_hit=False)
    b = slice(BATCH, 2 * BATCH)
    args = (o[b], d[b], t_min[b], t_max[b])
    k1_ms = time_ms(lambda: walk_cuda(bvh, *args, False), 20)
    logged, read = _row_log(bvh)
    _, rows = walk_plain(logged, *args, False, with_stats=True)
    bms, by = bound(BATCH * (RAY_IN + RAY_OUT) + int(read.sum())
                    * ROW_BYTES["widerow"], int(rows.sum()) * OPS_ROW)
    out = {"rays": o.shape[0], "kernel1_ms": k1_ms}
    for g in lanegroup.GROUPS:
        k, kr = walk_lanegroup_cuda(bvh, o, d, t_min, t_max, g,
                                    with_stats=True)
        p, pr, steps = walk_lanegroup_plain(bvh, o, d, t_min, t_max, g,
                                            with_stats=True, with_steps=True)
        torch.cuda.synchronize()
        for f in ("hit", "t", "u", "v", "tri"):
            check(torch.equal(getattr(k, f), getattr(p, f)),
                  f"lanegroup G={g}: {f} differs from plain")
        check(torch.equal(kr, pr), f"lanegroup G={g}: rows differ")
        check(torch.equal(k.hit, ref.hit) and torch.equal(k.t, ref.t),
              f"lanegroup G={g}: hit or t differs from the per-ray walk")
        m = k.hit
        err = float(torch.stack([
            (getattr(k, f)[m] - getattr(p, f)[m]).abs().max()
            for f in ("t", "u", "v")]).max()) if m.any() else 0.0
        tri_diff = k.tri != ref.tri
        live = max(int((t_max >= 0).sum()), 1)
        ms = time_ms(lambda: walk_lanegroup_cuda(bvh, *args, g), 20)
        plain_ms = time_ms(lambda: walk_lanegroup_plain(bvh, *args, g), 1,
                           warm=False)
        # the timed batch's groups (a group walks its own rays only)
        lanes = lanegroup.LANES // g
        b_steps = steps[BATCH // lanes:2 * BATCH // lanes]
        out[f"g{g}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "max_abs_err": err,
                        "tri_ties_vs_per_ray": int(tri_diff.sum()),
                        "rows_per_live_ray": int(kr.sum()) / live,
                        "groups": group_steps(pr[b].cpu().numpy(),
                                              b_steps.cpu().numpy(), g)}
    return out


def phase_sl_kernels(report, built, small_bvh, dev):
    out = {}
    for name in ("chunked_traverse", "qrow_traverse"):
        print(f"[16 single-level kernels] ptxas {name}: "
              f"{' | '.join(_ptxas(name))}", flush=True)
    for key, (scene, bvh) in built.items():
        which, fmt = key.split("_")
        r, rays, stats = _sl_check(scene, bvh, which, fmt, dev, key)
        r["times"] = _sl_times(bvh, fmt, rays, stats,
                               detail=which == "city")
        del rays, stats
        out[key] = r
        t = r["times"]
        print(f"[16 single-level kernels {key}] {r['rays']} rays: kernel == "
              f"plain (t/u/v/tri identical, closest and any hit); brute "
              f"{BRUTE_SUB} rays: {r['brute']} (allowed "
              f"{r['brute_allowed']}); pick: "
              f"{_pick_smem_line('chunks', bvh.num_chunks)}", flush=True)
        for kind, e in t.items():
            if "plain_ms" not in e:
                print(f"[16 single-level kernels {key}] {BATCH}-ray bounce "
                      f"batch {kind}: {e['ms']:.4f} ms; per live ray "
                      f"{e['rows_per_live_ray']:.1f} rows, "
                      f"{e['chunks_per_live_ray']:.2f} chunks", flush=True)
                continue
            print(f"[16 single-level kernels {key}] {BATCH}-ray bounce "
                  f"batch {kind}: {e['ms']:.4f} ms (plain "
                  f"{e['plain_ms']:.1f} ms, bound {e['bound_ms']:.4f} ms by "
                  f"{e['bound_by']}); per live ray "
                  f"{e['rows_per_live_ray']:.1f} rows, "
                  f"{e['chunks_per_live_ray']:.2f} chunks; rows read "
                  f"{e['rows_read']} of {bvh.num_chunks * bvh.rows_per_chunk}"
                  f"; {_cand_line(e['candidates'])}"
                  + (f"; {_trip_line(e['trips'])}" if "trips" in e else ""),
                  flush=True)
    lg = _lanegroup_check(small_bvh, dev)
    out["lanegroup_small"] = lg
    for g in lanegroup.GROUPS:
        e = lg[f"g{g}"]
        print(f"[16 lane groups small] G={g}: {lg['rays']} rays == plain "
              f"(t/u/v/tri/rows identical), == the per-ray walk in hit and "
              f"t ({e['tri_ties_vs_per_ray']} tri ties); {BATCH}-ray bounce "
              f"batch {e['ms']:.4f} ms (kernel 1 {lg['kernel1_ms']:.4f} ms, "
              f"plain {e['plain_ms']:.1f} ms, bound {e['bound_ms']:.4f} ms "
              f"by {e['bound_by']}), {e['rows_per_live_ray']:.1f} rows per "
              f"live ray; on the batch {group_line(e['groups'])}",
              flush=True)
    report["sl_kernels"] = out
    return out


def phase_sl_slice(report, built, dev):
    out = {}
    for fmt in SL_FORMATS:
        scene, bvh = built[f"big_{fmt}"]
        r = _render_pair(scene, bvh, "big", dev, f"single-level slice {fmt}")
        out[fmt] = r
        print(f"[17 single-level slice] big {fmt} 64x64 2spp cuda vs cpu: "
              f"image rel diff {r['image_rel_diff']:.3g} (bar {IMAGE_BAR}), "
              f"rays {r['rays_cuda']:.0f} vs {r['rays_cpu']:.0f}", flush=True)
    report["sl_slice"] = out


def _all_counts():
    """The walk launches counted since the last _reset_counts(), by kernel
    and query, 0 where a kernel was not launched (lane-group walks by their
    group count)."""
    c = trace.counters("walk.")
    qs = ("closest", "any")
    keys = {"kernel1": qs, "chunked": qs, "qrow": qs,
            "lanegroup": lanegroup.GROUPS,
            "instanced": [f"{q}_{r}" for q in qs for r in instanced.ROUTES],
            "skip": [f"{q}_{s}" for q in qs for s in SCOPES]}
    return {kind: {k: c.get(f"walk.{kind}.{k}", 0) for k in ks}
            for kind, ks in keys.items()}


def _loop_counts():
    """The displaced calls' loop counters (techniques/tfdm.py
    LOOP_COUNTERS) since their last reset, 0 where none counted."""
    from gfxexp_torch.techniques import tfdm

    c = trace.counters("tfdm.")
    return {k: c.get(f"tfdm.{k}", 0) for k in tfdm.LOOP_COUNTERS}


def phase_sl_main(report, built, small, dev):
    small_q = [x.to(dev) for x in bench.build_bench_scene(traversal="qrow")]
    runs = (("big_widerow", "big", built["big_widerow"], None),
            ("big_qrow", "big", built["big_qrow"], None),
            ("city_qrow", "city", built["city_qrow"], None),
            ("small_qrow", "small", small_q, None),
            ("small_nopersist", "small", small, False))
    _reset_counts()
    rows = {}
    try:
        for key, which, (scene, bvh), persist in runs:
            widerow.set_persistent(persist)
            torch.cuda.reset_peak_memory_stats(dev)
            rows[key] = bench.measure("512", scene, bvh, device=dev,
                                      which=which)
            rows[key]["peak_memory_bytes"] = \
                torch.cuda.max_memory_allocated(dev)
    finally:
        widerow.set_persistent(None)
    counts = _all_counts()
    check(all(v > 0 for v in counts["chunked"].values())
          and all(v > 0 for v in counts["qrow"].values()),
          f"single-level main path left kernel 2 or the quantized walk "
          f"unlaunched: {counts}")
    check(not any(counts["kernel1"].values())
          and not any(counts["lanegroup"].values())
          and not any(counts["instanced"].values())
          and not any(counts["skip"].values()),
          f"single-level main path launched another walk: {counts}")
    for key, r in rows.items():
        _check_bench_row(r, f"single-level main {key}")
        lc = {k: v for k, v in r["launches"].items() if v}
        walks = {k: v for k, v in lc.items() if not k.startswith("shade_")}
        want = "qrow" if "qrow" in key else "chunked"
        check(all(v > 0 for k, v in walks.items() if k.startswith(want))
              and set(k.split("_")[0] for k in walks) == {want},
              f"single-level main {key}: timed-run launches {lc}")
        print(f"[18 single-level main {key}] {r['metric']} {r['value']} "
              f"Mrays/s, {r['rays']:.0f} rays in {r['seconds']:.3f}s, mean "
              f"radiance {r['mean_radiance']:.5f}, peak memory "
              f"{r['peak_memory_bytes'] / 1e9:.2f} GB, timed-run launches "
              f"{lc}", flush=True)
        _save(r, f"torch_bench_{key}.png")
    print(f"[18 single-level main] launches: {counts}", flush=True)
    prof = {}
    for key, which, (scene, bvh), _ in runs[:3]:
        prof[key] = _print_profile(f"18 single-level profile {key}",
                                   _profile_sample(scene, bvh, which, dev))
    report["sl_main"] = {k: {f: v for f, v in r.items() if f != "image"}
                         for k, r in rows.items()}
    report["sl_main_launches"] = counts
    report["sl_profile"] = prof
    return counts


# ---------------------------------------------------------------------------
# phases 19-21: the screen-space techniques (G-buffer, SVGF, ReSTIR DI)
# ---------------------------------------------------------------------------

GB_RES = 256  # phase 19's G-buffers
TECH_W, TECH_H = 1920, 1080  # the techniques' frames (BASELINE.json's size)
TECH_FRAMES = 8  # the svgf app's frames per scene (phase 20)
RESTIR_FRAMES = 4  # ReSTIR frames per pipeline at 1080p (phase 21)
SVGF_BAR = 1e-3  # card vs CPU, mean relative difference per SVGF frame
# card vs CPU G-buffer planes where hit, tri, unit and material agree. An
# animated scene's world triangles come from each device's own
# advance_frame (slerp's sin, cos and arccos round differently), so normals,
# and the albedo that follows from them, differ by up to ~2.4e-5 there
GB_BARS = {"position": 1e-4, "normal": 1e-4, "albedo": 1e-4, "motion": 1e-3}
# the many-light scene's camera: above and in front of the emitter grid
ML_CAMERA = dict(position=[0.0, 5.0, 11.0], target=[0.0, 0.0, 0.0])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6))


def _reset_counts():
    trace.reset_counters("walk.")


def _route_launched(counts, route, kinds=("closest", "any")):
    """Whether the route's walks of `kinds` were launched and no other walk
    was: kernel 1 for a static wide-row table, kernel 6's per-ray scope for
    a skip-link table."""
    group, suffix = {"widerow": ("kernel1", ""),
                     "skip": ("skip", "_thread")}[route]
    keys = [k + suffix for k in kinds]
    return all(counts[group][k] > 0 for k in keys) and not any(
        v for g, c in counts.items() for k, v in c.items()
        if not (g == group and k in keys))


def phase_gbuffer(report, dev):
    """G-buffers of the small scene (kernel 1) and of `big` animated after
    one advance_frame (kernel 6), card against CPU at GB_RES^2."""
    from gfxexp_torch.accel.traverse import _check_structure
    from gfxexp_torch.render.gbuffer import render_gbuffer

    rows = {}
    for key, which, traversal in (("small", "small", "widerow"),
                                  ("big_animated", "big", "skip")):
        scene, bvh = bench.build_bench_scene(which, traversal=traversal)
        sd, bd = scene.to(dev), bvh.to(dev)
        if traversal == "skip":
            ctl = bench.bench_controllers(which)
            scene, bvh = animation.advance_frame(scene, bvh, ctl, 1 / 60)
            sd, bd = animation.advance_frame(sd, bd, ctl, 1 / 60)
        route = _check_structure(bd)
        check(route == traversal, f"19 gbuffer {key}: route {route}")
        cam = bench.bench_camera(GB_RES, GB_RES, which)
        prev = dataclasses.replace(cam, position=cam.position
                                   + torch.tensor([0.02, 0.0, 0.0]))
        _reset_counts()
        t0 = time.perf_counter()
        a = render_gbuffer(sd, bd, cam.to(dev), prev.to(dev), GB_RES, GB_RES,
                           1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _all_counts()
        check(_route_launched(counts, route, ("closest",)),
              f"19 gbuffer {key}: the card's G-buffer did not take the CUDA "
              f"{route} walk: {counts}")
        b = render_gbuffer(scene, bvh, cam, prev, GB_RES, GB_RES, 1)
        a = a.to("cpu")
        check(torch.equal(a.hit, b.hit), f"19 gbuffer {key}: hit differs")
        same = ((a.tri == b.tri) & (a.unit == b.unit)
                & (a.material == b.material))
        depth_tie = (a.depth - b.depth).abs() <= 1e-6 * b.depth.abs()
        check(bool((same | (a.hit & depth_tie)).all()),
              f"19 gbuffer {key}: ids differ off a tie in t")
        share = float(same.float().mean())
        check(share >= 0.999, f"19 gbuffer {key}: ids equal on {share}")
        errs = {n: float((getattr(a, n)[same] - getattr(b, n)[same]).abs()
                         .max()) for n in GB_BARS}
        check(all(errs[n] <= GB_BARS[n] for n in GB_BARS)
              and torch.isfinite(a.position).all(),
              f"19 gbuffer {key}: planes {errs} (bars {GB_BARS})")
        rows[key] = {"route": route, "ids_equal_share": share,
                     "max_abs_err": errs, "hit_share":
                     float(a.hit.float().mean()), "ms_first_call": ms,
                     "launches": {g: {k: v for k, v in c.items() if v}
                                  for g, c in counts.items()},
                     "moving_share": float((a.motion.abs().sum(-1) > 0)
                                           .float().mean())}
        print(f"[19 gbuffer {key}] {GB_RES}x{GB_RES} on the card ({route} "
              f"CUDA walk, launches {rows[key]['launches']}) vs the CPU: "
              f"hit equal, tri/unit/material equal on {share:.5f} of "
              f"pixels (bar 0.999, the rest ties in t), max abs err "
              + ", ".join(f"{n} {v:.3g}" for n, v in errs.items())
              + f" (bars {GB_BARS}); hit share {rows[key]['hit_share']:.3f}, "
              f"moving share {rows[key]['moving_share']:.3f}", flush=True)
    report["gbuffer"] = rows


def _profile_pass(tag, fn, what):
    return _print_profile(tag, _profile(lambda _: fn()), what)


def phase_svgf(report, dev):
    """SVGF: 8 frames on the card against the CPU from the same inputs;
    then the svgf app's frame loop at 1920x1080 on the small scene (static,
    kernel 1) and `big` animated (kernel 6), TECH_FRAMES each."""
    from gfxexp_torch.apps import svgf as svgf_app
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.techniques.svgf import (
        SVGFConfig,
        make_svgf_state,
        svgf_frame,
    )

    cfg = SVGFConfig()
    pt_cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH)
    res = 128
    scene, bvh = (x.to(dev) for x in bench.build_bench_scene())
    cam = bench.bench_camera(res, res).to(dev)
    sd, sc = make_svgf_state(res, res, dev), make_svgf_state(res, res, "cpu")
    diffs = []
    for f in range(8):
        gb = render_gbuffer(scene, bvh, cam, cam, res, res, f)
        light = render_sample(scene, bvh, cam, res, res, f,
                              pt_cfg).reshape(res, res, 3)
        a, sd = svgf_frame(sd, gb, light, cfg)
        b, sc = svgf_frame(sc, gb.to("cpu"), light.cpu(), cfg)
        check(bool(torch.isfinite(a).all()), "20 svgf: non-finite pixels")
        diffs.append(_rel(a.cpu().numpy(), b.numpy()))
    check(max(diffs) < SVGF_BAR,
          f"20 svgf: card vs cpu rel diffs {diffs} (bar {SVGF_BAR})")
    print(f"[20 svgf] 8 frames at {res}x{res}, card vs CPU from the same "
          f"G-buffers and lighting: mean rel diff per frame max "
          f"{max(diffs):.3g} (bar {SVGF_BAR})", flush=True)
    rows = {"card_vs_cpu_rel_diffs": diffs}
    for key, which, traversal in (("small", "small", "widerow"),
                                  ("big_animated", "big", "skip")):
        scene, bvh = (x.to(dev) for x in bench.build_bench_scene(
            which, traversal=traversal))
        ctl = bench.bench_controllers(which) if traversal == "skip" else []
        cam = bench.bench_camera(TECH_W, TECH_H, which).to(dev)
        args = (cam, ctl, traversal, TECH_W, TECH_H)
        # one warm-up frame (the caching allocator fills up)
        svgf_app.frame_loop(scene, bvh, *args, 1, pt_cfg, cfg,
                            PassTimer(device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        timer = PassTimer(device=dev)
        _reset_counts()
        t0 = time.perf_counter()
        final, state, s2, b2 = svgf_app.frame_loop(
            scene, bvh, *args, TECH_FRAMES, pt_cfg, cfg, timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_counts()
        check(_route_launched(counts, traversal),
              f"20 svgf {key}: the frame loop did not take the CUDA "
              f"{traversal} walk: {counts}")
        check(final.shape == (TECH_H, TECH_W, 3)
              and bool(torch.isfinite(final).all())
              and float(final.mean()) > 0, f"20 svgf {key}: bad image")
        ms = {p: timer.mean_ms(p) for p in timer.samples}
        gb = render_gbuffer(s2, b2, cam, cam, TECH_W, TECH_H, TECH_FRAMES)
        light = render_sample(s2, b2, cam, TECH_W, TECH_H, TECH_FRAMES,
                              pt_cfg).reshape(TECH_H, TECH_W, 3)
        prof = {
            "svgf": _profile_pass(
                f"20 svgf profile {key}",
                lambda: svgf_frame(state, gb, light, cfg), "one svgf pass"),
            "gbuffer": _profile_pass(
                f"20 gbuffer profile {key}",
                lambda: render_gbuffer(s2, b2, cam, cam, TECH_W, TECH_H, 1),
                "one gbuffer pass")}
        rows[key] = {"frames": TECH_FRAMES, "ms_per_frame": ms,
                     "wall_s": wall, "peak_memory_bytes":
                     torch.cuda.max_memory_allocated(dev),
                     "launches": {g: {k: v for k, v in c.items() if v}
                                  for g, c in counts.items()},
                     "mean": float(final.mean()), "profile": prof}
        save_png(os.path.join(REPO, "out", f"torch_svgf_{key}.png"),
                 (final / (1.0 + final)).cpu().numpy())
        print(f"[20 svgf {key}] {TECH_FRAMES} frames at {TECH_W}x{TECH_H}, "
              f"ms per frame: " + ", ".join(f"{p} {v:.2f}"
                                            for p, v in ms.items())
              + f"; wall {wall:.2f}s, peak memory "
              f"{rows[key]['peak_memory_bytes'] / 1e9:.2f} GB, walk "
              f"launches {rows[key]['launches']}", flush=True)
    report["svgf"] = rows


def _many_light_scene(n_lights=256, seed=3, albedo=0.6, occluders=16):
    """tests/scenes.py many_light_scene's recipe at 256 emitters (a 16 x 16
    grid of 0.15 squares at y = 2, spaced 1.2, of random intensity 1-60,
    over a 20 x 20 floor), with `occluders` spheres of radius 0.35 under
    them that cast shadows; compiled as wide rows, the apps' default for a
    static scene."""
    from gfxexp_torch.scene.builder import SceneBuilder, affine
    from gfxexp_torch.scene.compile import compile_scene

    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    floor = b.add_lambert_material((albedo, albedo, albedo))
    b.add_instance(b.add_rectangle(20.0, 20.0, floor))
    side = int(np.sqrt(n_lights))
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    for i in range(side):
        for j in range(side):
            e = float(rng.uniform(1.0, 60.0))
            m = b.add_lambert_material((0, 0, 0), emittance=(e, e, e))
            g = b.add_rectangle(0.15, 0.15, m)
            b.add_instance(g, affine(rotation=flip, translation=[
                (i - side / 2 + 0.5) * 1.2, 2.0, (j - side / 2 + 0.5) * 1.2]))
    mat = b.add_lambert_material((0.5, 0.4, 0.3))
    sph = b.add_sphere(0.35, mat, n_theta=10, n_phi=20)
    for _ in range(occluders):
        x, z = rng.uniform(-6.0, 6.0, 2)
        b.add_instance(sph, affine(translation=[x, 0.8, z]))
    return compile_scene(b, traversal="widerow")


def _ml_camera(w, h):
    from gfxexp_torch.render.camera import make_camera

    return make_camera(ML_CAMERA["position"], fov_y=np.deg2rad(50),
                       aspect=w / h, target=ML_CAMERA["target"])


def _count_shadow_rays(fn, module):
    """fn() with the shadow rays that `module`'s any-hit queries trace
    counted (the lanes the walk takes, t_max >= 0): (fn's result, shadow
    rays)."""
    orig = module.intersect_any
    counted = []

    def any_hit(bvh, tris, o, d, t_min=0.0, t_max=1e30):
        counted.append((t_max >= 0.0).sum())
        return orig(bvh, tris, o, d, t_min=t_min, t_max=t_max)

    module.intersect_any = any_hit
    try:
        out = fn()
    finally:
        module.intersect_any = orig
    return out, float(sum(counted)) if counted else 0.0


def _png_cli(tag, module, argv, size):
    out = os.path.join(REPO, "out", f"cli_{tag}")
    if os.path.exists(out + ".png"):
        os.remove(out + ".png")
    cmd = [sys.executable, "-m", module, "-width", str(size), "-height",
           str(size), "-frames", "4", "-stats", "-output", out, *argv]
    return out, subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=dict(os.environ, PYTHONPATH=REPO))


def phase_restir(report, dev):
    """ReSTIR DI: both pipelines 4 frames card against CPU at 64^2, then at
    1920x1080 on the 256-emitter scene; then the svgf, restir_di -rearch
    and path_tracing -denoise CLIs at 64^2 on the card, all three at
    once."""
    from gfxexp_torch.apps import restir_di as restir_app
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.techniques import restir_di
    from gfxexp_torch.techniques.restir_di import (
        ReSTIRConfig,
        empty_reservoir,
        empty_sample_visibility,
        pixel_ctx,
        restir_di_frame,
    )

    t0 = time.time()
    scene_c, bvh_c = _many_light_scene()
    build_s = time.time() - t0
    scene, bvh = scene_c.to(dev), bvh_c.to(dev)
    rows = {"scene": {"triangles": scene.num_triangles,
                      "emissive_units": int((scene_c.units.emissive_importance
                                             > 0).sum()),
                      "host_build_s": build_s}}
    pipelines = {"classic": ReSTIRConfig(),
                 "rearch": ReSTIRConfig(use_rearchitected_pipeline=True)}
    for name, cfg in pipelines.items():
        imgs = {}
        for where, s, b in (("cuda", scene, bvh), ("cpu", scene_c, bvh_c)):
            cam = _ml_camera(64, 64).to(s.device)
            film, _, _ = restir_app.frame_loop(s, b, cam, [], "widerow", 64,
                                               64, 4, cfg, True,
                                               PassTimer(device=s.device))
            imgs[where] = film.beauty.cpu().numpy()
        rel = _rel(imgs["cuda"], imgs["cpu"])
        check(np.isfinite(imgs["cuda"]).all() and imgs["cuda"].mean() > 0
              and rel < IMAGE_BAR,
              f"21 restir {name}: card vs cpu rel diff {rel}")
        rows[f"{name}_card_vs_cpu_rel_diff"] = rel
        print(f"[21 restir {name}] 4 frames at 64x64 on the 256-emitter "
              f"scene, card vs CPU: image rel diff {rel:.3g} (bar "
              f"{IMAGE_BAR})", flush=True)
    cam = _ml_camera(TECH_W, TECH_H).to(dev)
    n = TECH_W * TECH_H
    for name, cfg in pipelines.items():
        restir_app.frame_loop(scene, bvh, cam, [], "widerow", TECH_W, TECH_H,
                              1, cfg, True, PassTimer(device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        timer = PassTimer(device=dev)
        _reset_counts()
        trace.reset_counters("restir.")
        film, _, _ = restir_app.frame_loop(scene, bvh, cam, [], "widerow",
                                           TECH_W, TECH_H, RESTIR_FRAMES, cfg,
                                           True, timer)
        torch.cuda.synchronize()
        counts = _all_counts()
        check(_route_launched(counts, "widerow"),
              f"21 restir {name}: the frames did not take kernel 1: {counts}")
        # the resampling kernels: the initial stream only in the
        # rearchitected pipeline, every (biased) spatial pass
        routed = trace.counters("restir.")
        initial = ("restir.kernel.initial" if cfg.use_rearchitected_pipeline
                   else "restir.eager.initial")
        check(routed == {initial: RESTIR_FRAMES,
                         "restir.kernel.spatial": RESTIR_FRAMES
                         * cfg.num_spatial_passes},
              f"21 restir {name}: the stages' routes {routed}")
        img = film.beauty
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
              f"21 restir {name}: bad image")
        # one more frame, its shadow rays counted, and one under the
        # profiler, from the same state
        gb = render_gbuffer(scene, bvh, cam, cam, TECH_W, TECH_H, 0)
        ctx = pixel_ctx(scene, gb, cam)
        flat = (gb.hit.reshape(n), gb.position.reshape(n, 3),
                gb.normal.reshape(n, 3))
        state = (empty_reservoir(n, dev), ctx)
        out = restir_di_frame(scene, bvh, gb, cam, *state, *flat, 0, cfg,
                              empty_sample_visibility(n, dev))
        (col, res, ctx2, vis), rays = _count_shadow_rays(
            lambda: restir_di_frame(scene, bvh, gb, cam, out[1], out[2],
                                    *flat, 1, cfg, out[3]), restir_di)
        prof = _profile_pass(
            f"21 restir profile {name}",
            lambda: restir_di_frame(scene, bvh, gb, cam, res, ctx2, *flat, 2,
                                    cfg, vis), "one restir frame")
        ms = {p: timer.mean_ms(p) for p in timer.samples}
        rows[name] = {"frames": RESTIR_FRAMES, "ms_per_frame": ms,
                      "stage_routes": routed,
                      "shadow_rays_per_frame": rays,
                      "peak_memory_bytes":
                      torch.cuda.max_memory_allocated(dev),
                      "launches": {g: {k: v for k, v in c.items() if v}
                                   for g, c in counts.items()},
                      "launches_per_frame": {
                          k: v / RESTIR_FRAMES
                          for k, v in counts["kernel1"].items()},
                      "mean": float(img.mean()), "profile": prof}
        save_png(os.path.join(REPO, "out", f"torch_restir_{name}.png"),
                 (img / (1.0 + img)).cpu().numpy())
        print(f"[21 restir {name}] {RESTIR_FRAMES} frames at "
              f"{TECH_W}x{TECH_H}, ms per frame: " + ", ".join(
                  f"{p} {v:.2f}" for p, v in ms.items())
              + f"; {rays:.0f} shadow rays per frame ({rays / n:.2f} per "
              f"pixel), kernel 1 launches per frame "
              f"{rows[name]['launches_per_frame']}, peak memory "
              f"{rows[name]['peak_memory_bytes'] / 1e9:.2f} GB", flush=True)
    # the three CLIs at once, after the timed frames
    clis = {tag: _png_cli(tag, mod, argv, 64) for tag, mod, argv in (
        ("svgf", "gfxexp_torch.apps.svgf", []),
        ("restir_di", "gfxexp_torch.apps.restir_di", ["-rearch"]),
        ("path_tracing_denoise", "gfxexp_torch.apps.path_tracing",
         ["-denoise"]))}
    for tag, (out, proc) in clis.items():
        _, err = proc.communicate(timeout=300)
        check(proc.returncode == 0,
              f"21 CLI {tag} exited {proc.returncode}: {err[-2000:]}")
        px = _png_pixels(out + ".png")
        check(px.shape == (64, 64, 3) and px.any(),
              f"21 CLI {tag}: PNG {px.shape}, all black {not px.any()}")
        stats = [ln for ln in err.splitlines() if ln.startswith("final:")]
        rows[f"cli_{tag}"] = {"stats": stats[-1] if stats else None,
                              "mean_pixel": float(px.mean())}
        print(f"[21 CLI {tag}] 64x64, 4 frames: rc 0, out/cli_{tag}.png "
              f"mean pixel {px.mean():.1f}; "
              f"{stats[-1] if stats else ''}", flush=True)
    report["restir"] = rows


CHECK_RES = 64  # ReGIR and NRC card-against-CPU frames (phases 22-23)
REGIR_CHECK_FRAMES = 4
REGIR_FRAMES = 4  # the regir app's frames at 1080p (phase 22)
# phase 22's card-against-CPU grid, (8, 4, 8) cells x 64 slots
REGIR_SMALL = dict(grid_dimension=(8, 4, 8), num_light_slots_per_cell=64)
SEL_BAR = 0.999  # card vs CPU: share of slots whose selected sample agrees
NRC_FRAMES = 16  # the NRC app's frames at 1080p, triangle wave (phase 23)
NRC_HASH_FRAMES = 4  # and with the hash grid
NRC_PARAM_ATOL = 1e-5  # card vs CPU parameters after one frame's training
NRC_PARAM_SHARE = 0.999  # the share of entries that must meet it


def _per_frame(counts, frames):
    return {g: {k: v / frames for k, v in c.items() if v}
            for g, c in counts.items() if any(c.values())}


def _regir_card_vs_cpu(tag, scene_c, bvh_c, cam_c, ctl, dev):
    """REGIR_CHECK_FRAMES frames of build_cell_reservoirs and
    render_sample_regir at CHECK_RES^2, each device on its own state, from
    the same scene (an animated one advanced on the CPU and copied to the
    card each frame): selections, reservoir numbers, images, touches."""
    from gfxexp_torch.accel.traverse import _check_structure
    from gfxexp_torch.techniques.regir import (
        ReGIRConfig,
        build_cell_reservoirs,
        finalize_frame,
        make_grid,
        make_regir_state,
        render_sample_regir,
    )

    cfg = ReGIRConfig(**REGIR_SMALL)
    pt = PTConfig(max_path_length=bench.MAX_PATH_LENGTH, count_rays=True)
    res = CHECK_RES
    grid_c = make_grid(scene_c, cfg)
    states = {"cuda": make_regir_state(cfg, dev),
              "cpu": make_regir_state(cfg, "cpu")}
    frames = []
    _reset_counts()
    for f in range(REGIR_CHECK_FRAMES):
        if ctl:
            scene_c, bvh_c = animation.advance_frame(scene_c, bvh_c, ctl,
                                                     f / 60.0)
        out = {}
        for where, to in (("cuda", dev), ("cpu", "cpu")):
            s, b, c, g = (x.to(to) for x in (scene_c, bvh_c, cam_c, grid_c))
            built = build_cell_reservoirs(s, states[where], g, f, cfg)
            img, st, rays = render_sample_regir(s, b, c, built, g, res, res,
                                                f, pt, cfg)
            states[where] = finalize_frame(st, f)
            out[where] = (built.to("cpu"), img.cpu(), float(rays),
                          st.num_accesses.cpu())
        (ra, ia, na, ta), (rb, ib, nb, tb) = out["cuda"], out["cpu"]
        same = (((ra.pos - rb.pos).abs().amax(-1)
                 <= 1e-5 * (1 + rb.pos.abs().amax(-1)))
                & (ra.at_inf == rb.at_inf))
        share = float(same.float().mean())
        errs = {n: float(((getattr(ra, n) - getattr(rb, n)).abs()
                          / (getattr(rb, n).abs() + 1e-6))[same].max())
                for n in ("sum_w", "rec_pdf", "target")}
        rel = _rel(ia.numpy(), ib.numpy())
        touch_rel = float((ta - tb).abs().sum()) / max(float(tb.sum()), 1.0)
        frames.append({"selection_share": share, "max_rel_err": errs,
                       "image_rel_diff": rel, "rays_cuda": na,
                       "rays_cpu": nb, "touch_rel_diff": touch_rel,
                       "active_cells": int((tb > 0).sum())})
        check(share >= SEL_BAR and max(errs.values()) <= 1e-4
              and rel < IMAGE_BAR and abs(na - nb) <= 5e-3 * nb
              and touch_rel <= 5e-3 and bool(torch.isfinite(ia).all())
              and float(ia.mean()) > 0,
              f"22 regir {tag} frame {f}: card vs cpu {frames[-1]}")
    counts = _all_counts()
    route = _check_structure(bvh_c)
    check(_route_launched(counts, route),
          f"22 regir {tag}: the card did not take the CUDA {route} walk: "
          f"{counts}")
    worst = {"selection_share": min(r["selection_share"] for r in frames),
             "image_rel_diff": max(r["image_rel_diff"] for r in frames),
             "max_rel_err": max(max(r["max_rel_err"].values())
                                for r in frames)}
    print(f"[22 regir {tag}] {REGIR_CHECK_FRAMES} frames at {res}x{res}, "
          f"grid {cfg.grid_dimension} x {cfg.num_light_slots_per_cell} "
          f"slots, card ({route} CUDA walk) vs CPU: selections equal on "
          f"{worst['selection_share']:.5f} of slots (bar {SEL_BAR}), "
          f"reservoir numbers within rel {worst['max_rel_err']:.3g} (bar "
          f"1e-4), image rel diff {worst['image_rel_diff']:.3g} (bar "
          f"{IMAGE_BAR}), rays {frames[-1]['rays_cuda']:.0f} vs "
          f"{frames[-1]['rays_cpu']:.0f}", flush=True)
    return {"route": route, "frames": frames, "worst": worst}


def phase_regir(report, dev):
    """ReGIR: 4 frames card against CPU at 64^2 on the 256-emitter scene
    (kernel 1) and on `big` animated (kernel 6); then the regir app's frame
    loop at 1920x1080 with the defaults (16^3 cells x 512 slots) on the
    256-emitter scene, 8 frames."""
    from gfxexp_torch.apps import regir as regir_app
    from gfxexp_torch.techniques import regir
    from gfxexp_torch.techniques.regir import (
        ReGIRConfig,
        build_cell_reservoirs,
        make_grid,
        render_sample_regir,
    )

    scene_c, bvh_c = _many_light_scene()
    rows = {"many_lights": _regir_card_vs_cpu(
        "256 emitters", scene_c, bvh_c, _ml_camera(CHECK_RES, CHECK_RES), [],
        dev)}
    big_s, big_b = bench.build_bench_scene("big", traversal="skip")
    rows["big_animated"] = _regir_card_vs_cpu(
        "big animated", big_s, big_b,
        bench.bench_camera(CHECK_RES, CHECK_RES, "big"),
        bench.bench_controllers("big"), dev)
    big_s = big_b = None

    cfg = ReGIRConfig()
    pt = PTConfig(max_path_length=bench.MAX_PATH_LENGTH)
    scene, bvh = scene_c.to(dev), bvh_c.to(dev)
    cam = _ml_camera(TECH_W, TECH_H).to(dev)
    grid = make_grid(scene, cfg)
    args = (scene, bvh, cam, [], "widerow", TECH_W, TECH_H)
    # one warm-up frame (the caching allocator fills up)
    regir_app.frame_loop(*args, 1, pt, cfg, True, PassTimer(device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timer = PassTimer(device=dev)
    _reset_counts()
    film, state, _, _ = regir_app.frame_loop(*args, REGIR_FRAMES, pt, cfg,
                                             True, timer)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    counts = _all_counts()
    check(_route_launched(counts, "widerow"),
          f"22 regir 1080p: the frames did not take kernel 1: {counts}")
    img = film.beauty
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
          "22 regir 1080p: bad image")
    active = int((state.num_accesses > 0).sum())
    ms = {p: timer.mean_ms(p) for p in timer.samples}
    f = REGIR_FRAMES
    built = build_cell_reservoirs(scene, state, grid, f, cfg)
    _, rays = _count_shadow_rays(lambda: render_sample_regir(
        scene, bvh, cam, built, grid, TECH_W, TECH_H, f, pt, cfg), regir)
    prof = {
        "buildCellReservoirs": _profile_pass(
            "22 regir profile build",
            lambda: build_cell_reservoirs(scene, state, grid, f, cfg),
            "one buildCellReservoirs pass"),
        "pathTrace": _profile_pass(
            "22 regir profile pathTrace",
            lambda: render_sample_regir(scene, bvh, cam, built, grid, TECH_W,
                                        TECH_H, f, pt, cfg),
            "one pathTrace pass")}
    n = TECH_W * TECH_H
    rows["1080p"] = {
        "frames": REGIR_FRAMES, "ms_per_frame": ms,
        "slots": cfg.num_cells * cfg.num_light_slots_per_cell,
        "reservoir_bytes": sum(t.numel() * t.element_size() for t in (
            state.pos, state.nrm, state.emit, state.at_inf, state.sum_w,
            state.stream_len, state.rec_pdf, state.target)),
        "active_cells": active, "shadow_rays_per_frame": rays,
        "launches_per_frame": _per_frame(counts, REGIR_FRAMES),
        "peak_memory_bytes": peak, "mean": float(img.mean()),
        "profile": prof}
    save_png(os.path.join(REPO, "out", "torch_regir.png"),
             (img / (1.0 + img)).cpu().numpy())
    r = rows["1080p"]
    print(f"[22 regir 1080p] {REGIR_FRAMES} frames at {TECH_W}x{TECH_H}, "
          f"{cfg.grid_dimension} cells x {cfg.num_light_slots_per_cell} "
          f"slots ({r['slots']} slots, {r['reservoir_bytes'] / 1e6:.1f} MB "
          f"of reservoirs), ms per frame: " + ", ".join(
              f"{p} {v:.2f}" for p, v in ms.items())
          + f"; {rays:.0f} shadow rays per frame ({rays / n:.2f} per "
          f"pixel), walk launches per frame {r['launches_per_frame']}, "
          f"active cells {active} of {cfg.num_cells}, peak memory "
          f"{peak / 1e9:.2f} GB", flush=True)
    report["regir"] = rows


def _nrc_scene_and_camera(width, height):
    """The neural_radiance_caching app's default scene (the box and lamp)
    as wide rows and its default camera."""
    from gfxexp_torch.apps import common
    from gfxexp_torch.scene.compile import compile_scene

    scene, bvh = compile_scene(common.default_demo_builder(),
                               traversal="widerow")
    args = common.parse_scene_args(common.make_arg_parser("nrc"), [
        "-width", str(width), "-height", str(height)])
    return scene, bvh, common.make_camera_from_args(args)


def _nrc_frames(tag, scene, bvh, cam, nrc_cfg, icfg, frames, dev):
    """The NRC app's frame loop at 1080p: a warm-up frame on a state of its
    own, then `frames` timed frames from a fresh state; one pathTrace+infer
    and one train pass profiled."""
    from gfxexp_torch.apps import neural_radiance_caching as nrc_app
    from gfxexp_torch.techniques.nrc import init_nrc, train_on_frame
    from gfxexp_torch.techniques.nrc.cache import (
        render_sample_nrc,
        scene_aabb,
    )

    aabb = scene_aabb(scene)
    args = (scene, bvh, cam, [], "widerow", TECH_W, TECH_H)
    nrc_app.frame_loop(*args, 1, icfg, nrc_cfg,
                       init_nrc(None, nrc_cfg, dev), aabb,
                       PassTimer(device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timer = PassTimer(device=dev)
    _reset_counts()
    film, state, losses, _, _ = nrc_app.frame_loop(
        *args, frames, icfg, nrc_cfg, init_nrc(None, nrc_cfg, dev), aabb,
        timer)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    counts = _all_counts()
    check(_route_launched(counts, "widerow"),
          f"23 nrc {tag}: the frames did not take kernel 1: {counts}")
    losses = [float(x) for x in losses]
    img = film.beauty
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0
          and all(math.isfinite(x) for x in losses),
          f"23 nrc {tag}: bad image or loss {losses}")
    ms = {p: timer.mean_ms(p) for p in timer.samples}
    out = render_sample_nrc(scene, bvh, cam, state["ema"], *aabb, TECH_W,
                            TECH_H, frames, icfg, nrc_cfg)
    prof = {
        "pathTrace+infer": _profile_pass(
            f"23 nrc profile {tag} pathTrace+infer",
            lambda: render_sample_nrc(scene, bvh, cam, state["ema"], *aabb,
                                      TECH_W, TECH_H, frames, icfg, nrc_cfg),
            "one pathTrace+infer pass"),
        "train": _profile_pass(
            f"23 nrc profile {tag} train",
            lambda: train_on_frame(state, *out[1:], nrc_cfg, 4,
                                   torch.Generator().manual_seed(1)),
            "one train pass (4 steps)")}
    records = int(out[3].numel())
    row = {"frames": frames, "ms_per_frame": ms, "losses": losses,
           "training_records": records,
           "valid_records": int(out[3].sum()),
           "launches_per_frame": _per_frame(counts, frames),
           "peak_memory_bytes": peak, "mean": float(img.mean()),
           "profile": prof}
    save_png(os.path.join(REPO, "out", f"torch_nrc_{tag}.png"),
             (img / (1.0 + img)).cpu().numpy())
    print(f"[23 nrc {tag}] {frames} frames at {TECH_W}x{TECH_H}, ms per "
          f"frame: " + ", ".join(f"{p} {v:.2f}" for p, v in ms.items())
          + f"; {records} training records a frame "
          f"({row['valid_records']} valid in the last), walk launches per "
          f"frame {row['launches_per_frame']}, peak memory "
          f"{peak / 1e9:.2f} GB, loss by frame "
          + " ".join(f"{x:.4g}" for x in losses), flush=True)
    return row


def phase_nrc(report, dev):
    """NRC: render_sample_nrc at 64^2 on the card against the CPU from the
    same weights, and one train_on_frame with the same permutation; then
    the app's frame loop at 1920x1080, 16 frames with the triangle wave
    (its loss must fall) and 4 with the hash grid."""
    from gfxexp_torch.core.tree import tree_leaves, tree_map
    from gfxexp_torch.techniques.nrc import (
        NRCConfig,
        init_nrc,
        train_on_frame,
    )
    from gfxexp_torch.techniques.nrc.cache import (
        NRCIntegratorConfig,
        render_sample_nrc,
        scene_aabb,
    )

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "23 nrc: TF32 matmuls are on")
    res = CHECK_RES
    scene_c, bvh_c, cam_c = _nrc_scene_and_camera(res, res)
    nrc_cfg = NRCConfig()
    icfg = NRCIntegratorConfig(max_path_length=bench.MAX_PATH_LENGTH)
    state_c = init_nrc(torch.Generator().manual_seed(SEED), nrc_cfg, "cpu")
    # a non-zero output layer, so that the cache's reads count
    out_w = torch.randn(state_c["params"]["weights"][-1].shape,
                        generator=torch.Generator().manual_seed(SEED)) * 0.1
    for part in ("params", "ema"):
        state_c[part]["weights"][-1] = out_w.clone()
    state_d = tree_map(lambda x: x.to(dev), state_c)
    aabb_c = scene_aabb(scene_c)
    _reset_counts()
    a = render_sample_nrc(scene_c.to(dev), bvh_c.to(dev), cam_c.to(dev),
                          state_d["ema"], *(x.to(dev) for x in aabb_c), res,
                          res, 1, icfg, nrc_cfg)
    counts = _all_counts()
    b = render_sample_nrc(scene_c, bvh_c, cam_c, state_c["ema"], *aabb_c,
                          res, res, 1, icfg, nrc_cfg)
    a = [x.cpu() for x in a]
    check(_route_launched(counts, "widerow"),
          f"23 nrc: the card did not take kernel 1: {counts}")
    mask_share = float((a[3] == b[3]).float().mean())
    both = a[3] & b[3]
    rel = {"radiance": _rel(a[0].numpy(), b[0].numpy()),
           "targets": _rel(a[2][both].numpy(), b[2][both].numpy())}
    q_err = float((a[1][both] - b[1][both]).abs().max())
    check(mask_share >= SEL_BAR and max(rel.values()) < IMAGE_BAR
          and bool(torch.isfinite(a[0]).all()) and float(a[0].mean()) > 0
          and int(b[3].sum()) > 0,
          f"23 nrc: card vs cpu masks {mask_share}, {rel}")
    # one frame's training from the CPU's records, the same permutation
    ta, la = train_on_frame(state_d, *(x.to(dev) for x in b[1:]), nrc_cfg, 4,
                            torch.Generator().manual_seed(SEED))
    tb, lb = train_on_frame(state_c, *b[1:], nrc_cfg, 4,
                            torch.Generator().manual_seed(SEED))
    diffs = torch.cat([(x.cpu() - y).abs().reshape(-1) for x, y in zip(
        tree_leaves(ta["params"]), tree_leaves(tb["params"]))])
    p_share = float((diffs <= NRC_PARAM_ATOL).float().mean())
    loss_rel = abs(float(la) - float(lb)) / abs(float(lb))
    check(loss_rel <= 1e-4 and p_share >= NRC_PARAM_SHARE,
          f"23 nrc train: loss rel {loss_rel}, params within "
          f"{NRC_PARAM_ATOL} on {p_share} (max {float(diffs.max())})")
    rows = {"card_vs_cpu": {"mask_share": mask_share, "rel_diff": rel,
                            "query_max_abs_err": q_err,
                            "train_loss_rel_diff": loss_rel,
                            "train_param_share": p_share,
                            "train_param_max_abs_err": float(diffs.max())}}
    print(f"[23 nrc] render_sample_nrc at {res}x{res} on the box, card "
          f"(kernel 1) vs CPU from the same weights: training masks equal on "
          f"{mask_share:.5f} (bar {SEL_BAR}), radiance rel diff "
          f"{rel['radiance']:.3g}, targets {rel['targets']:.3g} (bar "
          f"{IMAGE_BAR}), queries within {q_err:.3g}; train_on_frame (4 "
          f"steps, {b[1].shape[0]} records, the same permutation): loss rel "
          f"diff {loss_rel:.3g} (bar 1e-4), params within {NRC_PARAM_ATOL} "
          f"on {p_share:.5f} of entries (bar {NRC_PARAM_SHARE}), max "
          f"{float(diffs.max()):.3g}", flush=True)

    scene, bvh, cam = _nrc_scene_and_camera(TECH_W, TECH_H)
    scene, bvh, cam = scene.to(dev), bvh.to(dev), cam.to(dev)
    rows["triangle_wave"] = _nrc_frames("triangle_wave", scene, bvh, cam,
                                        nrc_cfg, icfg, NRC_FRAMES, dev)
    losses = rows["triangle_wave"]["losses"]
    check(np.mean(losses[-4:]) < np.mean(losses[:4]),
          f"23 nrc: the loss did not fall over {NRC_FRAMES} frames: {losses}")
    rows["hash_grid"] = _nrc_frames(
        "hash_grid", scene, bvh, cam,
        NRCConfig(position_encoding="hash_grid"), icfg, NRC_HASH_FRAMES, dev)
    report["nrc"] = rows


def phase_technique_clis(report):
    """The regir and neural_radiance_caching CLIs at 64^2 on the card (the
    second with -checkpoint), at once; then neural_radiance_caching
    -resume from that checkpoint."""
    ck = os.path.join(REPO, "out", "cli_nrc_checkpoint.npz")
    if os.path.exists(ck):
        os.remove(ck)
    rows = {}
    runs = [{"regir": ("gfxexp_torch.apps.regir", []),
             "neural_radiance_caching": (
                 "gfxexp_torch.apps.neural_radiance_caching",
                 ["-checkpoint", ck])},
            {"neural_radiance_caching_resume": (
                "gfxexp_torch.apps.neural_radiance_caching",
                ["-resume", ck])}]
    for batch in runs:
        clis = {tag: _png_cli(tag, mod, argv, 64)
                for tag, (mod, argv) in batch.items()}
        for tag, (out, proc) in clis.items():
            _, err = proc.communicate(timeout=300)
            check(proc.returncode == 0,
                  f"24 CLI {tag} exited {proc.returncode}: {err[-2000:]}")
            px = _png_pixels(out + ".png")
            check(px.shape == (64, 64, 3) and px.any(),
                  f"24 CLI {tag}: PNG {px.shape}, all black {not px.any()}")
            stats = [ln for ln in err.splitlines()
                     if ln.startswith("final:")]
            rows[tag] = {"stats": stats[-1] if stats else None,
                         "mean_pixel": float(px.mean())}
            if tag.endswith("resume"):
                check(f"resumed cache from {ck}" in err,
                      f"24 CLI {tag}: no resume line")
            print(f"[24 CLI {tag}] 64x64, 4 frames: rc 0, out/cli_{tag}.png "
                  f"mean pixel {px.mean():.1f}; "
                  f"{stats[-1] if stats else ''}", flush=True)
        if "neural_radiance_caching" in batch:
            check(os.path.exists(ck), "24 CLI: no checkpoint written")
    report["technique_clis"] = rows


# the CUDA runtime's kernel-launch calls, as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
TEX_RES = 128  # phase 25's card-against-CPU renders
TEX_SAMPLES = 2
TEX_FRAMES = 4  # the path_tracing app's frames per run at 1080p (phase 26)
FUSED_RUNS = ("off", "on", "on", "off")  # phase 26's small-scene turns
# the default 512^2 sample of the small scene before the textures and the
# rest of PTConfig came in: the CUDA kernels of its device trace and the
# CUDA runtime's launch calls, from `gfxexp_torch/op_counts.py --cuda` run
# on that tree and on this one in turns (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md). Later in a long run the trace can keep fewer or more kernels
# (5,769 to 5,836 for the same sample); the launch calls do not move. The
# eager stages still make them; by the shading kernel's route (phase 38)
# the same sample makes SAMPLE_LAUNCHES (the same card)
PARENT_SAMPLE_KERNELS = 5833
PARENT_SAMPLE_LAUNCHES = 5824
SAMPLE_LAUNCHES = 329
# every option of the slice at once: bump, texture LOD, solid-angle NEE and
# the fused shadow rays
ALL_OPTIONS = dict(enable_bump_mapping=True, texture_lod=True,
                   use_solid_angle_sampling=True, fuse_shadow_rays=True)
# phase 25's cases: (traversal, options, debug switches, probability
# texture)
TEX_CASES = {
    "widerow_default": ("widerow", {}, 0, False),
    "widerow_options": ("widerow", ALL_OPTIONS, 0, False),
    "skip_default": ("skip", {}, 0, False),
    "skip_options": ("skip", ALL_OPTIONS, 0, False),
    "skip_options_probtex_0x85": ("skip", ALL_OPTIONS, 0b1000_0101, True),
    "skip_options_0xff": ("skip", ALL_OPTIONS, 0xFF, False),
}


def _tex_dir():
    return os.path.join(REPO, "out", "textures")


def _tex_render(scene, bvh, cam, res, samples, cfg, sw):
    """Mean of `samples` render_sample calls (indices 0..) and their rays."""
    acc = torch.zeros((res * res, 3), device=scene.device)
    rays = 0.0
    for s in range(samples):
        img, nr = render_sample(scene, bvh, cam, res, res, s, cfg, sw)
        acc += img
        rays += float(nr)
    return (acc / samples).cpu().numpy(), rays


def phase_textures(report, dev):
    """Phase 25: the textured scene (bench.build_textured_scene: a 1-texel
    checker with mips, normal- and height-mapped spheres with BC1 and BC7
    textures from DDS files and a normal map from a PNG, all written here,
    an emissive-textured lamp) at TEX_RES^2, TEX_SAMPLES samples, card
    against CPU, as wide rows (kernel 1) and skip links (kernel 6), with
    and without the slice's options, the probability texture and debug
    switches; fused against unfused on the card; and the world-space ReGIR
    grid of `big` two-level (kernel 5) against the same scene flattened."""
    from gfxexp_torch.techniques import regir as tg

    rows, built = {}, {}
    cam = bench.textured_camera(TEX_RES, TEX_RES)
    for name, (traversal, opts, sw, probtex) in TEX_CASES.items():
        key = (traversal, probtex)
        if key not in built:
            t0 = time.time()
            s, b = bench.build_textured_scene(
                _tex_dir(), traversal=traversal,
                use_probability_texture=probtex)
            built[key] = (s, b, s.to(dev), b.to(dev), time.time() - t0)
        s, b, sd, bd, build_s = built[key]
        cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH,
                       count_rays=True, **opts)
        _reset_counts()
        a, ra = _tex_render(sd, bd, cam.to(dev), TEX_RES, TEX_SAMPLES, cfg,
                            sw)
        torch.cuda.synchronize()
        counts = _all_counts()
        c, rc = _tex_render(s, b, cam, TEX_RES, TEX_SAMPLES, cfg, sw)
        rel = _rel(a, c)
        route = "widerow" if traversal == "widerow" else "skip"
        kinds = ("closest",) if opts.get("fuse_shadow_rays") or (
            sw & 1) else ("closest", "any")
        check(_route_launched(counts, route, kinds),
              f"25 textures {name}: the card did not take the {route} "
              f"walk ({kinds}): {counts}")
        check(np.isfinite(a).all(), f"25 textures {name}: non-finite pixels")
        check(rel < IMAGE_BAR and ra == rc,
              f"25 textures {name}: image rel diff {rel}, rays {ra} vs {rc}")
        check(sw == 0xFF or a.mean() > 0, f"25 textures {name}: black image")
        rows[name] = {"image_rel_diff": rel, "rays": ra,
                      "launches": {g: {k: v for k, v in c.items() if v}
                                   for g, c in counts.items()},
                      "mean": float(a.mean()), "host_build_s": build_s}
        print(f"[25 textures {name}] {TEX_RES}x{TEX_RES}, {TEX_SAMPLES} "
              f"samples, options {sorted(opts)}, switches {sw:#04x}, "
              f"probability texture {probtex}: card vs CPU image rel diff "
              f"{rel:.3g} (bar {IMAGE_BAR}), rays {ra:.0f} equal, launches "
              f"{rows[name]['launches']}", flush=True)
    save_png(os.path.join(REPO, "out", "torch_textured.png"),
             a.reshape(TEX_RES, TEX_RES, 3) / (1.0 + a.reshape(
                 TEX_RES, TEX_RES, 3)))

    # fused against unfused on the card: the same image, the same rays
    for traversal in ("widerow", "skip"):
        _, _, sd, bd, _ = built[(traversal, False)]
        out = {}
        for fuse in (False, True):
            cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH,
                           count_rays=True, **dict(ALL_OPTIONS,
                                                   fuse_shadow_rays=fuse))
            _reset_counts()
            img, nr = _tex_render(sd, bd, cam.to(dev), TEX_RES, TEX_SAMPLES,
                                  cfg, 0)
            out[fuse] = (img, nr, _all_counts())
        (a, ra, ca), (b, rb, cb) = out[False], out[True]
        err = float(np.abs(a - b).max())
        check(np.allclose(a, b, rtol=1e-5, atol=1e-6) and ra == rb,
              f"25 textures fused {traversal}: max abs diff {err}, rays "
              f"{ra} vs {rb}")
        group, suffix = {"widerow": ("kernel1", ""),
                         "skip": ("skip", "_thread")}[traversal]
        walks = {f: (c[group]["closest" + suffix], c[group]["any" + suffix])
                 for f, c in (("unfused", ca), ("fused", cb))}
        check(walks["fused"] == (bench.MAX_PATH_LENGTH * TEX_SAMPLES, 0),
              f"25 textures fused {traversal}: walks {walks}")
        rows[f"fused_{traversal}"] = {"max_abs_diff": err, "rays": ra,
                                      "walks": walks}
        print(f"[25 textures fused {traversal}] all options, fused vs "
              f"unfused on the card: max abs diff {err:.3g} (rtol 1e-5, "
              f"atol 1e-6), rays {ra:.0f} equal, walk launches closest/any "
              f"{walks}", flush=True)
    built = None

    # ReGIR's grid and one frame on `big` two-level (kernel 5) against the
    # same scene flattened (kernel 1)
    cfg = tg.ReGIRConfig(**REGIR_SMALL)
    pt = PTConfig(max_path_length=3, count_rays=True)
    cam = bench.bench_camera(CHECK_RES, CHECK_RES, "big").to(dev)
    grids, imgs = {}, {}
    for traversal in ("instanced", "widerow"):
        s, b = (x.to(dev) for x in bench.build_bench_scene(
            "big", traversal=traversal))
        grid = tg.make_grid(s, cfg)
        st = tg.build_cell_reservoirs(s, tg.make_regir_state(cfg, dev), grid,
                                      0, cfg)
        _reset_counts()
        img, _, _ = tg.render_sample_regir(s, b, cam, st, grid, CHECK_RES,
                                           CHECK_RES, 0, pt, cfg)
        torch.cuda.synchronize()
        counts = _all_counts()
        grids[traversal] = torch.cat([grid.origin, grid.cell_size]).cpu()
        imgs[traversal] = img.cpu().numpy()
        if traversal == "instanced":
            check(counts["instanced"]["closest_nearest"] > 0,
                  f"25 regir big instanced: kernel 5 not launched: {counts}")
    gerr = float((grids["instanced"] - grids["widerow"]).abs().max())
    rel = _rel(imgs["instanced"], imgs["widerow"])
    check(gerr <= 1e-6 and rel < 5e-5,
          f"25 regir big: grid differs by {gerr}, image rel diff {rel}")
    rows["regir_big_world_grid"] = {"grid_max_abs_diff": gerr,
                                    "image_rel_diff": rel,
                                    "grid": grids["instanced"].tolist()}
    print(f"[25 regir big] two-level (kernel 5) vs flattened (kernel 1) on "
          f"the card: grid origin and cell size within {gerr:.3g} (bar "
          f"1e-6), one frame at {CHECK_RES}x{CHECK_RES} image rel diff "
          f"{rel:.3g} (bar 5e-5)", flush=True)
    report["textures"] = rows


def phase_texture_costs(report, dev):
    """Phase 26: the path_tracing app's frame loop on the textured scene
    (wide rows, kernel 1) at 1920x1080, TEX_FRAMES frames without options
    and with bump mapping and texture LOD; then the small scene at 512^2
    with fused shadow rays off and on in turns (FUSED_RUNS), each under
    torch.profiler for one sample, and the default sample's kernel count
    against the parent's."""
    scene, bvh = (x.to(dev) for x in bench.build_textured_scene(
        _tex_dir(), traversal="widerow"))
    cam = bench.textured_camera(TECH_W, TECH_H).to(dev)
    rows = {}
    for name, opts in (("plain", {}),
                       ("bump_lod", dict(enable_bump_mapping=True,
                                         texture_lod=True))):
        cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH, **opts)
        frame_loop(scene, bvh, cam, [], "widerow", TECH_W, TECH_H, 1, cfg,
                   PassTimer(device=dev))  # warm-up
        torch.cuda.synchronize()
        timer = PassTimer(device=dev)
        _reset_counts()
        film, _, _, _ = frame_loop(scene, bvh, cam, [], "widerow", TECH_W,
                                   TECH_H, TEX_FRAMES, cfg, timer)
        torch.cuda.synchronize()
        counts = _all_counts()
        check(_route_launched(counts, "widerow"),
              f"26 textured 1080p {name}: not kernel 1: {counts}")
        img = film.beauty
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
              f"26 textured 1080p {name}: bad image")
        prof = _profile_pass(
            f"26 textured profile {name}",
            lambda: render_sample(scene, bvh, cam, TECH_W, TECH_H, 1, cfg),
            "one 1920x1080 pathTrace")
        rows[name] = {"ms_per_pathTrace": timer.mean_ms("pathTrace"),
                      "launches_per_frame": _per_frame(counts, TEX_FRAMES),
                      "profile": prof, "mean": float(img.mean())}
        print(f"[26 textured 1080p {name}] {TEX_FRAMES} frames: pathTrace "
              f"{rows[name]['ms_per_pathTrace']:.2f} ms per frame, walk "
              f"launches per frame {rows[name]['launches_per_frame']}",
              flush=True)
        save_png(os.path.join(REPO, "out", f"torch_textured_{name}.png"),
                 (img / (1.0 + img)).cpu().numpy())
    scene = bvh = None

    small, sbvh = (x.to(dev) for x in bench.build_bench_scene())
    turns = []
    for i, fused in enumerate(FUSED_RUNS):
        cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH, count_rays=True,
                       fuse_shadow_rays=fused == "on")
        _reset_counts()
        r = bench.measure("512", small, sbvh, device=dev, cfg=cfg)
        _check_bench_row(r, f"26 fused {fused}")
        lc = r["launches"]
        per = (lc["widerow_closest"] / bench.TIMED_SAMPLES,
               lc["widerow_any"] / bench.TIMED_SAMPLES)
        prof = _profile(lambda s: render_accumulate(
            small, sbvh, bench.bench_camera(512, 512).to(dev), 512, 512, s,
            1, cfg))
        eager = None
        if fused == "off":
            with _shade_route("eager"):
                eager = _profile(lambda s: render_accumulate(
                    small, sbvh, bench.bench_camera(512, 512).to(dev), 512,
                    512, s, 1, cfg))
        turns.append({"fused": fused, "mrays_per_s": r["value"],
                      "walks_per_sample": per, "profile": prof,
                      "eager_profile": eager, "mean": r["mean_radiance"]})
        print(f"[26 fused turn {i} {fused}] small 512x512: {r['value']} "
              f"Mrays/s, {prof['kernels']} CUDA kernels a sample, "
              f"{prof['launch_calls']} launch calls (idle share "
              f"{prof.get('idle_share', float('nan')):.3f}), walk "
              f"launches a sample closest + any {per[0]:.0f} + "
              f"{per[1]:.0f}", flush=True)
    rows["fused_walks"] = _fused_walk_times(sbvh, dev)
    want = {"off": (5.0, 4.0), "on": (5.0, 0.0)}
    for t in turns:
        check(t["walks_per_sample"] == want[t["fused"]],
              f"26 fused {t['fused']}: walks {t['walks_per_sample']}")
    means = {t["fused"]: t["mean"] for t in turns}
    check(abs(means["on"] - means["off"]) <= 1e-5 * means["off"],
          f"26 fused: mean radiance {means}")
    default = [(t["profile"]["kernels"], t["profile"]["launch_calls"])
               for t in turns if t["fused"] == "off"]
    eager = [(t["eager_profile"]["kernels"],
              t["eager_profile"]["launch_calls"])
             for t in turns if t["fused"] == "off"]
    rows["fused_turns"] = turns
    rows["default_sample"] = default
    rows["default_sample_eager"] = eager
    print(f"[26 default sample] small 512x512, default PTConfig: (CUDA "
          f"kernels in the trace, launch calls) {default} a sample by the "
          f"shading kernel, {eager} by the eager stages; the parent's: "
          f"{PARENT_SAMPLE_KERNELS} kernels, {PARENT_SAMPLE_LAUNCHES} "
          f"launch calls", flush=True)
    check(all(c == SAMPLE_LAUNCHES for _, c in default),
          f"26 default sample: launch calls {default}, expected "
          f"{SAMPLE_LAUNCHES}")
    check(all(c == PARENT_SAMPLE_LAUNCHES for _, c in eager),
          f"26 default sample, eager stages: launch calls {eager}, parent "
          f"{PARENT_SAMPLE_LAUNCHES}")
    report["texture_costs"] = rows


def _fused_walk_times(bvh, dev):
    """Kernel 1 on one 512^2 batch of the small scene's bounce rays and
    their shadow rays (bench.walk_rays): a closest-hit and an any-hit
    launch of N lanes each, as the unfused tracer walks them, against one
    closest-hit launch of the 2N lanes, as the fused tracer does. The 2N
    launch's shadow half must report the any-hit launch's occlusion."""
    def first_hit(o0, d0):
        h = walk_cuda(bvh, o0, d0, 0.0, 1e30, any_hit=False)
        return h.t, h.hit

    o, d, t_min, t_max, sd, s_max = _scene_rays(first_hit, "small", dev)
    b = slice(BATCH, 2 * BATCH)
    fo, fd = torch.cat([o[b], o[b]]), torch.cat([d[b], sd[b]])
    ft_min = torch.cat([t_min[b], t_min[b]])
    ft_max = torch.cat([t_max[b], s_max[b]])
    occluded = walk_cuda(bvh, o[b], sd[b], t_min[b], s_max[b], True).hit
    fused_hit = walk_cuda(bvh, fo, fd, ft_min, ft_max, False).hit[BATCH:]
    check(torch.equal(occluded, fused_hit),
          "26 fused walks: the 2N launch's shadow half differs from any-hit")
    ms = {"closest_n": time_ms(lambda: walk_cuda(
              bvh, o[b], d[b], t_min[b], t_max[b], False), 20),
          "any_n": time_ms(lambda: walk_cuda(
              bvh, o[b], sd[b], t_min[b], s_max[b], True), 20),
          "closest_2n": time_ms(lambda: walk_cuda(
              bvh, fo, fd, ft_min, ft_max, False), 20)}
    print(f"[26 fused walks] kernel 1 on {BATCH} bounce rays and their "
          f"shadow rays: closest {ms['closest_n']:.4f} + any "
          f"{ms['any_n']:.4f} = {ms['closest_n'] + ms['any_n']:.4f} ms "
          f"unfused, one closest over {2 * BATCH} lanes "
          f"{ms['closest_2n']:.4f} ms fused (occlusion equal)", flush=True)
    return ms


def phase_texture_clis(report, dev):
    """Phase 27: on the card at 64^2, path_tracing with -bump -texture-lod
    -debug-switches 133 -exr (the EXR read back) and path_tracing with
    -env-texture on an EXR written here, at once; then the svgf and
    restir_di apps' frame loops on the textured scene, whose G-buffer
    albedo carries the checker."""
    from gfxexp_torch.apps import restir_di as restir_app
    from gfxexp_torch.apps import svgf as svgf_app
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.techniques.restir_di import ReSTIRConfig
    from gfxexp_torch.techniques.svgf import SVGFConfig
    from gfxexp_torch.utils.image_io import load_exr, save_exr

    sky = os.path.join(REPO, "out", "cli_sky.exr")
    h, w = np.mgrid[0:16, 0:32].astype(np.float32)
    save_exr(sky, np.stack([1.0 + h / 8, 0.5 + w / 32, np.full_like(h, 0.8)],
                           -1), half=False)
    env_dsl = ["-cam-pos", "0", "1", "3.2", "-cam-pitch", "-12",
               "-name", "floor", "-rectangle", "4", "4", "-inst", "floor",
               "-name", "ball", "-sphere", "0.4", "-inst", "ball",
               "-position", "0", "0.4", "0"]
    clis = {"path_tracing_options": _png_cli(
                "path_tracing_options", "gfxexp_torch.apps.path_tracing",
                ["-bump", "-texture-lod", "-debug-switches", "133", "-exr"],
                CHECK_RES),
            "path_tracing_env_texture": _png_cli(
                "path_tracing_env_texture", "gfxexp_torch.apps.path_tracing",
                ["-env-texture", sky, "-debug-switches", "64", *env_dsl],
                CHECK_RES)}
    rows = {}
    for tag, (out, proc) in clis.items():
        _, err = proc.communicate(timeout=300)
        check(proc.returncode == 0,
              f"27 CLI {tag} exited {proc.returncode}: {err[-2000:]}")
        px = _png_pixels(out + ".png")
        check(px.shape == (CHECK_RES, CHECK_RES, 3) and px.any(),
              f"27 CLI {tag}: PNG {px.shape}, all black {not px.any()}")
        stats = [ln for ln in err.splitlines() if ln.startswith("final:")]
        rows[tag] = {"stats": stats[-1] if stats else None,
                     "mean_pixel": float(px.mean())}
        if tag == "path_tracing_options":
            hdr = load_exr(out + ".exr")
            check(hdr.shape == (CHECK_RES, CHECK_RES, 3)
                  and np.isfinite(hdr).all() and hdr.mean() > 0,
                  f"27 CLI {tag}: EXR {hdr.shape}")
            rows[tag]["exr_mean"] = float(hdr.mean())
        print(f"[27 CLI {tag}] {CHECK_RES}x{CHECK_RES}, 4 frames: rc 0, "
              f"out/cli_{tag}.png mean pixel {px.mean():.1f}"
              + (f", EXR read back, mean {rows[tag]['exr_mean']:.4f}"
                 if "exr_mean" in rows[tag] else "")
              + f"; {stats[-1] if stats else ''}", flush=True)

    scene, bvh = (x.to(dev) for x in bench.build_textured_scene(
        _tex_dir(), traversal="widerow"))
    cam = bench.textured_camera(CHECK_RES, CHECK_RES).to(dev)
    gb = render_gbuffer(scene, bvh, cam, cam, CHECK_RES, CHECK_RES, 0, False)
    floor = gb.hit & (gb.material == 0)
    alb = gb.albedo[floor][:, 0]
    check(float(alb.min()) < 0.3 and float(alb.max()) > 0.6,
          f"27 textured G-buffer: floor albedo {float(alb.min())} .. "
          f"{float(alb.max())}, no checker")
    pt = PTConfig(max_path_length=bench.MAX_PATH_LENGTH)
    img, _, _, _ = svgf_app.frame_loop(scene, bvh, cam, [], "widerow",
                                       CHECK_RES, CHECK_RES, 4, pt,
                                       SVGFConfig(), PassTimer(device=dev))
    film, _, _ = restir_app.frame_loop(scene, bvh, cam, [], "widerow",
                                       CHECK_RES, CHECK_RES, 4,
                                       ReSTIRConfig(), True,
                                       PassTimer(device=dev))
    for tag, im in (("svgf", img), ("restir_di", film.beauty)):
        check(bool(torch.isfinite(im).all()) and float(im.mean()) > 0,
              f"27 {tag} on the textured scene: bad image")
        rows[f"{tag}_textured"] = {"mean": float(im.mean())}
        save_png(os.path.join(REPO, "out", f"torch_textured_{tag}.png"),
                 (im / (1.0 + im)).cpu().numpy())
    print(f"[27 textured techniques] G-buffer floor albedo "
          f"{float(alb.min()):.3f} .. {float(alb.max()):.3f} (the checker); "
          f"svgf and restir_di frame loops, 4 frames at {CHECK_RES}x"
          f"{CHECK_RES}: mean {rows['svgf_textured']['mean']:.4f} / "
          f"{rows['restir_di_textured']['mean']:.4f}", flush=True)
    report["texture_clis"] = rows


TFDM_RAYS = 65536  # phase 28's camera and bounce rays
TFDM_RES = 128  # phase 28's card-against-CPU renders
TFDM_SAMPLES = 1
MESH_RES = 64  # phase 28's mesh scenes, card against CPU
# phase 29: the tfdm app's frames at 512^2 per base mesh (-base-res); the
# app renders 32, cut to these, and -base-res 32's frame (20-24 s) dropped
# since phases 30-31 came, to hold the script's time (PERF.md); phase 28
# still holds -base-res 32 (the prism BVH's walk) card against CPU
TFDM_FRAMES = {24: 1}
TFDM_COST_RES = 512  # the app's default resolution
# card against CPU on the same rays: share of rays whose hit agrees, t
# within rtol on that share of both-hit rays, steps equal on that share
TFDM_BARS = {"hit": 0.999, "t_rtol": 1e-5, "t_share": 0.999, "steps": 0.99}


def _tfdm_app(base_res, width, height, traversal="widerow"):
    """The tfdm app's demo scene at its defaults but `-base-res`, compiled
    on the host for `traversal`: (scene, bvh, camera, host seconds)."""
    from gfxexp_torch.apps import tfdm as app
    from gfxexp_torch.apps.common import make_camera_from_args

    args = app.parse_args(["-base-res", str(base_res), "-width", str(width),
                           "-height", str(height), "-traversal", traversal])
    t0 = time.time()
    scene, bvh, _ = app.compile_demo(args, "tfdm",
                                     app.displacement_params(args))
    return scene, bvh, make_camera_from_args(args), time.time() - t0


def _tfdm_rays(geom, cam, dev):
    """TFDM_RAYS / 2 jittered camera rays through random pixels at 512^2,
    then as many bounce rays from their displaced hits, in random
    directions of the hit normal's hemisphere (rays whose camera ray
    missed are dead, t_max < 0): (o, d, t_min, t_max)."""
    from gfxexp_torch.render.camera import generate_rays_for_lanes
    from gfxexp_torch.techniques.tfdm import intersect_tfdm_v2

    rng = np.random.default_rng(SEED)
    half = TFDM_RAYS // 2
    lane = torch.from_numpy(rng.integers(0, 512 * 512, half)).to(dev)
    jit = torch.from_numpy(rng.random((2, half), np.float32)).to(dev)
    o0, d0 = generate_rays_for_lanes(cam, 512, 512, lane, jit[0], jit[1])
    h0 = intersect_tfdm_v2(geom, o0, d0)
    dirs = torch.from_numpy(rng.normal(size=(half, 3)).astype(
        np.float32)).to(dev)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    side = torch.where((dirs * h0.normal).sum(1) < 0, -1.0, 1.0)
    o = torch.cat([o0, torch.where(h0.hit[:, None], h0.position, o0)])
    d = torch.cat([d0, dirs * side[:, None]])
    t_min = torch.cat([torch.full((half,), 1e-4, device=dev),
                       torch.full((half,), 1e-3, device=dev)])
    t_max = torch.cat([torch.full((half,), 1e30, device=dev),
                       torch.where(h0.hit, 1e30, -1.0)])
    return o.contiguous(), d.contiguous(), t_min, t_max


def _tfdm_card_vs_cpu(tag, geom_c, o, d, t_min, t_max, dev):
    """intersect_tfdm_v2 on the card and on the CPU on the same rays:
    agreement, the card's wall ms (fenced) and its loop counts."""
    from gfxexp_torch.techniques import tfdm

    geom = geom_c.to(dev)
    tfdm.intersect_tfdm_v2(geom, o[:1024], d[:1024], t_min[:1024],
                           t_max[:1024])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset_counters("tfdm.")
    t0 = time.perf_counter()
    hk = tfdm.intersect_tfdm_v2(geom, o, d, t_min, t_max)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stats = _loop_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    hc = tfdm.intersect_tfdm_v2(geom_c, o.cpu(), d.cpu(), t_min.cpu(),
                                t_max.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    hk = hk.to(torch.device("cpu"))
    hit_agree = float((hk.hit == hc.hit).float().mean())
    both = hk.hit & hc.hit
    rel = ((hk.t[both] - hc.t[both]).abs() / hc.t[both].abs())
    t_share = float((rel <= TFDM_BARS["t_rtol"]).float().mean())
    steps_eq = float((hk.steps == hc.steps).float().mean())
    live = t_max.cpu() > t_min.cpu()
    row = {"rays": o.shape[0], "live_rays": int(live.sum()),
           "hits": int(hk.hit.sum()), "hit_agree": hit_agree,
           "t_max_rel": float(rel.max()) if rel.numel() else 0.0,
           "t_share": t_share, "steps_equal": steps_eq,
           "uv_max_abs": float((hk.uv[both] - hc.uv[both]).abs().max()),
           "normal_max_abs": float((hk.normal[both]
                                    - hc.normal[both]).abs().max()),
           "card_ms": ms, "cpu_ms": cpu_ms, "card_peak_mib": peak,
           "loop": stats,
           "steps_mean_live": float(hk.steps[live].float().mean()),
           "steps_max": int(hk.steps.max())}
    check(hit_agree >= TFDM_BARS["hit"] and t_share >= TFDM_BARS["t_share"]
          and steps_eq >= TFDM_BARS["steps"],
          f"28 {tag}: card vs CPU hit agree {hit_agree}, t within "
          f"{TFDM_BARS['t_rtol']} on {t_share}, steps equal {steps_eq}")
    print(f"[28 {tag}] intersect_tfdm_v2 on {o.shape[0]} camera and bounce "
          f"rays ({row['live_rays']} live, {row['hits']} hits): card vs "
          f"CPU hit agree {hit_agree:.5f}, t max rel {row['t_max_rel']:.3g} "
          f"(within {TFDM_BARS['t_rtol']} on {t_share:.5f}), steps equal "
          f"on {steps_eq:.5f}, uv {row['uv_max_abs']:.3g}, normal "
          f"{row['normal_max_abs']:.3g}; card {ms:.1f} ms (CPU "
          f"{cpu_ms:.0f} ms), peak {peak:.0f} MiB, {stats['syncs']} syncs, "
          f"{stats['rounds']} rounds, {stats['march_iterations']} march "
          f"iterations, {stats['bvh_iterations']} BVH steps; steps mean "
          f"{row['steps_mean_live']:.2f} a live ray, max "
          f"{row['steps_max']}", flush=True)
    return row


def _walk_on(tag, route, scene, bvh, o, d, t_min, t_max, lamp, dev,
             phase="28"):
    """Kernel 1 (route "widerow") or kernel 6's per-ray scope ("skip")
    against its plain version on the scene's closest rays and on shadow
    rays from their hits to random points of the lamp (a 1x1 square at
    `lamp`): hits, triangles, t, u, v equal (kernel 1: t rel within phase
    3's bar); times of both. `phase` tags the lines."""
    tris = scene.triangles
    if route == "widerow":
        def card(*a):
            return walk_cuda(bvh, *a)

        def plain(*a):
            return walk_plain(bvh, *a)
    else:
        def card(*a):
            return walk_skip_cuda(bvh, tris, *a, scope="thread")

        def plain(*a):
            return walk_skip_plain(bvh, tris, *a)
    kc = card(o, d, t_min, t_max, False)
    pc = plain(o, d, t_min, t_max, False)
    rng = np.random.default_rng(SEED + 1)
    n = o.shape[0]
    xz = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 2)).astype(
        np.float32)).to(dev)
    target = torch.stack([lamp[0] + xz[:, 0],
                          torch.full((n,), lamp[1], device=dev),
                          lamp[2] + xz[:, 1]], 1)
    p = o + torch.where(kc.hit, kc.t, 0.0)[:, None] * d
    vec = target - p
    dist = torch.linalg.vector_norm(vec, dim=1)
    sd = (vec / dist[:, None]).contiguous()
    s_max = torch.where(kc.hit, dist * 0.9999, -1.0)
    s_min = torch.full_like(s_max, 1e-3)
    ka = card(p, sd, s_min, s_max, True)
    pa = plain(p, sd, s_min, s_max, True)
    torch.cuda.synchronize()
    m = kc.hit
    check(torch.equal(kc.hit, pc.hit) and torch.equal(kc.tri, pc.tri)
          and torch.equal(ka.hit, pa.hit),
          f"{phase} {tag} {route}: hits or triangles differ from plain")
    err = float(torch.stack([(kc.t[m] - pc.t[m]).abs().max(),
                             (kc.u[m] - pc.u[m]).abs().max(),
                             (kc.v[m] - pc.v[m]).abs().max()]).max()) \
        if bool(m.any()) else 0.0
    rel_t = float(((kc.t[m] - pc.t[m]).abs()
                   / pc.t[m].abs().clamp(min=1e-30)).max()) \
        if bool(m.any()) else 0.0
    check(rel_t <= 1e-4 and (route == "widerow" or err == 0.0),
          f"{phase} {tag} {route}: t rel {rel_t}, max abs err {err}")
    row = {"closest_ms": time_ms(lambda: card(o, d, t_min, t_max, False),
                                 20),
           "closest_plain_ms": time_ms(lambda: plain(o, d, t_min, t_max,
                                                     False), 2),
           "any_ms": time_ms(lambda: card(p, sd, s_min, s_max, True), 20),
           "any_plain_ms": time_ms(lambda: plain(p, sd, s_min, s_max, True),
                                   2),
           "max_abs_err": err, "t_rel": rel_t, "hits": int(m.sum()),
           "occluded": int(ka.hit.sum())}
    name = {"widerow": "kernel 1", "skip": "kernel 6"}[route]
    print(f"[{phase} {tag} {name}] {n} closest rays ({row['hits']} hit) and "
          f"their shadow rays ({row['occluded']} occluded): equal to plain "
          f"(max abs err {err:.3g}, t rel {rel_t:.3g}); closest "
          f"{row['closest_ms']:.4f} ms (plain {row['closest_plain_ms']:.1f}"
          f"), any {row['any_ms']:.4f} ms (plain "
          f"{row['any_plain_ms']:.1f})", flush=True)
    return row


def _mesh_scenes():
    """Phase 28's mesh scenes on the host, each (scene, bvh, camera): the
    torus OBJ through the DSL's -obj (with a convention, and without one
    followed by another option) under a lamp sphere, and the binary PLY
    and the GLB's node tree through load_mesh (bench.mesh_scene_builder)."""
    from gfxexp_torch.apps import common
    from gfxexp_torch.scene.builder import SceneBuilder
    from gfxexp_torch.scene.compile import compile_scene

    paths = bench.write_mesh_files(os.path.join(REPO, "out", "meshes"))
    cam_args = ["-cam-pos", "0", "1.2", "2.4", "-cam-pitch", "22",
                "-width", str(MESH_RES), "-height", str(MESH_RES)]
    scenes = {}
    for tag, obj in (
            ("obj_simple_pbr", ["-name", "torus", "-obj", paths["obj"],
                                "1.5", "simple_pbr"]),
            ("obj_bare", ["-name", "torus", "-obj", paths["obj"], "1.5"])):
        args = common.parse_scene_args(
            common.make_arg_parser("tfdm_meshes"),
            [*cam_args, "-device", "cpu", *obj, "-name", "lamp",
             "-emittance", "30", "30", "30", "-sphere", "0.2",
             "-name", "floor", "-rectangle", "4", "4"])
        scene, bvh, _, _ = common.compile_app_scene(args, "cpu")
        check(scene.num_units == 4, f"28 {tag}: {scene.num_units} units "
              f"(torus x2, lamp, floor)")
        scenes[tag] = (scene, bvh, common.make_camera_from_args(args))
    scene, bvh = compile_scene(bench.mesh_scene_builder(
        SceneBuilder(), os.path.join(REPO, "out", "meshes")),
        traversal="widerow")
    scenes["ply_glb"] = (scene, bvh, bench.textured_camera(MESH_RES,
                                                           MESH_RES))
    return scenes


def phase_tfdm(report, dev):
    """Phase 28: TFDM and the loaders, card against CPU. intersect_tfdm_v2
    on TFDM_RAYS camera and bounce rays over the tfdm app's scene at
    -base-res 24 (1,152 prisms, the slab sweep) and 32 (2,048 prisms, the
    prism BVH's walk); kernel 1 and kernel 6 (the scene compiled with
    -traversal skip) against their plain versions on those rays' closest
    and shadow rays; the demo scene at TFDM_RES^2, TFDM_SAMPLES
    samples, card against CPU with displaced shadows on and off; the mesh
    scenes (an OBJ + MTL through -obj, a binary PLY and a GLB through
    load_mesh; files written here) at MESH_RES^2, card against CPU."""
    # the CPU side of the renders, and phase 29's CLI, run beside the
    # card's work; returns the CLI's (output, process) for phase 29
    cpu_out = os.path.join(REPO, "out", "tfdm_cpu_renders.npz")
    if os.path.exists(cpu_out):
        os.remove(cpu_out)
    os.makedirs(os.path.dirname(cpu_out), exist_ok=True)
    cpu_proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; "
         f"c.tfdm_cpu_renders({cpu_out!r}, {TFDM_RES}, {TFDM_SAMPLES})"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    cli = _tfdm_cli()
    try:
        _phase_tfdm(report, dev, cpu_proc, cpu_out)
    except BaseException:
        for proc in (cpu_proc, cli[1]):
            proc.kill()
            proc.wait()
        raise
    return cli


def _tfdm_cli():
    """Start the tfdm CLI with -heatmap at 64x64, 4 frames (phase 29)."""
    return _png_cli("tfdm_heatmap", "gfxexp_torch.apps.tfdm", ["-heatmap"],
                    64)


def _phase_tfdm(report, dev, cpu_proc, cpu_out):
    from gfxexp_torch.techniques import tfdm

    rows = {}
    for base in (24, 32):
        scene, bvh, cam, host_s = _tfdm_app(base, 512, 512)
        geom = scene.displaced[0]
        check((geom.prism_bvh is not None) == (base == 32),
              f"28 base {base}: prism BVH {geom.prism_bvh is not None}")
        sd, bd = scene.to(dev), bvh.to(dev)
        o, d, t_min, t_max = _tfdm_rays(sd.displaced[0], cam.to(dev), dev)
        tag = f"tfdm base{base}"
        rows[tag] = _tfdm_card_vs_cpu(tag, geom, o, d, t_min, t_max, dev)
        rows[tag]["prisms"] = geom.p0.shape[0]
        rows[tag]["host_build_s"] = host_s
        if base == 24:
            # the triangles (floor, lamp, sphere) do not depend on the base
            # mesh: kernels 1 and 6 are held once, on these rays
            lamp = (0.8, 2.6, 0.8)
            rows[f"{tag} kernel1"] = _walk_on(tag, "widerow", sd, bd, o, d,
                                              t_min, t_max, lamp, dev)
            sk_scene, sk_bvh = (x.to(dev) for x in _tfdm_app(
                base, 512, 512, "skip")[:2])
            rows[f"{tag} kernel6"] = _walk_on(tag, "skip", sk_scene, sk_bvh,
                                              o, d, t_min, t_max, lamp, dev)
            sk_scene = sk_bvh = None
            renders, cards = {}, {}
            c_cam = _tfdm_app_camera(TFDM_RES)
            for shadows in (True, False):
                cfg = PTConfig(displaced_shadows=shadows, count_rays=True)
                _reset_counts()
                trace.reset_counters("tfdm.")
                t0 = time.perf_counter()
                a, ra = _tex_render(sd, bd, c_cam.to(dev), TFDM_RES,
                                    TFDM_SAMPLES, cfg, 0)
                cards[shadows] = (a, ra, time.perf_counter() - t0,
                                  _all_counts(), _loop_counts())
            _, err = cpu_proc.communicate(timeout=600)
            check(cpu_proc.returncode == 0,
                  f"28 CPU renders exited {cpu_proc.returncode}: "
                  f"{err[-2000:]}")
            cpu = np.load(cpu_out)
            for shadows in (True, False):
                a, ra, card_s, counts, loops = cards[shadows]
                c = cpu[f"img_{shadows}"]
                rc = float(cpu[f"rays_{shadows}"])
                cpu_s = float(cpu[f"seconds_{shadows}"])
                rel = _rel(a, c)
                key = f"render shadows {'on' if shadows else 'off'}"
                check(_route_launched(counts, "widerow"),
                      f"28 {key}: not kernel 1: {counts}")
                check(np.isfinite(a).all() and a.mean() > 0
                      and rel < IMAGE_BAR and abs(ra - rc) <= 0.005 * rc,
                      f"28 {key}: image rel diff {rel}, rays {ra} vs {rc}")
                renders[shadows] = a
                rows[key] = {"image_rel_diff": rel, "rays": ra,
                             "cpu_rays": rc, "mean": float(a.mean()),
                             "card_s": card_s, "cpu_s": cpu_s,
                             "loop": loops, "kernel1": counts["kernel1"]}
                print(f"[28 {key}] demo scene {TFDM_RES}x{TFDM_RES}, "
                      f"{TFDM_SAMPLES} samples: card vs CPU image rel diff "
                      f"{rel:.3g} (bar {IMAGE_BAR}), rays {ra:.0f} / "
                      f"{rc:.0f} (bar 0.5%), mean {a.mean():.4f}; card "
                      f"{card_s:.1f} s, CPU {cpu_s:.1f} s (its own "
                      f"process); kernel 1 {counts['kernel1']}; "
                      f"intersect_tfdm_v2 {loops}", flush=True)
            check(renders[True].mean() < renders[False].mean(),
                  "28 render: displaced shadows do not darken the image")
            save_png(os.path.join(REPO, "out", "torch_tfdm_128.png"),
                     (renders[True] / (1 + renders[True])).reshape(
                         TFDM_RES, TFDM_RES, 3))
        scene = bvh = sd = bd = None

    for tag, (scene, bvh, cam) in _mesh_scenes().items():
        cfg = PTConfig(count_rays=True)
        sd, bd = scene.to(dev), bvh.to(dev)
        a, ra = _tex_render(sd, bd, cam.to(dev), MESH_RES, 2, cfg, 0)
        c, rc = _tex_render(scene, bvh, cam, MESH_RES, 2, cfg, 0)
        rel = _rel(a, c)
        check(np.isfinite(a).all() and a.mean() > 0 and rel < IMAGE_BAR
              and ra == rc,
              f"28 mesh {tag}: image rel diff {rel}, rays {ra} vs {rc}")
        rows[f"mesh {tag}"] = {"image_rel_diff": rel, "rays": ra,
                               "triangles": scene.num_triangles,
                               "units": scene.num_units,
                               "atlas_layers": (0 if scene.textures is None
                                                else scene.textures.count)}
        print(f"[28 mesh {tag}] {scene.num_triangles} triangles, "
              f"{scene.num_units} units: {MESH_RES}x{MESH_RES}, 2 samples, "
              f"card vs CPU image rel diff {rel:.3g}, rays {ra:.0f} equal",
              flush=True)
    report["tfdm"] = rows


def tfdm_cpu_renders(out_path, res, samples):
    """Phase 28's CPU renders, run in a process of their own beside the
    card's: the demo scene (-base-res 24, wide rows) at res^2, `samples`
    samples, displaced shadows on and off; images, rays and seconds saved
    to `out_path` (npz)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    scene, bvh, _, _ = _tfdm_app(24, 512, 512)
    cam = _tfdm_app_camera(res)
    out = {}
    for shadows in (True, False):
        t0 = time.perf_counter()
        img, rays = _tex_render(scene, bvh, cam, res, samples, PTConfig(
            displaced_shadows=shadows, count_rays=True), 0)
        out.update({f"img_{shadows}": img, f"rays_{shadows}": rays,
                    f"seconds_{shadows}": time.perf_counter() - t0})
    np.savez(out_path, **out)


def _tfdm_app_camera(res):
    from gfxexp_torch.apps import tfdm as app
    from gfxexp_torch.apps.common import make_camera_from_args

    return make_camera_from_args(app.parse_args(
        ["-width", str(res), "-height", str(res)]))


def _num(x, digits=3):
    """A measured number rounded for a log line, or the words "not
    measured" as they stand."""
    return x if isinstance(x, str) else round(x, digits)


def _union_ms(kern):
    """Device busy time (ms) of kernel events: the union of their
    intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for st, en in spans:
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def phase_tfdm_costs(report, dev, cli=None):
    """Phase 29: the tfdm app's frame loop at 512^2 (its defaults: ridges,
    -h-scale 0.25, bilinear) at the -base-res of TFDM_FRAMES (24), its
    frames each: ms per pathTrace (fenced), kernel 1's launches a frame, peak
    memory; each intersect_tfdm_v2 call fenced and recorded (its ms, host
    syncs, rounds, march iterations and prism-BVH steps, and the steps of
    its rays: mean over the rays that march, max), so the TFDM calls'
    share of a frame's time; then one intersect_tfdm_v2 call on the
    frame's primary rays (the heatmap's), fenced, and at -base-res 24
    under torch.profiler (CUDA activity): CUDA kernels, launch calls,
    device busy and idle share against its fenced time. (A whole frame is
    ~840,000 kernels: its trace did not finish in minutes, PERF.md.) Last,
    the tfdm CLI with -heatmap at 64x64, 4 frames, started by phase 28
    (`cli`) or here, and its two PNGs."""
    from torch.profiler import ProfilerActivity, profile

    from gfxexp_torch.apps.path_tracing import frame_loop
    from gfxexp_torch.apps.tfdm import heatmap
    from gfxexp_torch.techniques import tfdm

    rows = {}
    real = tfdm.intersect_tfdm_v2
    for base, frames in TFDM_FRAMES.items():
        res = TFDM_COST_RES
        scene, bvh, cam, _ = _tfdm_app(base, res, res)
        scene, bvh, cam = scene.to(dev), bvh.to(dev), cam.to(dev)
        cfg = PTConfig()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls = []

        def recorded(*a, **kw):
            torch.cuda.synchronize()
            before = _loop_counts()
            t0 = time.perf_counter()
            h = real(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = _loop_counts()
            live = h.steps > 0
            calls.append({
                "ms": ms, "marching_rays": int(live.sum()),
                "steps_mean_marching": (float(h.steps[live].float().mean())
                                        if bool(live.any()) else 0.0),
                "steps_max": int(h.steps.max()),
                **{k: after[k] - before[k] for k in (
                    "syncs", "rounds", "march_iterations",
                    "bvh_iterations")}})
            return h

        timer = PassTimer(device=dev)
        _reset_counts()
        trace.reset_counters("tfdm.")
        tfdm.intersect_tfdm_v2 = recorded
        try:
            film, _, _, _ = frame_loop(scene, bvh, cam, [], "widerow", res,
                                       res, frames, cfg, timer)
        finally:
            tfdm.intersect_tfdm_v2 = real
        counts = _all_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        img = film.beauty
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
              f"29 base {base}: bad image")
        check(_route_launched(counts, "widerow"),
              f"29 base {base}: not kernel 1: {counts}")
        ms_frame = timer.mean_ms("pathTrace")
        n_calls = max(len(calls), 1)
        row = {"frames": frames, "ms_per_pathTrace": ms_frame,
               "kernel1_per_frame": _per_frame(counts, frames).get(
                   "kernel1", {}),
               "tfdm_calls_per_frame": len(calls) / frames,
               "tfdm_ms_per_frame": sum(c["ms"] for c in calls) / frames,
               "per_call": {k: sum(c[k] for c in calls) / n_calls for k in (
                   "ms", "syncs", "rounds", "march_iterations",
                   "bvh_iterations")},
               "calls": calls, "peak_mib": peak, "mean": float(img.mean())}
        row["tfdm_share_of_frame"] = row["tfdm_ms_per_frame"] / ms_frame

        # one call on the primary rays (the heatmap's), fenced, then (base
        # 24) under torch.profiler
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, raw = heatmap(scene, cam, res, res)
        wall = (time.perf_counter() - t0) * 1e3
        events = kern = []
        if base == 24:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                heatmap(scene, cam, res, res)
                torch.cuda.synchronize()
            events = prof.events()
            kern = [e for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = _union_ms(kern) if kern else None
        row["primary_call_profile"] = {
            "wall_ms": wall, "kernels": len(kern) if kern else
            "not measured",
            "launch_calls": sum(1 for e in events if e.name in LAUNCH_CALLS),
            "device_busy_ms": busy if kern else "not measured",
            "idle_share": (1.0 - busy / wall) if kern else "not measured",
            "steps_mean_hit_pixels": float(raw[raw > 0].mean()),
            "steps_max": int(raw.max())}
        rows[f"base{base}"] = row
        p = row["primary_call_profile"]
        pc = row["per_call"]
        steps = [(round(c["steps_mean_marching"], 2), c["steps_max"])
                 for c in calls[:9]]
        print(f"[29 tfdm base{base}] {res}x{res}, {frames} frames (the app "
              f"renders 32): pathTrace {ms_frame:.1f} ms a frame, of it "
              f"{row['tfdm_ms_per_frame']:.1f} ms in "
              f"{row['tfdm_calls_per_frame']:.0f} intersect_tfdm_v2 calls "
              f"({row['tfdm_share_of_frame']:.3f}); kernel 1 "
              f"{row['kernel1_per_frame']} a frame; a call: "
              f"{pc['ms']:.0f} ms, {pc['syncs']:.0f} host syncs, "
              f"{pc['rounds']:.1f} rounds, {pc['march_iterations']:.0f} "
              f"march iterations, {pc['bvh_iterations']:.0f} BVH steps; "
              f"steps (mean over marching rays, max) {steps}; peak "
              f"{peak:.0f} MiB; the primary rays' call: {wall:.0f} ms, "
              f"{p['kernels']} CUDA kernels, {p['launch_calls']} launch "
              f"calls, device busy {_num(p['device_busy_ms'])} ms, idle "
              f"share {_num(p['idle_share'])}", flush=True)
        save_png(os.path.join(REPO, "out", f"torch_tfdm_base{base}.png"),
                 (img / (1.0 + img)).cpu().numpy())
        scene = bvh = film = img = None

    out, proc = cli or _tfdm_cli()
    _, err = proc.communicate(timeout=300)
    check(proc.returncode == 0,
          f"29 tfdm CLI exited {proc.returncode}: {err[-2000:]}")
    px = _png_pixels(out + ".png")
    heat = _png_pixels(out + "_heatmap.png")
    check(px.shape == (64, 64, 3) and px.any() and heat.shape == (64, 64, 3)
          and heat.any(), f"29 tfdm CLI: PNGs {px.shape} {heat.shape}")
    stats = [ln for ln in err.splitlines() if ln.startswith("final:")]
    rows["cli"] = {"stats": stats[-1] if stats else None,
                   "mean_pixel": float(px.mean()),
                   "heatmap_mean_pixel": float(heat.mean())}
    print(f"[29 tfdm CLI] -heatmap at 64x64, 4 frames (run beside phases "
          f"28-29): rc 0, "
          f"out/cli_tfdm_heatmap.png mean pixel {px.mean():.1f}, heatmap "
          f"mean pixel {heat.mean():.1f}; {stats[-1] if stats else ''}",
          flush=True)
    report["tfdm_costs"] = rows


NRTDSM_RAYS = 65536  # phase 30's camera and bounce rays
NRTDSM_EXACT_RAYS = 16384  # ... for intersect_nrtdsm_exact
NRTDSM_RES = 64  # phase 30's card-against-CPU renders
NRTDSM_SAMPLES = 1  # their samples (2 took 22 s of host-bound card time)
NRTDSM_COST_RES = 512  # the app's default resolution (phase 31)
NRTDSM_CLI_RES = 64  # the nrtdsm CLIs' images (phases 30-31)
# card against CPU on the same rays: share of rays whose hit agrees, t
# within rtol on that share of both-hit rays
NRTDSM_BARS = {"hit": 0.999, "t_rtol": 1e-4, "t_share": 0.999}
# phase 31's cells: the nrtdsm app's defaults (bilinear) and -shell
NRTDSM_CELLS = {"bilinear": [], "shell": ["-shell"]}
FRAME2_CELLS = ("shell",)  # phase 31's cells whose second frame is counted


def _torus_obj():
    """The torus OBJ of bench.write_mesh_files (the nrtdsm app's -shell-obj
    here: the reference's bunny is not in the repository), written once:
    phase 30's processes read it while the others run."""
    mesh_dir = os.path.join(REPO, "out", "meshes_nrtdsm")
    path = os.path.join(mesh_dir, "torus.obj")
    if not os.path.exists(path):
        path = bench.write_mesh_files(mesh_dir)["obj"]
    return path


def _nrtdsm_app(extra, width, height, traversal="widerow"):
    """The nrtdsm app's demo scene at its defaults (-base-res 16,
    -normal-tilt 0.3) and `extra` flags, compiled on the host for
    `traversal`: (scene, bvh, camera, host seconds)."""
    from gfxexp_torch.apps import nrtdsm as app
    from gfxexp_torch.apps.common import make_camera_from_args
    from gfxexp_torch.apps.tfdm import compile_demo

    extra = list(extra)
    if "-shell" in extra:
        extra += ["-shell-obj", _torus_obj()]
    args = app.parse_args(["-width", str(width), "-height", str(height),
                           "-traversal", traversal, *extra])
    t0 = time.time()
    scene, bvh, _ = compile_demo(args, "nrtdsm",
                                 app.displacement_params(args),
                                 app.shell_contents(args))
    return scene, bvh, make_camera_from_args(args), time.time() - t0


def _displaced_rays(hit_fn, cam, dev, n, seed=SEED):
    """n / 2 jittered camera rays through random pixels at 512^2, then as
    many bounce rays from their hits (hit_fn(o, d) -> a hit record), in
    random directions of the hit normal's hemisphere (rays whose camera ray
    missed are dead, t_max < 0): (o, d, t_min, t_max)."""
    from gfxexp_torch.render.camera import generate_rays_for_lanes

    rng = np.random.default_rng(seed)
    half = n // 2
    lane = torch.from_numpy(rng.integers(0, 512 * 512, half)).to(dev)
    jit = torch.from_numpy(rng.random((2, half), np.float32)).to(dev)
    o0, d0 = generate_rays_for_lanes(cam, 512, 512, lane, jit[0], jit[1])
    h0 = hit_fn(o0, d0)
    dirs = torch.from_numpy(rng.normal(size=(half, 3)).astype(
        np.float32)).to(dev)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    side = torch.where((dirs * h0.normal).sum(1) < 0, -1.0, 1.0)
    o = torch.cat([o0, torch.where(h0.hit[:, None], h0.position, o0)])
    d = torch.cat([d0, dirs * side[:, None]])
    t_min = torch.cat([torch.full((half,), 1e-4, device=dev),
                       torch.full((half,), 1e-3, device=dev)])
    t_max = torch.cat([torch.full((half,), 1e30, device=dev),
                       torch.where(h0.hit, 1e30, -1.0)])
    return o.contiguous(), d.contiguous(), t_min, t_max


def _intersector_card_vs_cpu(tag, fn, geom_c, rays, dev):
    """fn (an intersector of techniques/nrtdsm.py, shell.py or
    core/curves.py) on the card and on the CPU on the same rays: agreement
    (NRTDSM_BARS), the card's wall ms (fenced), peak memory and loop
    counts."""
    from gfxexp_torch.techniques import tfdm

    o, d, t_min, t_max = rays
    geom = geom_c.to(dev)
    fn(geom, o[:1024], d[:1024], t_min[:1024], t_max[:1024])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset_counters("tfdm.")
    t0 = time.perf_counter()
    hk = fn(geom, o, d, t_min, t_max)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stats = {k: v for k, v in _loop_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    hc = fn(geom_c, o.cpu(), d.cpu(), t_min.cpu(), t_max.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    hk = hk.to(torch.device("cpu"))
    hit_agree = float((hk.hit == hc.hit).float().mean())
    both = hk.hit & hc.hit
    rel = (hk.t[both] - hc.t[both]).abs() / hc.t[both].abs()
    t_share = (float((rel <= NRTDSM_BARS["t_rtol"]).float().mean())
               if rel.numel() else 1.0)
    live = t_max.cpu() > t_min.cpu()
    row = {"rays": o.shape[0], "live_rays": int(live.sum()),
           "hits": int(hk.hit.sum()), "hit_agree": hit_agree,
           "t_max_rel": float(rel.max()) if rel.numel() else 0.0,
           "t_share": t_share,
           "prim_equal": float((hk.prim[both] == hc.prim[both]).float()
                               .mean()) if rel.numel() else 1.0,
           "card_ms": ms, "cpu_ms": cpu_ms, "card_peak_mib": peak,
           "loop": stats}
    if hasattr(hk, "steps"):
        row["steps_equal"] = float((hk.steps == hc.steps).float().mean())
    check(hit_agree >= NRTDSM_BARS["hit"] and row["hits"] > 100
          and t_share >= NRTDSM_BARS["t_share"],
          f"30 {tag}: card vs CPU hit agree {hit_agree}, t within "
          f"{NRTDSM_BARS['t_rtol']} on {t_share}, {row['hits']} hits")
    print(f"[30 {tag}] {fn.__name__} on {o.shape[0]} camera and bounce rays "
          f"({row['live_rays']} live, {row['hits']} hits): card vs CPU hit "
          f"agree {hit_agree:.5f}, t max rel {row['t_max_rel']:.3g} (within "
          f"{NRTDSM_BARS['t_rtol']} on {t_share:.5f}), prims equal "
          f"{row['prim_equal']:.5f}, steps equal "
          f"{row.get('steps_equal', 1.0):.5f}; card {ms:.1f} ms (CPU "
          f"{cpu_ms:.0f} ms), peak {peak:.0f} MiB, loops {stats}",
          flush=True)
    return row, hk


def _kernel6_on_shell_batches(tag, geom_c, rays, dev):
    """One intersect_shell call on the card with its chord queries
    recorded (each (o, d, t_min = 0, t_max) batch it sends the contents'
    skip-link walk; t_max = -1 on lanes that need no query), then kernel 6
    (walk_skip_cuda, the per-ray scope) against walk_skip_plain on every
    batch: t, u, v, tri and hit equal. The call's kernel-6 launches are
    counted apart from these comparisons."""
    from gfxexp_torch.techniques import shell

    o, d, t_min, t_max = rays
    geom = geom_c.to(dev)
    batches = []
    real = shell.intersect_closest

    def recorded(bvh, tris, q, sdir, t_min, t_max):
        batches.append((q, sdir, t_max))
        return real(bvh, tris, q, sdir, t_min=t_min, t_max=t_max)

    _reset_counts()
    shell.intersect_closest = recorded
    try:
        shell.intersect_shell(geom, o, d, t_min, t_max)
    finally:
        shell.intersect_closest = real
    torch.cuda.synchronize()
    launches = _all_counts()["skip"]["closest_thread"]
    check(launches == len(batches) > 0,
          f"30 {tag}: {launches} kernel 6 launches for {len(batches)} "
          f"chord batches")
    lanes = dead = 0
    for q, sdir, tm in batches:
        kc = walk_skip_cuda(geom.shell_bvh, geom.shell_tris, q, sdir, 0.0,
                            tm, False)
        pc = walk_skip_plain(geom.shell_bvh, geom.shell_tris, q, sdir, 0.0,
                             tm, False)
        for f in ("t", "u", "v", "tri", "hit"):
            check(torch.equal(getattr(kc, f), getattr(pc, f)),
                  f"30 {tag}: kernel 6 {f} differs from plain on a chord "
                  f"batch")
        lanes += q.shape[0]
        dead += int((tm < 0).sum())
    row = {"batches": len(batches), "lanes": lanes, "dead_lanes": dead,
           "live_lanes": lanes - dead, "kernel6_launches": launches,
           "max_abs_err": 0.0}
    check(dead > 0 and lanes > dead,
          f"30 {tag}: chord batches without live or dead lanes: {row}")
    print(f"[30 {tag} kernel 6] one intersect_shell call's {len(batches)} "
          f"chord batches ({lanes} lanes, {dead} with t_max = -1, t_min = "
          f"0): kernel 6 equal to walk_skip_plain bit for bit in t, u, v, "
          f"tri, hit; the call launched kernel 6 {launches} times",
          flush=True)
    return row


def _nrtdsm_curves():
    """Eight cubic B-spline curves of six control points arching over the
    nrtdsm patch (24 spans, r 0.02-0.05): phase 30's curve geometry."""
    from gfxexp_torch.core.curves import CurveSpans, build_curve_spans

    rng = np.random.default_rng(SEED)
    parts = []
    for i in range(8):
        x = np.linspace(-0.9, 0.9, 6)
        z = -0.8 + 0.22 * i + 0.1 * np.sin(3 * x + i)
        y = 0.15 + 0.3 * np.sin(np.pi * (x + 0.9) / 1.8) + 0.05 * rng.random(6)
        parts.append(build_curve_spans(
            np.stack([x, y, z], -1), rng.uniform(0.02, 0.05, 6)))
    return CurveSpans(**{f: torch.cat([getattr(p, f) for p in parts])
                         for f in ("coef", "rcoef", "lo", "hi")})


def nrtdsm_cpu_renders(out_path, res, samples):
    """Phase 30's CPU renders, in a process of their own beside the card's:
    the nrtdsm demo scene (bilinear) and its -shell form, wide rows, at
    res^2, `samples` samples; images, rays and seconds to `out_path`
    (npz)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    out = {}
    for cell, extra in NRTDSM_CELLS.items():
        scene, bvh, cam, _ = _nrtdsm_app(extra, res, res)
        t0 = time.perf_counter()
        img, rays = _tex_render(scene, bvh, cam, res, samples,
                                PTConfig(count_rays=True), 0)
        out.update({f"img_{cell}": img, f"rays_{cell}": rays,
                    f"seconds_{cell}": time.perf_counter() - t0})
    np.savez(out_path, **out)


def _nrtdsm_clis():
    """Start the nrtdsm CLI at NRTDSM_CLI_RES^2, 4 frames, with -heatmap,
    and with -shell (the torus OBJ): [(tag, output, process)]."""
    return [(tag, *_png_cli(tag, "gfxexp_torch.apps.nrtdsm", argv,
                            NRTDSM_CLI_RES))
            for tag, argv in (
                ("nrtdsm_heatmap", ["-heatmap"]),
                ("nrtdsm_shell", ["-shell", "-shell-obj", _torus_obj(),
                                  "-heatmap"]))]


def phase_nrtdsm(report, dev):
    """Phase 30: NRTDSM, shells and curves, card against CPU, on the
    nrtdsm app's scene at its defaults (-base-res 16, curved shells):
    intersect_nrtdsm_v2 and intersect_curve_spans (eight curves over the
    patch) on NRTDSM_RAYS camera and bounce rays, intersect_nrtdsm_exact
    on NRTDSM_EXACT_RAYS, intersect_shell (-shell, the torus OBJ) on
    NRTDSM_RAYS of its own; kernel 6 against its plain version on the
    chord batches one card shell call sends; kernels 1 and 6 against their
    plain versions on the scene's rays and their shadow rays; the scene
    and its -shell form at NRTDSM_RES^2, NRTDSM_SAMPLES samples, card
    against CPU (the CPU's in a process of its own). The nrtdsm CLIs run
    beside it and are read at its end (phase 31 prints them)."""
    cpu_out = os.path.join(REPO, "out", "nrtdsm_cpu_renders.npz")
    if os.path.exists(cpu_out):
        os.remove(cpu_out)
    os.makedirs(os.path.dirname(cpu_out), exist_ok=True)
    _torus_obj()  # written once, before the processes that read it
    cpu_proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; "
         f"c.nrtdsm_cpu_renders({cpu_out!r}, {NRTDSM_RES}, "
         f"{NRTDSM_SAMPLES})"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    clis = _nrtdsm_clis()
    procs = [cpu_proc] + [p for _, _, p in clis]
    try:
        return _phase_nrtdsm(report, dev, cpu_proc, cpu_out, clis)
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise


def _phase_nrtdsm(report, dev, cpu_proc, cpu_out, clis):
    from gfxexp_torch.core.curves import intersect_curve_spans
    from gfxexp_torch.techniques.nrtdsm import (
        intersect_nrtdsm_exact,
        intersect_nrtdsm_v2,
    )
    from gfxexp_torch.techniques.shell import intersect_shell

    rows = {}
    scene, bvh, cam, host_s = _nrtdsm_app([], 512, 512)
    geom = scene.displaced[0]
    sd, bd = scene.to(dev), bvh.to(dev)
    camd = cam.to(dev)
    gd = sd.displaced[0]
    rays = _displaced_rays(lambda o, d: intersect_nrtdsm_v2(gd, o, d), camd,
                           dev, NRTDSM_RAYS)
    rows["nrtdsm_v2"], _ = _intersector_card_vs_cpu(
        "nrtdsm v2", intersect_nrtdsm_v2, geom, rays, dev)
    rows["nrtdsm_v2"]["host_build_s"] = host_s
    rows["curve_spans"], _ = _intersector_card_vs_cpu(
        "curve spans", intersect_curve_spans, _nrtdsm_curves(), rays, dev)
    lamp = (0.8, 2.6, 0.8)
    rows["kernel1"] = _walk_on("nrtdsm", "widerow", sd, bd, *rays, lamp, dev,
                               phase="30")
    sk_scene, sk_bvh = (x.to(dev) for x in _nrtdsm_app([], 512, 512,
                                                       "skip")[:2])
    rows["kernel6"] = _walk_on("nrtdsm", "skip", sk_scene, sk_bvh, *rays,
                               lamp, dev, phase="30")
    sk_scene = sk_bvh = None
    exact_scene = _nrtdsm_app(["-local-intersection", "two_triangle"], 512,
                              512)[0]
    ex = exact_scene.displaced[0]
    # the first camera rays and their bounce rays
    half = NRTDSM_RAYS // 2
    ex_rays = tuple(torch.cat([x[: NRTDSM_EXACT_RAYS // 2],
                               x[half: half + NRTDSM_EXACT_RAYS // 2]])
                    .contiguous() for x in rays)
    rows["nrtdsm_exact"], _ = _intersector_card_vs_cpu(
        "nrtdsm exact", intersect_nrtdsm_exact, ex, ex_rays, dev)

    shell_scene, _, _, shell_s = _nrtdsm_app(["-shell"], 512, 512)
    sg = shell_scene.displaced[0]
    sgd = sg.to(dev)
    s_rays = _displaced_rays(lambda o, d: intersect_shell(sgd, o, d), camd,
                             dev, NRTDSM_RAYS, SEED + 2)
    rows["shell"], _ = _intersector_card_vs_cpu(
        "shell", intersect_shell, sg, s_rays, dev)
    rows["shell"].update(host_build_s=shell_s,
                         auto_segments=sg.auto_segments,
                         content_triangles=sg.shell_tris.p0.shape[0])
    rows["shell_kernel6"] = _kernel6_on_shell_batches("shell", sg, s_rays,
                                                      dev)

    # the renders, card against the CPU's process
    cards = {}
    for cell, extra in NRTDSM_CELLS.items():
        c_scene, c_bvh, c_cam, _ = _nrtdsm_app(extra, NRTDSM_RES,
                                               NRTDSM_RES)
        _reset_counts()
        t0 = time.perf_counter()
        a, ra = _tex_render(c_scene.to(dev), c_bvh.to(dev), c_cam.to(dev),
                            NRTDSM_RES, NRTDSM_SAMPLES,
                            PTConfig(count_rays=True), 0)
        cards[cell] = (a, ra, time.perf_counter() - t0, _all_counts())
    _, err = cpu_proc.communicate(timeout=900)
    check(cpu_proc.returncode == 0,
          f"30 CPU renders exited {cpu_proc.returncode}: {err[-2000:]}")
    cpu = np.load(cpu_out)
    for cell, (a, ra, card_s, counts) in cards.items():
        c = cpu[f"img_{cell}"]
        rc = float(cpu[f"rays_{cell}"])
        rel = _rel(a, c)
        check(counts["kernel1"]["closest"] > 0 and counts["kernel1"]["any"]
              > 0 and (cell != "shell"
                       or counts["skip"]["closest_thread"] > 0),
              f"30 render {cell}: walks {counts}")
        check(np.isfinite(a).all() and a.mean() > 0 and rel < IMAGE_BAR
              and abs(ra - rc) <= 0.005 * rc,
              f"30 render {cell}: image rel diff {rel}, rays {ra} vs {rc}")
        rows[f"render {cell}"] = {
            "image_rel_diff": rel, "rays": ra, "cpu_rays": rc,
            "mean": float(a.mean()), "card_s": card_s,
            "cpu_s": float(cpu[f"seconds_{cell}"]),
            "kernel1": counts["kernel1"],
            "kernel6": counts["skip"]["closest_thread"]}
        print(f"[30 render {cell}] {NRTDSM_RES}x{NRTDSM_RES}, "
              f"{NRTDSM_SAMPLES} samples: card vs CPU image rel diff "
              f"{rel:.3g} (bar {IMAGE_BAR}), rays {ra:.0f} / {rc:.0f}, mean "
              f"{a.mean():.4f}; card {card_s:.1f} s, CPU "
              f"{rows[f'render {cell}']['cpu_s']:.1f} s; kernel 1 "
              f"{counts['kernel1']}, kernel 6 "
              f"{counts['skip']['closest_thread']}", flush=True)
        save_png(os.path.join(REPO, "out", f"torch_nrtdsm_{cell}_64.png"),
                 (a / (1 + a)).reshape(NRTDSM_RES, NRTDSM_RES, 3))
    cli_rows = {}
    for tag, out, proc in clis:
        _, err = proc.communicate(timeout=600)
        check(proc.returncode == 0,
              f"30 {tag} CLI exited {proc.returncode}: {err[-2000:]}")
        px = _png_pixels(out + ".png")
        heat = _png_pixels(out + "_heatmap.png")
        check(px.shape == (NRTDSM_CLI_RES, NRTDSM_CLI_RES, 3) and px.any()
              and heat.any(), f"30 {tag} CLI: PNGs {px.shape} {heat.shape}")
        stats = [ln for ln in err.splitlines() if ln.startswith("final:")]
        cli_rows[tag] = {"stats": stats[-1] if stats else None,
                         "mean_pixel": float(px.mean()),
                         "heatmap_mean_pixel": float(heat.mean())}
    report["nrtdsm"] = rows
    return cli_rows


def phase_nrtdsm_costs(report, dev, cli_rows):
    """Phase 31: the nrtdsm app's frame loop at 512^2 (its defaults:
    -base-res 16, -normal-tilt 0.3, ridges, -h-scale 0.25, bilinear) and
    with -shell (the torus OBJ tiled 3 x 3), one frame each: ms per
    pathTrace (fenced); each displaced call fenced and recorded (its ms,
    host syncs, rounds, exact-loop steps, prism-BVH steps), so the calls'
    share of the frame; kernel 1's and kernel 6's launches in the frame
    (counts set to 0 before it); peak memory; then a second frame under
    a dispatch counter (op_counts), its walk launches counted; then one
    displaced call on the frame's primary rays (the heatmap's), fenced,
    counted the same way and under torch.profiler (CUDA activity): CUDA
    kernels, launch calls, device busy and idle share, and so CUDA kernels
    an op, which turns the second frame's ops into its CUDA kernels. Last,
    the nrtdsm CLIs that phase 30 ran."""
    from torch.profiler import ProfilerActivity, profile

    from gfxexp_torch.apps.tfdm import heatmap
    from gfxexp_torch.op_counts import _Count
    from gfxexp_torch.techniques import nrtdsm, shell, tfdm

    rows = {}
    for cell, extra in NRTDSM_CELLS.items():
        res = NRTDSM_COST_RES
        scene, bvh, cam, _ = _nrtdsm_app(extra, res, res)
        scene, bvh, cam = scene.to(dev), bvh.to(dev), cam.to(dev)
        mod, name = ((shell, "intersect_shell") if cell == "shell"
                     else (nrtdsm, "intersect_nrtdsm_v2"))
        real = getattr(mod, name)
        calls = []

        def recorded(*a, **kw):
            torch.cuda.synchronize()
            before = _loop_counts()
            t0 = time.perf_counter()
            h = real(*a, **kw)
            torch.cuda.synchronize()
            after = _loop_counts()
            calls.append({"ms": (time.perf_counter() - t0) * 1e3, **{
                k: after[k] - before[k] for k in (
                    "syncs", "rounds", "exact_iterations",
                    "bvh_iterations")}})
            return h

        cfg = PTConfig()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timer = PassTimer(device=dev)
        _reset_counts()
        trace.reset_counters("tfdm.")
        setattr(mod, name, recorded)
        try:
            film, _, _, _ = frame_loop(scene, bvh, cam, [], "widerow", res,
                                       res, 1, cfg, timer)
        finally:
            setattr(mod, name, real)
        counts = _all_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        img = film.beauty
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
              f"31 {cell}: bad image")
        check(counts["kernel1"]["closest"] > 0 and counts["kernel1"]["any"]
              > 0 and (cell != "shell"
                       or counts["skip"]["closest_thread"] > 0),
              f"31 {cell}: walks {counts}")
        ms_frame = timer.mean_ms("pathTrace")
        n_calls = max(len(calls), 1)
        row = {"ms_per_pathTrace": ms_frame,
               "kernel1_per_frame": counts["kernel1"],
               "kernel6_per_frame": counts["skip"]["closest_thread"],
               "calls_per_frame": len(calls),
               "calls_ms_per_frame": sum(c["ms"] for c in calls),
               "per_call": {k: sum(c[k] for c in calls) / n_calls for k in (
                   "ms", "syncs", "rounds", "exact_iterations",
                   "bvh_iterations")},
               "calls": calls, "peak_mib": peak, "mean": float(img.mean())}
        row["calls_share_of_frame"] = row["calls_ms_per_frame"] / ms_frame

        # the second frame's dispatched ops (~ CUDA kernels) and walks,
        # on the cells of FRAME2_CELLS only (the bilinear frame's, 13-18
        # s, is left out for the script's time)
        counter = walks = None
        if cell in FRAME2_CELLS:
            _reset_counts()
            with _Count() as counter:
                render_sample(scene, bvh, cam, res, res, 1, cfg)
            torch.cuda.synchronize()
            walks = sum(v for c in _all_counts().values()
                        for v in c.values())
            row["frame2_ops"] = counter.ops
            row["frame2_walk_launches"] = walks

        # one call on the primary rays (the heatmap's), fenced, its ops
        # dispatched counted, then profiled: CUDA kernels an op
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, raw = heatmap(scene, cam, res, res, "nrtdsm")
        wall = (time.perf_counter() - t0) * 1e3
        with _Count() as call_ops:
            heatmap(scene, cam, res, res, "nrtdsm")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            heatmap(scene, cam, res, res, "nrtdsm")
            torch.cuda.synchronize()
        events = prof.events()
        kern = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = _union_ms(kern) if kern else None
        row["primary_call_profile"] = {
            "wall_ms": wall, "kernels": len(kern) if kern else
            "not measured",
            "launch_calls": sum(1 for e in events if e.name in LAUNCH_CALLS),
            "device_busy_ms": busy if kern else "not measured",
            "idle_share": (1.0 - busy / wall) if kern else "not measured",
            "ops": call_ops.ops,
            "kernels_per_op": (len(kern) / call_ops.ops) if kern else
            "not measured",
            "steps_mean_hit_pixels": float(raw[raw > 0].mean()),
            "steps_max": int(raw.max())}
        if kern and counter is not None:
            row["frame2_kernels_estimate"] = (
                counter.ops * len(kern) / call_ops.ops + walks)
        rows[cell] = row
        p = row["primary_call_profile"]
        pc = row["per_call"]
        est = row.get("frame2_kernels_estimate", "not measured")
        print(f"[31 nrtdsm {cell}] {res}x{res}, 1 frame (the app renders "
              f"32): pathTrace {ms_frame:.1f} ms, of it "
              f"{row['calls_ms_per_frame']:.1f} ms in {len(calls)} {name} "
              f"calls ({row['calls_share_of_frame']:.3f}); kernel 1 "
              f"{counts['kernel1']}, kernel 6 "
              f"{row['kernel6_per_frame']} a frame; a call: {pc['ms']:.0f} "
              f"ms, {pc['syncs']:.0f} host syncs, {pc['rounds']:.1f} "
              f"rounds, {pc['exact_iterations']:.0f} exact steps, "
              f"{pc['bvh_iterations']:.0f} BVH steps; peak {peak:.0f} MiB; "
              + (f"frame 2: {counter.ops} ops dispatched + {walks} walk "
                 f"launches (~{_num(est, 0)} CUDA kernels); "
                 if counter is not None else "") + f"the primary "
              f"rays' call: {wall:.0f} ms, "
              f"{p['ops']} ops, {p['kernels']} CUDA kernels "
              f"({_num(p['kernels_per_op'])} an op), {p['launch_calls']} "
              f"launch calls, device busy {_num(p['device_busy_ms'])} ms, "
              f"idle share {_num(p['idle_share'])}", flush=True)
        save_png(os.path.join(REPO, "out", f"torch_nrtdsm_{cell}.png"),
                 (img / (1.0 + img)).cpu().numpy())
        scene = bvh = film = img = None
    for tag, row in cli_rows.items():
        print(f"[31 {tag} CLI] {NRTDSM_CLI_RES}x{NRTDSM_CLI_RES}, 4 frames "
              f"(run beside phase 30): rc 0, "
              f"mean pixel {row['mean_pixel']:.1f}, heatmap mean pixel "
              f"{row['heatmap_mean_pixel']:.1f}; {row['stats'] or ''}",
              flush=True)
    rows["clis"] = cli_rows
    report["nrtdsm_costs"] = rows


# ---------------------------------------------------------------------------
# phases 32-35: SBVH, the wide BVH, sharding, the PTConfig options and the
# runtime utilities
# ---------------------------------------------------------------------------

SBVH_CASES = (("small", "widerow"), ("big", "qrow"))  # (scene, table)
SBVH_WALKS = {"widerow": (walk_cuda, walk_plain),
              "qrow": (walk_qrow_cuda, walk_qrow_plain)}
WIDE_RES = 64  # phase 33's card-against-CPU render
NRC_DP_BATCH = 65536  # phase 34's data-parallel NRC batch
OPTION_SCENES = ("small", "city")  # phase 35, city flattened as wide rows
LIVE_RES = 128  # phase 35's path_tracing -live run


def _numpy_sbvh_proc():
    """A process that builds the small scene's SBVH with the numpy builder
    and prints its host seconds and references as JSON (beside the card's
    work of phase 32)."""
    code = ("import json, time\n"
            "from gfxexp_torch import bench\n"
            "from gfxexp_torch.accel.bvh_build import build_bvh\n"
            "t = bench.bench_scene_builder(scene='small').compile()"
            ".triangles\n"
            "t0 = time.time()\n"
            "b, perm = build_bvh(t.p0.numpy(), t.e1.numpy(), t.e2.numpy(), "
            "use_native=False, spatial_splits=True)\n"
            "print(json.dumps({'seconds': time.time() - t0, 'references': "
            "len(perm), 'triangles': t.p0.shape[0], 'nodes': "
            "b.child_idx.shape[0], 'max_depth': b.max_depth}))\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _world_soup(which):
    """The bench scene's world triangles (p0, e1, e2) on the host."""
    t = bench.bench_scene_builder(scene=which).compile().triangles
    return t.p0.numpy(), t.e1.numpy(), t.e2.numpy()


def _sbvh_tables(report, dev):
    """Each SBVH case's table built with and without splits: {(table kind,
    splits): (table on the card, perm, soup in table order)}."""
    tables, rows = {}, {}
    for which, fmt in SBVH_CASES:
        soup = _world_soup(which)
        for splits in (False, True):
            t0 = time.time()
            if fmt == "widerow":
                tab, perm = widerow.build_widerow(*soup,
                                                  spatial_splits=splits)
                dup = tuple(x[perm] for x in soup)
            else:
                tab, perm, dup = qrow.build_qrow(*soup,
                                                 spatial_splits=splits)
            secs = time.time() - t0
            tables[(fmt, splits)] = (tab.to(dev), perm, dup)
            key = f"{which}_{fmt}_{'sbvh' if splits else 'plain'}"
            rows[key] = {"triangles": soup[0].shape[0],
                         "references": int(perm.shape[0]),
                         "chunks": tab.num_chunks,
                         "rows": tab.num_chunks * tab.nodes.shape[1],
                         "max_depth": tab.max_depth, "host_seconds": secs}
            print(f"[32 sbvh build] {key}: {soup[0].shape[0]} triangles -> "
                  f"{perm.shape[0]} references, {tab.num_chunks} chunks of "
                  f"up to {tab.nodes.shape[1]} rows, max depth "
                  f"{tab.max_depth}, native build + pack on the host "
                  f"{secs:.2f}s", flush=True)
    report["sbvh"] = {"build": rows}
    return tables


def _source_mismatches(perm, k, b, sub):
    """Rays of `sub` where the walk and brute force (over the duplicated
    soup) both hit at the same t (rtol 1e-4) but name different source
    triangles perm[tri] beyond a tie."""
    kt, kh, ktri = k.t[sub], k.hit[sub], k.tri[sub]
    both = kh & b.hit
    close = (kt - b.t).abs() <= 1e-4 * b.t.abs() + 1e-4
    src_k = perm[ktri.clamp(min=0).long()]
    src_b = perm[b.tri.clamp(min=0).long()]
    same_t = (kt - b.t).abs() <= 1e-6 * b.t.abs()
    return int((both & close & (src_k != src_b) & ~same_t).sum())


def phase_sbvh(report, dev):
    """SBVH: `small` as wide rows and `big` flattened as quantized rows,
    with and without spatial splits; kernel 1 and kernel 7 on the SBVH
    tables against their plain versions and brute force over the
    duplicated soup; their ms per bounce batch beside the tables without
    splits; bench.measure with and without splits; a card-against-CPU
    render."""
    proc = _numpy_sbvh_proc()
    tables = _sbvh_tables(report, dev)
    rep = report["sbvh"]
    for which, fmt in SBVH_CASES:
        tab, perm, dup = tables[(fmt, True)]
        kwalk, pwalk = SBVH_WALKS[fmt]
        tag = f"32 sbvh {which} {fmt}"

        def first_hit(o0, d0):
            h = kwalk(tab, o0, d0, 0.0, 1e30, False)
            return h.t, h.hit

        o, d, t_min, t_max, sd, s_max = _scene_rays(first_hit, which, dev)
        res = {}
        for any_hit in (False, True):
            kind = "any" if any_hit else "closest"
            dd, tm = (sd, s_max) if any_hit else (d, t_max)
            k = kwalk(tab, o, dd, t_min, tm, any_hit)
            p = pwalk(tab, o, dd, t_min, tm, any_hit)
            torch.cuda.synchronize()
            for f in ("hit", "t", "u", "v", "tri"):
                diff = getattr(k, f) != getattr(p, f)
                check(not bool(diff.any()), f"{tag} {kind}: {f} differs "
                      f"from plain on {int(diff.sum())} rays")
            res[kind] = k
        n = o.shape[0]
        sub = torch.arange(0, n, n // BRUTE_SUB, device=dev)[:BRUTE_SUB]
        world = types.SimpleNamespace(
            **{k: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
               for k, x in zip(("p0", "e1", "e2"), dup)}, count=len(perm))
        brute = _brute_mismatches(world, res["closest"], res["any"], sub, o,
                                  d, sd, t_min, t_max, s_max,
                                  coplanar_apart=True)
        _check_brute(brute, sub, tag)
        bc = intersect_closest_brute(world, o[sub], d[sub], t_min[sub],
                                     t_max[sub])
        src = _source_mismatches(torch.from_numpy(perm).to(dev),
                                 res["closest"], bc, sub)
        check(src == 0, f"{tag}: {src} rays name another source triangle "
              f"than brute force")
        b = slice(BATCH, 2 * BATCH)
        # the tables in turns, without splits, SBVH, SBVH, without: a drift
        # of the card within the call shows as a spread between the two
        # readings of one table; the host's ms to enqueue a launch, beside
        # each, shows a reading the host held back
        turns, host, ahead = {}, {}, {}
        for any_hit in (False, True):
            kind = "any" if any_hit else "closest"
            args = ((o[b], sd[b], t_min[b], s_max[b]) if any_hit
                    else (o[b], d[b], t_min[b], t_max[b]))
            for splits in (False, True, True, False):
                t_s = tables[(fmt, splits)][0]
                key = f"{kind}_{'sbvh' if splits else 'plain'}"
                ms, h_ms, first = _device_and_host_ms(
                    lambda: kwalk(t_s, *args, any_hit), 20)
                turns.setdefault(key, []).append(ms)
                host.setdefault(key, []).append(h_ms)
                ahead.setdefault(key, []).append(first)
        times = {k: sum(v) / len(v) for k, v in turns.items()}
        rep[f"{which}_{fmt}"] = {"rays": n, "brute": brute,
                                 "source_mismatches": src, "ms": times,
                                 "ms_turns": turns,
                                 "host_ms_per_launch": host,
                                 "host_ahead_of_card": ahead}
        print(f"[32 {which} {fmt}] {n} rays: the kernel on the SBVH table "
              f"== plain (closest, any); brute force over the "
              f"{len(perm)} duplicated references on {sub.numel()} rays: "
              f"{brute}, source triangles equal; ms per {BATCH}-ray bounce "
              f"batch SBVH / without splits, the mean of two turns: closest "
              f"{times['closest_sbvh']:.4f} / {times['closest_plain']:.4f},"
              f" any {times['any_sbvh']:.4f} / {times['any_plain']:.4f}; "
              f"turns (without, SBVH, SBVH, without; the host's enqueue "
              f"ms a launch, * where it did not finish within the card's "
              f"spin) "
              + "; ".join(f"{k}: " + ", ".join(
                  f"{m:.4f} (host {h:.4f}{'' if a else '*'})"
                  for m, h, a in zip(turns[k], host[k], ahead[k]))
                  for k in ("closest_plain", "closest_sbvh", "any_plain",
                            "any_sbvh")),
              flush=True)
    tables = None
    from gfxexp_torch.scene.compile import compile_scene

    scene_s, bvh_s = compile_scene(bench.bench_scene_builder(scene="small"),
                                   traversal="widerow", spatial_splits=True)
    scene_s, bvh_s = scene_s.to(dev), bvh_s.to(dev)
    scene_p, bvh_p = (x.to(dev) for x in bench.build_bench_scene("small"))
    rows = {}
    for size in ("512", "1080p"):
        for name, s, bv in (("plain", scene_p, bvh_p),
                            ("sbvh", scene_s, bvh_s)):
            _reset_counts()
            r = bench.measure(size, s, bv, device=dev)
            _check_bench_row(r, f"32 bench {size} {name}")
            lc = _all_counts()["kernel1"]
            check(lc["closest"] > 0 and lc["any"] > 0,
                  f"32 bench {size} {name}: kernel 1 not launched {lc}")
            rows[f"{size}_{name}"] = {
                "mrays": r["value"], "seconds": r["seconds"],
                "rays": r["rays"], "kernel1_launches": lc}
            print(f"[32 bench] small {size} {name}: {r['value']} Mrays/s "
                  f"({r['rays']:.0f} rays in {r['seconds']:.3f}s), kernel 1 "
                  f"launches {lc}", flush=True)
    rep["bench"] = rows
    rep["slice"] = _render_pair(scene_s, bvh_s, "small", dev, "32 sbvh slice")
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"32 numpy SBVH build failed: {err[-2000:]}")
    rep["numpy_build"] = json.loads(out.strip().splitlines()[-1])
    nb = rep["numpy_build"]
    print(f"[32 sbvh] 64x64 2spp SBVH render cuda vs cpu: image rel diff "
          f"{rep['slice']['image_rel_diff']:.3g}; numpy SBVH of small "
          f"(beside the card's work): {nb['triangles']} -> "
          f"{nb['references']} references in {nb['seconds']:.2f}s on the "
          f"host", flush=True)


def phase_wide(report, dev):
    """traversal="wide": small compiled as the stack-based wide BVH, a
    64x64 2-sample render card against CPU, then one 512x512 sample on the
    card: ms, CUDA kernels, host syncs and loop steps a query."""
    from torch.profiler import ProfilerActivity, profile

    from gfxexp_torch.scene.compile import compile_scene

    scene, bvh = compile_scene(bench.bench_scene_builder(scene="small"),
                               traversal="wide")
    rep = {"nodes": int(bvh.child_idx.shape[0]), "max_depth": bvh.max_depth}
    rep["slice"] = _render_pair(scene.to(dev), bvh.to(dev), "small", dev,
                                "33 wide slice")
    scene, bvh = scene.to(dev), bvh.to(dev)
    cam = bench.bench_camera(512, 512).to(dev)
    cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH, count_rays=True)
    _reset_counts()
    trace.reset_counters("wide.")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, rays = render_sample(scene, bvh, cam, 512, 512, 1, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stats = {k: trace.counters("wide.").get(f"wide.{k}", 0)
             for k in ("queries", "syncs", "steps")}
    counts = _all_counts()
    check(not any(v for c in counts.values() for v in c.values()),
          f"33 wide: a walk kernel was launched: {counts}")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
          "33 wide: bad 512x512 image")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render_sample(scene, bvh, cam, 512, 512, 1, cfg)
        torch.cuda.synchronize()
    kern = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    q = max(stats["queries"], 1)
    rep.update(ms_512=ms, rays=float(rays), cuda_kernels=kern or
               "not measured", queries=stats["queries"],
               syncs_per_query=stats["syncs"] / q,
               steps_per_query=stats["steps"] / q)
    report["wide"] = rep
    print(f"[33 wide] small as a wide BVH ({rep['nodes']} nodes, depth "
          f"{rep['max_depth']}): 64x64 2spp cuda vs cpu image rel diff "
          f"{rep['slice']['image_rel_diff']:.3g}; one 512x512 sample "
          f"{ms:.1f} ms, {rep['cuda_kernels']} CUDA kernels, "
          f"{stats['queries']} queries, {rep['syncs_per_query']:.1f} syncs "
          f"and {rep['steps_per_query']:.1f} loop steps a query, no walk "
          f"kernel", flush=True)


def _fenced_ms(fn, reps=1):
    """Host ms of fn() fenced by torch.cuda.synchronize (mean of reps, after
    a warm call) and its last result."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def phase_sharded(report, dev):
    """The sharded entry points on a one-rank NCCL group (file://
    rendezvous): the render at 512x512 on small (kernel 1) and `big` as
    skip links (kernel 6), SVGF on a 1080p frame, the data-parallel NRC
    step, each against its unsharded call (bit for bit; NRC at phase 23's
    bars, card against CPU) and timed beside it."""
    import tempfile

    import torch.distributed as dist

    from gfxexp_torch.core.tree import tree_leaves, tree_map
    from gfxexp_torch.parallel import sharding
    from gfxexp_torch.render.camera import lane_from_pixel
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.techniques import svgf
    from gfxexp_torch.techniques.nrc import network as nrc

    rdv = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{rdv}/rendezvous",
                            world_size=1, rank=0)
    rep = {}
    try:
        mesh = sharding.make_mesh()
        cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH)
        order = lane_from_pixel(torch.arange(512 * 512, device=dev), 512,
                                512)
        for which, traversal, route in (("small", "widerow", "widerow"),
                                        ("big", "skip", "skip")):
            scene, bvh = (x.to(dev) for x in bench.build_bench_scene(
                which, traversal=traversal))
            cam = bench.bench_camera(512, 512, which).to(dev)
            _reset_counts()
            ms_s, lanes = _fenced_ms(lambda: sharding.render_sample_sharded(
                mesh, scene, bvh, cam, 512, 512, 2, cfg))
            counts = _all_counts()
            ms_1, ref = _fenced_ms(lambda: render_sample(
                scene, bvh, cam, 512, 512, 2, cfg))
            check(torch.equal(lanes[order], ref),
                  f"34 sharded render {which}: differs from render_sample")
            check(_route_launched(counts, route),
                  f"34 sharded render {which}: not on its kernel {counts}")
            rep[f"render_{which}"] = {"ms": ms_s, "unsharded_ms": ms_1,
                                      "launches": counts}
            print(f"[34 sharded] render_sample_sharded {which} ({traversal})"
                  f" 512x512 == render_sample bit for bit; {ms_s:.2f} ms "
                  f"against {ms_1:.2f} ms unsharded; launches {counts}",
                  flush=True)
        scene, bvh = (x.to(dev) for x in bench.build_bench_scene("small"))
        cam = bench.bench_camera(TECH_W, TECH_H).to(dev)
        gb = render_gbuffer(scene, bvh, cam, cam, TECH_W, TECH_H, 0, False)
        light = render_sample(scene, bvh, cam, TECH_W, TECH_H, 0,
                              cfg).reshape(TECH_H, TECH_W, 3)
        scfg = svgf.SVGFConfig()
        st0 = svgf.make_svgf_state(TECH_W, TECH_H, dev)
        ms_s, (a, st_a) = _fenced_ms(lambda: sharding.svgf_frame_sharded(
            mesh, st0, gb, light, scfg), 3)
        ms_1, (b, st_b) = _fenced_ms(lambda: svgf.svgf_frame(
            st0, gb, light, scfg), 3)
        check(torch.equal(a, b) and torch.equal(st_a.prev_noisy,
                                                st_b.prev_noisy),
              "34 sharded svgf: differs from svgf_frame")
        rep["svgf"] = {"ms": ms_s, "unsharded_ms": ms_1}
        print(f"[34 sharded] svgf_frame_sharded {TECH_W}x{TECH_H} == "
              f"svgf_frame bit for bit; {ms_s:.2f} ms against {ms_1:.2f} ms",
              flush=True)

        ncfg = nrc.NRCConfig()
        st_c = nrc.init_nrc(torch.Generator().manual_seed(SEED), ncfg, "cpu")
        w = torch.randn(st_c["params"]["weights"][-1].shape,
                        generator=torch.Generator().manual_seed(SEED)) * 0.1
        for part in ("params", "ema"):
            st_c[part]["weights"][-1] = w.clone()
        rng = np.random.default_rng(SEED)
        batch_c = (torch.from_numpy(rng.random((NRC_DP_BATCH, 14),
                                               np.float32)),
                   torch.from_numpy(rng.random((NRC_DP_BATCH, 3),
                                               np.float32) * 2.0),
                   torch.from_numpy(rng.random(NRC_DP_BATCH) < 0.8))
        st_d = tree_map(lambda x: x.to(dev), st_c)
        batch_d = tuple(x.to(dev) for x in batch_c)
        ms_s, (sa, la) = _fenced_ms(lambda: sharding.nrc_train_step_dp(
            mesh, st_d, *batch_d, ncfg), 3)
        ms_1, _ = _fenced_ms(lambda: nrc.train_step(st_d, *batch_d, ncfg), 3)
        sb, lb = nrc.train_step(st_c, *batch_c, ncfg)
        diffs = torch.cat([(x.cpu() - y).abs().reshape(-1) for x, y in zip(
            tree_leaves(sa["params"]), tree_leaves(sb["params"]))])
        p_share = float((diffs <= NRC_PARAM_ATOL).float().mean())
        loss_rel = abs(float(la) - float(lb)) / abs(float(lb))
        check(loss_rel <= 1e-4 and p_share >= NRC_PARAM_SHARE,
              f"34 sharded nrc: loss rel {loss_rel}, params within "
              f"{NRC_PARAM_ATOL} on {p_share}")
        rep["nrc"] = {"ms": ms_s, "unsharded_ms": ms_1,
                      "loss_rel_diff": loss_rel, "param_share": p_share,
                      "param_max_abs_err": float(diffs.max())}
        print(f"[34 sharded] nrc_train_step_dp ({NRC_DP_BATCH} records) on "
              f"the card against train_step on the CPU: loss rel diff "
              f"{loss_rel:.3g} (bar 1e-4), params within {NRC_PARAM_ATOL} on"
              f" {p_share:.5f} (bar {NRC_PARAM_SHARE}); {ms_s:.2f} ms against"
              f" {ms_1:.2f} ms for train_step on the card", flush=True)
    finally:
        dist.destroy_process_group()
    report["sharded"] = rep


def _live_app(dev):
    """The path_tracing app at LIVE_RES^2 with -live 0: an orbit and a pick
    POSTed to the viewer before its first frame, the pick read back over
    localhost. Returns (image, pick info, frames shown)."""
    import urllib.request

    from gfxexp_torch.apps import path_tracing
    from gfxexp_torch.utils import viewer as viewer_mod

    state = {}
    orig = viewer_mod.LiveViewer.__init__

    def post(port, ev):
        req = urllib.request.Request(f"http://localhost:{port}/control",
                                     data=json.dumps(ev).encode(),
                                     method="POST")
        return urllib.request.urlopen(req, timeout=10).status

    def patched(self, port=0, **kw):
        orig(self, port=0, **kw)
        state["viewer"] = self
        check(post(self.port, {"action": "orbit", "dx": 60, "dy": 10})
              == 204 and post(self.port, {"action": "pick", "u": 0.5,
                                          "v": 0.6}) == 204,
              "35 live: a POST was refused")

    viewer_mod.LiveViewer.__init__ = patched
    try:
        img = path_tracing.main(
            ["-width", str(LIVE_RES), "-height", str(LIVE_RES), "-frames",
             "4", "-live", "0", "-output",
             os.path.join(REPO, "out", "torch_live")])
    finally:
        viewer_mod.LiveViewer.__init__ = orig
    v = state["viewer"]
    try:
        port = v.port
        with urllib.request.urlopen(f"http://localhost:{port}/pick",
                                    timeout=10) as r:
            pick = json.loads(r.read())
        with urllib.request.urlopen(f"http://localhost:{port}/meta",
                                    timeout=10) as r:
            frames = int(r.read())
    finally:
        v.close()
    return img, pick, frames


def phase_options(report, dev, city):
    """sort_secondary_rays and compact_rays on small at 512x512 and `city`
    flattened (wide rows): bench.measure's 16-sample images equal the
    default's bit for bit, with Mrays/s of each in turns; the path_tracing
    app with -live; a DebugDraw PLY of small's top BVH levels."""
    from gfxexp_torch.accel.bvh_build import build_bvh
    from gfxexp_torch.utils.debug_draw import DebugDraw

    rep = {}
    built = {"small": bench.build_bench_scene("small"), "city": city}
    for which in OPTION_SCENES:
        scene, bvh = (x.to(dev) for x in built[which])
        rows, ref = {}, None
        for name in ("default", "sort_secondary_rays", "compact_rays",
                     "default"):
            kw = {} if name == "default" else {name: True}
            r = bench.measure("512", scene, bvh, device=dev, which=which,
                              cfg=PTConfig(max_path_length=bench
                                           .MAX_PATH_LENGTH,
                                           count_rays=True, **kw))
            _check_bench_row(r, f"35 {which} {name}")
            if ref is None:
                ref = r
            check(torch.equal(r["image"], ref["image"])
                  and r["rays"] == ref["rays"],
                  f"35 {which} {name}: the image differs from the default")
            rows.setdefault(name, []).append(r["value"])
        rep[which] = rows
        print(f"[35 options] {which} 512x512, 16 samples: images equal bit "
              f"for bit; Mrays/s " + ", ".join(
                  f"{k} {v}" for k, v in rows.items()), flush=True)
        built[which] = None
    img, pick, frames = _live_app(dev)
    check(np.isfinite(img).all() and img.mean() > 0 and frames == 4
          and "hit" in pick and pick["pixel"] == [LIVE_RES // 2,
                                                  int(0.6 * LIVE_RES)],
          f"35 live: image / pick {pick} / frames {frames}")
    rep["live"] = {"pick": pick, "frames": frames}
    print(f"[35 live] path_tracing -live 0 at {LIVE_RES}x{LIVE_RES}, 4 "
          f"frames, an orbit POSTed: mean pixel {img.mean():.4f}; pick read "
          f"back over localhost: {pick}", flush=True)
    soup = _world_soup("small")
    b, _ = build_bvh(*soup)
    dd = DebugDraw()
    level, depth = [0], 0
    while level and depth < 2:
        nxt = []
        for node in level:
            for k in range(b.arity):
                cnt = int(b.child_count[node, k])
                if cnt < 0:
                    continue
                dd.set_color(*((1, 0, 0), (0, 1, 0))[depth])
                dd.aabb(b.child_min[node, k].numpy(),
                        b.child_max[node, k].numpy())
                if cnt == 0:
                    nxt.append(int(b.child_idx[node, k]))
        level, depth = nxt, depth + 1
    path = dd.save(os.path.join(REPO, "chiprun_out", "small_bvh_top.ply"))
    verts, edges, _ = dd.counts
    check(edges > 0 and edges % 12 == 0, f"35 debug draw: {dd.counts}")
    rep["debug_draw"] = {"boxes": edges // 12, "vertices": verts}
    print(f"[35 debug draw] small's BVH, top 2 levels: {edges // 12} boxes "
          f"in {os.path.relpath(path, REPO)}", flush=True)
    report["options"] = rep


IMAGE_DIR = os.path.join(REPO, "tests", "torch_images")
# phase 36's image files in place of the textured scene's PNG and DDS files
IMAGE_TEXTURES = {"normal": "normal_64_rgb16_adam7.png",
                  "bc1": "photo_512_progressive420.jpg",
                  "bc7": "albedo_64_rle.tga"}
IMAGE_TIMED = "photo_512_progressive420.jpg"
# the same file cut after its first AC scan: libjpeg's block smoothing
IMAGE_TIMED_SMOOTHED = "photo_512_progressive420_cut2.jpg"
IMAGE_REPS = 5


def phase_images(report, dev):
    """Phase 36: the image decoders where there is no PIL. Every fixture
    decodes to PIL's samples (by digest); the textured scene with JPEG,
    16-bit Adam7 PNG and TGA textures renders on the card as on the CPU
    (kernel 1 launched, counts reset just before); the host's decode time
    of the 512^2 progressive JPEG, whole and cut after its first AC scan
    (block smoothing)."""
    with open(os.path.join(IMAGE_DIR, "digests.json")) as f:
        digests = json.load(f)
    rows = {}
    for name, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_DIR, name), "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        px = decode_samples(data, name)
        ms = (time.perf_counter() - t0) * 1e3
        digest = hashlib.sha256(np.ascontiguousarray(px).tobytes()
                                ).hexdigest()
        check(digest == rec["sha256"] and str(px.dtype) == rec["dtype"]
              and list(px.shape) == rec["shape"],
              f"36 images {name}: {px.dtype} {list(px.shape)} digest "
              f"{digest[:16]} vs PIL's {rec['dtype']} {rec['shape']} "
              f"{rec['sha256'][:16]}")
        rows[name] = {"ms": ms, "dtype": str(px.dtype),
                      "shape": list(px.shape)}
        print(f"[36 images {name}] {px.dtype} {list(px.shape)}, digest "
              f"equal to PIL's, decoded in {ms:.1f} ms", flush=True)
    for key, name in (("timed", IMAGE_TIMED),
                      ("timed_smoothed", IMAGE_TIMED_SMOOTHED)):
        with open(os.path.join(IMAGE_DIR, name), "rb") as f:
            data = f.read()
        times = []
        for _ in range(IMAGE_REPS):
            # a cold decode: no Huffman table kept from the rep before
            jpeg_decoder._huffman_lookup.cache_clear()
            t0 = time.perf_counter()
            px = decode_samples(data, name)
            times.append(time.perf_counter() - t0)
        mpix = px.shape[0] * px.shape[1] / 1e6
        best = min(times) * 1e3
        rows[key] = {"file": name, "best_ms": best,
                     "median_ms": float(np.median(times)) * 1e3,
                     "ms_per_megapixel": best / mpix,
                     "host_cores": os.cpu_count()}
        print(f"[36 images decode{' smoothed' * (key != 'timed')}] {name} "
              f"({len(data)} bytes, {px.shape[1]}x{px.shape[0]}): best "
              f"{best:.1f} ms, median {rows[key]['median_ms']:.1f} ms of "
              f"{IMAGE_REPS} on the host ({os.cpu_count()} cores): "
              f"{best / mpix:.1f} ms per megapixel", flush=True)
    files = {k: os.path.join(IMAGE_DIR, v) for k, v in IMAGE_TEXTURES.items()}
    t0 = time.time()
    s, b = bench.build_textured_scene(os.path.join(_tex_dir(), "images"),
                                      traversal="widerow", files=files)
    build_s = time.time() - t0
    cam = bench.textured_camera(TEX_RES, TEX_RES)
    cfg = PTConfig(max_path_length=bench.MAX_PATH_LENGTH, count_rays=True)
    sd, bd = s.to(dev), b.to(dev)
    _reset_counts()
    a, ra = _tex_render(sd, bd, cam.to(dev), TEX_RES, TEX_SAMPLES, cfg, 0)
    torch.cuda.synchronize()
    counts = _all_counts()
    c, rc = _tex_render(s, b, cam, TEX_RES, TEX_SAMPLES, cfg, 0)
    rel = _rel(a, c)
    check(_route_launched(counts, "widerow"),
          f"36 images render: kernel 1 not launched: {counts}")
    check(np.isfinite(a).all() and a.mean() > 0,
          "36 images render: non-finite or black image")
    check(rel < IMAGE_BAR and ra == rc,
          f"36 images render: image rel diff {rel}, rays {ra} vs {rc}")
    launches = {k: v for k, v in counts["kernel1"].items() if v}
    rows["render"] = {"image_rel_diff": rel, "rays": ra,
                      "launches": launches, "host_build_s": build_s,
                      "textures": IMAGE_TEXTURES}
    print(f"[36 images render] textured scene with {IMAGE_TEXTURES}, "
          f"{TEX_RES}x{TEX_RES}, {TEX_SAMPLES} samples, wide rows: card vs "
          f"CPU image rel diff {rel:.3g} (bar {IMAGE_BAR}), rays {ra:.0f} "
          f"equal, kernel 1 launches {launches}, host build {build_s:.2f}s",
          flush=True)
    save_png(os.path.join(REPO, "out", "torch_textured_images.png"),
             a.reshape(TEX_RES, TEX_RES, 3) / (1.0 + a.reshape(
                 TEX_RES, TEX_RES, 3)))
    report["images"] = rows


# phase 37: the core toolkit at full width
CORE_RES = (1920, 1080)  # generate_rays
CORE_ALIAS_N = 1 << 20  # alias table entries (built on the host)
CORE_DISCRETE_N = 1 << 16  # discrete distribution entries (built on the card)
CORE_SAMPLES = 1 << 22  # uniforms sampled, normals round-tripped
# the card's CDF against the CPU's: both accumulate in float64 and round
# once, but the card's scan associates each prefix its own way, so a prefix
# and the total it is divided by may each round the other way
CORE_CDF_ULPS = 4
CORE_REPS = 10


def _ulps(a, b):
    """Distance in float32 ulps of same-signed values [N] (bit patterns)."""
    return (a.contiguous().view(torch.int32).to(torch.int64)
            - b.contiguous().view(torch.int32).to(torch.int64)).abs()


def phase_core(report, dev):
    """Phase 37: the core toolkit (core/math.py, core/distributions.py,
    core/rng.py, render/camera.py) on the card against the CPU, at full
    width: generate_rays at 1920x1080; an alias table over 2^20 weights
    (host build) sampled with 2^22 uniforms, indices equal bit for bit; a
    discrete distribution over 2^16 weights built on the card, its CDF
    within CORE_CDF_ULPS of the CPU's and its 2^22 sampled indices equal
    off the edges (the rest counted; the faults of a float32 scan
    printed beside them); octahedral round trips of 2^22
    normals; power_heuristic, simple_tonemap, srgb_to_linear. Device ms
    per call from CUDA events, the card spinning while the host
    enqueues."""
    from gfxexp_torch.core import distributions as dist
    from gfxexp_torch.core import math as cm
    from gfxexp_torch.core.rng import uniform4
    from gfxexp_torch.render.camera import generate_rays

    t_phase = time.time()
    cpu = torch.device("cpu")
    r = np.random.default_rng(SEED)
    rep, ms = {}, {}

    def both(fn, *host):
        """fn on the card and on the CPU, the card's result on the host."""
        out = fn(*(x.to(dev) for x in host))
        ref = fn(*host)
        if isinstance(out, tuple):
            return tuple(o.cpu() for o in out), ref
        return out.cpu(), ref

    def timed(name, fn, *host):
        args = [x.to(dev) for x in host]
        ms[name] = _device_and_host_ms(lambda: fn(*args), CORE_REPS)[0]

    # primary rays: origins bit for bit, directions within 1e-6 (tan)
    w, h = CORE_RES
    cam = bench.bench_camera(w, h)
    jx, jy = (torch.from_numpy(x) for x in
              r.random((2, w * h), dtype=np.float32))
    (go, gd), (ro, rd) = both(lambda c, a, b: generate_rays(c, w, h, a, b),
                              cam, jx, jy)
    ray_err = float((gd - rd).abs().max())
    check(torch.equal(go, ro) and ray_err <= 1e-6
          and bool(torch.isfinite(gd).all()),
          f"37 core generate_rays: direction err {ray_err}")
    timed("generate_rays", lambda c, a, b: generate_rays(c, w, h, a, b),
          cam, jx, jy)

    u = uniform4(torch.arange(CORE_SAMPLES), SEED, 37, 0)[0]
    # the alias table: host build, samples bit for bit
    wa = r.random(CORE_ALIAS_N)
    wa[r.random(CORE_ALIAS_N) < 0.1] = 0.0
    t0 = time.perf_counter()
    table = dist.build_alias_table(wa)
    alias_build_s = time.perf_counter() - t0
    (gi, gp), (ri, rp) = both(lambda t, x: dist.sample_alias(t, x),
                              table, u)
    check(torch.equal(gi, ri) and torch.equal(gp, rp),
          f"37 core sample_alias: {int((gi != ri).sum())} indices differ")
    timed("sample_alias", dist.sample_alias, table, u)

    # the discrete distribution, built on each device
    wd = torch.from_numpy(r.random(CORE_DISCRETE_N).astype(np.float32))
    wd[torch.from_numpy(r.random(CORE_DISCRETE_N) < 0.1)] = 0.0
    gdist, rdist = dist.build_discrete_1d(wd.to(dev)), dist.build_discrete_1d(
        wd)
    gcdf = gdist.cdf.cpu()
    cdf_ulps = int(_ulps(gcdf, rdist.cdf).max())
    check(cdf_ulps <= CORE_CDF_ULPS,
          f"37 core build_discrete_1d: cdf {cdf_ulps} ulps from the CPU's")
    gi = dist.sample_discrete_1d(gdist, u.to(dev))[0].cpu()
    ri = dist.sample_discrete_1d(rdist, u)[0]
    # u can pick otherwise only where it lies between the two CDFs' values
    # of an edge: within their largest difference of the CPU's edges; the
    # share that does is about the mass between the two CDFs
    cdf, window = rdist.cdf, max(cdf_ulps, 1)
    edge = torch.minimum(_ulps(u, cdf[ri]), _ulps(u, cdf[ri + 1])) <= window
    differ = gi != ri
    n_differ, n_edge = int(differ.sum()), int(edge.sum())
    mass = float((gcdf.double() - cdf.double()).abs().sum())
    check(not bool((differ & ~edge).any())
          and n_differ <= 2 * mass * len(u) + 16
          and bool((wd[gi] > 0).all()),
          f"37 core sample_discrete_1d: {n_differ} indices differ "
          f"(mass between the CDFs {mass:.3g}), "
          f"{int((differ & ~edge).sum())} off the edges")
    # why the CDF is accumulated in float64: the card's float32 scan of the
    # same pmf steps down, and gives empty items a bin
    scan32 = torch.cumsum(gdist.pmf, dim=0)
    steps_down = int((scan32[1:] < scan32[:-1]).sum())
    empty_binned = int(((gdist.pmf[1:] == 0) & (scan32[1:] > scan32[:-1])
                        ).sum())
    timed("build_discrete_1d", dist.build_discrete_1d, wd)
    timed("sample_discrete_1d", dist.sample_discrete_1d, gdist, u)

    # octahedral normals: encode bit for bit, decode within 4 ulps (sqrt)
    v = torch.from_numpy(r.normal(size=(CORE_SAMPLES, 3)).astype(np.float32))
    n = cm.normalize(v)
    (ge, re_), (gn, rn) = (both(cm.octahedral_encode, n),
                           both(lambda x: cm.octahedral_decode(
                               cm.octahedral_encode(x)), n))
    oct_ulps = int(_ulps(gn.flatten(), rn.flatten()).max())
    oct_err = float((gn - n).abs().max())
    check(torch.equal(ge, re_) and oct_ulps <= 4 and oct_err < 1e-5,
          f"37 core octahedral: decode {oct_ulps} ulps from the CPU, round "
          f"trip err {oct_err}")
    timed("octahedral_round_trip",
          lambda x: cm.octahedral_decode(cm.octahedral_encode(x)), n)

    # MIS and colour: power_heuristic and simple_tonemap bit for bit,
    # srgb_to_linear within 8 ulps (pow)
    pa, pb = (torch.from_numpy(x) for x in
              r.random((2, CORE_SAMPLES), dtype=np.float32))
    pa[:4], pb[:2] = 0.0, 0.0
    gm, rm = both(cm.power_heuristic, pa, pb)
    col = torch.from_numpy((r.random((CORE_SAMPLES, 3)) * 4.0).astype(
        np.float32))
    gt, rt = both(cm.simple_tonemap, col)
    gs, rs = both(cm.srgb_to_linear, pa)
    srgb_ulps = int(_ulps(gs, rs).max())
    check(torch.equal(gm, rm) and torch.equal(gt, rt) and srgb_ulps <= 8,
          f"37 core colour: power_heuristic {torch.equal(gm, rm)}, "
          f"simple_tonemap {torch.equal(gt, rt)}, srgb {srgb_ulps} ulps")
    timed("power_heuristic", cm.power_heuristic, pa, pb)
    timed("simple_tonemap", cm.simple_tonemap, col)
    timed("srgb_to_linear", cm.srgb_to_linear, pa)

    rep.update(direction_max_abs=ray_err, alias_host_build_s=alias_build_s,
               cdf_max_ulps=cdf_ulps, discrete_differ=n_differ,
               discrete_near_edge=n_edge, cdf_mass_between=mass,
               float32_scan_steps_down=steps_down,
               float32_scan_empty_items_binned=empty_binned, octahedral_decode_max_ulps=oct_ulps,
               octahedral_round_trip_max_abs=oct_err,
               srgb_max_ulps=srgb_ulps, device_ms=ms,
               seconds=time.time() - t_phase)
    report["core"] = rep
    print(f"[37 core] {w}x{h} rays (dir err {ray_err:.3g}), alias "
          f"{CORE_ALIAS_N} (host build {alias_build_s:.2f} s) x "
          f"{CORE_SAMPLES} samples equal, discrete {CORE_DISCRETE_N} cdf "
          f"{cdf_ulps} ulps (bound {CORE_CDF_ULPS}), {n_differ} of "
          f"{CORE_SAMPLES} indices differ ({n_edge} within {window} ulps "
          f"of an edge, none off one; mass between the CDFs {mass:.3g}; a "
          f"float32 scan would step down {steps_down} times and give "
          f"{empty_binned} of {int((wd == 0).sum())} empty items a bin), "
          f"octahedral "
          f"{CORE_SAMPLES} encode equal, decode {oct_ulps} ulps, round trip "
          f"{oct_err:.3g}; power_heuristic, simple_tonemap equal, srgb "
          f"{srgb_ulps} ulps | device ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f" | {rep['seconds']:.1f} s", flush=True)


SHADE_RES = (1920, 1080)  # phase 38
SHADE_BOUNCES = 5
SHADE_REPS = 50
# bytes a lane the shading kernel moves: it reads the hit (t, tri, u, v,
# hit: 17), the ray direction, throughput, contribution and pending NEE
# term (4 x 12), `alive`, `prev_pdf`, the occlusion flag and the pixel
# (10); it writes the next ray, throughput, contribution, shadow direction
# and pending term (6 x 12), the shadow ray's tmax, `alive` and `prev_pdf`
# (9)
SHADE_LANE_BYTES = 17 + 48 + 10 + 72 + 9


def _kernel_device_ms(fn, name, reps):
    """Mean device ms of the CUDA kernels whose name holds `name` over reps
    calls of fn (after a warm call), from torch.profiler: what else fn
    launches is left out. Late in a long run the trace can keep fewer
    kernels than were launched, or none (seen after phase 38 of a full
    run): the mean is over those it kept, and a trace that kept none is
    taken again, three at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and name in e.name]
        if spans:
            break
    check(spans, f"{name}: no kernel in 3 traces of {reps} calls")
    return sum(spans) / len(spans) / 1e3


def phase_shade(report, dev):
    """Phase 38: the shading kernel against its plain version and the
    eager stages at 1920x1080 on the box and lamp (see the header)."""
    from gfxexp_torch.apps.common import default_demo_builder
    from gfxexp_torch.render import pathtrace as tpt
    from gfxexp_torch.render.camera import make_camera
    from gfxexp_torch.scene.compile import compile_scene

    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from reference import compare

    t_phase = time.time()
    w, h = SHADE_RES
    n = w * h
    scene, bvh = (x.to(dev) for x in compile_scene(default_demo_builder(),
                                                   traversal="widerow"))
    cam = make_camera([0.0, 0.0, 1.9], fov_y=1.2, aspect=w / h,
                      target=[0.0, 0.0, -1.0]).to(dev)
    cfg = PTConfig(max_path_length=SHADE_BOUNCES, count_rays=True)
    check(tpt.shade_kernel_admits(scene, cfg), "38: the box is refused")
    rep = {"res": [w, h], "bounces": {}}

    # the kernel shades every bounce; the plain version shades a copy of
    # the same state after the same walks
    s, st = tpt._start(scene, bvh, cam, w, h, 0, n, 3, cfg)
    timed = None
    max_err = 0.0
    for bounce in range(1, SHADE_BOUNCES + 1):
        first, collect = bounce == 1, bounce == SHADE_BOUNCES
        hit, occluded, _ = tpt._trace(s, st, first)
        pst = _shade_lanes_copy(st)
        if bounce == 2:
            timed = (_shade_lanes_copy(st), hit, occluded)
        tpt.shade_bounce(s, st, hit, bounce, first, collect, occluded)
        tpt._shade_bounce_plain(s, pst, hit, bounce, first, collect,
                                occluded)
        torch.cuda.synchronize()
        outs = {"contribution": (st.contribution, pst.contribution),
                "throughput": (st.throughput, pst.throughput),
                "alive": (st.alive, pst.alive),
                "rays_traced": (st.rays_traced, pst.rays_traced)}
        if not collect:
            outs.update(ray_o=(st.ray_o, pst.ray_o),
                        ray_d=(st.ray_d, pst.ray_d),
                        pending=(st.pending[0], pst.pending[0]),
                        shadow_tmax=(st.pending[3], pst.pending[3]))
        same = {}
        for name, (a, b) in outs.items():
            eq = a == b
            same[name] = float((eq.all(-1) if eq.dim() > 1 else eq)
                               .double().mean())
            if a.dtype.is_floating_point:
                check(bool(torch.isfinite(a).all()),
                      f"38 bounce {bounce}: {name} not finite")
        err = float((st.contribution - pst.contribution).abs().max())
        max_err = max(max_err, err)
        off = compare.mismatch_share(st.contribution, pst.contribution)
        check(off <= 1e-4, f"38 bounce {bounce}: {off} of the pixels off")
        rep["bounces"][bounce] = {"bit_identical": same, "pixels_off": off,
                                  "max_abs_err": err}
        print(f"[38 shade bounce {bounce}] bit-identical lanes "
              + ", ".join(f"{k} {v:.6f}" for k, v in same.items())
              + f"; pixels off by over 1e-3: {off:.2e}; largest difference "
              f"in contribution {err:.3g}", flush=True)
    rep["max_abs_err"] = max_err

    # bounce 2's shading, timed: the kernel on a fresh copy of its lanes
    # each call (the profiler keeps its time alone), the plain version on
    # the same inputs
    base, hit, occ = timed
    k_ms = _kernel_device_ms(lambda: tpt.shade_bounce(
        s, _shade_lanes_copy(base), hit, 2, False, False, occ),
        "shade_bounce_kernel", SHADE_REPS)
    p_ms = _device_and_host_ms(lambda: tpt._shade_bounce_plain(
        s, dataclasses.replace(base), hit, 2, False, False, occ), 3)[0]
    tables = sum(x.numel() * x.element_size() for x in (
        s.tri_packed, s.light_packed, scene.materials.diffuse_color,
        scene.materials.specular_f0, scene.materials.emittance))
    bound_ms, bound_by = bound(n * SHADE_LANE_BYTES + tables, 0)
    regs = _ptxas("shade_bounce")
    rep.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
               lane_bytes=SHADE_LANE_BYTES, ptxas=regs,
               roofline=bound_ms / k_ms)
    print(f"[38 shade kernel] bounce 2 at {w}x{h}: {k_ms:.4f} ms, plain "
          f"version {p_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{SHADE_LANE_BYTES} B a lane): {100 * bound_ms / k_ms:.1f}% of "
          f"it; ptxas: {' | '.join(regs)}", flush=True)

    # render_sample: kernel route against the eager stages
    def render(sample):
        return tpt.render_sample(scene, bvh, cam, w, h, sample, cfg)

    rows = {}
    for route in ("kernel", "eager", "eager", "kernel"):
        with _shade_route(route):
            trace.reset_counters("pathtrace.shade")
            img, rays = render(1)
            counted = trace.counters("pathtrace.shade")
            prof = _profile(render)
        rows.setdefault(route, []).append(
            {"counters": counted, "rays": float(rays), **prof})
        rows[route + "_img"] = img
        print(f"[38 shade render {route}] {w}x{h} render_sample: "
              f"{prof['wall_ms']:.2f} ms, {prof['kernels']} CUDA kernels "
              f"({prof.get('device_busy_ms', float('nan')):.2f} ms busy), "
              f"{prof['launch_calls']} launch calls (idle share "
              f"{prof.get('idle_share', float('nan')):.3f}), counters "
              f"{counted}", flush=True)
    check(all(r["counters"] == {"pathtrace.shade.kernel": SHADE_BOUNCES}
              for r in rows["kernel"]), f"38 counters: {rows['kernel']}")
    check(all(r["counters"] == {"pathtrace.shade.eager": SHADE_BOUNCES}
              for r in rows["eager"]), f"38 counters: {rows['eager']}")
    check(rows["kernel"][0]["rays"] == rows["eager"][0]["rays"],
          f"38 rays {rows['kernel'][0]['rays']} {rows['eager'][0]['rays']}")
    off = compare.mismatch_share(rows.pop("kernel_img"),
                                 rows.pop("eager_img"))
    check(off <= 1e-4, f"38 render: {off} of the pixels off")
    rep["render"] = rows
    rep["render_pixels_off"] = off
    rep["seconds"] = time.time() - t_phase
    report["shade"] = rep
    print(f"[38 shade] render_sample images: {off:.2e} of the pixels off "
          f"by over 1e-3; phase {rep['seconds']:.1f}s", flush=True)
    return rep


@contextlib.contextmanager
def _shade_route(route):
    """Within it render_lanes shades by the kernel where its predicate
    admits the call ("kernel") or by the eager stages everywhere
    ("eager")."""
    from gfxexp_torch.render import pathtrace as tpt

    admits = tpt.shade_kernel_admits
    if route == "eager":
        tpt.shade_kernel_admits = lambda *a: False
    try:
        yield
    finally:
        tpt.shade_kernel_admits = admits


def _shade_lanes_copy(st):
    """A copy of render_lanes' lane state, every tensor copied (the pending
    term and the shading kernel's buffers too)."""
    pending = (None if st.pending is None
               else tuple(x.clone() for x in st.pending))
    buffers = (None if st.buffers is None
               else {k: None if x is None else x.clone()
                     for k, x in st.buffers.items()})
    return dataclasses.replace(
        st, ray_o=st.ray_o.clone(), ray_d=st.ray_d.clone(),
        throughput=st.throughput.clone(), alive=st.alive.clone(),
        prev_pdf=st.prev_pdf.clone(), contribution=st.contribution.clone(),
        rays_traced=st.rays_traced.clone(), pending=pending, buffers=buffers)


RESTIR_KERNEL_REPS = 50  # phase 39
# bytes a pixel the resampling kernels move, each input and output once:
# a pixel's context (position, v_out_local, the frame t, b, n, diffuse and
# f0: 7 x 12; roughness 4; the Lambert and valid flags 2) and a reservoir
# (position, normal, emittance 3 x 12; at_inf 1; sum_w, stream length,
# rec_pdf, target 4 x 4). The initial kernel reads the context and writes
# a reservoir and the shadow ray (12 + 4), and reads the pool once (41 B an
# entry); a spatial pass reads the context, the camera distance (4), the
# reservoirs and the G-buffer's hit, position and normal (25), and writes
# reservoirs.
RESTIR_CTX_BYTES = 7 * 12 + 4 + 2
RESTIR_RES_BYTES = 3 * 12 + 1 + 4 * 4
RESTIR_INITIAL_BYTES = RESTIR_CTX_BYTES + RESTIR_RES_BYTES + 16
RESTIR_SPATIAL_BYTES = RESTIR_CTX_BYTES + 4 + 25 + 2 * RESTIR_RES_BYTES
RESTIR_POOL_ENTRY_BYTES = 3 * 12 + 1 + 4


@contextlib.contextmanager
def _restir_route(route):
    """Within it restir_di_frame runs its stages by the kernels where its
    predicate admits them ("kernel") or by the plain versions everywhere
    ("plain")."""
    from gfxexp_torch.techniques import restir_di

    admits = restir_di.restir_kernel_admits
    if route == "plain":
        restir_di.restir_kernel_admits = lambda *a: (False, False)
    try:
        yield
    finally:
        restir_di.restir_kernel_admits = admits


def phase_restir_kernels(report, dev):
    """Phase 39: ReSTIR DI's resampling kernels against their plain
    versions at 1920x1080 on phase 21's scene (see the header)."""
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.techniques import restir_di as R

    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from reference import compare

    t_phase = time.time()
    w, h = TECH_W, TECH_H
    n = w * h
    scene, bvh = (x.to(dev) for x in _many_light_scene())
    cam = _ml_camera(w, h).to(dev)
    cfg = R.ReSTIRConfig(use_rearchitected_pipeline=True)
    check(R.restir_kernel_admits(cfg, cam.position) == (True, True),
          "39: the kernels refuse the benchmark's configuration")
    frame = 3
    gb = render_gbuffer(scene, bvh, cam, cam, w, h, frame, True)
    ctx = R.pixel_ctx(scene, gb, cam)
    pool = R.presample_lights(scene, frame, cfg)
    pixel = torch.arange(n, device=dev)
    rep = {"res": [w, h]}

    def against(tag, k, p):
        same = {}
        identical = torch.ones(n, dtype=torch.bool, device=dev)
        err = 0.0
        for f in dataclasses.fields(k):
            a, b = getattr(k, f.name), getattr(p, f.name)
            eq = a == b
            eq = eq.all(-1) if eq.dim() > 1 else eq
            identical &= eq
            same[f.name] = float(eq.double().mean())
            if a.dtype.is_floating_point:
                check(bool(torch.isfinite(a).all()),
                      f"39 {tag}: {f.name} not finite")
                err = max(err, float((a - b).abs().max()))
        names = [f.name for f in dataclasses.fields(k)]
        off = compare.share(compare.fields_mismatch(
            {x: getattr(k, x).float() for x in names},
            {x: getattr(p, x).float() for x in names}))
        share = float(identical.double().mean())
        check(share >= 1.0 - 1e-4 and off <= 1e-4,
              f"39 {tag}: {share} of the pixels bit-identical, {off} off")
        print(f"[39 restir {tag}] bit-identical pixels "
              + ", ".join(f"{k_} {v:.6f}" for k_, v in same.items())
              + f"; all fields {share:.6f}; pixels off by over 1e-3: "
              f"{off:.2e}; largest difference {err:.3g}", flush=True)
        return {"bit_identical": same, "pixels_identical": share,
                "pixels_off": off, "max_abs_err": err}

    # each stage by the kernel and by the plain version on the same inputs
    k = R.initial_ris_kernel(scene, bvh, ctx, pool, gb, frame, cfg)
    p = R.initial_ris_presampled(scene, bvh, ctx, pool, gb, pixel, frame,
                                 cfg)
    torch.cuda.synchronize()
    stages = {"initial": against("initial", k, p)}
    res = {"initial": p}
    for pass_idx in range(cfg.num_spatial_passes):
        prev = p
        k = R.spatial_reuse_kernel(prev, ctx, gb, cam, frame, pass_idx, cfg)
        p = R.spatial_reuse(scene, bvh, prev, ctx, gb, cam, pixel, frame,
                            pass_idx, cfg)
        torch.cuda.synchronize()
        stages[f"spatial{pass_idx}"] = against(f"spatial{pass_idx}", k, p)
        res[f"spatial{pass_idx}"] = prev
    rep["stages"] = stages

    # each kernel's device time (the profiler keeps it alone), the plain
    # version's on the same inputs, and the bound
    regs = _ptxas("restir_resample")
    pool_bytes = pool["pos"].shape[0] * RESTIR_POOL_ENTRY_BYTES
    timed = {
        "initial": (
            lambda: R.initial_ris_kernel(scene, bvh, ctx, pool, gb, frame,
                                         cfg),
            lambda: R.initial_ris_presampled(scene, bvh, ctx, pool, gb,
                                             pixel, frame, cfg),
            "restir_initial_kernel", n * RESTIR_INITIAL_BYTES + pool_bytes),
        "spatial": (
            lambda: R.spatial_reuse_kernel(res["spatial1"], ctx, gb, cam,
                                           frame, 1, cfg),
            lambda: R.spatial_reuse(scene, bvh, res["spatial1"], ctx, gb,
                                    cam, pixel, frame, 1, cfg),
            "restir_spatial_kernel", n * RESTIR_SPATIAL_BYTES)}
    for name, (kern, plain, kname, nbytes) in timed.items():
        k_ms = _kernel_device_ms(kern, kname, RESTIR_KERNEL_REPS)
        p_ms = _device_and_host_ms(plain, 3)[0]
        bound_ms, bound_by = bound(nbytes, 0)
        rep[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes,
                     "roofline": bound_ms / k_ms}
        print(f"[39 restir {name} kernel] at {w}x{h}: {k_ms:.4f} ms, plain "
              f"version {p_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{nbytes / n:.1f} B a pixel): {100 * bound_ms / k_ms:.1f}% "
              f"of it", flush=True)
    rep["ptxas"] = regs
    print(f"[39 restir kernels] ptxas: {' | '.join(regs)}", flush=True)

    # restir_di_frame by the kernel route and by the plain versions, each
    # from the same state
    flat = (gb.hit.reshape(n), gb.position.reshape(n, 3),
            gb.normal.reshape(n, 3))
    state = (res["spatial1"], ctx)

    def frame_fn(_):
        return R.restir_di_frame(scene, bvh, gb, cam, *state, *flat,
                                 frame + 1, cfg)

    rows = {}
    for route in ("kernel", "plain", "plain", "kernel"):
        with _restir_route(route):
            trace.reset_counters("restir.")
            img = frame_fn(0)[0]
            torch.cuda.synchronize()
            counted = trace.counters("restir.")
            prof = _profile(frame_fn)
        rows.setdefault(route, []).append({"counters": counted, **prof})
        rows[route + "_img"] = img.reshape(n, 3)
        print(f"[39 restir frame {route}] {w}x{h} restir_di_frame: "
              f"{prof['wall_ms']:.2f} ms, {prof['kernels']} CUDA kernels "
              f"({prof.get('device_busy_ms', float('nan')):.2f} ms busy), "
              f"{prof['launch_calls']} launch calls (idle share "
              f"{prof.get('idle_share', float('nan')):.3f}), counters "
              f"{counted}", flush=True)
    passes = cfg.num_spatial_passes
    check(all(r["counters"] == {"restir.kernel.initial": 1,
                                "restir.kernel.spatial": passes}
              for r in rows["kernel"]), f"39 counters: {rows['kernel']}")
    check(all(r["counters"] == {"restir.eager.initial": 1,
                                "restir.eager.spatial": passes}
              for r in rows["plain"]), f"39 counters: {rows['plain']}")
    kimg, pimg = rows.pop("kernel_img"), rows.pop("plain_img")
    off = compare.mismatch_share(kimg, pimg)
    same = float((kimg == pimg).all(-1).double().mean())
    check(off <= 1e-4 and same >= 1.0 - 1e-4,
          f"39 frame: {off} of the pixels off, {same} bit-identical")
    rep["frame"] = rows
    rep["frame_pixels_off"] = off
    rep["frame_pixels_identical"] = same
    rep["max_abs_err"] = max(s["max_abs_err"] for s in stages.values())
    rep["seconds"] = time.time() - t_phase
    report["restir_kernels"] = rep
    print(f"[39 restir] restir_di_frame images: {same:.6f} of the pixels "
          f"bit-identical, {off:.2e} off by over 1e-3; phase "
          f"{rep['seconds']:.1f}s", flush=True)
    return rep


def mark(report, t_start, phase):
    """Seconds since the start at the end of `phase`, kept and printed."""
    secs = time.time() - t_start
    report.setdefault("phase_end_seconds", {})[phase] = secs
    print(f"[time] phase {phase} done at {secs:.1f}s", flush=True)


def main():
    t_start = time.time()
    report = {}
    phase_environment(report)
    dev = torch.device("cuda", 0)
    # the CLIs this script starts build into, and find, the same libraries
    report["build_dir"] = enable_compile_cache()
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
    mark(report, t_start, "3")
    phase_slice(report, scene, bvh, dev)
    launches = phase_main(report, scene, bvh, dev)
    mark(report, t_start, "5")
    built, worlds = phase_inst_build(report)
    built = {k: (s.to(dev), a.to(dev)) for k, (s, a) in built.items()}
    inst = phase_inst_kernels(report, built, worlds, dev)
    mark(report, t_start, "7")
    phase_inst_slice(report, built, dev)
    inst_launches = phase_inst_main(report, built, dev)
    mark(report, t_start, "9")
    skip_built = {k: (s.to(dev), b.to(dev))
                  for k, (s, b) in phase_skip_build(report).items()}
    skip = phase_skip_kernels(report, skip_built, dev)
    mark(report, t_start, "11")
    phase_skip_slice(report, skip_built, dev)
    skip_launches = phase_anim_main(report, skip_built, dev)
    mark(report, t_start, "13")
    phase_app_cli(report)
    built = skip_built = None  # free the card for the flattened tables
    mark(report, t_start, "14")
    sl_host = phase_sl_build(report)
    sl_built = {k: (s.to(dev), b.to(dev)) for k, (s, b) in sl_host.items()}
    city_host = sl_host["city_widerow"]  # phase 35 renders it again
    sl_host = None
    mark(report, t_start, "15")
    sl = phase_sl_kernels(report, sl_built, bvh, dev)
    mark(report, t_start, "16")
    phase_sl_slice(report, sl_built, dev)
    mark(report, t_start, "17")
    sl_launches = phase_sl_main(report, sl_built, (scene, bvh), dev)
    mark(report, t_start, "18")
    sl_built = None  # free the card for the techniques' frames
    phase_gbuffer(report, dev)
    mark(report, t_start, "19")
    phase_svgf(report, dev)
    mark(report, t_start, "20")
    phase_restir(report, dev)
    mark(report, t_start, "21")
    phase_regir(report, dev)
    mark(report, t_start, "22")
    phase_nrc(report, dev)
    mark(report, t_start, "23")
    phase_technique_clis(report)
    mark(report, t_start, "24")
    phase_textures(report, dev)
    mark(report, t_start, "25")
    phase_texture_costs(report, dev)
    mark(report, t_start, "26")
    phase_texture_clis(report, dev)
    mark(report, t_start, "27")
    cli = phase_tfdm(report, dev)
    mark(report, t_start, "28")
    phase_tfdm_costs(report, dev, cli)
    mark(report, t_start, "29")
    clis = phase_nrtdsm(report, dev)
    mark(report, t_start, "30")
    phase_nrtdsm_costs(report, dev, clis)
    mark(report, t_start, "31")
    phase_sbvh(report, dev)
    mark(report, t_start, "32")
    phase_wide(report, dev)
    mark(report, t_start, "33")
    phase_sharded(report, dev)
    mark(report, t_start, "34")
    phase_options(report, dev, city_host)
    city_host = None
    mark(report, t_start, "35")
    phase_images(report, dev)
    mark(report, t_start, "36")
    phase_core(report, dev)
    mark(report, t_start, "37")
    shade = phase_shade(report, dev)
    mark(report, t_start, "38")
    restir_k = phase_restir_kernels(report, dev)
    mark(report, t_start, "39")

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
    times = skip["city_frame0"]["times"]
    for kind in ("closest", "any"):
        for scope in SCOPES:
            key = f"{kind}_{scope}"
            t = times[key]
            kernels.append({
                "name": f"skiplink_walk_{key}", "route": "cuda",
                "source": "gfxexp_torch/csrc/skiplink_traverse.cu",
                "replaces": REPLACES[scope],
                "launches": skip_launches[key],
                "max_abs_err": max(r["max_abs_err"][key]
                                   for r in skip.values()),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None})
    for fmt, name, src, route in (
            ("widerow", "chunked_walk", "chunked_traverse", "chunked"),
            ("qrow", "qrow_walk", "qrow_traverse", "qrow")):
        for kind in ("closest", "any"):
            t = sl[f"city_{fmt}"]["times"][kind]
            kernels.append({
                "name": f"{name}_{kind}", "route": "cuda",
                "source": f"gfxexp_torch/csrc/{src}.cu",
                "replaces": REPLACES[route],
                "launches": sl_launches[route][kind],
                "max_abs_err": max(sl[f"{w}_{fmt}"]["max_abs_err"][kind]
                                   for w in SL_SCENES),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None})
    lg = sl["lanegroup_small"]
    for g in lanegroup.GROUPS:
        t = lg[f"g{g}"]
        kernels.append({
            "name": f"lanegroup_walk_g{g}", "route": "cuda",
            "source": "gfxexp_torch/csrc/lanegroup_traverse.cu",
            "replaces": REPLACES["lanegroup"],
            "launches": sl_launches["lanegroup"][g],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    kernels.append({
        "name": "shade_bounce_kernel", "route": "cuda",
        "source": "gfxexp_torch/csrc/shade_bounce.cu",
        "replaces": None,  # the JAX integrator is plain jnp
        "launches": shade["render"]["kernel"][0]["counters"][
            "pathtrace.shade.kernel"],
        "max_abs_err": shade["max_abs_err"], "ms": shade["ms"],
        "plain_ms": shade["plain_ms"], "bound_ms": shade["bound_ms"],
        "bound_by": shade["bound_by"], "library_ms": None})
    for stage, passes in (("initial", 1), ("spatial", 2)):
        t = restir_k[stage]
        kernels.append({
            "name": f"restir_{stage}_kernel", "route": "cuda",
            "source": "gfxexp_torch/csrc/restir_resample.cu",
            "replaces": None,  # the JAX technique is plain jnp
            "launches": restir_k["frame"]["kernel"][0]["counters"][
                f"restir.kernel.{stage}"],
            "max_abs_err": max(s["max_abs_err"] for k, s in
                               restir_k["stages"].items()
                               if k.startswith(stage)),
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
