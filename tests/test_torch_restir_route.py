"""Which route restir_di_frame takes for its initial candidate stream and
its spatial passes (restir_di.restir_kernel_admits: the CUDA kernels of
csrc/restir_resample.cu, or the plain versions), and the plain route on
the CPU: the frames bit for bit as before the kernels came, no stage
counted on the CPU, and the host-side arithmetic the kernels are handed
(the neighbours' offsets, the kernel's shadow rays through the any-hit
walk) equal to the plain version's.

The frames' digests were taken from the code before the kernel route, in a
process with ATEN_CPU_CAPABILITY=default, so that PyTorch's CPU kernels
round alike on every x86 host; the test takes them again the same way."""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
from gfxexp_torch.render.camera import make_camera  # noqa: E402
from gfxexp_torch.render.gbuffer import render_gbuffer  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene  # noqa: E402
from gfxexp_torch.techniques import restir_di as R  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402

W, H = 24, 16
CAM = dict(position=[0.0, 3.0, 4.0], fov_y=np.deg2rad(50), aspect=W / H,
           target=[0.0, 0.0, 0.0])
SMALL = dict(num_light_subsets=8, light_subset_size=64, spatial_radius=6.0)
CONFIGS = {
    "classic": R.ReSTIRConfig(**SMALL),
    "rearch": R.ReSTIRConfig(use_rearchitected_pipeline=True, **SMALL),
    "unbiased": R.ReSTIRConfig(use_rearchitected_pipeline=True,
                               use_unbiased_estimator=True, **SMALL),
    "no_spatial": R.ReSTIRConfig(use_rearchitected_pipeline=True,
                                 enable_spatial_reuse=False, **SMALL),
}
# frame_digests() at the parent of the kernel route, with
# ATEN_CPU_CAPABILITY=default
DIGESTS = {
    "classic":
    "16a0049990e28d1904e1660f24be1aedae7124318dc5f828f1ac3c9e9e8bede2",
    "rearch":
    "e49a2ff12c45e5ca43535b8d75e7c216814f38f50260276655ade7b67c93da57",
    "unbiased":
    "dbab4fa0df78b6d52c19e60b844125fc016727fc5bc2a85d8dd0d3dbb56af953",
    "no_spatial":
    "a8abc84b065566a76db070b2d3aa24a00c3a7d3f0379213e260ad254b2601997",
}

CUDA = types.SimpleNamespace(device=torch.device("cuda"))


def _frames(cfg, frames=3):
    """restir_di_frame's frames 0 .. frames - 1 on the CPU from empty
    state, the camera still: each frame's outputs."""
    scene, bvh = compile_scene(S.many_light_scene(TB, 16, occluders=3))
    cam = make_camera(**CAM)
    n = W * H
    res, vis = R.empty_reservoir(n, "cpu"), R.empty_sample_visibility(n,
                                                                      "cpu")
    gb = render_gbuffer(scene, bvh, cam, cam, W, H, 0, True)
    ctx = R.pixel_ctx(scene, gb, cam)
    out = []
    for f in range(frames):
        prev = (gb.hit.reshape(n), gb.position.reshape(n, 3),
                gb.normal.reshape(n, 3))
        gb = render_gbuffer(scene, bvh, cam, cam, W, H, f, True)
        color, res, ctx, vis = R.restir_di_frame(scene, bvh, gb, cam, res,
                                                 ctx, *prev, f, cfg, vis)
        out.append((color, res, vis))
    return out


def _digest(frames) -> str:
    h = hashlib.sha256()
    for color, res, vis in frames:
        for x in (color, *(getattr(res, f.name) for f in
                           dataclasses.fields(res)),
                  *(getattr(vis, f.name) for f in dataclasses.fields(vis))):
            h.update(x.contiguous().numpy().tobytes())
    return h.hexdigest()


def frame_digests() -> dict:
    """The sha256 of each configuration's frames."""
    torch.set_num_threads(1)
    return {name: _digest(_frames(cfg)) for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("case,expected", [
    ("rearch", (True, True)),
    ("classic", (False, True)),
    ("cpu", (False, False)),
    ("unbiased", (True, False)),
    ("random_disk", (True, False)),
    ("too_many_neighbors", (True, False)),
])
def test_route(case, expected):
    """The rearchitected, biased, low-discrepancy frame on the card takes
    both kernels; each refusing input sends its stage to the plain
    version."""
    cfg = R.ReSTIRConfig(use_rearchitected_pipeline=case != "classic",
                         use_unbiased_estimator=case == "unbiased",
                         use_low_discrepancy_neighbors=case != "random_disk",
                         num_spatial_neighbors=(33 if case ==
                                                "too_many_neighbors" else 3))
    x = torch.zeros(1) if case == "cpu" else CUDA
    assert R.restir_kernel_admits(cfg, x) == expected


def test_frames_match_the_parent():
    """Three frames of each configuration on the CPU, bit for bit as the
    plain code gave them before the kernel route (the digests), in a
    process whose PyTorch kernels round as on every x86 host."""
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default")
    got = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; sys.path.insert(0, 'tests'); "
         "import test_torch_restir_route as t; "
         "print(json.dumps(t.frame_digests()))"],
        env=env, capture_output=True, text=True, check=True, timeout=600)
    assert json.loads(got.stdout.strip().splitlines()[-1]) == DIGESTS


def test_cpu_counts_nothing():
    """On the CPU every stage runs its plain version and no counter of the
    kernel route or of the eager stages moves."""
    trace.reset_counters("restir.")
    frames = _frames(CONFIGS["rearch"], 2)
    assert trace.counters("restir.") == {}
    color = frames[-1][0]
    assert torch.isfinite(color).all() and float(color.mean()) > 0


@pytest.mark.parametrize("radius", [1.0, 6.0, 20.0, 7.3])
def test_kernel_offsets_equal_the_plain_ones(radius):
    """The spatial kernel's neighbour offsets, computed on the host in
    float32, equal spatial_reuse's device arithmetic (a float32 fill times
    the radius) for every entry of the table."""
    cfg = R.ReSTIRConfig(spatial_radius=radius)
    r = np.float32(radius)
    for tbl in range(1024):
        delta = R._SPATIAL_DELTAS[tbl]
        plain = (torch.full((2,), float(delta[0])) * cfg.spatial_radius,
                 torch.full((2,), float(delta[1])) * cfg.spatial_radius)
        assert float(delta[0] * r) == float(plain[0][0])
        assert float(delta[1] * r) == float(plain[1][0])
    assert R._spatial_table_index(3, 1, 2, cfg) == (3 * 6 + 1 * 3 + 2) % 1024


def test_kernel_shadow_rays_equal_the_plain_visibility():
    """The initial kernel hands its shadow rays (direction, t_max -1 on
    the lanes that trace none) to the any-hit walk: with rays computed as
    the kernel computes them, _keep_visible kills the same estimates as
    _finish_ris."""
    cfg = CONFIGS["rearch"]
    scene, bvh = compile_scene(S.many_light_scene(TB, 16, occluders=3))
    cam = make_camera(**CAM)
    gb = render_gbuffer(scene, bvh, cam, cam, W, H, 0, True)
    ctx = R.pixel_ctx(scene, gb, cam)
    pool = R.presample_lights(scene, 0, cfg)
    pixel = torch.arange(W * H)
    plain = R.initial_ris_presampled(scene, bvh, ctx, pool, gb, pixel, 0,
                                     cfg)
    est = R.initial_ris_presampled(scene, bvh, ctx, pool, gb, pixel, 0,
                                   dataclasses.replace(
                                       cfg, reuse_visibility=False))
    sdir, tmax = R._shadow_dir_dist(ctx, est.pos, est.at_inf)
    tmax = torch.where(ctx.valid & (est.target > 0.0), tmax, -1.0)
    kept = R._keep_visible(scene, bvh, ctx, est, cfg, (sdir, tmax))
    assert bool((plain.rec_pdf != est.rec_pdf).any())
    for f in dataclasses.fields(plain):
        assert torch.equal(getattr(kept, f.name), getattr(plain, f.name))
