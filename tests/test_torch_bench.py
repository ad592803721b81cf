"""The port's bench path on the CPU: the bench scene (diffuse-specular and
Lambert spheres under an area light) renders as gfxexp_tpu renders it, the
1080p-style tiled frame equals one accumulated frame, and the timing entry
point refuses to measure without a CUDA device."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch import bench  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.render.camera import make_camera as j_camera  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(2)
RES = 32


def test_bench_scene_render_matches_jax():
    """bench.py's integrator settings (max path length 5, ray counts) on
    its scene and camera; JAX traces with its default skip traversal."""
    js, jb = jcompile(bench.bench_scene_builder(JB.SceneBuilder()))
    jc = j_camera([0.0, 0.8, 1.6], fov_y=np.deg2rad(45), aspect=1.0,
                  target=[0.0, 0.2, 0.0])
    ts, tb = bench.build_bench_scene()
    tc = bench.bench_camera(RES, RES)
    for s in (0, 1):
        jimg, jnr = jpt.render_sample(
            js, jb, jc, RES, RES, jnp.uint32(s),
            jpt.PTConfig(max_path_length=bench.MAX_PATH_LENGTH,
                         count_rays=True))
        img, nr = tpt.render_sample(
            ts, tb, tc, RES, RES, s,
            tpt.PTConfig(max_path_length=bench.MAX_PATH_LENGTH,
                         count_rays=True))
        assert S.image_rel_diff(img.numpy(), np.asarray(jimg)) < 5e-3
        assert abs(float(nr) - float(jnr)) <= 5e-3 * float(jnr)


def test_tiled_frame_equals_accumulated_frame():
    """render_frame's tile path (the 1080p one: HD_TILES lane tiles in raw
    row-major order) gives render_accumulate's mean image and ray count."""
    w, h = 48, 24  # not block-divisible: raw lane order, as at 1080p
    ts, tb = bench.build_bench_scene()
    tc = bench.bench_camera(w, h)
    cfg = tpt.PTConfig(max_path_length=3, count_rays=True)
    img, rays = bench.render_frame(ts, tb, tc, w, h, 7, 2, cfg)
    ref, ref_rays = tpt.render_accumulate(ts, tb, tc, w, h, 7, 2, cfg)
    assert torch.allclose(img, ref, atol=1e-6)
    assert float(rays) == float(ref_rays)


def test_measure_needs_cuda():
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure("512", device="cpu")
