"""The port's path tracer on two-level (instanced) scenes: against
gfxexp_tpu's instanced render on the same scene, camera and sample indices
(image mean relative difference < 5e-3, ray counts within 0.5%), and against
the port's own flattened wide-row render of the same scene (atol 1e-4, the
bar of tests/test_pathtrace.py's instanced test). This exercises the
two-level walk, world-space surface points through the instance transform,
NEE through the instances' light rows and the implicit-hit MIS pdf.

JAX side: the instanced queries take the static-grid route
(`set_persistent(False)`), whose interpret-mode compile is a few seconds
instead of the persistent kernel's ~25 s; both compute the same function
(tests/test_persistent_inst.py)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch import bench  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera as t_camera  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.lights import (  # noqa: E402
    pack_light_rows,
    sample_surface_light,
    surface_light_pdf,
)
from gfxexp_tpu.accel import pallas_widestack  # noqa: E402
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.render.camera import make_camera as j_camera  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(2)
BAR = 5e-3
RES = 24
SAMPLES = (3, 4)


@pytest.fixture
def jax_static_route(monkeypatch):
    monkeypatch.setattr(pallas_widestack, "PERSISTENT", False)


def _jax_images(js, jacc, jc, cfg):
    out = []
    for s in SAMPLES:
        img, nr = jpt.render_sample(js, jacc, jc, RES, RES, jnp.uint32(s),
                                    cfg)
        out.append((np.asarray(img), float(nr)))
    return out


def _check(ts, tacc, tc, cfg, jimgs):
    for s, (jimg, jnr) in zip(SAMPLES, jimgs):
        img, nr = tpt.render_sample(ts, tacc, tc, RES, RES, s, cfg)
        assert torch.isfinite(img).all()
        assert S.image_rel_diff(img.numpy(), jimg) < BAR
        assert abs(float(nr) - jnr) <= 5e-3 * jnr


def test_instanced_render_matches_jax(jax_static_route):
    js, jacc = jcompile(S.instanced_spheres_scene(JB), traversal="instanced")
    jimgs = _jax_images(js, jacc, j_camera(**S.INSTANCED_CAMERA),
                        jpt.PTConfig(max_path_length=4, count_rays=True))
    ts, tacc = tcompile(S.instanced_spheres_scene(TB), traversal="instanced")
    _check(ts, tacc, t_camera(**S.INSTANCED_CAMERA),
           tpt.PTConfig(max_path_length=4, count_rays=True), jimgs)


def test_bench_big_matches_jax(jax_static_route):
    """bench.py's `big` grid (74 instances) with its camera and integrator
    settings."""
    js, jacc = jcompile(bench.bench_scene_builder(JB.SceneBuilder(), "big"),
                        traversal="instanced")
    jc = j_camera([0.0, 2.2, 3.4], fov_y=np.deg2rad(45), aspect=1.0,
                  target=[0.0, 0.1, 0.0])
    jimgs = _jax_images(js, jacc, jc, jpt.PTConfig(
        max_path_length=bench.MAX_PATH_LENGTH, count_rays=True))
    ts, tacc = bench.build_bench_scene("big")
    _check(ts, tacc, bench.bench_camera(RES, RES, "big"), tpt.PTConfig(
        max_path_length=bench.MAX_PATH_LENGTH, count_rays=True), jimgs)


def test_instanced_matches_flattened():
    """The two-level compile renders the image of the flattened one."""
    ts_f, tb_f = tcompile(S.instanced_spheres_scene(TB),
                          traversal="widerow")
    ts_i, tacc = tcompile(S.instanced_spheres_scene(TB),
                          traversal="instanced")
    assert ts_i.num_triangles < ts_f.num_triangles
    tc = t_camera(**S.INSTANCED_CAMERA)
    cfg = tpt.PTConfig(max_path_length=4, count_rays=True)
    img_f, nr_f = tpt.render_accumulate(ts_f, tb_f, tc, 32, 32, 0, 4, cfg)
    img_i, nr_i = tpt.render_accumulate(ts_i, tacc, tc, 32, 32, 0, 4, cfg)
    assert torch.allclose(img_f, img_i, atol=1e-4), float(
        (img_f - img_i).abs().max())
    assert abs(float(nr_f) - float(nr_i)) <= 5e-3 * float(nr_f)


def test_instanced_light_sampling_matches_flattened():
    """Light rows, surface samples and the implicit-hit pdf through the
    instance transforms equal the flattened scene's (the box's lamp is an
    instanced emitter)."""
    ts_f, _ = tcompile(S.instanced_spheres_scene(TB), traversal="widerow")
    ts_i, _ = tcompile(S.instanced_spheres_scene(TB), traversal="instanced")
    rng = np.random.default_rng(11)
    u = [torch.from_numpy(rng.random(4096, np.float32)) for _ in range(3)]
    ls = {}
    for key, s in (("flat", ts_f), ("inst", ts_i)):
        packed = pack_light_rows(s)
        ls[key] = (sample_surface_light(s, *u, packed),
                   sample_surface_light(s, *u))
    for a, b in ((ls["flat"][0], ls["inst"][0]), (ls["inst"][0],
                                                  ls["inst"][1])):
        torch.testing.assert_close(a.position, b.position, atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(a.normal, b.normal, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(a.pdf, b.pdf, rtol=1e-5, atol=0)
    # the lamp's pdf at one of its (equal-area) triangles, through its
    # instance
    lamp = int(ts_i.units.light_tri_index[0])
    inst = ts_i.units.instance[
        int(torch.nonzero(ts_i.units.tri_count)[0])].reshape(1)
    pdf = surface_light_pdf(ts_i, torch.tensor([lamp]), inst=inst)
    assert torch.allclose(pdf, ls["inst"][0].pdf.max().reshape(1),
                          rtol=1e-5)
