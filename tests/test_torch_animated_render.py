"""The port's path tracer on animated (skip-link) scenes: a frame after
advance_frame against gfxexp_tpu's render of the same frame (16x16, two
samples; image mean relative difference < 5e-3, the bar of
test_torch_pathtrace.py, and ray counts within 0.5%), and a static
skip-link render against the port's wide-row render of the same scene (atol
1e-4: the walks find the same hits, Moller-Trumbore against Baldwin-Weber
rounding). This exercises the refit, the device-rebuilt light
distributions (alias tables dropped, so light selection takes the CDF
search) and the skip walk inside the integrator.

JAX side: on the CPU the skip scene is traced by accel/tiled.py (the
JAX package's CPU stand-in for the skip walk)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera as t_camera  # noqa: E402
from gfxexp_torch.scene import animation as ta  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.render.camera import make_camera as j_camera  # noqa: E402
from gfxexp_tpu.scene import animation as ja  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(2)
BAR = 5e-3
RES = 16
SAMPLES = (3, 4)


def test_animated_frame_matches_jax():
    js, jb = jcompile(S.instanced_spheres_scene(JB), traversal="skip")
    js = jax.tree_util.tree_map(jnp.asarray, js)
    js, jb = ja.advance_frame(js, jb, S.spheres_controllers(ja), 0.6)
    assert js.light_unit_alias_prob is None
    jcfg = jpt.PTConfig(max_path_length=4, count_rays=True)
    jc = j_camera(**S.INSTANCED_CAMERA)
    jimgs = [jpt.render_sample(js, jb, jc, RES, RES, jnp.uint32(s), jcfg)
             for s in SAMPLES]

    ts, tb = tcompile(S.instanced_spheres_scene(TB), traversal="skip")
    ts, tb = ta.advance_frame(ts, tb, S.spheres_controllers(ta), 0.6)
    tcfg = tpt.PTConfig(max_path_length=4, count_rays=True)
    tc = t_camera(**S.INSTANCED_CAMERA)
    for s, (jimg, jnr) in zip(SAMPLES, jimgs):
        img, nr = tpt.render_sample(ts, tb, tc, RES, RES, s, tcfg)
        assert torch.isfinite(img).all() and float(img.mean()) > 0.0
        assert S.image_rel_diff(img.numpy(), np.asarray(jimg)) < BAR
        assert abs(float(nr) - float(jnr)) <= 5e-3 * float(jnr)


def test_static_skip_render_matches_widerow():
    ts_s, tb_s = tcompile(S.instanced_spheres_scene(TB), traversal="skip")
    ts_w, tb_w = tcompile(S.instanced_spheres_scene(TB), traversal="widerow")
    # one BVH build behind both: the same triangle order
    assert torch.equal(ts_s.triangles.p0, ts_w.triangles.p0)
    tc = t_camera(**S.INSTANCED_CAMERA)
    cfg = tpt.PTConfig(max_path_length=4, count_rays=True)
    img_s, nr_s = tpt.render_accumulate(ts_s, tb_s, tc, 32, 32, 0, 4, cfg)
    img_w, nr_w = tpt.render_accumulate(ts_w, tb_w, tc, 32, 32, 0, 4, cfg)
    assert torch.allclose(img_s, img_w, atol=1e-4), float(
        (img_s - img_w).abs().max())
    assert abs(float(nr_s) - float(nr_w)) <= 5e-3 * float(nr_w)
