"""The port's G-buffer (render/gbuffer.py), screen_position,
bsdf_dh_reflectance and the visualize modes against gfxexp_tpu's on the same
scenes, cameras and sample indices, at 16x16.

Cases: the box scene as wide rows (JAX: the persistent Pallas kernel in
interpret mode) with jitter; the instanced spheres scene after
advance_frame at t = 0.6 as a skip-link scene (flattened world triangles;
JAX traces it with accel/tiled.py on the CPU) without jitter and with a
previous camera moved by 0.05, and as a two-level scene
(advance_frame_instanced; JAX's static-grid instanced route) with jitter
and the same camera, so its motion is the instances' own.

Bars: hit, unit and material planes equal; tri equal except on ties in t
(|dt| <= 1e-6 t); position, depth and geom_normal within 1e-5 (absolute),
the shading normal within 1e-5, texcoord within 2e-5, bary within 5e-5 on
hit pixels (XLA on the CPU contracts the leaf test's multiply-adds into
fused multiply-adds, which moves u, v by up to ~1e-5,
torch_scenes.check_against_jax), motion within 1e-4 pixels, albedo,
emittance and view_dir within 1e-6. Measured: position 8.4e-7, normal
1.6e-6, texcoord 4.7e-6, bary 1.1e-5, motion 2.9e-6 px.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch.render import bsdf as tbsdf  # noqa: E402
from gfxexp_torch.render import camera as tcam  # noqa: E402
from gfxexp_torch.render import visualize as tvis  # noqa: E402
from gfxexp_torch.render.gbuffer import render_gbuffer as t_gbuffer  # noqa
from gfxexp_torch.scene import animation as ta  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.types import from_numpy  # noqa: E402
from gfxexp_tpu.accel import pallas_widestack  # noqa: E402
from gfxexp_tpu.render import bsdf as jbsdf  # noqa: E402
from gfxexp_tpu.render import camera as jcam  # noqa: E402
from gfxexp_tpu.render import visualize as jvis  # noqa: E402
from gfxexp_tpu.render.gbuffer import render_gbuffer as j_gbuffer  # noqa
from gfxexp_tpu.scene import animation as ja  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(2)
RES = 16
SAMPLE = 3
ATOL = {"position": 1e-5, "depth": 1e-5, "geom_normal": 1e-5,
        "normal": 1e-5, "texcoord": 2e-5, "bary": 5e-5, "motion": 1e-4,
        "albedo": 1e-6, "emittance": 1e-6, "view_dir": 1e-6}
MOVED = dict(S.INSTANCED_CAMERA, position=[0.05, 0.5, 1.9])
# case: (scene, traversal, jitter, camera, previous camera)
CASES = {
    "box_widerow_jitter": ("box", "widerow", True, S.BOX_CAMERA,
                           S.BOX_CAMERA),
    "animated_skip": ("spheres", "skip", False, S.INSTANCED_CAMERA, MOVED),
    "animated_instanced_jitter": ("spheres", "instanced", True,
                                  S.INSTANCED_CAMERA, S.INSTANCED_CAMERA),
}
SCENES = {"box": S.box_scene, "spheres": S.instanced_spheres_scene}


def _scenes(which, traversal):
    """(JAX scene, JAX bvh, port scene, port bvh), after one frame of
    animation for the spheres."""
    js, jb = jcompile(SCENES[which](JB), traversal=traversal)
    ts, tb = tcompile(SCENES[which](TB), traversal=traversal)
    if which == "spheres":
        js = jax.tree_util.tree_map(jnp.asarray, js)
        jadv = (ja.advance_frame_instanced if traversal == "instanced"
                else ja.advance_frame)
        tadv = (ta.advance_frame_instanced if traversal == "instanced"
                else ta.advance_frame)
        js, jb = jadv(js, jb, S.spheres_controllers(ja), 0.6)
        ts, tb = tadv(ts, tb, S.spheres_controllers(ta), 0.6)
    return js, jb, ts, tb


@pytest.fixture(scope="module")
def gbuffers():
    out = {}
    saved = pallas_widestack.PERSISTENT
    pallas_widestack.PERSISTENT = False  # the static-grid instanced route
    try:
        for key, (which, traversal, jitter, cam, prev) in CASES.items():
            js, jb, ts, tb = _scenes(which, traversal)
            jgb = j_gbuffer(js, jb, jcam.make_camera(**cam),
                            jcam.make_camera(**prev), RES, RES,
                            jnp.uint32(SAMPLE), jitter)
            tgb = t_gbuffer(ts, tb, tcam.make_camera(**cam),
                            tcam.make_camera(**prev), RES, RES, SAMPLE,
                            jitter)
            out[key] = (tgb, jgb)
    finally:
        pallas_widestack.PERSISTENT = saved
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_gbuffer_matches_jax(gbuffers, case):
    tgb, jgb = gbuffers[case]
    m = np.asarray(jgb.hit)
    assert m.any()
    for name in ("hit", "unit", "material"):
        np.testing.assert_array_equal(getattr(tgb, name).numpy(),
                                      np.asarray(getattr(jgb, name)), name)
    depth, jdepth = tgb.depth.numpy(), np.asarray(jgb.depth)
    assert np.isinf(depth[~m]).all()
    tie = np.abs(depth - jdepth) <= 1e-6 * np.abs(jdepth)
    assert ((tgb.tri.numpy() == np.asarray(jgb.tri)) | (m & tie)).all()
    for name, atol in ATOL.items():
        a = getattr(tgb, name).numpy()
        b = np.asarray(getattr(jgb, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("depth", "bary"):
            a, b = a[m], b[m]
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


def test_motion_follows_the_instances(gbuffers):
    """With the camera still, motion is non-zero only where an animated
    instance is hit (the two-level case: prev_transform set by
    advance_frame_instanced)."""
    tgb, _ = gbuffers["animated_instanced_jitter"]
    moving = tgb.motion.abs().sum(-1) > 0
    assert moving.any() and not moving.all()
    # the box walls (units of instances 0-5) do not move
    assert not moving[tgb.hit & (tgb.unit < 6)].any()


def test_screen_position_matches_jax(rng_np):
    cams = [S.BOX_CAMERA, S.FURNACE_CAMERA, MOVED]
    p = rng_np.uniform(-2, 2, (257, 3)).astype(np.float32)
    for cam in cams:
        uv = tcam.screen_position(tcam.make_camera(**cam), torch.from_numpy(p))
        juv = jcam.screen_position(jcam.make_camera(**cam), jnp.asarray(p))
        np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-5,
                                   atol=1e-6)


def test_dh_reflectance_matches_jax(rng_np):
    n = 300
    diffuse = rng_np.uniform(0, 1, (n, 3)).astype(np.float32)
    f0 = rng_np.uniform(0, 1, (n, 3)).astype(np.float32)
    rough = rng_np.uniform(0, 0.999, n).astype(np.float32)
    lam = rng_np.random(n) < 0.3
    v = rng_np.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    tp = tbsdf.BSDFParams(torch.from_numpy(diffuse), torch.from_numpy(f0),
                          torch.from_numpy(rough), torch.from_numpy(lam))
    jp = jbsdf.BSDFParams(jnp.asarray(diffuse), jnp.asarray(f0),
                          jnp.asarray(rough), jnp.asarray(lam))
    out = tbsdf.bsdf_dh_reflectance(tp, torch.from_numpy(v))
    jout = jbsdf.bsdf_dh_reflectance(jp, jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)
    h = tbsdf._half_vec(torch.from_numpy(v), torch.from_numpy(v[::-1].copy()))
    jh = jbsdf._half_vec(jnp.asarray(v), jnp.asarray(v[::-1].copy()))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", list(jvis.ALL_BUFFERS))
def test_visualize_matches_jax(gbuffers, mode):
    """Every mode on JAX's G-buffer of the animated skip case, carried into
    the port's class (the beauty view on a seeded HDR image), within
    1e-6."""
    _, jgb = gbuffers["animated_skip"]
    tgb = from_numpy(jgb)
    beauty = np.random.default_rng(5).gamma(
        1.0, 0.5, (RES, RES, 3)).astype(np.float32)
    out = tvis.visualize(mode, torch.from_numpy(beauty), tgb, 1.5)
    jout = jvis.visualize(mode, jnp.asarray(beauty), jgb, 1.5)
    assert out.shape == (RES, RES, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)


def test_visualize_rejects_unknown_mode_and_debug_switches():
    with pytest.raises(ValueError):
        tvis.visualize("nope")
    sw = tvis.DebugSwitches(flags=0b1000_0101)
    assert [sw.get(i) for i in range(8)] == [
        jvis.DebugSwitches(0b1000_0101).get(i) for i in range(8)]
    assert int(tvis.DebugSwitches(0xFFFFFFFF).as_uint32()) == -1


def test_gbuffer_converts_from_jax(gbuffers):
    """from_numpy carries a JAX GBuffer into the port's class, field for
    field (the SVGF and ReSTIR tests feed passes this way)."""
    tgb, jgb = gbuffers["box_widerow_jitter"]
    conv = from_numpy(jgb)
    assert type(conv) is type(tgb)
    assert torch.equal(conv.hit, tgb.hit) and conv.unit.dtype == torch.int32
