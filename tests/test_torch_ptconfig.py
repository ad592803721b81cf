"""The rest of PTConfig and the debug switches in the port's path tracer
(render/pathtrace.py) against gfxexp_tpu's render_sample on the textured
scene (gfxexp_torch.bench.textured_scene_builder: a 1-texel checker floor
with a 2-channel normal map, a normal-mapped and a height-mapped sphere
with BC1 and BC7 textures, an emissive-textured lamp, a dim environment),
compiled as a skip-link scene (JAX traces it with accel/tiled.py on the
CPU), at 16x16, max path length 4, one sample: bump mapping with every
debug-switch bit alone, 0b1000_0101 and 0xFF; bump with texture LOD;
solid-angle NEE; the probability-texture light selector. Then the fused
shadow rays against the unfused path in the port, on the textured scene
and on two-level and wide-row box scenes.

Bar against JAX: mean relative image difference < 5e-4, with at least 3/4
of the pixels within 1e-5 (absolute), and ray counts equal. The checker's
1-texel squares turn the walk's u, v rounding (XLA contracts the leaf
test's multiply-adds; up to ~2e-5, torch_scenes.check_against_jax) into a
texel step of 0.6 on the hit pixel, and a path that then bounces elsewhere
moves one pixel by up to ~1e-2 (measured: 1.7e-6 with white albedo, which
hides the checker, and 2.1e-6 with LOD, which filters it; 7.5e-6 to
6.7e-5 elsewhere, with 0.92 to 1 of the pixels within 1e-5). Fused
against unfused: rtol 1e-5, atol 1e-6 and equal ray counts
(tests/test_pathtrace.py's test_fused_shadow_rays_identical).
"""

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
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.render.camera import make_camera as j_camera  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(2)
RES = 16
SAMPLE = 3
BAR = 5e-4
CAMERA = dict(position=[0.0, 1.6, 3.0], fov_y=np.deg2rad(45), aspect=1.0,
              target=[0.0, 0.3, 0.0])
# case: (PTConfig options, debug switches, probability texture)
SWITCHES = [0, 1, 2, 4, 8, 16, 32, 64, 128, 0b1000_0101, 0xFF]
CASES = {f"bump_switches_{sw:#04x}": (dict(enable_bump_mapping=True), sw,
                                      False) for sw in SWITCHES}
CASES.update({
    "bump_texture_lod": (dict(enable_bump_mapping=True, texture_lod=True), 0,
                         False),
    "solid_angle": (dict(use_solid_angle_sampling=True), 0, False),
    "probability_texture": ({}, 0, True),
})


def _cfg(mod, **kw):
    return mod.PTConfig(max_path_length=4, count_rays=True, **kw)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tex"))
    out = {}
    for probtex in (False, True):
        out[probtex] = (
            jcompile(bench.textured_scene_builder(
                JB.SceneBuilder(texture_mips=True), d),
                use_probability_texture=probtex),
            tcompile(bench.textured_scene_builder(
                TB.SceneBuilder(texture_mips=True), d),
                use_probability_texture=probtex))
    return out


def _render_pair(scenes, kw, sw, probtex):
    (js, jb), (ts, tb) = scenes[probtex]
    jimg, jn = jpt.render_sample(js, jb, j_camera(**CAMERA), RES, RES,
                                 jnp.uint32(SAMPLE), _cfg(jpt, **kw),
                                 jnp.uint32(sw))
    timg, tn = tpt.render_sample(ts, tb, t_camera(**CAMERA), RES, RES, SAMPLE,
                                 _cfg(tpt, **kw), sw)
    return timg.numpy(), float(tn), np.asarray(jimg), float(jn)


@pytest.mark.parametrize("case", list(CASES))
def test_render_matches_jax(scenes, case):
    kw, sw, probtex = CASES[case]
    a, na, b, nb = _render_pair(scenes, kw, sw, probtex)
    assert a.shape == (RES * RES, 3) and np.isfinite(a).all()
    assert na == nb
    close = (np.abs(a - b).max(-1) <= 1e-5).mean()
    assert S.image_rel_diff(a, b) < BAR and close >= 0.75, (
        S.image_rel_diff(a, b), close)
    if sw != 0xFF:
        assert a.mean() > 0


def test_switches_act(scenes):
    """The switches change the image where they should: no NEE darkens,
    white albedo brightens the checker, no jitter and geometric normals
    move it, and 0xFF (no NEE, no env, no emission past the first hit)
    leaves the camera's view of the lamp only (out of frame: black)."""
    (_, _), (ts, tb) = scenes[False]
    cam = t_camera(**CAMERA)

    def img(sw):
        return tpt.render_sample(ts, tb, cam, RES, RES, SAMPLE,
                                 tpt.PTConfig(max_path_length=4), sw)

    base = img(0)
    assert float(img(1).mean()) < 0.6 * float(base.mean())
    assert float(img(64).mean()) > float(base.mean())
    for sw in (32, 128):
        assert not torch.equal(img(sw), base)
    assert float(img(0xFF).abs().max()) == 0.0
    # a 0-d tensor is read once, on the host
    assert torch.equal(img(torch.tensor(64)), img(64))


FUSED_SCENES = {
    "textured_skip": None,
    "box_widerow": (S.box_scene, "widerow", S.BOX_CAMERA),
    "spheres_instanced": (S.instanced_spheres_scene, "instanced",
                          S.INSTANCED_CAMERA),
}


@pytest.mark.parametrize("which", list(FUSED_SCENES))
@pytest.mark.parametrize("sw", [0, 0b1000_0101])
def test_fused_shadow_rays_match_unfused(scenes, which, sw):
    if FUSED_SCENES[which] is None:
        (_, _), (ts, tb) = scenes[False]
        cam = t_camera(**CAMERA)
    else:
        make, traversal, c = FUSED_SCENES[which]
        ts, tb = tcompile(make(TB), traversal=traversal)
        cam = t_camera(**c)
    out = {}
    for fuse in (False, True):
        cfg = tpt.PTConfig(max_path_length=4, count_rays=True,
                           fuse_shadow_rays=fuse, enable_bump_mapping=True)
        out[fuse] = tpt.render_sample(ts, tb, cam, 24, 24, 5, cfg, sw)
    (a, na), (b, nb) = out[False], out[True]
    assert float(na) == float(nb)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), float(
        (a - b).abs().max())
    assert float(a.mean()) > 0


def test_fused_walk_takes_two_batches(scenes, monkeypatch):
    """With fuse_shadow_rays every bounce after the first is one closest
    walk over 2N lanes (its rays, then the previous bounce's shadow rays)
    and no any-hit walk runs."""
    (_, _), (ts, tb) = scenes[False]
    calls = []
    real_closest, real_any = tpt.intersect_closest, tpt.intersect_any

    def closest(bvh, tris, o, d, t_min=0.0, t_max=1e30):
        calls.append(("closest", o.shape[0]))
        return real_closest(bvh, tris, o, d, t_min=t_min, t_max=t_max)

    def any_hit(*a, **kw):
        calls.append(("any", a[2].shape[0]))
        return real_any(*a, **kw)

    monkeypatch.setattr(tpt, "intersect_closest", closest)
    monkeypatch.setattr(tpt, "intersect_any", any_hit)
    n = RES * RES
    tpt.render_sample(ts, tb, t_camera(**CAMERA), RES, RES, 0,
                      tpt.PTConfig(fuse_shadow_rays=True))
    assert calls == [("closest", n)] + [("closest", 2 * n)] * 4
    calls.clear()
    tpt.render_sample(ts, tb, t_camera(**CAMERA), RES, RES, 0, tpt.PTConfig())
    assert calls == [("closest", n), ("any", n)] * 4 + [("closest", n)]
