"""Which route render_lanes takes (pathtrace.shade_kernel_admits), and the
default next-event estimation as render_lanes runs it on the CPU against
tracing each shadow ray at once, bit for bit: a bounce leaves its NEE term
and shadow ray to the next bounce's walks (an any-hit walk, or the fused
closest-hit walk), whose shading adds the unoccluded terms before its own
emission, the order of sums of pathtrace._next_event, which a custom NEE
(`nee_fn`) calls here."""

import dataclasses
import sys
import types

import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402


@pytest.fixture(scope="module")
def box():
    return compile_scene(S.box_scene(TB), traversal="widerow")


def _nee(scene, bvh, sp, v_out_local, frame, params, rs, cfg, alive, aux):
    rs.skip(3)
    return torch.zeros_like(sp.position), aux


def _refused(case, box):
    """(scene, cfg, nee_fn) for each input that sends a call to the eager
    stages."""
    scene, _ = box
    cfg = tpt.PTConfig()
    if case == "instanced":
        return (compile_scene(S.instanced_spheres_scene(TB),
                              traversal="instanced")[0], cfg, None)
    if case == "textured":
        return (dataclasses.replace(scene,
                                    textures=types.SimpleNamespace(count=1)),
                cfg, None)
    if case == "displaced":
        return dataclasses.replace(scene, displaced=(object(),)), cfg, None
    if case == "environment":
        return (compile_scene(S.furnace_scene(TB), traversal="widerow")[0],
                cfg, None)
    if case == "probability_texture":
        return (compile_scene(S.box_scene(TB), traversal="widerow",
                              use_probability_texture=True)[0], cfg, None)
    if case == "nee_fn":
        return scene, cfg, _nee
    return scene, tpt.PTConfig(**{case: True}), None


@pytest.mark.parametrize("case", [
    "box", "instanced", "textured", "displaced", "environment",
    "probability_texture", "nee_fn", "sort_secondary_rays", "compact_rays",
    "use_solid_angle_sampling", "fuse_shadow_rays"])
def test_route(case, box):
    """The plain box takes the kernel route; each of the others, the eager
    stages."""
    if case == "box":
        assert tpt.shade_kernel_admits(box[0], tpt.PTConfig())
    else:
        assert not tpt.shade_kernel_admits(*_refused(case, box))


W, H = 24, 16
# (scene, PTConfig fields, debug switches): the kernel route's options,
# and refused ones that change the walks (fused, compacted, sorted) or the
# light (environment)
NEE_CASES = [
    ("box", {}, 0),
    ("box", {"count_rays": True, "max_path_length": 3}, 0),
    ("box", {"use_implicit_light_sampling": False}, 0),
    ("box", {"russian_roulette": False, "max_path_length": 2}, 0),
    ("box", {}, 0b11111110),
    ("glossy", {"mollify_specular": True}, 0b01000100),
    ("glossy", {"count_rays": True, "max_path_length": 2}, 0b10000001),
    ("box", {"fuse_shadow_rays": True, "count_rays": True}, 0),
    ("box", {"compact_rays": True, "count_rays": True}, 0),
    ("glossy", {"sort_secondary_rays": True}, 0),
    ("furnace", {}, 0),
    ("furnace", {"compact_rays": True}, 0b00000100),
]


def _immediate_nee(dbg):
    """The default NEE with its shadow ray traced at once, as an nee_fn."""
    env_off = tpt.DebugSwitches.from_bits(dbg).no_env

    def nee(scene, bvh, sp, v_out_local, frame, params, rs, cfg, alive,
            aux):
        return tpt._next_event(scene, bvh, sp, v_out_local, frame, params,
                               rs, cfg, alive,
                               light_packed=tpt.pack_light_rows(scene),
                               env_off=env_off), aux

    return nee


@pytest.mark.parametrize("which,opts,dbg", NEE_CASES)
def test_deferred_nee_equals_immediate(box, which, opts, dbg):
    """render_lanes on the CPU with the default NEE, deferred to the next
    bounce, and with the same NEE traced at once: equal bit for bit, ray
    counts too; no bounce counted on the CPU."""
    scene, bvh = {
        "box": lambda: box,
        "glossy": lambda: compile_scene(S.glossy_box_scene(TB),
                                        traversal="widerow"),
        "furnace": lambda: compile_scene(S.furnace_scene(TB),
                                         traversal="widerow")}[which]()
    cam = make_camera(**dict(S.BOX_CAMERA, aspect=W / H))
    cfg = tpt.PTConfig(**opts)
    trace.reset_counters("pathtrace.shade")
    k = tpt.render_lanes(scene, bvh, cam, W, H, 0, W * H, 5, cfg,
                         debug_switches=dbg)
    p = tpt.render_lanes(scene, bvh, cam, W, H, 0, W * H, 5, cfg,
                         nee_fn=_immediate_nee(dbg), debug_switches=dbg)
    assert trace.counters("pathtrace.shade") == {}
    if cfg.count_rays:
        (k, kn), (p, pn) = k, p
        assert torch.equal(kn, pn) and float(kn) > W * H
    assert torch.isfinite(k).all() and float(k.abs().sum()) > 0
    assert torch.equal(k, p)
