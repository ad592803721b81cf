"""The port's path tracer against gfxexp_tpu's on the same scenes, cameras and
sample indices (the RNG is bit-exact, so images agree up to float rounding).

JAX side: the box scene is compiled with traversal="widerow" and traced by
the persistent Pallas kernel in interpret mode; the furnace scene uses the
default skip traversal (one more interpret-mode compile would double this
file's time). Bar: mean relative absolute image difference < 5e-3 (the
golden test's, tests/test_pathtrace.py:254-257) and ray counts within 0.5%.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera as t_camera  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.render.camera import make_camera as j_camera  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(2)
BAR = 5e-3
RES = 24
SAMPLES = (3, 4)
CASES = {
    # scene, camera, JAX traversal
    "box": (S.box_scene, S.BOX_CAMERA, "widerow"),
    "furnace": (S.furnace_scene, S.FURNACE_CAMERA, "skip"),
}


def _jcfg(**kw):
    return jpt.PTConfig(max_path_length=4, count_rays=True, **kw)


def _tcfg(**kw):
    return tpt.PTConfig(max_path_length=4, count_rays=True, **kw)


@pytest.fixture(scope="module")
def rendered():
    """Per case: the port's scene + camera, and JAX's per-sample images and
    ray counts."""
    out = {}
    for key, (make, cam, traversal) in CASES.items():
        js, jb = jcompile(make(JB), traversal=traversal)
        jc = j_camera(**cam)
        jimgs = []
        for s in SAMPLES:
            img, nr = jpt.render_sample(js, jb, jc, RES, RES, jnp.uint32(s),
                                        _jcfg())
            jimgs.append((np.asarray(img), float(nr)))
        ts, tb = tcompile(make(TB), traversal="widerow")
        out[key] = (ts, tb, t_camera(**cam), jimgs)
    return out


@pytest.mark.parametrize("key", list(CASES))
def test_render_sample_matches_jax(rendered, key):
    ts, tb, tc, jimgs = rendered[key]
    for s, (jimg, jnr) in zip(SAMPLES, jimgs):
        img, nr = tpt.render_sample(ts, tb, tc, RES, RES, s, _tcfg())
        assert img.shape == (RES * RES, 3)
        assert torch.isfinite(img).all()
        assert S.image_rel_diff(img.numpy(), jimg) < BAR
        assert abs(float(nr) - jnr) <= 5e-3 * jnr


@pytest.mark.parametrize("key", list(CASES))
def test_render_accumulate_matches_jax(rendered, key):
    ts, tb, tc, jimgs = rendered[key]
    mean, nr = tpt.render_accumulate(ts, tb, tc, RES, RES, SAMPLES[0],
                                     len(SAMPLES), _tcfg())
    jmean = np.mean([im for im, _ in jimgs], axis=0)
    jnr = sum(n for _, n in jimgs)
    assert S.image_rel_diff(mean.numpy(), jmean) < BAR
    assert abs(float(nr) - jnr) <= 5e-3 * jnr


def test_furnace_is_flat(rendered):
    """Furnace: a convex 0.5-albedo Lambert sphere under constant radiance 1
    sees only the environment, so its pixels converge to 0.5 and the
    background reads exactly 1."""
    ts, tb, tc, _ = rendered["furnace"]
    mean = tpt.render_accumulate(ts, tb, tc, RES, RES, 0, 4,
                                 tpt.PTConfig(max_path_length=8)).mean(1)
    sphere = mean[mean < 0.99]
    assert (mean[mean >= 0.99] == 1.0).all()
    assert sphere.numel() > RES * RES // 3
    assert abs(float(sphere.mean()) - 0.5) < 0.05, float(sphere.mean())


def test_golden_box_image():
    """The port on the committed golden (tests/golden/box_8spp_48.npz: box
    scene, 48x48, 8 samples, max_path_length 4) at the golden test's
    tolerance."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "box_8spp_48.npz"))["img"]
    ts, tb = tcompile(S.box_scene(TB), traversal="widerow")
    tc = t_camera(**S.BOX_CAMERA)
    img = tpt.render_accumulate(ts, tb, tc, 48, 48, 0, 8,
                                tpt.PTConfig(max_path_length=4))
    assert S.image_rel_diff(img.numpy(), golden) < BAR


def test_render_tile_accumulate_matches_accumulate(rendered):
    """bench's 1080p path (lane tiles through render_tile_accumulate) gives
    render_accumulate's image and ray count."""
    ts, tb, tc, _ = rendered["box"]
    cfg = tpt.PTConfig(max_path_length=3, count_rays=True)
    mean, nr = tpt.render_accumulate(ts, tb, tc, RES, RES, 5, 3, cfg)
    lanes = RES * RES // 2
    tiles, nr_t = [], 0.0
    for tile in range(2):
        acc, n = tpt.render_tile_accumulate(ts, tb, tc, RES, RES,
                                            tile * lanes, lanes, 5, 3, cfg)
        one = sum(tpt.render_tile(ts, tb, tc, RES, RES, tile * lanes, lanes,
                                  5 + s, cfg)[0] for s in range(3))
        assert torch.allclose(acc, one, atol=1e-5)
        tiles.append(acc)
        nr_t += float(n)
    order = tpt._pixel_order(RES, RES, "cpu")
    assert torch.allclose(torch.cat(tiles)[order] / 3, mean, atol=1e-6)
    assert nr_t == float(nr)


@pytest.mark.parametrize("option", ["sort_secondary_rays", "compact_rays"])
def test_unported_options_raise(rendered, option):
    """Ray sorting and compaction (once unported, now ported) leave the
    image and the ray count bit for bit the default's: the RNG is keyed by
    pixel and every walk answers each ray on its own."""
    ts, tb, tc, _ = rendered["box"]
    for s in SAMPLES:
        ref, nr = tpt.render_sample(ts, tb, tc, RES, RES, s, _tcfg())
        img, nr_o = tpt.render_sample(ts, tb, tc, RES, RES, s,
                                      _tcfg(**{option: True}))
        assert torch.equal(img, ref), (option, s)
        assert float(nr_o) == float(nr)
