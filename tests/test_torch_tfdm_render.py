"""The path tracer's displaced hooks (render/pathtrace.py) on the tfdm
app's demo scene (apps/tfdm.py demo_scene at -base-res 4: a floor, a lamp,
a specular sphere and a 32-prism displaced patch), compiled skip-link,
against gfxexp_tpu's render_sample at 16x16, 2 samples, with displaced
shadows on and off; the scene carried across by from_numpy; fused shadow
rays ignored on it; the tfdm CLI on the CPU; every other displaced kind
(curves, shells, NRTDSM) building and carried across, one unknown to the
port raising; and a scene without displaced geometry dispatching the ops per
sample it did before the hooks (gfxexp_torch/op_counts.py).

Bars: mean relative image difference < 5e-4 against JAX (measured 1.8e-6)
with equal ray counts; from_numpy's scene and fused shadow rays equal to
the port's own build and to unfused, bit for bit; the small scene's
default sample 5,789 ops (5,805 with fused shadow rays), 9 (5) walks, as
counted on the tree before the hooks came in.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfxexp_torch.apps import tfdm as tapp
from gfxexp_torch.render import pathtrace as tpt
from gfxexp_torch.render.camera import make_camera as tcam
from gfxexp_torch.scene.compile import compile_scene as tcompile
from gfxexp_torch.scene.types import from_numpy
from gfxexp_torch.techniques import tfdm as T
from gfxexp_torch.utils.image_io import load_png
from gfxexp_tpu.apps import tfdm as japp
from gfxexp_tpu.apps.common import euler_orientation
from gfxexp_tpu.render import pathtrace as jpt
from gfxexp_tpu.render.camera import make_camera as jcam
from gfxexp_tpu.scene.compile import compile_scene as jcompile
from gfxexp_tpu.techniques import tfdm as J

torch.set_num_threads(2)
RES = 16
SAMPLES = 2
CAMERA = dict(position=[0.0, 2.1, 3.4], fov_y=math.radians(50), aspect=1.0,
              orientation=euler_orientation(0.0, math.radians(30),
                                            math.radians(180)))


def _args():
    return types.SimpleNamespace(height_map=None, height_kind="ridges",
                                 base_res=4)


@pytest.fixture(scope="module")
def scenes():
    js, jb = jcompile(japp.demo_scene(_args(), "tfdm",
                                      J.DisplacementParameters(h_scale=0.25)),
                      traversal="skip")
    ts, tb = tcompile(tapp.demo_scene(_args(), "tfdm",
                                      T.DisplacementParameters(h_scale=0.25)),
                      traversal="skip")
    return (js, jb), (ts, tb)


def _t_render(scene, bvh, cfg):
    img, rays = 0.0, 0.0
    for s in range(SAMPLES):
        out, nr = tpt.render_sample(scene, bvh, tcam(**CAMERA), RES, RES, s,
                                    cfg)
        img, rays = img + out, rays + float(nr)
    return img / SAMPLES, rays


@pytest.mark.parametrize("shadows", [True, False])
def test_displaced_render_matches_jax(scenes, shadows):
    (js, jb), (ts, tb) = scenes
    assert len(ts.displaced) == 1 and ts.displaced[0].p0.shape[0] == 32
    jimg, jrays = 0.0, 0.0
    for s in range(SAMPLES):
        out, nr = jpt.render_sample(
            js, jb, jcam(**CAMERA), RES, RES, jnp.uint32(s),
            jpt.PTConfig(displaced_shadows=shadows, count_rays=True))
        jimg, jrays = jimg + np.asarray(out), jrays + float(nr)
    jimg = jimg / SAMPLES
    timg, trays = _t_render(ts, tb, tpt.PTConfig(displaced_shadows=shadows,
                                                 count_rays=True))
    timg = timg.numpy()
    rel = np.abs(timg - jimg).mean() / np.abs(jimg).mean()
    assert rel < 5e-4, rel
    assert trays == jrays
    assert np.isfinite(timg).all() and timg.mean() > 0


def test_displaced_shadows_act(scenes):
    _, (ts, tb) = scenes
    on, _ = _t_render(ts, tb, tpt.PTConfig(count_rays=True))
    off, _ = _t_render(ts, tb, tpt.PTConfig(displaced_shadows=False,
                                            count_rays=True))
    assert float(on.mean()) < float(off.mean())


def test_from_numpy_scene_renders_as_port_build(scenes):
    (js, jb), (ts, tb) = scenes
    fs, fb = from_numpy(js), from_numpy(jb)
    cfg = tpt.PTConfig(count_rays=True)
    a, ra = _t_render(fs, fb, cfg)
    b, rb = _t_render(ts, tb, cfg)
    assert torch.equal(a, b) and ra == rb


def test_fused_shadow_rays_ignored_with_displaced(scenes):
    _, (ts, tb) = scenes
    a, ra = _t_render(ts, tb, tpt.PTConfig(count_rays=True))
    b, rb = _t_render(ts, tb, tpt.PTConfig(count_rays=True,
                                           fuse_shadow_rays=True))
    assert torch.equal(a, b) and ra == rb


def _all_kinds(B, T):
    """A builder of either package with every displaced kind under an
    emissive tessellated curve tube: direct linear and cubic curves, a
    shell and an NRTDSM patch."""
    b = B.SceneBuilder()
    m = b.add_lambert_material((0.5, 0.5, 0.5))
    cp = np.array([[0, 0, 0], [1, 1.2, 0.3], [2, -0.8, -0.4], [3, 0.2, 0.5],
                   [4, 1.0, 0.0]], np.float32)
    rr = np.array([0.2, 0.15, 0.3, 0.18, 0.25], np.float32)
    lamp = b.add_lambert_material((0, 0, 0), emittance=(20.0, 20.0, 20.0))
    b.add_instance(b.add_curve(cp[:4] + [0.0, 2.0, 0.0], rr[:4], lamp,
                               curve_type="bezier", n_axial=4, n_radial=5))
    b.add_curve(cp, rr, m, curve_type="linear", direct=True)
    b.add_curve(cp, rr, m, curve_type="cubic_bspline", direct=True)
    pos, idx, uvs, nrm = japp.subdivided_plane(2)
    box = np.array([[0.2, 0.2, 0.1], [0.6, 0.2, 0.1], [0.6, 0.6, 0.1],
                    [0.2, 0.6, 0.8]], np.float32)
    tets = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]], np.int32)
    params = T.DisplacementParameters(h_scale=0.25)
    b.add_shell(pos, idx, uvs, box, tets, params=params, material=m,
                normals=nrm, shell_materials=[0, 1, 0, 1])
    b.add_displaced(pos, idx, uvs, japp.procedural_height(16), params=params,
                    material=m, kind="nrtdsm", normals=nrm)
    return b


def test_unported_displaced_kinds_raise():
    """Curves, shells and NRTDSM raised here until the port had them; now
    add_curve (tessellated, and direct as segments and as spans), add_shell
    and add_displaced(kind="nrtdsm") build and compile, from_numpy carries
    the JAX scene's geometry across equal to the port's build, field for
    field, and the path tracer renders it. A displaced kind the port does
    not have still raises."""
    import gfxexp_tpu.scene.builder as JB
    import gfxexp_torch.scene.builder as TB

    js, _ = jcompile(_all_kinds(JB, J), traversal="skip")
    ts, tb = tcompile(_all_kinds(TB, T), traversal="skip")
    assert [type(g).__name__ for g in ts.displaced] == [
        "CurveSegments", "CurveSpans", "ShellGeometry", "NRTDSMGeometry"]
    assert ts.num_triangles == js.triangles.p0.shape[0]
    fs = from_numpy(js)
    for fg, tg in zip(fs.displaced, ts.displaced):
        assert type(fg) is type(tg)
        for f in ("p0", "p1", "r0", "coef", "lo", "shell_mat", "n2",
                  "height"):
            if hasattr(tg, f):
                assert torch.equal(getattr(fg, f), getattr(tg, f)), f
    assert torch.equal(fs.displaced[2].shell_bvh.node_pack,
                       ts.displaced[2].shell_bvh.node_pack)
    cam = tcam(position=[1.5, 1.5, 4.0], fov_y=math.radians(60),
               aspect=1.0, target=[1.5, 0.0, 0.0])
    img = tpt.render_sample(ts, tb, cam, 8, 8, 0, tpt.PTConfig())
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0

    class FooGeometry:
        pass

    with pytest.raises(TypeError, match="FooGeometry"):
        from_numpy(js.replace(displaced=(FooGeometry(),)))


def test_scene_without_displaced_keeps_its_ops():
    from gfxexp_torch import bench
    from gfxexp_torch.op_counts import count_sample

    scene, bvh = bench.build_bench_scene()
    cam = bench.bench_camera(32, 32)
    assert scene.displaced is None
    assert count_sample(scene, bvh, cam, 32, 32, tpt.PTConfig()) == {
        "ops": 5789, "walks": 9}
    # fused shadow rays: the default's ops, less its 4 any-hit walks, plus
    # 3 concatenations a fused walk
    assert count_sample(scene, bvh, cam, 32, 32,
                        tpt.PTConfig(fuse_shadow_rays=True)) == {
        "ops": 5797, "walks": 5}


def test_tfdm_cli_writes_image_and_heatmap(tmp_path):
    out = str(tmp_path / "tfdm")
    hdr = tapp.main(["-device", "cpu", "-width", str(RES), "-height",
                     str(RES), "-frames", "1", "-base-res", "4",
                     "-height-kind", "bumps", "-heatmap", "-output", out])
    assert hdr.shape == (RES, RES, 3) and np.isfinite(hdr).all()
    assert hdr.mean() > 0
    img = load_png(out + ".png", to_linear=False)
    heat = load_png(out + "_heatmap.png", to_linear=False)
    assert img.shape == heat.shape == (RES, RES, 3)
    assert heat.std() > 0  # the steps vary over the patch
