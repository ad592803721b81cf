"""The slice as a whole: the path tracer's displaced hooks
(render/pathtrace.py) on the nrtdsm app's demo scene (apps/tfdm.py
demo_scene with -normal-tilt 0.3 at -base-res 2: a floor, a lamp, a
specular sphere and an 8-prism patch with curved shells), on the bilinear
surface (intersect_nrtdsm_v2) and the two-triangle one
(intersect_nrtdsm_exact), and on the shell-mapped scene (the torus OBJ of
gfxexp_torch.bench.write_mesh_files tiled 2 x 2 inside the shells,
intersect_shell; tests/test_torch_shell_render.py runs that case), each
compiled skip-link, against gfxexp_tpu's render_sample at 16x16, one
sample, displaced shadows on; each scene carried across by from_numpy; and
the nrtdsm CLI on the CPU with -heatmap (and with -shell, in that file).

Bars: mean relative image difference < 5e-3 against JAX (measured
4e-7 to 7e-6) with equal ray counts; from_numpy's scene renders equal to
the port's own build, bit for bit.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfxexp_torch import bench
from gfxexp_torch.apps import nrtdsm as tn
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
CAMERA = dict(position=[0.0, 2.1, 3.4], fov_y=math.radians(50), aspect=1.0,
              orientation=euler_orientation(0.0, math.radians(30),
                                            math.radians(180)))
CASES = {"bilinear": T.LOCAL_INTERSECTION_BILINEAR,
         "two_triangle": T.LOCAL_INTERSECTION_TWO_TRIANGLE,
         "shell": T.LOCAL_INTERSECTION_BILINEAR}


@pytest.fixture(scope="module")
def torus_obj(tmp_path_factory):
    return bench.write_mesh_files(str(tmp_path_factory.mktemp("meshes")))[
        "obj"]


def _scenes(case, torus_obj):
    args = types.SimpleNamespace(height_map=None, height_kind="ridges",
                                 base_res=2, normal_tilt=0.3)
    shell = (tn.shell_contents_mesh(torus_obj, 2) if case == "shell"
             else None)
    lit = CASES[case]
    js, jb = jcompile(japp.demo_scene(
        args, "nrtdsm", J.DisplacementParameters(
            h_scale=0.25, local_intersection_type=lit),
        shell_contents=shell), traversal="skip")
    ts, tb = tcompile(tapp.demo_scene(
        args, "nrtdsm", T.DisplacementParameters(
            h_scale=0.25, local_intersection_type=lit),
        shell_contents=shell), traversal="skip")
    return (js, jb), (ts, tb)


def _t_render(scene, bvh):
    img, rays = tpt.render_sample(scene, bvh, tcam(**CAMERA), RES, RES, 0,
                                  tpt.PTConfig(count_rays=True))
    return img, float(rays)


def check_render_matches_jax(case, torus_obj):
    """The bars of the module docstring on one scene."""
    (js, jb), (ts, tb) = _scenes(case, torus_obj)
    kind = {"shell": "ShellGeometry"}.get(case, "NRTDSMGeometry")
    assert [type(g).__name__ for g in ts.displaced] == [kind]
    jimg, jrays = jpt.render_sample(js, jb, jcam(**CAMERA), RES, RES,
                                    jnp.uint32(0),
                                    jpt.PTConfig(count_rays=True))
    jimg = np.asarray(jimg)
    timg, trays = _t_render(ts, tb)
    timg = timg.numpy()
    rel = np.abs(timg - jimg).mean() / np.abs(jimg).mean()
    assert rel < 5e-3, rel
    assert trays == float(jrays)
    assert np.isfinite(timg).all() and timg.mean() > 0
    # the scene carried across from JAX renders as the port's own build
    fs, fb = from_numpy(js), from_numpy(jb)
    a, ra = _t_render(fs, fb)
    b, rb = _t_render(ts, tb)
    assert torch.equal(a, b) and ra == rb


def check_cli_writes_images(tmp_path, torus_obj, extra):
    """The nrtdsm CLI at 16x16, one frame, -base-res 2 on the CPU writes
    its image and heatmap."""
    out = str(tmp_path / "nrtdsm")
    if "-shell" in extra:
        extra = [*extra, "-shell-obj", torus_obj]
    hdr = tn.main(["-device", "cpu", "-width", str(RES), "-height",
                   str(RES), "-frames", "1", "-base-res", "2",
                   "-output", out, *extra])
    assert hdr.shape == (RES, RES, 3) and np.isfinite(hdr).all()
    assert hdr.mean() > 0
    img = load_png(out + ".png", to_linear=False)
    heat = load_png(out + "_heatmap.png", to_linear=False)
    assert img.shape == heat.shape == (RES, RES, 3)
    assert heat.std() > 0  # the steps vary over the patch


@pytest.mark.parametrize("case", ["bilinear", "two_triangle"])
def test_displaced_render_matches_jax(case, torus_obj):
    check_render_matches_jax(case, torus_obj)


def test_nrtdsm_cli_writes_images(tmp_path, torus_obj):
    check_cli_writes_images(tmp_path, torus_obj, ["-heatmap"])
