"""gfxexp_torch runs without JAX or PIL: in a subprocess where importing
jax, flax or PIL fails, every module of the package (the apps included; among them the
quantized rows, accel/qrow.py, and the lane-group walk, accel/lanegroup.py)
imports, 16x16 renders of the small bench scene (wide rows and quantized
rows), of the two-level `big` scene and of an animated frame of the
flattened `big` scene run, a chunked wide-row table is built and walked,
the lane-group walk runs, and the path_tracing, svgf, restir_di (-rearch
-denoise), regir and neural_radiance_caching apps render on the CPU; the
textured scene (its PNG and DDS files written and loaded) renders with
bump, texture LOD, solid-angle NEE and fused shadow rays, an EXR round
trips, the path_tracing app runs with -bump -texture-lod -exr, and
SceneBuilder.load_texture reads a progressive JPEG, a 16-bit grey PNG and
an RLE TGA (tests/torch_images/) through the port's own decoders; the
tfdm app renders its displaced patch with -heatmap, the mesh loaders read
an OBJ, a PLY, a GLB and a glTF written here, and the path_tracing app
loads the OBJ through -obj; the nrtdsm app renders with -heatmap, the
two-triangle surface and -shell (the OBJ inside the shells), noise and the
affine forms evaluate, and a scene of tessellated and direct curves
renders; a scene builds with spatial splits (wide and quantized rows), a
"wide" BVH renders with ray sorting and compaction as without, the
sharded render runs on a one-rank gloo group, the viewer, camera rig,
DebugDraw and enable_compile_cache work, and the path_tracing app runs
with -live -spatial-splits and with -traversal wide. optax is blocked
too: the NRC cache trains without it. The package's sources and
chip_smoke.py never name jax, flax, PIL or gfxexp_tpu."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "gfxexp_torch"

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
sys.modules["PIL"] = None
import torch
torch.set_num_threads(1)
import gfxexp_torch
names = [m.name for m in pkgutil.walk_packages(gfxexp_torch.__path__,
                                               "gfxexp_torch.")]
for name in names:
    importlib.import_module(name)
assert {"gfxexp_torch.accel.qrow", "gfxexp_torch.accel.lanegroup"} <= set(
    names)
from gfxexp_torch.bench import (bench_camera, bench_controllers,
                                build_bench_scene)
from gfxexp_torch.render.pathtrace import PTConfig, render_sample
scene, bvh = build_bench_scene()
img, nr = render_sample(scene, bvh, bench_camera(16, 16), 16, 16, 0,
                        PTConfig(count_rays=True))
assert img.shape == (256, 3) and bool(torch.isfinite(img).all())
assert float(img.mean()) > 0.0 and float(nr) >= 256
scene, qb = build_bench_scene(traversal="qrow")
img = render_sample(scene, qb, bench_camera(16, 16), 16, 16, 0, PTConfig())
assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
from gfxexp_torch.accel.lanegroup import intersect_closest_lanegroup
from gfxexp_torch.accel.traverse import intersect_closest
from gfxexp_torch.accel.widerow import build_widerow
tris = scene.triangles
wb, _ = build_widerow(tris.p0.numpy(), tris.e1.numpy(), tris.e2.numpy(),
                      max_rows=500)
assert wb.num_chunks > 1
o = torch.zeros(64, 3) + torch.tensor([0.0, 0.8, 1.6])
d = torch.nn.functional.normalize(torch.randn(64, 3) * 0.2
                                  + torch.tensor([0.0, -0.6, -1.6]), dim=1)
h = intersect_closest(wb, None, o, d)
assert bool(h.hit.any())
one, _ = build_widerow(tris.p0.numpy(), tris.e1.numpy(), tris.e2.numpy())
hg = intersect_closest_lanegroup(one, None, o, d, groups=4)
assert torch.equal(hg.hit, h.hit)
scene, acc = build_bench_scene("big")
img = render_sample(scene, acc, bench_camera(16, 16, "big"), 16, 16, 0,
                    PTConfig())
assert scene.is_instanced and bool(torch.isfinite(img).all())
assert float(img.mean()) > 0.0
from gfxexp_torch.apps import path_tracing
from gfxexp_torch.scene.animation import advance_frame
scene, skip = build_bench_scene("big", traversal="skip")
scene, skip = advance_frame(scene, skip, bench_controllers("big"), 0.5)
img = render_sample(scene, skip, bench_camera(16, 16, "big"), 16, 16, 0,
                    PTConfig())
assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
hdr = path_tracing.main(["-device", "cpu", "-width", "8", "-height", "8",
                         "-frames", "2", "-output", OUT,
                         "-name", "b", "-sphere", "0.5", "-inst", "b",
                         "-begin-pos", "0", "0", "0", "-end-pos", "0", "1",
                         "0"])
assert hdr.shape == (8, 8, 3)
from gfxexp_torch.apps import restir_di, svgf
for app, extra in ((svgf, []), (restir_di, ["-rearch", "-denoise",
                                            "-light-subsets", "4"])):
    hdr = app.main(["-device", "cpu", "-width", "8", "-height", "8",
                    "-frames", "2", "-output", OUT, *extra])
    assert hdr.shape == (8, 8, 3) and hdr.mean() > 0.0
from gfxexp_torch.apps import neural_radiance_caching, regir
for app, extra in ((regir, ["-grid-dim", "4", "4", "4", "-light-slots",
                            "8"]),
                   (neural_radiance_caching, ["-position-encoding",
                                              "hash_grid"])):
    hdr = app.main(["-device", "cpu", "-width", "16", "-height", "16",
                    "-frames", "2", "-output", OUT, *extra])
    assert hdr.shape == (16, 16, 3) and hdr.mean() > 0.0
import os
import numpy as np
from gfxexp_torch.bench import build_textured_scene, textured_camera
from gfxexp_torch.scene.textures import load_dds
from gfxexp_torch.utils.image_io import load_exr, load_png, save_exr
tex = os.path.join(os.path.dirname(OUT), "tex")
scene, bvh = build_textured_scene(tex)
assert scene.textures.count == 7 and scene.textures.mip_flat is not None
img = render_sample(scene, bvh, textured_camera(16, 16), 16, 16, 0,
                    PTConfig(enable_bump_mapping=True, texture_lod=True,
                             use_solid_angle_sampling=True,
                             fuse_shadow_rays=True), 0b10000101)
assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
assert load_png(os.path.join(tex, "normal.png")).shape == (64, 64, 3)
assert load_dds(os.path.join(tex, "bc7.dds")).shape == (64, 64, 4)
from gfxexp_torch.scene.builder import SceneBuilder
b = SceneBuilder()
ids = [b.load_texture(os.path.join("tests", "torch_images", name))
       for name in ("photo_512_progressive420.jpg", "height_64_grey16.png",
                    "albedo_64_rle.tga")]
assert ids == [0, 1, 2] and len(b.atlas.images) == 3
assert load_png("tests/torch_images/height_64_grey16.png").shape == (64, 64)
save_exr(OUT + "_rt.exr", np.ones((4, 5, 3), np.float32))
assert (load_exr(OUT + "_rt.exr") == 1.0).all()
hdr = path_tracing.main(["-device", "cpu", "-width", "8", "-height", "8",
                         "-frames", "2", "-output", OUT, "-bump",
                         "-texture-lod", "-exr", "-debug-switches", "133"])
assert load_exr(OUT + ".exr").shape == (8, 8, 3)
from gfxexp_torch.apps import tfdm as tfdm_app
from gfxexp_torch.bench import write_mesh_files
from gfxexp_torch.scene.builder import SceneBuilder
from gfxexp_torch.scene.loaders import load_mesh
hdr = tfdm_app.main(["-device", "cpu", "-width", "8", "-height", "8",
                     "-frames", "1", "-base-res", "3", "-heatmap",
                     "-output", OUT + "_tfdm"])
assert hdr.shape == (8, 8, 3) and np.isfinite(hdr).all()
assert load_png(OUT + "_tfdm_heatmap.png").shape == (8, 8, 3)
paths = write_mesh_files(os.path.join(os.path.dirname(OUT), "meshes"))
b = SceneBuilder()
assert [len(load_mesh(paths[k], b)) for k in ("obj", "ply", "glb",
                                               "gltf")] == [2, 1, 1, 1]
hdr = path_tracing.main(["-device", "cpu", "-width", "8", "-height", "8",
                         "-frames", "1", "-output", OUT,
                         "-obj", paths["obj"], "1.0", "-name", "lamp",
                         "-emittance", "9", "9", "9", "-sphere", "0.2"])
assert hdr.shape == (8, 8, 3) and np.isfinite(hdr).all()
from gfxexp_torch.apps import nrtdsm as nrtdsm_app
for extra in (["-heatmap"], ["-local-intersection", "two_triangle"],
              ["-shell", "-shell-obj", paths["obj"], "-shell-grid", "2"]):
    hdr = nrtdsm_app.main(["-device", "cpu", "-width", "8", "-height", "8",
                           "-frames", "1", "-base-res", "2", "-output",
                           OUT + "_nrtdsm", *extra])
    assert hdr.shape == (8, 8, 3) and np.isfinite(hdr).all()
assert load_png(OUT + "_nrtdsm_heatmap.png").shape == (8, 8, 3)
from gfxexp_torch.core.noise import multi_octave_perlin3d
from gfxexp_torch.core.interval import aa_to_iv, aa_var
from gfxexp_torch.scene.compile import compile_scene
assert bool(torch.isfinite(multi_octave_perlin3d(torch.rand(16, 3))).all())
assert aa_to_iv(aa_var(0.0, 1.0, 0, 1))[1] > 1.0
b = SceneBuilder()
lamp = b.add_lambert_material((0, 0, 0), emittance=(9.0, 9.0, 9.0))
cp = np.array([[0, 0, 0], [1, 1, 0], [2, 0, 0], [3, 1, 0]], np.float32)
b.add_instance(b.add_curve(cp, np.full(4, 0.2, np.float32), lamp))
b.add_curve(cp, np.full(4, 0.1, np.float32), lamp, curve_type="linear",
            direct=True)
b.add_curve(cp, np.full(4, 0.1, np.float32), lamp, direct=True)
scene, bvh = compile_scene(b)
img = render_sample(scene, bvh, bench_camera(8, 8), 8, 8, 0, PTConfig())
assert len(scene.displaced) == 2 and bool(torch.isfinite(img).all())
import gfxexp_torch.techniques.nrc  # noqa: F401
from gfxexp_torch.accel.bvh_build import BVH
from gfxexp_torch.accel.qrow import build_qrow
b = SceneBuilder()
b.add_instance(b.add_sphere(0.5, b.add_lambert_material((0.5, 0.5, 0.5))))
b.add_instance(b.add_rectangle(4.0, 4.0, lamp))
sw, wr = compile_scene(b, traversal="widerow", spatial_splits=True)
t = sw.triangles
_, perm, _ = build_qrow(t.p0.numpy(), t.e1.numpy(), t.e2.numpy(),
                        max_rows=24, spatial_splits=True)
assert len(perm) >= sw.num_triangles
scene, wide = compile_scene(b, traversal="wide")
assert isinstance(wide, BVH)
ref = render_sample(scene, wide, bench_camera(8, 8), 8, 8, 0, PTConfig())
for opt in ("sort_secondary_rays", "compact_rays"):
    img = render_sample(scene, wide, bench_camera(8, 8), 8, 8, 0,
                        PTConfig(**{opt: True}))
    assert torch.equal(img, ref)
import torch.distributed as dist
from gfxexp_torch.parallel import sharding
dist.init_process_group("gloo", init_method="file://" + OUT + "_rdv",
                        world_size=1, rank=0)
lanes = sharding.render_sample_sharded(sharding.make_mesh(), scene, wide,
                                       bench_camera(8, 8), 8, 8, 0)
dist.destroy_process_group()
from gfxexp_torch.render.camera import lane_from_pixel
assert torch.equal(lanes[lane_from_pixel(torch.arange(64), 8, 8)], ref)
from gfxexp_torch.utils.debug_draw import DebugDraw
from gfxexp_torch.utils.runtime import enable_compile_cache
from gfxexp_torch.utils.viewer import CameraRig, LiveViewer
v = LiveViewer(port=0)
v.update(np.ones((4, 4, 3), np.float32))
v.close()
assert CameraRig([0, 0, 2], [0, 0, 0]).apply([{"action": "dolly"}])
DebugDraw().aabb([0, 0, 0], [1, 1, 1]).save(OUT + ".ply")
assert os.path.isdir(enable_compile_cache())
hdr = path_tracing.main(["-device", "cpu", "-width", "8", "-height", "8",
                         "-frames", "1", "-output", OUT, "-live", "0",
                         "-spatial-splits"])
hdr = path_tracing.main(["-device", "cpu", "-width", "8", "-height", "8",
                         "-frames", "1", "-output", OUT, "-traversal",
                         "wide"])
assert hdr.shape == (8, 8, 3) and np.isfinite(hdr).all()
assert not any(m == "jax" or m.startswith(("jax.", "flax", "optax", "PIL"))
               for m in sys.modules if sys.modules[m] is not None)
print("OK", len(names))
"""


def test_package_imports_and_renders_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = _SCRIPT.replace("OUT", repr(str(tmp_path / "app")))
    out = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1].startswith("OK")
    assert int(out.stdout.splitlines()[-1].split()[1]) >= 28  # every module


def test_no_source_names_jax():
    offenders = []
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and (
                    words[1].split(".")[0] in ("jax", "flax", "optax", "PIL",
                                               "gfxexp_tpu")):
                offenders.append(f"{path}: {line.strip()}")
    assert not offenders, offenders
