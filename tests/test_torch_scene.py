"""gfxexp_torch's host build against gfxexp_tpu's: compile_scene with the
wide-row traversal (and "wide", and spatial splits) gives the same
structure, triangle order and light tables, and `from_numpy` carries JAX
objects into the port unchanged."""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch.bench import bench_scene_builder  # noqa: E402
from gfxexp_torch.render import camera as tcam  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.types import from_numpy  # noqa: E402
from gfxexp_tpu.render import camera as jcam  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(1)

SCENES = {
    "box": lambda mod: S.box_scene(mod),
    "furnace": lambda mod: S.furnace_scene(mod),
    "bench": lambda mod: bench_scene_builder(mod.SceneBuilder()),
}


def _bits(x):
    """Array bits for exact comparison (row tables hold int bit patterns
    that read as NaN floats)."""
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_tables_equal(jobj, tobj, name):
    for f in dataclasses.fields(tobj):
        tv = getattr(tobj, f.name)
        if tv is None or not isinstance(tv, torch.Tensor):
            continue
        jv = getattr(jobj, f.name)
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv),
                                      err_msg=f"{name}.{f.name}")


@pytest.fixture(scope="module")
def compiled():
    out = {}
    for key, make in SCENES.items():
        out[key] = (jcompile(make(JB), traversal="widerow"),
                    tcompile(make(TB), traversal="widerow"))
    return out


@pytest.mark.parametrize("key", list(SCENES))
def test_compile_scene_matches_jax(compiled, key):
    (js, jb), (ts, tb) = compiled[key]
    assert jb.nodes.shape[0] == 1
    np.testing.assert_array_equal(_bits(tb.nodes.numpy()), _bits(jb.nodes))
    assert (tb.arity, tb.width, tb.max_leaf, tb.max_depth) == (
        jb.arity, jb.width, jb.max_leaf, jb.max_depth)
    _assert_tables_equal(js.triangles, ts.triangles, "triangles")
    _assert_tables_equal(js.units, ts.units, "units")
    _assert_tables_equal(js.materials, ts.materials, "materials")
    _assert_tables_equal(js.instances, ts.instances, "instances")
    for f in ("light_unit_cdf", "light_unit_pmf", "light_unit_alias_prob",
              "light_unit_alias_idx", "total_emissive_importance"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("key", ["box", "furnace"])
def test_from_numpy_equals_port_build(compiled, key):
    (js, jb), (ts, tb) = compiled[key]
    fs = from_numpy(js)
    fb = from_numpy(jb)
    np.testing.assert_array_equal(_bits(fb.nodes.numpy()),
                                  _bits(tb.nodes.numpy()))
    assert fb.max_depth == tb.max_depth and fb.arity == tb.arity
    for part in ("triangles", "units", "materials", "instances"):
        _assert_tables_equal(getattr(fs, part), getattr(ts, part), part)
    assert (fs.env is None) == (ts.env is None)
    if fs.env is not None:
        np.testing.assert_array_equal(fs.env.radiance.numpy(),
                                      ts.env.radiance.numpy())
        np.testing.assert_allclose(fs.env.importance.pdf.numpy(),
                                   ts.env.importance.pdf.numpy(), rtol=1e-6)
        np.testing.assert_allclose(
            fs.env.importance.marginal_cdf.numpy(),
            ts.env.importance.marginal_cdf.numpy(), atol=1e-6)


def test_from_numpy_moves_with_to():
    scene, bvh = tcompile(S.box_scene(TB), traversal="widerow")
    moved = scene.to("cpu")
    assert moved.device == torch.device("cpu")
    assert moved.triangles.p0 is not None
    assert bvh.to("cpu").nodes.shape[-1] == 64


@pytest.mark.parametrize("w,h", [(64, 64), (48, 32), (20, 12), (1920, 1080)])
def test_lane_orders_match_jax(w, h):
    lane = np.arange(w * h, dtype=np.uint32)
    jp = np.asarray(jcam.pixel_from_lane(jnp.asarray(lane), w, h))
    tp = tcam.pixel_from_lane(torch.from_numpy(lane.astype(np.int64)), w, h)
    np.testing.assert_array_equal(tp.numpy(), jp.astype(np.int64))
    jl = np.asarray(jcam.lane_from_pixel(jnp.asarray(lane), w, h))
    tl = tcam.lane_from_pixel(torch.from_numpy(lane.astype(np.int64)), w, h)
    np.testing.assert_array_equal(tl.numpy(), jl.astype(np.int64))
    assert torch.equal(tcam.lane_from_pixel(tp, w, h),
                       torch.arange(w * h))


def test_primary_rays_match_jax():
    w, h = 40, 24
    rng = np.random.default_rng(0)
    jx, jy = rng.random((2, w * h), dtype=np.float32)
    jc = jcam.make_camera(**S.BOX_CAMERA | {"aspect": w / h})
    tc = from_numpy(jc)
    lane = np.arange(w * h)
    jo, jd = jcam.generate_rays_for_lanes(jc, w, h, jnp.asarray(lane),
                                          jnp.asarray(jx), jnp.asarray(jy))
    to, td = tcam.generate_rays_for_lanes(tc, w, h, torch.from_numpy(lane),
                                          torch.from_numpy(jx),
                                          torch.from_numpy(jy))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    # the port's own make_camera agrees with the JAX one
    own = tcam.make_camera(**S.BOX_CAMERA | {"aspect": w / h})
    np.testing.assert_allclose(own.orientation.numpy(),
                               np.asarray(jc.orientation), atol=1e-6)


@pytest.mark.parametrize("traversal,splits", [("wide", False),
                                               ("widerow", True),
                                               ("qrow", True)])
def test_unported_paths_raise(traversal, splits):
    """The paths that raised before the port had them ("wide", spatial
    splits) build what JAX builds: the structure and the scene's triangles
    and light tables, bit for bit."""
    js, jb = jcompile(S.instanced_spheres_scene(JB), traversal=traversal,
                      spatial_splits=splits)
    ts, tb = tcompile(S.instanced_spheres_scene(TB), traversal=traversal,
                      spatial_splits=splits)
    fields = (("child_min", "child_max", "child_idx", "child_count")
              if traversal == "wide" else ("nodes",))
    for f in fields:
        np.testing.assert_array_equal(_bits(getattr(tb, f).numpy()),
                                      _bits(getattr(jb, f)), err_msg=f)
    assert tb.max_depth == jb.max_depth
    for part, names in (("triangles", ("p0", "e1", "e2", "n0", "uv0",
                                       "unit_id")),
                        ("units", ("light_tri_index", "light_tri_pmf"))):
        for f in names:
            np.testing.assert_array_equal(
                _bits(getattr(getattr(ts, part), f).numpy()),
                _bits(getattr(getattr(js, part), f)), err_msg=f)
    with pytest.raises(ValueError, match="traversal"):
        tcompile(S.box_scene(TB), traversal="bogus")
