"""gfxexp_torch's two-level (instanced) host build against gfxexp_tpu's:
build_instanced (with and without rebraiding) and
compile_scene(traversal="instanced") give bit-identical tables, and
`from_numpy` carries JAX's instanced scene and InstancedAccel into the port
unchanged."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch import bench  # noqa: E402
from gfxexp_torch.accel.instanced import InstancedAccel  # noqa: E402
from gfxexp_torch.accel.instanced import (  # noqa: E402
    build_instanced as t_build,
)
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.types import from_numpy  # noqa: E402
from gfxexp_tpu.accel.pallas_widestack import (  # noqa: E402
    build_instanced as j_build,
)
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(1)


def _bits(x):
    """Array bits for exact comparison (row tables hold int bit patterns
    that read as NaN floats)."""
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_equal(jobj, tobj, name):
    """Every field of a port container equals the JAX object's, bit for
    bit (None where JAX has None)."""
    for f in dataclasses.fields(tobj):
        tv = getattr(tobj, f.name)
        jv = getattr(jobj, f.name, None)
        if isinstance(tv, torch.Tensor):
            assert jv is not None, f"{name}.{f.name}"
            np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv),
                                          err_msg=f"{name}.{f.name}")
        elif dataclasses.is_dataclass(tv):
            _assert_equal(jv, tv, f"{name}.{f.name}")
        elif tv is None:
            assert jv is None, f"{name}.{f.name}"
        else:
            assert tv == jv, f"{name}.{f.name}: {tv} != {jv}"


@pytest.mark.parametrize("key", ["two_blas", "grazing", "rebraid"])
def test_build_instanced_matches_jax(key):
    geoms, inst, rebraid, _, _ = S.instanced_walk_cases()[key]
    jacc, jperms = j_build(geoms, inst, rebraid=rebraid)
    tacc, tperms = t_build(geoms, inst, rebraid=rebraid)
    _assert_equal(jacc, tacc, "acc")
    for jp, tp in zip(jperms, tperms):
        np.testing.assert_array_equal(np.asarray(jp), tp)
    if rebraid:
        assert tacc.num_entries > len(inst)  # subtrees were opened
        assert tacc.start_rows is not None
    else:
        assert tacc.start_rows is None and tacc.num_entries == len(inst)


SCENES = {
    "spheres": lambda mod: S.instanced_spheres_scene(mod),
    "big": lambda mod: bench.bench_scene_builder(mod.SceneBuilder(), "big"),
}


@pytest.fixture(scope="module")
def compiled():
    return {key: (jcompile(make(JB), traversal="instanced"),
                  tcompile(make(TB), traversal="instanced"))
            for key, make in SCENES.items()}


@pytest.mark.parametrize("key", list(SCENES))
def test_compile_instanced_matches_jax(compiled, key):
    (js, jacc), (ts, tacc) = compiled[key]
    assert ts.is_instanced and js.is_instanced
    _assert_equal(jacc, tacc, "acc")
    for part in ("triangles", "units", "materials", "instances"):
        _assert_equal(getattr(js, part), getattr(ts, part), part)
    for f in ("light_unit_cdf", "light_unit_pmf", "light_unit_alias_prob",
              "light_unit_alias_idx", "total_emissive_importance",
              "inst_unit_base", "unit_tri_base", "tri_light_local"):
        np.testing.assert_array_equal(_bits(getattr(ts, f).numpy()),
                                      _bits(getattr(js, f)), err_msg=f)
    # instancing shares geometry: the spheres' triangles are stored once
    assert ts.num_triangles < SCENES[key](TB).compile().num_triangles


def test_compile_instanced_rebraid_matches_jax():
    (js, jacc) = jcompile(S.instanced_spheres_scene(JB),
                          traversal="instanced", rebraid=4.0)
    (ts, tacc) = tcompile(S.instanced_spheres_scene(TB),
                          traversal="instanced", rebraid=4.0)
    _assert_equal(jacc, tacc, "acc")
    assert tacc.num_entries > len(tacc.inst_of_chunk.unique())


def test_from_numpy_equals_port_build(compiled):
    (js, jacc), (ts, tacc) = compiled["spheres"]
    fs, fa = from_numpy(js), from_numpy(jacc)
    assert isinstance(fa, InstancedAccel) and fs.is_instanced
    _assert_equal(fa, tacc, "acc")
    for part in ("triangles", "units", "materials", "instances"):
        _assert_equal(getattr(fs, part), getattr(ts, part), part)
    for f in ("inst_unit_base", "unit_tri_base", "tri_light_local"):
        assert torch.equal(getattr(fs, f), getattr(ts, f)), f
    moved = fa.to("cpu")
    assert moved.nodes.shape == tacc.nodes.shape and not moved.use_tlas


def test_width_other_than_64_raises(compiled):
    """The JAX package walks a stale width-32 InstancedAccel as 64-wide
    rows; the port refuses it."""
    (_, jacc), (_, tacc) = compiled["spheres"]
    with pytest.raises(ValueError, match="64"):
        dataclasses.replace(tacc, width=32)
    with pytest.raises(ValueError, match="64"):
        from_numpy(jacc.replace(width=32))
