"""The port's mesh loaders (scene/loaders.py), SceneBuilder.add_geometry,
compute_smooth_normals and the DSL's -obj (apps/common.py) against
gfxexp_tpu's on the same files, written here (the repository holds no mesh
asset): a torus as OBJ + MTL in both material conventions (a PNG diffuse
map, and a variant with a BC1 DDS diffuse map and a PNG bump map), as
binary and ASCII PLY with vertex colours, as glTF JSON with a data-URI
buffer and as GLB, both with TRS and matrix nodes (bench.write_mesh_files).

Bars: every geometry (positions, normals, texcoords, indices, material),
material, instance transform and atlas image bit-equal; the compiled mesh
scene's tables bit-equal, and equal through from_numpy. -obj PATH SCALE
CONVENTION builds equal scenes in both packages; -obj PATH SCALE followed
by another option keeps that option in the port, where the JAX DSL
consumes it (it loses the next -name and the OBJ's group is overwritten).
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch import bench  # noqa: E402
from gfxexp_torch.apps import common as tcommon  # noqa: E402
from gfxexp_torch.scene import loaders as TL  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.types import from_numpy  # noqa: E402
from gfxexp_tpu.apps import common as jcommon  # noqa: E402
from gfxexp_tpu.scene import loaders as JL  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("meshes"))
    paths = bench.write_mesh_files(d)
    # an MTL variant: a BC1 DDS diffuse map and a PNG bump map
    rng = np.random.default_rng(4)
    bench._write_dds(os.path.join(d, "kd.dds"),
                     rng.integers(0, 256, 4 * 4 * 8, np.uint8).tobytes(),
                     16, 16, fourcc=b"DXT1")
    with open(paths["mtl"]) as f:
        mtl = f.read().replace(os.path.basename(paths["png"]), "kd.dds")
    mtl = mtl.replace("newmtl shiny\n", "newmtl shiny\nmap_Bump "
                      + os.path.basename(paths["png"]) + "\n")
    with open(os.path.join(d, "torus_dds.mtl"), "w") as f:
        f.write(mtl)
    with open(paths["obj"]) as f:
        obj = f.read().replace(os.path.basename(paths["mtl"]),
                               "torus_dds.mtl")
    paths["obj_dds"] = os.path.join(d, "torus_dds.obj")
    with open(paths["obj_dds"], "w") as f:
        f.write(obj)
    return paths


def _assert_builders_equal(jb, tb):
    assert len(jb.geometries) == len(tb.geometries)
    for k, (a, b) in enumerate(zip(jb.geometries, tb.geometries)):
        for f in ("positions", "normals", "texcoords", "indices"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=f"geometry {k}.{f}")
            assert getattr(b, f).dtype == getattr(a, f).dtype
        assert a.material == b.material
    assert len(jb.materials) == len(tb.materials)
    for k, (a, b) in enumerate(zip(jb.materials, tb.materials)):
        for f in dataclasses.fields(a):
            if hasattr(b, f.name):
                assert np.array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name))), (
                    f"material {k}.{f.name}")
    assert len(jb.instances) == len(tb.instances)
    for a, b in zip(jb.instances, tb.instances):
        assert a.geometries == b.geometries
        np.testing.assert_array_equal(b.transform, a.transform)
    assert len(jb.atlas.images) == len(tb.atlas.images)
    for a, b in zip(jb.atlas.images, tb.atlas.images):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


MESH_CASES = {
    "obj_trad": ("obj", {}),
    "obj_simple_pbr": ("obj", {"material_convention": "simple_pbr"}),
    "obj_dds_trad": ("obj_dds", {}),
    "obj_dds_simple_pbr": ("obj_dds", {"material_convention": "simple_pbr"}),
    "ply_binary": ("ply", {}),
    "ply_ascii": ("ply_ascii", {}),
    "gltf_data_uri": ("gltf", {}),
    "glb": ("glb", {}),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_file_matches_jax(files, case):
    kind, kw = MESH_CASES[case]
    jb, tb = JB.SceneBuilder(), TB.SceneBuilder()
    jg = JL.load_mesh(files[kind], jb, **kw)
    tg = TL.load_mesh(files[kind], tb, **kw)
    assert tg == jg and len(tg) >= 1
    _assert_builders_equal(jb, tb)
    if kind.startswith("obj"):
        # two MTL materials, one with a diffuse map (and, in the DDS
        # variant, one with a bump map)
        assert len(tb.materials) == 2 and tb.materials[0].diffuse_tex == 0
        assert (tb.materials[1].normal_tex >= 0) == (kind == "obj_dds")
    if kind in ("gltf", "glb"):
        assert len(tb.instances) == 3  # TRS root, matrix child, matrix root


def test_load_mesh_dispatch_and_errors(files, tmp_path):
    for mod, b in ((JL, JB.SceneBuilder()), (TL, TB.SceneBuilder())):
        with pytest.raises(ValueError):
            mod.load_mesh(str(tmp_path / "mesh.stl"), b)
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply\n")
    with pytest.raises(ValueError):
        TL.load_ply(str(bad), TB.SceneBuilder())
    # a material given to load_ply is used as is
    b = TB.SceneBuilder()
    m = b.add_lambert_material((0.1, 0.2, 0.3))
    (g,) = TL.load_ply(files["ply"], b, material=m)
    assert b.geometries[g].material == m and len(b.materials) == 1


def test_add_geometry_and_smooth_normals_match_jax():
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(40, 3)).astype(np.float32)
    idx = rng.integers(0, 40, (60, 3)).astype(np.int32)
    np.testing.assert_array_equal(TB.compute_smooth_normals(pos, idx),
                                  JB.compute_smooth_normals(pos, idx))
    nrm = rng.normal(size=(40, 3))
    uv = rng.random((40, 2))
    for kw in ({}, {"normals": nrm}, {"texcoords": uv},
               {"normals": nrm, "texcoords": uv}):
        jb, tb = JB.SceneBuilder(), TB.SceneBuilder()
        assert jb.add_geometry(pos, idx, 0, **kw) == tb.add_geometry(
            pos, idx, 0, **kw) == 0
        _assert_builders_equal(jb, tb)


def _bits(x):
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_tensors_equal(jobj, tobj, name):
    for f in dataclasses.fields(tobj):
        tv = getattr(tobj, f.name)
        if isinstance(tv, torch.Tensor):
            np.testing.assert_array_equal(
                _bits(tv.numpy()), _bits(getattr(jobj, f.name)),
                err_msg=f"{name}.{f.name}")


def test_mesh_scene_compiles_like_jax(tmp_path):
    js, jbvh = jcompile(bench.mesh_scene_builder(
        JB.SceneBuilder(), str(tmp_path / "j")), traversal="widerow")
    ts, tbvh = tcompile(bench.mesh_scene_builder(
        TB.SceneBuilder(), str(tmp_path / "t")), traversal="widerow")
    np.testing.assert_array_equal(_bits(tbvh.nodes.numpy()),
                                  _bits(jbvh.nodes))
    fs = from_numpy(js)
    for name in ("triangles", "units", "materials", "instances"):
        _assert_tensors_equal(getattr(js, name), getattr(ts, name), name)
        _assert_tensors_equal(getattr(js, name), getattr(fs, name), name)
    assert ts.num_units == 6 and ts.displaced is None and fs.displaced is None


def _dsl_args():
    return types.SimpleNamespace(texture_lod=False, env_texture=None)


@pytest.mark.parametrize("convention", ["trad", "simple_pbr"])
def test_dsl_obj_with_convention_matches_jax(files, convention):
    argv = ["-name", "torus", "-obj", files["obj"], "1.5", convention,
            "-name", "lamp", "-emittance", "30", "30", "30", "-sphere",
            "0.2", "-inst", "torus", "-inst", "lamp", "-position", "0", "2",
            "0"]
    jb, _ = jcommon.build_scene_from_dsl(_dsl_args(), argv)
    tb, _ = tcommon.build_scene_from_dsl(_dsl_args(), argv)
    _assert_builders_equal(jb, tb)
    assert len(tb.instances) == 2 and len(tb.geometries) == 3
    js, _ = jcompile(jb, traversal="widerow")
    ts, _ = tcompile(tb, traversal="widerow")
    _assert_tensors_equal(js.materials, ts.materials, "materials")
    _assert_tensors_equal(js.triangles, ts.triangles, "triangles")


def test_dsl_obj_without_convention_keeps_next_option(files):
    """-obj PATH SCALE and then -name: the JAX DSL steps over three words
    and its loop a fourth, so `-name lamp` is lost and the sphere lands in
    the OBJ's "unnamed" group, replacing it (one instance); the port keeps
    -name and builds both groups."""
    argv = ["-obj", files["obj"], "1.0", "-name", "lamp", "-emittance", "1",
            "1", "1", "-sphere", "0.2"]
    jb, _ = jcommon.build_scene_from_dsl(_dsl_args(), argv)
    tb, _ = tcommon.build_scene_from_dsl(_dsl_args(), argv)
    assert len(jb.geometries) == len(tb.geometries) == 3
    assert len(jb.instances) == 1 and jb.instances[0].geometries == [2]
    assert len(tb.instances) == 2
    assert sorted(g for i in tb.instances for g in i.geometries) == [0, 1, 2]
    lamp = [i for i in tb.instances if i.geometries == [2]]
    assert len(lamp) == 1
    assert tb.materials[tb.geometries[2].material].emittance == (1.0, 1.0,
                                                                 1.0)
