"""SBVH spatial splits in the port (gfxexp_torch/accel/bvh_build.py,
native.py, widerow.py, qrow.py, scene/compile.py) against gfxexp_tpu.

Bars: the builds (numpy and native, the wide-row and quantized tables, one
table and chunked) equal JAX's bit for bit: perms, child arrays, rows,
chunk boxes, dequantized vertices, max_depth. The plain versions of kernel 1
(walk_plain) and kernel 7 (walk_qrow_plain) agree with brute force over the
duplicated soup: hits equal, t within rtol 5e-4 (wide rows) and 1e-3
(quantized rows), and the source triangle perm[tri] equal except where the
two t tie within that rtol. Brute force is Moller-Trumbore; the wide rows
test a triangle through its plane and edge planes baked in float32 (4e-4
of t seen on this soup's long slivers), and the quantized walk
dequantizes in float32 (tests/test_torch_qrow.py; 5.3e-4 seen).
`light_tri_index` and `light_tri_pmf` equal JAX's on a scene whose emitter
is split. A 16x16 render with spatial splits matches JAX's (its
wide-row kernel in interpret mode): mean relative difference < 5e-3, ray
counts equal.
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
from gfxexp_torch.accel import bvh_build as tbb  # noqa: E402
from gfxexp_torch.accel import native as tnative  # noqa: E402
from gfxexp_torch.accel.persistent import walk_plain  # noqa: E402
from gfxexp_torch.accel.qrow import build_qrow as t_qrow  # noqa: E402
from gfxexp_torch.accel.qrow import walk_qrow_plain  # noqa: E402
from gfxexp_torch.accel.traverse import intersect_closest_brute  # noqa: E402
from gfxexp_torch.accel.widerow import build_widerow as t_widerow  # noqa
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_tpu.accel import bvh_build as jbb  # noqa: E402
from gfxexp_tpu.accel.pallas_qrow import build_qrow as j_qrow  # noqa: E402
from gfxexp_tpu.accel.pallas_widestack import (  # noqa: E402
    build_widerow as j_widerow,
)
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.render.camera import make_camera as j_camera  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(2)


def _bits(x):
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _diagonals(seed=0, n_long=60, n_soup=140):
    """tests/test_accel.py's SBVH soup: long thin diagonal triangles across
    the scene (what object splits handle badly) and a local soup. Returns
    (p0, e1, e2) float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-4, 4, size=(n_long, 3))
    d = rng.normal(size=(n_long, 3))
    d = 6.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    w = rng.normal(scale=0.05, size=(n_long, 3))
    c = rng.uniform(-4, 4, size=(n_soup, 3))
    s = [c + rng.normal(scale=0.4, size=(n_soup, 3)) for _ in range(3)]
    p0 = np.concatenate([a, s[0]]).astype(np.float32)
    p1 = np.concatenate([a + d, s[1]]).astype(np.float32)
    p2 = np.concatenate([a + d * 0.5 + w, s[2]]).astype(np.float32)
    return p0, p1 - p0, p2 - p0


def _check_bvh(tb, tperm, jb, jperm):
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    for f in ("child_min", "child_max", "child_idx", "child_count"):
        np.testing.assert_array_equal(_bits(getattr(tb, f).numpy()),
                                      _bits(getattr(jb, f)), err_msg=f)
    assert (tb.max_depth, tb.arity, tb.max_leaf) == (
        jb.max_depth, jb.arity, jb.max_leaf)


@pytest.mark.parametrize("use_native", [False, True])
def test_sbvh_build_bit_identical_to_jax(use_native):
    """The numpy SBVH (float64, tests/test_accel.py's 200 triangles) and
    the native one (native/bvh_builder.cpp, shared) equal JAX's; both
    duplicate references."""
    if use_native:
        assert tnative.native_available()
    soup = _diagonals()
    jb, jperm = jbb.build_bvh(*soup, arity=4, use_native=use_native,
                              spatial_splits=True)
    tb, tperm = tbb.build_bvh(*soup, arity=4, use_native=use_native,
                              spatial_splits=True)
    assert tperm.shape[0] > soup[0].shape[0], "no spatial split fired"
    _check_bvh(tb, tperm, jb, jperm)
    # without splits the perm is a permutation
    tb0, tperm0 = tbb.build_bvh(*soup, arity=4, use_native=use_native)
    assert np.array_equal(np.sort(tperm0), np.arange(soup[0].shape[0]))


def test_sbvh_arrays_bit_identical_to_jax():
    """build_bvh_arrays(verts=...) and the native binding directly, on a
    wider soup at arity 8."""
    p0, e1, e2 = _diagonals(seed=5, n_long=80, n_soup=160)
    p1, p2 = p0 + e1, p0 + e2
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    from gfxexp_tpu.accel import native as jnative

    t = tnative.build_bvh_arrays_native_sbvh(lo, hi, (p0, p1, p2), arity=8)
    j = jnative.build_bvh_arrays_native_sbvh(lo, hi, (p0, p1, p2), arity=8)
    assert t[4].shape[0] > p0.shape[0]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    t = tbb.build_bvh_arrays(lo, hi, arity=8, verts=(p0, p1, p2))
    j = jbb.build_bvh_arrays(lo, hi, arity=8, verts=(p0, p1, p2))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("max_rows", [13000, 40])
def test_widerow_sbvh_bit_identical_to_jax(max_rows):
    """One table built with splits; chunked (max_rows 40) the chunks build
    without them, in both packages."""
    soup = _diagonals(seed=1)
    jw, jperm = j_widerow(*soup, spatial_splits=True, max_rows=max_rows)
    tw, tperm = t_widerow(*soup, spatial_splits=True, max_rows=max_rows)
    assert (tw.num_chunks >= 3) == (max_rows == 40)
    assert (tperm.shape[0] > soup[0].shape[0]) == (max_rows == 13000)
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    np.testing.assert_array_equal(_bits(tw.nodes.numpy()), _bits(jw.nodes))
    assert tw.max_depth == jw.max_depth
    if max_rows == 40:
        for f in ("chunk_lo", "chunk_hi"):
            np.testing.assert_array_equal(_bits(getattr(tw, f).numpy()),
                                          _bits(getattr(jw, f)))


@pytest.mark.parametrize("max_rows", [26000, 24])
def test_qrow_sbvh_bit_identical_to_jax(max_rows):
    """The quantized table with splits, one table and chunked: at max_rows
    24 every chunk is an SBVH, so from the second chunk on the leaves name
    triangles past the chunk's range (a chunk's first triangle is the sum
    of the earlier chunks' references)."""
    soup = _diagonals(seed=2)
    jq, jperm, jdq = j_qrow(*soup, spatial_splits=True, max_rows=max_rows)
    tq, tperm, tdq = t_qrow(*soup, spatial_splits=True, max_rows=max_rows)
    assert tperm.shape[0] > soup[0].shape[0]
    assert (tq.num_chunks >= 3) == (max_rows == 24)
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    np.testing.assert_array_equal(_bits(tq.nodes.numpy()), _bits(jq.nodes))
    for a, b in zip(tdq, jdq):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert tq.max_depth == jq.max_depth
    if max_rows == 24:
        for f in ("chunk_lo", "chunk_hi"):
            np.testing.assert_array_equal(_bits(getattr(tq, f).numpy()),
                                          _bits(getattr(jq, f)))


def _rays(seed, soup, n=400):
    return tuple(torch.from_numpy(x) for x in S.aimed_rays(
        np.random.default_rng(seed), n, *soup, box=6.0))


def _tsoa(p0, e1, e2):
    import types

    return types.SimpleNamespace(p0=torch.from_numpy(np.asarray(p0)),
                                 e1=torch.from_numpy(np.asarray(e1)),
                                 e2=torch.from_numpy(np.asarray(e2)),
                                 count=p0.shape[0])


def _check_brute(h, ref, perm, rtol):
    assert torch.equal(h.hit, ref.hit) and int(ref.hit.sum()) > 100
    m = ref.hit
    np.testing.assert_allclose(h.t[m].numpy(), ref.t[m].numpy(), rtol=rtol)
    src = perm[h.tri[m].numpy()]
    src_ref = perm[ref.tri[m].numpy()]
    tie = (h.t[m] - ref.t[m]).abs() <= rtol * ref.t[m]
    assert ((src == src_ref) | tie.numpy()).all()


@pytest.mark.parametrize("fmt", ["widerow", "qrow_chunked"])
def test_plain_walks_match_brute_over_the_duplicated_soup(fmt):
    """Kernel 1's plain walk over an SBVH wide-row table and kernel 7's
    over a chunked SBVH quantized table (duplicates in every chunk),
    closest and any hit, against brute force over the duplicated soup."""
    soup = _diagonals(seed=3)
    o, d = _rays(4, soup)
    if fmt == "widerow":
        bvh, perm = t_widerow(*soup, spatial_splits=True)
        assert bvh.num_chunks == 1
        dup = tuple(x[perm] for x in soup)
        h = walk_plain(bvh, o, d, 1e-4, 1e30, any_hit=False)
        a = walk_plain(bvh, o, d, 1e-4, 1e30, any_hit=True)
        rtol = 5e-4
    else:
        bvh, perm, dup = t_qrow(*soup, spatial_splits=True, max_rows=24)
        assert bvh.num_chunks >= 3
        h = walk_qrow_plain(bvh, o, d, 1e-4, 1e30, any_hit=False)
        a = walk_qrow_plain(bvh, o, d, 1e-4, 1e30, any_hit=True)
        rtol = 1e-3
    assert perm.shape[0] > soup[0].shape[0]
    ref = intersect_closest_brute(_tsoa(*dup), o, d)
    _check_brute(h, ref, perm, rtol)
    assert torch.equal(a.hit, ref.hit)


@pytest.fixture(scope="module")
def split_scene():
    """The box with three spheres, flattened, compiled as wide rows with
    spatial splits by both packages: its lamp's two triangles are split."""
    js, jb = jcompile(S.instanced_spheres_scene(JB), traversal="widerow",
                      spatial_splits=True)
    ts, tb = tcompile(S.instanced_spheres_scene(TB), traversal="widerow",
                      spatial_splits=True)
    return js, jb, ts, tb


def test_light_tri_index_matches_jax(split_scene):
    js, jb, ts, tb = split_scene
    plain, _ = tcompile(S.instanced_spheres_scene(TB), traversal="widerow")
    assert ts.triangles.p0.shape[0] > plain.triangles.p0.shape[0]
    np.testing.assert_array_equal(_bits(tb.nodes.numpy()), _bits(jb.nodes))
    units, junits = ts.units, js.units
    np.testing.assert_array_equal(units.light_tri_index.numpy(),
                                  np.asarray(junits.light_tri_index))
    np.testing.assert_array_equal(_bits(units.light_tri_pmf.numpy()),
                                  _bits(junits.light_tri_pmf))
    # the lamp was split: its triangles have copies

    def emissive(scene):
        mat = scene.units.material[scene.triangles.unit_id.long()].long()
        return int((scene.materials.emittance[mat].sum(-1) > 0).sum())

    assert emissive(ts) > emissive(plain)
    for f in ("p0", "e1", "e2", "n0", "uv0", "unit_id"):
        np.testing.assert_array_equal(
            _bits(getattr(ts.triangles, f).numpy()),
            _bits(getattr(js.triangles, f)), err_msg=f)


def test_render_with_spatial_splits_matches_jax(split_scene):
    js, jb, ts, tb = split_scene
    cam = S.INSTANCED_CAMERA
    cfg = dict(max_path_length=2, count_rays=True)
    jimg, jnr = jpt.render_sample(js, jb, j_camera(**cam), 16, 16,
                                  jnp.uint32(1), jpt.PTConfig(**cfg))
    img, nr = tpt.render_sample(ts, tb, make_camera(**cam), 16, 16, 1,
                                tpt.PTConfig(**cfg))
    assert torch.isfinite(img).all() and float(img.mean()) > 0
    assert S.image_rel_diff(img.numpy(), np.asarray(jimg)) < 5e-3
    assert float(nr) == float(jnr)
