"""The port's core toolkit against gfxexp_tpu's, on the CPU: core/math.py
(vectors, octahedral normals, transforms, AABBs, sampling, MIS, colour),
the discrete and alias distributions, uniform4 and SampleStream.next3,
generate_rays, SimplePBR materials, num_nodes and has_emissive, the
wide-row pack and routing predicates, and the NRC loss and constants.

Every comparison states its tolerance. Bit for bit where both packages do
the same elementwise float32 arithmetic in the same order; a bound in ulps
(or an absolute bound on unit-scale values) where an op is computed by
another routine (XLA's sin, cos, pow, tan and rsqrt against PyTorch's; a
3x3 product XLA contracts with FMAs); and for a CDF, which every backend's
prefix sum rounds in its own order, a bound in ulps with sampled indices
equal wherever the uniform lies more than a few ulps from an edge. The
statistical cases of tests/test_core.py run on the port as well."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch.accel import bvh_build as tbvh  # noqa: E402
from gfxexp_torch.accel import instanced as tinst  # noqa: E402
from gfxexp_torch.accel import persistent as tpers  # noqa: E402
from gfxexp_torch.accel import widerow as twr  # noqa: E402
from gfxexp_torch.core import distributions as tdist  # noqa: E402
from gfxexp_torch.core import math as tm  # noqa: E402
from gfxexp_torch.core import rng as trng  # noqa: E402
from gfxexp_torch.render import camera as tcam  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.types import TriangleSoA, from_numpy  # noqa: E402
from gfxexp_torch.techniques.nrc import encoding as tenc  # noqa: E402
from gfxexp_torch.techniques.nrc import network as tnet  # noqa: E402
from gfxexp_tpu.accel import bvh_build as jbvh  # noqa: E402
from gfxexp_tpu.accel import pallas_persistent as jpers  # noqa: E402
from gfxexp_tpu.accel import pallas_persistent_inst as jpinst  # noqa: E402
from gfxexp_tpu.accel import pallas_widestack as jws  # noqa: E402
from gfxexp_tpu.core import distributions as jdist  # noqa: E402
from gfxexp_tpu.core import math as jm  # noqa: E402
from gfxexp_tpu.core import rng as jrng  # noqa: E402
from gfxexp_tpu.render import camera as jcam  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402
from gfxexp_tpu.techniques.nrc import encoding as jenc  # noqa: E402
from gfxexp_tpu.techniques.nrc import network as jnet  # noqa: E402

torch.set_num_threads(1)
N = 4096


def _ulps(a, b):
    """Distance in float32 ulps of same-signed values (bit patterns)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)
    b = np.ascontiguousarray(np.asarray(b, np.float32)).view(np.int32)
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


def _inputs():
    r = np.random.default_rng(17)
    f = np.float32
    v = r.normal(size=(N, 3)).astype(f)
    unit = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(f)
    lo = (r.normal(size=(N, 3)) - 0.5).astype(f)
    d = r.normal(size=(N, 3)).astype(f)
    d[:8, 0] = 0.0  # a zero component: an infinite inverse
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(f)
    pdf = r.random((2, N)).astype(f)
    pdf[:, :4] = 0.0  # (0, 0) and (0, b), (a, 0) pairs
    pdf[1, 4:8] = 0.0
    colour = (r.random((N, 3)) * 4.0).astype(f)
    srgb = r.random(N).astype(f)
    srgb[:4] = [0.0, 0.04045, 0.0405, 1.0]  # both branches and the knee
    return dict(
        v=v, n=unit, o=r.normal(size=(N, 3)).astype(f), inv=inv, lo=lo,
        hi=lo + r.random((N, 3)).astype(f), lo2=lo + 0.3, hi2=lo + 0.9,
        tmin=r.random(N).astype(f) * 0.1,
        a=r.normal(size=(64, 3, 4)).astype(f),
        b=r.normal(size=(64, 3, 4)).astype(f), pdf=pdf, colour=colour,
        srgb=srgb, u0=r.random(N).astype(f), u1=r.random(N).astype(f),
        axis=r.normal(size=(64, 3)).astype(f),
        angle=(r.random(64) * 6.0).astype(f))


X = _inputs()

# name -> (call on a module `m` with inputs made by `a`, tolerance): "bits"
# (bit for bit), ("ulps", k), ("abs", x)
MATH_CASES = {
    "sq_length": (lambda m, a: m.sq_length(a("v")), "bits"),
    "reflect": (lambda m, a: m.reflect(a("v"), a("n")), "bits"),
    "octahedral_encode": (lambda m, a: m.octahedral_encode(a("n")), "bits"),
    # normalize: XLA's rsqrt against 1 / sqrt, 3 ulps measured
    "octahedral_decode": (lambda m, a: m.octahedral_decode(
        m.octahedral_encode(a("n"))), ("ulps", 4)),
    "identity_transform": (lambda m, a: m.identity_transform(), "bits"),
    "make_transform": (lambda m, a: m.make_transform(
        rotation=X["a"][0, :, :3], translation=[1.0, 2.0, 3.0],
        scale=[2.0, 0.5, 3.0]), "bits"),
    "make_transform_scalar_scale": (lambda m, a: m.make_transform(
        scale=2.0), "bits"),
    # XLA contracts the 3x3 products with FMAs: 4.8e-7 measured on values
    # up to ~10
    "compose_transforms": (lambda m, a: m.compose_transforms(a("a"), a("b")),
                           ("abs", 2e-6)),
    # sin and cos of XLA against PyTorch's
    "axis_angle_quaternion": (lambda m, a: m.axis_angle_quaternion(
        a("axis"), a("angle")), ("abs", 1e-6)),
    "look_at": (lambda m, a: m.look_at([0.0, 1.0, 2.0], [0.3, 0.0, -1.0],
                                       [0.0, 1.0, 0.0]), ("abs", 1e-6)),
    "aabb_union": (lambda m, a: m.aabb_union(a("lo"), a("hi"), a("lo2"),
                                             a("hi2")), "bits"),
    "aabb_surface_area": (lambda m, a: m.aabb_surface_area(a("lo"),
                                                           a("hi")), "bits"),
    "ray_aabb_intersect": (lambda m, a: m.ray_aabb_intersect(
        a("o"), a("inv"), a("tmin"), 1e30, a("lo"), a("hi")), "bits"),
    "ray_aabb_intersect_scalar_t": (lambda m, a: m.ray_aabb_intersect(
        a("o"), a("inv"), 0.0, 2.0, a("lo"), a("hi")), "bits"),
    # sin and cos: 3 ulps (9e-8) measured on the unit vectors
    "uniform_sample_sphere": (lambda m, a: m.uniform_sample_sphere(
        a("u0"), a("u1")), ("abs", 1e-6)),
    "power_heuristic": (lambda m, a: m.power_heuristic(a("pdf")[0],
                                                       a("pdf")[1]), "bits"),
    # pow: 1 ulp measured
    "srgb_to_linear": (lambda m, a: m.srgb_to_linear(a("srgb")),
                       ("ulps", 2)),
    "simple_tonemap": (lambda m, a: m.simple_tonemap(a("colour")), "bits"),
}


def _flat(out):
    return [np.asarray(x) for x in (out if isinstance(out, tuple)
                                    else (out,))]


@pytest.mark.parametrize("name", list(MATH_CASES))
def test_math_matches_jax(name):
    fn, tol = MATH_CASES[name]
    ref = _flat(fn(jm, lambda k: jnp.asarray(X[k])))
    got = _flat(fn(tm, lambda k: torch.from_numpy(X[k])))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, r.shape)
        if tol == "bits" or r.dtype == bool:
            np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8))
        elif tol[0] == "ulps":
            assert _ulps(g, r).max() <= tol[1], _ulps(g, r).max()
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=tol[1])


def test_functions_follow_their_inputs_device():
    """A tensor argument sets the device of what is made from Python values;
    identity_transform and make_transform take one, None for torch's
    default."""
    meta = torch.device("meta")
    assert tm.identity_transform(meta).device == meta
    assert tm.make_transform(translation=torch.zeros(3, device=meta),
                             scale=2.0).device == meta
    assert tm.make_transform(rotation=np.eye(3), device=meta).device == meta
    assert tm.look_at(torch.zeros(3, device=meta), [0.0, 0.0, -1.0],
                      [0.0, 1.0, 0.0]).device == meta
    assert tm.axis_angle_quaternion(torch.ones(3, device=meta),
                                    0.5).device == meta


def _stat_octahedral():
    n = torch.from_numpy(X["n"])
    back = tm.octahedral_decode(tm.octahedral_encode(n))
    np.testing.assert_allclose(back.numpy(), X["n"], atol=1e-5)


def _stat_transforms():
    q = tm.axis_angle_quaternion([0.3, 1.0, -0.2], 0.7)
    r = tm.quaternion_to_matrix(q)
    np.testing.assert_allclose((r @ r.T).numpy(), np.eye(3), atol=1e-5)
    m = tm.make_transform(rotation=r, translation=[1.0, 2.0, 3.0], scale=2.0)
    mi = tm.invert_transform(m)
    p = torch.from_numpy(X["v"][:16])
    back = tm.transform_point(mi, tm.transform_point(m, p))
    np.testing.assert_allclose(back.numpy(), p.numpy(), atol=1e-4)
    np.testing.assert_allclose(tm.compose_transforms(mi, m).numpy(),
                               tm.identity_transform().numpy(), atol=1e-5)
    # b first, then a
    both = tm.transform_point(tm.compose_transforms(m, mi), p)
    np.testing.assert_allclose(both.numpy(), p.numpy(), atol=1e-4)
    # look_at's columns: right, up, -forward
    la = tm.look_at([0.0, 0.0, 0.0], [0.0, 0.0, -5.0], [0.0, 1.0, 0.0])
    np.testing.assert_allclose(la.numpy(), np.eye(3), atol=1e-7)


def _stat_cosine_hemisphere():
    u0, u1, _, _ = trng.uniform4(torch.arange(200_000), 0, 0, 0)
    d = tm.cosine_sample_hemisphere(u0, u1)
    z = d[..., 2].numpy()
    assert abs(z.mean() - 2.0 / 3.0) < 5e-3 and (z >= 0).all()
    np.testing.assert_allclose(torch.linalg.norm(d, dim=-1).numpy(), 1.0,
                               atol=1e-5)


def _stat_uniform4():
    draws = trng.uniform4(torch.arange(100_000), 7, 13, 1)
    for x in draws:
        x = x.numpy()
        assert 0.0 <= x.min() and x.max() < 1.0
        assert abs(x.mean() - 0.5) < 5e-3
    assert abs(np.corrcoef(draws[0].numpy(), draws[1].numpy())[0, 1]) < 0.02


def _stat_discrete():
    d = tdist.build_discrete_1d(torch.tensor([1.0, 0.0, 3.0, 6.0]))
    np.testing.assert_allclose(d.pmf.numpy(), [0.1, 0.0, 0.3, 0.6],
                               atol=1e-6)
    u = trng.bits_to_unit_float(trng.pcg3d(torch.arange(100_000), 0, 0)[0])
    idx, _ = tdist.sample_discrete_1d(d, u)
    counts = np.bincount(idx.numpy(), minlength=4) / 100_000.0
    np.testing.assert_allclose(counts, [0.1, 0.0, 0.3, 0.6], atol=0.01)


def _stat_alias():
    w = np.asarray([0.5, 2.0, 0.0, 1.5, 4.0])
    table = tdist.build_alias_table(w)
    u = trng.bits_to_unit_float(trng.pcg3d(torch.arange(200_000), 3, 0)[0])
    idx, pmf = tdist.sample_alias(table, u)
    counts = np.bincount(idx.numpy(), minlength=5) / 200_000.0
    np.testing.assert_allclose(counts, w / w.sum(), atol=0.01)
    np.testing.assert_allclose(pmf.numpy(), (w / w.sum())[idx.numpy()],
                               atol=1e-6)


STAT_CASES = {"octahedral_round_trip": _stat_octahedral,
              "transform_round_trips": _stat_transforms,
              "cosine_hemisphere_mean": _stat_cosine_hemisphere,
              "uniform4_uniformity": _stat_uniform4,
              "discrete_frequencies": _stat_discrete,
              "alias_frequencies": _stat_alias}


@pytest.mark.parametrize("name", list(STAT_CASES))
def test_statistics_of_the_port(name):
    """tests/test_core.py's statistical cases on the port's functions."""
    STAT_CASES[name]()


def test_uniform4_and_next3_bit_exact():
    lane = np.random.default_rng(3).integers(0, 2 ** 32, N, dtype=np.uint64
                                             ).astype(np.uint32)
    lane[:2] = [2 ** 31, 2 ** 32 - 1]
    ref = jrng.uniform4(jnp.asarray(lane), 7, jnp.uint32(2 ** 32 - 5), 1)
    got = trng.uniform4(torch.from_numpy(lane.view(np.int32)), 7,
                        2 ** 32 - 5, 1)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(r).view(np.uint32))
    js = jrng.SampleStream(jnp.asarray(lane), jnp.uint32(5), 2)
    ts = trng.SampleStream(torch.from_numpy(lane.view(np.int32)), 5, 2)
    for _ in range(3):  # nine draws across three hashes
        for r, g in zip(js.next3(), ts.next3()):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# discrete distributions: the CDF to CDF_ULPS, indices off the edges equal
# ---------------------------------------------------------------------------

CDF_ULPS = 8  # 3-4 measured (XLA's scan against PyTorch's float64 cumsum)


def _weights(shape, seed):
    r = np.random.default_rng(seed)
    w = r.random(shape).astype(np.float32)
    w[r.random(shape) < 0.1] = 0.0  # empty items
    return w


@pytest.mark.parametrize("shape", [(5,), (4096,), (3, 7, 257)])
def test_build_discrete_1d_matches_jax(shape):
    w = _weights(shape, sum(shape))
    ref = jdist.build_discrete_1d(jnp.asarray(w))
    got = tdist.build_discrete_1d(torch.from_numpy(w))
    assert got.size == ref.size == shape[-1]
    for f in ("pmf", "cdf", "integral"):
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert g.shape == r.shape, f
        assert _ulps(g, r).max() <= CDF_ULPS, (f, _ulps(g, r).max())
    assert (got.cdf[..., 0] == 0).all() and (got.cdf[..., -1] == 1).all()


def test_sample_discrete_1d_matches_jax_off_the_edges():
    """A uniform picks another item only where it lies between the two
    CDFs' values of an edge: within their largest difference (in ulps) of
    the JAX CDF's edges. Of random uniforms, about the mass between the two
    CDFs does."""
    w = _weights(4096, 1)
    ref = jdist.build_discrete_1d(jnp.asarray(w))
    got = tdist.build_discrete_1d(torch.from_numpy(w))
    cdf, gcdf = np.asarray(ref.cdf), got.cdf.numpy()
    window = max(int(_ulps(gcdf, cdf).max()), 1)
    u = trng.bits_to_unit_float(trng.pcg3d(torch.arange(1 << 17), 9, 0)[0])
    u[:4096] = torch.from_numpy(cdf[:-1].copy())  # every edge exactly
    ri, rp, ru = jdist.sample_discrete_1d_remapped(ref, jnp.asarray(u))
    gi, gp, gu = tdist.sample_discrete_1d_remapped(got, u)
    ri, gi, un = np.asarray(ri), gi.numpy(), u.numpy()
    edge = np.minimum(_ulps(un, cdf[ri]), _ulps(un, cdf[ri + 1])) <= window
    off = ~edge
    np.testing.assert_array_equal(gi[off], ri[off])
    # on an edge the port picks by its own CDF: the item whose bin holds u,
    # never an empty one
    assert ((gcdf[gi] <= un) & (un < gcdf[gi + 1])).all()
    assert (w[gi] > 0).all()
    mass = np.abs(gcdf.astype(np.float64) - cdf).sum()
    differ = int((gi[4096:] != ri[4096:]).sum())
    assert differ <= 2 * mass * (len(un) - 4096) + 16, (differ, mass)
    assert _ulps(gp.numpy()[off], np.asarray(rp)[off]).max() <= CDF_ULPS
    assert 0.0 <= gu.min() and gu.max() < 1.0
    # the remapped uniform divides by the bin's width: its error is the
    # CDF's (a few ulps of the edge) over that width
    width = cdf[ri + 1] - cdf[ri]
    err = np.abs(gu.numpy() - np.asarray(ru))[off]
    assert (err <= 1e-6 + 2 * CDF_ULPS * 1.2e-7 / width[off]).all()


def test_discrete_pinned_edges_and_empty_bins():
    """Weights whose CDF is exact in float32 on every backend: uniforms on
    the edges pick what JAX picks, and the empty item is skipped."""
    w = np.asarray([1.0, 0.0, 1.0, 2.0], np.float32)
    ref = jdist.build_discrete_1d(jnp.asarray(w))
    got = tdist.build_discrete_1d(torch.from_numpy(w))
    np.testing.assert_array_equal(got.cdf.numpy(), [0, 0.25, 0.25, 0.5, 1])
    u = np.asarray([0.0, 0.25, 0.5, 0.75, 1 - 2 ** -24, 0.2499999],
                   np.float32)
    r = jdist.sample_discrete_1d_remapped(ref, jnp.asarray(u))
    g = tdist.sample_discrete_1d_remapped(got, torch.from_numpy(u))
    np.testing.assert_array_equal(g[0].numpy(), [0, 2, 3, 3, 3, 0])
    for a, b in zip(r, g):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_alias_table_matches_jax_bit_for_bit():
    w = _weights(1000, 4).astype(np.float64)
    ref = jdist.build_alias_table(w)
    got = tdist.build_alias_table(w)
    for f in ("pmf", "prob", "alias", "integral"):
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)
    u = trng.bits_to_unit_float(trng.pcg3d(torch.arange(1 << 17), 5, 0)[0])
    u[:1000] = torch.arange(1000) / 1000.0  # bucket edges
    u[1000] = 1 - 2 ** -24
    for r, g in zip(jdist.sample_alias(ref, jnp.asarray(u)),
                    tdist.sample_alias(got, u)):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # JAX's NamedTuple carries across by field name
    moved = from_numpy(ref)
    assert isinstance(moved, tdist.AliasTable)
    np.testing.assert_array_equal(moved.alias.numpy(), got.alias.numpy())


# ---------------------------------------------------------------------------
# camera, scene, acceleration structures, NRC
# ---------------------------------------------------------------------------


def test_generate_rays_matches_jax():
    w, h = 40, 24
    r = np.random.default_rng(0)
    jx, jy = r.random((2, w * h), dtype=np.float32)
    jc = jcam.make_camera(**S.BOX_CAMERA | {"aspect": w / h})
    tc = from_numpy(jc)
    jo, jd = jcam.generate_rays(jc, w, h, jnp.asarray(jx), jnp.asarray(jy))
    to, td = tcam.generate_rays(tc, w, h, torch.from_numpy(jx),
                                torch.from_numpy(jy))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # tan and the 3x3 product: 1e-6 on unit directions
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    # linear lanes, not block-major: the rays of arange(W * H), bit for bit
    lo, ld = tcam.generate_rays_for_lanes(tc, w, h, torch.arange(w * h),
                                          torch.from_numpy(jx),
                                          torch.from_numpy(jy))
    assert torch.equal(lo, to) and torch.equal(ld, td)


def test_simple_pbr_material_and_controller_match_jax():
    args = ((0.8, 0.4, 0.2), 0.35, 0.6)
    jb, tb = JB.SceneBuilder(), TB.SceneBuilder()
    for b in (jb, tb):
        b.add_lambert_material((0.5, 0.5, 0.5))
        assert b.add_simple_pbr_material(*args, emittance=(1, 2, 3),
                                         name="pbr") == 1
        assert b.add_simple_pbr_material((0.1, 0.9, 0.5), 1.0, 0.0) == 2
    for jmat, tmat in zip(jb.materials, tb.materials):
        assert dataclasses.asdict(tmat) == dataclasses.asdict(jmat)
    ctl = object()
    for b in (jb, tb):
        g = b.add_sphere(0.3, 1, n_theta=6, n_phi=8)
        assert b.add_instance(g, controller=ctl) == 0
        b.add_instance(g, JB.affine(translation=[1, 0, 0]))
    assert tb.instances[0].controller is ctl
    assert tb.instances[1].controller is None
    assert [i.controller for i in jb.instances] == [ctl, None]


@pytest.fixture(scope="module")
def box_built():
    return (jcompile(S.box_scene(JB), traversal="wide"),
            tcompile(S.box_scene(TB), traversal="wide"))


def test_num_nodes_and_has_emissive(box_built):
    (js, jb), (ts, tb) = box_built
    assert isinstance(tb, tbvh.BVH) and isinstance(jb, jbvh.BVH)
    assert tb.num_nodes == jb.num_nodes > 1
    emits = ts.has_emissive
    assert emits.dtype == torch.bool and emits.shape == ()
    assert bool(emits) == bool(js.has_emissive) is True
    b = TB.SceneBuilder()
    b.add_instance(b.add_sphere(0.5, b.add_lambert_material((0.5,) * 3)))
    jbld = JB.SceneBuilder()
    jbld.add_instance(jbld.add_sphere(0.5, jbld.add_lambert_material(
        (0.5,) * 3)))
    dark, _ = tcompile(b, traversal="widerow")
    assert bool(dark.has_emissive) == bool(
        jcompile(jbld, traversal="widerow")[0].has_emissive) is False
    # a chunked wide-row table: rows of all chunks, as JAX counts them
    t = ts.triangles
    soup = [x.numpy() for x in (t.p0, t.e1, t.e2)]
    for rows in (500, 24):
        tw, _ = twr.build_widerow(*soup, max_rows=rows)
        jw, _ = jws.build_widerow(*soup, max_rows=rows)
        assert tw.num_nodes == jw.num_nodes == (
            tw.num_chunks * tw.rows_per_chunk)
        assert tw.num_nodes == int(np.prod(np.asarray(jw.nodes).shape[:2]))
        assert tpers.persistent_supported(tw) == jpers.persistent_supported(
            jw) == (tw.num_chunks == 1)


def test_pack_widerows_and_routing_predicates_match_jax(box_built):
    (js, jb), (ts, tb) = box_built
    jtab = jws.pack_widerows(jb, js.triangles)
    ttab = twr.pack_widerows(tb, ts.triangles)
    assert isinstance(ttab, twr.WideRowBVH) and ttab.num_chunks == 1
    np.testing.assert_array_equal(ttab.nodes.numpy().view(np.int32),
                                  np.asarray(jtab.nodes).view(np.int32))
    assert (ttab.max_depth, ttab.arity, ttab.max_leaf) == (
        jtab.max_depth, jtab.arity, jtab.max_leaf)
    assert tpers.persistent_supported(ttab) and not (
        tpers.persistent_supported(tb))
    assert tpers.persistent_supported(ttab) == jpers.persistent_supported(
        jtab)
    _, ja = jcompile(S.instanced_spheres_scene(JB), traversal="instanced")
    _, ta = tcompile(S.instanced_spheres_scene(TB), traversal="instanced")
    assert tinst.persistent_inst_supported(ta) is True
    assert ta.num_instances == ja.num_instances == ta.num_entries
    assert jpinst.persistent_inst_supported(ja) is True
    assert not tinst.persistent_inst_supported(ttab)
    assert isinstance(ts.triangles, TriangleSoA)


def test_nrc_loss_and_constants_match_jax():
    r = np.random.default_rng(2)
    pred = r.random((512, 3)).astype(np.float32) * 2.0
    target = r.random((512, 3)).astype(np.float32)
    jl, jg = jax.value_and_grad(jnet.relative_l2_luminance_loss)(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    tl = tnet.relative_l2_luminance_loss(p, torch.from_numpy(target))
    tl.backward()
    # a mean of 512 terms summed in another order: 2 ulps
    np.testing.assert_allclose(tl.item(), float(jl), rtol=2.5e-7)
    # the normaliser is detached in both: the same gradient
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-7)
    assert tnet.NUM_INPUT_DIMS == jnet.NUM_INPUT_DIMS == 14
    assert tenc.HASH_PER_LEVEL_SCALE == jenc.HASH_PER_LEVEL_SCALE
