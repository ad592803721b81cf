"""The stack-based wide BVH (compile_scene(traversal="wide"), walked by
gfxexp_torch/accel/traverse.py `_traverse`) against gfxexp_tpu's `_traverse`,
and ray sorting and compaction against JAX's.

Bars: closest and any hit against JAX: hits equal, t within rtol 1e-5, the
triangle equal where no other t lies within 1e-6 of it, u and v within 2e-4
(XLA contracts the Moller-Trumbore sums into fused multiply-adds, ROADMAP
Queue C). With `max_leaf=8` the port agrees with brute force (hits equal, t
rtol 1e-5) where JAX's walk, which tests 4 triangles a leaf unless its
caller passes more, misses hits. Renders at 16x16 (the box with three
spheres, flattened): the port's default, sorted and compacted renders
each within a mean relative difference of 5e-3 of JAX's render with
both options set (which JAX keeps bit-identical to its default), ray
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
from gfxexp_torch.accel import traverse as tt  # noqa: E402
from gfxexp_torch.accel.bvh_build import BVH  # noqa: E402
from gfxexp_torch.accel.bvh_build import build_bvh as t_build  # noqa: E402
from gfxexp_torch.core.tensors import from_numpy  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402
from gfxexp_tpu.accel import traverse as jt  # noqa: E402
from gfxexp_tpu.accel.bvh_build import build_bvh as j_build  # noqa: E402
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.render.camera import make_camera as j_camera  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402
from gfxexp_tpu.scene.types import TriangleSoA as JSoA  # noqa: E402

torch.set_num_threads(2)
N_RAYS = 1500


def _soup(seed, n=400):
    return S.soup(np.random.default_rng(seed), n, 2.0)


def _jsoa(p0, e1, e2):
    z3 = jnp.zeros_like(jnp.asarray(p0))
    z2 = jnp.zeros((p0.shape[0], 2), jnp.float32)
    return JSoA(p0=jnp.asarray(p0), e1=jnp.asarray(e1), e2=jnp.asarray(e2),
                n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
                unit_id=jnp.zeros((p0.shape[0],), jnp.int32))


def _tsoa(p0, e1, e2):
    import types

    return types.SimpleNamespace(p0=torch.from_numpy(p0),
                                 e1=torch.from_numpy(e1),
                                 e2=torch.from_numpy(e2), count=p0.shape[0])


def _rays(seed, soup):
    """Rays from origins uniform in [-4, 4]^3 in uniform directions, as
    tests/test_accel.py shoots them, with tmax < 0 (dead) on every 7th.
    (Rays aimed at the soup's slivers from afar, S.aimed_rays, part t from
    JAX's by up to 1.2e-4 of itself on 0.3% of hits: XLA's FMAs.)"""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, size=(N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(N_RAYS) % 7 == 3, -1.0,
                     1e30).astype(np.float32)
    return o, d, t_max


@pytest.fixture(scope="module")
def jax_walk():
    """JAX's arity-8 wide BVH over a soup, and its closest and any hits on
    the module's rays (one JAX compile of each walk)."""
    p0, e1, e2 = _soup(4)
    jb, perm = j_build(p0, e1, e2, arity=8)
    soup = (p0[perm], e1[perm], e2[perm])
    o, d, t_max = _rays(14, soup)
    args = (_jsoa(*soup), jnp.asarray(o), jnp.asarray(d))
    jh = jt.intersect_closest(jb, *args, t_max=jnp.asarray(t_max))
    ja = jt.intersect_any(jb, *args, t_max=jnp.asarray(t_max))
    return (p0, e1, e2), jb, perm, (o, d, t_max), jh, ja


def _check_walk(tb, soup, rays, jh, ja):
    o, d, t_max = rays
    args = (_tsoa(*soup), torch.from_numpy(o), torch.from_numpy(d))
    h = tt.intersect_closest(tb, *args, t_max=torch.from_numpy(t_max))
    assert int(h.hit.sum()) > N_RAYS // 20
    assert not h.hit.numpy()[t_max < 0].any()
    S.check_single_against_jax(h, jh, uv_atol=2e-4)
    a = tt.intersect_any(tb, *args, t_max=torch.from_numpy(t_max))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def test_wide_walk_matches_jax(jax_walk):
    """The port's own arity-8 build, closest and any hit."""
    (p0, e1, e2), jb, jperm, rays, jh, ja = jax_walk
    tb, tperm = t_build(p0, e1, e2, arity=8)
    assert isinstance(tb, BVH) and np.array_equal(tperm, jperm)
    trace.reset_counters("wide.")
    _check_walk(tb, (p0[tperm], e1[tperm], e2[tperm]), rays, jh, ja)
    c = trace.counters("wide.")
    assert c["wide.queries"] == 2 and c["wide.steps"] > 0
    assert c["wide.syncs"] <= c["wide.steps"]


def test_wide_walk_of_jax_bvh_through_from_numpy(jax_walk):
    """JAX's own BVH carried into the port walks as JAX's."""
    (p0, e1, e2), jb, perm, rays, jh, ja = jax_walk
    fb = from_numpy(jb)
    assert isinstance(fb, BVH)
    assert (fb.max_depth, fb.arity, fb.max_leaf) == (
        jb.max_depth, jb.arity, jb.max_leaf)
    _check_walk(fb, (p0[perm], e1[perm], e2[perm]), rays, jh, ja)


def test_leaf_size_8_matches_brute_where_jax_misses():
    """A BVH built with max_leaf=8: the port tests each leaf's 8 triangles
    (bvh.max_leaf) and agrees with brute force; JAX's intersect_closest,
    called as the path tracer calls it, tests 4 and misses hits."""
    p0, e1, e2 = _soup(31)
    jb, _ = j_build(p0, e1, e2, max_leaf=8)
    tb, perm = t_build(p0, e1, e2, max_leaf=8)
    soup = (p0[perm], e1[perm], e2[perm])
    o, d, _ = _rays(32, soup)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    h = tt.intersect_closest(tb, _tsoa(*soup), *args)
    ref = tt.intersect_closest_brute(_tsoa(*soup), *args)
    assert torch.equal(h.hit, ref.hit)
    m = ref.hit
    np.testing.assert_allclose(h.t[m].numpy(), ref.t[m].numpy(), rtol=1e-5)
    assert torch.equal(tt.intersect_any(tb, _tsoa(*soup), *args), ref.hit)
    jh = jt.intersect_closest(jb, _jsoa(*soup), jnp.asarray(o),
                              jnp.asarray(d))
    assert int(np.asarray(jh.hit).sum()) < int(ref.hit.sum())


@pytest.fixture(scope="module")
def wide_scene():
    """The box with three spheres, flattened, compiled "wide" by both
    packages, and JAX's 16x16 image with both options set (one JAX compile:
    JAX keeps it bit-identical to its default)."""
    js, jb = jcompile(S.instanced_spheres_scene(JB), traversal="wide")
    ts, tb = tcompile(S.instanced_spheres_scene(TB), traversal="wide")
    jimg = jpt.render_sample(js, jb, j_camera(**S.INSTANCED_CAMERA), 16, 16,
                             jnp.uint32(1), jpt.PTConfig(
                                 sort_secondary_rays=True, compact_rays=True,
                                 **PT))
    return ts, tb, jimg


PT = dict(max_path_length=3, count_rays=True)


@pytest.mark.parametrize("option", [None, "sort_secondary_rays",
                                    "compact_rays"])
def test_wide_render_matches_jax(wide_scene, option):
    ts, tb, (jimg, jnr) = wide_scene
    assert isinstance(tb, BVH)
    assert isinstance(tb.to("cpu"), BVH) and tb.device.type == "cpu"
    kw = {} if option is None else {option: True}
    img, nr = tpt.render_sample(ts, tb, make_camera(**S.INSTANCED_CAMERA),
                                16, 16, 1, tpt.PTConfig(**PT, **kw))
    assert torch.isfinite(img).all() and float(img.mean()) > 0
    assert S.image_rel_diff(img.numpy(), np.asarray(jimg)) < 5e-3
    assert float(nr) == float(jnr)
