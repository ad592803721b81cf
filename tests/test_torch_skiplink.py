"""gfxexp_torch's skip-link BVH against gfxexp_tpu's: build_skip_links and
compile_scene(traversal="skip") give bit-identical nodes and scene tables
(object-space triangles included), and the plain walk (the plain version of
csrc/skiplink_traverse.cu) finds the hits of JAX's skip walk
(`intersect_closest_skip` / `intersect_any_skip`) and of the row-cursor
Pallas kernel in interpret mode.

Bars: hit and tri equal; t rtol 1e-5; u, v atol 2e-5 (XLA on the CPU
contracts the Moller-Trumbore sums into fused multiply-adds, which the port
and its kernel do not: tests/torch_scenes.py check_against_jax)."""

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
from gfxexp_torch import bench  # noqa: E402
from gfxexp_torch.accel import skiplink as tsk  # noqa: E402
from gfxexp_torch.accel.bvh_build import build_bvh as t_build_bvh  # noqa
from gfxexp_torch.accel.rowcursor import (  # noqa: E402
    intersect_any_rowcursor,
    intersect_closest_rowcursor,
)
from gfxexp_torch.accel.traverse import intersect_closest_brute  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.types import from_numpy  # noqa: E402
from gfxexp_tpu.accel import skiplink as jsk  # noqa: E402
from gfxexp_tpu.accel.pallas_rowcursor import (  # noqa: E402
    intersect_closest_rowcursor as j_rowcursor,
)
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(2)
SKIP_FIELDS = ("aabb_min", "aabb_max", "first", "count", "skip", "depth")


def _bits(x):
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_skip_equal(jb, tb):
    for f in SKIP_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(tb, f).numpy()),
                                      _bits(getattr(jb, f)), err_msg=f)
    assert (tb.max_leaf, tb.n_levels, tb.arity) == (
        jb.max_leaf, jb.n_levels, jb.arity)


def _assert_tables_equal(jobj, tobj, name):
    for f in ("p0", "e1", "e2", "n0", "n1", "n2"):
        np.testing.assert_array_equal(_bits(getattr(tobj, f).numpy()),
                                      _bits(getattr(jobj, f)),
                                      err_msg=f"{name}.{f}")


@pytest.mark.parametrize("arity,n", [(4, 300), (8, 300), (4, 3)])
def test_build_skip_links_matches_jax(arity, n):
    rng = np.random.default_rng(arity + n)
    p0, e1, e2 = S.soup(rng, n, 2.0)
    wide, _ = t_build_bvh(p0, e1, e2, arity=arity)
    args = (wide.child_min, wide.child_max, wide.child_idx, wide.child_count)
    tb = tsk.build_skip_links(*args, max_leaf=4)
    jb = jsk.build_skip_links(*args, max_leaf=4)
    _assert_skip_equal(jb, tb)
    # every skip link points forward, past the node's subtree
    idx = np.arange(tb.num_nodes)
    assert (tb.skip.numpy() > idx).all()


@pytest.fixture(scope="module")
def spheres():
    """The box with three spheres, compiled skip by both packages (JAX's
    host compile returns numpy arrays: the walk needs device arrays)."""
    js, jb = jcompile(S.instanced_spheres_scene(JB), traversal="skip")
    return ((jax.tree_util.tree_map(jnp.asarray, js), jb),
            tcompile(S.instanced_spheres_scene(TB), traversal="skip"))


@pytest.mark.parametrize("key", ["spheres", "bench"])
def test_compile_skip_matches_jax(spheres, key):
    if key == "spheres":
        (js, jb), (ts, tb) = spheres
    else:
        js, jb = jcompile(bench.bench_scene_builder(JB.SceneBuilder()),
                          traversal="skip")
        ts, tb = tcompile(bench.bench_scene_builder(), traversal="skip")
    _assert_skip_equal(jb, tb)
    _assert_tables_equal(js.triangles, ts.triangles, "triangles")
    _assert_tables_equal(js.object_triangles, ts.object_triangles,
                         "object_triangles")
    np.testing.assert_array_equal(ts.object_triangles.instance.numpy(),
                                  np.asarray(js.object_triangles.instance))
    for f in ("light_tri_index", "light_tri_pmf", "light_tri_cdf"):
        np.testing.assert_array_equal(getattr(ts.units, f).numpy(),
                                      np.asarray(getattr(js.units, f)))
    # the walk tables: node rows and triangle rows carry the same values
    m = tb.num_nodes
    nodes = tb.node_pack.numpy()
    np.testing.assert_array_equal(nodes[:m, 0:3], tb.aabb_min.numpy())
    packed = nodes[:m, 6].view(np.int32)
    np.testing.assert_array_equal(packed >> 24, tb.count.numpy())
    np.testing.assert_array_equal(packed & 0xFFFFFF, tb.first.numpy())
    np.testing.assert_array_equal(nodes[:, 7].view(np.int32),
                                  np.r_[tb.skip.numpy(), m])
    np.testing.assert_array_equal(tb.tri_pack[:ts.num_triangles, 3:6].numpy(),
                                  ts.triangles.e1.numpy())
    # from_numpy packs JAX's SkipBVH's node table as it comes in; the
    # triangle table waits for the triangles
    fb = from_numpy(jb)
    _assert_skip_equal(jb, fb)
    assert torch.equal(fb.node_pack, tb.node_pack) and fb.tri_pack is None
    assert torch.equal(fb.level_ids, tb.level_ids)
    assert fb.level_sizes == tb.level_sizes


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.8, 1.8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(np.arange(n) % 9 == 4, -1.0, 1e30).astype(np.float32)
    return o, d, t_max


def _check(h, jh):
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(jh.hit))
    m = np.asarray(jh.hit)
    np.testing.assert_array_equal(h.tri.numpy()[m], np.asarray(jh.tri)[m])
    np.testing.assert_allclose(h.t.numpy()[m], np.asarray(jh.t)[m],
                               rtol=1e-5)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(h, f).numpy()[m],
                                   np.asarray(getattr(jh, f))[m], atol=2e-5)


def test_plain_walk_matches_jax_skip(spheres):
    (js, jb), (ts, tb) = spheres
    o, d, t_max = _rays(1024, 3)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    # JAX's walk has no dead rays: give those t_max = 0 (no hit either way)
    jt = jnp.asarray(np.maximum(t_max, 0.0))
    to, td, tt = (torch.from_numpy(x) for x in (o, d, t_max))
    h, st = tsk.walk_skip_plain(tb, ts.triangles, to, td, 1e-4, tt, False,
                                with_stats=True)
    _check(h, jsk.intersect_closest_skip(jb, js.triangles, jo, jd, 1e-4, jt))
    assert not h.hit[tt < 0].any() and int(st.nodes[tt < 0].max()) == 0
    assert int(st.tris.sum()) > 0 and int(st.nodes.max()) < tb.num_nodes
    # rows read: at most the visits, every hit triangle among them, and no
    # sentinel or padding row
    assert 0 < int(st.node_rows.sum()) <= int(st.nodes.sum())
    assert 0 < int(st.tri_rows.sum()) <= int(st.tris.sum())
    assert st.tri_rows[h.tri[h.hit].long()].all()
    assert not st.node_rows[-1] and not st.tri_rows[ts.num_triangles:].any()
    occ = tsk.walk_skip_plain(tb, ts.triangles, to, td, 1e-4, tt, True).hit
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jsk.intersect_any_skip(jb, js.triangles, jo,
                                                        jd, 1e-4, jt)))
    # against brute force over the world triangles
    hb = intersect_closest_brute(ts.triangles, to, td, 1e-4, tt)
    assert torch.equal(h.hit, hb.hit) and torch.equal(h.tri, hb.tri)


def test_plain_walk_matches_rowcursor_interpret(spheres):
    """JAX's row-cursor Pallas kernel in interpret mode (333 rays, not a
    tile multiple) against the port's row-cursor entry points, which on CPU
    tensors run the plain walk."""
    (js, jb), (ts, tb) = spheres
    o, d, _ = _rays(333, 5)
    jh = j_rowcursor(jb, js.triangles, jnp.asarray(o), jnp.asarray(d))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    _check(intersect_closest_rowcursor(tb, ts.triangles, to, td), jh)
    occ = intersect_any_rowcursor(tb, ts.triangles, to, td)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jh.hit))


def test_triangle_table_follows_the_given_triangles(spheres):
    """The walk reads the triangles it is given: a structure from
    from_numpy, or one given other triangles than it was packed from, packs
    its triangle table once for them and keeps it."""
    (js, jb), (ts, tb) = spheres
    o, d, t_max = (torch.from_numpy(x) for x in _rays(200, 8))
    fb = from_numpy(jb)
    a = tsk.walk_skip_plain(fb, ts.triangles, o, d, 1e-4, t_max, False)
    b = tsk.walk_skip_plain(tb, ts.triangles, o, d, 1e-4, t_max, False)
    assert torch.equal(a.t, b.t) and torch.equal(a.tri, b.tri)
    table = fb.tri_pack
    tsk.walk_skip_plain(fb, ts.triangles, o, d, 1e-4, t_max, False)
    assert fb.tri_pack is table  # packed once per triangle set
    # moved triangles (boxes not refit): the walk tests the moved ones, as
    # a structure packed for them does
    moved = dataclasses.replace(ts.triangles, p0=ts.triangles.p0 + 0.01)
    ref = tsk.pack_tables(from_numpy(jb), moved)
    c = tsk.walk_skip_plain(tb, moved, o, d, 1e-4, t_max, False)
    e = tsk.walk_skip_plain(ref, moved, o, d, 1e-4, t_max, False)
    assert torch.equal(c.t, e.t) and torch.equal(c.tri, e.tri)
    assert not torch.equal(c.t, b.t)
    assert tsk.packed_for(tb, moved) and not tsk.packed_for(tb, ts.triangles)
    with pytest.raises(ValueError):
        tsk.walk_skip_plain(fb, None, o, d, 1e-4, t_max, False)
