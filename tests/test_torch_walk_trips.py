"""The CPU count of dependent round trips to memory of kernel 2 (chunked wide
rows, persistent.chunked_trips) and of the skip-link walk's per-ray scope
(skiplink.skip_trips): hand-built trees whose counts are known, and on small
scenes the counts against the plain walks' own stats."""

import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
from gfxexp_torch import bench  # noqa: E402
from gfxexp_torch.accel.persistent import (  # noqa: E402
    chunked_trips,
    walk_chunked_plain,
)
from gfxexp_torch.accel.skiplink import (  # noqa: E402
    SkipBVH,
    SkipStats,
    skip_trips,
    walk_skip_plain,
)
from gfxexp_torch.accel.widerow import build_widerow  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene  # noqa: E402

FIELDS = ("t", "u", "v", "tri", "hit")


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def _square(x, y, z):
    """p0, e1, e2 of a 3 x 3 triangle in the plane at z whose corner is at
    (x, y): it covers (x + 1, y + 1)."""
    return [x, y, z], [3.0, 0.0, 0.0], [0.0, 3.0, 0.0]


def _hand_tree():
    """Five nodes in preorder and four triangles, for a ray from (0, 0, -5)
    along +z: root (hit) -> leaf of triangles 0, 1 at z = 3, 2 (both hit)
    -> internal B (hit) -> leaf of triangle 2 (missed, off to the side) ->
    leaf of triangle 3 at z = 0.5 (hit)."""
    tri = [_square(-1, -1, 3), _square(-1, -1, 2), _square(9, -1, 0),
           _square(-1, -1, 0.5)]
    tris = types.SimpleNamespace(**{
        k: _f32([t[i] for t in tri]) for i, k in enumerate(("p0", "e1",
                                                             "e2"))})
    lo = [[-20, -20, -20], [-1, -1, 2], [-1, -1, -1], [9, -1, 0],
          [-1, -1, 0.5]]
    hi = [[20, 20, 20], [2, 2, 3], [12, 2, 1], [12, 2, 0], [2, 2, 0.5]]
    bvh = SkipBVH(aabb_min=_f32(lo), aabb_max=_f32(hi),
                  first=_i32([0, 0, 0, 2, 3]), count=_i32([0, 2, 0, 1, 1]),
                  skip=_i32([5, 2, 5, 4, 5]), depth=_i32([0, 1, 1, 2, 2]),
                  max_leaf=2, n_levels=3, arity=2)
    return bvh, tris, _f32([[0, 0, -5]]), _f32([[0, 0, 1]])


@pytest.mark.parametrize("leaf_batch", [False, True])
def test_skip_trips_of_a_hand_built_tree(leaf_batch):
    """Closest hit visits 5 nodes, tests 3 triangles in 2 leaves (the leaf
    of triangle 2 is missed): 8 trips on the parent's schedule, 7 with the
    leaf batch. Any hit stops at triangle 0: the root, the leaf, one
    triangle, 3 trips either way."""
    bvh, tris, o, d = _hand_tree()
    for any_hit, counts, trips in ((False, (5, 3, 2), (8, 7)),
                                   (True, (2, 1, 1), (3, 3))):
        h, st = walk_skip_plain(bvh, tris, o, d, 1e-4, 1e30, any_hit,
                                with_stats=True)
        assert int(h.tri[0]) == (0 if any_hit else 3)
        assert float(h.t[0]) == (8.0 if any_hit else 5.5)
        assert (int(st.nodes[0]), int(st.tris[0]), int(st.leaves[0])) == counts
        parent, new = skip_trips(st, leaf_batch)
        assert (int(parent[0]), int(new[0])) == (
            trips if leaf_batch else (trips[0], trips[0]))


def test_skip_trips_counts():
    """The formula on counts: a trip per node and per triangle on the
    parent's schedule; a trip per node and per hit leaf with the batch."""
    z = torch.zeros(3, dtype=torch.bool)
    st = SkipStats(nodes=torch.tensor([70, 5, 0]),
                   tris=torch.tensor([13, 0, 0]), node_rows=z, tri_rows=z,
                   leaves=torch.tensor([4, 0, 0]))
    assert [x.tolist() for x in skip_trips(st)] == [[83, 5, 0], [74, 5, 0]]
    assert [x.tolist() for x in skip_trips(st, leaf_batch=False)] == [
        [83, 5, 0], [83, 5, 0]]


@pytest.mark.parametrize("arity", [4, 8])
def test_chunked_trips_of_a_hand_built_table(arity):
    """Five stacked triangles in one leaf row under the root row: the
    parent's schedule takes 2 trips for the root, 1 + 5 for the leaf
    (closest) or 1 + 1 (any hit stops at the first); the batched one 1 a
    row and 1 more for the leaf's triangles past the first batch."""
    z = np.arange(1, 6, dtype=np.float32)
    p0 = np.stack([np.full(5, -1.0), np.full(5, -1.0), z], 1)
    e1 = np.tile([[3.0, 0.0, 0.0]], (5, 1))
    e2 = np.tile([[0.0, 3.0, 0.0]], (5, 1))
    tb, _ = build_widerow(p0.astype(np.float32), e1.astype(np.float32),
                          e2.astype(np.float32), arity=arity, max_leaf=5)
    o, d = _f32([[0, 0, -5]]), _f32([[0, 0, 1]])
    for any_hit, tested, want in ((False, 5, (8, 3)), (True, 1, (4, 2))):
        h, rows, chunks, tests = walk_chunked_plain(tb, o, d, 1e-4, 1e30,
                                                    any_hit, with_stats=True)
        assert int(rows[0]) == 2 and int(chunks[0]) == 1
        assert tests[0].tolist() == [int(c == tested) for c in range(6)]
        parent, new = chunked_trips(rows, tests, arity)
        assert (int(parent[0]), int(new[0])) == want


def test_chunked_trips_counts():
    """The formula on counts: arity 4 holds 2 triangles in the first batch,
    arity 8 holds 4."""
    rows = torch.tensor([10, 3, 0])
    tests = torch.tensor([[0, 1, 1, 1, 1, 1],  # leaves testing 1..5
                          [0, 0, 0, 2, 0, 0],
                          [0, 0, 0, 0, 0, 0]])
    parent, new = chunked_trips(rows, tests, 4)
    assert parent.tolist() == [2 * 5 + 5 + 15, 2 * 1 + 2 + 6, 0]
    assert new.tolist() == [10 + 3, 3 + 2, 0]
    assert chunked_trips(rows, tests, 8)[1].tolist() == [10 + 1, 3, 0]


def _skip_scenes():
    yield compile_scene(S.instanced_spheres_scene(TB), traversal="skip")
    yield bench.build_bench_scene(traversal="skip")


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("which", [0, 1])
def test_skip_replay_matches_plain_stats(which, any_hit):
    """On the box with three spheres and bench.py's small scene: the stats
    leave the results alone, each ray tests a triangle in no more leaves
    than it visits nodes and tests at least one triangle in each, and the
    kernel's schedule never counts more trips than the parent's (as many
    without the leaf batch)."""
    scene, bvh = list(_skip_scenes())[which]
    tris = scene.triangles
    rng = np.random.default_rng(37)
    soup = tuple(x.numpy() for x in (tris.p0, tris.e1, tris.e2))
    o, d = (torch.from_numpy(x) for x in S.aimed_rays(rng, 3000, *soup,
                                                      box=3.0))
    t_max = torch.where(torch.arange(3000) % 7 == 3, -1.0, 1e30)
    live = t_max >= 0
    plain = walk_skip_plain(bvh, tris, o, d, 1e-4, t_max, any_hit)
    h, st = walk_skip_plain(bvh, tris, o, d, 1e-4, t_max, any_hit,
                            with_stats=True)
    for f in FIELDS:
        assert torch.equal(getattr(h, f), getattr(plain, f)), f
    assert int(st.leaves[live].sum()) > 0 and int(st.nodes[~live].max()) == 0
    assert (st.leaves <= st.nodes).all() and (st.leaves <= st.tris).all()
    parent, new = skip_trips(st)
    assert torch.equal(parent, st.nodes + st.tris)
    assert (new <= parent).all() and (new[live] >= 1).all()
    assert int(new[~live].max()) == 0
    assert torch.equal(skip_trips(st, leaf_batch=False)[1], parent)


def test_chunked_replay_matches_plain_stats():
    """On bench.py's small scene (one table, walked whole) and a chunked
    soup: the leaf tests leave the results alone, count no more leaf rows
    than rows, and the batched schedule never counts more trips than the
    parent's."""
    scene, small = bench.build_bench_scene()
    rng = np.random.default_rng(41)
    soup = S.soup(rng, 1500, 6.0)
    chunked = build_widerow(*soup, max_rows=120)[0]
    assert small.num_chunks == 1 and chunked.num_chunks > 4
    tris = scene.triangles
    small_soup = tuple(x.numpy() for x in (tris.p0, tris.e1, tris.e2))
    for tb, aim, box in ((small, small_soup, 3.0), (chunked, soup, 10.0)):
        o, d = S.aimed_rays(rng, 2000, *aim, box=box)
        o, d = torch.from_numpy(o), torch.from_numpy(d)
        t_max = torch.where(torch.arange(2000) % 5 == 1, -1.0, 1e30)
        for any_hit in (False, True):
            plain = walk_chunked_plain(tb, o, d, 1e-4, t_max, any_hit)
            h, rows, chunks, tests = walk_chunked_plain(
                tb, o, d, 1e-4, t_max, any_hit, with_stats=True)
            for f in FIELDS:
                assert torch.equal(getattr(h, f), getattr(plain, f)), f
            assert tests.shape == (2000, tb.max_leaf + 1)
            assert (tests.sum(1) <= rows).all()
            assert int(tests[t_max < 0].sum()) == 0
            parent, new = chunked_trips(rows, tests, tb.arity)
            assert (new <= parent).all() and (new >= rows).all()
            assert int(tests.sum()) > 0
