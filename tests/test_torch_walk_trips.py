"""The CPU counts of gfxexp_torch.walk_trips: dependent round trips to memory
of kernel 2 (chunked wide rows, persistent.chunked_trips) and of the
skip-link walk's per-ray scope (skiplink.skip_trips), the lane
utilisation of kernel 1's and the build-order two-level walk's schedules,
the skip-link warp scope's windows (warp_windows) and the lane-group
walk's steps (group_steps):
hand-built trees and visit sequences whose counts are known, and on small
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
from gfxexp_torch.accel.instanced import (  # noqa: E402
    GROUP,
    SUB_GROUP,
    group_boxes,
    walk_instanced_plain,
)
from gfxexp_torch.accel.persistent import walk_plain  # noqa: E402
from gfxexp_torch.accel.widerow import build_widerow  # noqa: E402
from gfxexp_torch.csrc.build import header_constant  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene  # noqa: E402
from gfxexp_torch.walk_trips import (  # noqa: E402
    build_order_costs,
    group_shares,
    group_steps,
    lane_steps,
    refill_steps,
    static_steps,
    warp_windows,
)
from gfxexp_torch.accel.lanegroup import walk_lanegroup_plain  # noqa: E402

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


def test_lane_steps_of_hand_built_batches():
    """33 rays: one of 10 rows, 32 of one row. The static grid runs the
    first warp 10 steps and the second 1; per-lane refill with 1 or 16 idle
    lanes starts the 33rd ray beside the long one (10 steps), per-warp
    feeding (32) only after it (11). Dead rays (0 rows) cost no step."""
    rows = [10] + [1] * 32
    assert static_steps(rows) == 11
    assert [refill_steps(rows, k) for k in (1, 16, 32)] == [10, 10, 11]
    assert refill_steps([0] * 40, 1) == 0 and static_steps([0] * 40) == 0
    # 40 rays of 3 rows after them: 32 start beside the long ray, then 8
    assert refill_steps(rows + [3] * 40, 1) == 10
    assert refill_steps([3] * 40, 1) == 3 + 3
    out = lane_steps(rows)
    assert out["rows"] == 42
    assert out["static"]["warp_steps"] == 11
    assert out["refill1"]["utilisation"] == 42 / (32 * 10)


def _costs(visits, n_rays, n_entries, stopped=()):
    ray, ent, rows = (np.array(x, np.int64) for x in zip(*visits))
    live = np.zeros(n_rays, bool)
    live[: max(ray) + 1] = True
    st = np.zeros(n_rays, bool)
    st[list(stopped)] = True
    return build_order_costs((ray, ent, rows), n_rays, n_entries, live, st)


def test_build_order_costs_of_hand_built_sequences():
    """Two live lanes over 64 entries. Lane 0 visits entry 5 (10 rows),
    lane 1 entries 1 (1 row) and 5 (10 rows): the lock-step loop walks 1 +
    10 rows, the candidate loop and the window 10 + 10 (their second rounds
    hold only lane 1), the candidate loop scanning 6, then 58 (lane 0 to the
    end) and 58 (lane 1). Lane 0 at entry 3, lane 1 at entry 40, 8 rows
    each: lock-step and window (two windows) 16, candidate 8, scanning 41,
    then 60 (lane 0 to the end, beside lane 1's 23). An any hit
    that stops lane 0 at entry 3 and lane 1 at 40 ends the scans there."""
    c = _costs([(0, 5, 10), (1, 1, 1), (1, 5, 10)], 2, 64)
    assert c["lockstep"] == {"scan_steps": 64, "walk_steps": 11,
                             "utilisation": 21 / (32 * 11)}
    assert (c["candidate"]["scan_steps"], c["candidate"]["walk_steps"]) == (
        6 + 58 + 58, 20)
    assert (c["window"]["scan_steps"], c["window"]["walk_steps"]) == (64, 20)
    c = _costs([(0, 3, 8), (1, 40, 8)], 2, 64)
    assert [c[k]["walk_steps"] for k in ("lockstep", "candidate",
                                         "window")] == [16, 8, 16]
    assert c["candidate"]["scan_steps"] == 41 + 60
    c = _costs([(0, 3, 8), (1, 40, 8)], 2, 64, stopped=(0, 1))
    assert c["lockstep"]["scan_steps"] == 41
    assert c["window"]["scan_steps"] == 64
    assert c["candidate"]["scan_steps"] == 41


def test_group_shares_and_boxes():
    """40 unit boxes along x, in groups of 32 (one full, one of 8): a ray
    along x through all enters both groups, one along y at x = 35.5 only
    the second, a dead ray none; the union boxes are the min and max of
    their members' corners. The wrapper builds them at the sizes the
    build-order kernel reads them (its kWindow and kSub)."""
    src = "instanced_traverse.cu"
    assert header_constant("kWindow", src) == GROUP
    assert header_constant("kSub", src) == SUB_GROUP
    lo = torch.stack([torch.arange(40.0), torch.zeros(40), torch.zeros(40)],
                     1)
    hi = lo + 1.0
    glo, ghi = group_boxes(lo, hi)
    assert glo.tolist() == [[0, 0, 0], [32, 0, 0]]
    assert ghi.tolist() == [[32, 1, 1], [40, 1, 1]]
    o = _f32([[-1, 0.5, 0.5], [35.5, -1, 0.5], [0, 0, 0]])
    d = _f32([[1, 0, 0], [0, 1, 0], [1, 0, 0]])
    out = group_shares(lo, hi, o, d, torch.zeros(3),
                       _f32([1e30, 1e30, -1]))
    assert out == {"groups": 2, "per_ray": 0.75, "per_warp": 1.0}


def test_lane_counts_on_bench_scenes():
    """On bench.py's small scene (kernel 1) and `big` (build order), 1,024
    rays through neighbouring pixels: the stats leave the results alone;
    refill never takes more warp steps than the static grid, fewer idle
    lanes before a refill never more, and per-warp feeding as many; the
    candidate loop and the window walk no more rows than the lock-step
    loop on closest hit, the window scanning as many boxes."""
    small = bench.build_bench_scene()[1]

    def small_hit(o0, d0):
        h = walk_plain(small, o0, d0, 0.0, 1e30, False)
        return h.t, h.hit

    first = 512 * 256
    o, d, t_min, t_max, _, _ = bench.walk_rays(small_hit, "small", "cpu",
                                               batch=1024, first=first)
    b = slice(1024, 2048)
    h, rows = walk_plain(small, o[b], d[b], t_min[b], t_max[b], False,
                         with_stats=True)
    plain = walk_plain(small, o[b], d[b], t_min[b], t_max[b], False)
    for f in FIELDS:
        assert torch.equal(getattr(h, f), getattr(plain, f)), f
    steps = lane_steps(rows.numpy())
    order = [steps[k]["warp_steps"] for k in ("refill1", "refill8",
                                              "refill16", "static")]
    assert order == sorted(order) and order[0] < order[-1]
    assert steps["refill32"]["warp_steps"] == steps["static"]["warp_steps"]

    acc = bench.build_bench_scene("big")[1]

    def big_hit(o0, d0):
        h, _ = walk_instanced_plain(acc, o0, d0, 0.0, 1e30, False, "nearest")
        return h.t, h.hit

    o, d, t_min, t_max, _, _ = bench.walk_rays(big_hit, "big", "cpu",
                                               batch=1024, first=first)
    args = (o[b], d[b], t_min[b], t_max[b])
    h, ent, rows, visits, seq = walk_instanced_plain(acc, *args, False,
                                                     "build", with_stats=True)
    ph, pe = walk_instanced_plain(acc, *args, False, "build")
    for f in FIELDS:
        assert torch.equal(getattr(h, f), getattr(ph, f)), f
    assert torch.equal(ent, pe)
    assert int(seq[2].sum()) == int(rows.sum()) and len(seq[0]) == int(
        visits.sum())
    live = (args[3] >= 0).numpy()
    c = build_order_costs([x.numpy() for x in seq], 1024, acc.num_entries,
                          live, np.zeros(1024, bool))
    lock = c["lockstep"]
    assert c["candidate"]["walk_steps"] <= lock["walk_steps"]
    assert c["window"]["walk_steps"] <= lock["walk_steps"]
    assert c["window"]["scan_steps"] == lock["scan_steps"]


def test_skip_visits_of_the_hand_tree():
    """The plain walk's visits, in order: closest hit takes every node of
    the hand-built tree, any hit the root and the first leaf."""
    bvh, tris, o, d = _hand_tree()
    for any_hit, nodes in ((False, [0, 1, 2, 3, 4]), (True, [0, 1])):
        _, st = walk_skip_plain(bvh, tris, o, d, 1e-4, 1e30, any_hit,
                                with_stats=True)
        assert st.visits.tolist() == [[0, c] for c in nodes]


def test_warp_windows_of_hand_built_visits():
    """Warp 0: rays 0 and 1 visit nodes {0, 1, 2, 40, 41, 100} and {0, 5,
    70}, a union of 8 steps. With the prefetch the windows start at 0, 32,
    64 and 96 (every change into the next window: one load not
    prefetched); opened at the cursor they start at 0, 40 and 100. Warp 1:
    ray 32 visits {0, 200}: two windows, the change past the next one.
    Warp 2 has no live ray and is not counted."""
    visits = [(0, c) for c in (0, 1, 2, 40, 41, 100)] + [
        (1, c) for c in (0, 5, 70)] + [(32, 0), (32, 200)]
    out = warp_windows(np.array(visits), 96)
    assert out == {"warps": 2, "steps": (8 + 2) / 2,
                   "windows": (4 + 2) / 2, "windows_at_cursor": (3 + 2) / 2,
                   "next_share": 3 / 4, "dependent_loads": (1 + 2) / 2}
    assert warp_windows(np.zeros((0, 2)), 32)["warps"] == 0


def test_group_steps_of_hand_built_counts():
    """Two groups of 32 lanes (G = 4), 10 and 0 steps, 40 rows: a share of
    40 / 320; one group of 128 lanes (G = 1) spans four warps."""
    rows = np.zeros(64, np.int64)
    rows[:4] = 10
    out = group_steps(rows, np.array([10, 0]), 4)
    assert out == {"groups": 2, "steps": 10, "steps_per_group": 5.0,
                   "warp_steps": 10, "rows": 40, "share": 40 / 320}
    out = group_steps(np.full(128, 1), np.array([5]), 1)
    assert (out["warp_steps"], out["share"]) == (20, 128 / (128 * 5))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_lanegroup_steps_match_plain_stats(groups):
    """On bench.py's small scene, 700 rays (a ragged last block), some
    dead: the step counts leave the results and rows alone; a group steps
    at least as often as any of its lanes takes part, and the share of
    lanes that take part lies in (0, 1]."""
    scene, small = bench.build_bench_scene(traversal="widerow")
    tris = scene.triangles
    rng = np.random.default_rng(47)
    soup = tuple(x.numpy() for x in (tris.p0, tris.e1, tris.e2))
    o, d = (torch.from_numpy(x) for x in S.aimed_rays(rng, 700, *soup,
                                                      box=3.0))
    t_max = torch.where(torch.arange(700) % 9 == 4, -1.0, 1e30)
    h, rows = walk_lanegroup_plain(small, o, d, 1e-4, t_max, groups,
                                   with_stats=True)
    h2, rows2, steps = walk_lanegroup_plain(small, o, d, 1e-4, t_max, groups,
                                            with_stats=True, with_steps=True)
    for f in FIELDS:
        assert torch.equal(getattr(h, f), getattr(h2, f)), f
    assert torch.equal(rows, rows2)
    lanes = 128 // groups
    assert steps.shape == (-(-700 // 128) * groups,)
    pad = torch.cat([rows, rows.new_zeros(len(steps) * lanes - 700)])
    assert (steps >= pad.reshape(-1, lanes).max(1).values).all()
    out = group_steps(rows.numpy(), steps.numpy(), groups)
    assert 0 < out["share"] <= 1


@pytest.mark.parametrize("any_hit", [False, True])
def test_warp_windows_on_plain_visits(any_hit):
    """On the box with three spheres, 1,000 rays: the visits are the nodes
    each ray visited, in preorder; a warp's union takes at least as many
    steps as its longest ray, at least one window, never more windows than
    steps, and the prefetch leaves no more dependent loads than windows."""
    scene, bvh = next(_skip_scenes())
    tris = scene.triangles
    rng = np.random.default_rng(53)
    soup = tuple(x.numpy() for x in (tris.p0, tris.e1, tris.e2))
    o, d = (torch.from_numpy(x) for x in S.aimed_rays(rng, 1000, *soup,
                                                      box=3.0))
    t_max = torch.where(torch.arange(1000) % 7 == 3, -1.0, 1e30)
    _, st = walk_skip_plain(bvh, tris, o, d, 1e-4, t_max, any_hit,
                            with_stats=True)
    v = st.visits.numpy()
    assert len(v) == int(st.nodes.sum())
    assert np.array_equal(np.bincount(v[:, 0], minlength=1000),
                          st.nodes.numpy())
    order = np.lexsort((np.arange(len(v)), v[:, 0]))
    same = v[order][1:, 0] == v[order][:-1, 0]
    assert (np.diff(v[order][:, 1])[same] > 0).all()
    out = warp_windows(v, 1000)
    assert out["warps"] == -(-1000 // 32)
    longest = np.pad(st.nodes.numpy(), (0, 24)).reshape(-1, 32).max(1)
    assert out["steps"] >= longest.mean()
    assert 1 <= out["windows_at_cursor"] <= out["steps"]
    assert out["dependent_loads"] <= out["windows"] <= out["steps"]
