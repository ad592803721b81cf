"""Tests of the port that need a CUDA device: the hand-written kernels against
their plain PyTorch versions, and a render on the card against the same
render on the CPU. They skip where there is no card. This file imports no
JAX (the card's machine has none); run it there with

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
from gfxexp_torch.accel import instanced, persistent, widerow  # noqa: E402
from gfxexp_torch.accel.bvh_build import build_bvh  # noqa: E402
from gfxexp_torch.accel.instanced import (  # noqa: E402
    GROUP,
    build_instanced,
    walk_instanced_cuda,
    walk_instanced_plain,
    walk_tlas,
)
from gfxexp_torch.accel.lanegroup import (  # noqa: E402
    intersect_closest_lanegroup,
    walk_lanegroup_cuda,
    walk_lanegroup_plain,
)
from gfxexp_torch.accel.persistent import (  # noqa: E402
    walk_chunked_cuda,
    walk_chunked_plain,
    walk_cuda,
    walk_plain,
)
from gfxexp_torch.accel.qrow import (  # noqa: E402
    build_qrow,
    walk_qrow_cuda,
    walk_qrow_plain,
)
from gfxexp_torch.accel.rowcursor import intersect_any_rowcursor  # noqa: E402
from gfxexp_torch.accel.skip_traverse import walk_skip_cuda  # noqa: E402
from gfxexp_torch.accel.skiplink import (  # noqa: E402
    build_skip_links,
    walk_skip_plain,
)
from gfxexp_torch.accel.traverse import intersect_any  # noqa: E402
from gfxexp_torch.accel.traverse import intersect_closest  # noqa: E402
from gfxexp_torch.accel.widerow import build_widerow  # noqa: E402
from gfxexp_torch.csrc.build import header_constant  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera  # noqa: E402
from gfxexp_torch.scene import animation  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402
from gfxexp_torch.walk_trips import warp_windows  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _launches(prefix):
    """The walk launches counted under `prefix` (utils/trace.py), by the
    rest of the counter's name; a kernel never launched is absent."""
    return {k[len(prefix):]: v for k, v in trace.counters(prefix).items()}


def _soup_table(arity, n=2000, seed=1234):
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=(n, 3)).astype(np.float32)
    e1 = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    return build_widerow(p0, e1, e2, arity=arity)[0]


def _rays(n, seed=5):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("arity", [4, 8])
def test_kernel_matches_plain(dev, arity):
    """Both instantiations, dead lanes included: the kernel and the plain
    version round the same operations in the same order (--fmad=false),
    so their results are identical."""
    tb = _soup_table(arity).to(dev)
    o, d = (x.to(dev) for x in _rays(20000))
    t_max = torch.where(torch.arange(20000, device=dev) % 5 == 0, -1.0, 4.0)
    for any_hit in (False, True):
        k = walk_cuda(tb, o, d, 1e-4, t_max, any_hit)
        p = walk_plain(tb, o, d, 1e-4, t_max, any_hit)
        torch.cuda.synchronize()
        assert torch.equal(k.hit, p.hit) and torch.equal(k.tri, p.tri)
        assert torch.equal(k.t, p.t) and torch.equal(k.u, p.u)
        assert not k.hit[t_max < 0].any()


def test_wrappers_launch_the_kernel_and_count(dev):
    tb = _soup_table(4, n=300).to(dev)
    o, d = (x.to(dev) for x in _rays(1000))
    trace.reset_counters("walk.")
    intersect_closest(tb, None, o, d)
    intersect_any(tb, None, o, d)
    intersect_any(tb, None, o[:0], d[:0])  # nothing to launch
    assert _launches("walk.kernel1.") == {"closest": 1, "any": 1}


def test_oversized_stack_raises(dev):
    tb = _soup_table(4, n=300).to(dev)
    tb.max_depth = 100  # (100 + 2) * 3 entries > the kernel's bound
    o, d = (x.to(dev) for x in _rays(16))
    with pytest.raises(ValueError, match="stack"):
        walk_cuda(tb, o, d, 1e-4, 1e30, any_hit=False)


def test_render_on_card_matches_cpu(dev):
    ts, tb = compile_scene(S.box_scene(TB), traversal="widerow")
    tc = make_camera(**S.BOX_CAMERA)
    cfg = tpt.PTConfig(max_path_length=4, count_rays=True)
    a, na = tpt.render_accumulate(ts.to(dev), tb.to(dev), tc.to(dev), 32, 32,
                                  0, 2, cfg)
    b, nb = tpt.render_accumulate(ts, tb, tc, 32, 32, 0, 2, cfg)
    assert torch.isfinite(a).all()
    assert S.image_rel_diff(a.cpu().numpy(), b.numpy()) < 5e-3
    assert abs(float(na) - float(nb)) <= 5e-3 * float(nb)


def _instanced(rebraid):
    rng = np.random.default_rng(7)
    p = S.soup(rng, 300, 1.0)
    q = S.soup(rng, 120, 0.7)
    inst = S.grid_instances(5, 4)
    for j in range(0, 20, 3):
        inst[j] = (1, inst[j][1])
    return build_instanced([p, q], inst, rebraid=rebraid)[0]


def _instanced_rays(n, seed=9):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 13, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("rebraid", [0.0, 3.0])
@pytest.mark.parametrize("route", ["nearest", "build", "sorted"])
def test_instanced_kernel_matches_plain(dev, route, rebraid):
    """Each route of the two-level walk, closest and any hit, dead rays
    included: kernel and plain version visit the same entries in the same
    order with the same arithmetic, so their results (t, u, v, tri, hit,
    entry) are identical."""
    acc = _instanced(rebraid).to(dev)
    o, d = (x.to(dev) for x in _instanced_rays(20000))
    t_max = torch.where(torch.arange(20000, device=dev) % 5 == 0, -1.0, 6.0)
    for any_hit in (False, True):
        if route == "sorted":
            k, ke = walk_tlas(walk_instanced_cuda, acc, o, d, 1e-4, t_max,
                              any_hit)
            p, pe = walk_tlas(walk_instanced_plain, acc, o, d, 1e-4, t_max,
                              any_hit)
        else:
            k, ke = walk_instanced_cuda(acc, o, d, 1e-4, t_max, any_hit,
                                        route)
            p, pe = walk_instanced_plain(acc, o, d, 1e-4, t_max, any_hit,
                                         route)
        torch.cuda.synchronize()
        assert k.hit.any() and not k.hit[t_max < 0].any()
        for f in ("hit", "t", "u", "v", "tri"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f
        assert torch.equal(ke, pe)


def _stacked_rays(o, d, dev):
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    return o, d, _dead_every_fifth(o.shape[0], dev)


def _overflow_share(lo, hi, o, d, t_max):
    """Share of live rays that enter more boxes than the pick keeps."""
    near = instanced._instance_entry_dists(lo, hi, o, d,
                                           torch.full_like(t_max, 1e-4),
                                           t_max)
    over = (near < t_max[:, None]).sum(1) > header_constant("kPick")
    return float(over[t_max >= 0].float().mean())


@pytest.mark.parametrize("route", ["nearest", "sorted", "build"])
def test_instanced_overflow_matches_plain(dev, route):
    """300 open frames stacked along the rays: most rays enter more entry
    boxes than the pick keeps and miss most frames, so its buffer runs dry
    and refills. The nearest-first kernel (and the ray-sorted route's) still
    equals the plain version, closest and any hit; so does the build-order
    kernel, whose lanes each visit many candidates of a window."""
    blas, inst, o, d = S.stacked_frames()
    acc = build_instanced(blas, inst)[0].to(dev)
    o, d, t_max = _stacked_rays(o, d, dev)
    assert _overflow_share(acc.chunk_lo, acc.chunk_hi, o, d, t_max) > 0.5
    for any_hit in (False, True):
        if route == "sorted":
            k, ke = walk_tlas(walk_instanced_cuda, acc, o, d, 1e-4, t_max,
                              any_hit)
            p, pe = walk_tlas(walk_instanced_plain, acc, o, d, 1e-4, t_max,
                              any_hit)
        else:
            k, ke = walk_instanced_cuda(acc, o, d, 1e-4, t_max, any_hit,
                                        route)
            p, pe = walk_instanced_plain(acc, o, d, 1e-4, t_max, any_hit,
                                         route)
        torch.cuda.synchronize()
        assert k.hit.any() and not k.hit[t_max >= 0].all()
        for f in ("hit", "t", "u", "v", "tri"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f
        assert torch.equal(ke, pe)


@pytest.mark.parametrize("fmt", ["widerow", "qrow"])
def test_chunked_overflow_matches_plain(dev, fmt):
    """The stacked frames flattened into chunk tables at a small max_rows
    (75-85 chunks along the rays): kernel 2 and the quantized walk equal
    their plain versions on rays that enter more chunk boxes than the pick
    keeps, closest and any hit."""
    blas, inst, o, d = S.stacked_frames()
    soup = S.flatten(blas, inst)
    if fmt == "widerow":
        tb = build_widerow(*soup, arity=4, max_rows=60)[0]
        kwalk, pwalk = walk_chunked_cuda, walk_chunked_plain
    else:
        tb = build_qrow(*soup, max_rows=40)[0]
        kwalk, pwalk = walk_qrow_cuda, walk_qrow_plain
    tb = tb.to(dev)
    o, d, t_max = _stacked_rays(o, d, dev)
    assert _overflow_share(tb.chunk_lo, tb.chunk_hi, o, d, t_max) > 0.5
    for any_hit in (False, True):
        k = kwalk(tb, o, d, 1e-4, t_max, any_hit)
        p = pwalk(tb, o, d, 1e-4, t_max, any_hit)
        torch.cuda.synchronize()
        assert k.hit.any() and not k.hit[t_max >= 0].all()
        for f in ("hit", "t", "u", "v", "tri"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f


def test_instanced_wrappers_launch_and_count(dev):
    acc = _instanced(0.0).to(dev)
    o, d = (x.to(dev) for x in _instanced_rays(1000))
    trace.reset_counters("walk.")
    intersect_closest(acc, None, o, d)
    intersect_any(acc, None, o, d)
    acc.use_tlas = True
    intersect_closest(acc, None, o, d)
    assert _launches("walk.instanced.") == {
        "closest_nearest": 1, "any_nearest": 1, "closest_sorted": 1}


def test_instanced_oversized_stack_raises(dev):
    acc = _instanced(0.0).to(dev)
    acc.max_depth = 100
    o, d = (x.to(dev) for x in _instanced_rays(16))
    with pytest.raises(ValueError, match="stack"):
        walk_instanced_cuda(acc, o, d, 1e-4, 1e30, False, "nearest")


def test_instanced_render_on_card_matches_cpu(dev):
    ts, acc = compile_scene(S.instanced_spheres_scene(TB),
                            traversal="instanced")
    tc = make_camera(**S.INSTANCED_CAMERA)
    cfg = tpt.PTConfig(max_path_length=4, count_rays=True)
    a, na = tpt.render_accumulate(ts.to(dev), acc.to(dev), tc.to(dev), 32,
                                  32, 0, 2, cfg)
    b, nb = tpt.render_accumulate(ts, acc, tc, 32, 32, 0, 2, cfg)
    assert torch.isfinite(a).all()
    assert S.image_rel_diff(a.cpu().numpy(), b.numpy()) < 5e-3
    assert abs(float(na) - float(nb)) <= 5e-3 * float(nb)


def _skip_frames(dev):
    """The box with three spheres compiled skip, at frame 0 and after two
    frames of animation (refit boxes), on the card."""
    ts, tb = compile_scene(S.instanced_spheres_scene(TB), traversal="skip")
    ts, tb = ts.to(dev), tb.to(dev)
    out = [(ts, tb)]
    for t in (0.4, 0.9):
        ts, tb = animation.advance_frame(
            ts, tb, S.spheres_controllers(animation), t)
    out.append((ts, tb))
    return out


@pytest.mark.parametrize("scope", ["thread", "warp", "block"])
def test_skip_kernel_matches_plain(dev, scope):
    """Each cursor scope, closest and any hit, dead rays and a ragged last
    block included, before and after a refit: the kernel equals the plain
    version bit for bit (a shared cursor visits more nodes, never finds
    other hits)."""
    n = 20000
    rng = np.random.default_rng(13)
    o = torch.from_numpy(rng.uniform(-1.8, 1.8, (n, 3)).astype(
        np.float32)).to(dev)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True)).to(dev)
    t_max = torch.where(torch.arange(n, device=dev) % 5 == 0, -1.0, 3.0)
    for ts, tb in _skip_frames(dev):
        for any_hit in (False, True):
            k = walk_skip_cuda(tb, ts.triangles, o, d, 1e-4, t_max, any_hit,
                               scope)
            p = walk_skip_plain(tb, ts.triangles, o, d, 1e-4, t_max, any_hit)
            torch.cuda.synchronize()
            assert k.hit.any() and not k.hit[t_max < 0].any()
            for f in ("hit", "t", "u", "v", "tri"):
                assert torch.equal(getattr(k, f), getattr(p, f)), f


def test_skip_wrappers_launch_and_count(dev):
    ts, tb = _skip_frames(dev)[0]
    o, d = (x.to(dev) for x in _rays(1000))
    trace.reset_counters("walk.")
    intersect_closest(tb, ts.triangles, o, d)
    intersect_any(tb, ts.triangles, o, d)
    intersect_any_rowcursor(tb, ts.triangles, o, d)
    walk_skip_cuda(tb, ts.triangles, o, d, 1e-4, 1e30, False, "block")
    assert _launches("walk.skip.") == {
        "closest_thread": 1, "any_thread": 1, "any_warp": 1,
        "closest_block": 1}


def test_animated_render_on_card_matches_cpu(dev):
    ts, tb = _skip_frames(dev)[1]
    tc = make_camera(**S.INSTANCED_CAMERA)
    cfg = tpt.PTConfig(max_path_length=4, count_rays=True)
    a, na = tpt.render_accumulate(ts, tb, tc.to(dev), 32, 32, 0, 2, cfg)
    b, nb = tpt.render_accumulate(ts.to("cpu"), tb.to("cpu"), tc, 32, 32, 0,
                                  2, cfg)
    assert torch.isfinite(a).all()
    assert S.image_rel_diff(a.cpu().numpy(), b.numpy()) < 5e-3
    assert float(na) == float(nb)


def _chunked_table(arity, max_rows):
    rng = np.random.default_rng(17)
    p0, e1, e2 = S.soup(rng, 3000, 6.0)
    return build_widerow(p0, e1, e2, arity=arity, max_rows=max_rows)[0], (
        p0, e1, e2)


def _aimed(soup, n=20000, seed=19):
    o, d = S.aimed_rays(np.random.default_rng(seed), n, *soup)
    return torch.from_numpy(o), torch.from_numpy(d)


def _dead_every_fifth(n, dev, t=1e30):
    return torch.where(torch.arange(n, device=dev) % 5 == 0, -1.0, t)


@pytest.mark.parametrize("arity", [4, 8])
@pytest.mark.parametrize("max_rows", [300, 13000])
def test_chunked_kernel_matches_plain(dev, arity, max_rows):
    """Kernel 2 over chunk tables (nearest-first chunks) and over one table
    without chunk boxes (the route with the switch off), closest and any
    hit: identical to the plain walk."""
    tb, soup = _chunked_table(arity, max_rows)
    assert (tb.num_chunks > 4) == (max_rows == 300)
    tb = tb.to(dev)
    o, d = (x.to(dev) for x in _aimed(soup))
    t_max = _dead_every_fifth(o.shape[0], dev)
    for any_hit in (False, True):
        k = walk_chunked_cuda(tb, o, d, 1e-4, t_max, any_hit)
        p = walk_chunked_plain(tb, o, d, 1e-4, t_max, any_hit)
        torch.cuda.synchronize()
        assert k.hit.any() and not k.hit[t_max < 0].any()
        for f in ("hit", "t", "u", "v", "tri"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.parametrize("max_rows", [200, 26000])
def test_qrow_kernel_matches_plain(dev, max_rows):
    rng = np.random.default_rng(23)
    soup = S.soup(rng, 3000, 6.0)
    qb = build_qrow(*soup, max_rows=max_rows)[0]
    assert (qb.num_chunks > 4) == (max_rows == 200)
    qb = qb.to(dev)
    o, d = (x.to(dev) for x in _aimed(soup))
    n = o.shape[0]
    t_max = _dead_every_fifth(n, dev)
    t_max[torch.arange(n, device=dev) % 11 == 5] = 0.0
    for any_hit in (False, True):
        k = walk_qrow_cuda(qb, o, d, 1e-4, t_max, any_hit)
        p = walk_qrow_plain(qb, o, d, 1e-4, t_max, any_hit)
        torch.cuda.synchronize()
        assert k.hit.any() and not k.hit[t_max < 0].any()
        for f in ("hit", "t", "u", "v", "tri"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.parametrize("arity", [4, 8])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_lanegroup_kernel_matches_plain(dev, groups, arity):
    """Each group count, a ragged last block and dead rays included: the
    kernel equals its plain version bit for bit, and the per-ray walk in
    hits and t."""
    tb = _soup_table(arity, n=3000).to(dev)
    o, d = (x.to(dev) for x in _rays(20001))
    t_max = _dead_every_fifth(20001, dev, 4.0)
    k, kr = walk_lanegroup_cuda(tb, o, d, 1e-4, t_max, groups,
                                with_stats=True)
    p, pr = walk_lanegroup_plain(tb, o, d, 1e-4, t_max, groups,
                                 with_stats=True)
    r = walk_plain(tb, o, d, 1e-4, t_max, False)
    torch.cuda.synchronize()
    assert k.hit.any() and not k.hit[t_max < 0].any()
    for f in ("hit", "t", "u", "v", "tri"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    assert torch.equal(kr, pr)
    assert torch.equal(k.hit, r.hit) and torch.equal(k.t, r.t)


def test_single_level_routes_launch_and_count(dev):
    """Single-chunk tables take kernel 1, chunked ones (and any table with
    the switch off) kernel 2, QRowBVH the quantized walk; the lane-group
    walk only by its own entry point."""
    one = _soup_table(4, n=300).to(dev)
    chunked = _chunked_table(4, 300)[0].to(dev)
    q = build_qrow(*S.soup(np.random.default_rng(2), 300, 3.0))[0].to(dev)
    o, d = (x.to(dev) for x in _rays(1000))
    trace.reset_counters("walk.")
    intersect_closest(one, None, o, d)
    intersect_closest(chunked, None, o, d)
    intersect_any(chunked, None, o, d)
    intersect_closest(q, None, o, d)
    intersect_any(q, None, o, d)
    widerow.set_persistent(False)
    try:
        intersect_any(one, None, o, d)
    finally:
        widerow.set_persistent(None)
    intersect_closest_lanegroup(one, None, o, d, groups=4)
    assert _launches("walk.kernel1.") == {"closest": 1}
    assert _launches("walk.chunked.") == {"closest": 1, "any": 2}
    assert _launches("walk.qrow.") == {"closest": 1, "any": 1}
    assert _launches("walk.lanegroup.") == {"4": 1}


def test_new_kernels_refuse_oversized_stacks(dev):
    chunked = _chunked_table(4, 300)[0].to(dev)
    chunked.max_depth = 100
    q = build_qrow(*S.soup(np.random.default_rng(2), 300, 3.0))[0].to(dev)
    q.max_depth = 100  # (100 + 2) * 7 entries > the kernel's bound
    one = _soup_table(4, n=300).to(dev)
    one.max_depth = 100
    o, d = (x.to(dev) for x in _rays(16))
    with pytest.raises(ValueError, match="stack"):
        walk_chunked_cuda(chunked, o, d, 1e-4, 1e30, False)
    with pytest.raises(ValueError, match="stack"):
        walk_qrow_cuda(q, o, d, 1e-4, 1e30, False)
    with pytest.raises(ValueError, match="stack"):
        walk_lanegroup_cuda(one, o, d, 1e-4, 1e30, 2)


def test_qrow_render_on_card_matches_cpu(dev):
    ts, qb = compile_scene(S.box_scene(TB), traversal="qrow")
    tc = make_camera(**S.BOX_CAMERA)
    cfg = tpt.PTConfig(max_path_length=4, count_rays=True)
    a, na = tpt.render_accumulate(ts.to(dev), qb.to(dev), tc.to(dev), 32, 32,
                                  0, 2, cfg)
    b, nb = tpt.render_accumulate(ts, qb, tc, 32, 32, 0, 2, cfg)
    assert torch.isfinite(a).all()
    assert S.image_rel_diff(a.cpu().numpy(), b.numpy()) < 5e-3
    assert abs(float(na) - float(nb)) <= 5e-3 * float(nb)


def _aimed_at(rng, n, soup, idx):
    """n rays from origins in [-10, 10]^3 aimed at points of the triangles
    `idx` of the soup."""
    p0, e1, e2 = soup
    o = rng.uniform(-10.0, 10.0, size=(n, 3)).astype(np.float32)
    j = rng.choice(idx, n)
    a, b = rng.random((2, n, 1)) * 0.5
    d = p0[j] + a * e1[j] + b * e2[j] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("max_leaf", [1, 4, 8, 16])
def test_skip_kernel_load_batches_match_plain(dev, max_leaf):
    """The per-ray scope's load batches at their edges, every scope, closest
    and any hit, 20,001 rays (not a multiple of the block): leaf batches of
    4 and 8 rows and the one-row loop (1, 16), rays aimed at the leaf that
    holds the table's last triangles (its batch ends at the padding rows)
    and at the last node in preorder (runs clamped at the sentinel row),
    dead rays included: equal to the plain version bit for bit."""
    rng = np.random.default_rng(29)
    soup = S.soup(rng, 3000, 6.0)
    b, perm = build_bvh(*soup, arity=4, max_leaf=max_leaf)
    soup = tuple(x[perm] for x in soup)
    tb = build_skip_links(b.child_min, b.child_max, b.child_idx,
                          b.child_count, max_leaf=max_leaf).to(dev)
    tris = types.SimpleNamespace(
        **{k: torch.from_numpy(x).to(dev)
           for k, x in zip(("p0", "e1", "e2"), soup)})
    first, count = tb.first.cpu().numpy(), tb.count.cpu().numpy()
    leaves = np.nonzero(count > 0)[0]
    end = leaves[np.argmax(first[leaves] + count[leaves])]
    assert first[end] + count[end] == 3000
    edge = np.concatenate([np.arange(first[end], 3000),
                           np.arange(first[leaves[-1]],
                                     first[leaves[-1]] + count[leaves[-1]])])
    n = 20001
    o0, d0 = S.aimed_rays(rng, n // 2, *soup)
    o1, d1 = _aimed_at(rng, n - n // 2, soup, edge)
    o = torch.from_numpy(np.concatenate([o0, o1])).to(dev)
    d = torch.from_numpy(np.concatenate([d0, d1])).to(dev)
    t_max = _dead_every_fifth(n, dev)
    for any_hit in (False, True):
        p = walk_skip_plain(tb, tris, o, d, 1e-4, t_max, any_hit)
        assert p.hit[n // 2:].sum() > n // 4
        for scope in ("thread", "warp", "block"):
            k = walk_skip_cuda(tb, tris, o, d, 1e-4, t_max, any_hit, scope)
            torch.cuda.synchronize()
            for f in ("hit", "t", "u", "v", "tri"):
                assert torch.equal(getattr(k, f), getattr(p, f)), (scope, f)


@pytest.mark.parametrize("arity", [4, 8])
@pytest.mark.parametrize("max_rows", [300, 13000])
def test_chunked_kernel_leaf_rows_match_plain(dev, arity, max_rows):
    """Kernel 2's one load batch a row: leaf rows of 1 to 5 triangles
    (max_leaf 5, so a leaf of more than the first batch's triangles loads
    the rest), arity 4 and 8, chunk tables and one table walked whole (no
    chunk boxes), 20,001 rays with dead ones, closest and any hit: equal to
    the plain version bit for bit."""
    rng = np.random.default_rng(31)
    soup = S.soup(rng, 3000, 6.0)
    tb, perm = build_widerow(*soup, arity=arity, max_leaf=5,
                             max_rows=max_rows)
    assert (tb.num_chunks > 1) == (max_rows == 300)
    rows = tb.nodes.reshape(-1, 64)
    counts = rows.view(torch.int32)[rows[:, 63] > 0.5, 60] >> 24
    assert set(range(1, 6)) <= set(counts.tolist())
    tb = tb.to(dev)
    o, d = S.aimed_rays(rng, 20001, *(x[perm] for x in soup))
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_max = _dead_every_fifth(o.shape[0], dev)
    for any_hit in (False, True):
        k = walk_chunked_cuda(tb, o, d, 1e-4, t_max, any_hit)
        p = walk_chunked_plain(tb, o, d, 1e-4, t_max, any_hit)
        torch.cuda.synchronize()
        assert k.hit.any() and not k.hit[t_max < 0].any()
        for f in ("hit", "t", "u", "v", "tri"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f


def test_chunked_kernel_fed_grid_matches_plain(dev):
    """Kernel 2's persistent grid, whose warps take 32 rays at a time from
    a counter, on 600,001 rays (several times what the card holds at once,
    and not a multiple of 32) over chunk tables, closest and any hit, with
    dead rays: equal to the plain version bit for bit, every ray written.
    Each launch leaves the stream's counters at zero for the next: launches
    back to back, a smaller batch after a larger, and a launch on a second
    stream (counters of its own) all give the same results."""
    tb, soup = _chunked_table(4, 300)
    assert tb.num_chunks > 4
    tb = tb.to(dev)
    o, d = (x.to(dev) for x in _aimed(soup, n=600001, seed=43))
    t_max = _dead_every_fifth(o.shape[0], dev)
    side = torch.cuda.Stream(dev)
    trace.reset_counters("walk.")
    for any_hit in (False, True):
        p = walk_chunked_plain(tb, o, d, 1e-4, t_max, any_hit)
        runs = [walk_chunked_cuda(tb, o, d, 1e-4, t_max, any_hit)
                for _ in range(3)]
        small = walk_chunked_cuda(tb, o[:1001], d[:1001], 1e-4,
                                  t_max[:1001], any_hit)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            runs.append(walk_chunked_cuda(tb, o, d, 1e-4, t_max, any_hit))
        torch.cuda.synchronize()
        assert p.hit.any() and not p.hit[t_max < 0].any()
        for k in runs:
            for f in ("hit", "t", "u", "v", "tri"):
                assert torch.equal(getattr(k, f), getattr(p, f)), f
        for f in ("hit", "t", "u", "v", "tri"):
            assert torch.equal(getattr(small, f), getattr(p, f)[:1001]), f
    assert _launches("walk.chunked.") == {"closest": 5, "any": 5}
    for c in persistent._grid_counters.values():
        assert c.tolist() == [0, 0]


def test_chunked_kernel_many_chunks_matches_plain(dev):
    """Kernel 2 over more chunk boxes than one shared-memory tile holds
    (800 > kBoxTile): each ray's scan reads the boxes through __ldg instead
    of a staged tile, closest and any hit: equal to the plain version."""
    soup = S.soup(np.random.default_rng(47), 4000, 6.0)
    tb = build_widerow(*soup, max_rows=3)[0]
    assert tb.num_chunks > header_constant("kBoxTile")
    tb = tb.to(dev)
    o, d = (x.to(dev) for x in _aimed(soup, n=20001, seed=53))
    t_max = _dead_every_fifth(o.shape[0], dev)
    for any_hit in (False, True):
        k = walk_chunked_cuda(tb, o, d, 1e-4, t_max, any_hit)
        p = walk_chunked_plain(tb, o, d, 1e-4, t_max, any_hit)
        torch.cuda.synchronize()
        assert k.hit.any() and not k.hit[t_max < 0].any()
        for f in ("hit", "t", "u", "v", "tri"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f


def _equal_fields(k, p, n=None):
    for f in ("hit", "t", "u", "v", "tri"):
        a, b = getattr(k, f), getattr(p, f)
        assert torch.equal(a, b if n is None else b[:n]), f


def _leafy_table(arity, max_leaf, n=1500, seed=61):
    rng = np.random.default_rng(seed)
    soup = S.soup(rng, n, 6.0)
    tb, perm = build_widerow(*soup, arity=arity, max_leaf=max_leaf)
    return tb, tuple(x[perm] for x in soup), rng


@pytest.mark.parametrize("arity", [4, 8])
@pytest.mark.parametrize("max_leaf", [1, 2, 3, 4, 5])
def test_kernel_refill_leaf_sizes_match_plain(dev, arity, max_leaf):
    """Kernel 1's per-lane refill over tables of arity 4 and 8 with leaves
    of 1 to 5 triangles, on 1,000 rays (not a multiple of the block or of a
    warp) with dead ones, closest and any hit: equal to the plain version
    bit for bit."""
    tb, soup, rng = _leafy_table(arity, max_leaf)
    assert tb.num_chunks == 1 and tb.max_leaf == max_leaf
    tb = tb.to(dev)
    o, d = S.aimed_rays(rng, 1000, *soup)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_max = _dead_every_fifth(1000, dev)
    for any_hit in (False, True):
        k = walk_cuda(tb, o, d, 1e-4, t_max, any_hit)
        p = walk_plain(tb, o, d, 1e-4, t_max, any_hit)
        torch.cuda.synchronize()
        assert p.hit.any()
        _equal_fields(k, p)


@pytest.mark.parametrize("n", [1, 33, 1000])
def test_kernel_refill_small_batches_match_plain(dev, n):
    """Batches of 1 ray, 33 rays (a warp and one) and 1,000 (not a multiple
    of 128): every ray is written, equal to the plain version."""
    tb, soup, rng = _leafy_table(4, 4)
    tb = tb.to(dev)
    o, d = S.aimed_rays(rng, n, *soup)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    for any_hit in (False, True):
        k = walk_cuda(tb, o, d, 1e-4, 1e30, any_hit)
        p = walk_plain(tb, o, d, 1e-4, 1e30, any_hit)
        torch.cuda.synchronize()
        _equal_fields(k, p)


def test_kernel_refill_dead_rays_match_plain(dev):
    """A batch whose rays are all dead (t_max < 0: each ends as it is
    taken) and one where all but every 97th are: equal to the plain
    version, the dead rays' t_max and no hit written back."""
    tb, soup, rng = _leafy_table(4, 4)
    tb = tb.to(dev)
    o, d = S.aimed_rays(rng, 5000, *soup)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    idx = torch.arange(5000, device=dev)
    for t_max in (torch.full((5000,), -2.0, device=dev),
                  torch.where(idx % 97 == 0, 1e30, -1.0)):
        for any_hit in (False, True):
            k = walk_cuda(tb, o, d, 1e-4, t_max, any_hit)
            p = walk_plain(tb, o, d, 1e-4, t_max, any_hit)
            torch.cuda.synchronize()
            _equal_fields(k, p)
            assert torch.equal(k.t[t_max < 0], t_max[t_max < 0])
            assert not k.hit[t_max < 0].any()


def test_kernel_refill_fed_grid_matches_plain(dev):
    """Kernel 1's persistent grid on 600,001 rays (many times what the card
    holds at once), closest and any hit: launches back to back, a smaller
    batch after a larger, and a launch on a second stream (counters of its
    own) all equal the plain version; every stream's counters are back at
    zero after."""
    tb, soup, rng = _leafy_table(4, 4)
    tb = tb.to(dev)
    o, d = S.aimed_rays(rng, 600001, *soup)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_max = _dead_every_fifth(o.shape[0], dev)
    side = torch.cuda.Stream(dev)
    trace.reset_counters("walk.")
    for any_hit in (False, True):
        p = walk_plain(tb, o, d, 1e-4, t_max, any_hit)
        runs = [walk_cuda(tb, o, d, 1e-4, t_max, any_hit) for _ in range(3)]
        small = walk_cuda(tb, o[:1001], d[:1001], 1e-4, t_max[:1001],
                          any_hit)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            runs.append(walk_cuda(tb, o, d, 1e-4, t_max, any_hit))
        torch.cuda.synchronize()
        assert p.hit.any()
        for k in runs:
            _equal_fields(k, p)
        _equal_fields(small, p, 1001)
    assert _launches("walk.kernel1.") == {"closest": 5, "any": 5}
    for c in persistent._grid_counters.values():
        assert c.tolist() == [0, 0]


def _entries(acc, count):
    """acc cut to its first `count` entries (0 included)."""
    return dataclasses.replace(
        acc, blas_ids=acc.blas_ids[:count].contiguous(),
        inv_transforms=acc.inv_transforms[:count].contiguous(),
        inst_of_chunk=acc.inst_of_chunk[:count].contiguous(),
        chunk_lo=acc.chunk_lo[:count].contiguous(),
        chunk_hi=acc.chunk_hi[:count].contiguous(),
        start_rows=None if acc.start_rows is None
        else acc.start_rows[:count].contiguous())


def _build_order_case(acc, dev, n=20001, seed=67, span=None):
    """The build-order kernel against the plain version on n rays from
    origins spread over `span` (lo, hi [3]; default the entries' boxes),
    random directions, every fifth ray dead: (closest, any) plain hits."""
    if span is None:
        span = (acc.chunk_lo.amin(0).numpy(), acc.chunk_hi.amax(0).numpy())
    acc = acc.to(dev)
    rng = np.random.default_rng(seed)
    o = rng.uniform(span[0] - 1.0, span[1] + 1.0,
                    size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_max = _dead_every_fifth(n, dev, 6.0)
    out = []
    for any_hit in (False, True):
        k, ke = walk_instanced_cuda(acc, o, d, 1e-4, t_max, any_hit, "build")
        p, pe = walk_instanced_plain(acc, o, d, 1e-4, t_max, any_hit,
                                     "build")
        torch.cuda.synchronize()
        _equal_fields(k, p)
        assert torch.equal(ke, pe)
        assert not k.hit[t_max < 0].any()
        out.append(p)
    return out


@pytest.mark.parametrize("count", [0, 1, 31, 32, 33])
def test_build_order_window_edges_match_plain(dev, count):
    """The build-order kernel over 0, 1, 31, 32 and 33 entries (no window,
    one partial window, one full, one full and one of a single entry),
    closest and any hit: equal to the plain version bit for bit (t, u, v,
    tri, hit, entry)."""
    rng = np.random.default_rng(71)
    blas = [S.soup(rng, 200, 1.0), S.soup(rng, 90, 0.7)]
    inst = S.grid_instances(6, 6, spacing=1.5)
    for j in range(0, 36, 4):
        inst[j] = (1, inst[j][1])
    full = build_instanced(blas, inst)[0]
    acc = _entries(full, count)
    assert acc.num_entries == count
    closest, _ = _build_order_case(acc, dev, span=(
        full.chunk_lo.amin(0).numpy(), full.chunk_hi.amax(0).numpy()))
    assert closest.hit.any() == (count > 0)


def test_build_order_many_entries_match_plain(dev):
    """2,056 entries (64 full windows and a partial one; `city` with
    rebraid4 has as many): equal to the plain version, closest and any hit,
    whose early stops end a lane's list in mid-window."""
    rng = np.random.default_rng(73)
    blas = [S.soup(rng, 60, 0.8), S.soup(rng, 40, 0.6)]
    inst = S.grid_instances(46, 45, spacing=1.0)[:2056]
    for j in range(0, 2056, 3):
        inst[j] = (1, inst[j][1])
    acc = build_instanced(blas, inst)[0]
    assert acc.num_entries == 2056 and acc.num_entries % GROUP
    closest, any_hit = _build_order_case(acc, dev, n=30001)
    assert closest.hit.any() and any_hit.hit.any()


def test_build_order_rebraid_start_rows_match_plain(dev):
    """The build-order kernel on a rebraided build (entries that start at
    inner BLAS rows, several a window): equal to the plain version."""
    acc = _instanced(4.0)
    assert acc.start_rows is not None and int(acc.start_rows.max()) > 0
    closest, _ = _build_order_case(acc, dev)
    assert closest.hit.any()


def test_build_order_fed_grid_and_groups(dev):
    """The build-order kernel's persistent grid on 300,001 rays, launched
    three times, once on a second stream, and once after the entry boxes
    were moved in place (the cached window boxes are rebuilt): each equal
    to the plain version, the counters back at zero, and the window boxes
    the union of their 32 entries' boxes."""
    acc = _instanced(0.0).to(dev)
    o, d = (x.to(dev) for x in _instanced_rays(300001))
    t_max = _dead_every_fifth(o.shape[0], dev, 6.0)
    side = torch.cuda.Stream(dev)
    trace.reset_counters("walk.")
    p, pe = walk_instanced_plain(acc, o, d, 1e-4, t_max, False, "build")
    runs = [walk_instanced_cuda(acc, o, d, 1e-4, t_max, False, "build")
            for _ in range(2)]
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        runs.append(walk_instanced_cuda(acc, o, d, 1e-4, t_max, False,
                                        "build"))
    torch.cuda.synchronize()
    for k, ke in runs:
        _equal_fields(k, p)
        assert torch.equal(ke, pe)
    glo, ghi = instanced._cached_groups(acc, acc.chunk_lo, acc.chunk_hi)
    assert torch.equal(glo[0], acc.chunk_lo[:GROUP].amin(0))
    assert torch.equal(ghi[0], acc.chunk_hi[:GROUP].amax(0))
    acc.chunk_lo[:] -= 1.0  # every entry box grows: more candidates
    p, pe = walk_instanced_plain(acc, o, d, 1e-4, t_max, False, "build")
    k, ke = walk_instanced_cuda(acc, o, d, 1e-4, t_max, False, "build")
    torch.cuda.synchronize()
    _equal_fields(k, p)
    assert torch.equal(ke, pe)
    assert _launches("walk.instanced.")["closest_build"] == 4
    for c in persistent._grid_counters.values():
        assert c.tolist() == [0, 0]


def _skip_soup(n_tris, max_leaf, seed=43, spread=6.0):
    """A skip-link table over a random soup (in traversal order) and the
    soup's triangles on the card."""
    rng = np.random.default_rng(seed)
    soup = S.soup(rng, n_tris, spread)
    b, perm = build_bvh(*soup, arity=4, max_leaf=max_leaf)
    soup = tuple(x[perm] for x in soup)
    tb = build_skip_links(b.child_min, b.child_max, b.child_idx,
                          b.child_count, max_leaf=max_leaf)
    return tb, soup, rng


def _on(dev, soup, *rays):
    tris = types.SimpleNamespace(
        **{k: torch.from_numpy(x).to(dev)
           for k, x in zip(("p0", "e1", "e2"), soup)})
    return (tris,) + tuple(torch.from_numpy(x).to(dev) for x in rays)


def _warp_equals_plain(tb, tris, o, d, t_max):
    """The warp scope against the plain walk, closest and any hit; returns
    the plain closest hits."""
    out = None
    for any_hit in (False, True):
        p = walk_skip_plain(tb, tris, o, d, 1e-4, t_max, any_hit)
        k = walk_skip_cuda(tb, tris, o, d, 1e-4, t_max, any_hit, "warp")
        torch.cuda.synchronize()
        _equal_fields(k, p)
        assert not k.hit[t_max < 0].any()
        out = out if any_hit else p
    return out


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000])
def test_skip_warp_small_batches_match_plain(dev, n):
    """Kernel 8 (the warp scope, a window of 32 nodes a warp) on batches of
    1, 31, 32, 33 and 1,000 rays (ragged warps and blocks), every third ray
    dead (t_max < 0): equal to the plain version bit for bit."""
    tb, soup, rng = _skip_soup(2000, 4)
    tris, o, d = _on(dev, soup, *S.aimed_rays(rng, n, *soup))
    t_max = torch.where(torch.arange(n, device=dev) % 3 == 1, -1.0, 1e30)
    p = _warp_equals_plain(tb.to(dev), tris, o, d, t_max)
    assert p.hit.any() or n == 1


@pytest.mark.parametrize("n_tris, max_leaf", [(3, 1), (20, 1), (45, 1),
                                              (200, 4), (600, 8)])
def test_skip_warp_table_ends_match_plain(dev, n_tris, max_leaf):
    """Kernel 8 on tables of fewer than 32 nodes and of node counts that are
    not a multiple of 32, so the last window is cut at the sentinel row;
    leaves of 1, 4 and 8 triangles: equal to the plain version."""
    tb, soup, rng = _skip_soup(n_tris, max_leaf, spread=2.0)
    m = tb.num_nodes
    assert m < 32 if n_tris <= 20 else m % 32 != 0
    tris, o, d = _on(dev, soup, *S.aimed_rays(rng, 4000, *soup, box=4.0))
    t_max = _dead_every_fifth(4000, dev)
    p = _warp_equals_plain(tb.to(dev), tris, o, d, t_max)
    assert p.hit.any()


@pytest.mark.parametrize("max_leaf", [4, 8])
def test_skip_warp_jumps_past_the_prefetched_window(dev, max_leaf):
    """Warps whose 32 rays all aim at one triangle: their cursor skips whole
    subtrees, past the prefetched window (checked on the plain walk's
    visits: some window change lands past the next window). Equal to the
    plain version."""
    tb, soup, rng = _skip_soup(3000, max_leaf)
    targets = rng.choice(3000, 64)
    o, d = _aimed_at(rng, 64 * 32, soup, targets[:1])
    for w in range(64):
        o[32 * w:32 * w + 32], d[32 * w:32 * w + 32] = _aimed_at(
            rng, 32, soup, targets[w:w + 1])
    tris, o, d = _on(dev, soup, o, d)
    tb = tb.to(dev)
    t_max = torch.full((64 * 32,), 1e30, device=dev)
    _, st = walk_skip_plain(tb, tris, o, d, 1e-4, t_max, False,
                            with_stats=True)
    assert warp_windows(st.visits.cpu().numpy(), 64 * 32)["next_share"] < 1
    p = _warp_equals_plain(tb, tris, o, d, t_max)
    assert p.hit.float().mean() > 0.5


@pytest.mark.parametrize("n", [37, 700, 1000])
@pytest.mark.parametrize("arity", [4, 8])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_lanegroup_ragged_batches_match_plain(dev, groups, arity, n):
    """Kernel 9 (pairs of the lanes that take part, the group's stack in
    shared memory) on ragged batches, every fifth ray dead: equal to its
    plain version bit for bit, rows per ray included."""
    tb = _soup_table(arity, n=3000).to(dev)
    o, d = (x.to(dev) for x in _rays(n, seed=n))
    t_max = _dead_every_fifth(n, dev, 4.0)
    k, kr = walk_lanegroup_cuda(tb, o, d, 1e-4, t_max, groups,
                                with_stats=True)
    p, pr = walk_lanegroup_plain(tb, o, d, 1e-4, t_max, groups,
                                 with_stats=True)
    torch.cuda.synchronize()
    _equal_fields(k, p)
    assert torch.equal(kr, pr)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_lanegroup_idle_warps_and_signed_zero_match_plain(dev, groups):
    """Kernel 9 where no lane of one warp takes part for a whole walk (its
    rays dead or pointed away from every box) while the other warps of its
    group walk, and where rays of one warp enter the same boxes with an
    entry distance of -0.0 and of +0.0 (origins inside the boxes, t_min
    -0.0 beside +0.0; the group's minimum takes -0.0, which the sort network
    compares equal to +0.0): equal to the plain version, rows included."""
    tb = _soup_table(4, n=3000).to(dev)
    o, d = _rays(512, seed=3)
    o = o * 0.2  # inside the soup's boxes
    t_min = torch.where(torch.arange(512) % 2 == 0, -0.0, 0.0)
    t_max = torch.full((512,), 4.0)
    idle = (torch.arange(512) // 32) % 4 == 1  # the second warp of a block
    t_max[idle & (torch.arange(512) % 2 == 0)] = -1.0
    o[idle] = torch.tensor([1e6, 1e6, 1e6])
    d[idle] = torch.tensor([0.0, 1.0, 0.0])
    o, d, t_min, t_max = (x.to(dev) for x in (o, d, t_min, t_max))
    assert bool(torch.signbit(t_min).any())
    k, kr = walk_lanegroup_cuda(tb, o, d, t_min, t_max, groups,
                                with_stats=True)
    p, pr = walk_lanegroup_plain(tb, o, d, t_min, t_max, groups,
                                 with_stats=True)
    r = walk_plain(tb, o, d, t_min, t_max, False)
    torch.cuda.synchronize()
    _equal_fields(k, p)
    assert torch.equal(kr, pr)
    assert int(kr[idle].max()) <= 1 and int(kr[~idle].sum()) > 0
    assert torch.equal(k.hit, r.hit) and torch.equal(k.t, r.t)


# ---------------------------------------------------------------------------
# the screen-space techniques' traffic: shadow rays with dead lanes, the
# G-buffer and SVGF on the card
# ---------------------------------------------------------------------------


def _shadow_batch(ts, n=30000, seed=23):
    """Shadow rays from points in the box toward its lamp, every third lane
    dead (t_max = -1, as restir_di._visibility sends them)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.9, 1.9, (n, 3)).astype(np.float32)
    target = np.concatenate([rng.uniform(-0.4, 0.4, (n, 1)),
                             np.full((n, 1), 1.99),
                             rng.uniform(-0.4, 0.4, (n, 1))], axis=1)
    v = target - o
    dist = np.linalg.norm(v, axis=1)
    d = (v / dist[:, None]).astype(np.float32)
    t_max = np.where(np.arange(n) % 3 == 0, -1.0, 0.9999 * dist)
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max.astype(np.float32)))


@pytest.mark.parametrize("traversal, counts", [
    ("widerow", lambda: _launches("walk.kernel1.").get("any", 0)),
    ("skip", lambda: _launches("walk.skip.").get("any_thread", 0)),
    ("instanced",
     lambda: _launches("walk.instanced.").get("any_nearest", 0))],
    ids=["kernel1", "kernel6", "kernel5"])
def test_any_hit_dead_lanes_match_cpu(dev, traversal, counts):
    """intersect_any on a batch with t_max = -1 lanes mixed in, on kernels
    1, 6 and 5: the dead lanes report not occluded, and every lane equals
    the CPU's plain walk."""
    ts, tb = compile_scene(S.instanced_spheres_scene(TB),
                           traversal=traversal)
    o, d, t_max = _shadow_batch(ts)
    cpu = intersect_any(tb, ts.triangles, o, d, 0.0, t_max)
    trace.reset_counters("walk.")
    ts_d, tb_d = ts.to(dev), tb.to(dev)
    card = intersect_any(tb_d, ts_d.triangles, o.to(dev), d.to(dev), 0.0,
                         t_max.to(dev))
    assert counts() == 1
    card = card.cpu()
    assert not card[t_max < 0].any()
    assert card.any() and not card[t_max >= 0].all()
    assert torch.equal(card, cpu)


def test_gbuffer_on_card_matches_cpu(dev):
    """The G-buffer at 64x64 on the card (kernel 6 after a frame of
    animation) against the CPU's: hit, tri, unit and material equal on
    at least 0.999 of pixels; position, normal and albedo within 1e-4,
    motion within 1e-3 pixels where they agree."""
    from gfxexp_torch.render.gbuffer import render_gbuffer

    ts, tb = _skip_frames(dev)[1]
    tc = make_camera(**S.INSTANCED_CAMERA)
    prev = make_camera(**dict(S.INSTANCED_CAMERA, position=[0.05, 0.5, 1.9]))
    a = render_gbuffer(ts, tb, tc.to(dev), prev.to(dev), 64, 64, 3)
    b = render_gbuffer(ts.to("cpu"), tb.to("cpu"), tc, prev, 64, 64, 3)
    a = a.to("cpu")
    same = ((a.hit == b.hit) & (a.tri == b.tri) & (a.unit == b.unit)
            & (a.material == b.material))
    assert float(same.float().mean()) >= 0.999
    for name, atol in (("position", 1e-4), ("normal", 1e-4),
                       ("albedo", 1e-4), ("motion", 1e-3)):
        x, y = getattr(a, name)[same], getattr(b, name)[same]
        assert torch.allclose(x, y, atol=atol), (name, float(
            (x - y).abs().max()))


def test_svgf_frame_on_card_matches_cpu(dev):
    """Three SVGF frames at 64x64 on the card against the CPU from the same
    G-buffer and seeded lighting: the mean relative image difference under
    1e-4 each frame (exp and pow may round differently on the card)."""
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.techniques.svgf import make_svgf_state, svgf_frame

    ts, tb = compile_scene(S.box_scene(TB), traversal="widerow")
    tc = make_camera(**S.BOX_CAMERA)
    gb = render_gbuffer(ts, tb, tc, tc, 64, 64, 0)
    sa, sb = make_svgf_state(64, 64, dev), make_svgf_state(64, 64, "cpu")
    rng = np.random.default_rng(29)
    for _ in range(3):
        light = torch.from_numpy(rng.gamma(2.0, 0.3, (64, 64, 3)).astype(
            np.float32))
        a, sa = svgf_frame(sa, gb.to(dev), light.to(dev))
        b, sb = svgf_frame(sb, gb, light)
        assert torch.isfinite(a).all()
        assert S.image_rel_diff(a.cpu().numpy(), b.numpy()) < 1e-4


def test_regir_build_and_sample_on_card_match_cpu(dev):
    """Three frames of the ReGIR cell build and sample (widerow walk,
    kernel 1) on the card against the CPU from the same start: every
    slot's selection equal, sum_w and rec_pdf within rtol 1e-4, touch
    counts equal, images within a mean relative difference of 1e-4."""
    from gfxexp_torch.techniques import regir as tg

    ts, tb = compile_scene(S.many_light_scene(TB, 16, occluders=3),
                           traversal="widerow")
    tc = make_camera(position=[0.0, 3.0, 4.0], fov_y=np.deg2rad(50),
                     aspect=1.0, target=[0.0, 0.0, 0.0])
    cfg = tg.ReGIRConfig(grid_dimension=(4, 2, 4),
                         num_light_slots_per_cell=16)
    pt = tpt.PTConfig(max_path_length=3)
    grid = tg.make_grid(ts, cfg)
    sa, sb = tg.make_regir_state(cfg, dev), tg.make_regir_state(cfg, "cpu")
    sd, bd, cd, gd = ts.to(dev), tb.to(dev), tc.to(dev), grid.to(dev)
    for f in range(3):
        sa = tg.build_cell_reservoirs(sd, sa, gd, f, cfg)
        sb = tg.build_cell_reservoirs(ts, sb, grid, f, cfg)
        a = sa.to("cpu")
        assert torch.allclose(a.pos, sb.pos, atol=1e-5)
        assert torch.equal(a.at_inf, sb.at_inf)
        for name in ("sum_w", "rec_pdf", "stream_len"):
            assert torch.allclose(getattr(a, name), getattr(sb, name),
                                  rtol=1e-4, atol=1e-6), name
        ia, sa = tg.render_sample_regir(sd, bd, cd, sa, gd, 32, 32, f, pt,
                                        cfg)
        ib, sb = tg.render_sample_regir(ts, tb, tc, sb, grid, 32, 32, f, pt,
                                        cfg)
        assert torch.equal(sa.num_accesses.cpu(), sb.num_accesses)
        assert S.image_rel_diff(ia.cpu().numpy(), ib.numpy()) < 1e-4
        sa, sb = tg.finalize_frame(sa, f), tg.finalize_frame(sb, f)


def test_nrc_train_step_on_card_matches_cpu(dev):
    """One NRC frame's training (4 steps, the same CPU-drawn permutation)
    on the card against the CPU from the same state, TF32 off: the loss
    within rtol 1e-4 and the trained MLP's predictions on the batch within
    the bf16 bar (rtol 1e-2, atol 1e-4). The triangle wave's params within
    1e-5 on at least 0.999 of entries (measured: all, within 3e-8). The
    hash grid's table gradient is a scatter-add that sums in another order
    on the card, and its features (~1e-4) are rounded to bf16 at the MLP's
    input, so some entries take another Adam step, which is about lr
    whatever the gradient's size: the table within 1e-5 on at least 0.999
    of entries (measured 0.99986), every param within 2 lr of the CPU's
    (measured 5.4e-3)."""
    from gfxexp_torch.core.tree import tree_leaves, tree_map
    from gfxexp_torch.techniques.nrc import network as tn

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.random((1000, 14)).astype(np.float32))
    t = torch.from_numpy(rng.random((1000, 3)).astype(np.float32))
    m = torch.from_numpy(rng.random(1000) < 0.8)
    for enc in ("triangle_wave", "hash_grid"):
        cfg = tn.NRCConfig(position_encoding=enc)
        st = tn.init_nrc(torch.Generator().manual_seed(4), cfg, "cpu")
        st["params"]["weights"][-1] = torch.randn(
            st["params"]["weights"][-1].shape,
            generator=torch.Generator().manual_seed(5)) * 0.1
        dst = tree_map(lambda x: x.to(dev), st)
        a, la = tn.train_on_frame(dst, q.to(dev), t.to(dev), m.to(dev), cfg,
                                  4, torch.Generator().manual_seed(9))
        b, lb = tn.train_on_frame(st, q, t, m, cfg, 4,
                                  torch.Generator().manual_seed(9))
        assert abs(float(la) - float(lb)) <= 1e-4 * abs(float(lb))
        pa = tn.apply(a["params"], q.to(dev), cfg).cpu()
        pb = tn.apply(b["params"], q, cfg)
        assert torch.allclose(pa, pb, rtol=1e-2, atol=1e-4), enc
        diffs = [(x.cpu() - y).abs() for x, y in zip(
            tree_leaves(a["params"]), tree_leaves(b["params"]))]
        checked = diffs if enc == "triangle_wave" else diffs[:1]
        share = float((torch.cat([d.reshape(-1) for d in checked])
                       <= 1e-5).float().mean())
        assert share >= 0.999, (enc, share)
        assert max(float(d.max()) for d in diffs) <= 2 * cfg.learning_rate


@pytest.fixture(scope="module")
def textured_scenes(tmp_path_factory):
    """The textured scene (bench.build_textured_scene) as wide rows and as
    skip links, on the CPU."""
    from gfxexp_torch import bench

    d = str(tmp_path_factory.mktemp("tex"))
    return {t: bench.build_textured_scene(d, traversal=t)
            for t in ("widerow", "skip")}


@pytest.mark.parametrize("traversal", ["widerow", "skip"])
@pytest.mark.parametrize("opts", [
    {}, {"enable_bump_mapping": True, "texture_lod": True},
    {"use_solid_angle_sampling": True}],
    ids=["plain", "bump_lod", "solid_angle"])
def test_textured_render_on_card_matches_cpu(dev, textured_scenes,
                                             traversal, opts):
    """The textured scene at 32x32, 2 samples, on the card (kernel 1 or
    6) against the CPU: mean relative image difference under 5e-3 and
    equal ray counts; solid-angle NEE keeps float32 and its own bar."""
    from gfxexp_torch import bench

    ts, tb = textured_scenes[traversal]
    cam = bench.textured_camera(32, 32)
    cfg = tpt.PTConfig(max_path_length=4, count_rays=True, **opts)
    a, na = tpt.render_accumulate(ts.to(dev), tb.to(dev), cam.to(dev), 32,
                                  32, 0, 2, cfg)
    b, nb = tpt.render_accumulate(ts, tb, cam, 32, 32, 0, 2, cfg)
    a = a.cpu().numpy()
    assert np.isfinite(a).all() and a.mean() > 0
    assert S.image_rel_diff(a, b.numpy()) < 5e-3
    assert float(na) == float(nb)


@pytest.mark.parametrize("traversal, counts", [
    ("widerow", lambda: (_launches("walk.kernel1.").get("closest", 0),
                         _launches("walk.kernel1.").get("any", 0))),
    ("skip", lambda: (_launches("walk.skip.").get("closest_thread", 0),
                      _launches("walk.skip.").get("any_thread", 0)))],
    ids=["kernel1", "kernel6"])
def test_fused_batch_on_card_matches_cpu(dev, textured_scenes, traversal,
                                         counts):
    """fuse_shadow_rays on the card: 4 closest-hit walks of 2N lanes after
    the first (N odd here: 23x17 pixels), no any-hit walk, the image equal
    to the unfused card image (rtol 1e-5, atol 1e-6) and to the CPU's
    (5e-3), the ray counts equal."""
    from gfxexp_torch import bench

    ts, tb = textured_scenes[traversal]
    w, h = 23, 17
    cam = bench.textured_camera(w, h)
    sd, bd, cd = ts.to(dev), tb.to(dev), cam.to(dev)
    out = {}
    for fuse in (False, True):
        cfg = tpt.PTConfig(max_path_length=5, count_rays=True,
                           fuse_shadow_rays=fuse, enable_bump_mapping=True)
        trace.reset_counters("walk.")
        out[fuse] = tpt.render_sample(sd, bd, cd, w, h, 3, cfg) + (
            counts(),)
    (a, na, ca), (b, nb, cb) = out[False], out[True]
    assert ca == (5, 4) and cb == (5, 0)
    assert float(na) == float(nb)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
    cfg = tpt.PTConfig(max_path_length=5, count_rays=True,
                       fuse_shadow_rays=True, enable_bump_mapping=True)
    c, nc = tpt.render_sample(ts, tb, cam, w, h, 3, cfg)
    assert S.image_rel_diff(b.cpu().numpy(), c.numpy()) < 5e-3
    assert float(nc) == float(nb)


@pytest.mark.parametrize("traversal", ["widerow", "skip"])
def test_odd_and_mixed_batches_match_plain(dev, textured_scenes, traversal):
    """A fused batch as the tracer builds it, on kernels 1 and 6: N odd
    bounce rays in block order, then N shadow rays toward random points,
    a third of them empty (t_max < 0); and the same batch less its last
    lane (an odd count). Every lane equals the CPU's plain walk."""
    ts, tb = textured_scenes[traversal]
    rng = np.random.default_rng(21)
    n = 1001
    o = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(0.05, 1.5, n),
                  rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    target = np.stack([rng.uniform(-0.5, 0.5, n), np.full(n, 2.0),
                       rng.uniform(-0.5, 0.5, n)], -1).astype(np.float32)
    sv = target - o
    dist = np.linalg.norm(sv, axis=1)
    stmax = np.where(np.arange(n) % 3 == 0, -1.0, 0.9999 * dist)
    bo = torch.from_numpy(np.concatenate([o, o]))
    bd = torch.from_numpy(np.concatenate([d, sv / dist[:, None]]))
    btmax = torch.from_numpy(np.concatenate(
        [np.full(n, 1e30), stmax]).astype(np.float32))
    for m in (2 * n, 2 * n - 1):
        cpu = intersect_closest(tb, ts.triangles, bo[:m], bd[:m], 0.0,
                                btmax[:m])
        card = intersect_closest(tb.to(dev), ts.triangles.to(dev),
                                 bo[:m].to(dev), bd[:m].to(dev), 0.0,
                                 btmax[:m].to(dev))
        card = card.to("cpu")
        assert torch.equal(card.hit, cpu.hit)
        assert torch.equal(card.tri, cpu.tri)
        assert torch.equal(card.t, cpu.t)
        assert not card.hit[btmax[:m] < 0].any()


def test_textures_stay_on_their_device(dev, textured_scenes):
    """scene.to(card) moves the atlas (layers, mips, offsets) with it;
    sampling a CPU atlas with lanes on the card is an error."""
    from gfxexp_torch.scene.textures import sample_bilinear

    ts, _ = textured_scenes["widerow"]
    sd = ts.to(dev)
    atlas = sd.textures
    for t in (atlas.layers, atlas.mip_flat, atlas.mip_offsets):
        assert t.device.type == "cuda"
    assert atlas.n_levels == ts.textures.n_levels
    uv = torch.rand(64, 2, device=dev)
    tid = torch.zeros(64, dtype=torch.int32, device=dev)
    assert torch.allclose(sample_bilinear(atlas, tid, uv).cpu(),
                          sample_bilinear(ts.textures, tid.cpu(), uv.cpu()),
                          rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="atlas"):
        sample_bilinear(ts.textures, tid, uv)


def test_tfdm_intersect_on_card_matches_cpu(dev):
    """intersect_tfdm_v2 on the tfdm app's patch (-base-res 6, and 32 for
    the prism BVH's walk) on the card against the CPU, 4,096 rays: hits
    agree on >= 0.999 of rays, t within rtol 1e-5 where both hit, steps
    equal on >= 0.99 (chip_smoke.py phase 28's bars)."""
    from gfxexp_torch.apps.tfdm import procedural_height, subdivided_plane
    from gfxexp_torch.techniques import tfdm

    rng = np.random.default_rng(8)
    n = 4096
    o = np.stack([rng.uniform(-1, 1, n), rng.uniform(0.5, 2, n),
                  rng.uniform(-1, 1, n)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-1, 1, n), np.zeros(n),
                  rng.uniform(-1, 1, n)], -1) - o
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                         .astype(np.float32))
    o = torch.from_numpy(o)
    for base in (6, 32):
        pos, idx, uvs, nrm = subdivided_plane(base)
        g = tfdm.build_tfdm_geometry(
            pos, idx, uvs, procedural_height(128),
            params=tfdm.DisplacementParameters(h_scale=0.25), normals=nrm)
        assert (g.prism_bvh is not None) == (base == 32)
        k = tfdm.intersect_tfdm_v2(g.to(dev), o.to(dev), d.to(dev))
        c = tfdm.intersect_tfdm_v2(g, o, d)
        k = k.to(torch.device("cpu"))
        assert (k.hit == c.hit).float().mean() >= 0.999
        both = k.hit & c.hit
        assert both.sum() > 1000
        assert ((k.t[both] - c.t[both]).abs()
                <= 1e-5 * c.t[both].abs()).float().mean() >= 0.999
        assert (k.steps == c.steps).float().mean() >= 0.99


def test_tfdm_app_on_card_matches_cpu(dev, tmp_path):
    """The tfdm app at 32x32, 2 frames, -base-res 8: the card's image
    within 5e-3 (mean relative difference) of its -device cpu image."""
    from gfxexp_torch.apps import tfdm as app

    argv = ["-width", "32", "-height", "32", "-frames", "2", "-base-res",
            "8"]
    a = app.main([*argv, "-output", str(tmp_path / "card")])
    b = app.main([*argv, "-device", "cpu", "-output", str(tmp_path / "cpu")])
    assert np.isfinite(a).all() and a.mean() > 0
    assert S.image_rel_diff(a, b) < 5e-3


def _patch_rays(n, seed):
    """Rays from above the 2x2 patch toward it, a third of them grazing."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-1, 1, n), rng.uniform(0.5, 2, n),
                  rng.uniform(-1, 1, n)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-1, 1, n), np.zeros(n),
                  rng.uniform(-1, 1, n)], -1) - o
    d[: n // 3, 1] *= 0.05
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _tilted_plane(base, tilt=0.3):
    from gfxexp_torch.apps.tfdm import subdivided_plane

    pos, idx, uvs, nrm = subdivided_plane(base)
    nrm = nrm + tilt * pos * np.asarray([[1.0, 0.0, 1.0]], np.float32)
    return pos, idx, uvs, nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)


def _card_agrees(k, c, min_hits):
    """Hits equal on >= 0.999 of rays, t within rtol 1e-4 where both hit
    (chip_smoke.py phase 30's bars)."""
    k = k.to(torch.device("cpu"))
    assert (k.hit == c.hit).float().mean() >= 0.999
    both = k.hit & c.hit
    assert both.sum() > min_hits
    assert ((k.t[both] - c.t[both]).abs()
            <= 1e-4 * c.t[both].abs()).float().mean() >= 0.999


@pytest.mark.parametrize("fn, lit, base", [
    ("intersect_nrtdsm_v2", 2, 6), ("intersect_nrtdsm_v2", 2, 32),
    ("intersect_nrtdsm_exact", 1, 4)])
def test_nrtdsm_intersect_on_card_matches_cpu(dev, fn, lit, base):
    """NRTDSM on a tilted patch (-base-res 32: the prism BVH's walk) on the
    card against the CPU, 4,096 rays."""
    from gfxexp_torch.apps.tfdm import procedural_height
    from gfxexp_torch.techniques import nrtdsm, tfdm

    pos, idx, uvs, nrm = _tilted_plane(base)
    g = nrtdsm.build_nrtdsm_geometry(
        pos, idx, uvs, procedural_height(64), normals=nrm,
        params=tfdm.DisplacementParameters(h_scale=0.25,
                                           local_intersection_type=lit))
    o, d = _patch_rays(4096, 9)
    k = getattr(nrtdsm, fn)(g.to(dev), o.to(dev), d.to(dev))
    c = getattr(nrtdsm, fn)(g, o, d)
    _card_agrees(k, c, 1000)
    assert (k.steps.cpu() == c.steps).float().mean() >= 0.99


def test_shell_on_card_matches_cpu_and_kernel6_equals_plain(dev):
    """intersect_shell on a tilted shell of boxes, card against CPU on
    4,096 rays; and kernel 6 (the per-ray scope) on the chords the card's
    call really sent (t_min 0, t_max a chord's length or -1 on lanes that
    need no query) against walk_skip_plain: t, u, v, tri and hit equal."""
    from gfxexp_torch.techniques import shell

    pos, idx, uvs, nrm = _tilted_plane(4)
    sv = np.array([[0.1, 0.1, 0.1], [0.7, 0.1, 0.1], [0.7, 0.7, 0.1],
                   [0.1, 0.7, 0.9]], np.float32)
    tets = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]], np.int32)
    g = shell.build_shell_geometry(pos, idx, uvs, sv, tets, normals=nrm,
                                   shell_materials=[0, 1, 2, 3])
    assert g.auto_segments > 1
    o, d = _patch_rays(4096, 10)
    batches = []
    real = shell.intersect_closest

    def recorded(bvh, tris, q, sdir, t_min, t_max):
        batches.append((q, sdir, t_max))
        return real(bvh, tris, q, sdir, t_min=t_min, t_max=t_max)

    shell.intersect_closest = recorded
    try:
        gk = g.to(dev)
        k = shell.intersect_shell(gk, o.to(dev), d.to(dev))
    finally:
        shell.intersect_closest = real
    c = shell.intersect_shell(g, o, d)
    _card_agrees(k, c, 200)
    assert len(batches) >= g.auto_segments
    dead = 0
    for q, sdir, t_max in batches:
        kc = walk_skip_cuda(gk.shell_bvh, gk.shell_tris, q, sdir, 0.0, t_max,
                            False)
        pc = walk_skip_plain(gk.shell_bvh, gk.shell_tris, q, sdir, 0.0,
                             t_max, False)
        for f in ("t", "u", "v", "tri", "hit"):
            assert torch.equal(getattr(kc, f), getattr(pc, f)), f
        dead += int((t_max < 0).sum())
    assert dead > 0


@pytest.mark.parametrize("kind", ["segments", "spans"])
def test_curves_on_card_match_cpu(dev, kind):
    from gfxexp_torch.core import curves

    cp = np.array([[0, 0, 0], [1, 1.2, 0.3], [2, -0.8, -0.4], [3, 0.2, 0.5],
                   [4, 1.0, 0.0], [5, -0.3, 0.2]], np.float32)
    rr = np.array([0.22, 0.15, 0.3, 0.18, 0.25, 0.2], np.float32)
    if kind == "segments":
        g = curves.build_curve_segments(cp, rr, curve_type="catmull_rom")
        fn = curves.intersect_curve_segments
    else:
        g = curves.build_curve_spans(cp, rr, curve_type="catmull_rom")
        fn = curves.intersect_curve_spans
    rng = np.random.default_rng(11)
    n = 4096
    o = rng.uniform(-1, 5, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(2, 4, n)
    tgt = cp[rng.integers(1, 5, n)] + rng.normal(0, 0.3, (n, 3))
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))
    _card_agrees(fn(g.to(dev), o.to(dev), d.to(dev)), fn(g, o, d), 500)


def test_nrtdsm_app_on_card_matches_cpu(dev, tmp_path):
    """The nrtdsm app at 32x32, 1 frame, -base-res 4, bilinear and -shell
    (the torus OBJ): the card's image within 5e-3 (mean relative
    difference) of its -device cpu image."""
    from gfxexp_torch import bench
    from gfxexp_torch.apps import nrtdsm as app

    obj = bench.write_mesh_files(str(tmp_path / "meshes"))["obj"]
    for extra in ([], ["-shell", "-shell-obj", obj, "-shell-grid", "2"]):
        argv = ["-width", "32", "-height", "32", "-frames", "1",
                "-base-res", "4", *extra]
        a = app.main([*argv, "-output", str(tmp_path / "card")])
        b = app.main([*argv, "-device", "cpu", "-output",
                      str(tmp_path / "cpu")])
        assert np.isfinite(a).all() and a.mean() > 0
        assert S.image_rel_diff(a, b) < 5e-3


def _diagonal_soup(n_long=300, n_soup=2000, seed=3):
    """Long thin diagonal triangles and a local soup (p0, e1, e2): spatial
    splits duplicate many references."""
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


@pytest.mark.parametrize("fmt", ["widerow", "qrow_chunked", "qrow"])
def test_sbvh_tables_kernels_match_plain(dev, fmt):
    """Kernel 1 over an SBVH wide-row table and kernel 7 over SBVH
    quantized tables (one, and chunked with duplicates in every chunk),
    closest and any hit, dead lanes included: identical to the plain
    walks."""
    soup = _diagonal_soup()
    if fmt == "widerow":
        tb, perm = build_widerow(*soup, spatial_splits=True)
        kernel, plain = walk_cuda, walk_plain
    else:
        tb, perm, _ = build_qrow(*soup, spatial_splits=True,
                                 max_rows=200 if fmt == "qrow_chunked"
                                 else 26000)
        assert (tb.num_chunks >= 3) == (fmt == "qrow_chunked")
        kernel, plain = walk_qrow_cuda, walk_qrow_plain
    assert perm.shape[0] > soup[0].shape[0]
    tb = tb.to(dev)
    o, d = (x.to(dev) for x in _aimed(soup))
    t_max = _dead_every_fifth(o.shape[0], dev)
    for any_hit in (False, True):
        k = kernel(tb, o, d, 1e-4, t_max, any_hit)
        p = plain(tb, o, d, 1e-4, t_max, any_hit)
        torch.cuda.synchronize()
        assert k.hit.any() and not k.hit[t_max < 0].any()
        for f in ("hit", "t", "u", "v", "tri"):
            assert torch.equal(getattr(k, f), getattr(p, f)), f


def test_sharded_render_world_one_matches_render_sample(dev, tmp_path):
    """render_sample_sharded on a one-rank NCCL group (file:// rendezvous)
    equals render_sample bit for bit, in lane order; ray sorting and
    compaction leave the card's image bit-identical too."""
    import torch.distributed as dist

    from gfxexp_torch.parallel import sharding
    from gfxexp_torch.render.camera import lane_from_pixel

    scene, bvh = compile_scene(S.box_scene(TB), traversal="widerow")
    scene, bvh = scene.to(dev), bvh.to(dev)
    cam = make_camera(**S.BOX_CAMERA).to(dev)
    cfg = tpt.PTConfig(max_path_length=4)
    ref = tpt.render_sample(scene, bvh, cam, 64, 64, 3, cfg)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        lanes = sharding.render_sample_sharded(sharding.make_mesh(), scene,
                                               bvh, cam, 64, 64, 3, cfg)
    finally:
        dist.destroy_process_group()
    order = lane_from_pixel(torch.arange(64 * 64, device=dev), 64, 64)
    assert torch.equal(lanes[order], ref)
    for opt in ("sort_secondary_rays", "compact_rays"):
        img = tpt.render_sample(scene, bvh, cam, 64, 64, 3,
                                dataclasses.replace(cfg, **{opt: True}))
        assert torch.equal(img, ref), opt
