"""Tests of the port that need a CUDA device: the hand-written kernels against
their plain PyTorch versions, and a render on the card against the same
render on the CPU. They skip where there is no card. This file imports no
JAX (the card's machine has none); run it there with

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
from gfxexp_torch.accel import (  # noqa: E402
    instanced,
    lanegroup,
    persistent,
    qrow,
    skip_traverse,
    widerow,
)
from gfxexp_torch.accel.instanced import (  # noqa: E402
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
from gfxexp_torch.accel.skiplink import walk_skip_plain  # noqa: E402
from gfxexp_torch.accel.traverse import intersect_any  # noqa: E402
from gfxexp_torch.accel.traverse import intersect_closest  # noqa: E402
from gfxexp_torch.accel.widerow import build_widerow  # noqa: E402
from gfxexp_torch.csrc.build import header_constant  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera  # noqa: E402
from gfxexp_torch.scene import animation  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


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
    persistent.reset_launch_counts()
    intersect_closest(tb, None, o, d)
    intersect_any(tb, None, o, d)
    intersect_any(tb, None, o[:0], d[:0])  # nothing to launch
    assert persistent.launch_counts == {"closest": 1, "any": 1}


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


@pytest.mark.parametrize("route", ["nearest", "sorted"])
def test_instanced_overflow_matches_plain(dev, route):
    """300 open frames stacked along the rays: most rays enter more entry
    boxes than the pick keeps and miss most frames, so its buffer runs dry
    and refills. The nearest-first kernel (and the ray-sorted route's) still
    equals the plain version, closest and any hit."""
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
    instanced.reset_launch_counts()
    intersect_closest(acc, None, o, d)
    intersect_any(acc, None, o, d)
    acc.use_tlas = True
    intersect_closest(acc, None, o, d)
    assert instanced.launch_counts == {
        "closest_nearest": 1, "any_nearest": 1, "closest_build": 0,
        "any_build": 0, "closest_sorted": 1, "any_sorted": 0}


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
    skip_traverse.reset_launch_counts()
    intersect_closest(tb, ts.triangles, o, d)
    intersect_any(tb, ts.triangles, o, d)
    intersect_any_rowcursor(tb, ts.triangles, o, d)
    walk_skip_cuda(tb, ts.triangles, o, d, 1e-4, 1e30, False, "block")
    assert skip_traverse.launch_counts == {
        "closest_thread": 1, "any_thread": 1, "closest_warp": 0,
        "any_warp": 1, "closest_block": 1, "any_block": 0}


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
    for mod in (persistent, qrow, lanegroup):
        mod.reset_launch_counts()
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
    assert persistent.launch_counts == {"closest": 1, "any": 0}
    assert persistent.chunked_launch_counts == {"closest": 1, "any": 2}
    assert qrow.launch_counts == {"closest": 1, "any": 1}
    assert lanegroup.launch_counts == {1: 0, 2: 0, 4: 1}


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
