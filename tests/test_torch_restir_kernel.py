"""ReSTIR DI's resampling kernels (csrc/restir_resample.cu) against their
plain versions on the card: the initial candidate stream
(initial_ris_kernel against initial_ris_presampled) and one spatial pass
(spatial_reuse_kernel against spatial_reuse) on the same inputs, and
restir_di_frame by the kernel route against the plain one. They skip where
there is no card. This file imports no JAX (the card's machine has none);
run it there with

    python -m pytest tests/test_torch_restir_kernel.py --noconftest -q

Kernel and plain version round the same operations alike (--fmad=false,
the target density summed as PyTorch's reduction sums it), so they agree
bit for bit. Each test reports the share of bit-identical pixels of every
reservoir field, holds the pixels that are not bit-identical to 1e-4 of
them, and the pixels off by over 1e-3 (benchmark/reference/compare.py) to
1e-4 of them as well.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
sys.path.insert(0, "benchmark")
import torch_scenes as S  # noqa: E402
from reference import compare  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
from gfxexp_torch.render.camera import make_camera  # noqa: E402
from gfxexp_torch.render.gbuffer import render_gbuffer  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene  # noqa: E402
from gfxexp_torch.techniques import restir_di as R  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402

pytestmark = pytest.mark.cuda

MISMATCH = 1e-4  # the share of pixels the tests allow to differ
W, H = 64, 36
SMALL_POOL = dict(num_light_subsets=16, light_subset_size=256)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _many_lights_with_env(mod):
    """The many-light scene under a constant environment: a pool of
    surface and environment samples."""
    b = S.many_light_scene(mod, 16, occluders=3)
    b.set_environment(np.full((16, 32, 3), 0.5, np.float32))
    return b


# scene: (builder, camera)
_SCENE_DEFS = {
    "lambert": (lambda: S.many_light_scene(TB, 16, occluders=3),
                dict(position=[0.0, 3.0, 4.0], fov_y=np.deg2rad(50),
                     target=[0.0, 0.0, 0.0])),
    "ggx": (lambda: S.glossy_box_scene(TB), dict(S.BOX_CAMERA)),
    "env": (lambda: _many_lights_with_env(TB),
            dict(position=[0.0, 1.5, 4.0], fov_y=np.deg2rad(60),
                 target=[0.0, 0.5, 0.0])),
}
_SCENES = {}


def _scene(which, dev):
    if which not in _SCENES:
        _SCENES[which] = compile_scene(_SCENE_DEFS[which][0](),
                                       traversal="widerow")
    scene, bvh = _SCENES[which]
    return scene.to(dev), bvh.to(dev)


def _camera(which, w, h, dev):
    return make_camera(**dict(_SCENE_DEFS[which][1], aspect=w / h)).to(dev)


def _inputs(which, w, h, frame, dev):
    scene, bvh = _scene(which, dev)
    cam = _camera(which, w, h, dev)
    gb = render_gbuffer(scene, bvh, cam, cam, w, h, frame, True)
    return scene, bvh, cam, gb, R.pixel_ctx(scene, gb, cam)


def _fields(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


def _check(what, k, p):
    """Every field finite, the share of bit-identical pixels of each
    reported, the pixels that differ anywhere within MISMATCH of all, and
    the pixels off by over 1e-3 too."""
    kf, pf = _fields(k), _fields(p)
    n = kf["sum_w"].shape[0]
    same_all = torch.ones(n, dtype=torch.bool, device=kf["sum_w"].device)
    shares = {}
    for name, kx in kf.items():
        px = pf[name]
        if kx.dtype.is_floating_point:
            assert bool(torch.isfinite(kx).all()), (what, name)
        eq = kx == px
        if eq.dim() > 1:
            eq = eq.all(-1)
        same_all &= eq
        shares[name] = float(eq.double().mean())
    print(f"{what}: bit-identical pixels " + ", ".join(
        f"{k} {v:.6f}" for k, v in shares.items()))
    assert compare.share(~same_all) <= MISMATCH, (what, shares)
    as_f = {k: v.float() for k, v in kf.items()}
    ref = {k: v.float() for k, v in pf.items()}
    assert compare.share(compare.fields_mismatch(as_f, ref)) <= MISMATCH
    return shares


# (scene, ReSTIRConfig fields, frame): each value of every option at least
# once
INITIAL_CASES = [
    ("lambert", {}, 0),
    ("ggx", {}, 0),
    ("lambert", {"reuse_visibility": False}, 7),
    ("ggx", {"reuse_visibility": False, "log2_num_candidates": 5}, 7),
    ("lambert", {"log2_num_candidates": 0}, 0),
    ("ggx", {"log2_num_candidates": 0, "reuse_visibility": False}, 7),
    ("lambert", {"log2_num_candidates": 5}, 7),
    ("env", {}, 0),
    ("env", {"reuse_visibility": False}, 7),
    ("lambert", SMALL_POOL, 7),
]
INITIAL_IDS = [f"{s}-{'-'.join(f'{k}={v}' for k, v in c.items()) or 'default'}"
               f"-frame{f}" for s, c, f in INITIAL_CASES]


@pytest.mark.parametrize("which,opts,frame", INITIAL_CASES, ids=INITIAL_IDS)
def test_initial_kernel_matches_plain(dev, which, opts, frame):
    """The initial stream at 64x36 by the kernel (then the any-hit walk of
    its shadow rays) and by initial_ris_presampled, from the same pool."""
    scene, bvh, _, gb, ctx = _inputs(which, W, H, frame, dev)
    cfg = R.ReSTIRConfig(use_rearchitected_pipeline=True, **opts)
    pool = R.presample_lights(scene, frame, cfg)
    if which == "env":
        assert bool(pool["at_inf"].any()) and not bool(pool["at_inf"].all())
    trace.reset_counters("restir.")
    k = R.initial_ris_kernel(scene, bvh, ctx, pool, gb, frame, cfg)
    assert trace.counters("restir.") == {"restir.kernel.initial": 1}
    p = R.initial_ris_presampled(scene, bvh, ctx, pool, gb,
                                 torch.arange(W * H, device=dev), frame, cfg)
    torch.cuda.synchronize()
    assert float(p.rec_pdf.sum()) > 0
    _check(f"initial {which} {opts} frame {frame}", k, p)


# (scene, ReSTIRConfig fields, frame, pass)
SPATIAL_CASES = [
    ("lambert", {}, 0, 0),
    ("ggx", {}, 7, 1),
    ("lambert", {"num_spatial_neighbors": 1}, 7, 0),
    ("ggx", {"num_spatial_neighbors": 1}, 0, 1),
    ("lambert", {"num_spatial_neighbors": 5}, 0, 1),
    ("ggx", {"num_spatial_neighbors": 5, "spatial_radius": 1.0}, 7, 0),
    ("lambert", {"spatial_radius": 1.0}, 7, 1),
    ("env", {}, 0, 0),
    ("env", {"num_spatial_neighbors": 5}, 7, 1),
    ("lambert", {"use_rearchitected_pipeline": False}, 7, 0),
]
SPATIAL_IDS = [f"{s}-{'-'.join(f'{k}={v}' for k, v in c.items()) or 'default'}"
               f"-frame{f}-pass{p}" for s, c, f, p in SPATIAL_CASES]


@pytest.mark.parametrize("which,opts,frame,pass_idx", SPATIAL_CASES,
                         ids=SPATIAL_IDS)
def test_spatial_kernel_matches_plain(dev, which, opts, frame, pass_idx):
    """One spatial pass at 64x36 by the kernel and by spatial_reuse on the
    same reservoirs (the initial stream's), which neither changes."""
    scene, bvh, cam, gb, ctx = _inputs(which, W, H, frame, dev)
    cfg = R.ReSTIRConfig(**{"use_rearchitected_pipeline": True, **opts})
    assert R.restir_kernel_admits(cfg, gb.depth)[1]
    pool = R.presample_lights(scene, frame, cfg)
    pixel = torch.arange(W * H, device=dev)
    res = R.initial_ris_presampled(scene, bvh, ctx, pool, gb, pixel, frame,
                                   cfg)
    before = {k: v.clone() for k, v in _fields(res).items()}
    trace.reset_counters("restir.")
    k = R.spatial_reuse_kernel(res, ctx, gb, cam, frame, pass_idx, cfg)
    assert trace.counters("restir.") == {"restir.kernel.spatial": 1}
    p = R.spatial_reuse(scene, bvh, res, ctx, gb, cam, pixel, frame,
                        pass_idx, cfg)
    torch.cuda.synchronize()
    assert all(torch.equal(v, before[n]) for n, v in _fields(res).items())
    assert float(p.rec_pdf.sum()) > 0
    _check(f"spatial {which} {opts} frame {frame} pass {pass_idx}", k, p)


def _frames(monkeypatch, which, w, h, cfg, frames, route):
    """restir_di_frame's frames 0 .. frames - 1 from empty state by the
    kernel route ("kernel") or the plain versions everywhere ("plain"):
    each frame's (colour, reservoir) and the counters."""
    scene, bvh = _scene(which, dev=torch.device("cuda"))
    cam = _camera(which, w, h, scene.device)
    n = w * h
    res = R.empty_reservoir(n, scene.device)
    vis = R.empty_sample_visibility(n, scene.device)
    gb = render_gbuffer(scene, bvh, cam, cam, w, h, 0, True)
    ctx = R.pixel_ctx(scene, gb, cam)
    out = []
    trace.reset_counters("restir.")
    with monkeypatch.context() as m:
        if route == "plain":
            m.setattr(R, "restir_kernel_admits", lambda *a: (False, False))
        for f in range(frames):
            prev = (gb.hit.reshape(n), gb.position.reshape(n, 3),
                    gb.normal.reshape(n, 3))
            gb = render_gbuffer(scene, bvh, cam, cam, w, h, f, True)
            color, res, ctx, vis = R.restir_di_frame(
                scene, bvh, gb, cam, res, ctx, *prev, f, cfg, vis)
            out.append((color.reshape(n, 3), res))
    torch.cuda.synchronize()
    return out, trace.counters("restir.")


@pytest.mark.parametrize("which", ["lambert", "ggx"])
def test_frames_match_plain(dev, monkeypatch, which):
    """Eight rearchitected frames at 64x36, each route carrying its own
    state: images and reservoirs alike frame by frame."""
    cfg = R.ReSTIRConfig(use_rearchitected_pipeline=True)
    k, kc = _frames(monkeypatch, which, W, H, cfg, 8, "kernel")
    p, pc = _frames(monkeypatch, which, W, H, cfg, 8, "plain")
    assert kc == {"restir.kernel.initial": 8, "restir.kernel.spatial": 16}
    assert pc == {"restir.eager.initial": 8, "restir.eager.spatial": 16}
    for f, ((kcol, kres), (pcol, pres)) in enumerate(zip(k, p)):
        _check(f"{which} frame {f} reservoir", kres, pres)
        assert bool(torch.isfinite(kcol).all())
        assert compare.mismatch_share(kcol, pcol) <= MISMATCH
        assert compare.share(~(kcol == pcol).all(-1)) <= MISMATCH


def test_frame_1080p_matches_plain(dev, monkeypatch):
    """restir_di_frame at 1920x1080 with the benchmark's configuration,
    frames 0 and 1, by both routes."""
    cfg = R.ReSTIRConfig(use_rearchitected_pipeline=True)
    k, kc = _frames(monkeypatch, "lambert", 1920, 1080, cfg, 2, "kernel")
    p, _ = _frames(monkeypatch, "lambert", 1920, 1080, cfg, 2, "plain")
    assert kc == {"restir.kernel.initial": 2, "restir.kernel.spatial": 4}
    for f, ((kcol, kres), (pcol, pres)) in enumerate(zip(k, p)):
        _check(f"1080p frame {f} reservoir", kres, pres)
        same = float((kcol == pcol).all(-1).double().mean())
        print(f"1080p frame {f} image: {same:.6f} of pixels bit-identical, "
              f"largest difference {float((kcol - pcol).abs().max()):.3g}")
        assert same >= 1.0 - MISMATCH
        assert compare.mismatch_share(kcol, pcol) <= MISMATCH


@pytest.mark.parametrize("opts,expected", [
    ({"use_rearchitected_pipeline": True},
     {"restir.kernel.initial": 2, "restir.kernel.spatial": 4}),
    ({}, {"restir.eager.initial": 2, "restir.kernel.spatial": 4}),
    ({"use_rearchitected_pipeline": True, "use_unbiased_estimator": True},
     {"restir.kernel.initial": 2, "restir.eager.spatial": 4}),
    ({"use_rearchitected_pipeline": True,
      "use_low_discrepancy_neighbors": False},
     {"restir.kernel.initial": 2, "restir.eager.spatial": 4}),
    ({"use_rearchitected_pipeline": True, "enable_spatial_reuse": False},
     {"restir.kernel.initial": 2}),
])
def test_counters(dev, monkeypatch, opts, expected):
    """Two frames: one kernel count a launch, one eager count a plain pass
    on the card, by route."""
    _, counted = _frames(monkeypatch, "lambert", 32, 18,
                         R.ReSTIRConfig(**opts), 2, "kernel")
    assert counted == expected


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """A dtype, a shape, a non-contiguous tensor, a CPU tensor or a
    configuration the kernels do not take raise; nothing falls back."""
    scene, bvh, cam, gb, ctx = _inputs("lambert", 16, 16, 0, dev)
    cfg = R.ReSTIRConfig(use_rearchitected_pipeline=True)
    pool = R.presample_lights(scene, 0, cfg)
    n = 16 * 16
    bad = dataclasses.replace(ctx, pos=ctx.pos.double())
    with pytest.raises(ValueError, match="pos must be a contiguous"):
        R.initial_ris_kernel(scene, bvh, bad, pool, gb, 0, cfg)
    short = dict(pool, pos=pool["pos"][:-1])
    with pytest.raises(ValueError, match="pool_pos must be"):
        R.initial_ris_kernel(scene, bvh, ctx, short, gb, 0, cfg)
    strided = torch.empty((3, n), device=dev).t()
    strided.copy_(ctx.t)
    with pytest.raises(ValueError, match="contiguous: False"):
        R.initial_ris_kernel(scene, bvh, dataclasses.replace(ctx, t=strided),
                             pool, gb, 0, cfg)
    res = R.initial_ris_kernel(scene, bvh, ctx, pool, gb, 0, cfg)
    with pytest.raises(ValueError, match="in_sum_w must be"):
        R.spatial_reuse_kernel(dataclasses.replace(res, sum_w=res.sum_w[:-1]),
                               ctx, gb, cam, 0, 0, cfg)
    with pytest.raises(ValueError, match="biased pass"):
        R.spatial_reuse_kernel(res, ctx, gb, cam, 0, 0, dataclasses.replace(
            cfg, use_unbiased_estimator=True))
    cpu = ctx.to("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        R.initial_ris_kernel(scene, bvh, cpu, pool, gb, 0, cfg)
