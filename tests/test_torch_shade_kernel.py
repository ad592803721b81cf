"""The path tracer's shading kernel (csrc/shade_bounce.cu) against its plain
version on the card: bounce by bounce on the same inputs, and through
render_sample against the eager stages. They skip where there is no card.
This file imports no JAX (the card's machine has none); run it there with

    python -m pytest tests/test_torch_shade_kernel.py --noconftest -q

Kernel and plain version round the same operations alike (--fmad=false),
so the lanes agree bit for bit but where cosf / sinf of the CUDA library
differ from PyTorch's or a lane's roulette draw sits on its threshold; a
lane that leaves another way may end elsewhere. Each test reports the share
of bit-identical lanes and holds the pixels off by over 1e-3
(benchmark/reference/compare.py) to 1e-4 of them.
"""

import dataclasses
import sys

import pytest
import torch

sys.path.insert(0, "tests")
sys.path.insert(0, "benchmark")
import torch_scenes as S  # noqa: E402
from reference import compare  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402

pytestmark = pytest.mark.cuda

MISMATCH = 1e-4  # the share of pixels off by over 1e-3 the tests allow


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


_SCENES = {}


def _scene(which, lights, dev):
    """The box (Lambert) or the glossy box (diffuse + GGX), with its lights
    picked by alias tables or by CDF search, on the card."""
    key = (which, lights)
    if key not in _SCENES:
        make = S.box_scene if which == "lambert" else S.glossy_box_scene
        scene, bvh = compile_scene(make(TB), traversal="widerow")
        if lights == "cdf":
            scene = dataclasses.replace(
                scene, light_unit_alias_prob=None, light_unit_alias_idx=None,
                units=dataclasses.replace(scene.units,
                                          light_tri_alias_prob=None,
                                          light_tri_alias_local=None))
        _SCENES[key] = scene, bvh
    scene, bvh = _SCENES[key]
    return scene.to(dev), bvh.to(dev)


def _camera(w, h, dev):
    cam = dict(S.BOX_CAMERA, aspect=w / h)
    return make_camera(**cam).to(dev)


def _report(what, k, p):
    """The share of lanes whose values are bit-identical, printed."""
    same = (k == p)
    if same.dim() > 1:
        same = same.all(-1)
    share = float(same.to(torch.float64).mean())
    print(f"{what}: {share:.6f} of lanes bit-identical")
    return share


def _pixels_off(k, p):
    return compare.mismatch_share(k.reshape(k.shape[0], -1),
                                  p.reshape(p.shape[0], -1))


# (material, lights, PTConfig fields, debug switches): each value of every
# option at least once
CASES = [
    ("lambert", "alias", {}, 0),
    ("ggx", "alias", {}, 0),
    ("lambert", "cdf", {}, 0),
    ("ggx", "cdf", {"count_rays": True}, 0),
    ("ggx", "alias", {"use_implicit_light_sampling": False}, 0),
    ("ggx", "alias", {"use_explicit_light_sampling": False}, 0),
    ("lambert", "alias", {"russian_roulette": False}, 0),
    ("ggx", "alias", {"mollify_specular": True}, 0),
    ("lambert", "alias", {"max_path_length": 1, "count_rays": True}, 0),
    ("ggx", "alias", {"max_path_length": 2}, 0),
    ("lambert", "alias", {"enable_jitter": False}, 0),
    *[("ggx", "alias", {}, 1 << bit) for bit in range(8)],
    ("ggx", "cdf", {"count_rays": True}, 0b11000101),
]
IDS = [f"{m}-{l}-{'-'.join(f'{k}={v}' for k, v in c.items()) or 'default'}"
       f"-dbg{d}" for m, l, c, d in CASES]


def _copy(st):
    """The lanes' state with every tensor copied, the pending term and the
    kernel's buffers too."""
    pending = buffers = None
    if st.pending is not None:
        pending = tuple(x.clone() for x in st.pending)
    if st.buffers is not None:
        buffers = {k: None if x is None else x.clone()
                   for k, x in st.buffers.items()}
    return dataclasses.replace(
        st, ray_o=st.ray_o.clone(), ray_d=st.ray_d.clone(),
        throughput=st.throughput.clone(), alive=st.alive.clone(),
        prev_pdf=st.prev_pdf.clone(), contribution=st.contribution.clone(),
        rays_traced=st.rays_traced.clone(), pending=pending, buffers=buffers)


@pytest.mark.parametrize("mat,lights,opts,dbg", CASES, ids=IDS)
def test_kernel_matches_plain_bounce_by_bounce(dev, mat, lights, opts, dbg):
    """The kernel shades every bounce from bounce 1; the plain version
    shades a copy of the same state after the same walks: every output
    finite, alike bit for bit on nearly every lane."""
    w, h = 64, 36
    scene, bvh = _scene(mat, lights, dev)
    cfg = tpt.PTConfig(**opts)
    s, st = tpt._start(scene, bvh, _camera(w, h, dev), w, h, 0, w * h, 7,
                       cfg, debug_switches=dbg)
    last = cfg.max_path_length
    for bounce in range(1, last + 1):
        first, collect = bounce == 1, bounce == last
        hit, occluded, _ = tpt._trace(s, st, first)
        pst = _copy(st)
        tpt.shade_bounce(s, st, hit, bounce, first, collect, occluded)
        tpt._shade_bounce_plain(s, pst, hit, bounce, first, collect,
                                occluded)
        torch.cuda.synchronize()
        pairs = {"contribution": (st.contribution, pst.contribution),
                 "throughput": (st.throughput, pst.throughput),
                 "alive": (st.alive, pst.alive),
                 "prev_pdf": (st.prev_pdf, pst.prev_pdf),
                 "rays_traced": (st.rays_traced, pst.rays_traced)}
        if not collect:
            pairs.update({"ray_o": (st.ray_o, pst.ray_o),
                          "ray_d": (st.ray_d, pst.ray_d)})
        if pst.pending is not None:
            assert st.pending is not None
            for name, kx, px in zip(("pending", "shadow_o", "shadow_d",
                                     "shadow_tmax"), st.pending, pst.pending):
                pairs[name] = (kx, px)
        else:
            assert st.pending is None
        for name, (kx, px) in pairs.items():
            if kx.dtype.is_floating_point:
                assert torch.isfinite(kx).all(), (bounce, name)
            same = _report(f"bounce {bounce} {name}", kx, px)
            assert same >= 1.0 - 1e-3, (bounce, name, same)
        assert _pixels_off(st.contribution, pst.contribution) <= MISMATCH


def _both_routes(monkeypatch, scene, bvh, cam, w, h, sample, cfg, dbg):
    """render_sample by the kernel route and by the eager stages."""
    trace.reset_counters("pathtrace.shade")
    k = tpt.render_sample(scene, bvh, cam, w, h, sample, cfg,
                          debug_switches=dbg)
    torch.cuda.synchronize()
    counted = trace.counters("pathtrace.shade")
    with monkeypatch.context() as m:
        m.setattr(tpt, "shade_kernel_admits", lambda *a: False)
        p = tpt.render_sample(scene, bvh, cam, w, h, sample, cfg,
                              debug_switches=dbg)
    return k, p, counted


@pytest.mark.parametrize("mat,lights,opts,dbg", CASES, ids=IDS)
def test_render_sample_matches_eager(dev, monkeypatch, mat, lights, opts,
                                     dbg):
    """render_sample at 64x36 through the kernel against the eager stages
    on the card: the image (and the ray count) alike but for 1e-4 of the
    pixels; one kernel launch a bounce and no eager bounce."""
    w, h = 64, 36
    scene, bvh = _scene(mat, lights, dev)
    cfg = tpt.PTConfig(**opts)
    assert tpt.shade_kernel_admits(scene, cfg)
    k, p, counted = _both_routes(monkeypatch, scene, bvh, _camera(w, h, dev),
                                 w, h, 11, cfg, dbg)
    if cfg.count_rays:
        (k, kn), (p, pn) = k, p
        assert float(kn) == float(pn)
    assert counted == {"pathtrace.shade.kernel": cfg.max_path_length}
    assert torch.isfinite(k).all()
    _report(f"{w}x{h} radiance", k, p)
    assert _pixels_off(k, p) <= MISMATCH


@pytest.mark.parametrize("mat", ["lambert", "ggx"])
def test_render_sample_matches_eager_1080p(dev, monkeypatch, mat):
    """The same at 1920x1080 with the benchmark's options (NEE + MIS,
    roulette, path length 5), two samples."""
    w, h = 1920, 1080
    scene, bvh = _scene(mat, "alias", dev)
    cfg = tpt.PTConfig(max_path_length=5, count_rays=True)
    cam = _camera(w, h, dev)
    for sample in (0, 1):
        (k, kn), (p, pn), counted = _both_routes(monkeypatch, scene, bvh,
                                                 cam, w, h, sample, cfg, 0)
        assert float(kn) == float(pn)
        assert counted == {"pathtrace.shade.kernel": 5}
        assert torch.isfinite(k).all()
        _report(f"1080p sample {sample} radiance", k, p)
        assert _pixels_off(k, p) <= MISMATCH


def test_counters_on_the_box(dev):
    """One `pathtrace.shade.kernel` a bounce on the box and no
    `pathtrace.shade.eager`; the eager count where the route is refused
    (a custom NEE)."""
    scene, bvh = _scene("lambert", "alias", dev)
    cam = _camera(32, 18, dev)
    cfg = tpt.PTConfig(max_path_length=4)
    trace.reset_counters("pathtrace.shade")
    for sample in range(3):
        tpt.render_sample(scene, bvh, cam, 32, 18, sample, cfg)
    assert trace.counters("pathtrace.shade") == {
        "pathtrace.shade.kernel": 12}

    def nee(scene, bvh, sp, v_out_local, frame, params, rs, cfg, alive,
            aux):
        rs.skip(3)
        return torch.zeros_like(sp.position), aux

    trace.reset_counters("pathtrace.shade")
    tpt.render_lanes(scene, bvh, cam, 32, 18, 0, 32 * 18, 0, cfg,
                     nee_fn=nee)
    assert trace.counters("pathtrace.shade") == {"pathtrace.shade.eager": 4}


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """A later bounce without the kernel's lanes and a hit of the wrong
    type raise; nothing falls back."""
    w, h = 16, 16
    scene, bvh = _scene("lambert", "alias", dev)
    cfg = tpt.PTConfig()
    s, st = tpt._start(scene, bvh, _camera(w, h, dev), w, h, 0, w * h, 0,
                       cfg)
    hit, _, _ = tpt._trace(s, st, True)
    with pytest.raises(ValueError, match="start at bounce 1"):
        tpt.shade_bounce(s, st, hit, 2, False, False)
    bad = dataclasses.replace(hit, tri=hit.tri.to(torch.int64))
    with pytest.raises(ValueError, match="hit_tri"):
        tpt.shade_bounce(s, st, bad, 1, True, False)
