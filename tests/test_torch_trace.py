"""The port's tracing (gfxexp_torch/utils/trace.py): the span tree of one
frame of the restir_di (rearchitected pipeline), svgf and path_tracing
apps under the CPU profiler, spans that do nothing outside a profiler,
frames equal bit for bit with the profiler on and off, and the counter
registry. The box and lamp at 24x16."""

import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gfxexp_torch.apps import common
from gfxexp_torch.apps import path_tracing as pt_app
from gfxexp_torch.apps import restir_di as restir_app
from gfxexp_torch.apps import svgf as svgf_app
from gfxexp_torch.render.camera import make_camera
from gfxexp_torch.render.gbuffer import render_gbuffer
from gfxexp_torch.render.pathtrace import PTConfig
from gfxexp_torch.scene.compile import compile_scene
from gfxexp_torch.techniques import restir_di
from gfxexp_torch.techniques.svgf import SVGFConfig
from gfxexp_torch.utils import trace

W, H = 24, 16
BOUNCES = 3  # the path tracer's max_path_length here
STAGES = 5  # SVGF's a-trous stages
PASSES = ("update", "gbuffer", "restir", "pathTrace", "svgf")
WALK_KERNEL = re.compile(r"\w*_walk\w*")  # how a device trace names walks
LAYERS = ("gfx.gbuffer", "gfx.pathtrace", "gfx.restir", "gfx.svgf")


@pytest.fixture(scope="module")
def box():
    scene, bvh = compile_scene(common.default_demo_builder(),
                               traversal="widerow")
    cam = make_camera([0.0, 0.0, 1.9], fov_y=1.2, aspect=W / H,
                      target=[0.0, 0.0, -1.0])
    return scene, bvh, cam


def _frame(app, box):
    """One frame of the app's frame loop; the outputs it returns."""
    scene, bvh, cam = box
    timer = common.PassTimer()
    pt_cfg = PTConfig(max_path_length=BOUNCES)
    if app == "restir_di":
        cfg = restir_di.ReSTIRConfig(use_rearchitected_pipeline=True,
                                     num_light_subsets=4,
                                     light_subset_size=16)
        return restir_app.frame_loop(scene, bvh, cam, [], "widerow", W, H,
                                     1, cfg, True, timer)[0]
    if app == "svgf":
        return svgf_app.frame_loop(scene, bvh, cam, [], "widerow", W, H, 1,
                                   pt_cfg, SVGFConfig(), timer)[:2]
    return pt_app.frame_loop(scene, bvh, cam, [], "widerow", W, H, 1,
                             pt_cfg, timer)[0]


class Span:
    """A span as the profiler recorded it, with its nearest enclosing
    span."""

    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end
        self.parent = None


def _profiled(fn):
    """fn's result and its spans, from the profiler's raw events (the
    spans nest by their intervals: the port traces on one thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("gfx.")]
    for e in spans:
        around = [p for p in spans if p is not e
                  and p.start <= e.start and e.end <= p.end]
        if around:
            e.parent = max(around, key=lambda p: (p.start, -p.end))
    return out, spans


@pytest.fixture(scope="module")
def frames(box):
    """Per app: one frame unprofiled, one frame profiled and its spans."""
    out = {}
    for app in ("restir_di", "svgf", "path_tracing"):
        off = _frame(app, box)
        on, spans = _profiled(lambda: _frame(app, box))
        out[app] = off, on, spans
    return out


def _bounce_stages(b):
    stages = ["trace", "surface"]
    if b < BOUNCES:
        stages += ["bsdf", "nee", "bsdf"]
    return [f"gfx.pathtrace.bounce{b}.{s}" for s in stages]


_PATHTRACE = (["gfx.pathtrace", "gfx.pathtrace.resolve"]
              + [f"gfx.pathtrace.bounce{b}" for b in range(1, BOUNCES + 1)]
              + [s for b in range(1, BOUNCES + 1) for s in _bounce_stages(b)])
EXPECTED = {
    "path_tracing": _PATHTRACE,
    "svgf": (["gfx.gbuffer"] + _PATHTRACE
             + ["gfx.svgf", "gfx.svgf.temporal", "gfx.svgf.variance",
                "gfx.svgf.taa"]
             + [f"gfx.svgf.atrous{i}" for i in range(STAGES)]),
    "restir_di": (["gfx.gbuffer", "gfx.gbuffer", "gfx.restir"]
                  + [f"gfx.restir.{s}" for s in (
                      "presample", "initial", "shadow", "resample",
                      "spatial0", "spatial1", "shade")]),
}


@pytest.mark.parametrize("app", ["restir_di", "svgf", "path_tracing"])
def test_one_frame_gives_the_span_tree(frames, app):
    spans = frames[app][2]
    walks = [e for e in spans if e.name.startswith("gfx.walk.")]
    assert sorted(e.name for e in spans if e not in walks) == sorted(
        EXPECTED[app])
    assert walks and {e.name for e in walks} <= {"gfx.walk.closest",
                                                 "gfx.walk.any"}
    for e in spans:
        assert "." in e.name and e.name not in PASSES
        assert not WALK_KERNEL.fullmatch(e.name)
        parent = e.parent
        if e in walks:
            # a walk nests inside the layer that asked for it
            layer = parent
            while layer is not None and layer.name not in LAYERS:
                layer = layer.parent
            assert layer is not None, e.name
        elif e.name in LAYERS:
            assert parent is None, (e.name, parent.name)
        else:
            # a stage's parent is the span its name extends
            assert parent is not None, e.name
            assert parent.name == e.name.rsplit(".", 1)[0], (e.name,
                                                            parent.name)
    bounces = [e for e in spans
               if re.fullmatch(r"gfx\.pathtrace\.bounce\d+", e.name)]
    if app != "restir_di":
        assert [e.name for e in sorted(bounces, key=lambda e: e.start)] == [
            f"gfx.pathtrace.bounce{b}" for b in range(1, BOUNCES + 1)]


def test_spans_outside_a_profiler_open_no_range(box, monkeypatch):
    """Outside a profiler a span never opens a range; under one, each span
    opens one (the stand-in counts both)."""
    opened = []

    class StandIn:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "_RecordFunctionFast", StandIn)
    _frame("restir_di", box)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        _frame("restir_di", box)
    assert "gfx.restir" in opened and "gfx.walk.any" in opened
    assert trace.span("gfx.x") is trace.span("gfx.y")  # the shared no-op


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        for k in a.__dataclass_fields__:
            _equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("app", ["restir_di", "svgf", "path_tracing"])
def test_profiled_frames_equal_unprofiled(frames, app):
    off, on, _ = frames[app]
    _equal(off, on)


def test_profiled_reservoirs_equal_unprofiled(box):
    scene, bvh, cam = box
    cfg = restir_di.ReSTIRConfig(use_rearchitected_pipeline=True,
                                 num_light_subsets=4, light_subset_size=16)
    n = W * H
    gb = render_gbuffer(scene, bvh, cam, cam, W, H, 1)
    prev = render_gbuffer(scene, bvh, cam, cam, W, H, 0)
    ctx = restir_di.pixel_ctx(scene, prev, cam)

    def frame():
        return restir_di.restir_di_frame(
            scene, bvh, gb, cam, restir_di.empty_reservoir(n, "cpu"), ctx,
            prev.hit.reshape(n), prev.position.reshape(n, 3),
            prev.normal.reshape(n, 3), 1, cfg)

    off = frame()
    on, _ = _profiled(frame)
    _equal(off[:2], on[:2])  # the image and the reservoirs


def test_counters():
    trace.reset_counters("test.")
    trace.count("test.a")
    trace.count("test.a", 2)
    trace.count("test.b.x", 5)
    trace.count("other.a")
    assert trace.counters("test.") == {"test.a": 3, "test.b.x": 5}
    assert trace.counters()["other.a"] >= 1
    snapshot = trace.counters("test.")
    trace.count("test.a")
    assert snapshot["test.a"] == 3  # a copy
    trace.reset_counters("test.b")
    assert trace.counters("test.") == {"test.a": 4}
    trace.reset_counters()
    assert trace.counters() == {}
