"""The NRC app's spans and counters (utils/trace.py): one frame of the
neural_radiance_caching app's frame loop with the hash grid under the CPU
profiler opens `gfx.nrc` with its stages and `gfx.nrc.train` with each
step's stages, every stage nested in the span its name extends; the
counters move by the counts the tensors' shapes give; the frame equals an
unprofiled one bit for bit. The box and lamp at 24x16."""

import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gfxexp_torch.apps import common
from gfxexp_torch.apps import neural_radiance_caching as nrc_app
from gfxexp_torch.render.camera import make_camera
from gfxexp_torch.scene.compile import compile_scene
from gfxexp_torch.techniques.nrc import NRCConfig, init_nrc
from gfxexp_torch.techniques.nrc.cache import NRCIntegratorConfig, scene_aabb
from gfxexp_torch.utils import trace

W, H = 24, 16
BOUNCES = 3
STEPS = 4
STRIDE = 4
PASSES = ("update", "pathTrace+infer", "train")
WALK_KERNEL = re.compile(r"\w*_walk\w*")
LAYERS = ("gfx.nrc", "gfx.nrc.train")
EXPECTED = (
    ["gfx.nrc", "gfx.nrc.setup", "gfx.nrc.query", "gfx.nrc.infer",
     "gfx.nrc.propagate", "gfx.nrc.train"]
    + [f"gfx.nrc.bounce{b}" for b in range(1, BOUNCES + 1)]
    + [f"gfx.nrc.train.step{k}{s}" for k in range(STEPS)
       for s in ("", ".encode", ".mlp", ".backward", ".adam")])


def _frame():
    """One frame of the app's frame loop: (radiance of the film, the
    state after it)."""
    scene, bvh = compile_scene(common.default_demo_builder(),
                               traversal="widerow")
    cam = make_camera([0.0, 0.0, 1.9], fov_y=1.2, aspect=W / H,
                      target=[0.0, 0.0, -1.0])
    cfg = NRCConfig(position_encoding="hash_grid")
    icfg = NRCIntegratorConfig(max_path_length=BOUNCES, train_stride=STRIDE)
    state = init_nrc(torch.Generator().manual_seed(0), cfg, "cpu")
    film, state, _, _, _ = nrc_app.frame_loop(
        scene, bvh, cam, [], "widerow", W, H, 1, icfg, cfg, state,
        scene_aabb(scene), common.PassTimer(), train_steps=STEPS)
    return film.beauty, state


class Span:
    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end
        self.parent = None


@pytest.fixture(scope="module")
def frames():
    """An unprofiled frame, a profiled one with its spans, and the
    counters the profiled one moved."""
    off = _frame()
    trace.reset_counters("nrc.")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _frame()
    counts = trace.counters("nrc.")
    spans = [Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("gfx.")]
    for e in spans:
        around = [p for p in spans if p is not e
                  and p.start <= e.start and e.end <= p.end]
        if around:
            e.parent = max(around, key=lambda p: (p.start, -p.end))
    return off, on, spans, counts


def test_one_frame_gives_the_span_tree(frames):
    spans = frames[2]
    walks = [e for e in spans if e.name.startswith("gfx.walk.")]
    assert sorted(e.name for e in spans if e not in walks) == sorted(
        EXPECTED)
    assert walks
    for e in spans:
        assert "." in e.name and e.name not in PASSES
        assert not WALK_KERNEL.fullmatch(e.name)
        if e in walks:
            assert e.parent is not None and e.parent.name.startswith(
                "gfx.nrc.bounce"), e.name
        elif e.name in LAYERS:
            assert e.parent is None, (e.name, e.parent.name)
        else:
            assert e.parent is not None, e.name
            assert e.parent.name == e.name.rsplit(".", 1)[0], (
                e.name, e.parent.name)


def test_counters_move_by_the_shapes(frames):
    n_train = W * H // STRIDE
    rows = (n_train * BOUNCES // STEPS) * STEPS
    # the MLP 58-64-64-64-3 (16 x 2 hash features, 5 x 4 OneBlob bins, 6
    # reflectances in), the table 16 levels x 2^15 entries x 2 features
    macs = 58 * 64 + 2 * 64 * 64 + 64 * 3
    assert frames[3] == {
        "nrc.frames": 1, "nrc.train_steps": STEPS, "nrc.train_rows": rows,
        "nrc.train_params": STEPS * (16 * 2 ** 15 * 2 + macs),
        "nrc.train_macs": rows * macs,
        "nrc.queries": W * H + n_train}


def test_profiled_frame_equals_unprofiled(frames):
    off, on = frames[0], frames[1]
    assert torch.equal(off[0], on[0])
    for a, b in zip(off[1]["params"]["weights"] + [
            off[1]["params"]["hash_table"]],
            on[1]["params"]["weights"] + [on[1]["params"]["hash_table"]]):
        assert torch.equal(a, b)
