"""The port's runtime utilities against gfxexp_tpu's: the live viewer
(gfxexp_torch/utils/viewer.py LiveViewer, its /control, /pick and
/frame.png over localhost), CameraRig, the apps' -live (path_tracing: an
orbit and a shift-click pick; tfdm: an orbit), DebugDraw and
enable_compile_cache.

Bars: CameraRig's position, target, switches and brightness after the same
events equal JAX's within 1e-12 (both in float64 numpy), its cameras'
fields within 1e-6; DebugDraw's PLY bytes equal JAX's; the apps' images
are finite and the pick names what the G-buffer holds.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from gfxexp_torch.apps import path_tracing as tpt_app
from gfxexp_torch.apps import tfdm as ttfdm_app
from gfxexp_torch.utils import viewer as tviewer
from gfxexp_torch.utils.debug_draw import DebugDraw as TDraw
from gfxexp_tpu.utils import viewer as jviewer
from gfxexp_tpu.utils.debug_draw import DebugDraw as JDraw

torch.set_num_threads(2)

EVENTS = [{"action": "orbit", "dx": 40, "dy": -15},
          {"action": "dolly", "amount": 1},
          {"action": "pan", "v": [1, 0.5, 0]},
          {"action": "toggle", "bit": 2},
          {"action": "brightness", "log2": 1.0},
          {"action": "pick", "u": 0.25, "v": 0.75},
          {"action": "orbit", "dx": -10, "dy": 200},
          {"action": "reset"}]


def _post(port, ev, path="/control"):
    req = urllib.request.Request(f"http://localhost:{port}{path}",
                                 data=json.dumps(ev).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=5).status


def _get(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=5) as r:
        return r.read()


def test_viewer_control_roundtrip():
    """POST /control queues events that drain_events() returns once;
    malformed events get 400; /frame.png serves the pushed image. The
    server listens on the loopback interface only."""
    viewer = tviewer.LiveViewer(port=0)
    try:
        assert viewer._server.server_address[0] == "127.0.0.1"
        for ev in EVENTS:
            assert _post(viewer.port, ev) == 204
        with pytest.raises(urllib.error.HTTPError):
            _post(viewer.port, [1, 2])
        events = viewer.drain_events()
        assert events == EVENTS and viewer.drain_events() == []
        viewer.update(np.full((8, 12, 3), 0.5, np.float32), frame=3)
        png = _get(viewer.port, "/frame.png")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert _get(viewer.port, "/meta") == b"3"
        viewer.set_pick({"hit": True})
        assert json.loads(_get(viewer.port, "/pick")) == {"hit": True}
    finally:
        viewer.close()


def test_camera_rig_matches_jax():
    t = tviewer.CameraRig([0.0, 0.3, 2.0], [0.0, 0.0, -0.5])
    j = jviewer.CameraRig([0.0, 0.3, 2.0], [0.0, 0.0, -0.5])
    for k in range(len(EVENTS)):
        assert t.apply(EVENTS[k:k + 1]) == j.apply(EVENTS[k:k + 1])
        np.testing.assert_allclose(t.position, j.position, atol=1e-12)
        np.testing.assert_allclose(t.target, j.target, atol=1e-12)
        assert t.debug_switches == j.debug_switches
        assert t.brightness == j.brightness
        assert t.reset_requested == j.reset_requested
    assert t.take_picks() == j.take_picks() == [(0.25, 0.75)]
    tc, jc = t.make_camera(np.deg2rad(50), 1.5), j.make_camera(
        np.deg2rad(50), 1.5)
    for f in ("position", "orientation", "fov_y", "aspect"):
        np.testing.assert_allclose(np.asarray(getattr(tc, f)),
                                   np.asarray(getattr(jc, f)), atol=1e-6,
                                   err_msg=f)


def test_camera_rig_orbits_the_point_in_view():
    """The apps' rig orbits a point along the CLI camera's view (the
    camera's +z column); JAX's maybe_camera_rig takes -z, a point behind
    the camera, so after a move JAX's live view looks away from the scene
    (ROADMAP Queue C)."""
    from gfxexp_torch.apps import common as tcommon
    from gfxexp_tpu.apps import common as jcommon

    argv = ["-cam-pos", "0", "1", "3.2", "-cam-pitch", "-12"]
    targs = tcommon.parse_scene_args(tcommon.make_arg_parser("pt"), argv)
    jargs = jcommon.parse_scene_args(jcommon.make_arg_parser("pt"), argv)
    view = tcommon.make_camera_from_args(targs).orientation[:, 2].numpy()
    t = tcommon.maybe_camera_rig(targs, object())
    j = jcommon.maybe_camera_rig(jargs, object())
    np.testing.assert_allclose(t.position, j.position)
    dt = (t.target - t.position) / np.linalg.norm(t.target - t.position)
    dj = (j.target - j.position) / np.linalg.norm(j.target - j.position)
    np.testing.assert_allclose(dt, view, atol=1e-6)
    np.testing.assert_allclose(dj, -view, atol=1e-6)


@pytest.fixture
def live(monkeypatch):
    """Patch LiveViewer to serve on a free port and queue `events[0]`
    before the app's first frame (as a page would POST them); yields the
    dict that receives the viewer."""
    state = {"events": []}
    orig = tviewer.LiveViewer.__init__

    def patched(self, port=8716, **kw):
        orig(self, port=0, **kw)
        state["viewer"] = self
        for ev in state["events"]:
            assert _post(self.port, ev) == 204

    monkeypatch.setattr(tviewer.LiveViewer, "__init__", patched)
    yield state
    if "viewer" in state:
        state["viewer"].close()


def test_path_tracing_live_orbit_and_pick(tmp_path, live):
    """-live 0: an orbit restarts the accumulation from the moved camera,
    and a shift-click pick is answered at GET /pick."""
    live["events"] = [{"action": "orbit", "dx": 60, "dy": 10},
                      {"action": "pick", "u": 0.5, "v": 0.6}]
    base = ["-device", "cpu", "-width", "24", "-height", "24", "-frames",
            "3", "-max-path-length", "2", "-cam-pos", "0", "0.5", "1.9",
            "-fov", "75"]
    still = tpt_app.main(base + ["-output", str(tmp_path / "still")])
    moved = tpt_app.main(base + ["-live", "0", "-output",
                                 str(tmp_path / "live")])
    assert (tmp_path / "live.png").exists()
    assert np.isfinite(moved).all() and not np.array_equal(moved, still)
    assert moved.mean() > 0.1 * still.mean()  # the orbit keeps the scene
    v = live["viewer"]
    info = json.loads(_get(v.port, "/pick"))
    assert info["pixel"] == [12, 14] and isinstance(info["hit"], bool)
    if info["hit"]:
        assert np.isfinite(info["position"]).all()
    assert _get(v.port, "/meta") == b"3"


def test_tfdm_live_orbit(tmp_path, live):
    live["events"] = [{"action": "orbit", "dx": 30, "dy": 0}]
    hdr = ttfdm_app.main(["-device", "cpu", "-width", "16", "-height", "16",
                          "-frames", "2", "-base-res", "4", "-live", "0",
                          "-output", str(tmp_path / "tfdm")])
    assert np.isfinite(hdr).all() and (tmp_path / "tfdm.png").exists()
    assert _get(live["viewer"].port, "/meta") == b"2"


def test_debug_draw_writes_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    for cls, name in ((TDraw, "t.ply"), (JDraw, "j.ply")):
        dd = cls()
        dd.set_color(1, 0, 0).point(rng.random(3))
        dd.points(rng.random((4, 3)))
        dd.line([0, 0, 0], [1, 2, 3]).vector([0, 1, 0], [0, 0, 2], 0.5)
        dd.set_color(0.2, 0.4, 0.6).cross([1, 1, 1], 0.3)
        dd.aabb([-1, -1, -1], [1, 2, 3])
        dd.triangle([0, 0, 0], [1, 0, 0], [0, 1, 0])
        dd.frame([0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1])
        dd.save(str(tmp_path / "sub" / name))
        rng = np.random.default_rng(0)
    t = (tmp_path / "sub" / "t.ply").read_bytes()
    assert t == (tmp_path / "sub" / "j.ply").read_bytes()
    assert TDraw().triangle([0, 0, 0], [1, 0, 0], [0, 1, 0]).counts == (
        3, 0, 1)


def test_enable_compile_cache_keys_host_and_device(tmp_path, monkeypatch):
    """One build directory, keyed by host and device: the cache is the
    directory csrc/build.py and accel/native.py build into."""
    from gfxexp_torch.csrc import build
    from gfxexp_torch.utils import runtime

    monkeypatch.setattr(build, "BUILD_DIR", None)
    path = runtime.enable_compile_cache()
    dev = "nocuda" if not torch.cuda.is_available() else "sm"
    assert os.path.basename(path).startswith(
        f"torch-{build._host_tag()}-{dev}")
    assert os.path.dirname(path) == os.path.join(build._REPO, ".cache")
    assert build.build_dir() == path and os.path.isdir(path)
    mine = runtime.enable_compile_cache(str(tmp_path / "c"))
    assert build.build_dir() == mine == str(tmp_path / "c")
