"""A configuration, a traffic mix and a per-layer metric are added as new
files plus BENCHMARK.json entries alone: in a copy of the benchmark, a
dummy configuration with a scene recipe of its own (the Cornell box with
its short block animated), a traffic mix and a metric reader written as
files are run and reported with no edit to any file that was there. The
animated scene is checked too, and comes out wrong when the program's
update hands the scene on unchanged."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

_RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import harness
if len(sys.argv) > 3:  # the update hands the scene on unchanged
    from gfxexp_torch.scene import animation
    animation.advance_frame = lambda scene, bvh, *a, **kw: (scene, bvh)
rc, res = harness.run_cell("dummy.cell", 11, 0.2, True, device="cpu",
                           size=(32, 18))
assert rc == 0, rc
"""

_RECIPE = """
from scenes import cornellbox


def build(cfg, seed):
    r = cornellbox.build(cfg, seed)
    r.controllers.append(dict(
        instance=cornellbox.SURFACES.index("short_block"),
        begin_position=(0.0, 0.0, 0.0), end_position=(0.0, 0.05, 0.0),
        begin_orientation=(0, 0, 0, 1), end_orientation=(0, 0, 0, 1),
        begin_scale=1.0, end_scale=1.0, frequency=0.5, initial_time=0.0))
    return r
"""


def _checkout(tmp_path):
    dst = tmp_path / "checkout"
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(BENCH, "configs",
                                      "cornellbox_1080p.json")))
    cfg.update(name="dummy_cfg", recipe="dummy_anim", traversal="skip")
    json.dump(cfg, open(dst / "benchmark/configs/dummy_cfg.json", "w"))
    (dst / "benchmark/scenes/dummy_anim.py").write_text(_RECIPE)
    traffic = json.load(open(os.path.join(BENCH, "traffic", "pt.json")))
    traffic.update(warmup_frames=2, trace_skip=1, trace_frames=1)
    json.dump(traffic, open(dst / "benchmark/traffic/dummy_mix.json", "w"))
    (dst / "benchmark/metrics/dummy_frames.py").write_text(
        "def read(rec):\n    return float(rec.frames)\n")
    bench["configs"].append(dict(bench["configs"][0], name="dummy_cfg",
                                 file="benchmark/configs/dummy_cfg.json"))
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "frame_ms")["workloads"].append("dummy.cell")
    bench["per_layer"].append({"name": "dummy_frames", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "apps frame loop",
                               "moves": "frame_ms",
                               "workloads": ["dummy.cell"]})
    json.dump(bench, open(dst / "BENCHMARK.json", "w"))
    return dst


def _run(dst, *fault):
    out = subprocess.run(
        [sys.executable, "-c", _RUN, str(dst / "benchmark"), ROOT, *fault],
        cwd=dst, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_are_picked_up(tmp_path):
    dst = _checkout(tmp_path)
    res = _run(dst)
    assert res["correct"] and res["metrics"]["dummy_frames"]["value"] >= 2
    assert set(res["checks"]) == {"radiance_mismatch_share",
                                  "film_mismatch_share", "scene_max_error"}
    res = _run(dst, "scene_unchanged")
    assert res["correct"] is False
    check = res["checks"]["scene_max_error"]
    assert not check["value"] <= check["limit"], check
