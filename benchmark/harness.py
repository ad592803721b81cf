"""The benchmark's runner: one run of one cell of BENCHMARK.json.

A cell names a configuration (configs/<config>.json: a scene recipe of
scenes/<recipe>.py with its sizes) and a traffic mix (traffic/<traffic>.json:
the app whose frame loop serves it, loops/<app>.py, and its settings). A
run builds the scene from the seed, hands it to the port, warms up the
app's own frame loop, then runs it for --seconds as one viewer sees it: a
closed loop of frames rendered back to back. The app measures its passes
with the timer it is given; the benchmark's timer fences every pass, as
the app's own PassTimer does, and keeps every sample. Every metric is
read from what the run recorded by metrics/<name>.py (see reader_of).
After the window, the reference (reference/) recomputes what the window
produced at frames and pixels drawn from the seed, and `correct` says
whether the program stayed within each number's limit.

Nothing here imports JAX or the JAX package; a run that finds either in
sys.modules once the window has closed prints no result and fails.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gfxexp_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, by name."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    return importlib.import_module(f"{kind}.{name}")


def cell(bench: dict, workload: str):
    """(workload entry, config, traffic) of a cell, found by name."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}: "
                         f"{sorted(entries)}")
    w = entries[workload]
    cfg = load_json(HERE, "configs", w["config"] + ".json")
    traffic = load_json(HERE, "traffic", w["traffic"] + ".json")
    return w, cfg, traffic


def metrics_of(bench: dict, workload: str, trace: bool):
    """The metric entries this cell reports: its end-to-end metrics, or with
    trace its per-layer metrics (those that list it, or list no cells and
    move a metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader_of(name: str) -> str:
    """The reader of a metric, metrics/<reader>.py: its name up to the first
    dot. What follows a dot splits one quantity by the end-to-end metric it
    moves in the cells it lists (frame_ms.svgf reads as frame_ms does)."""
    return name.split(".")[0]


def forbidden_modules():
    """The JAX modules loaded in this process, by whole top-level name (an
    entry of None only blocks an import)."""
    return sorted({k.split(".")[0] for k, v in sys.modules.items()
                   if v is not None} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the timer the app's frame loop measures its passes with
# ---------------------------------------------------------------------------


class FrameTimer:
    """PassTimer's interface (measure, mean_ms, report) with every sample
    kept. A frame starts at its first pass (`first_pass`); each pass ends
    in a device synchronisation, as the app's own timer does. `on_pass`
    sees each pass's arguments and result; `on_frame` is called as a frame
    starts; `annotate` wraps each pass (a profiler range while tracing)."""

    def __init__(self, first_pass: str, sync):
        self.first_pass = first_pass
        self.sync = sync
        self.frame = -1
        self.starts = []
        self.samples = {}
        self.on_pass = None
        self.on_frame = None
        self.annotate = None

    def measure(self, name, fn, *a, **kw):
        if name == self.first_pass:
            self.frame += 1
            if self.frame == 0:
                self.sync()  # the loop's own set-up ends outside frame 0
            if self.on_frame is not None:
                self.on_frame(self.frame)
            t0 = time.perf_counter()
            self.starts.append(t0)
        else:
            t0 = time.perf_counter()
        ctx = (self.annotate(name) if self.annotate is not None
               else contextlib.nullcontext())
        with ctx:
            out = fn(*a, **kw)
            self.sync()
        self.samples.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3)
        if self.on_pass is not None:
            self.on_pass(self.frame, name, a, out)
        return out

    def mean_ms(self, name):
        return float(np.mean(self.samples[name]))

    def report(self):
        return ", ".join(f"{k}: {np.mean(v):.2f} ms"
                         for k, v in self.samples.items())


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


class Session:
    """What a loop needs: the device, the frame size, the recipe, the
    port's scene and camera, and the cell's files."""

    def __init__(self, cfg, traffic, seed, device, size=None):
        import torch

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.width, self.height = size or (cfg["width"], cfg["height"])
        recipe_mod = load_module("scenes", cfg["recipe"])
        self.recipe = recipe_mod.build(cfg, seed)
        self.animated = bool(self.recipe.controllers)
        self.traversal = cfg["traversal"]
        self.scene, self.bvh, self.camera, self.controllers = \
            build_program_scene(self.recipe, self.traversal, self.device,
                                self.width, self.height)

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def build_program_scene(recipe, traversal, device, width, height):
    """The recipe handed to the port through its public builder: every
    material, mesh and instance as the recipe gives them, the keyframe
    controllers, and the camera. Returns (scene, bvh, camera, controllers)
    on `device`."""
    from gfxexp_torch.render.camera import make_camera
    from gfxexp_torch.scene.animation import InstanceController
    from gfxexp_torch.scene.builder import HostMaterial, SceneBuilder
    from gfxexp_torch.scene.compile import compile_scene
    from gfxexp_torch.scene.types import BSDF_DIFFUSE_SPECULAR, BSDF_LAMBERT

    kinds = {"lambert": BSDF_LAMBERT,
             "diffuse_specular": BSDF_DIFFUSE_SPECULAR}
    b = SceneBuilder()
    for m in recipe.materials:
        b.add_material(HostMaterial(
            bsdf_type=kinds[m["bsdf"]], diffuse_color=m["diffuse"],
            specular_f0=m["f0"], roughness=m["roughness"],
            emittance=m["emittance"]))
    for g in recipe.geometries:
        b.add_geometry(g["positions"], g["indices"], g["material"],
                       normals=g["normals"], texcoords=g["texcoords"])
    for inst in recipe.instances:
        b.add_instance(inst["geometries"], inst["transform"])
    scene, bvh = compile_scene(b, traversal=traversal)
    cam = recipe.camera
    camera = make_camera(cam["position"], fov_y=math.radians(
        cam["fov_y_deg"]), aspect=width / height, target=cam["target"])
    controllers = [InstanceController(**c) for c in recipe.controllers]
    return scene.to(device), bvh.to(device), camera.to(device), controllers


class Record:
    """What a run recorded, for the metric readers: the window's frames and
    pass samples, and with tracing the profiled stretch's device events,
    walk launches and wall."""

    def __init__(self):
        self.frames = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.intervals_ms = []
        self.passes = {}
        self.kernels = None  # [(name, start_us, end_us)] of the stretch
        self.stretch_frames = 0
        self.stretch_wall_s = 0.0
        self.walk_calls = []  # [(rays, table bytes)] of the stretch
        self.breakdown = None


def plan(sess, rng, n_frames):
    """What the check compares, drawn from the seed before the window: the
    checked frames (the first, and one more) and the film pixels a loop
    follows through every frame. Returns (checked frames, store)."""
    import checks

    frames = [0, 1 + int(rng.integers(0, 2 ** 31)) % (n_frames - 1)]
    return frames, {"film_pixels": checks.sample_pixels(
        rng, sess.traffic.get("check_film_pixels", 0), sess)}


def window(sess, loop, rng, n_frames):
    """The app's own frame loop for `n_frames`, timed by a FrameTimer, with
    what the check compares captured as the loop produces it (the frames
    and pixels drawn from `rng` first). Returns (timer, store, checked
    frames, the state of `rng` that the check goes on from)."""
    frames, store = plan(sess, rng, n_frames)
    timer = FrameTimer(loop.first_pass(sess), sess.sync)
    timer.on_pass = lambda f, name, a, o: loop.capture(
        sess, store, f, name, a, o, f in frames)
    store["result"] = loop.run(sess, n_frames, timer)
    sess.sync()
    return timer, store, frames, rng.bit_generator.state


def judge(sess, loop, store, frames, rng, state, control=False):
    """The check of a window: ([(name, value, limit)], frames found wrong),
    the program's outputs against the reference, or with `control` the
    reference in bfloat16 in the program's place (see checks.py)."""
    rng.bit_generator.state = state
    return loop.check(sess, store, frames, rng, control)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", size=None, t_process=None,
             out=sys.stdout, err=sys.stderr):
    """One run. Returns (exit code, result dict or None). `size` and a CPU
    `device` are for the benchmark's own tests."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    bench = load_json(ROOT, "BENCHMARK.json")
    w, cfg, traffic = cell(bench, workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < w["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {w['chips']} CUDA device(s), found {found}", file=err)
        return 2, None
    loop = load_module("loops", traffic["app"])
    t_import = time.perf_counter()
    torch.empty(1, device=device)  # the device's context
    t_context = time.perf_counter()
    sess = Session(cfg, traffic, seed, device, size)
    sess.sync()
    t_scene = time.perf_counter()
    rng = np.random.default_rng(seed)
    rec = Record()
    if sess.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(sess.device)

    # warm-up: every shape the window uses, counted as set-up; then about
    # calibrate_seconds of frames, whose mean frame time sizes the window
    # (a frame's time swings with the host: a few frames do not tell it).
    # The calibration serves no request and is left out of the set-up.
    est_ms = 1e3
    for n in (traffic["warmup_frames"], None):
        if n is None:
            t_warm = time.perf_counter()
            n = min(max(3, int(math.ceil(
                traffic["calibrate_seconds"] * 1e3 / est_ms))), 1000)
        warm = FrameTimer(loop.first_pass(sess), sess.sync)
        loop.run(sess, n, warm)
        sess.sync()
        est_ms = float(np.mean(np.diff(
            warm.starts[1:] + [time.perf_counter()]))) * 1e3
    n_frames = max(2, int(round(seconds * 1e3 / est_ms)))

    timer, store, check_frames, state = window(sess, loop, rng, n_frames)
    t_end = time.perf_counter()
    setup_s = t_warm - t_process
    print(f"setup {setup_s:.3f} s: imports {t_import - t_process:.3f}, "
          f"device context {t_context - t_import:.3f}, scene built and "
          f"uploaded {t_scene - t_context:.3f}, warm-up frames "
          f"{t_warm - t_scene:.3f}; then calibration frames "
          f"{timer.starts[0] - t_warm:.3f}", file=err)
    rec.frames = len(timer.starts)
    rec.window_s = t_end - timer.starts[0]
    rec.intervals_ms = list(np.diff(timer.starts + [t_end]) * 1e3)
    rec.passes = timer.samples
    q = np.percentile(rec.intervals_ms, [0, 10, 50, 90, 95, 99, 100])
    print(f"window {rec.frames} frames in {rec.window_s:.3f} s (sized from "
          f"{est_ms:.3f} ms); frame ms min, p10, p50, p90, p95, p99, max: "
          + ", ".join(f"{x:.3f}" for x in q) + "; passes ms: "
          + ", ".join(f"{k} {np.mean(v):.3f}"
                      for k, v in timer.samples.items()), file=err)

    if trace:
        _trace_stretch(sess, loop, traffic, rec)
    mem = (torch.cuda.max_memory_allocated(sess.device)
           if sess.device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              "alone", file=err)
        return 3, None

    # the comparison, once the window has closed and the program's state
    # is gone (only what the window produced at the checked frames stays)
    del sess.scene, sess.bvh
    if sess.device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = judge(sess, loop, store, check_frames, rng, state)
    correct = failed == 0

    metrics = {}
    rec.setup_s = setup_s
    for m in metrics_of(bench, workload, trace):
        v = load_module("metrics", reader_of(m["name"])).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if sess.device.type == "cuda" else
                   sess.device.type,
                   "kind": (torch.cuda.get_device_name(sess.device)
                            if sess.device.type == "cuda" else "cpu"),
                   "count": w["chips"], "memory_peak_bytes": int(mem)}
    if trace and rec.kernels is not None:
        import yardstick

        busy = sum(e - s for s, e in yardstick.busy_union(
            [(k[1], k[2]) for k in rec.kernels])) * 1e-6
        device_info["busy_s"] = busy
        device_info["window_s"] = rec.stretch_wall_s
    result = {"correct": correct, "attempted": rec.frames,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace and rec.breakdown is not None:
        result["breakdown"] = rec.breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=err)
    print(json.dumps(result), file=out)
    return 0, result


# ---------------------------------------------------------------------------
# the traced stretch
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def record_walks(calls, frame_of):
    """Each walk query the program makes (the port's intersect_closest and
    intersect_any, wherever its modules bound them) recorded as (frame,
    rays, bytes of the walk's tables), its result unchanged."""
    from gfxexp_torch.accel import traverse

    import yardstick

    originals = {"intersect_closest": traverse.intersect_closest,
                 "intersect_any": traverse.intersect_any}

    def wrap(fn):
        def recorded(bvh, tris, o, *a, **kw):
            calls.append((frame_of(), int(o.shape[0]),
                          yardstick.table_bytes(bvh)))
            return fn(bvh, tris, o, *a, **kw)
        return recorded

    patched = []
    for mod in list(sys.modules.values()):
        name = getattr(mod, "__name__", "") or ""
        if not name.startswith("gfxexp_torch"):
            continue
        for attr, fn in originals.items():
            if getattr(mod, attr, None) is fn:
                setattr(mod, attr, wrap(fn))
                patched.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)


def _trace_stretch(sess, loop, traffic, rec):
    """A steady stretch of frames under torch.profiler: the app's frame
    loop again, the first `trace_skip` frames unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import yardstick

    skip, k = traffic["trace_skip"], traffic["trace_frames"]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    timer = FrameTimer(loop.first_pass(sess), sess.sync)
    state = {}

    def on_frame(f):
        if f == skip:
            sess.sync()
            prof.start()
            state["t0"] = time.perf_counter()
            state["range"] = record_function("bench_stretch")
            state["range"].__enter__()
            timer.annotate = record_function

    timer.on_frame = on_frame
    calls = []
    with record_walks(calls, lambda: timer.frame):
        loop.run(sess, skip + k, timer)
        sess.sync()
    state["range"].__exit__(None, None, None)
    rec.stretch_wall_s = time.perf_counter() - state["t0"]
    prof.stop()
    rec.walk_calls = [(n, b) for f, n, b in calls if f >= skip]
    rec.stretch_frames = k
    events = prof.events()
    dev_type = torch.autograd.DeviceType.CUDA
    # the frame loop's pass ranges and the stretch's own range appear on
    # the device's timeline too (as annotations): they are not operations
    marks = set(timer.samples) | {"bench_stretch"}
    kern, cpu, passes = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name in marks:
            if e.device_type != dev_type:
                passes.append((s, t, e.name))
        elif e.device_type == dev_type:
            kern.append((e.name, s, t))
        else:
            cpu.append((s, t, e.name))
    rec.kernels = kern
    rec.breakdown = yardstick.breakdown(kern, cpu, passes)
