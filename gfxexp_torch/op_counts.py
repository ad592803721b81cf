"""Operations one path-tracing sample dispatches, counted on the CPU: a
stand-in for the CUDA kernels it launches on the card, where eager glue
launches about one kernel an operation.

    python -m gfxexp_torch.op_counts
    python3 gfxexp_torch/op_counts.py --cuda  # on the card

Counts every operation torch dispatches during one render_sample (after a
warm-up sample), leaving out views (select, slice, view, expand, ...), which
launch nothing, and counting each walk (intersect_closest, intersect_any) as
one operation, as it is one launch on the card. Prints one JSON line per
case: the small bench scene with the default PTConfig and with fused shadow
rays, and the textured scene (bench.build_textured_scene, skip-link) with
the default PTConfig, with bump mapping and texture LOD, with solid-angle
NEE and with fused shadow rays; then the tfdm app's demo scene (wide
rows) with its default base mesh (-base-res 24, 1,152 prisms, the slab
sweep broad phase) and with -base-res 32 (2,048 prisms, the prism BVH's
walk); then the nrtdsm app's demo scene at its defaults (-base-res 16,
curved shells) on the bilinear surface, on the two-triangle surface and
with -shell (the torus OBJ). `walks` is the number of walk launches (a
shell's chord queries included); a displaced row also has the host syncs
and loop iterations of its displaced calls (the `tfdm.*` counters of
utils/trace.py, techniques/tfdm.py LOOP_COUNTERS), which grow with the
rays' worst case and so with the resolution (`--res N` sets it, 32 by
default).

With --cuda it profiles one default sample of the small scene at 512x512
on the card instead (render_accumulate, after a warm-up sample) and prints
the kernels of the device trace and the CUDA runtime's launch calls on the
host. Run as a file, it measures whichever gfxexp_torch PYTHONPATH puts
first, so that a parent tree's sample can be counted with this script:
`PYTHONPATH=<parent tree> python3 gfxexp_torch/op_counts.py --cuda`.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gfxexp_torch import bench
from gfxexp_torch.render import pathtrace
from gfxexp_torch.render.pathtrace import PTConfig, render_sample
from gfxexp_torch.utils import trace

_VIEWS = ("select.int", "slice.Tensor", "view.default", "t.default",
          "unsqueeze.default", "expand.default", "alias.default",
          "detach.default", "_unsafe_view.default", "as_strided.default",
          "reshape.default", "permute.default", "squeeze.dim",
          "transpose.int")


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0
        self.walks = 0
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and func.__name__ not in _VIEWS:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def count_sample(scene, bvh, camera, width: int, height: int,
                 cfg: PTConfig, debug_switches: int = 0) -> dict:
    """{"ops", "walks"} of one render_sample (sample 1, after sample 0)."""
    from gfxexp_torch.techniques import shell

    counter = None
    # the walks: the path tracer's, and the shells' queries of their
    # contents (one launch each on the card)
    real = {(mod, n): getattr(mod, n) for mod, n in (
        (pathtrace, "intersect_closest"), (pathtrace, "intersect_any"),
        (shell, "intersect_closest"))}

    def walk(fn):
        def counted(*a, **kw):
            if counter is None:
                return fn(*a, **kw)
            counter.paused += 1
            try:
                return fn(*a, **kw)
            finally:
                counter.paused -= 1
                counter.ops += 1
                counter.walks += 1
        return counted

    for (mod, name), fn in real.items():
        setattr(mod, name, walk(fn))
    try:
        render_sample(scene, bvh, camera, width, height, 0, cfg,
                      debug_switches)
        with _Count() as counter:
            render_sample(scene, bvh, camera, width, height, 1, cfg,
                          debug_switches)
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    return {"ops": counter.ops, "walks": counter.walks}


def tfdm_scene(base_res: int, width: int, height: int):
    """The tfdm app's demo scene (its defaults but `-base-res`) compiled as
    wide rows, and its camera: (scene, bvh, camera) on the CPU."""
    from gfxexp_torch.apps import common
    from gfxexp_torch.apps import tfdm as app

    args = app.parse_args(["-base-res", str(base_res), "-width", str(width),
                           "-height", str(height)])
    scene, bvh, _ = app.compile_demo(args, "tfdm",
                                     app.displacement_params(args))
    return scene, bvh, common.make_camera_from_args(args)


NRTDSM_CASES = {"nrtdsm_bilinear": [],
                "nrtdsm_two_triangle": ["-local-intersection",
                                        "two_triangle"],
                "nrtdsm_shell": ["-shell"]}


def nrtdsm_scene(case: str, width: int, height: int, mesh_dir: str):
    """The nrtdsm app's demo scene at its defaults (-base-res 16, -normal-
    tilt 0.3) with the flags of NRTDSM_CASES[case], compiled as wide rows,
    and its camera: (scene, bvh, camera) on the CPU. -shell instances the
    torus OBJ that gfxexp_torch.bench.write_mesh_files writes into
    mesh_dir."""
    from gfxexp_torch.apps import common
    from gfxexp_torch.apps import nrtdsm as app
    from gfxexp_torch.apps.tfdm import compile_demo

    extra = list(NRTDSM_CASES[case])
    if "-shell" in extra:
        extra += ["-shell-obj", bench.write_mesh_files(mesh_dir)["obj"]]
    args = app.parse_args(["-width", str(width), "-height", str(height),
                           *extra])
    scene, bvh, _ = compile_demo(args, "nrtdsm", app.displacement_params(args),
                                 app.shell_contents(args))
    return scene, bvh, common.make_camera_from_args(args)


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def _loop_counts() -> dict:
    """The displaced calls' loop counters (techniques/tfdm.py
    LOOP_COUNTERS) a sample: they cover the warm-up sample too, so they
    are halved."""
    from gfxexp_torch.techniques import tfdm

    c = trace.counters("tfdm.")
    return {k: c.get(f"tfdm.{k}", 0) / 2 for k in tfdm.LOOP_COUNTERS}


def count_cuda_sample() -> dict:
    """Kernels in the device trace and launch calls of one default 512x512
    sample of the small scene on the card."""
    from torch.profiler import ProfilerActivity, profile

    from gfxexp_torch.render.pathtrace import render_accumulate

    dev = torch.device("cuda")
    scene, bvh = (x.to(dev) for x in bench.build_bench_scene())
    cam = bench.bench_camera(512, 512).to(dev)
    cfg = PTConfig(max_path_length=5, count_rays=True)
    render_accumulate(scene, bvh, cam, 512, 512, 0, 1, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_accumulate(scene, bvh, cam, 512, 512, 1, 1, cfg)
        torch.cuda.synchronize()
    events = prof.events()
    return {"case": "small_default_512_cuda",
            "kernels": sum(1 for e in events if e.device_type
                           == torch.autograd.DeviceType.CUDA),
            "launch_calls": sum(1 for e in events
                                if e.name in LAUNCH_CALLS),
            "package": os.path.dirname(bench.__file__)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--cuda" in argv:
        row = count_cuda_sample()
        print(json.dumps(row))
        return row
    torch.set_num_threads(2)
    res = int(argv[argv.index("--res") + 1]) if "--res" in argv else 32
    rows = {}
    scene, bvh = bench.build_bench_scene()
    cam = bench.bench_camera(res, res)
    for name, cfg in (("small_default", PTConfig()),
                      ("small_fused", PTConfig(fuse_shadow_rays=True))):
        rows[name] = count_sample(scene, bvh, cam, res, res, cfg)
    with tempfile.TemporaryDirectory() as tex:
        scene, bvh = bench.build_textured_scene(os.path.join(tex, "tex"))
    cam = bench.textured_camera(res, res)
    for name, cfg in (
            ("textured_default", PTConfig()),
            ("textured_bump_lod", PTConfig(enable_bump_mapping=True,
                                           texture_lod=True)),
            ("textured_solid_angle", PTConfig(use_solid_angle_sampling=True)),
            ("textured_fused", PTConfig(fuse_shadow_rays=True))):
        rows[name] = count_sample(scene, bvh, cam, res, res, cfg)
    for base_res in (24, 32):
        scene, bvh, cam = tfdm_scene(base_res, res, res)
        trace.reset_counters("tfdm.")
        row = count_sample(scene, bvh, cam, res, res, PTConfig())
        rows[f"tfdm_base{base_res}"] = {**row, **_loop_counts()}
    with tempfile.TemporaryDirectory() as mesh_dir:
        for case in NRTDSM_CASES:
            scene, bvh, cam = nrtdsm_scene(case, res, res, mesh_dir)
            trace.reset_counters("tfdm.")
            row = count_sample(scene, bvh, cam, res, res, PTConfig())
            rows[case] = {**row, **_loop_counts()}
    for name, row in rows.items():
        print(json.dumps({"case": name, **row}), file=sys.stdout)
    return rows


if __name__ == "__main__":
    main()
