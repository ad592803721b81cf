"""Shared app framework: the scene-description CLI, the camera, per-pass
timers and the outputs (port of gfxexp_tpu/apps/common.py).

The apps are headless: they render N frames, write a PNG and print per-pass
timings. The reference's scene DSL is accepted so its command lines carry
over (-name, -emittance, -obj PATH SCALE [trad|simple_pbr], -rectangle,
-sphere, -inst with -position, -begin-pos/-end-pos, -begin-scale/-end-scale,
-freq, -time). `-obj` loads a Wavefront OBJ with its MTL materials
(scene/loaders.py load_obj; load_mesh reads PLY, glTF and GLB too). `-device`
picks where the app runs: `cuda` (the default) or `cpu`; without a card,
`cuda` raises instead of falling back.

`-denoise` runs the SVGF denoiser (Denoiser) on the accumulated image
every frame; `-exr` also writes the HDR image as EXR; `-env-texture` lights
the scene with a lat-long EXR; `-bump`, `-texture-lod` (the builder then
makes mips) and `-debug-switches` go to the path tracer. `-live [PORT]`
serves the progressive image over HTTP (utils/viewer.py LiveViewer) and
takes camera moves, debug toggles and picks from the page (CameraRig);
the path_tracing and tfdm apps act on them, the others ignore them, as in
the JAX package.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import List

import numpy as np
import torch


def make_arg_parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=name, description=f"{name} (gfxexp_torch): offline renderer")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device to render on: cuda (default) or cpu")
    p.add_argument("-width", type=int, default=512)
    p.add_argument("-height", type=int, default=512)
    p.add_argument("-frames", type=int, default=32,
                   help="samples/frames to accumulate")
    p.add_argument("-max-path-length", type=int, default=5)
    p.add_argument("-output", type=str, default="output",
                   help="output basename")
    p.add_argument("-exr", action="store_true", help="also write HDR EXR")
    p.add_argument("-no-jitter", action="store_true")
    p.add_argument("-bump", action="store_true", help="enable normal mapping")
    p.add_argument("-stats", action="store_true",
                   help="print per-pass timings")
    p.add_argument("-live", type=int, nargs="?", const=8716, default=None,
                   metavar="PORT", help="live progressive view over HTTP")
    p.add_argument("-traversal", type=str, default=None,
                   choices=["skip", "widerow", "qrow", "instanced",
                            "wide"],
                   help="acceleration-structure format (default: widerow "
                        "for static scenes, skip for animated)")
    p.add_argument("-spatial-splits", action="store_true",
                   help="SBVH spatial splits at BVH build")
    p.add_argument("-rebraid", type=float, default=0.0,
                   help="TLAS rebraiding budget for -traversal instanced")
    p.add_argument("-fused-shadow-rays", action="store_true",
                   help="batch NEE shadow rays with the next bounce's "
                        "closest rays in one walk")
    p.add_argument("-texture-lod", action="store_true",
                   help="trilinear mip LOD for material textures")
    p.add_argument("-denoise", action="store_true",
                   help="denoise the accumulated beauty every frame (SVGF)")
    p.add_argument("-debug-switches", type=int, default=0,
                   help="8-bit path tracer debug field: bit 0 no NEE, 1 no "
                        "implicit light, 2 no Russian roulette, 3 no env "
                        "light, 4 no bump, 5 no jitter, 6 white albedo, 7 "
                        "geometric normals")
    # camera
    p.add_argument("-cam-pos", type=float, nargs=3, default=[0.0, 0.0, 3.16])
    p.add_argument("-cam-roll", type=float, default=0.0)
    p.add_argument("-cam-pitch", type=float, default=0.0)
    p.add_argument("-cam-yaw", type=float, default=180.0,
                   help="default 180: identity orientation looks +z, scenes "
                        "sit toward -z (reference convention)")
    p.add_argument("-fov", type=float, default=50.0, help="vertical fov (deg)")
    p.add_argument("-brightness", type=float, default=1.0)
    p.add_argument("-env-texture", type=str, default=None)
    p.add_argument("-env-power", type=float, default=1.0)
    # the scene DSL (-name/-obj/-rectangle/-sphere/-emittance/-inst/...) is
    # left to build_scene_from_dsl: parse with parse_scene_args
    return p


def parse_scene_args(parser, argv=None):
    """parse_known_args wrapper: the DSL leftovers land in args.scene_args."""
    args, rest = parser.parse_known_args(argv)
    args.scene_args = rest
    return args


def resolve_device(args) -> torch.device:
    """The app's device; `cuda` without a card raises (no CPU fallback)."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass -device cpu to render on "
                           "the CPU")
    return dev


def compile_app_scene(args, dev):
    """The DSL's scene (the box and lamp when it names none) compiled for
    the app's traversal and moved to `dev`. Static scenes default to the
    wide-row walk, animated ones to the refittable skip-link structure;
    `-traversal` overrides. Returns (scene, bvh, controllers, traversal)."""
    from gfxexp_torch.scene.compile import compile_scene

    builder, controllers = build_scene_from_dsl(args, args.scene_args)
    if not builder.instances:
        builder = default_demo_builder()
    traversal = args.traversal or ("skip" if controllers else "widerow")
    scene, bvh = compile_scene(
        builder, traversal=traversal,
        spatial_splits=(args.spatial_splits
                        if traversal in ("widerow", "qrow") else False),
        rebraid=args.rebraid if traversal == "instanced" else 0.0)
    return scene.to(dev), bvh.to(dev), controllers, traversal


def frame_advance(controllers, traversal: str):
    """The per-frame animation update of the traversal's structure:
    advance_frame (skip-link refit) or advance_frame_instanced (two-level
    rigid update). Raises for an animated scene on a static table."""
    from gfxexp_torch.scene.animation import (
        advance_frame,
        advance_frame_instanced,
    )

    if controllers and traversal not in ("skip", "instanced"):
        raise ValueError(f"animated scenes need -traversal skip or "
                         f"instanced, got {traversal!r}")
    return (advance_frame_instanced if traversal == "instanced"
            else advance_frame)


def euler_orientation(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Camera-to-world [3, 3] of the reference's roll (z), pitch (x), yaw
    (y) convention."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return (ry @ rx @ rz).astype(np.float32)


def build_scene_from_dsl(args, extra_argv: List[str]):
    """Parse the reference scene DSL from leftover argv and build the scene.
    Returns (SceneBuilder, controllers)."""
    from gfxexp_torch.scene.animation import InstanceController
    from gfxexp_torch.scene.builder import SceneBuilder, affine
    from gfxexp_torch.scene.loaders import load_obj

    b = SceneBuilder(texture_mips=getattr(args, "texture_lod", False))
    controllers: List[InstanceController] = []
    named = {}  # name -> (geometry ids, base scale)
    pending_name = "unnamed"
    pending_emittance = (0.0, 0.0, 0.0)
    argv = list(extra_argv)
    n_used_instances = 0
    i = 0

    def floats(k):
        nonlocal i
        vals = [float(argv[i + 1 + j]) for j in range(k)]
        i += k
        return vals

    while i < len(argv):
        a = argv[i]
        if a == "-name":
            pending_name = argv[i + 1]
            i += 1
        elif a == "-emittance":
            pending_emittance = tuple(floats(3))
        elif a == "-obj":
            # -obj PATH SCALE [trad|simple_pbr]: the convention word is
            # taken only when it is one of the two, so the option after
            # a bare -obj PATH SCALE is kept
            path, scale = argv[i + 1], float(argv[i + 2])
            convention = "trad"
            i += 2
            if i + 1 < len(argv) and argv[i + 1] in ("trad", "simple_pbr"):
                convention = argv[i + 1]
                i += 1
            geoms = load_obj(path, b, material_convention=convention)
            named[pending_name] = (geoms, scale)
        elif a in ("-rectangle", "-sphere"):
            mat = b.add_lambert_material((0.0, 0.0, 0.0),
                                         emittance=pending_emittance)
            if a == "-rectangle":
                w, d = floats(2)
                geom = b.add_rectangle(w, d, mat)
            else:
                (r,) = floats(1)
                geom = b.add_sphere(r, mat)
            named[pending_name] = ([geom], 1.0)
            pending_emittance = (0.0, 0.0, 0.0)
        elif a == "-inst":
            name = argv[i + 1]
            i += 1
            geoms, base_scale = named[name]
            pos = [0.0, 0.0, 0.0]
            begin_pos = end_pos = None
            begin_scale = end_scale = 1.0
            freq = 1.0
            t0 = 0.0
            while i + 1 < len(argv) and argv[i + 1].startswith("-"):
                k = argv[i + 1]
                if k == "-position":
                    i += 1
                    pos = floats(3)
                elif k == "-begin-pos":
                    i += 1
                    begin_pos = floats(3)
                elif k == "-end-pos":
                    i += 1
                    end_pos = floats(3)
                elif k == "-begin-scale":
                    i += 1
                    begin_scale = floats(1)[0]
                elif k == "-end-scale":
                    i += 1
                    end_scale = floats(1)[0]
                elif k == "-freq":
                    i += 1
                    freq = floats(1)[0]
                elif k == "-time":
                    i += 1
                    t0 = floats(1)[0]
                else:
                    break
            inst = b.add_instance(geoms,
                                  affine(scale=base_scale, translation=pos))
            if begin_pos is not None or end_pos is not None:
                controllers.append(InstanceController(
                    instance=inst,
                    begin_position=tuple(begin_pos or pos),
                    end_position=tuple(end_pos or begin_pos or pos),
                    begin_scale=begin_scale * base_scale,
                    end_scale=end_scale * base_scale,
                    frequency=freq, initial_time=t0))
            n_used_instances += 1
        i += 1

    # groups never instanced explicitly get one instance each
    if n_used_instances == 0:
        for geoms, scale in named.values():
            b.add_instance(geoms, affine(scale=scale))
    if getattr(args, "env_texture", None):
        from gfxexp_torch.utils.image_io import load_exr

        b.set_environment(load_exr(args.env_texture)[:, :, :3],
                          power_coeff=args.env_power)
    return b, controllers


def make_camera_from_args(args):
    from gfxexp_torch.render.camera import make_camera

    orientation = euler_orientation(
        math.radians(args.cam_roll), math.radians(args.cam_pitch),
        math.radians(args.cam_yaw))
    return make_camera(args.cam_pos, fov_y=math.radians(args.fov),
                       aspect=args.width / args.height,
                       orientation=orientation)


class PassTimer:
    """Per-pass wall-clock times with a moving window. On a CUDA device each
    measured pass ends in torch.cuda.synchronize(), so a time covers the
    device's work."""

    def __init__(self, window: int = 60, device=None):
        self.window = window
        self.samples = {}
        self.device = None if device is None else torch.device(device)

    def measure(self, name: str, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = (time.perf_counter() - t0) * 1000.0
        vals = self.samples.setdefault(name, [])
        vals.append(dt)
        if len(vals) > self.window:
            vals.pop(0)
        return out

    def mean_ms(self, name: str) -> float:
        return float(np.mean(self.samples[name]))

    def report(self) -> str:
        return ", ".join(f"{name}: {np.mean(vals):.2f} ms"
                         for name, vals in self.samples.items())


def maybe_viewer(args):
    """A LiveViewer on `-live`'s port when it was given, else None."""
    if getattr(args, "live", None) is None:
        return None
    from gfxexp_torch.utils.viewer import LiveViewer

    return LiveViewer(port=args.live)


def viewer_update(viewer, film_beauty, frame: int, brightness: float = 1.0):
    """Push the image [H, W, 3] (a tensor on any device) to the viewer."""
    if viewer is not None:
        viewer.update(film_beauty.detach().cpu().numpy(), frame=frame,
                      brightness=brightness)


def maybe_camera_rig(args, viewer):
    """An interactive CameraRig when a live viewer is attached, orbiting a
    point along the CLI camera's view at the camera's distance from the
    origin (at least 1); None for offline renders. The view is the
    orientation's +z column, as make_camera builds it (JAX's rig takes -z,
    a point behind the camera: ROADMAP Queue C)."""
    if viewer is None:
        return None
    from gfxexp_torch.utils.viewer import CameraRig

    cam_pos = np.asarray(args.cam_pos, np.float64)
    ori = euler_orientation(math.radians(args.cam_roll),
                            math.radians(args.cam_pitch),
                            math.radians(args.cam_yaw))
    fwd = np.asarray(ori, np.float64) @ np.asarray([0.0, 0.0, 1.0])
    dist = max(float(np.linalg.norm(cam_pos)), 1.0)
    rig = CameraRig(cam_pos, cam_pos + fwd * dist)
    rig.debug_switches = int(getattr(args, "debug_switches", 0))
    return rig


def rig_step(rig, viewer, args, film, make_film_fn):
    """Drain the viewer's events into the rig. When the camera or the
    switches changed, returns (camera on the CPU, make_film_fn(width,
    height), debug switches): accumulation restarts, as the reference's
    resetAccumulation on a move; else (None, film, None)."""
    if rig is None or viewer is None:
        return None, film, None
    changed = rig.apply(viewer.drain_events())
    if not changed and not rig.reset_requested:
        return None, film, None
    rig.reset_requested = False
    camera = rig.make_camera(math.radians(args.fov),
                             args.width / args.height)
    return camera, make_film_fn(args.width, args.height), rig.debug_switches


def save_outputs(args, hdr_image: np.ndarray):
    """The PNG of the accumulated HDR image, scaled by -brightness, and
    with -exr the HDR image itself as EXR."""
    from gfxexp_torch.utils.image_io import save_exr, save_png

    out = args.output
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    sdr = np.clip(hdr_image * args.brightness, 0.0, 1.0)
    save_png(out + ".png", sdr)
    if args.exr:
        save_exr(out + ".exr", hdr_image)
    print(f"wrote {out}.png" + (f" and {out}.exr" if args.exr else ""))


class Denoiser:
    """The SVGF denoiser of the apps' `-denoise`: it owns its temporal state
    and renders the G-buffer it needs (or takes the frame's); call step()
    once a frame with the accumulated HDR image [H, W, 3]."""

    def __init__(self, width: int, height: int, taa: bool = False,
                 device="cuda"):
        from gfxexp_torch.techniques.svgf import SVGFConfig, make_svgf_state

        # the accumulated input is already a temporal mean: the à-trous
        # stages and the validated EMA, without TAA unless asked for
        self.cfg = SVGFConfig(enable_taa=taa)
        self.state = make_svgf_state(width, height, device)
        self.width, self.height = width, height
        self.prev_camera = None
        self.image = None  # the last step's output

    def step(self, scene, bvh, camera, frame: int, hdr, timer=None,
             jitter: bool = False, gb=None):
        """The denoised [H, W, 3] image; updates the temporal state."""
        from gfxexp_torch.render.gbuffer import render_gbuffer
        from gfxexp_torch.techniques.svgf import svgf_frame

        def measure(name, fn, *a):
            return fn(*a) if timer is None else timer.measure(name, fn, *a)

        prev_camera = (self.prev_camera if self.prev_camera is not None
                       else camera)
        if gb is None:
            gb = measure("gbuffer", render_gbuffer, scene, bvh, camera,
                         prev_camera, self.width, self.height, frame, jitter)
        hdr = hdr.reshape(self.height, self.width, 3)
        self.image, self.state = measure("denoise", svgf_frame, self.state,
                                         gb, hdr, self.cfg)
        self.prev_camera = camera
        return self.image


def maybe_denoiser(args, device="cuda"):
    """A Denoiser on `device` when -denoise was asked for, else None."""
    if not getattr(args, "denoise", False):
        return None
    return Denoiser(args.width, args.height, device=device)


def pick_info(scene, gb, x: int, y: int) -> dict:
    """What the G-buffer holds at pixel (x, y), as Python values."""
    unit = int(gb.unit[y, x])
    mat = int(gb.material[y, x])
    return {
        "pixel": (x, y),
        "hit": bool(gb.hit[y, x]),
        "instance": (int(scene.units.instance[unit]) if unit >= 0 else -1),
        "unit": unit,
        "triangle": int(gb.tri[y, x]),
        "material": mat,
        "position": gb.position[y, x].tolist(),
        "normal": gb.normal[y, x].tolist(),
        "albedo": gb.albedo[y, x].tolist(),
        "emittance": (scene.materials.emittance[mat].tolist()
                      if mat >= 0 else [0, 0, 0]),
    }


def default_demo_builder():
    """The scene when no DSL was given: the classic box and lamp."""
    from gfxexp_torch.scene.builder import SceneBuilder, affine

    b = SceneBuilder()
    wall = b.add_lambert_material((0.7, 0.7, 0.7))
    light = b.add_lambert_material((0, 0, 0), emittance=(20.0, 20.0, 20.0))
    s = 2.0
    flipx = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    b.add_instance(b.add_rectangle(2 * s, 2 * s, wall),
                   affine(translation=[0, -s, 0]))
    b.add_instance(b.add_rectangle(2 * s, 2 * s, wall),
                   affine(rotation=flipx, translation=[0, s, 0]))
    rot_zp = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)
    b.add_instance(b.add_rectangle(2 * s, 2 * s, wall),
                   affine(rotation=rot_zp, translation=[0, 0, -s]))
    rot_xp = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float64)
    b.add_instance(b.add_rectangle(2 * s, 2 * s, wall),
                   affine(rotation=rot_xp, translation=[-s, 0, 0]))
    rot_xm = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
    b.add_instance(b.add_rectangle(2 * s, 2 * s, wall),
                   affine(rotation=rot_xm, translation=[s, 0, 0]))
    b.add_instance(b.add_rectangle(0.8, 0.8, light),
                   affine(rotation=flipx, translation=[0, s - 0.01, 0]))
    return b
