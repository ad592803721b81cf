"""path_tracing app: the NEE+MIS path tracer with progressive accumulation,
headless (port of gfxexp_tpu/apps/path_tracing.py).

    python -m gfxexp_torch.apps.path_tracing -cam-pos 0 0 3.2 -frames 64 \\
        -name floor -rectangle 4 4 -inst floor \\
        -name lamp -emittance 30 30 30 -rectangle 1 1 -inst lamp \\
            -position 0 2 0 -begin-pos 0 2 0 -end-pos 0 1.5 0

Runs on the card (`-device cuda`, the default) or on the CPU
(`-device cpu`). Static scenes compile to the wide-row table, animated ones
(any -begin-pos/-end-pos) to the refittable skip-link BVH; `-traversal`
overrides. Each frame advances the animation (`update`), renders one sample
(`pathTrace`) and adds it to the film; `-denoise` runs the SVGF denoiser
on the film every frame (`gbuffer`, `denoise`) and writes its image;
`-stats` prints the per-pass times. `-bump`, `-texture-lod`,
`-fused-shadow-rays` and `-debug-switches` set the path tracer's options;
`-exr` also writes `<output>.exr`. `-live [PORT]` serves the film over
HTTP each frame: a camera move or a debug toggle from the page restarts
the accumulation, and a shift-click renders a G-buffer and publishes what
it holds at that pixel (GET /pick).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gfxexp_torch.apps import common
from gfxexp_torch.utils.runtime import enable_compile_cache


def frame_loop(scene, bvh, camera, controllers, traversal: str, width: int,
               height: int, frames: int, cfg, timer: common.PassTimer,
               stats: bool = False, denoiser=None, debug_switches: int = 0,
               live=None):
    """The app's frames f = 0 .. frames - 1 on the scene's device: `update`
    (advance_frame, or advance_frame_instanced for two-level scenes, at
    t = f / 60) when there are controllers, `pathTrace` (render_sample with
    sample index f and the debug switches), the film's running mean, and
    the denoiser's step on the film when one is given (its image is
    `denoiser.image`). Returns (film, scene, bvh, rays): rays is the
    traced-ray count when cfg.count_rays, else None.

    `live` = (viewer, rig, args) attaches a LiveViewer: before each frame
    the rig's events may move the camera or flip debug switches, which
    restarts the film and the sample indices; picks are answered from a
    G-buffer at the current camera; the film (or the denoised image) is
    pushed after each frame."""
    from gfxexp_torch.render.film import add_sample, make_film
    from gfxexp_torch.render.pathtrace import render_sample

    advance = common.frame_advance(controllers, traversal)
    dev = scene.device
    film = make_film(width, height, dev)
    rays = torch.zeros((), device=dev) if cfg.count_rays else None
    viewer, rig, args = live if live is not None else (None, None, None)
    sample_key = 0
    for f in range(frames):
        new_cam, film, new_sw = common.rig_step(
            rig, viewer, args, film, lambda w, h: make_film(w, h, dev))
        if new_cam is not None:
            camera = new_cam.to(dev)
            debug_switches = new_sw
            sample_key = f  # the restarted film's own sample indices
        if controllers:
            scene, bvh = timer.measure("update", advance, scene, bvh,
                                       controllers, f / 60.0)
        out = timer.measure("pathTrace", render_sample, scene, bvh, camera,
                            width, height, f - sample_key, cfg,
                            debug_switches)
        if cfg.count_rays:
            out, nr = out
            rays = rays + nr
        film = add_sample(film, out.reshape(height, width, 3))
        if denoiser is not None:
            denoiser.step(scene, bvh, camera, f, film.beauty, timer,
                          cfg.enable_jitter)
        if rig is not None and rig.pick_requests:
            _answer_picks(scene, bvh, camera, width, height, f, rig, viewer)
        common.viewer_update(
            viewer, film.beauty if denoiser is None else denoiser.image,
            f + 1, brightness=rig.brightness if rig is not None else 1.0)
        if stats and f % 16 == 15:
            print(f"frame {f + 1}/{frames}: {timer.report()}",
                  file=sys.stderr)
    return film, scene, bvh, rays


def _answer_picks(scene, bvh, camera, width, height, frame, rig, viewer):
    """The reference's pick under the cursor: one G-buffer at the current
    camera, read at each requested (u, v) and published by the viewer."""
    from gfxexp_torch.render.gbuffer import render_gbuffer

    gb = render_gbuffer(scene, bvh, camera, camera, width, height, frame,
                        enable_jitter=False)
    for pu, pv in rig.take_picks():
        px = min(max(int(pu * width), 0), width - 1)
        py = min(max(int(pv * height), 0), height - 1)
        viewer.set_pick(common.pick_info(scene, gb, px, py))


def main(argv=None):
    """Render, write `<output>.png`, and return the accumulated (or, with
    -denoise, the denoised) HDR image [H, W, 3] (numpy)."""
    from gfxexp_torch.render.pathtrace import PTConfig

    args = common.parse_scene_args(common.make_arg_parser("path_tracing"),
                                   argv)
    enable_compile_cache()
    dev = common.resolve_device(args)
    scene, bvh, controllers, traversal = common.compile_app_scene(args, dev)
    camera = common.make_camera_from_args(args).to(dev)
    cfg = PTConfig(max_path_length=args.max_path_length,
                   enable_jitter=not args.no_jitter,
                   enable_bump_mapping=args.bump,
                   fuse_shadow_rays=args.fused_shadow_rays,
                   texture_lod=args.texture_lod)
    timer = common.PassTimer(device=dev)
    denoiser = common.maybe_denoiser(args, dev)
    viewer = common.maybe_viewer(args)
    live = (None if viewer is None
            else (viewer, common.maybe_camera_rig(args, viewer), args))
    film, _, _, _ = frame_loop(scene, bvh, camera, controllers, traversal,
                               args.width, args.height, args.frames, cfg,
                               timer, stats=args.stats, denoiser=denoiser,
                               debug_switches=args.debug_switches,
                               live=live)
    out = film.beauty if denoiser is None else denoiser.image
    hdr = out.cpu().numpy()
    common.save_outputs(args, hdr)
    if args.stats:
        print("final:", timer.report(), file=sys.stderr)
    return np.asarray(hdr)


if __name__ == "__main__":
    main()
