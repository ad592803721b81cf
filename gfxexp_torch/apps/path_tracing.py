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
`-exr` also writes `<output>.exr`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gfxexp_torch.apps import common


def frame_loop(scene, bvh, camera, controllers, traversal: str, width: int,
               height: int, frames: int, cfg, timer: common.PassTimer,
               stats: bool = False, denoiser=None, debug_switches: int = 0):
    """The app's frames f = 0 .. frames - 1 on the scene's device: `update`
    (advance_frame, or advance_frame_instanced for two-level scenes, at
    t = f / 60) when there are controllers, `pathTrace` (render_sample with
    sample index f and the debug switches), the film's running mean, and the denoiser's step on
    the film when one is given (its image is `denoiser.image`). Returns
    (film, scene, bvh, rays): rays is the traced-ray count when
    cfg.count_rays, else None."""
    from gfxexp_torch.render.film import add_sample, make_film
    from gfxexp_torch.render.pathtrace import render_sample

    advance = common.frame_advance(controllers, traversal)
    dev = scene.device
    film = make_film(width, height, dev)
    rays = torch.zeros((), device=dev) if cfg.count_rays else None
    for f in range(frames):
        if controllers:
            scene, bvh = timer.measure("update", advance, scene, bvh,
                                       controllers, f / 60.0)
        out = timer.measure("pathTrace", render_sample, scene, bvh, camera,
                            width, height, f, cfg, debug_switches)
        if cfg.count_rays:
            out, nr = out
            rays = rays + nr
        film = add_sample(film, out.reshape(height, width, 3))
        if denoiser is not None:
            denoiser.step(scene, bvh, camera, f, film.beauty, timer,
                          cfg.enable_jitter)
        if stats and f % 16 == 15:
            print(f"frame {f + 1}/{frames}: {timer.report()}",
                  file=sys.stderr)
    return film, scene, bvh, rays


def main(argv=None):
    """Render, write `<output>.png`, and return the accumulated (or, with
    -denoise, the denoised) HDR image [H, W, 3] (numpy)."""
    from gfxexp_torch.render.pathtrace import PTConfig

    args = common.parse_scene_args(common.make_arg_parser("path_tracing"),
                                   argv)
    common.check_unported(args)
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
    film, _, _, _ = frame_loop(scene, bvh, camera, controllers, traversal,
                               args.width, args.height, args.frames, cfg,
                               timer, stats=args.stats, denoiser=denoiser,
                               debug_switches=args.debug_switches)
    out = film.beauty if denoiser is None else denoiser.image
    hdr = out.cpu().numpy()
    common.save_outputs(args, hdr)
    if args.stats:
        print("final:", timer.report(), file=sys.stderr)
    return np.asarray(hdr)


if __name__ == "__main__":
    main()
