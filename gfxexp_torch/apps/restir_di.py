"""restir_di app: reservoir-based spatiotemporal resampled direct
illumination, headless (port of gfxexp_tpu/apps/restir_di.py).

    python -m gfxexp_torch.apps.restir_di -device cpu -width 64 \\
        -height 64 -frames 8 -stats -output out/restir [-rearch]

Runs on the card (`-device cuda`, the default) or on the CPU (`-device
cpu`). Each frame advances the animation (`update`), renders the G-buffer
(`gbuffer`) and runs one ReSTIR DI frame (`restir`); the film accumulates
the frames, and `-denoise` filters it with SVGF on the frame's G-buffer
(`denoise`). `-rearch` takes the rearchitected pipeline (presampled light
pool, decoupled shadow rays), `-reuse-vis-temporal` its visibility reuse;
`-unbiased`, `-no-temporal`, `-no-spatial`, `-no-reuse-visibility` and the
candidate, pass, neighbour and radius options set ReSTIRConfig.
"""

from __future__ import annotations

import sys

import numpy as np

from gfxexp_torch.apps import common
from gfxexp_torch.utils.runtime import enable_compile_cache


def frame_loop(scene, bvh, camera, controllers, traversal: str, width: int,
               height: int, frames: int, cfg, jitter: bool,
               timer: common.PassTimer, stats: bool = False, denoiser=None):
    """The app's frames f = 0 .. frames - 1 on the scene's device: `update`
    (at t = f / 60) when there are controllers, `gbuffer` (sample index f),
    `restir` (restir_di_frame, frame f), the film's running mean and the
    denoiser's step on the film with this frame's G-buffer when one is
    given (its image is `denoiser.image`). The history starts from a
    G-buffer of frame 0. Returns (film, scene, bvh)."""
    from gfxexp_torch.render.film import add_sample, make_film
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.techniques.restir_di import (
        empty_reservoir,
        empty_sample_visibility,
        pixel_ctx,
        restir_di_frame,
    )

    advance = common.frame_advance(controllers, traversal)
    dev = scene.device
    n = width * height
    film = make_film(width, height, dev)
    res = empty_reservoir(n, dev)
    vis = empty_sample_visibility(n, dev)
    gb = render_gbuffer(scene, bvh, camera, camera, width, height, 0, jitter)
    ctx = pixel_ctx(scene, gb, camera)
    for f in range(frames):
        prev_hit = gb.hit.reshape(n)
        prev_pos = gb.position.reshape(n, 3)
        prev_nrm = gb.normal.reshape(n, 3)
        if controllers:
            scene, bvh = timer.measure("update", advance, scene, bvh,
                                       controllers, f / 60.0)
        gb = timer.measure("gbuffer", render_gbuffer, scene, bvh, camera,
                           camera, width, height, f, jitter)
        color, res, ctx, vis = timer.measure(
            "restir", restir_di_frame, scene, bvh, gb, camera, res, ctx,
            prev_hit, prev_pos, prev_nrm, f, cfg, vis)
        film = add_sample(film, color)
        if denoiser is not None:
            # the frame's G-buffer serves as the guide: no second render
            denoiser.step(scene, bvh, camera, f, film.beauty, timer, gb=gb)
        if stats and f % 16 == 15:
            print(f"frame {f + 1}/{frames}: {timer.report()}",
                  file=sys.stderr)
    return film, scene, bvh


def main(argv=None):
    """Render, write `<output>.png`, and return the accumulated (or, with
    -denoise, the denoised) HDR image [H, W, 3] (numpy)."""
    from gfxexp_torch.techniques.restir_di import ReSTIRConfig

    p = common.make_arg_parser("restir_di")
    p.add_argument("-unbiased", action="store_true")
    p.add_argument("-log2-num-candidates", type=int, default=3)
    p.add_argument("-spatial-passes", type=int, default=2)
    p.add_argument("-spatial-neighbors", type=int, default=3)
    p.add_argument("-spatial-radius", type=float, default=20.0)
    p.add_argument("-no-temporal", action="store_true")
    p.add_argument("-no-spatial", action="store_true")
    p.add_argument("-no-reuse-visibility", action="store_true")
    p.add_argument("-rearch", action="store_true",
                   help="rearchitected pipeline (light presampling and "
                        "decoupled shadow and shade passes)")
    p.add_argument("-reuse-vis-temporal", action="store_true",
                   help="rearch: reuse last frame's selected-sample "
                        "visibility for the temporal candidate (no ray)")
    p.add_argument("-light-subsets", type=int, default=128)
    p.add_argument("-light-subset-size", type=int, default=1024)
    args = common.parse_scene_args(p, argv)
    enable_compile_cache()
    dev = common.resolve_device(args)
    scene, bvh, controllers, traversal = common.compile_app_scene(args, dev)
    camera = common.make_camera_from_args(args).to(dev)
    cfg = ReSTIRConfig(
        log2_num_candidates=args.log2_num_candidates,
        enable_temporal_reuse=not args.no_temporal,
        enable_spatial_reuse=not args.no_spatial,
        num_spatial_passes=args.spatial_passes,
        num_spatial_neighbors=args.spatial_neighbors,
        spatial_radius=args.spatial_radius,
        use_unbiased_estimator=args.unbiased,
        reuse_visibility=not args.no_reuse_visibility,
        use_rearchitected_pipeline=args.rearch,
        num_light_subsets=args.light_subsets,
        light_subset_size=args.light_subset_size,
        reuse_visibility_for_temporal=args.reuse_vis_temporal)
    timer = common.PassTimer(device=dev)
    denoiser = common.maybe_denoiser(args, dev)
    film, _, _ = frame_loop(scene, bvh, camera, controllers, traversal,
                            args.width, args.height, args.frames, cfg,
                            not args.no_jitter, timer, stats=args.stats,
                            denoiser=denoiser)
    out = film.beauty if denoiser is None else denoiser.image
    hdr = out.cpu().numpy()
    common.save_outputs(args, hdr)
    if args.stats:
        print("final:", timer.report(), file=sys.stderr)
    return np.asarray(hdr)


if __name__ == "__main__":
    main()
