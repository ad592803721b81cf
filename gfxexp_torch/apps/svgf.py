"""svgf app: 1-spp path tracing denoised by SVGF, with TAA, headless (port
of gfxexp_tpu/apps/svgf.py).

    python -m gfxexp_torch.apps.svgf -device cpu -width 64 -height 64 \\
        -frames 8 -stats -output out/svgf

Runs on the card (`-device cuda`, the default) or on the CPU (`-device
cpu`), on the DSL's scene or the box and lamp. Each frame advances the
animation (`update`), renders the G-buffer (`gbuffer`) and one path-traced
sample (`pathTrace`) and filters it (`svgf`); the PNG is the last frame's
output. `-no-svgf`, `-no-temporal`, `-no-taa`, `-feedback-1st`,
`-filter-stages N` and `-mollify-specular` set SVGFConfig.
"""

from __future__ import annotations

import sys

import numpy as np

from gfxexp_torch.apps import common
from gfxexp_torch.utils.runtime import enable_compile_cache


def frame_loop(scene, bvh, camera, controllers, traversal: str, width: int,
               height: int, frames: int, pt_cfg, svgf_cfg,
               timer: common.PassTimer, stats: bool = False):
    """The app's frames f = 0 .. frames - 1 on the scene's device: `update`
    (at t = f / 60) when there are controllers, `gbuffer` (sample index f,
    jittered as pt_cfg says), `pathTrace` (render_sample, sample index f)
    and `svgf` (svgf_frame). The camera stays put, so it is also the
    previous frame's. Returns (the last frame's image [H, W, 3], state,
    scene, bvh)."""
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.render.pathtrace import render_sample
    from gfxexp_torch.techniques.svgf import make_svgf_state, svgf_frame

    advance = common.frame_advance(controllers, traversal)
    state = make_svgf_state(width, height, scene.device)
    final = None
    for f in range(frames):
        if controllers:
            scene, bvh = timer.measure("update", advance, scene, bvh,
                                       controllers, f / 60.0)
        gb = timer.measure("gbuffer", render_gbuffer, scene, bvh, camera,
                           camera, width, height, f, pt_cfg.enable_jitter)
        lighting = timer.measure("pathTrace", render_sample, scene, bvh,
                                 camera, width, height, f, pt_cfg)
        final, state = timer.measure("svgf", svgf_frame, state, gb,
                                     lighting.reshape(height, width, 3),
                                     svgf_cfg)
        if stats and f % 16 == 15:
            print(f"frame {f + 1}/{frames}: {timer.report()}",
                  file=sys.stderr)
    return final, state, scene, bvh


def main(argv=None):
    """Render, write `<output>.png`, and return the last frame's HDR image
    [H, W, 3] (numpy)."""
    from gfxexp_torch.render.pathtrace import PTConfig
    from gfxexp_torch.techniques.svgf import SVGFConfig

    p = common.make_arg_parser("svgf")
    p.add_argument("-no-svgf", action="store_true")
    p.add_argument("-no-temporal", action="store_true")
    p.add_argument("-no-taa", action="store_true")
    p.add_argument("-feedback-1st", action="store_true")
    p.add_argument("-filter-stages", type=int, default=5)
    p.add_argument("-mollify-specular", action="store_true")
    args = common.parse_scene_args(p, argv)
    enable_compile_cache()
    dev = common.resolve_device(args)
    scene, bvh, controllers, traversal = common.compile_app_scene(args, dev)
    camera = common.make_camera_from_args(args).to(dev)
    pt_cfg = PTConfig(max_path_length=args.max_path_length,
                      enable_jitter=not args.no_jitter,
                      enable_bump_mapping=args.bump,
                      mollify_specular=args.mollify_specular)
    svgf_cfg = SVGFConfig(
        enable_svgf=not args.no_svgf,
        enable_temporal_accumulation=not args.no_temporal,
        enable_taa=not args.no_taa,
        feedback_1st_filtered=args.feedback_1st,
        num_filter_stages=args.filter_stages,
        mollify_specular=args.mollify_specular)
    timer = common.PassTimer(device=dev)
    final, _, _, _ = frame_loop(scene, bvh, camera, controllers, traversal,
                                args.width, args.height, args.frames, pt_cfg,
                                svgf_cfg, timer, stats=args.stats)
    hdr = final.cpu().numpy()
    common.save_outputs(args, hdr)
    if args.stats:
        print("final:", timer.report(), file=sys.stderr)
    return np.asarray(hdr)


if __name__ == "__main__":
    main()
