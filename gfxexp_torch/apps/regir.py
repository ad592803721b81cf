"""regir app: path tracing with ReGIR's world-space grid reservoirs for
every next-event estimate, headless (port of gfxexp_tpu/apps/regir.py).

    python -m gfxexp_torch.apps.regir -device cpu -width 64 -height 64 \\
        -frames 8 -stats -output out/regir [-grid-dim 16 16 16]

Runs on the card (`-device cuda`, the default) or on the CPU (`-device
cpu`). Each frame advances the animation (`update`), rebuilds the cell
reservoirs (`buildCellReservoirs`) and traces one sample (`pathTrace`);
the film accumulates the frames, and `-denoise` filters it with SVGF.
`-grid-dim`, `-light-slots`, `-log2-candidates-per-slot`,
`-log2-candidates-per-cell`, `-no-temporal` and `-no-cell-randomization`
set ReGIRConfig.
"""

from __future__ import annotations

import sys

import numpy as np

from gfxexp_torch.apps import common
from gfxexp_torch.utils.runtime import enable_compile_cache


def frame_loop(scene, bvh, camera, controllers, traversal: str, width: int,
               height: int, frames: int, pt_cfg, regir_cfg, jitter: bool,
               timer: common.PassTimer, stats: bool = False, denoiser=None):
    """The app's frames f = 0 .. frames - 1 on the scene's device: `update`
    (at t = f / 60) when there are controllers, `buildCellReservoirs`
    (frame f), `pathTrace` (render_sample_regir, sample f), the LRU's
    finalize_frame, the film's running mean and the denoiser's step when
    one is given. The grid spans the first frame's scene. Returns (film,
    state, scene, bvh)."""
    from gfxexp_torch.render.film import add_sample, make_film
    from gfxexp_torch.techniques.regir import (
        build_cell_reservoirs,
        finalize_frame,
        make_grid,
        make_regir_state,
        render_sample_regir,
    )

    advance = common.frame_advance(controllers, traversal)
    dev = scene.device
    grid = make_grid(scene, regir_cfg)
    state = make_regir_state(regir_cfg, dev)
    film = make_film(width, height, dev)
    for f in range(frames):
        if controllers:
            scene, bvh = timer.measure("update", advance, scene, bvh,
                                       controllers, f / 60.0)
        state = timer.measure("buildCellReservoirs", build_cell_reservoirs,
                              scene, state, grid, f, regir_cfg)
        radiance, state = timer.measure(
            "pathTrace", render_sample_regir, scene, bvh, camera, state,
            grid, width, height, f, pt_cfg, regir_cfg)
        state = finalize_frame(state, f)
        film = add_sample(film, radiance.reshape(height, width, 3))
        if denoiser is not None:
            denoiser.step(scene, bvh, camera, f, film.beauty, timer, jitter)
        if stats and f % 16 == 15:
            n_active = int((state.num_accesses > 0).sum())
            print(f"frame {f + 1}/{frames}: {timer.report()}, active cells "
                  f"{n_active}", file=sys.stderr)
    return film, state, scene, bvh


def main(argv=None):
    """Render, write `<output>.png`, and return the accumulated (or, with
    -denoise, the denoised) HDR image [H, W, 3] (numpy)."""
    from gfxexp_torch.render.pathtrace import PTConfig
    from gfxexp_torch.techniques.regir import ReGIRConfig

    p = common.make_arg_parser("regir")
    p.add_argument("-grid-dim", type=int, nargs=3, default=[16, 16, 16])
    p.add_argument("-light-slots", type=int, default=512,
                   help="light slots per cell (the reference's "
                        "kNumLightSlotsPerCell)")
    p.add_argument("-log2-candidates-per-slot", type=int, default=3)
    p.add_argument("-log2-candidates-per-cell", type=int, default=3)
    p.add_argument("-no-temporal", action="store_true")
    p.add_argument("-no-cell-randomization", action="store_true")
    args = common.parse_scene_args(p, argv)
    enable_compile_cache()
    dev = common.resolve_device(args)
    scene, bvh, controllers, traversal = common.compile_app_scene(args, dev)
    camera = common.make_camera_from_args(args).to(dev)
    pt_cfg = PTConfig(max_path_length=args.max_path_length,
                      enable_jitter=not args.no_jitter,
                      enable_bump_mapping=args.bump)
    regir_cfg = ReGIRConfig(
        grid_dimension=tuple(args.grid_dim),
        num_light_slots_per_cell=args.light_slots,
        log2_num_candidates_per_slot=args.log2_candidates_per_slot,
        log2_num_candidates_per_cell=args.log2_candidates_per_cell,
        enable_temporal_reuse=not args.no_temporal,
        enable_cell_randomization=not args.no_cell_randomization)
    timer = common.PassTimer(device=dev)
    denoiser = common.maybe_denoiser(args, dev)
    film, _, _, _ = frame_loop(scene, bvh, camera, controllers, traversal,
                               args.width, args.height, args.frames, pt_cfg,
                               regir_cfg, not args.no_jitter, timer,
                               stats=args.stats, denoiser=denoiser)
    out = film.beauty if denoiser is None else denoiser.image
    hdr = out.cpu().numpy()
    common.save_outputs(args, hdr)
    if args.stats:
        print("final:", timer.report(), file=sys.stderr)
    return np.asarray(hdr)


if __name__ == "__main__":
    main()
