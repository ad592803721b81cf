"""neural_radiance_caching app: path tracing with an online-trained neural
radiance cache, headless (port of
gfxexp_tpu/apps/neural_radiance_caching.py).

    python -m gfxexp_torch.apps.neural_radiance_caching -device cpu \\
        -width 64 -height 64 -frames 8 -stats -output out/nrc \\
        [-position-encoding hash_grid] [-checkpoint out/nrc.npz]

Runs on the card (`-device cuda`, the default) or on the CPU (`-device
cpu`). Each frame advances the animation (`update`), renders one NRC
sample, whose paths end in the cache and whose training suffixes record
targets (`pathTrace+infer`), and trains the cache on them (`train`,
`-train-steps` Adam steps on disjoint slices of a permutation); the film
accumulates the frames. `-visualize-cache` also writes the cache's
prediction at the primary hits (`<output>_cache.png`); `-checkpoint`
saves the trained state and `-resume` starts from a saved one.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gfxexp_torch.apps import common
from gfxexp_torch.utils.runtime import enable_compile_cache


def frame_loop(scene, bvh, camera, controllers, traversal: str, width: int,
               height: int, frames: int, icfg, nrc_cfg, state, aabb,
               timer: common.PassTimer, train_steps: int = 4,
               stats: bool = False, denoiser=None):
    """The app's frames f = 0 .. frames - 1 on the scene's device: `update`
    (at t = f / 60) when there are controllers, `pathTrace+infer`
    (render_sample_nrc with the EMA weights, sample f), `train`
    (train_on_frame, the permutations from one CPU generator seeded 0),
    the film's running mean and the denoiser's step when one is given.
    Returns (film, state, losses, scene, bvh); the losses are 0-d tensors
    on the device, one a frame."""
    from gfxexp_torch.render.film import add_sample, make_film
    from gfxexp_torch.techniques.nrc import train_on_frame
    from gfxexp_torch.techniques.nrc.cache import render_sample_nrc

    advance = common.frame_advance(controllers, traversal)
    dev = scene.device
    generator = torch.Generator().manual_seed(0)
    lo, hi = aabb
    film = make_film(width, height, dev)
    losses = []
    for f in range(frames):
        if controllers:
            scene, bvh = timer.measure("update", advance, scene, bvh,
                                       controllers, f / 60.0)
        radiance, tq, tt, tm = timer.measure(
            "pathTrace+infer", render_sample_nrc, scene, bvh, camera,
            state["ema"], lo, hi, width, height, f, icfg, nrc_cfg)
        state, loss = timer.measure(
            "train", train_on_frame, state, tq, tt, tm, nrc_cfg, train_steps,
            generator)
        losses.append(loss)
        film = add_sample(film, radiance.reshape(height, width, 3))
        if denoiser is not None:
            denoiser.step(scene, bvh, camera, f, film.beauty, timer,
                          icfg.enable_jitter)
        if stats and f % 16 == 15:
            print(f"frame {f + 1}/{frames}: {timer.report()}, loss "
                  f"{float(loss):.4f}", file=sys.stderr)
    return film, state, losses, scene, bvh


def cache_image(scene, bvh, camera, state, aabb, width: int, height: int,
                nrc_cfg):
    """The cache's prediction (EMA weights, times the reflectance) at the
    primary hits of an unjittered G-buffer, [H, W, 3]; 0 where the rays
    miss."""
    from gfxexp_torch.render.bsdf import material_params_textured
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.techniques.nrc import infer
    from gfxexp_torch.techniques.nrc.cache import _query_ref_factor, make_query

    gb = render_gbuffer(scene, bvh, camera, camera, width, height, 0, False)
    n = width * height
    mat = torch.clamp(gb.material.reshape(n), min=0)
    params = material_params_textured(scene.materials, scene.textures, mat,
                                      gb.texcoord.reshape(n, 2))
    q = make_query(aabb[0], aabb[1], gb.position.reshape(n, 3),
                   gb.normal.reshape(n, 3), -gb.view_dir.reshape(n, 3),
                   params)
    pred = torch.clamp(infer(state, q, nrc_cfg), min=0.0)
    pred = pred * _query_ref_factor(q)
    pred = torch.where(gb.hit.reshape(n)[:, None], pred, 0.0)
    return pred.reshape(height, width, 3)


def main(argv=None):
    """Render, write `<output>.png`, and return the accumulated (or, with
    -denoise, the denoised) HDR image [H, W, 3] (numpy)."""
    from gfxexp_torch.techniques.nrc import NRCConfig, init_nrc
    from gfxexp_torch.techniques.nrc.cache import (
        NRCIntegratorConfig,
        scene_aabb,
    )

    p = common.make_arg_parser("neural_radiance_caching")
    p.add_argument("-position-encoding", choices=["triangle_wave",
                                                  "hash_grid"],
                   default="triangle_wave",
                   help="position encoding of the cache's input (the "
                        "reference defaults to hash_grid)")
    p.add_argument("-num-hidden-layers", type=int, default=2)
    p.add_argument("-learning-rate", type=float, default=1e-2)
    p.add_argument("-train-steps", type=int, default=4,
                   help="optimizer steps per frame (the reference: 4)")
    p.add_argument("-train-stride", type=int, default=16)
    p.add_argument("-visualize-cache", action="store_true",
                   help="also write the raw cache prediction at the "
                        "primary hits")
    p.add_argument("-checkpoint", type=str, default=None,
                   help="save the trained cache to this file at the end")
    p.add_argument("-resume", type=str, default=None,
                   help="load the cache's state before rendering")
    args = common.parse_scene_args(p, argv)
    enable_compile_cache()
    dev = common.resolve_device(args)
    scene, bvh, controllers, traversal = common.compile_app_scene(args, dev)
    camera = common.make_camera_from_args(args).to(dev)
    nrc_cfg = NRCConfig(position_encoding=args.position_encoding,
                        num_hidden_layers=args.num_hidden_layers,
                        learning_rate=args.learning_rate)
    icfg = NRCIntegratorConfig(max_path_length=args.max_path_length,
                               train_stride=args.train_stride,
                               enable_jitter=not args.no_jitter)
    state = init_nrc(torch.Generator().manual_seed(0), nrc_cfg, dev)
    if args.resume:
        from gfxexp_torch.utils.checkpoint import load_checkpoint

        state = load_checkpoint(args.resume, like=state)
        print(f"resumed cache from {args.resume}", file=sys.stderr)
    aabb = scene_aabb(scene)
    timer = common.PassTimer(device=dev)
    denoiser = common.maybe_denoiser(args, dev)
    film, state, _, scene, bvh = frame_loop(
        scene, bvh, camera, controllers, traversal, args.width, args.height,
        args.frames, icfg, nrc_cfg, state, aabb, timer,
        train_steps=args.train_steps, stats=args.stats, denoiser=denoiser)

    if args.visualize_cache:
        from gfxexp_torch.utils.image_io import save_png

        vis = cache_image(scene, bvh, camera, state, aabb, args.width,
                          args.height, nrc_cfg).cpu().numpy()
        save_png(args.output + "_cache.png", vis / (1.0 + vis))
        print(f"wrote {args.output}_cache.png", file=sys.stderr)

    out = film.beauty if denoiser is None else denoiser.image
    hdr = out.cpu().numpy()
    common.save_outputs(args, hdr)
    if args.checkpoint:
        from gfxexp_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, state)
        print(f"saved cache to {args.checkpoint}", file=sys.stderr)
    if args.stats:
        print("final:", timer.report(), file=sys.stderr)
    return np.asarray(hdr)


if __name__ == "__main__":
    main()
