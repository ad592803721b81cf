"""tfdm app: tessellation-free displacement mapping, headless (port of
gfxexp_tpu/apps/tfdm.py).

    python -m gfxexp_torch.apps.tfdm -frames 32 -heatmap -output out/tfdm

Renders a displaced height-map patch (a subdivided plane of 2 x n^2 base
triangles, `-base-res n`) over the demo scene (a floor, an area light and a
specular sphere) with the path tracer, whose displaced hooks trace it beside
the triangles (techniques/tfdm.py). The height map is procedural
(`-height-kind ridges|bumps|flat`, 128^2) or read from `-height-map` (a
.dds through load_dds, else any image load_png reads; a 16-bit grey PNG
keeps its full precision), displaced by `-h-offset`,
`-h-scale` and `-h-bias`, with the `-local-intersection` surface type.
`-heatmap` also writes `<output>_heatmap.png`, the march steps per primary
ray. Runs on the card (`-device cuda`, the default) or on the CPU
(`-device cpu`); the scene compiles to the wide-row table unless
`-traversal` says otherwise. `-stats` prints the per-pass times.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gfxexp_torch.apps import common
from gfxexp_torch.utils.runtime import enable_compile_cache


def procedural_height(size: int = 128, kind: str = "ridges") -> np.ndarray:
    """The built-in height maps [size, size] float32."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    if kind == "ridges":
        h = 0.5 + 0.25 * np.sin(8 * np.pi * x) * np.cos(6 * np.pi * y)
    elif kind == "bumps":
        h = ((np.sin(10 * np.pi * x) * np.sin(10 * np.pi * y)) ** 2)
    else:
        h = 0.5 * np.ones_like(x)
    return h.astype(np.float32)


def subdivided_plane(n: int, extent: float = 2.0):
    """An n x n grid plane on XZ centred at the origin, uv over [0, 1]^2:
    (positions, indices, uvs, normals)."""
    xs = np.linspace(-extent / 2, extent / 2, n + 1, dtype=np.float32)
    vx, vz = np.meshgrid(xs, xs, indexing="ij")
    positions = np.stack([vx, np.zeros_like(vx), vz], -1).reshape(-1, 3)
    normals = np.tile(np.array([[0, 1, 0]], np.float32),
                      (positions.shape[0], 1))
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).reshape(-1)
    b = a + 1
    c = a + (n + 1)
    dd = c + 1
    indices = np.stack([np.stack([a, b, dd], -1), np.stack([a, dd, c], -1)],
                       1).reshape(-1, 3).astype(np.int32)
    uvs = (positions[:, [0, 2]] / extent) + 0.5
    return positions, indices, uvs.astype(np.float32), normals


def load_or_procedural_height(args) -> np.ndarray:
    """`-height-map` (channel 0, cut to the largest power-of-two square) or
    the procedural map of `-height-kind`."""
    if args.height_map:
        if args.height_map.lower().endswith(".dds"):
            from gfxexp_torch.scene.textures import load_dds

            height = load_dds(args.height_map)[..., 0]
        else:
            from gfxexp_torch.utils.image_io import load_png

            height = load_png(args.height_map, to_linear=False)
            if height.ndim == 3:
                height = height[..., 0]
        s = 1 << int(np.log2(min(height.shape[:2])))
        return height[:s, :s]
    return procedural_height(kind=args.height_kind)


def add_displacement_args(p):
    p.add_argument("-height-map", type=str, default=None,
                   help="height map file (.dds, or an image load_png reads: "
                        "PNG, JPEG, TGA, BMP, GIF, PNM); procedural if "
                        "omitted")
    p.add_argument("-height-kind", choices=["ridges", "bumps", "flat"],
                   default="ridges")
    p.add_argument("-h-offset", type=float, default=0.0)
    p.add_argument("-h-scale", type=float, default=0.25)
    p.add_argument("-h-bias", type=float, default=0.0)
    p.add_argument("-base-res", type=int, default=24,
                   help="displaced base mesh grid (2*n^2 triangles; 24 -> "
                        "1152 base tris)")
    p.add_argument("-heatmap", action="store_true")


def demo_scene(args, kind: str, params, shell_contents=None):
    """The demo scene's builder: a floor, an area light, a specular sphere
    and the displaced base mesh (`kind` "tfdm" or "nrtdsm"), its vertex
    normals tilted radially by `args.normal_tilt` where the args have one
    (curved shells, which NRTDSM traces exactly); shell_contents =
    (positions, indices) in (u, v, hn) makes it a shell-mapped mesh
    instead."""
    from gfxexp_torch.scene.builder import SceneBuilder, affine

    b = SceneBuilder()
    floor = b.add_lambert_material((0.7, 0.7, 0.72))
    b.add_instance(b.add_rectangle(7.0, 7.0, floor),
                   affine(translation=[0.0, -0.02, 0.0]))
    lamp = b.add_lambert_material((0, 0, 0), emittance=(120.0, 110.0, 100.0))
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    b.add_instance(b.add_rectangle(1.0, 1.0, lamp),
                   affine(rotation=flip, translation=[0.8, 2.6, 0.8]))
    shiny = b.add_diffuse_specular_material((0.2, 0.25, 0.5),
                                            (0.25,) * 3, 0.85)
    b.add_instance(b.add_sphere(0.35, shiny),
                   affine(translation=[-1.35, 0.35, -0.6]))
    disp_mat = b.add_lambert_material((0.65, 0.6, 0.55))
    positions, indices, uvs, normals = subdivided_plane(args.base_res)
    tilt = getattr(args, "normal_tilt", 0.0)
    if tilt:
        radial = positions * np.asarray([[1.0, 0.0, 1.0]], np.float32)
        normals = normals + tilt * radial
        normals = normals / np.maximum(
            np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
    if shell_contents is not None:
        spos, sidx = shell_contents
        b.add_shell(positions, indices, uvs, spos, sidx, params=params,
                    material=disp_mat, normals=normals)
    else:
        b.add_displaced(positions, indices, uvs,
                        load_or_procedural_height(args), params=params,
                        material=disp_mat, kind=kind, normals=normals)
    return b


def heatmap(scene, camera, width: int, height: int, kind: str = "tfdm"):
    """The steps per primary ray (pixel centres) through the scene's first
    displaced mesh (march steps of intersect_tfdm_v2 for "tfdm", of
    intersect_nrtdsm_v2 for the other kinds; chords of intersect_shell on a
    shell), normalised to their maximum, as an RGB image [H, W, 3] (numpy)
    and the raw steps [H, W]."""
    from gfxexp_torch.render.camera import generate_rays_for_lanes
    from gfxexp_torch.techniques.nrtdsm import intersect_nrtdsm_v2
    from gfxexp_torch.techniques.shell import ShellGeometry, intersect_shell
    from gfxexp_torch.techniques.tfdm import intersect_tfdm_v2

    dev = scene.device
    n = width * height
    jx = torch.full((n,), 0.5, device=dev)
    o, d = generate_rays_for_lanes(camera, width, height,
                                   torch.arange(n, device=dev), jx, jx)
    g = scene.displaced[0]
    if isinstance(g, ShellGeometry):
        fn = intersect_shell
    else:
        fn = intersect_tfdm_v2 if kind == "tfdm" else intersect_nrtdsm_v2
    steps = fn(g, o, d).steps
    raw = steps.reshape(height, width).cpu().numpy()
    s = raw.astype(np.float64) / max(float(raw.max()), 1.0)
    return np.stack([s, 1.0 - np.abs(2 * s - 1), 1.0 - s], axis=-1), raw


def compile_demo(args, kind: str, params, shell_contents=None):
    """The demo scene compiled on the CPU for `-traversal` (wide rows by
    default): (scene, bvh, traversal)."""
    from gfxexp_torch.scene.compile import compile_scene

    builder = demo_scene(args, kind, params, shell_contents)
    traversal = args.traversal or "widerow"
    scene, bvh = compile_scene(builder, traversal=traversal,
                               spatial_splits=args.spatial_splits)
    return scene, bvh, traversal


def run_displaced_app(args, kind: str, params, shell_contents=None):
    """Build and compile the demo scene (shell-mapped with
    `shell_contents`), move it to `-device`, render `-frames` frames
    (path_tracing.frame_loop: `pathTrace` a frame; with `-live`, the
    viewer's camera, toggles and picks), write the PNG and, with -heatmap,
    the heatmap. Returns the accumulated HDR image [H, W, 3]
    (numpy)."""
    from gfxexp_torch.apps.path_tracing import frame_loop
    from gfxexp_torch.render.pathtrace import PTConfig
    from gfxexp_torch.utils.image_io import save_png

    enable_compile_cache()
    dev = common.resolve_device(args)
    scene, bvh, traversal = compile_demo(args, kind, params, shell_contents)
    scene, bvh = scene.to(dev), bvh.to(dev)
    camera = common.make_camera_from_args(args).to(dev)
    cfg = PTConfig(max_path_length=args.max_path_length,
                   enable_jitter=not args.no_jitter)
    timer = common.PassTimer(device=dev)
    viewer = common.maybe_viewer(args)
    live = (None if viewer is None
            else (viewer, common.maybe_camera_rig(args, viewer), args))
    film, _, _, _ = frame_loop(scene, bvh, camera, [], traversal, args.width,
                               args.height, args.frames, cfg, timer,
                               stats=args.stats, live=live)
    hdr = film.beauty.cpu().numpy()
    common.save_outputs(args, hdr)
    if args.heatmap:
        heat, _ = heatmap(scene, camera, args.width, args.height, kind)
        save_png(args.output + "_heatmap.png", heat, apply_srgb=False)
        print(f"wrote {args.output}_heatmap.png")
    if args.stats:
        print("final:", timer.report(), file=sys.stderr)
    return hdr


def parse_args(argv=None):
    """The app's options (its defaults: 512^2, 32 frames, -base-res 24,
    ridges, -h-scale 0.25, bilinear, the camera at (0, 2.1, 3.4) pitched
    30 degrees)."""
    p = common.make_arg_parser("tfdm")
    add_displacement_args(p)
    p.add_argument("-local-intersection",
                   choices=["box", "two_triangle", "bilinear", "bspline"],
                   default="bilinear")
    p.set_defaults(cam_pos=[0.0, 2.1, 3.4], cam_yaw=180.0, cam_pitch=30.0)
    return common.parse_scene_args(p, argv)


def displacement_params(args):
    from gfxexp_torch.techniques import tfdm as T

    lit = {"box": T.LOCAL_INTERSECTION_BOX,
           "two_triangle": T.LOCAL_INTERSECTION_TWO_TRIANGLE,
           "bilinear": T.LOCAL_INTERSECTION_BILINEAR,
           "bspline": T.LOCAL_INTERSECTION_BSPLINE}[args.local_intersection]
    return T.DisplacementParameters(
        h_offset=args.h_offset, h_scale=args.h_scale, h_bias=args.h_bias,
        local_intersection_type=lit)


def main(argv=None):
    args = parse_args(argv)
    return run_displaced_app(args, "tfdm", displacement_params(args))


if __name__ == "__main__":
    main()
