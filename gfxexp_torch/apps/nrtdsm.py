"""nrtdsm app: nonlinear ray tracing for displacement and shell mapping,
headless (port of gfxexp_tpu/apps/nrtdsm.py).

    python -m gfxexp_torch.apps.nrtdsm -frames 32 -heatmap -output out/nrtdsm
    python -m gfxexp_torch.apps.nrtdsm -shell -shell-obj mesh.obj

The tfdm app's demo scene (a floor, an area light, a specular sphere and a
displaced patch of 2 x n^2 base triangles, `-base-res n`, 16 by default)
with the exact nonlinear shells of techniques/nrtdsm.py: the vertex
normals tilt radially by `-normal-tilt`, and the patch is traced on the
`-local-intersection` surface (bilinear: intersect_nrtdsm_v2's march;
two_triangle: intersect_nrtdsm_exact's cubic roots). `-shell` instances an
OBJ (`-shell-obj`, normalised into the unit shell box and tiled
`-shell-grid` x `-shell-grid` in texture space) inside the shells instead
of a height field (techniques/shell.py). The other options are the tfdm
app's (apps/tfdm.py), `-heatmap` included. Runs on the card (`-device
cuda`, the default) or on the CPU (`-device cpu`).
"""

from __future__ import annotations

import os

import numpy as np

from gfxexp_torch.apps import common
from gfxexp_torch.apps.tfdm import add_displacement_args, run_displaced_app

# the JAX app's default: the reference's data folder beside the repository
DEFAULT_SHELL_OBJ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "reference", "data",
    "stanford_bunny_309_faces.obj")


def shell_contents_mesh(obj_path, grid: int):
    """An OBJ normalised into the unit shell box and tiled grid x grid in
    (u, v): (positions [V, 3] in (u, v, hn), indices [F, 3]), as the JAX
    app builds them."""
    from gfxexp_torch.scene import loaders
    from gfxexp_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    geoms = loaders.load_obj(obj_path, b, material_convention="trad")
    pos_l, idx_l = [], []
    voff = 0
    for gid in geoms:
        g = b.geometries[gid]
        pos_l.append(np.asarray(g.positions, np.float32))
        idx_l.append(np.asarray(g.indices, np.int32) + voff)
        voff += len(g.positions)
    pos = np.concatenate(pos_l)
    idx = np.concatenate(idx_l)
    lo = pos.min(axis=0)
    span = np.maximum(pos.max(axis=0) - lo, 1e-9)
    unit = (pos - lo) / span.max()  # a uniform scale into the unit cube
    # x -> u, z -> v, y -> hn; shrunk a little and centred in its cell
    cell = 1.0 / grid
    unit = unit * 0.85 * cell + 0.075 * cell
    tiles_p, tiles_i = [], []
    for gu in range(grid):
        for gv in range(grid):
            off = np.asarray([gu * cell, gv * cell, 0.0], np.float32)
            tiles_p.append(unit[:, [0, 2, 1]] + off)
            tiles_i.append(idx + len(tiles_p[-1]) * (len(tiles_p) - 1))
    return np.concatenate(tiles_p), np.concatenate(tiles_i)


def parse_args(argv=None):
    """The app's options (its defaults: 512^2, 32 frames, -base-res 16,
    -normal-tilt 0.3, ridges, -h-scale 0.25, bilinear, the camera at
    (0, 2.1, 3.4) pitched 30 degrees)."""
    p = common.make_arg_parser("nrtdsm")
    add_displacement_args(p)
    p.add_argument("-normal-tilt", type=float, default=0.3,
                   help="radial tilt of the vertex normals (curved shells)")
    p.add_argument("-shell", action="store_true",
                   help="shell mapping: instance an OBJ inside the shells "
                        "instead of a height field")
    p.add_argument("-shell-obj", type=str, default=DEFAULT_SHELL_OBJ)
    p.add_argument("-shell-grid", type=int, default=3,
                   help="tile the shell contents N x N in texture space")
    p.add_argument("-local-intersection",
                   choices=["bilinear", "two_triangle"], default="bilinear",
                   help="local surface: bilinear (marched) or two_triangle "
                        "(exact cubic roots a micro-triangle)")
    p.set_defaults(cam_pos=[0.0, 2.1, 3.4], cam_yaw=180.0, cam_pitch=30.0,
                   base_res=16)
    return common.parse_scene_args(p, argv)


def displacement_params(args):
    from gfxexp_torch.techniques import tfdm as T

    lit = {"bilinear": T.LOCAL_INTERSECTION_BILINEAR,
           "two_triangle": T.LOCAL_INTERSECTION_TWO_TRIANGLE}[
        args.local_intersection]
    return T.DisplacementParameters(
        h_offset=args.h_offset, h_scale=args.h_scale, h_bias=args.h_bias,
        local_intersection_type=lit)


def shell_contents(args):
    """The -shell contents, or None without -shell."""
    if not args.shell:
        return None
    return shell_contents_mesh(args.shell_obj, args.shell_grid)


def main(argv=None):
    args = parse_args(argv)
    return run_displaced_app(args, "nrtdsm", displacement_params(args),
                             shell_contents=shell_contents(args))


if __name__ == "__main__":
    main()
