"""Row-cursor skip-link walk (port of gfxexp_tpu/accel/pallas_rowcursor.py,
whose `intersect_*_rowcursor` names it keeps).

Replaces the TPU kernel `_make_kernel` (gfxexp_tpu/accel/pallas_rowcursor.py
:76, launched by `_run` :206), which keeps one skip-link cursor per 128-lane
row of a tile. On the card that is the warp scope of
csrc/skiplink_traverse.cu (`skiplink_warp_walk`): one cursor per 32 rays,
which descends when any of its rays hits the node's box, over a window of
32 consecutive nodes held in registers, one a lane, with a hit leaf's
triangle rows staged for the warp. It computes the function of the per-ray
walk (accel/skip_traverse.py), launch counts included there under
"closest_warp" / "any_warp"; on CPU tensors the plain version runs.
"""

from __future__ import annotations

import torch

from gfxexp_torch.accel.skip_traverse import walk
from gfxexp_torch.accel.skiplink import SkipBVH
from gfxexp_torch.accel.traverse import HitInfo


def intersect_closest_rowcursor(bvh: SkipBVH, tris, o, d, t_min=1e-4,
                                t_max=1e30) -> HitInfo:
    return walk(bvh, tris, o, d, t_min, t_max, False, "warp")


def intersect_any_rowcursor(bvh: SkipBVH, tris, o, d, t_min=1e-4,
                            t_max=1e30) -> torch.Tensor:
    return walk(bvh, tris, o, d, t_min, t_max, True, "warp").hit
