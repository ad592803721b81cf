"""Skip-link walk: the wrappers of the CUDA kernel (port of
gfxexp_tpu/accel/pallas_traverse.py, whose `intersect_*_pallas` names they
keep).

Replaces the TPU kernel `_make_kernel`
(gfxexp_tpu/accel/pallas_traverse.py:63, launched by `_run` :178): one
skip-link cursor per 4,096-ray tile. The CUDA
kernel (csrc/skiplink_traverse.cu) computes the same function with the
cursor kept at one of three scopes:
- "thread": one cursor per ray, what intersect_*_pallas (and so every
  query of a skip-link scene) launch;
- "warp": one cursor per 32 rays, the counterpart of kernel 8's 128-lane
  row cursor (accel/rowcursor.py), walking a window of 32 nodes a warp;
- "block": one cursor per 128-ray block, the counterpart of this kernel's
  tile cursor (walk_skip_cuda(..., scope="block")).
A shared cursor changes which nodes are visited, never the result: a node's
box contains its descendants' boxes and the slab test rounds monotonically,
so a ray that misses a node misses every leaf below it.

On a CUDA tensor the wrappers launch the kernel or raise; the plain version
(accel/skiplink.py `walk_skip_plain`) runs only for tensors on the CPU (and
in tests and chip_smoke.py, which compare the two).
"""

from __future__ import annotations

import ctypes

import torch

from gfxexp_torch.accel.persistent import (
    _launch_walk,
    _walk_fields,
    prepare_rays,
)
from gfxexp_torch.accel.skiplink import SkipBVH, packed, walk_skip_plain
from gfxexp_torch.accel.traverse import HitInfo

SCOPES = ("thread", "warp", "block")
_SCOPE_ID = {s: i for i, s in enumerate(SCOPES)}


class _SkiplinkArgs(ctypes.Structure):
    """csrc/skiplink_traverse.cu's SkiplinkArgs."""

    _fields_ = _walk_fields(("any_hit", "scope", "n_nodes", "n_tri_rows",
                             "max_leaf", "n"), ("nodes", "tris"))


def walk_skip_cuda(bvh: SkipBVH, tris, o, d, t_min, t_max, any_hit: bool,
                   scope: str = "thread") -> HitInfo:
    """Launch csrc/skiplink_traverse.cu on PyTorch's current stream. Raises
    if the kernel cannot be built or the launch is refused."""
    if scope not in SCOPES:
        raise ValueError(f"scope must be one of {SCOPES}, got {scope!r}")
    bvh = packed(bvh, tris)
    o, d, t_min, t_max = prepare_rays(o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"walk_skip_cuda needs CUDA tensors, got {o.device}")
    nodes, tp = bvh.node_pack, bvh.tri_pack
    for name, x in (("node", nodes), ("triangle", tp)):
        if (x.device != o.device or x.dtype != torch.float32
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"the {name} table must be a contiguous, "
                             f"16-byte aligned float32 tensor on {o.device}")
    return _launch_walk(
        "skiplink_traverse", "skiplink_walk", _SkiplinkArgs,
        dict(any_hit=int(any_hit), scope=_SCOPE_ID[scope],
             n_nodes=bvh.num_nodes, n_tri_rows=tp.shape[0],
             max_leaf=bvh.max_leaf),
        dict(nodes=(nodes, torch.float32, None),
             tris=(tp, torch.float32, None)),
        (o, d, t_min, t_max),
        f"walk.skip.{'any' if any_hit else 'closest'}_{scope}")


def walk(bvh: SkipBVH, tris, o, d, t_min, t_max, any_hit: bool,
         scope: str = "thread") -> HitInfo:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if o.device.type == "cuda":
        return walk_skip_cuda(bvh, tris, o, d, t_min, t_max, any_hit, scope)
    if o.device.type == "cpu":
        return walk_skip_plain(bvh, tris, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no skip-link walk for device {o.device}")


def intersect_closest_pallas(bvh: SkipBVH, tris, o, d, t_min=1e-4,
                             t_max=1e30) -> HitInfo:
    """Closest hit of rays o, d [N, 3] against the skip-link BVH (the
    thread scope on the card)."""
    return walk(bvh, tris, o, d, t_min, t_max, False)


def intersect_any_pallas(bvh: SkipBVH, tris, o, d, t_min=1e-4,
                         t_max=1e30) -> torch.Tensor:
    """Occlusion [N] bool: any triangle with t_min < t < t_max."""
    return walk(bvh, tris, o, d, t_min, t_max, True).hit
