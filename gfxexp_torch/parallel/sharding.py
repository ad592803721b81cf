"""Multi-device scaling on torch.distributed (port of
gfxexp_tpu/parallel/sharding.py): the image plane sharded over the ranks of
the default process group, one device a rank.

The scene and its structure are small beside a device's memory and are
replicated; the ray lanes are sharded. Each rank renders its contiguous lane
range (`render_lanes(lane_start=rank * lanes_per)`) and one all_gather puts
the lanes back in block-major lane order. SVGF's à-trous pyramid is sharded
over image rows: every stage trades halos of `radius * step + 1` rows with
the two neighbouring ranks (zeros at the image's top and bottom, which every
tap's hit test weighs 0), and the rows are gathered after the last stage.
The NRC step is data-parallel: each rank takes its slice of the batch, and
one all_reduce sums the flattened (loss sum, valid count, gradients).

The caller initialises the process group: NCCL for CUDA devices, gloo for
the CPU, e.g. `torch.distributed.init_process_group("nccl",
init_method="file:///tmp/rendezvous", world_size=1, rank=0)`. Nothing here
renders alone when the group is missing: make_mesh raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from gfxexp_torch.core.tree import tree_flatten, tree_unflatten
from gfxexp_torch.render.pathtrace import PTConfig, render_lanes


@dataclass(frozen=True)
class Mesh:
    """The default process group seen from one rank: its rank, the world
    size and the device its tensors live on."""

    rank: int
    size: int
    device: torch.device


def make_mesh(device=None) -> Mesh:
    """The mesh of the default process group and this rank's device
    (default: the current CUDA device under NCCL, the CPU under gloo).
    Raises when no process group is initialised."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call torch.distributed."
            "init_process_group(backend, init_method=..., world_size=..., "
            "rank=...) first ('nccl' on CUDA devices, 'gloo' on the CPU; "
            "a world size of 1 is a mesh of one device)")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if (backend == "nccl") != (device.type == "cuda"):
        raise ValueError(f"backend {backend!r} does not serve {device} "
                         f"tensors: use nccl for cuda, gloo for the cpu")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(),
                device=device)


def _gather_rows(mesh: Mesh, x):
    """The ranks' blocks of x stacked in rank order along dim 0."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def render_sample_sharded(mesh: Mesh, scene, bvh, camera, width: int,
                          height: int, sample_idx,
                          cfg: PTConfig = PTConfig()):
    """One sample per pixel, the lanes sharded over the mesh: radiance
    [H*W, 3] in block-major LANE order (render_lanes' order, as the JAX
    package returns it), on every rank."""
    total = width * height
    if total % mesh.size:
        raise ValueError(f"{total} lanes do not split over {mesh.size} "
                         f"ranks")
    if cfg.count_rays:
        raise ValueError("the sharded render returns radiance only: "
                         "count_rays must be off")
    lanes_per = total // mesh.size
    out = render_lanes(scene, bvh, camera, width, height,
                       mesh.rank * lanes_per, lanes_per, sample_idx, cfg)
    return _gather_rows(mesh, out)


def _halo_exchange(mesh: Mesh, x, h: int):
    """x [rows, ...] padded with the h rows above it (the previous rank's
    bottom rows) and the h rows below it (the next rank's top rows); zeros
    at the image's edges, as JAX's ppermute fills them."""
    top = torch.zeros_like(x[:h])
    bot = torch.zeros_like(x[:h])
    ops = []
    if mesh.rank > 0:
        ops += [dist.P2POp(dist.isend, x[:h].contiguous(), mesh.rank - 1),
                dist.P2POp(dist.irecv, top, mesh.rank - 1)]
    if mesh.rank < mesh.size - 1:
        ops += [dist.P2POp(dist.isend, x[-h:].contiguous(), mesh.rank + 1),
                dist.P2POp(dist.irecv, bot, mesh.rank + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([top, x, bot])


def _sharded_pyramid(mesh: Mesh):
    """svgf_frame's `pyramid_fn`: the à-trous stages on this rank's row
    block with halos traded each stage, then the rows gathered."""
    from gfxexp_torch.techniques.svgf import (
        _STEP_WIDTHS,
        ATROUS_GAUSS5,
        _atrous_stage_core,
        _depth_gradients,
    )

    def pyramid(noisy, variance, gb, cfg):
        height = gb.depth.shape[0]
        if height % mesh.size:
            raise ValueError(f"{height} rows do not split over {mesh.size} "
                             f"ranks")
        rows = height // mesh.size
        radius = 2 if cfg.atrous_kernel == ATROUS_GAUSS5 else 1
        steps = _STEP_WIDTHS[:cfg.num_filter_stages]
        max_halo = max((radius * s + 1 for s in steps), default=0)
        # one exchange reaches the neighbouring row blocks only
        if max_halo > rows:
            raise ValueError(
                f"à-trous halo {max_halo} rows exceeds the {rows}-row "
                f"shard; use a taller image, fewer ranks, or fewer filter "
                f"stages")
        dzdx, dzdy = _depth_gradients(
            torch.where(gb.hit, gb.depth, float("inf")))
        mine = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
        # the stage's inputs in one float tensor a row block: color 3,
        # variance, depth, normal 3, hit, dzdx, dzdy
        guide = torch.cat([gb.depth[mine, :, None], gb.normal[mine],
                           gb.hit[mine, :, None].to(torch.float32),
                           dzdx[mine, :, None], dzdy[mine, :, None]], -1)
        color, var = noisy[mine], variance[mine]
        first = color
        for si, step in enumerate(steps):
            h = radius * step + 1
            x = _halo_exchange(
                mesh, torch.cat([color, var[..., None], guide], -1), h)
            c2, v2 = _atrous_stage_core(
                x[..., 0:3], x[..., 3], x[..., 4], x[..., 5:8],
                x[..., 8] != 0, x[..., 9], x[..., 10], step, cfg)
            color, var = c2[h:-h], v2[h:-h]
            if si == 0:
                first = color
        both = _gather_rows(mesh, torch.stack([color, first]).transpose(0, 1))
        return both[:, 0], both[:, 1]

    return pyramid


def svgf_frame_sharded(mesh: Mesh, state, gb, lighting, cfg=None):
    """One SVGF frame (techniques/svgf.py svgf_frame) with the à-trous
    pyramid sharded over image rows; the temporal passes and TAA stay
    replicated. Returns (final colour [H, W, 3], new state) on every
    rank."""
    from gfxexp_torch.techniques.svgf import SVGFConfig, svgf_frame

    return svgf_frame(state, gb, lighting,
                      SVGFConfig() if cfg is None else cfg,
                      pyramid_fn=_sharded_pyramid(mesh))


def nrc_train_step_dp(mesh: Mesh, state, query, target, mask, nrc_cfg):
    """Data-parallel NRC training: this rank's slice of the batch, one
    all_reduce of the flattened (loss sum, valid count, gradients), the
    gradients over the valid records, then Adam and the EMA
    (network.apply_step). Returns (new state, loss), equal on every
    rank."""
    from gfxexp_torch.techniques.nrc.network import (
        apply_step,
        masked_loss_sum,
        value_and_grads,
    )

    n = query.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} "
                         f"ranks")
    mine = slice(mesh.rank * (n // mesh.size),
                 (mesh.rank + 1) * (n // mesh.size))
    loss_sum, grads = value_and_grads(masked_loss_sum, state["params"],
                                      query[mine], target[mine],
                                      mask[mine], nrc_cfg)
    leaves, structure = tree_flatten(grads)
    n_valid = mask[mine].sum().to(torch.float32)
    flat = torch.cat([loss_sum.reshape(1), n_valid.reshape(1)]
                     + [g.reshape(-1) for g in leaves])
    dist.all_reduce(flat)
    inv_n = 1.0 / torch.clamp(flat[1], min=1.0)
    out, off = [], 2
    for g in leaves:
        out.append(flat[off:off + g.numel()].reshape(g.shape) * inv_n)
        off += g.numel()
    return (apply_step(state, tree_unflatten(structure, out), nrc_cfg),
            flat[0] * inv_n)
