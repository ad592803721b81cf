"""ReGIR: world-space grid reservoirs with two-stage streaming RIS (port of
gfxexp_tpu/techniques/regir.py).

The cell build is one batched pass over [num_cells * slots] lanes: per-slot
streaming RIS over 2^k light candidates, scored by the luminous intensity
at the cell centre, then temporal reuse with a 20x clamp, then the LRU mask
(cells idle for more than `lru_idle_frames` keep their reservoirs). At
shade time the path tracer's NEE hook (render_lanes' `nee_fn`) looks up a
jittered cell, resamples 2^k uniformly picked slots by their unshadowed
contribution and traces one shadow ray for the winner; the hook's aux is
the per-cell touch count that feeds the LRU.

The random numbers are the JAX package's, drawn in the same order: the
build on SampleStream(slot, frame, 0x9e61), 1 + 2 + 1 draws a candidate and
one for the temporal merge; the hook on the path tracer's bounce stream, 3
jitter draws (with cell randomization) and 2 a resample. Frame indices are
Python ints; nothing here reads a tensor back to the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from gfxexp_torch.accel.traverse import intersect_any
from gfxexp_torch.core.math import to_local
from gfxexp_torch.core.rng import SampleStream
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.render.bsdf import bsdf_evaluate
from gfxexp_torch.scene.lights import PROB_SAMPLE_ENV
from gfxexp_torch.scene.types import SceneData, world_bounds
from gfxexp_torch.techniques.restir_di import _sample_light_stratified

_PI = float(np.pi)
_BUILD_STREAM = 0x9E61


@dataclasses.dataclass(frozen=True)
class ReGIRConfig:
    grid_dimension: tuple = (16, 16, 16)
    num_light_slots_per_cell: int = 512
    log2_num_candidates_per_slot: int = 3
    log2_num_candidates_per_cell: int = 3
    enable_temporal_reuse: bool = True
    enable_cell_randomization: bool = True
    lru_idle_frames: int = 8

    @property
    def num_cells(self):
        gx, gy, gz = self.grid_dimension
        return gx * gy * gz


@dataclass
class GridInfo(TensorData):
    origin: torch.Tensor  # [3]
    cell_size: torch.Tensor  # [3]


@dataclass
class ReGIRState(TensorData):
    """Cell reservoirs, flat [num_cells * slots], and the LRU's per-cell
    bookkeeping."""

    pos: torch.Tensor  # [S, 3]
    nrm: torch.Tensor  # [S, 3]
    emit: torch.Tensor  # [S, 3]
    at_inf: torch.Tensor  # [S] bool
    sum_w: torch.Tensor  # [S]
    stream_len: torch.Tensor  # [S]
    rec_pdf: torch.Tensor  # [S]
    target: torch.Tensor  # [S]
    last_access: torch.Tensor  # [num_cells] int32 frame index
    num_accesses: torch.Tensor  # [num_cells] int32 touches this frame


def make_grid(scene: SceneData, cfg: ReGIRConfig,
              margin: float = 0.01) -> GridInfo:
    """The grid over the scene's world-space triangle AABB grown by
    `margin` of its extent (host-side, once), on the scene's device. A
    two-level scene is bounded in world space too (JAX's make_grid bounds
    its object-space BLAS triangles)."""
    lo, hi = world_bounds(scene)
    extent = hi - lo
    lo = lo - margin * extent
    hi = hi + margin * extent
    dims = np.asarray(cfg.grid_dimension, np.float32)
    dev = scene.triangles.p0.device
    return GridInfo(
        origin=torch.from_numpy(lo.astype(np.float32)).to(dev),
        cell_size=torch.from_numpy(((hi - lo) / dims).astype(np.float32))
        .to(dev))


def make_regir_state(cfg: ReGIRConfig, device="cuda") -> ReGIRState:
    """Empty reservoirs on `device` (the card unless the caller asks for
    the CPU)."""
    n = cfg.num_cells * cfg.num_light_slots_per_cell
    z3 = torch.zeros((n, 3), device=device)
    z = torch.zeros((n,), device=device)
    zc = torch.zeros((cfg.num_cells,), dtype=torch.int32, device=device)
    return ReGIRState(
        pos=z3, nrm=z3, emit=z3,
        at_inf=torch.zeros((n,), dtype=torch.bool, device=device),
        sum_w=z, stream_len=z, rec_pdf=z, target=z,
        last_access=zc, num_accesses=zc)


def _cell_centers(grid: GridInfo, cfg: ReGIRConfig, cell):
    """Centres [S, 3] of the cells `cell` [S]."""
    gx, gy, _ = cfg.grid_dimension
    ijk = torch.stack([cell % gx, (cell // gx) % gy, cell // (gx * gy)],
                      dim=-1).to(torch.float32)
    return grid.origin[None, :] + (ijk + 0.5) * grid.cell_size[None, :]


def _intensity_target(cell_center, half_cell, min_sq_dist, ls_pos, ls_nrm,
                      ls_emit, ls_inf):
    """Luminous intensity of a light sample at the cell centre, with the
    half-space cosine bound (the reference's sampleIntensity)."""
    outside = ls_inf | ((ls_pos < cell_center - half_cell)
                        | (ls_pos > cell_center + half_cell)).any(dim=-1)
    shadow_dir = torch.where(ls_inf[:, None], ls_pos, ls_pos - cell_center)
    perp = (-shadow_dir * ls_nrm).sum(dim=-1)
    dist2_out = (shadow_dir ** 2).sum(dim=-1)
    dist = torch.sqrt(torch.clamp(dist2_out, min=1e-20))
    # the reference compares lpCos (1 at this point) against the minimum
    # squared distance: kept as it is, for parity
    valid_half = (1.0 > min_sq_dist) | ls_inf
    invalid_half = 1.0 < -min_sq_dist
    lp_cos_out = torch.where(valid_half, perp / dist,
                             torch.where(invalid_half, 0.0, 1.0))
    lp_cos = torch.where(outside, lp_cos_out, 1.0)
    dist2 = torch.where(outside, dist2_out, min_sq_dist)
    le = ls_emit / _PI
    cont = le * (lp_cos / torch.clamp(dist2, min=1e-20))[:, None]
    cont = torch.where((lp_cos > 0.0)[:, None], cont, 0.0)
    return cont.mean(dim=-1)


def _select(accept, new, old):
    mask = accept[:, None] if new.dim() == 2 else accept
    return torch.where(mask, new, old)


def build_cell_reservoirs(scene: SceneData, state: ReGIRState,
                          grid: GridInfo, frame_idx: int,
                          cfg: ReGIRConfig = ReGIRConfig()) -> ReGIRState:
    """Per-slot streaming RIS, accumulated temporal reuse and LRU gating;
    clears the per-frame touch counts."""
    frame_idx = int(frame_idx)
    dev = state.sum_w.device
    slots = cfg.num_light_slots_per_cell
    n_slots = cfg.num_cells * slots
    slot = torch.arange(n_slots, dtype=torch.int32, device=dev)
    cell = (slot // slots).to(torch.int64)
    rs = SampleStream(slot, frame_idx, stream=_BUILD_STREAM)

    centers = _cell_centers(grid, cfg, cell)
    half_cell = 0.5 * grid.cell_size
    min_sq_dist = (half_cell ** 2).sum()

    n_cand = 1 << cfg.log2_num_candidates_per_slot
    z3 = torch.zeros((n_slots, 3), device=dev)
    z = torch.zeros((n_slots,), device=dev)
    pos, nrm, emit = z3, z3, z3
    at_inf = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
    sum_w = stream_len = selected_target = z
    for i in range(n_cand):
        u_l = rs.next()
        prob = float(np.clip(PROB_SAMPLE_ENV * n_cand - i, 0.0, 1.0))
        u0, u1 = rs.next2()
        ls = _sample_light_stratified(scene, u_l, u0, u1, prob)
        target = _intensity_target(centers, half_cell[None, :], min_sq_dist,
                                   ls.position, ls.normal, ls.emittance,
                                   ls.at_infinity)
        weight = torch.where(ls.pdf > 0.0,
                             target / torch.clamp(ls.pdf, min=1e-30), 0.0)
        sum_w = sum_w + weight
        accept = (rs.next() * sum_w < weight) & (weight > 0.0)
        pos = _select(accept, ls.position, pos)
        nrm = _select(accept, ls.normal, nrm)
        emit = _select(accept, ls.emittance, emit)
        at_inf = _select(accept, ls.at_infinity, at_inf)
        selected_target = _select(accept, target, selected_target)
        stream_len = stream_len + 1.0

    rec_pdf = sum_w / torch.clamp(selected_target * stream_len, min=1e-30)
    bad = ~torch.isfinite(rec_pdf) | (selected_target <= 0.0)
    rec_pdf = torch.where(bad, 0.0, rec_pdf)
    selected_target = torch.where(bad, 0.0, selected_target)

    if cfg.enable_temporal_reuse:
        self_len = stream_len
        dead = rec_pdf == 0.0
        sum_w = torch.where(dead, 0.0, sum_w)
        selected_target = torch.where(dead, 0.0, selected_target)
        prev_len = torch.minimum(state.stream_len, 20.0 * self_len)
        corr = prev_len / torch.clamp(state.stream_len, min=1e-30)
        # a static grid keeps its target pdf across frames
        weight = corr * state.sum_w
        sum_w = sum_w + weight
        accept = (rs.next() * sum_w < weight) & (weight > 0.0)
        pos = _select(accept, state.pos, pos)
        nrm = _select(accept, state.nrm, nrm)
        emit = _select(accept, state.emit, emit)
        at_inf = _select(accept, state.at_inf, at_inf)
        selected_target = _select(accept, state.target, selected_target)
        stream_len = self_len + prev_len
        rec_pdf = (sum_w / torch.clamp(stream_len, min=1e-30)) / torch.clamp(
            selected_target, min=1e-30)
        bad = ~torch.isfinite(rec_pdf) | (selected_target <= 0.0)
        rec_pdf = torch.where(bad, 0.0, rec_pdf)
        selected_target = torch.where(bad, 0.0, selected_target)

    # LRU: cells idle for longer than lru_idle_frames keep their reservoirs
    idle = (frame_idx - state.last_access) > cfg.lru_idle_frames
    active = ~idle[cell]
    return dataclasses.replace(
        state,
        pos=_select(active, pos, state.pos),
        nrm=_select(active, nrm, state.nrm),
        emit=_select(active, emit, state.emit),
        at_inf=_select(active, at_inf, state.at_inf),
        sum_w=_select(active, sum_w, state.sum_w),
        stream_len=_select(active, stream_len, state.stream_len),
        rec_pdf=_select(active, rec_pdf, state.rec_pdf),
        target=_select(active, selected_target, state.target),
        num_accesses=torch.zeros_like(state.num_accesses))


def cell_index(grid: GridInfo, cfg: ReGIRConfig, p):
    """World positions [N, 3] -> linear cell indices [N] (int64), clamped
    to the grid."""
    gx, gy, gz = cfg.grid_dimension
    rel = torch.floor((p - grid.origin[None, :]) / grid.cell_size[None, :])
    # clamp before the integer cast: JAX's cast saturates, torch's is
    # undefined out of range (and a NaN would index out of bounds)
    rel = torch.nan_to_num(rel, nan=0.0)
    i = torch.clamp(rel[:, 0], 0, gx - 1).to(torch.int64)
    j = torch.clamp(rel[:, 1], 0, gy - 1).to(torch.int64)
    k = torch.clamp(rel[:, 2], 0, gz - 1).to(torch.int64)
    return i + j * gx + k * (gx * gy)


def make_regir_nee(state: ReGIRState, grid: GridInfo, cfg: ReGIRConfig):
    """The NEE hook of render_lanes for ReGIR (the reference's useReGIR
    branch of performNextEventEstimation). Its aux is the per-cell touch
    count [num_cells] int32: every alive lane adds one to the cell it
    looked up."""
    slots = cfg.num_light_slots_per_cell
    n_resample = 1 << cfg.log2_num_candidates_per_cell

    def nee_fn(scene, bvh, sp, v_out_local, frame, params, rs, pt_cfg, alive,
               aux):
        t, b, n = frame
        pos = sp.position
        n_lanes = pos.shape[0]
        dev = pos.device
        if cfg.enable_cell_randomization:
            jit = torch.stack([rs.next(), rs.next(), rs.next()], dim=-1)
            cell = cell_index(grid, cfg,
                              pos + (jit - 0.5) * grid.cell_size[None, :])
        else:
            cell = cell_index(grid, cfg, pos)
        res_start = cell * slots

        z3 = torch.zeros((n_lanes, 3), device=dev)
        z = torch.zeros((n_lanes,), device=dev)
        sel_pos = sel_nrm = sel_cont = z3
        sel_inf = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
        sum_w = comb_len = sel_target = z
        for _ in range(n_resample):
            u = rs.next()
            slot_idx = res_start + torch.clamp((u * slots).to(torch.int64),
                                               max=slots - 1)
            r_pos = state.pos[slot_idx]
            r_nrm = state.nrm[slot_idx]
            r_emit = state.emit[slot_idx]
            r_inf = state.at_inf[slot_idx]
            r_len = state.stream_len[slot_idx]
            r_rec = state.rec_pdf[slot_idx]
            comb_len = comb_len + r_len

            # unshadowed contribution at the shading point
            svec = torch.where(r_inf[:, None], r_pos, r_pos - pos)
            d2 = torch.clamp((svec ** 2).sum(dim=-1), min=1e-12)
            sdir = svec / torch.sqrt(d2)[:, None]
            v_in_local = to_local(t, b, n, sdir)
            lp_cos = (-sdir * r_nrm).sum(dim=-1)
            cos_in = torch.abs(v_in_local[..., 2])
            g = torch.where(r_inf, cos_in, lp_cos * cos_in / d2)
            f = bsdf_evaluate(params, v_out_local, v_in_local)
            cont = f * (r_emit / _PI) * g[:, None]
            cont = torch.where((lp_cos > 0.0)[:, None], cont, 0.0)
            target = cont.mean(dim=-1)

            weight = torch.where(r_rec > 0.0, target * r_rec * r_len, 0.0)
            sum_w = sum_w + weight
            accept = (rs.next() * sum_w < weight) & (weight > 0.0)
            sel_pos = _select(accept, r_pos, sel_pos)
            sel_nrm = _select(accept, r_nrm, sel_nrm)
            sel_inf = _select(accept, r_inf, sel_inf)
            sel_cont = _select(accept, cont, sel_cont)
            sel_target = _select(accept, target, sel_target)

        rec_pdf = (sum_w / torch.clamp(comb_len, min=1e-30)) / torch.clamp(
            sel_target, min=1e-30)
        rec_pdf = torch.where(torch.isfinite(rec_pdf) & (sel_target > 0.0),
                              rec_pdf, 0.0)

        # the winner's shadow ray; lanes that cannot contribute (dead, or
        # no sample) skip the walk, their result is masked either way
        svec = torch.where(sel_inf[:, None], sel_pos, sel_pos - pos)
        dist = torch.linalg.vector_norm(svec, dim=-1)
        sdir = svec / torch.clamp(dist[:, None], min=1e-12)
        tmax = torch.where(sel_inf, 1e10, dist * 0.9999)
        tmax = torch.where((rec_pdf > 0.0) & alive, tmax, -1.0)
        occluded = intersect_any(bvh, scene.triangles, pos, sdir, t_min=0.0,
                                 t_max=tmax)
        vis = ~occluded & (rec_pdf > 0.0)
        aux = aux.index_add(0, torch.where(alive, cell, 0),
                            alive.to(aux.dtype))
        return torch.where(vis[:, None], sel_cont * rec_pdf[:, None],
                           0.0), aux

    return nee_fn


def render_sample_regir(scene: SceneData, bvh, camera, state: ReGIRState,
                        grid: GridInfo, width: int, height: int, sample_idx,
                        cfg=None, regir_cfg: ReGIRConfig = ReGIRConfig()):
    """One path-traced sample with ReGIR's cell reservoirs for every NEE.
    Returns (radiance [H*W, 3] in pixel order, the state with this sample's
    touch counts added), plus the ray count when cfg.count_rays. Emitters
    hit by secondary rays are not counted (use_implicit_light_sampling is
    forced off): resampled light pdfs admit no MIS weight."""
    from gfxexp_torch.render.camera import lane_from_pixel
    from gfxexp_torch.render.pathtrace import PTConfig, render_lanes

    if cfg is None:
        cfg = PTConfig()
    cfg = dataclasses.replace(cfg, use_implicit_light_sampling=False)
    out, counts = render_lanes(
        scene, bvh, camera, width, height, 0, width * height, sample_idx,
        cfg, nee_fn=make_regir_nee(state, grid, regir_cfg),
        nee_aux=torch.zeros_like(state.num_accesses))
    new_state = dataclasses.replace(
        state, num_accesses=state.num_accesses + counts)
    order = lane_from_pixel(torch.arange(width * height,
                                         device=counts.device),
                            width, height)
    if cfg.count_rays:
        contribution, nrays = out
        return contribution[order], new_state, nrays
    return out[order], new_state


def touch_cells(state: ReGIRState, cells, alive) -> ReGIRState:
    """Count one access per alive lane in its cell."""
    counts = torch.zeros_like(state.num_accesses).index_add(
        0, torch.where(alive, cells.to(torch.int64), 0),
        alive.to(state.num_accesses.dtype))
    return dataclasses.replace(state,
                               num_accesses=state.num_accesses + counts)


def finalize_frame(state: ReGIRState, frame_idx: int) -> ReGIRState:
    """Record the frame as the last access of every touched cell (the
    reference's updateLastAccessFrameIndices)."""
    touched = state.num_accesses > 0
    return dataclasses.replace(
        state, last_access=torch.where(
            touched, torch.full_like(state.last_access, int(frame_idx)),
            state.last_access))
