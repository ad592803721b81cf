"""ReSTIR DI: reservoir-based spatiotemporal resampled direct illumination
(port of gfxexp_tpu/techniques/restir_di.py).

Every pass runs over all H*W pixels at once: reservoirs are flat [N]
tensors (ReservoirSoA), the candidate stream is a Python loop, neighbour
reuse is a gather and a masked merge, and visibility is one batched
any-hit query of the scene's walk per pass. The selected light sample is
stored resolved (position, normal, emittance).

Two pipelines:
  classic: initial RIS (streaming over 2^k candidates, the winner's
    shadow ray) -> temporal reuse -> N spatial passes -> shading (a shadow
    ray per pixel);
  rearchitected: a per-frame pool of presampled lights, per-pixel RIS over
    one pool subset per 8x8 tile -> trace_shadow_rays (the new and the
    temporal sample's visibility, and the cross term of the unbiased
    estimator) -> shade_and_resample, which traces nothing -> optional
    spatial passes and shading.

The random numbers are the JAX package's, drawn in the same order from
the same streams: 0x5151 (initial RIS), 0x9135 (the pool), 0x5152 (per-pixel
RIS), pcg3d(tile, frame, 77) (a tile's subset), 0x7e39 (temporal reuse),
0x7e40 (shade_and_resample), 0x5a00 + pass (spatial reuse). Frame indices
are Python ints.

On the card two stages run as one CUDA kernel each
(csrc/restir_resample.cu) where restir_kernel_admits takes them: the
rearchitected pipeline's initial candidate stream (initial_ris_kernel,
then the any-hit walk of its shadow rays) and each biased spatial pass with
low-discrepancy neighbours (spatial_reuse_kernel). Their plain versions,
initial_ris_presampled and spatial_reuse, run every other route and every
call on the CPU; kernel and plain version agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from gfxexp_torch.accel.traverse import intersect_any, walk_library
from gfxexp_torch.core.math import (
    dot,
    length,
    make_frame,
    offset_ray_origin,
    to_local,
)
from gfxexp_torch.core.rng import SampleStream, pcg3d
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.render.bsdf import (
    BSDFParams,
    bsdf_evaluate,
    material_params_textured,
)
from gfxexp_torch.render.camera import Camera
from gfxexp_torch.render.gbuffer import GBuffer
from gfxexp_torch.scene.lights import (
    PROB_SAMPLE_ENV,
    LightSample,
    sample_env_light,
    sample_surface_light,
)
from gfxexp_torch.scene.types import SceneData
from gfxexp_torch.utils import trace

_PI = float(np.pi)


@dataclasses.dataclass(frozen=True)
class ReSTIRConfig:
    log2_num_candidates: int = 3
    enable_temporal_reuse: bool = True
    enable_spatial_reuse: bool = True
    num_spatial_passes: int = 2
    num_spatial_neighbors: int = 3
    spatial_radius: float = 20.0
    use_unbiased_estimator: bool = False
    reuse_visibility: bool = True
    use_low_discrepancy_neighbors: bool = True
    use_mis_ris: bool = True
    # the rearchitected pipeline: a pool of num_light_subsets x
    # light_subset_size presampled lights per frame, candidates from one
    # subset per 8x8 tile, visibility traced apart from shading
    use_rearchitected_pipeline: bool = False
    num_light_subsets: int = 128
    light_subset_size: int = 1024
    # rearchitected and biased only: the temporal candidate takes the
    # previous frame's selected-sample visibility instead of a shadow ray
    reuse_visibility_for_temporal: bool = False


@dataclass
class ReservoirSoA(TensorData):
    """Per-pixel reservoirs, flat [N]."""

    pos: torch.Tensor  # [N, 3] light-sample position (or env direction)
    nrm: torch.Tensor  # [N, 3]
    emit: torch.Tensor  # [N, 3]
    at_inf: torch.Tensor  # [N] bool
    sum_w: torch.Tensor  # [N]
    stream_len: torch.Tensor  # [N] float32
    rec_pdf: torch.Tensor  # [N] reciprocal pdf estimate
    target: torch.Tensor  # [N] target density of the selected sample


def empty_reservoir(n: int, device="cuda") -> ReservoirSoA:
    """Empty reservoirs on `device` (the card unless the caller asks for
    the CPU)."""
    z3 = torch.zeros((n, 3), device=device)
    z = torch.zeros((n,), device=device)
    return ReservoirSoA(
        pos=z3, nrm=z3, emit=z3,
        at_inf=torch.zeros((n,), dtype=torch.bool, device=device),
        sum_w=z, stream_len=z, rec_pdf=z, target=z)


@dataclass
class PixelCtx(TensorData):
    """Per-pixel shading context reconstructed from the G-buffer."""

    pos: torch.Tensor  # [N, 3] offset surface position
    v_out_local: torch.Tensor  # [N, 3]
    t: torch.Tensor
    b: torch.Tensor
    n: torch.Tensor
    params: BSDFParams
    valid: torch.Tensor  # [N]
    cam_dist: torch.Tensor  # [N]


@dataclass
class SampleVisibility(TensorData):
    """Shadow-ray results of the decoupled visibility pass, per pixel. The
    flags are the current frame's samples'; `selected` is written by
    shade_and_resample and read next frame under
    reuse_visibility_for_temporal."""

    new: torch.Tensor  # [N] new sample visible at the current surface
    temporal_passed: torch.Tensor  # [N] temporal neighbour test passed
    temporal: torch.Tensor  # [N] temporal sample visible at the surface
    new_on_temporal: torch.Tensor  # [N] new sample visible at the temporal
    #     neighbour's surface (the unbiased cross term)
    selected: torch.Tensor  # [N] visibility of the selected sample


def empty_sample_visibility(n: int, device="cuda") -> SampleVisibility:
    f = torch.zeros((n,), dtype=torch.bool, device=device)
    return SampleVisibility(new=f, temporal_passed=f, temporal=f,
                            new_on_temporal=f, selected=f)


def _gather(obj, idx):
    """Every tensor of a TensorData (nested ones included) indexed by
    `idx` along its first axis."""
    return dataclasses.replace(obj, **{
        f.name: (_gather(v, idx) if isinstance(v, TensorData)
                 else v[idx] if isinstance(v, torch.Tensor) else v)
        for f in dataclasses.fields(obj)
        for v in (getattr(obj, f.name),)})


def pixel_ctx(scene: SceneData, gb: GBuffer, camera: Camera) -> PixelCtx:
    h, w = gb.depth.shape
    n = h * w
    pos = gb.position.reshape(n, 3)
    gn = gb.geom_normal.reshape(n, 3)
    sn = gb.normal.reshape(n, 3)
    v_out = camera.position[None, :] - pos
    dist = length(v_out)
    v_out = v_out / torch.clamp(dist[:, None], min=1e-12)
    front = dot(v_out, gn) >= 0.0
    pos_off = offset_ray_origin(pos, torch.where(front[:, None], gn, -gn))
    t, b = make_frame(sn)
    mat = torch.clamp(gb.material.reshape(n), min=0)
    params = material_params_textured(scene.materials, scene.textures, mat,
                                      gb.texcoord.reshape(n, 2))
    return PixelCtx(pos=pos_off, v_out_local=to_local(t, b, sn, v_out), t=t,
                    b=b, n=sn, params=params, valid=gb.hit.reshape(n),
                    cam_dist=dist)


def _unshadowed_contribution(ctx: PixelCtx, ls_pos, ls_nrm, ls_emit, ls_inf):
    """Direct lighting of a light sample without visibility."""
    shadow_vec = torch.where(ls_inf[:, None], ls_pos, ls_pos - ctx.pos)
    dist2 = torch.clamp(dot(shadow_vec, shadow_vec), min=1e-12)
    sdir = shadow_vec / torch.sqrt(dist2)[:, None]
    v_in_local = to_local(ctx.t, ctx.b, ctx.n, sdir)
    lp_cos = dot(-sdir, ls_nrm)
    sp_cos = v_in_local[..., 2]
    le = ls_emit / _PI
    f = bsdf_evaluate(ctx.params, ctx.v_out_local, v_in_local)
    g = torch.where(ls_inf, torch.abs(sp_cos),
                    lp_cos * torch.abs(sp_cos) / dist2)
    cont = f * le * g[:, None]
    ok = (lp_cos > 0.0) & ctx.valid
    return torch.where(ok[:, None], cont, 0.0)


def _target_density(cont):
    """The target density: the mean of RGB."""
    return cont.mean(-1)


def _shadow_dir_dist(ctx: PixelCtx, ls_pos, ls_inf):
    vec = torch.where(ls_inf[:, None], ls_pos, ls_pos - ctx.pos)
    dist = length(vec)
    sdir = vec / torch.clamp(dist[:, None], min=1e-12)
    tmax = torch.where(ls_inf, 1e10, dist * 0.9999)
    return sdir, tmax


def _visibility(scene, bvh, ctx: PixelCtx, ls_pos, ls_inf, valid,
                ray=None):
    """Unoccluded and valid [N] bool: one any-hit query, the dead lanes
    with t_max = -1 (the walks do no work for them). `ray`: the query's
    (direction, t_max) where a kernel computed them."""
    if ray is None:
        sdir, tmax = _shadow_dir_dist(ctx, ls_pos, ls_inf)
        tmax = torch.where(valid, tmax, -1.0)
    else:
        sdir, tmax = ray
    occluded = intersect_any(bvh, scene.triangles, ctx.pos, sdir, t_min=0.0,
                             t_max=tmax)
    return ~occluded & valid


def _reservoir_update(res: ReservoirSoA, new_pos, new_nrm, new_emit, new_inf,
                      weight, u, new_target, selected_target):
    """Streaming weighted reservoir update, batched and masked. Returns
    (reservoir, selected_target, accept mask)."""
    sum_w = res.sum_w + weight
    accept = (u * sum_w < weight) & (weight > 0.0)
    a3 = accept[:, None]
    return (dataclasses.replace(
        res, pos=torch.where(a3, new_pos, res.pos),
        nrm=torch.where(a3, new_nrm, res.nrm),
        emit=torch.where(a3, new_emit, res.emit),
        at_inf=torch.where(accept, new_inf, res.at_inf), sum_w=sum_w,
        stream_len=res.stream_len + 1.0),
        torch.where(accept, new_target, selected_target), accept)


def _sample_light_stratified(scene: SceneData, u, u0, u1,
                             prob_env_strat: float) -> LightSample:
    """A candidate light sample with stratified environment allocation: the
    family is picked with prob_env_strat, the pdf uses the marginal
    PROB_SAMPLE_ENV split."""
    surface_ok = scene.total_emissive_importance > 0.0
    if scene.env is None:
        ls = sample_surface_light(scene, u, u0, u1)
        return dataclasses.replace(ls, pdf=torch.where(surface_ok, ls.pdf,
                                                       0.0))
    env_on = torch.where(scene.env.enabled, 1.0, 0.0)
    p_strat = torch.where(surface_ok, prob_env_strat, 1.0) * env_on
    p_marginal = torch.where(surface_ok, PROB_SAMPLE_ENV, 1.0) * env_on
    pick_env = u < p_strat
    u_surf = torch.clamp((u - p_strat) / torch.clamp(1.0 - p_strat,
                                                     min=1e-8),
                         0.0, 1.0 - 1e-7)
    # the environment branch draws from (u0, u1) only
    surf = sample_surface_light(scene, u_surf, u0, u1)
    envs = sample_env_light(scene, u0, u1)
    pe3 = pick_env[:, None]
    pdf = torch.where(pick_env, envs.pdf * p_marginal,
                      torch.where(surface_ok, surf.pdf * (1.0 - p_marginal),
                                  0.0))
    return LightSample(
        position=torch.where(pe3, envs.position, surf.position),
        normal=torch.where(pe3, envs.normal, surf.normal),
        emittance=torch.where(pe3, envs.emittance, surf.emittance),
        pdf=pdf, at_infinity=pick_env)


def _finish_ris(scene, bvh, ctx: PixelCtx, res: ReservoirSoA,
                selected_target, cfg: ReSTIRConfig) -> ReservoirSoA:
    """The RIS estimate of a candidate stream, killed where the winner's
    shadow ray is occluded (cfg.reuse_visibility)."""
    rec_pdf = res.sum_w / torch.clamp(selected_target * res.stream_len,
                                      min=1e-30)
    bad = ~torch.isfinite(rec_pdf) | (selected_target <= 0.0)
    res = dataclasses.replace(res, rec_pdf=torch.where(bad, 0.0, rec_pdf),
                              target=torch.where(bad, 0.0, selected_target))
    return _keep_visible(scene, bvh, ctx, res, cfg)


def _keep_visible(scene, bvh, ctx: PixelCtx, res: ReservoirSoA,
                  cfg: ReSTIRConfig, ray=None) -> ReservoirSoA:
    """The estimate killed where the selected sample's shadow ray is
    occluded (cfg.reuse_visibility; `ray` as _visibility takes it)."""
    if not cfg.reuse_visibility:
        return res
    vis = _visibility(scene, bvh, ctx, res.pos, res.at_inf,
                      ctx.valid & (res.target > 0.0), ray)
    return dataclasses.replace(res, rec_pdf=torch.where(vis, res.rec_pdf, 0.0),
                               target=torch.where(vis, res.target, 0.0))


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------


def initial_ris(scene, bvh, ctx: PixelCtx, pixel, frame_idx: int,
                cfg: ReSTIRConfig) -> ReservoirSoA:
    """Streaming RIS over 2^k candidates from the whole light set."""
    n = ctx.pos.shape[0]
    n_cand = 1 << cfg.log2_num_candidates
    rs = SampleStream(pixel, frame_idx, stream=0x5151)
    res = empty_reservoir(n, ctx.pos.device)
    selected_target = torch.zeros_like(res.sum_w)
    for i in range(n_cand):
        u_l = rs.next()
        # stratified environment allocation across the candidate stream
        prob = float(np.clip(PROB_SAMPLE_ENV * n_cand - i, 0.0, 1.0))
        u0, u1 = rs.next2()
        ls = _sample_light_stratified(scene, u_l, u0, u1, prob)
        cont = _unshadowed_contribution(ctx, ls.position, ls.normal,
                                        ls.emittance, ls.at_infinity)
        target = _target_density(cont)
        weight = torch.where(ls.pdf > 0.0,
                             target / torch.clamp(ls.pdf, min=1e-30), 0.0)
        res, selected_target, _ = _reservoir_update(
            res, ls.position, ls.normal, ls.emittance, ls.at_infinity,
            weight, rs.next(), target, selected_target)
    return _finish_ris(scene, bvh, ctx, res, selected_target, cfg)


def presample_lights(scene: SceneData, frame_idx: int, cfg: ReSTIRConfig):
    """The frame's pool of num_light_subsets x light_subset_size light
    samples, as a dict of [P, ...] tensors; rec_pdf = 1 / pdf, so a pool
    pick weighs like a sample of the whole light set."""
    n = cfg.num_light_subsets * cfg.light_subset_size
    dev = scene.triangles.p0.device
    rs = SampleStream(torch.arange(n, dtype=torch.int64, device=dev),
                      frame_idx, stream=0x9135)
    u = rs.next()
    u0, u1 = rs.next2()
    ls = _sample_light_stratified(scene, u, u0, u1, PROB_SAMPLE_ENV)
    rec_pdf = torch.where(ls.pdf > 0.0,
                          1.0 / torch.clamp(ls.pdf, min=1e-30), 0.0)
    return {"pos": ls.position, "nrm": ls.normal, "emit": ls.emittance,
            "at_inf": ls.at_infinity, "rec_pdf": rec_pdf}


def initial_ris_presampled(scene, bvh, ctx: PixelCtx, pool, gb: GBuffer,
                           pixel, frame_idx: int,
                           cfg: ReSTIRConfig) -> ReservoirSoA:
    """Initial RIS over candidates of one pool subset per 8x8 screen tile,
    the subset hashed from the tile and the frame."""
    h, w = gb.depth.shape
    n = h * w
    n_cand = 1 << cfg.log2_num_candidates
    rs = SampleStream(pixel, frame_idx, stream=0x5152)
    px = pixel.to(torch.int64) % w
    py = pixel.to(torch.int64) // w
    tile = (py // 8) * ((w + 7) // 8) + px // 8
    sub_bits, _, _ = pcg3d(tile, frame_idx, 77)
    # the hash is a uint32 held in int32 bits: reduce it unsigned
    subset = (sub_bits.to(torch.int64) & 0xFFFFFFFF) % cfg.num_light_subsets

    res = empty_reservoir(n, ctx.pos.device)
    selected_target = torch.zeros_like(res.sum_w)
    size = cfg.light_subset_size
    for _ in range(n_cand):
        u = rs.next()
        slot = subset * size + torch.clamp((u * size).to(torch.int64),
                                           max=size - 1)
        p_pos, p_nrm, p_emit = (pool["pos"][slot], pool["nrm"][slot],
                                pool["emit"][slot])
        p_inf, p_rec = pool["at_inf"][slot], pool["rec_pdf"][slot]
        target = _target_density(
            _unshadowed_contribution(ctx, p_pos, p_nrm, p_emit, p_inf))
        res, selected_target, _ = _reservoir_update(
            res, p_pos, p_nrm, p_emit, p_inf, target * p_rec, rs.next(),
            target, selected_target)
    return _finish_ris(scene, bvh, ctx, res, selected_target, cfg)


def _neighbor_ok(gb_prev_pos, gb_prev_nrm, gb_prev_hit, nb_idx, in_bounds,
                 ctx: PixelCtx, camera_pos, test_geometry: bool):
    """The neighbour test: in bounds, a hit there and here, and (biased)
    camera distances within 10% and normals within dot 0.9."""
    ok = in_bounds & gb_prev_hit[nb_idx] & ctx.valid
    if test_geometry:
        nb_dist = length(camera_pos[None, :] - gb_prev_pos[nb_idx])
        ok = ok & (torch.abs(nb_dist - ctx.cam_dist)
                   / torch.clamp(ctx.cam_dist, min=1e-6) <= 0.1) & (
            dot(ctx.n, gb_prev_nrm[nb_idx]) >= 0.9)
    return ok


def _reproject(gb: GBuffer, pixel, w: int, h: int):
    """The previous frame's pixel index through the motion vector, and
    whether it lies on screen."""
    n = w * h
    px = pixel.to(torch.int64) % w
    py = pixel.to(torch.int64) // w
    motion = gb.motion.reshape(n, 2)
    nbx = torch.floor(px.to(torch.float32) + 0.5 - motion[:, 0]).to(
        torch.int64)
    nby = torch.floor(py.to(torch.float32) + 0.5 - motion[:, 1]).to(
        torch.int64)
    in_bounds = (nbx >= 0) & (nbx < w) & (nby >= 0) & (nby < h)
    nb_idx = torch.clamp(nby, 0, h - 1) * w + torch.clamp(nbx, 0, w - 1)
    return nb_idx, in_bounds


def trace_shadow_rays(scene, bvh, ctx: PixelCtx, res: ReservoirSoA,
                      prev_res: ReservoirSoA, prev_vis: SampleVisibility,
                      prev_ctx: PixelCtx, gb: GBuffer, prev_hit,
                      prev_pos_img, prev_nrm_img, camera: Camera, pixel,
                      cfg: ReSTIRConfig):
    """The decoupled visibility pass: shadow rays for the new sample and
    the temporal neighbour's sample (and, unbiased, the new sample seen
    from the neighbour's surface). With reuse_visibility_for_temporal
    (biased only) the temporal ray is skipped and the neighbour's
    selected-sample visibility of the previous frame stands in. Returns
    (SampleVisibility, rays traced as a 0-d tensor)."""
    h, w = gb.depth.shape
    n = h * w

    new_valid = ctx.valid & (res.sum_w > 0.0)
    vis_new = _visibility(scene, bvh, ctx, res.pos, res.at_inf, new_valid)
    rays = new_valid.sum().to(torch.float32)

    nb_idx, in_bounds = _reproject(gb, pixel, w, h)
    passed = _neighbor_ok(prev_pos_img, prev_nrm_img, prev_hit, nb_idx,
                          in_bounds, ctx, camera.position,
                          test_geometry=not cfg.use_unbiased_estimator)

    t_valid = passed & (prev_res.sum_w[nb_idx] > 0.0)
    if cfg.reuse_visibility_for_temporal and not cfg.use_unbiased_estimator:
        vis_temporal = prev_vis.selected[nb_idx] & t_valid
    else:
        vis_temporal = _visibility(scene, bvh, ctx, prev_res.pos[nb_idx],
                                   prev_res.at_inf[nb_idx], t_valid)
        rays = rays + t_valid.sum().to(torch.float32)

    if cfg.use_unbiased_estimator:
        cross_valid = new_valid & passed
        vis_new_on_t = _visibility(scene, bvh, _gather(prev_ctx, nb_idx),
                                   res.pos, res.at_inf, cross_valid)
        rays = rays + cross_valid.sum().to(torch.float32)
    else:
        vis_new_on_t = torch.zeros((n,), dtype=torch.bool,
                                   device=ctx.pos.device)

    return SampleVisibility(
        new=vis_new, temporal_passed=passed, temporal=vis_temporal,
        new_on_temporal=vis_new_on_t, selected=torch.zeros_like(vis_new),
    ), rays


def _kill(res: ReservoirSoA, dead) -> ReservoirSoA:
    return dataclasses.replace(
        res, sum_w=torch.where(dead, 0.0, res.sum_w),
        stream_len=torch.where(dead, 0.0, res.stream_len),
        target=torch.where(dead, 0.0, res.target))


def _finish_reuse(res: ReservoirSoA, weight_for_estimate,
                  selected_target) -> ReservoirSoA:
    rec_pdf = weight_for_estimate * res.sum_w / torch.clamp(selected_target,
                                                            min=1e-30)
    bad = ~torch.isfinite(rec_pdf) | (selected_target <= 0.0)
    return dataclasses.replace(
        res, rec_pdf=torch.where(bad, 0.0, rec_pdf),
        target=torch.where(bad, 0.0, selected_target))


def _temporal_candidate(prev_res: ReservoirSoA, nb_idx, max_prev_len):
    return (prev_res.pos[nb_idx], prev_res.nrm[nb_idx],
            prev_res.emit[nb_idx], prev_res.at_inf[nb_idx],
            torch.minimum(prev_res.stream_len[nb_idx], max_prev_len),
            prev_res.rec_pdf[nb_idx])


def shade_and_resample(scene, res: ReservoirSoA, prev_res: ReservoirSoA,
                       vis: SampleVisibility, ctx: PixelCtx,
                       prev_ctx: PixelCtx, gb: GBuffer, pixel,
                       frame_idx: int, cfg: ReSTIRConfig):
    """Temporal resampling and shading from the SampleVisibility flags,
    without a ray: a candidate's visibility enters its target density, and
    the winner is shaded with its traced visibility. Returns (colour
    [H, W, 3], reservoir, SampleVisibility with `selected` set)."""
    h, w = gb.depth.shape
    n = h * w
    rs = SampleStream(pixel, frame_idx, stream=0x7e40)

    self_len = res.stream_len
    res0 = _kill(res, ~vis.new)
    selected_target = res0.target
    nb_idx, _ = _reproject(gb, pixel, w, h)
    accepted = vis.temporal_passed
    nb_pos, nb_nrm, nb_emit, nb_inf, nb_len, nb_rec_pdf = \
        _temporal_candidate(prev_res, nb_idx, 20.0 * self_len)

    cont = _unshadowed_contribution(ctx, nb_pos, nb_nrm, nb_emit, nb_inf)
    # the temporal candidate's target is gated by its traced (or reused)
    # visibility
    target = torch.where(vis.temporal, _target_density(cont), 0.0)
    weight = torch.where(accepted, target * nb_rec_pdf * nb_len, 0.0)
    merged, selected_target, neighbor_selected = _reservoir_update(
        res0, nb_pos, nb_nrm, nb_emit, nb_inf, weight, rs.next(), target,
        selected_target)
    merged = dataclasses.replace(
        merged, stream_len=self_len + torch.where(accepted, nb_len, 0.0))

    if cfg.use_unbiased_estimator:
        cont_self = _unshadowed_contribution(ctx, merged.pos, merged.nrm,
                                             merged.emit, merged.at_inf)
        sel_vis_cur = torch.where(neighbor_selected, vis.temporal, vis.new)
        td_self = torch.where(sel_vis_cur, _target_density(cont_self), 0.0)
        if cfg.use_mis_ris:
            num_w = torch.where(neighbor_selected, 0.0, td_self)
            den_w = td_self * self_len
        else:
            num_w = torch.ones((n,), device=ctx.pos.device)
            den_w = torch.where(td_self > 0.0, self_len, 0.0)
        cont_nb = _unshadowed_contribution(_gather(prev_ctx, nb_idx),
                                           merged.pos, merged.nrm,
                                           merged.emit, merged.at_inf)
        # the survivor's visibility at the neighbour's surface: the
        # temporal sample was visible there iff it was selected there; the
        # new sample's cross visibility was traced
        sel_vis_nb = torch.where(neighbor_selected, vis.temporal,
                                 vis.new_on_temporal)
        td_nb = torch.where(accepted & sel_vis_nb, _target_density(cont_nb),
                            0.0)
        if cfg.use_mis_ris:
            den_w = den_w + td_nb * torch.where(accepted, nb_len, 0.0)
            num_w = torch.where(neighbor_selected, td_nb, num_w)
        else:
            den_w = den_w + torch.where(accepted & (td_nb > 0.0), nb_len,
                                        0.0)
        weight_for_estimate = num_w / torch.clamp(den_w, min=1e-30)
    else:
        weight_for_estimate = 1.0 / torch.clamp(merged.stream_len,
                                                min=1e-30)
    merged = _finish_reuse(merged, weight_for_estimate, selected_target)

    # the selected sample's visibility is known from the flags: no ray
    sel_vis = torch.where(neighbor_selected, vis.temporal, vis.new)
    cont_sel = _unshadowed_contribution(ctx, merged.pos, merged.nrm,
                                        merged.emit, merged.at_inf)
    use = ctx.valid & (merged.rec_pdf > 0.0) & sel_vis
    color = _direct_emission(ctx, gb) + torch.where(
        use[:, None], cont_sel * merged.rec_pdf[:, None], 0.0)
    return (color.reshape(h, w, 3), merged,
            dataclasses.replace(vis, selected=sel_vis))


def temporal_reuse(scene, res: ReservoirSoA, prev_res: ReservoirSoA,
                   ctx: PixelCtx, prev_ctx: PixelCtx, gb: GBuffer, prev_hit,
                   prev_pos_img, prev_nrm_img, camera: Camera, pixel,
                   frame_idx: int, cfg: ReSTIRConfig) -> ReservoirSoA:
    """Merge the reprojected previous reservoir, its stream length clamped
    to 20x the current one's."""
    h, w = gb.depth.shape
    n = h * w
    rs = SampleStream(pixel, frame_idx, stream=0x7e39)

    self_len = res.stream_len
    # a killed sample must not propagate
    res = _kill(res, res.rec_pdf == 0.0)
    selected_target = res.target

    nb_idx, in_bounds = _reproject(gb, pixel, w, h)
    accepted = _neighbor_ok(prev_pos_img, prev_nrm_img, prev_hit, nb_idx,
                            in_bounds, ctx, camera.position,
                            test_geometry=not cfg.use_unbiased_estimator)
    nb_pos, nb_nrm, nb_emit, nb_inf, nb_len, nb_rec_pdf = \
        _temporal_candidate(prev_res, nb_idx, 20.0 * self_len)

    target = _target_density(
        _unshadowed_contribution(ctx, nb_pos, nb_nrm, nb_emit, nb_inf))
    weight = torch.where(accepted, target * nb_rec_pdf * nb_len, 0.0)
    res, selected_target, neighbor_selected = _reservoir_update(
        res, nb_pos, nb_nrm, nb_emit, nb_inf, weight, rs.next(), target,
        selected_target)
    res = dataclasses.replace(
        res, stream_len=self_len + torch.where(accepted, nb_len, 0.0))

    if cfg.use_unbiased_estimator:
        # the survivor's target here and at the neighbour's previous
        # surface
        td_self = _target_density(_unshadowed_contribution(
            ctx, res.pos, res.nrm, res.emit, res.at_inf))
        if cfg.use_mis_ris:
            num_w = torch.where(neighbor_selected, 0.0, td_self)
            den_w = td_self * self_len
        else:
            num_w = torch.ones((n,), device=ctx.pos.device)
            den_w = torch.where(td_self > 0.0, self_len, 0.0)
        cont_nb = _unshadowed_contribution(_gather(prev_ctx, nb_idx),
                                           res.pos, res.nrm, res.emit,
                                           res.at_inf)
        td_nb = torch.where(accepted, _target_density(cont_nb), 0.0)
        if cfg.use_mis_ris:
            den_w = den_w + td_nb * torch.where(accepted, nb_len, 0.0)
            num_w = torch.where(neighbor_selected, td_nb, num_w)
        else:
            den_w = den_w + torch.where(accepted & (td_nb > 0.0), nb_len,
                                        0.0)
        weight_for_estimate = num_w / torch.clamp(den_w, min=1e-30)
    else:
        weight_for_estimate = 1.0 / torch.clamp(res.stream_len, min=1e-30)
    return _finish_reuse(res, weight_for_estimate, selected_target)


def _r2_disk_deltas(count: int = 1024) -> np.ndarray:
    """Low-discrepancy (R2) offsets in the unit disk, [count, 2] float32."""
    g = 1.32471795724474602596
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    i = np.arange(count)
    u = (0.5 + a1 * i) % 1.0
    v = (0.5 + a2 * i) % 1.0
    r = np.sqrt(u)
    th = 2 * np.pi * v
    return np.stack([r * np.cos(th), r * np.sin(th)],
                    axis=-1).astype(np.float32)


_SPATIAL_DELTAS = _r2_disk_deltas()


def _spatial_table_index(frame_idx: int, pass_idx: int, k: int,
                         cfg: ReSTIRConfig) -> int:
    """Neighbour k's entry of _SPATIAL_DELTAS: a frame-varying base index
    into the table."""
    return (frame_idx * (cfg.num_spatial_passes * cfg.num_spatial_neighbors)
            + pass_idx * cfg.num_spatial_neighbors + k) % 1024


def spatial_reuse(scene, bvh, res: ReservoirSoA, ctx: PixelCtx, gb: GBuffer,
                  camera: Camera, pixel, frame_idx: int, pass_idx: int,
                  cfg: ReSTIRConfig) -> ReservoirSoA:
    """One spatial reuse pass over cfg.num_spatial_neighbors neighbours in
    a disk of cfg.spatial_radius pixels."""
    h, w = gb.depth.shape
    n = h * w
    dev = ctx.pos.device
    rs = SampleStream(pixel, frame_idx, stream=0x5a00 + pass_idx)
    px = pixel.to(torch.int64) % w
    py = pixel.to(torch.int64) // w
    hit_img = gb.hit.reshape(n)
    pos_img = gb.position.reshape(n, 3)
    nrm_img = gb.normal.reshape(n, 3)

    keep_self = res.rec_pdf > 0.0
    combined = dataclasses.replace(
        empty_reservoir(n, dev), pos=res.pos, nrm=res.nrm, emit=res.emit,
        at_inf=res.at_inf, sum_w=torch.where(keep_self, res.sum_w, 0.0),
        stream_len=torch.where(keep_self, res.stream_len, 0.0))
    selected_target = torch.where(keep_self, res.target, 0.0)
    self_len = res.stream_len
    combined_len = self_len
    selected_nb = torch.full((n,), -1, dtype=torch.int32, device=dev)

    nb_indices = []
    nb_accepts = []
    for k in range(cfg.num_spatial_neighbors):
        if cfg.use_low_discrepancy_neighbors:
            delta = _SPATIAL_DELTAS[_spatial_table_index(frame_idx, pass_idx,
                                                         k, cfg)]
            dx = torch.full((n,), float(delta[0]), device=dev) \
                * cfg.spatial_radius
            dy = torch.full((n,), float(delta[1]), device=dev) \
                * cfg.spatial_radius
        else:
            r = cfg.spatial_radius * torch.sqrt(rs.next())
            ang = 2.0 * _PI * rs.next()
            dx = r * torch.cos(ang)
            dy = r * torch.sin(ang)
        nbx = torch.floor(px.to(torch.float32) + 0.5 + dx).to(torch.int64)
        nby = torch.floor(py.to(torch.float32) + 0.5 + dy).to(torch.int64)
        in_bounds = (nbx >= 0) & (nbx < w) & (nby >= 0) & (nby < h)
        not_self = (nbx != px) | (nby != py)
        nb_idx = torch.clamp(nby, 0, h - 1) * w + torch.clamp(nbx, 0, w - 1)
        accepted = _neighbor_ok(pos_img, nrm_img, hit_img, nb_idx,
                                in_bounds & not_self, ctx, camera.position,
                                test_geometry=not cfg.use_unbiased_estimator)
        nb_indices.append(nb_idx)
        nb_accepts.append(accepted)

        nb_len = res.stream_len[nb_idx]
        nb_pos, nb_nrm, nb_emit, nb_inf = (res.pos[nb_idx], res.nrm[nb_idx],
                                           res.emit[nb_idx],
                                           res.at_inf[nb_idx])
        target = _target_density(
            _unshadowed_contribution(ctx, nb_pos, nb_nrm, nb_emit, nb_inf))
        weight = torch.where(accepted,
                             target * res.rec_pdf[nb_idx] * nb_len, 0.0)
        combined, selected_target, took = _reservoir_update(
            combined, nb_pos, nb_nrm, nb_emit, nb_inf, weight, rs.next(),
            target, selected_target)
        selected_nb = torch.where(took, k, selected_nb)
        combined_len = combined_len + torch.where(accepted, nb_len, 0.0)

    combined = dataclasses.replace(combined, stream_len=combined_len)

    if cfg.use_unbiased_estimator:
        td_self = _target_density(_unshadowed_contribution(
            ctx, combined.pos, combined.nrm, combined.emit, combined.at_inf))
        if cfg.reuse_visibility:
            vis_self = _visibility(scene, bvh, ctx, combined.pos,
                                   combined.at_inf, ctx.valid)
            td_self = torch.where(vis_self, td_self, 0.0)
        if cfg.use_mis_ris:
            num_w = torch.where(selected_nb >= 0, 0.0, td_self)
            den_w = td_self * self_len
        else:
            num_w = torch.ones((n,), device=dev)
            den_w = torch.where(td_self > 0.0, self_len, 0.0)
        for k in range(cfg.num_spatial_neighbors):
            nb_idx = nb_indices[k]
            accepted = nb_accepts[k]
            nb_ctx = _gather(ctx, nb_idx)
            td_nb = torch.where(accepted, _target_density(
                _unshadowed_contribution(nb_ctx, combined.pos, combined.nrm,
                                         combined.emit, combined.at_inf)),
                0.0)
            if cfg.reuse_visibility:
                vis_nb = _visibility(scene, bvh, nb_ctx, combined.pos,
                                     combined.at_inf,
                                     accepted & (td_nb > 0))
                td_nb = torch.where(vis_nb, td_nb, 0.0)
            nb_len = res.stream_len[nb_idx]
            if cfg.use_mis_ris:
                den_w = den_w + td_nb * torch.where(accepted, nb_len, 0.0)
                num_w = torch.where(selected_nb == k, td_nb, num_w)
            else:
                den_w = den_w + torch.where(accepted & (td_nb > 0.0),
                                            nb_len, 0.0)
        weight_for_estimate = num_w / torch.clamp(den_w, min=1e-30)
        if cfg.reuse_visibility:
            weight_for_estimate = torch.where(td_self > 0.0,
                                              weight_for_estimate, 0.0)
    else:
        weight_for_estimate = 1.0 / torch.clamp(combined.stream_len,
                                                min=1e-30)
    return _finish_reuse(combined, weight_for_estimate, selected_target)


# ---------------------------------------------------------------------------
# the card's resampling kernels (csrc/restir_resample.cu)
# ---------------------------------------------------------------------------

# the most neighbours the spatial kernel takes (restir_resample.cu
# kMaxNeighbors)
_MAX_KERNEL_NEIGHBORS = 32


def restir_kernel_admits(cfg: ReSTIRConfig, x: torch.Tensor):
    """(initial, spatial): whether restir_di_frame runs its initial
    candidate stream, and each spatial pass, as one CUDA kernel
    (csrc/restir_resample.cu) rather than by its plain version. Both need
    `x`, any tensor of the frame, on a CUDA device. The initial kernel is
    the rearchitected pipeline's stream over the presampled pool (the
    classic initial_ris samples the whole light set itself). The spatial
    kernel takes a biased pass over at most 32 low-discrepancy neighbours:
    the unbiased pass traces a visibility walk per neighbour between its
    steps. It reads the configuration and the device only."""
    cuda = x.device.type == "cuda"
    return (cuda and cfg.use_rearchitected_pipeline,
            cuda and not cfg.use_unbiased_estimator
            and cfg.use_low_discrepancy_neighbors
            and cfg.num_spatial_neighbors <= _MAX_KERNEL_NEIGHBORS)


_CTX_PTRS = ("pos", "v_out", "t", "b", "nrm", "diffuse", "f0", "rough",
             "lambert", "valid")
# ReservoirSoA's fields and the kernels' names for them
_RES_PTRS = {"pos": "pos", "nrm": "nrm", "emit": "emit", "at_inf": "inf",
             "sum_w": "sum_w", "stream_len": "len", "rec_pdf": "rec",
             "target": "target"}


class _InitialArgs(ctypes.Structure):
    """restir_resample.cu's InitialArgs."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "n", "w", "frame", "num_subsets", "subset_size", "n_cand")]
        + [("mean_scale", ctypes.c_float)]
        + [(f, ctypes.c_void_p) for f in (
            *_CTX_PTRS, "pool_pos", "pool_nrm", "pool_emit", "pool_inf",
            "pool_rec", *(f"r_{k}" for k in _RES_PTRS.values()),
            "shadow_d", "shadow_tmax")])


class _SpatialArgs(ctypes.Structure):
    """restir_resample.cu's SpatialArgs."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "n", "w", "h", "frame", "pass", "n_nb")]
        + [("mean_scale", ctypes.c_float),
           ("dx", ctypes.c_float * _MAX_KERNEL_NEIGHBORS),
           ("dy", ctypes.c_float * _MAX_KERNEL_NEIGHBORS)]
        + [(f, ctypes.c_void_p) for f in (
            *_CTX_PTRS, "cam_dist", "cam_pos", "gb_hit", "gb_pos", "gb_nrm",
            *(f"in_{k}" for k in _RES_PTRS.values()),
            *(f"r_{k}" for k in _RES_PTRS.values()))])


def _mean_scale(n: int) -> float:
    """The factor of PyTorch's CUDA mean over the last axis of an [n, 3]
    tensor: n / (3 n), each rounded to float32 first."""
    return float(np.float32(n) / np.float32(3 * max(n, 1)))


def _ctx_args(ctx: PixelCtx, n: int) -> dict:
    f32, b8 = torch.float32, torch.bool
    p = ctx.params
    return dict(zip(_CTX_PTRS, (
        (ctx.pos, f32, (n, 3)), (ctx.v_out_local, f32, (n, 3)),
        (ctx.t, f32, (n, 3)), (ctx.b, f32, (n, 3)), (ctx.n, f32, (n, 3)),
        (p.diffuse, f32, (n, 3)), (p.f0, f32, (n, 3)),
        (p.roughness, f32, (n,)), (p.is_lambert, b8, (n,)),
        (ctx.valid, b8, (n,)))))


def _res_args(prefix: str, res: ReservoirSoA, n: int) -> dict:
    return {f"{prefix}{c}": (getattr(res, k),
                             torch.bool if k == "at_inf" else torch.float32,
                             (n, 3) if k in ("pos", "nrm", "emit") else (n,))
            for k, c in _RES_PTRS.items()}


def _empty_like_res(n: int, dev) -> ReservoirSoA:
    """Uninitialised reservoirs, a kernel's output."""
    e3 = [torch.empty((n, 3), device=dev) for _ in range(3)]
    e = [torch.empty((n,), device=dev) for _ in range(4)]
    return ReservoirSoA(pos=e3[0], nrm=e3[1], emit=e3[2],
                        at_inf=torch.empty((n,), dtype=torch.bool,
                                           device=dev),
                        sum_w=e[0], stream_len=e[1], rec_pdf=e[2],
                        target=e[3])


def _launch(kernel: str, args_type, fields: dict, tensors: dict, dev):
    """Launch restir_resample.cu's `kernel` (counter
    restir.kernel.<kernel>): build.launch on a CUDA device, else raise."""
    from gfxexp_torch.csrc.build import launch

    if dev.type != "cuda":
        raise ValueError(f"restir_{kernel}: runs on CUDA tensors, got {dev}")
    launch("restir_resample", f"restir_{kernel}", args_type, fields, tensors,
           dev)
    trace.count(f"restir.kernel.{kernel}")


def initial_ris_kernel(scene, bvh, ctx: PixelCtx, pool, gb: GBuffer,
                       frame_idx: int, cfg: ReSTIRConfig) -> ReservoirSoA:
    """initial_ris_presampled for the pixels 0 .. N - 1 of `gb` in order,
    on the card: the candidate stream and its estimate in one kernel
    launch, then (cfg.reuse_visibility) the any-hit walk of the shadow rays
    the kernel wrote and the mask of _finish_ris. Raises on a tensor the
    kernel does not take; nothing falls back."""
    from gfxexp_torch.csrc.build import int32_bits

    h, w = gb.depth.shape
    n = h * w
    dev = ctx.pos.device
    f32 = torch.float32
    res = _empty_like_res(n, dev)
    ray = ((torch.empty((n, 3), device=dev), torch.empty((n,), device=dev))
           if cfg.reuse_visibility else (None, None))
    p = cfg.num_light_subsets * cfg.light_subset_size
    inputs = {
        **_ctx_args(ctx, n),
        "pool_pos": (pool["pos"], f32, (p, 3)),
        "pool_nrm": (pool["nrm"], f32, (p, 3)),
        "pool_emit": (pool["emit"], f32, (p, 3)),
        "pool_inf": (pool["at_inf"], torch.bool, (p,)),
        "pool_rec": (pool["rec_pdf"], f32, (p,)),
        **_res_args("r_", res, n),
        "shadow_d": (ray[0], f32, (n, 3)), "shadow_tmax": (ray[1], f32, (n,))}
    _launch("initial", _InitialArgs, dict(
        n=n, w=w, frame=int32_bits(frame_idx),
        num_subsets=cfg.num_light_subsets, subset_size=cfg.light_subset_size,
        n_cand=1 << cfg.log2_num_candidates, mean_scale=_mean_scale(n)),
        inputs, dev)
    return _keep_visible(scene, bvh, ctx, res, cfg, ray)


def spatial_reuse_kernel(res: ReservoirSoA, ctx: PixelCtx, gb: GBuffer,
                         camera: Camera, frame_idx: int, pass_idx: int,
                         cfg: ReSTIRConfig) -> ReservoirSoA:
    """spatial_reuse for the pixels 0 .. N - 1 of `gb` in order, biased,
    with low-discrepancy neighbours, on the card in one kernel launch: new
    reservoirs, `res` untouched. Raises on a tensor or a configuration the
    kernel does not take; nothing falls back."""
    from gfxexp_torch.csrc.build import int32_bits

    if not restir_kernel_admits(cfg, ctx.pos)[1]:
        raise ValueError("restir_spatial: the kernel takes a biased pass "
                         "over at most 32 low-discrepancy neighbours on "
                         "the card")
    h, w = gb.depth.shape
    n = h * w
    dev = ctx.pos.device
    f32 = torch.float32
    k = cfg.num_spatial_neighbors
    dx = (ctypes.c_float * _MAX_KERNEL_NEIGHBORS)()
    dy = (ctypes.c_float * _MAX_KERNEL_NEIGHBORS)()
    for j in range(k):
        # spatial_reuse's offset: the table's float32 entry times the
        # radius, in float32
        delta = _SPATIAL_DELTAS[_spatial_table_index(frame_idx, pass_idx, j,
                                                     cfg)]
        radius = np.float32(cfg.spatial_radius)
        dx[j], dy[j] = float(delta[0] * radius), float(delta[1] * radius)
    out = _empty_like_res(n, dev)
    inputs = {
        **_ctx_args(ctx, n), "cam_dist": (ctx.cam_dist, f32, (n,)),
        "cam_pos": (camera.position, f32, (3,)),
        "gb_hit": (gb.hit.reshape(n), torch.bool, (n,)),
        "gb_pos": (gb.position.reshape(n, 3), f32, (n, 3)),
        "gb_nrm": (gb.normal.reshape(n, 3), f32, (n, 3)),
        **_res_args("in_", res, n), **_res_args("r_", out, n)}
    _launch("spatial", _SpatialArgs, {
        "n": n, "w": w, "h": h, "frame": int32_bits(frame_idx),
        "pass": pass_idx, "n_nb": k, "mean_scale": _mean_scale(n),
        "dx": dx, "dy": dy}, inputs, dev)
    return out


def _direct_emission(ctx: PixelCtx, gb: GBuffer):
    """Emitters seen directly: emittance / pi on their front side."""
    emit = gb.emittance.reshape(-1, 3)
    return torch.where((ctx.valid & (ctx.v_out_local[:, 2] > 0))[:, None],
                       emit / _PI, 0.0)


def shade(scene, bvh, res: ReservoirSoA, ctx: PixelCtx, gb: GBuffer):
    """Final shading: emitters seen directly plus the selected light sample
    weighted by its reciprocal pdf, behind one shadow ray."""
    h, w = gb.depth.shape
    cont = _unshadowed_contribution(ctx, res.pos, res.nrm, res.emit,
                                    res.at_inf)
    use = ctx.valid & (res.rec_pdf > 0.0)
    vis = _visibility(scene, bvh, ctx, res.pos, res.at_inf, use)
    color = _direct_emission(ctx, gb) + torch.where(
        vis[:, None], cont * res.rec_pdf[:, None], 0.0)
    return color.reshape(h, w, 3)


def restir_di_frame(scene: SceneData, bvh, gb: GBuffer, camera: Camera,
                    prev_reservoir: ReservoirSoA, prev_ctx: PixelCtx,
                    prev_hit, prev_pos, prev_nrm, frame_idx: int,
                    cfg: ReSTIRConfig = ReSTIRConfig(),
                    prev_vis: SampleVisibility = None):
    """One ReSTIR DI frame on the device that holds `scene`. Returns
    (colour [H, W, 3], reservoir, ctx, SampleVisibility): carry all four
    into the next frame (the visibility matters only for the rearchitected
    pipeline's reuse_visibility_for_temporal).

    The initial stream and the spatial passes run as CUDA kernels where
    restir_kernel_admits(cfg, gb.depth) takes them (counters
    restir.kernel.initial and restir.kernel.spatial, one a launch), else by
    their plain versions (restir.eager.initial, restir.eager.spatial, one
    a pass on the card). Both give the same frame."""
    with trace.span("gfx.restir"):
        h, w = gb.depth.shape
        n = h * w
        dev = gb.depth.device
        frame_idx = int(frame_idx)
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        kernel = restir_kernel_admits(cfg, gb.depth)
        if any(kernel):
            # the resampling kernels and the walk build at once at first use
            from gfxexp_torch.csrc.build import load_libraries

            load_libraries(["restir_resample"]
                           + [x for x in (walk_library(bvh),) if x])
        ctx = pixel_ctx(scene, gb, camera)
        if prev_vis is None:
            prev_vis = empty_sample_visibility(n, dev)

        def spatial(res):
            for p in range(cfg.num_spatial_passes):
                with trace.span(f"gfx.restir.spatial{p}"):
                    if kernel[1]:
                        res = spatial_reuse_kernel(res, ctx, gb, camera,
                                                   frame_idx, p, cfg)
                    else:
                        _count_eager(dev, "spatial")
                        res = spatial_reuse(scene, bvh, res, ctx, gb, camera,
                                            pixel, frame_idx, p, cfg)
            return res

        if cfg.use_rearchitected_pipeline:
            with trace.span("gfx.restir.presample"):
                pool = presample_lights(scene, frame_idx, cfg)
            with trace.span("gfx.restir.initial"):
                if kernel[0]:
                    res = initial_ris_kernel(scene, bvh, ctx, pool, gb,
                                             frame_idx, cfg)
                else:
                    _count_eager(dev, "initial")
                    res = initial_ris_presampled(scene, bvh, ctx, pool, gb,
                                                 pixel, frame_idx, cfg)
            if cfg.enable_temporal_reuse:
                with trace.span("gfx.restir.shadow"):
                    vis, _ = trace_shadow_rays(
                        scene, bvh, ctx, res, prev_reservoir, prev_vis,
                        prev_ctx, gb, prev_hit, prev_pos, prev_nrm, camera,
                        pixel, cfg)
                with trace.span("gfx.restir.resample"):
                    color, res, vis = shade_and_resample(
                        scene, res, prev_reservoir, vis, ctx, prev_ctx, gb,
                        pixel, frame_idx, cfg)
                if cfg.enable_spatial_reuse:
                    res = spatial(res)
                    with trace.span("gfx.restir.shade"):
                        color = shade(scene, bvh, res, ctx, gb)
                return color, res, ctx, vis
        else:
            with trace.span("gfx.restir.initial"):
                _count_eager(dev, "initial")
                res = initial_ris(scene, bvh, ctx, pixel, frame_idx, cfg)
            if cfg.enable_temporal_reuse:
                with trace.span("gfx.restir.temporal"):
                    res = temporal_reuse(scene, res, prev_reservoir, ctx,
                                         prev_ctx, gb, prev_hit, prev_pos,
                                         prev_nrm, camera, pixel, frame_idx,
                                         cfg)
        if cfg.enable_spatial_reuse:
            res = spatial(res)
        with trace.span("gfx.restir.shade"):
            color = shade(scene, bvh, res, ctx, gb)
        return color, res, ctx, empty_sample_visibility(n, dev)


def _count_eager(dev, stage: str):
    """Count a stage's plain pass on the card (restir.eager.<stage>)."""
    if dev.type == "cuda":
        trace.count(f"restir.eager.{stage}")
