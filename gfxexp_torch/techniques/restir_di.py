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
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from gfxexp_torch.accel.traverse import intersect_any
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


def _visibility(scene, bvh, ctx: PixelCtx, ls_pos, ls_inf, valid):
    """Unoccluded and valid [N] bool: one any-hit query, the dead lanes
    with t_max = -1 (the walks do no work for them)."""
    sdir, tmax = _shadow_dir_dist(ctx, ls_pos, ls_inf)
    tmax = torch.where(valid, tmax, -1.0)
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
    rec_pdf = torch.where(bad, 0.0, rec_pdf)
    selected_target = torch.where(bad, 0.0, selected_target)
    if cfg.reuse_visibility:
        vis = _visibility(scene, bvh, ctx, res.pos, res.at_inf,
                          ctx.valid & (selected_target > 0.0))
        rec_pdf = torch.where(vis, rec_pdf, 0.0)
        selected_target = torch.where(vis, selected_target, 0.0)
    return dataclasses.replace(res, rec_pdf=rec_pdf, target=selected_target)


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
            # a frame-varying base index into the table
            tbl = (frame_idx * (cfg.num_spatial_passes
                                * cfg.num_spatial_neighbors)
                   + pass_idx * cfg.num_spatial_neighbors + k) % 1024
            delta = _SPATIAL_DELTAS[tbl]
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
    pipeline's reuse_visibility_for_temporal)."""
    with trace.span("gfx.restir"):
        h, w = gb.depth.shape
        n = h * w
        dev = gb.depth.device
        frame_idx = int(frame_idx)
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        ctx = pixel_ctx(scene, gb, camera)
        if prev_vis is None:
            prev_vis = empty_sample_visibility(n, dev)

        if cfg.use_rearchitected_pipeline:
            with trace.span("gfx.restir.presample"):
                pool = presample_lights(scene, frame_idx, cfg)
            with trace.span("gfx.restir.initial"):
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
                    for p in range(cfg.num_spatial_passes):
                        with trace.span(f"gfx.restir.spatial{p}"):
                            res = spatial_reuse(scene, bvh, res, ctx, gb,
                                                camera, pixel, frame_idx, p,
                                                cfg)
                    with trace.span("gfx.restir.shade"):
                        color = shade(scene, bvh, res, ctx, gb)
                return color, res, ctx, vis
        else:
            with trace.span("gfx.restir.initial"):
                res = initial_ris(scene, bvh, ctx, pixel, frame_idx, cfg)
            if cfg.enable_temporal_reuse:
                with trace.span("gfx.restir.temporal"):
                    res = temporal_reuse(scene, res, prev_reservoir, ctx,
                                         prev_ctx, gb, prev_hit, prev_pos,
                                         prev_nrm, camera, pixel, frame_idx,
                                         cfg)
        if cfg.enable_spatial_reuse:
            for p in range(cfg.num_spatial_passes):
                with trace.span(f"gfx.restir.spatial{p}"):
                    res = spatial_reuse(scene, bvh, res, ctx, gb, camera,
                                        pixel, frame_idx, p, cfg)
        with trace.span("gfx.restir.shade"):
            color = shade(scene, bvh, res, ctx, gb)
        return color, res, ctx, empty_sample_visibility(n, dev)
