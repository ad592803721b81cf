"""NRC-integrated wavefront path tracer: rendering paths that end in the
radiance cache, and self-training suffixes (port of
gfxexp_tpu/techniques/nrc/cache.py).

The reference's NRC renderer: a radiance query per vertex (AABB-normalised
position, polar normal and direction, roughness 1 - exp(-r), the
reflectances); the primary spread d^2 / (4 pi |cos|) and the accumulated
spread sqrt(d^2 / (pdf |cos|)); a path ends in the cache once spread^2 >
0.01 x the primary spread; one training path per tile of `train_stride`
lanes, every `unbiased_fraction`-th of them unbiased (its suffix never
reads the cache); per-vertex targets start with the NEE radiance, and an
emitter hit adds to the previous vertex's target; Russian roulette spares
training paths of length <= 2; reflectance factorisation; targets
propagate backward from the suffix's cache prediction.

The training lanes of a sample are a fixed stride of the lanes (the lane
of each tile rotates with the sample index, a Python int), so their
records live in dense [n_train, max_len] tensors indexed by the strided
slice of the lanes: the JAX package's scatters of unused lanes to an
out-of-range row (mode="drop") become masked writes to the training rows,
with no out-of-range index at all. A lane whose tile index reaches n_train
(when the lane count is not a multiple of the stride) trains nowhere, as
JAX's dropped scatter has it. Lanes that are dead skip the walks (t_max <
0): every use of their hit is masked.

Tracing (utils/trace.py): render_sample_nrc is span `gfx.nrc`, with the
stages `.setup`, `.bounce<b>`, `.query` (the queries inferred), `.infer`
(the cache's MLP read with the EMA weights) and `.propagate` (the
targets); it counts the rows inferred (`nrc.queries`) from their shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gfxexp_torch.accel.traverse import intersect_closest
from gfxexp_torch.core.math import (
    dot,
    luminance,
    make_frame,
    normalize,
    offset_ray_origin,
    to_local,
    to_world,
)
from gfxexp_torch.core.rng import SampleStream
from gfxexp_torch.render.bsdf import bsdf_sample, material_params_textured
from gfxexp_torch.render.camera import (
    generate_rays_for_lanes,
    lane_from_pixel,
    pixel_from_lane,
)
from gfxexp_torch.render.pathtrace import (
    PTConfig,
    _next_event,
    compute_surface_point,
    pack_tri_attrs,
)
from gfxexp_torch.scene.lights import (
    env_pdf,
    env_radiance,
    light_selection_probs,
    pack_light_rows,
    surface_light_pdf,
)
from gfxexp_torch.scene.types import world_bounds
from gfxexp_torch.techniques.nrc.network import NRCConfig
from gfxexp_torch.techniques.nrc.network import apply as nrc_apply
from gfxexp_torch.utils import trace

_PI = float(np.pi)
PATH_TERMINATION_FACTOR = 0.01  # the reference's pathTerminationFactor


@dataclasses.dataclass(frozen=True)
class NRCIntegratorConfig:
    max_path_length: int = 5
    train_stride: int = 16  # one training path per this many lanes
    unbiased_fraction: int = 16  # every Nth training path is unbiased
    enable_jitter: bool = True
    use_reflectance_factorization: bool = True
    radiance_scale: float = 1.0


def scene_aabb(scene):
    """The scene's world-space triangle AABB (host-side, once): (lo [3],
    hi [3]) on the scene's device. A two-level scene is bounded in world
    space too (JAX's scene_aabb bounds its object-space BLAS triangles)."""
    lo, hi = world_bounds(scene)
    dev = scene.triangles.p0.device
    return (torch.from_numpy(lo.astype(np.float32)).to(dev),
            torch.from_numpy(hi.astype(np.float32)).to(dev))


def _to_polar(v):
    """Direction -> (phi, theta) in [0, 1]^2 (the reference's
    convertToPolar); phi wraps with a floor modulo, as jnp's % does."""
    theta = torch.arccos(torch.clamp(v[..., 1], -1.0, 1.0)) / _PI
    phi = torch.remainder(torch.atan2(v[..., 2], v[..., 0]) / (2.0 * _PI),
                          1.0)
    return phi, theta


def make_query(aabb_lo, aabb_hi, position, normal, v_out, params):
    """RadianceQuery [N, 14] (the reference's createRadianceQuery)."""
    p = (position - aabb_lo) / torch.clamp(aabb_hi - aabb_lo, min=1e-6)
    n_phi, n_theta = _to_polar(normal)
    d_phi, d_theta = _to_polar(v_out)
    rough = 1.0 - torch.exp(-params.roughness)
    return torch.cat([torch.clamp(p, 0.0, 1.0), d_phi[:, None],
                      d_theta[:, None], n_phi[:, None], n_theta[:, None],
                      rough[:, None], params.diffuse, params.f0], dim=-1)


def _query_ref_factor(query):
    """Diffuse plus specular reflectance of stored queries [..., 14]."""
    return query[..., 8:11] + query[..., 11:14]


def propagate_targets(t_target, t_thru, t_valid, suffix_pred,
                      suffix_has_query):
    """Backward radiance propagation along the training suffixes (the
    reference's propagateRadianceValues): a vertex's target is its direct
    radiance plus its local throughput times the next recorded vertex's
    target; the chain starts from the cache's prediction at the suffix's
    end (zero where the suffix never ended in the cache).

    t_target, t_thru: [n_train, L, 3]; t_valid: [n_train, L];
    suffix_pred: [n_train, 3]; suffix_has_query: [n_train]."""
    L = t_target.shape[1]
    carry = torch.where(suffix_has_query[:, None], suffix_pred, 0.0)
    targets = t_target.clone()
    for depth in range(L - 1, -1, -1):
        valid_d = t_valid[:, depth][:, None]
        new_carry = targets[:, depth] + t_thru[:, depth] * carry
        carry = torch.where(valid_d, new_carry, carry)
        targets[:, depth] = torch.where(valid_d, new_carry, targets[:, depth])
    return targets


def render_sample_nrc(scene, bvh, camera, nrc_params, aabb_lo, aabb_hi,
                      width: int, height: int, sample_idx,
                      cfg: NRCIntegratorConfig = NRCIntegratorConfig(),
                      nrc_cfg: NRCConfig = NRCConfig()):
    """One NRC sample, reading the cache with `nrc_params` (the EMA
    weights). Returns (radiance [H*W, 3] in pixel order, train_query
    [T, 14], train_target [T, 3], train_mask [T]) with T = n_train x
    max_path_length, n_train = H*W // train_stride."""
    with trace.span("gfx.nrc"):
        return _render_sample_nrc(scene, bvh, camera, nrc_params, aabb_lo,
                                  aabb_hi, width, height, sample_idx, cfg,
                                  nrc_cfg)


def _render_sample_nrc(scene, bvh, camera, nrc_params, aabb_lo, aabb_hi,
                       width, height, sample_idx, cfg, nrc_cfg):
    with trace.span("gfx.nrc.setup"):
        dev = scene.triangles.p0.device
        n = width * height
        lane = torch.arange(n, dtype=torch.int64, device=dev)
        pixel = pixel_from_lane(lane, width, height)
        sample_idx = int(sample_idx)

        stride = cfg.train_stride
        n_train = n // stride
        # which lane of each tile trains, and which tiles are unbiased, rotate
        # with the sample
        off_a = sample_idx % stride
        off_b = (sample_idx // stride) % cfg.unbiased_fraction
        is_training = (lane % stride) == off_a
        is_unbiased = is_training & (((lane // stride) % cfg.unbiased_fraction)
                                     == off_b)
        tr = slice(off_a, off_a + stride * n_train, stride)  # training rows
        rows = torch.arange(n_train, device=dev)

        pt_cfg = PTConfig(max_path_length=cfg.max_path_length,
                          enable_jitter=cfg.enable_jitter)
        rs_cam = SampleStream(pixel, sample_idx, stream=0xFFFF)
        if cfg.enable_jitter:
            jx, jy = rs_cam.next2()
        else:
            jx = torch.full((n,), 0.5, device=dev)
            jy = torch.full((n,), 0.5, device=dev)
        ray_o, ray_d = generate_rays_for_lanes(camera, width, height, pixel,
                                               jx, jy)

        contribution = torch.zeros((n, 3), device=dev)
        throughput = torch.ones((n, 3), device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        prev_pdf = torch.zeros(n, device=dev)
        sqrt_spread = torch.zeros(n, device=dev)
        primary_spread = torch.ones(n, device=dev)
        render_ended = torch.zeros(n, dtype=torch.bool, device=dev)
        suffix_ended = torch.zeros(n, dtype=torch.bool, device=dev)
        render_query = torch.zeros((n, 14), device=dev)
        render_alpha = torch.zeros((n, 3), device=dev)

        L = cfg.max_path_length
        tq = torch.zeros((n_train, L, 14), device=dev)
        t_target = torch.zeros((n_train, L, 3), device=dev)
        t_thru = torch.zeros((n_train, L, 3), device=dev)
        t_valid = torch.zeros((n_train, L), dtype=torch.bool, device=dev)
        suffix_query = torch.zeros((n_train, 14), device=dev)
        suffix_has_query = torch.zeros(n_train, dtype=torch.bool, device=dev)
        prev_vertex = torch.full((n_train,), -1, dtype=torch.int64, device=dev)

        use_env = scene.env is not None
        p_env_sel, p_surf_sel = light_selection_probs(scene)
        tri_packed = pack_tri_attrs(scene.triangles)
        light_packed = pack_light_rows(scene)

    for bounce in range(1, L + 1):
        with trace.span(f"gfx.nrc.bounce{bounce}"):
            rs = SampleStream(pixel, sample_idx, stream=bounce)
            # dead lanes trace with tmax < 0: no traversal work
            hit = intersect_closest(bvh, scene.triangles, ray_o, ray_d,
                                    t_min=0.0,
                                    t_max=torch.where(alive, 1e30, -1.0))
            hit_ok = alive & hit.hit
            miss = alive & ~hit.hit

            if use_env:
                env_l = env_radiance(scene.env, ray_d)
                if bounce == 1:
                    env_mis = torch.ones(n, device=dev)
                else:
                    light_p = p_env_sel * env_pdf(scene.env, ray_d)
                    env_mis = prev_pdf ** 2 / torch.clamp(
                        prev_pdf ** 2 + light_p ** 2, min=1e-30)
                add = torch.where(miss[:, None],
                                  throughput * env_l * env_mis[:, None], 0.0)
                contribution = contribution + torch.where(
                    render_ended[:, None], 0.0, add)

            sp = compute_surface_point(scene, hit.tri, hit.u, hit.v,
                                       inst=hit.inst, packed=tri_packed)
            v_out = -ray_d
            front = dot(v_out, sp.geom_normal) >= 0.0
            gn_signed = torch.where(front[:, None], sp.geom_normal,
                                    -sp.geom_normal)
            pos_off = offset_ray_origin(sp.position, gn_signed)
            nrm = sp.shading_normal
            t, b = make_frame(nrm)
            v_out_local = to_local(t, b, nrm, v_out)
            params = material_params_textured(scene.materials, scene.textures,
                                              sp.material, sp.texcoord)

            d2 = torch.clamp(hit.t ** 2, min=1e-12)
            if bounce == 1:
                cos_vn = torch.abs(dot(v_out, sp.geom_normal))
                primary_spread = d2 / (4.0 * _PI
                                       * torch.clamp(cos_vn, min=1e-6))
            else:
                inc = torch.sqrt(d2 / torch.clamp(
                    prev_pdf * torch.abs(v_out_local[:, 2]), min=1e-12))
                sqrt_spread = sqrt_spread + torch.where(hit_ok, inc, 0.0)

            # ---- implicit emitter hit (MIS after the first bounce) ----------
            emissive = ((sp.emittance > 0.0).any(dim=-1)
                        & (v_out_local[:, 2] > 0.0))
            if bounce == 1:
                mis_w = torch.ones(n, device=dev)
            else:
                hyp = surface_light_pdf(scene, torch.clamp(hit.tri, min=0),
                                        inst=hit.inst)
                light_p = p_surf_sel * hyp * d2 / torch.clamp(
                    v_out_local[:, 2], min=1e-6)
                mis_w = prev_pdf ** 2 / torch.clamp(
                    prev_pdf ** 2 + light_p ** 2, min=1e-30)
            implicit = torch.where((hit_ok & emissive)[:, None],
                                   sp.emittance * (mis_w / _PI)[:, None], 0.0)
            contribution = contribution + torch.where(
                render_ended[:, None], 0.0, throughput * implicit)
            if bounce > 1:
                # the emitter's radiance goes to the previous training vertex
                pv = hit_ok[tr] & (prev_vertex >= 0) & emissive[tr]
                depth = torch.clamp(prev_vertex, min=0)
                old = t_target[rows, depth]
                t_target[rows, depth] = torch.where(
                    pv[:, None], old + t_thru[rows, depth] * implicit[tr], old)

            alive = hit_ok

            # ---- cache termination (not on the primary hit) -----------------
            q = make_query(aabb_lo, aabb_hi, pos_off, nrm, v_out, params)
            if bounce > 1:
                ends = alive & (sqrt_spread ** 2
                                > PATH_TERMINATION_FACTOR * primary_spread)
                # 1) the rendering path's terminal, the first time
                rend_term = ends & ~render_ended
                render_query = torch.where(rend_term[:, None], q, render_query)
                render_alpha = torch.where(rend_term[:, None], throughput,
                                           render_alpha)
                # training lanes restart their spread and go on; others stop
                sqrt_spread = torch.where(rend_term & is_training, 0.0,
                                          sqrt_spread)
                # 2) the training suffix's terminal (the second trigger); the
                # unbiased ones never end in the cache
                suf_term = (ends & render_ended & is_training & ~suffix_ended
                            & ~is_unbiased)
                suf_tr = suf_term[tr]
                suffix_query = torch.where(suf_tr[:, None], q[tr],
                                           suffix_query)
                suffix_has_query = suffix_has_query | suf_tr
                suffix_ended = suffix_ended | suf_term
                render_ended = render_ended | rend_term
                alive = alive & ~(rend_term & ~is_training) & ~suf_term

            # ---- Russian roulette (training paths of length <= 2 skip it) ---
            if bounce > 1:
                cont_prob = torch.clamp(luminance(throughput), max=1.0)
                u_rr = rs.next()
                do_rr = alive & ~(is_training & (bounce <= 2))
                alive = alive & ~(do_rr & (u_rr >= cont_prob))
                # the 1/p compensation for surviving paths only, and for the
                # previous training vertex's local throughput too
                survived = do_rr & alive
                scale = torch.where(
                    survived, 1.0 / torch.clamp(cont_prob, min=1e-8), 1.0)
                throughput = throughput * scale[:, None]
                pv = (prev_vertex >= 0) & survived[tr]
                depth = torch.clamp(prev_vertex, min=0)
                old = t_thru[rows, depth]
                t_thru[rows, depth] = torch.where(
                    pv[:, None], old * scale[tr][:, None], old)
            if bounce == L:
                break

            # ---- NEE (training suffixes need it for their targets too) ------
            sp_off = dataclasses.replace(sp, position=pos_off)
            nee = _next_event(scene, bvh, sp_off, v_out_local, (t, b, nrm),
                              params, rs, pt_cfg, alive,
                              light_packed=light_packed)
            contribution = contribution + torch.where(
                (alive & ~render_ended)[:, None], throughput * nee, 0.0)

            # ---- record the training vertex ---------------------------------
            d = bounce - 1
            rec = alive[tr]
            tq[:, d] = torch.where(rec[:, None], q[tr], tq[:, d])
            t_target[:, d] = torch.where(rec[:, None], nee[tr], t_target[:, d])
            t_valid[:, d] = t_valid[:, d] | rec
            prev_vertex = torch.where(rec, d, prev_vertex)

            # ---- next direction ---------------------------------------------
            u0, u1 = rs.next2()
            v_in_local, f_val, pdf = bsdf_sample(params, v_out_local, u0, u1)
            valid = (pdf > 0.0) & torch.isfinite(pdf)
            local_thr = f_val * (torch.abs(v_in_local[:, 2])
                                 / torch.clamp(pdf, min=1e-30))[:, None]
            # a failed sample continues nowhere: its local throughput is 0
            local_thr = torch.where(valid[:, None], local_thr, 0.0)
            t_thru[:, d] = torch.where(rec[:, None], local_thr[tr],
                                       t_thru[:, d])
            throughput = torch.where((alive & valid)[:, None],
                                     throughput * local_thr, throughput)
            alive = alive & valid
            ray_o = pos_off
            ray_d = normalize(to_world(t, b, nrm, v_in_local))
            prev_pdf = pdf

    # ---- inference at the rendering and the suffix terminals -----------
    with trace.span("gfx.nrc.query"):
        all_queries = torch.cat([render_query, suffix_query], dim=0)
    with trace.span("gfx.nrc.infer"):
        trace.count("nrc.queries", all_queries.shape[0])
        with torch.no_grad():
            pred = nrc_apply(nrc_params, all_queries, nrc_cfg)
        pred = torch.clamp(pred, min=0.0) / cfg.radiance_scale
        if cfg.use_reflectance_factorization:
            pred = pred * _query_ref_factor(all_queries)
        render_pred, suffix_pred = pred[:n], pred[n:]
        radiance = contribution + torch.where(render_ended[:, None],
                                              render_alpha * render_pred, 0.0)

    # ---- targets, propagated backward along the suffixes ----------------
    with trace.span("gfx.nrc.propagate"):
        targets = propagate_targets(t_target, t_thru, t_valid, suffix_pred,
                                    suffix_has_query)
        if cfg.use_reflectance_factorization:
            rf = _query_ref_factor(tq)
            targets = torch.where(rf > 0.0,
                                  targets / torch.clamp(rf, min=1e-6), 0.0)
        targets = targets * cfg.radiance_scale
        order = lane_from_pixel(lane, width, height)
        return (radiance[order], tq.reshape(n_train * L, 14),
                targets.reshape(n_train * L, 3),
                t_valid.reshape(n_train * L))
