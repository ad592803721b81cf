"""The reference path tracer: one sample of the port's integrator for a set
of pixels (next-event estimation with the power heuristic against
BSDF-sampled emitter hits, Russian roulette after the first bounce, max
path length 5 by default, diffuse emitters, no environment), following the
port's random-number streams: the camera jitter on stream 0xFFFF, then per
bounce b (stream b) Russian roulette (not on the first bounce nor the
collect-only last), the light pick and its two coordinates, and the BSDF's
two. Paths are traced against the reference's own scene tables."""

from __future__ import annotations

import torch

from reference import intersect
from reference.rng import Stream
from reference.shading import (
    PI,
    bsdf_eval,
    bsdf_pdf,
    bsdf_sample,
    cross,
    dot,
    luminance,
    make_frame,
    normalize,
    offset_ray_origin,
    primary_rays,
    to_local,
    to_world,
)


def camera_rays(scene, cam, width, height, pixel, sample, jitter=True):
    dt = scene.dtype
    if jitter:
        rs = Stream(pixel, sample, 0xFFFF, dt)
        jx, jy = rs.next2()
    else:
        jx = torch.full(pixel.shape, 0.5, dtype=dt, device=pixel.device)
        jy = jx
    return primary_rays(cam, width, height, pixel, jx, jy)


def surface(scene, tri, u, v):
    """position, geometric normal, shading normal, unit, material and
    emittance of hits (tri clamped to 0 on misses)."""
    tri = torch.clamp(tri, min=0)
    p0, e1, e2 = scene.p0[tri], scene.e1[tri], scene.e2[tri]
    pos = p0 + u[..., None] * e1 + v[..., None] * e2
    gn = normalize(cross(e1, e2))
    n = scene.n[tri]
    w = (1.0 - u - v)[..., None]
    sn = normalize(w * n[:, 0] + u[..., None] * n[:, 1]
                   + v[..., None] * n[:, 2])
    unit = scene.unit[tri]
    mat = scene.unit_material[unit]
    return pos, gn, sn, unit, mat, scene.emittance[mat]


def radiance(scene, cam, width, height, pixel, sample, max_len=5,
             jitter=True):
    """[R, 3] radiance of one sample at pixels `pixel` (row-major ids)."""
    dt, dev = scene.dtype, scene.device
    n = pixel.shape[0]
    o, d = camera_rays(scene, cam, width, height, pixel, sample, jitter)
    contrib = torch.zeros((n, 3), dtype=dt, device=dev)
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, dtype=dt, device=dev)
    p_surf = 1.0 if scene.surface_ok else 0.0

    def step(bounce, first, collect):
        nonlocal o, d, thr, alive, prev_pdf, contrib
        rs = Stream(pixel, sample, bounce, dt)
        tmax = torch.where(alive, 1e30, -1.0).to(dt)
        t, tri, u, v, hit = intersect.closest(scene, o, d, 0.0, tmax)
        hit_ok = alive & hit
        pos, gn, sn, unit, mat, emit = surface(scene, tri, u, v)
        v_out = -d
        front = dot(v_out, gn) >= 0.0
        gns = torch.where(front[..., None], gn, -gn)
        pos_off = offset_ray_origin(pos, gns)
        tt, bb = make_frame(sn)
        vol = to_local(tt, bb, sn, v_out)
        emissive = (emit > 0.0).any(-1) & (vol[..., 2] > 0.0)
        if first:
            mis_w = torch.ones(n, dtype=dt, device=dev)
        else:
            dist2 = torch.clamp(t * t, min=1e-12)
            light_p = (p_surf * scene.area_pdf[torch.clamp(tri, min=0)]
                       * dist2 / torch.clamp(vol[..., 2], min=1e-6))
            mis_w = prev_pdf ** 2 / torch.clamp(prev_pdf ** 2 + light_p ** 2,
                                                min=1e-30)
        contrib = contrib + torch.where((hit_ok & emissive)[..., None],
                                        thr * emit * (mis_w / PI)[..., None],
                                        0.0)
        alive = hit_ok
        if not first and not collect:
            cont = torch.clamp(luminance(thr), max=1.0)
            alive = alive & (rs.next() < cont)
            thr = thr / torch.clamp(cont, min=1e-8)[..., None]
        if collect:
            return
        params = scene.material_params(mat)
        # next-event estimation
        u_l = rs.next()
        u0, u1 = rs.next2()
        lpos, lnrm, lemit, lpdf = scene.sample_light(u_l, u0, u1)
        svec = lpos - pos_off
        dist2 = torch.clamp(dot(svec, svec), min=1e-12)
        dist = torch.sqrt(dist2)
        sdir = svec / dist[..., None]
        vin = to_local(tt, bb, sn, sdir)
        lp_cos = dot(-sdir, lnrm)
        bp = bsdf_pdf(params, vol, vin) * torch.abs(lp_cos) / dist2
        bp = torch.where(torch.isfinite(bp), bp, 0.0)
        mis = torch.where(lpdf > 0.0,
                          lpdf ** 2 / torch.clamp(bp ** 2 + lpdf ** 2,
                                                  min=1e-30), 0.0)
        potential = (lpdf > 0.0) & (lp_cos > 0.0) & alive
        g = lp_cos * torch.abs(vin[..., 2]) / dist2
        c = (bsdf_eval(params, vol, vin) * (lemit / PI)
             * (g * mis / torch.clamp(lpdf, min=1e-30))[..., None])
        stmax = torch.where(potential, dist * 0.9999, -1.0)
        occ = intersect.occluded(scene, pos_off, sdir, 0.0, stmax)
        nee = torch.where((potential & ~occ)[..., None], c, 0.0)
        contrib = contrib + torch.where(alive[..., None], thr * nee, 0.0)
        # next direction
        u0, u1 = rs.next2()
        vin, f, pdf = bsdf_sample(params, vol, u0, u1)
        valid = (pdf > 0.0) & torch.isfinite(pdf)
        w = f * (torch.abs(vin[..., 2]) / torch.clamp(pdf, min=1e-30))[
            ..., None]
        thr = torch.where((alive & valid)[..., None], thr * w, thr)
        alive = alive & valid
        o = pos_off
        d = normalize(to_world(tt, bb, sn, vin))
        prev_pdf = pdf

    step(1, True, max_len == 1)
    for b in range(2, max_len):
        step(b, False, False)
    if max_len > 1:
        step(max_len, False, True)
    return contrib
