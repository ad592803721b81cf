"""The reference ReSTIR DI frame, rearchitected pipeline, biased
estimator (Bitterli et al. 2020; Wyman and Panteleev 2021), at a set of
pixels: a per-frame pool of num_subsets x subset_size presampled lights;
per pixel, streaming RIS over 2^k candidates of the pool subset its 8 x 8
tile hashes to, the winner kept only if visible; the temporal candidate
(the previous reservoir at the reprojected pixel, its stream length
clamped to 20x, accepted by the camera-distance (10%) and normal (0.9)
tests) merged with visibility in its target; num_passes spatial passes
over num_neighbors low-discrepancy (R2) disk offsets of radius `radius`;
then the selected sample shaded behind a shadow ray, plus emitters seen
directly. Random streams as the port's: 0x9135 (the pool), 0x5152 and
pcg3d(tile, frame, 77) (initial RIS), 0x7e40 (temporal resampling),
0x5a00 + pass (spatial).

A pixel's result depends on its neighbours' through the spatial passes,
so the reference computes every pixel the requested ones reach back to:
at most (1 + num_neighbors)^num_passes pixels each. The previous frame's
reservoirs are the one input it takes from the program (none at the first
frame of a run, whose history is empty)."""

from __future__ import annotations


import numpy as np
import torch

from reference import intersect
from reference.gbuffer import gbuffer
from reference.rng import Stream, pcg3d
from reference.shading import (
    PI,
    bsdf_eval,
    dot,
    length,
    make_frame,
    offset_ray_origin,
    to_local,
)


def r2_disk(count=1024):
    g = 1.32471795724474602596
    i = np.arange(count)
    u = (0.5 + i / g) % 1.0
    v = (0.5 + i / (g * g)) % 1.0
    r = np.sqrt(u)
    return np.stack([r * np.cos(2 * np.pi * v), r * np.sin(2 * np.pi * v)],
                    -1).astype(np.float32)


_R2 = r2_disk()
FIELDS = ("pos", "nrm", "emit", "sum_w", "stream_len", "rec_pdf", "target")


def _ctx(scene, cam, gb):
    pos, gn, sn = gb["position"], gb["geom_normal"], gb["normal"]
    v_out = cam["position"] - pos
    dist = length(v_out)
    v_out = v_out / torch.clamp(dist, min=1e-12)[..., None]
    front = dot(v_out, gn) >= 0.0
    t, b = make_frame(sn)
    return dict(pos=offset_ray_origin(pos, torch.where(front[..., None], gn,
                                                       -gn)),
                vol=to_local(t, b, sn, v_out), t=t, b=b, n=sn,
                params=scene.material_params(torch.clamp(gb["material"],
                                                         min=0)),
                valid=gb["hit"], cam_dist=dist, emit=gb["emittance"])


def _unshadowed(ctx, pos, nrm, emit):
    vec = pos - ctx["pos"]
    dist2 = torch.clamp(dot(vec, vec), min=1e-12)
    sdir = vec / torch.sqrt(dist2)[..., None]
    vin = to_local(ctx["t"], ctx["b"], ctx["n"], sdir)
    lp_cos = dot(-sdir, nrm)
    f = bsdf_eval(ctx["params"], ctx["vol"], vin)
    cont = f * (emit / PI) * (lp_cos * torch.abs(vin[..., 2]) / dist2)[
        ..., None]
    return torch.where(((lp_cos > 0.0) & ctx["valid"])[..., None], cont, 0.0)


def _visible(scene, ctx, pos, valid):
    vec = pos - ctx["pos"]
    dist = length(vec)
    sdir = vec / torch.clamp(dist, min=1e-12)[..., None]
    tmax = torch.where(valid, dist * 0.9999, -1.0)
    return ~intersect.occluded(scene, ctx["pos"], sdir, 0.0, tmax) & valid


def _update(res, pos, nrm, emit, weight, u, target, sel_t):
    sum_w = res["sum_w"] + weight
    acc = (u * sum_w < weight) & (weight > 0.0)
    a3 = acc[..., None]
    out = dict(res, pos=torch.where(a3, pos, res["pos"]),
               nrm=torch.where(a3, nrm, res["nrm"]),
               emit=torch.where(a3, emit, res["emit"]), sum_w=sum_w,
               stream_len=res["stream_len"] + 1.0)
    return out, torch.where(acc, target, sel_t), acc


def _finish_reuse(res, w_est, sel_t):
    rec = w_est * res["sum_w"] / torch.clamp(sel_t, min=1e-30)
    bad = ~torch.isfinite(rec) | (sel_t <= 0.0)
    return dict(res, rec_pdf=torch.where(bad, 0.0, rec),
                target=torch.where(bad, 0.0, sel_t))


def _take(d, idx):
    return {k: _take(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in d.items()}


def _neighbor_ok(cam, gb_pos, gb_nrm, gb_hit, ok, ctx):
    nb_dist = length(cam["position"] - gb_pos)
    return (ok & gb_hit & ctx["valid"]
            & (torch.abs(nb_dist - ctx["cam_dist"])
               / torch.clamp(ctx["cam_dist"], min=1e-6) <= 0.1)
            & (dot(ctx["n"], gb_nrm) >= 0.9))


def _offset_pixels(pix, width, height, dx, dy):
    """Pixel ids at (px + 0.5 + dx, py + 0.5 + dy), floored in float32 as
    the port takes them, clamped; and whether they are on screen."""
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    nbx = torch.floor(px + 0.5 + dx).to(torch.int64)
    nby = torch.floor(py + 0.5 + dy).to(torch.int64)
    inb = (nbx >= 0) & (nbx < width) & (nby >= 0) & (nby < height)
    idx = (torch.clamp(nby, 0, height - 1) * width
           + torch.clamp(nbx, 0, width - 1))
    return idx, inb, (nbx != px.to(torch.int64)) | (nby != py.to(torch.int64))


def restir_frame(scene, cam, width, height, pixels, frame, prev_sample,
                 prev_res, cfg):
    """(colour [P, 3], reservoir dict [P]) at `pixels` for frame `frame`.
    prev_res: the previous frame's reservoirs as a dict of full-image
    tensors (FIELDS), or None for an empty history."""
    dt, dev = scene.dtype, scene.device
    f = int(frame)
    passes, nbrs = cfg["num_spatial_passes"], cfg["num_spatial_neighbors"]
    radius = float(cfg["spatial_radius"])

    def deltas(k):
        out = []
        for j in range(nbrs):
            dl = _R2[(f * passes * nbrs + k * nbrs + j) % 1024]
            out.append((torch.tensor(float(dl[0]), dtype=torch.float32)
                        * radius, torch.tensor(float(dl[1]),
                                               dtype=torch.float32) * radius))
        return out

    dl = [deltas(k) for k in range(passes)]
    # the pixels each pass reads, last pass first
    need = [pixels.to(dev)]
    for k in reversed(range(passes)):
        cur = need[-1]
        parts = [cur] + [_offset_pixels(cur, width, height, dx.to(dev),
                                        dy.to(dev))[0] for dx, dy in dl[k]]
        need.append(torch.unique(torch.cat(parts)))
    closure = need[-1]  # sorted

    def rows(pix):
        return torch.searchsorted(closure, pix)

    gb = gbuffer(scene, cam, width, height, closure, f)
    ctx = _ctx(scene, cam, gb)

    # the frame's light pool (only the slots the closure reads are used)
    n_pool = cfg["num_light_subsets"] * cfg["light_subset_size"]
    rs = Stream(torch.arange(n_pool, device=dev), f, 0x9135, dt)
    u = rs.next()
    u0, u1 = rs.next2()
    p_pos, p_nrm, p_emit, p_pdf = scene.sample_light(u, u0, u1)
    p_rec = torch.where(p_pdf > 0.0, 1.0 / torch.clamp(p_pdf, min=1e-30),
                        0.0)

    # initial RIS over the tile's pool subset
    n = closure.shape[0]
    rs = Stream(closure, f, 0x5152, dt)
    px, py = closure % width, closure // width
    tile = (py // 8) * ((width + 7) // 8) + px // 8
    sub_bits = pcg3d(tile, f, 77)[0]
    subset = (sub_bits.to(torch.int64) & 0xFFFFFFFF) % cfg[
        "num_light_subsets"]
    size = cfg["light_subset_size"]
    zero3 = torch.zeros((n, 3), dtype=dt, device=dev)
    zero = torch.zeros(n, dtype=dt, device=dev)
    res = dict(pos=zero3, nrm=zero3, emit=zero3, sum_w=zero,
               stream_len=zero, rec_pdf=zero, target=zero)
    sel_t = zero
    for _ in range(1 << cfg["log2_num_candidates"]):
        uu = rs.next()
        slot = subset * size + torch.clamp((uu * size).to(torch.int64),
                                           max=size - 1)
        target = _unshadowed(ctx, p_pos[slot], p_nrm[slot],
                             p_emit[slot]).mean(-1)
        res, sel_t, _ = _update(res, p_pos[slot], p_nrm[slot], p_emit[slot],
                                target * p_rec[slot], rs.next(), target,
                                sel_t)
    rec = res["sum_w"] / torch.clamp(sel_t * res["stream_len"], min=1e-30)
    bad = ~torch.isfinite(rec) | (sel_t <= 0.0)
    rec = torch.where(bad, 0.0, rec)
    sel_t = torch.where(bad, 0.0, sel_t)
    vis = _visible(scene, ctx, res["pos"], ctx["valid"] & (sel_t > 0.0))
    res = dict(res, rec_pdf=torch.where(vis, rec, 0.0),
               target=torch.where(vis, sel_t, 0.0))

    # visibility of the new and the temporal sample
    vis_new = _visible(scene, ctx, res["pos"],
                       ctx["valid"] & (res["sum_w"] > 0.0))
    mo = gb["motion"].to(torch.float32)
    nb, inb, _ = _offset_pixels(closure, width, height, -mo[:, 0],
                                -mo[:, 1])
    prev_gb = gbuffer(scene, cam, width, height, nb, prev_sample)
    passed = _neighbor_ok(cam, prev_gb["position"], prev_gb["normal"],
                          prev_gb["hit"], inb, ctx)
    if prev_res is None:
        prev = {k: torch.zeros_like(res[k]) for k in FIELDS}
    else:
        prev = {k: prev_res[k][nb].to(dt) for k in FIELDS}
    t_valid = passed & (prev["sum_w"] > 0.0)
    vis_t = _visible(scene, ctx, prev["pos"], t_valid)

    # temporal resampling
    rs = Stream(closure, f, 0x7e40, dt)
    self_len = res["stream_len"]
    dead = ~vis_new
    res0 = dict(res, sum_w=torch.where(dead, 0.0, res["sum_w"]),
                stream_len=torch.where(dead, 0.0, res["stream_len"]),
                target=torch.where(dead, 0.0, res["target"]))
    nb_len = torch.minimum(prev["stream_len"], 20.0 * self_len)
    target = torch.where(vis_t, _unshadowed(ctx, prev["pos"], prev["nrm"],
                                            prev["emit"]).mean(-1), 0.0)
    weight = torch.where(passed, target * prev["rec_pdf"] * nb_len, 0.0)
    merged, sel_t, _ = _update(res0, prev["pos"], prev["nrm"], prev["emit"],
                               weight, rs.next(), target, res0["target"])
    merged["stream_len"] = self_len + torch.where(passed, nb_len, 0.0)
    res = _finish_reuse(merged, 1.0 / torch.clamp(merged["stream_len"],
                                                  min=1e-30), sel_t)

    # spatial passes
    for k in range(passes):
        out_pix = need[passes - 1 - k]
        r_out = rows(out_pix)
        c = _take(ctx, r_out)
        rs = Stream(out_pix, f, 0x5a00 + k, dt)
        me = _take(res, r_out)
        keep = me["rec_pdf"] > 0.0
        comb = dict(me, sum_w=torch.where(keep, me["sum_w"], 0.0),
                    stream_len=torch.where(keep, me["stream_len"], 0.0))
        sel_t = torch.where(keep, me["target"], 0.0)
        comb_len = me["stream_len"]
        for dx, dy in dl[k]:
            nbi, inb, not_self = _offset_pixels(out_pix, width, height,
                                                dx.to(dev), dy.to(dev))
            rn = rows(nbi)
            ok = _neighbor_ok(cam, gb["position"][rn], gb["normal"][rn],
                              gb["hit"][rn], inb & not_self, c)
            other = _take(res, rn)
            target = _unshadowed(c, other["pos"], other["nrm"],
                                 other["emit"]).mean(-1)
            weight = torch.where(ok, target * other["rec_pdf"]
                                 * other["stream_len"], 0.0)
            comb, sel_t, _ = _update(comb, other["pos"], other["nrm"],
                                     other["emit"], weight, rs.next(),
                                     target, sel_t)
            comb_len = comb_len + torch.where(ok, other["stream_len"], 0.0)
        comb["stream_len"] = comb_len
        new = _finish_reuse(comb, 1.0 / torch.clamp(comb_len, min=1e-30),
                            sel_t)
        res = {k2: res[k2].index_put((r_out,), new[k2]) for k2 in FIELDS}

    # shading
    r = rows(pixels.to(dev))
    c = _take(ctx, r)
    fin = _take(res, r)
    cont = _unshadowed(c, fin["pos"], fin["nrm"], fin["emit"])
    use = c["valid"] & (fin["rec_pdf"] > 0.0)
    vis = _visible(scene, c, fin["pos"], use)
    direct = torch.where((c["valid"] & (c["vol"][..., 2] > 0))[..., None],
                         c["emit"] / PI, 0.0)
    color = direct + torch.where(vis[..., None],
                                 cont * fin["rec_pdf"][..., None], 0.0)
    return color, fin
