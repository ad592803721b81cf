"""The reference neural radiance cache (Müller et al. 2021, with the
multiresolution hash encoding of Müller et al. 2022), as the port and
GfxExp's neural_radiance_caching app define it, in plain torch in any
float dtype (float64 for the check, bfloat16 for the control):

- the query of a path vertex: its position normalised to the scene's box,
  the polar angles of the outgoing direction and of the shading normal,
  roughness 1 - exp(-r), and the diffuse and specular reflectances;
- its encoding: a hash grid on the position (levels of resolution
  base x scale^l, eight corners a level hashed by the primes 1,
  2654435761, 805459861 into 2^log2 entries, interpolated trilinearly),
  OneBlob (a Gaussian of sigma 1 / bins integrated over each bin) on the
  angles and the roughness, the reflectances as they are;
- the MLP: ReLU hidden layers, no output activation, with its operands
  rounded to bfloat16 (the encoding, each weight, each hidden activation)
  and products and sums in the working dtype; the gradients that pass
  those roundings are rounded to bfloat16 too, as autograd rounds the
  cotangent of a cast;
- the loss RelativeL2Luminance, (p - t)^2 / (lum(p)^2 + 0.01) with the
  normaliser held constant, averaged over the valid records, and its
  gradient written out by hand; Adam with L2 weight decay (eps outside
  the square root, bias-corrected) and an EMA of the weights;
- the path: one sample a pixel with the port's random streams, paths
  ending in the cache once their spread exceeds 0.01 x the primary
  spread (not on the primary hit), one training path per tile of
  `train_stride` lanes (the lane of each tile rotating with the sample,
  every `unbiased_fraction`-th tile's unbiased: its suffix never reads the
  cache), Russian roulette after the first bounce that spares training
  paths of length <= 2, per-vertex targets from next-event estimation
  and emitter hits, propagated backward from the suffix's cache
  prediction, and reflectance factorisation.

Nothing here is imported from the port: the scene, its ray queries, the
shading and the random streams are the reference's own (scene.py,
intersect.py, shading.py, rng.py, pathtrace.py). No product runs in
float32, so TF32 never applies."""

from __future__ import annotations

import math

import torch

from reference import intersect
from reference.pathtrace import camera_rays, surface
from reference.rng import Stream
from reference.shading import (
    PI,
    bsdf_eval,
    bsdf_pdf,
    bsdf_sample,
    dot,
    luminance,
    make_frame,
    normalize,
    offset_ray_origin,
    to_local,
    to_world,
)

_PRIMES = (1, 2654435761, 805459861)
TERMINATION_FACTOR = 0.01
BLOCK = 16  # the lane order's screen blocks


# ---------------------------------------------------------------------------
# the lane order: which lanes of a sample train
# ---------------------------------------------------------------------------


def lane_of_pixel(pixel, width, height):
    """The lane (render order) of row-major pixels: the pixel itself on a
    frame not made of whole 16x16 blocks, the only order the reference
    follows (the port orders whole blocks block by block)."""
    if width % BLOCK == 0 and height % BLOCK == 0:
        raise ValueError(f"{width}x{height}: the reference follows the lane "
                         f"order of frames not made of whole blocks")
    return pixel


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def bf16(x):
    """x rounded to bfloat16, in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def hash_grid(table, p, net):
    """(features [R, levels x features], corner entries [R, levels, 8]
    into the flattened table, their weights [R, levels, 8]) of positions
    p [R, 3] in [0, 1]."""
    hg = net["hash_grid"]
    n_levels, size, n_feat = table.shape
    dev, dt = p.device, p.dtype
    res = torch.tensor([hg["base_resolution"] * hg["per_level_scale"] ** lv
                        for lv in range(n_levels)], dtype=dt, device=dev)
    pf = p[:, None, :] * res[:, None]
    cell = torch.floor(pf)
    frac = pf - cell
    cell = cell.to(torch.int64)
    ent, wts = [], []
    for c in range(8):
        bit = [(c >> k) & 1 for k in range(3)]
        h = torch.zeros(cell.shape[:2], dtype=torch.int64, device=dev)
        w = torch.ones(cell.shape[:2], dtype=dt, device=dev)
        for k in range(3):
            h = h ^ ((cell[..., k] + bit[k]) * _PRIMES[k])
            w = w * (frac[..., k] if bit[k] else 1.0 - frac[..., k])
        h = (h & 0xFFFFFFFF) % size
        ent.append(h + torch.arange(n_levels, device=dev) * size)
        wts.append(w)
    ent = torch.stack(ent, -1)
    wts = torch.stack(wts, -1)
    feat = (wts[..., None] * table.reshape(-1, n_feat)[ent]).sum(-2)
    return feat.reshape(p.shape[0], -1), ent, wts


def one_blob(x, bins):
    """[R, D] -> [R, D x bins]."""
    centres = (torch.arange(bins, dtype=x.dtype, device=x.device)
               + 0.5) / bins
    sigma = 1.0 / bins
    d = x[..., None] - centres
    blob = torch.exp(-0.5 * (d / sigma) ** 2) / (sigma * math.sqrt(2 * PI))
    return (blob / bins).reshape(x.shape[0], -1)


def forward(params, query, net):
    """(prediction [R, 3], what the backward pass needs)."""
    feat, ent, wts = hash_grid(params["hash_table"], query[:, 0:3], net)
    x = bf16(torch.cat([feat, one_blob(query[:, 3:8], net["one_blob_bins"]),
                        query[:, 8:14]], -1))
    acts, pre = [x], []
    ws = params["weights"]
    for i, w in enumerate(ws):
        h = x @ bf16(w)
        if i < len(ws) - 1:
            pre.append(h)
            x = bf16(torch.clamp(h, min=0.0))
            acts.append(x)
        else:
            x = h
    return x, (ent, wts, acts, pre)


def predict(params, query, net):
    """The cache's radiance at queries [R, 14]: the MLP's output clamped at
    0, times the query's reflectance where the cache is factorised."""
    out = torch.clamp(forward(params, query, net)[0], min=0.0)
    if net["reflectance_factorization"]:
        out = out * (query[:, 8:11] + query[:, 11:14])
    return out


def loss_and_grads(params, query, target, mask, net):
    """The masked mean RelativeL2Luminance loss and its gradients, with the
    structure of `params`."""
    pred, (ent, wts, acts, pre) = forward(params, query, net)
    lum = 0.2126 * pred[:, 0] + 0.7152 * pred[:, 1] + 0.0722 * pred[:, 2]
    denom = lum * lum + 0.01
    diff = pred - target
    per = (diff * diff).sum(-1) / denom
    m = mask.to(pred.dtype)
    count = torch.clamp(m.sum(), min=1.0)
    loss = (per * m).sum() / count
    g = (m / count / denom)[:, None] * 2.0 * diff
    ws = params["weights"]
    gws = [None] * len(ws)
    for i in range(len(ws) - 1, -1, -1):
        gws[i] = bf16(acts[i].transpose(0, 1) @ g)
        ga = bf16(g @ bf16(ws[i]).transpose(0, 1))
        if i > 0:
            h = pre[i - 1]
            # the gradient of max(h, 0) splits at the tie
            g = ga * torch.where(h > 0.0, 1.0, torch.where(
                h == 0.0, 0.5, 0.0)).to(ga.dtype)
        else:
            g = ga
    table = params["hash_table"]
    n_levels, size, n_feat = table.shape
    gfeat = g[:, :n_levels * n_feat].reshape(-1, n_levels, 1, n_feat)
    gtab = torch.zeros((n_levels * size, n_feat), dtype=table.dtype,
                       device=table.device)
    gtab.index_add_(0, ent.reshape(-1),
                    (wts[..., None] * gfeat).reshape(-1, n_feat))
    return loss, {"weights": gws, "hash_table": gtab.reshape(table.shape)}


def _leaves(tree):
    return list(tree["weights"]) + [tree["hash_table"]]


def _tree(leaves):
    return {"weights": leaves[:-1], "hash_table": leaves[-1]}


def adam_step(state, grads, net):
    """Adam with L2 weight decay, then the EMA of the weights. state:
    {"params", "ema", "mu", "nu", "count"} (count a Python int)."""
    b1, b2 = net["adam_b1"], net["adam_b2"]
    lr, eps, l2, d = (net["learning_rate"], net["adam_eps"], net["l2"],
                      net["ema_decay"])
    count = state["count"] + 1
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    out = {k: [] for k in ("params", "ema", "mu", "nu")}
    for p, g, m, v, e in zip(*(_leaves(x) for x in (
            state["params"], grads, state["mu"], state["nu"],
            state["ema"]))):
        g = g + l2 * p
        m = (1.0 - b1) * g + b1 * m
        v = (1.0 - b2) * g * g + b2 * v
        p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        for k, x in (("params", p), ("mu", m), ("nu", v),
                     ("ema", d * e + (1.0 - d) * p)):
            out[k].append(x)
    new = {k: _tree(v) for k, v in out.items()}
    new["count"] = count
    return new


def train_frame(state, query, target, mask, perm, steps, net):
    """A frame's training: `steps` Adam steps on consecutive slices of the
    permutation `perm` of the records (the trailing n % steps dropped).
    Returns (state after, the steps' mean loss, [levels, entries] bool:
    the table entries some step's records gave a gradient)."""
    n = query.shape[0]
    perm = perm[:(n // steps) * steps].reshape(steps, -1)
    losses = []
    touched = torch.zeros(state["params"]["hash_table"].shape[:2],
                          dtype=torch.bool, device=query.device)
    for k in range(steps):
        idx = perm[k].to(query.device)
        loss, grads = loss_and_grads(state["params"], query[idx],
                                     target[idx], mask[idx], net)
        touched |= (grads["hash_table"] != 0.0).any(-1)
        state = adam_step(state, grads, net)
        losses.append(loss)
    return state, torch.stack(losses).mean(), touched


def permutation(n, frame):
    """The records' order in frame `frame` of a frame loop: the
    (frame + 1)-th permutation of n drawn from one CPU generator seeded
    0."""
    gen = torch.Generator().manual_seed(0)
    for _ in range(frame + 1):
        perm = torch.randperm(n, generator=gen)
    return perm


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------


def scene_box(scene):
    """(lo [3], hi [3]) of the scene's triangles."""
    v = torch.stack([scene.p0, scene.p0 + scene.e1, scene.p0 + scene.e2], 1)
    return v.amin((0, 1)), v.amax((0, 1))


def _polar(v):
    theta = torch.arccos(torch.clamp(v[..., 1], -1.0, 1.0)) / PI
    phi = torch.remainder(torch.atan2(v[..., 2], v[..., 0]) / (2.0 * PI),
                          1.0)
    return phi, theta


def make_query(box, position, normal, v_out, params):
    """[R, 14]: position in the box, direction and normal as (phi, theta),
    1 - exp(-roughness), diffuse, specular."""
    lo, hi = box
    p = torch.clamp((position - lo) / torch.clamp(hi - lo, min=1e-6), 0.0,
                    1.0)
    n_phi, n_theta = _polar(normal)
    d_phi, d_theta = _polar(v_out)
    rough = 1.0 - torch.exp(-params["roughness"])
    return torch.cat([p, d_phi[:, None], d_theta[:, None], n_phi[:, None],
                      n_theta[:, None], rough[:, None], params["diffuse"],
                      params["f0"]], -1)


def _nee(scene, rs, pos_off, frame, vol, params, alive):
    """Next-event estimation with the power heuristic, as the reference
    path tracer draws it: light pick, then its two coordinates."""
    tt, bb, sn = frame
    dt = pos_off.dtype
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
                      lpdf ** 2 / torch.clamp(bp ** 2 + lpdf ** 2, min=1e-30),
                      0.0)
    potential = (lpdf > 0.0) & (lp_cos > 0.0) & alive
    g = lp_cos * torch.abs(vin[..., 2]) / dist2
    c = (bsdf_eval(params, vol, vin) * (lemit / PI)
         * (g * mis / torch.clamp(lpdf, min=1e-30))[..., None])
    stmax = torch.where(potential, dist * 0.9999, -1.0).to(dt)
    occ = intersect.occluded(scene, pos_off, sdir, 0.0, stmax)
    return torch.where((potential & ~occ)[..., None], c, 0.0)


def propagate(direct, thru, valid, end):
    """The training targets [R, L, 3]: each recorded vertex's own
    radiance `direct` plus its local throughput `thru` times the next
    recorded vertex's target, starting from `end` [R, 3] (the suffix's
    cache prediction, 0 where it never reached the cache)."""
    carry = end
    targets = direct.clone()
    for k in range(direct.shape[1] - 1, -1, -1):
        ok = valid[:, k][:, None]
        new = targets[:, k] + thru[:, k] * carry
        carry = torch.where(ok, new, carry)
        targets[:, k] = torch.where(ok, new, targets[:, k])
    return targets


def sample(scene, cam, width, height, pixel, frame, ema, net, icfg):
    """One NRC sample at pixels `pixel` [R] (row-major ids) of frame
    `frame` (its sample index), reading the cache with the EMA weights
    `ema`. icfg: train_stride, unbiased_fraction, jitter. Returns
    (radiance [R, 3], the cache's part of it [R, 3], records): records
    hold, for the pixels whose lane has a training row, `row` [R] (-1:
    none), `query` [R, L, 14], `target` [R, L, 3] and `valid` [R, L], L =
    max_path_length, and `target_cached` [R, L, 3], the part of each
    target that the suffix's cache prediction carries."""
    dt, dev = scene.dtype, scene.device
    n_pix = pixel.shape[0]
    L = net["max_path_length"]
    stride, uf = icfg["train_stride"], icfg["unbiased_fraction"]
    n_train = width * height // stride
    lane = lane_of_pixel(pixel, width, height)
    is_training = lane % stride == frame % stride
    is_unbiased = is_training & ((lane // stride) % uf
                                 == (frame // stride) % uf)
    has_row = is_training & (lane // stride < n_train)
    box = scene_box(scene)

    o, d = camera_rays(scene, cam, width, height, pixel, frame,
                       icfg["jitter"])
    zeros3 = torch.zeros((n_pix, 3), dtype=dt, device=dev)
    falses = torch.zeros(n_pix, dtype=torch.bool, device=dev)
    contrib, thr = zeros3, torch.ones_like(zeros3)
    alive = ~falses
    prev_pdf = torch.zeros(n_pix, dtype=dt, device=dev)
    sqrt_spread = torch.zeros_like(prev_pdf)
    primary = torch.ones_like(prev_pdf)
    render_ended, suffix_ended = falses, falses
    render_query = torch.zeros((n_pix, 14), dtype=dt, device=dev)
    render_alpha = zeros3
    tq = torch.zeros((n_pix, L, 14), dtype=dt, device=dev)
    t_target = torch.zeros((n_pix, L, 3), dtype=dt, device=dev)
    t_thru = torch.zeros_like(t_target)
    t_valid = torch.zeros((n_pix, L), dtype=torch.bool, device=dev)
    suffix_query = torch.zeros_like(render_query)
    suffix_has = falses
    prev_vertex = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    ar = torch.arange(n_pix, device=dev)
    p_surf = 1.0 if scene.surface_ok else 0.0

    for bounce in range(1, L + 1):
        rs = Stream(pixel, frame, bounce, dt)
        tmax = torch.where(alive, 1e30, -1.0).to(dt)
        t, tri, u, v, hit = intersect.closest(scene, o, d, 0.0, tmax)
        hit_ok = alive & hit
        pos, gn, sn, _, mat, emit = surface(scene, tri, u, v)
        v_out = -d
        front = dot(v_out, gn) >= 0.0
        pos_off = offset_ray_origin(pos, torch.where(front[..., None], gn,
                                                     -gn))
        tt, bb = make_frame(sn)
        vol = to_local(tt, bb, sn, v_out)
        params = scene.material_params(mat)
        d2 = torch.clamp(t * t, min=1e-12)
        if bounce == 1:
            primary = d2 / (4.0 * PI * torch.clamp(
                torch.abs(dot(v_out, gn)), min=1e-6))
        else:
            inc = torch.sqrt(d2 / torch.clamp(prev_pdf * torch.abs(vol[:, 2]),
                                              min=1e-12))
            sqrt_spread = sqrt_spread + torch.where(hit_ok, inc, 0.0)

        # the emitter hit, MIS-weighted after the first bounce; its
        # radiance also goes to the previous training vertex
        emissive = (emit > 0.0).any(-1) & (vol[:, 2] > 0.0)
        if bounce == 1:
            mis_w = torch.ones_like(prev_pdf)
        else:
            light_p = (p_surf * scene.area_pdf[torch.clamp(tri, min=0)] * d2
                       / torch.clamp(vol[:, 2], min=1e-6))
            mis_w = prev_pdf ** 2 / torch.clamp(prev_pdf ** 2 + light_p ** 2,
                                                min=1e-30)
        implicit = torch.where((hit_ok & emissive)[:, None],
                               emit * (mis_w / PI)[:, None], 0.0)
        contrib = contrib + torch.where(render_ended[:, None], 0.0,
                                        thr * implicit)
        depth = torch.clamp(prev_vertex, min=0)
        if bounce > 1:
            pv = hit_ok & (prev_vertex >= 0) & emissive
            t_target[ar, depth] = torch.where(
                pv[:, None], t_target[ar, depth]
                + t_thru[ar, depth] * implicit, t_target[ar, depth])
        alive = hit_ok

        # the cache: the rendering path ends at its first trigger, a
        # (biased) training path's suffix at its second
        q = make_query(box, pos_off, sn, v_out, params)
        if bounce > 1:
            ends = alive & (sqrt_spread ** 2 > TERMINATION_FACTOR * primary)
            rend = ends & ~render_ended
            render_query = torch.where(rend[:, None], q, render_query)
            render_alpha = torch.where(rend[:, None], thr, render_alpha)
            sqrt_spread = torch.where(rend & is_training, 0.0, sqrt_spread)
            suf = (ends & render_ended & is_training & ~suffix_ended
                   & ~is_unbiased)
            suffix_query = torch.where((suf & has_row)[:, None], q,
                                       suffix_query)
            suffix_has = suffix_has | (suf & has_row)
            suffix_ended = suffix_ended | suf
            render_ended = render_ended | rend
            alive = alive & ~(rend & ~is_training) & ~suf

            # Russian roulette; training paths of length <= 2 skip it
            cont = torch.clamp(luminance(thr), max=1.0)
            u_rr = rs.next()
            do_rr = alive & ~(is_training & (bounce <= 2))
            alive = alive & ~(do_rr & (u_rr >= cont))
            survived = do_rr & alive
            scale = torch.where(survived, 1.0 / torch.clamp(cont, min=1e-8),
                                1.0).to(dt)
            thr = thr * scale[:, None]
            pv = (prev_vertex >= 0) & survived & has_row
            t_thru[ar, depth] = torch.where(
                pv[:, None], t_thru[ar, depth] * scale[:, None],
                t_thru[ar, depth])
        if bounce == L:
            break

        nee = _nee(scene, rs, pos_off, (tt, bb, sn), vol, params, alive)
        contrib = contrib + torch.where((alive & ~render_ended)[:, None],
                                        thr * nee, 0.0)
        rec = alive & has_row
        k = bounce - 1
        tq[:, k] = torch.where(rec[:, None], q, tq[:, k])
        t_target[:, k] = torch.where(rec[:, None], nee, t_target[:, k])
        t_valid[:, k] = t_valid[:, k] | rec
        prev_vertex = torch.where(rec, k, prev_vertex)

        u0, u1 = rs.next2()
        vin, f, pdf = bsdf_sample(params, vol, u0, u1)
        valid = (pdf > 0.0) & torch.isfinite(pdf)
        local = f * (torch.abs(vin[:, 2])
                     / torch.clamp(pdf, min=1e-30))[:, None]
        local = torch.where(valid[:, None], local, 0.0)
        t_thru[:, k] = torch.where(rec[:, None], local, t_thru[:, k])
        thr = torch.where((alive & valid)[:, None], thr * local, thr)
        alive = alive & valid
        o = pos_off
        d = normalize(to_world(tt, bb, sn, vin))
        prev_pdf = pdf

    cached = torch.where(render_ended[:, None],
                         render_alpha * predict(ema, render_query, net), 0.0)
    end = torch.where(suffix_has[:, None], predict(ema, suffix_query, net),
                      0.0)
    targets = [propagate(t_target, t_thru, t_valid, e)
               for e in (end, torch.zeros_like(end))]
    if net["reflectance_factorization"]:
        rf = tq[..., 8:11] + tq[..., 11:14]
        targets = [torch.where(rf > 0.0, t / torch.clamp(rf, min=1e-6), 0.0)
                   for t in targets]
    rows = torch.where(has_row, lane // stride, -1)
    return contrib + cached, cached, {
        "row": rows, "query": tq, "target": targets[0], "valid": t_valid,
        "target_cached": targets[0] - targets[1]}
