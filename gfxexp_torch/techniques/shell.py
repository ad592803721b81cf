"""Shell mapping: triangle contents instanced inside each prism of a base
mesh's displacement shell (port of gfxexp_tpu/techniques/shell.py; the
reference's NRTDSM shell demo).

The shell's interior is parameterised by (u, v, hn), hn in [0, 1]. A world
ray maps to a curve q(t) in shell space through the exact height solve
(techniques/nrtdsm.py `find_height`); the curve is traced piecewise
linearly, `auto_segments` chords a prism (1 for straight shells, where the
trace is exact; more as the vertex normals tilt, from a chord-error bound
measured at build time, `_estimate_shell_segments`), each chord against the
shell contents' skip-link BVH with the regular closest-hit query
(accel/traverse.py `intersect_closest`: the skip-link walk, kernel 6 on the
card, its plain version on the CPU). Every content triangle carries a
material slot.

The build is numpy on the host (the wide BVH builder at arity 8, then skip
links), as in the JAX package; the queries are plain PyTorch on the device
that holds the geometry, with the chords' points evaluated together and
divisions by constants rounded as XLA's (techniques/nrtdsm.py `_rcp`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gfxexp_torch.accel.skiplink import SkipBVH
from gfxexp_torch.accel.traverse import intersect_closest
from gfxexp_torch.core.math import cross, dot, length_rn
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.scene.types import TriangleSoA
from gfxexp_torch.techniques.nrtdsm import (
    _Prism,
    _prism_corners,
    _rcp,
    _scatter,
    _state0,
    _t32,
    find_height,
    prism_boxes,
)
from gfxexp_torch.techniques.tfdm import (
    DisplacementParameters,
    PrismBVH,
    _rays,
    _select,
    _uv_transform,
    iterate_candidates,
)
from gfxexp_torch.utils import trace


@dataclass
class ShellGeometry(TensorData):
    """A base mesh whose prisms each instance the same texture-space
    contents: the base triangles (world space), the contents' triangles in
    (u, v, hn) with their skip-link BVH and material slots, the shell's
    height range [h_lo, h_hi] and the chords a prism of the trace."""

    p0: torch.Tensor  # [B, 3]
    p1: torch.Tensor
    p2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # [B, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    shell_tris: TriangleSoA  # texture space, in BVH order
    shell_bvh: SkipBVH
    shell_mat: torch.Tensor  # [M] int32 material slot a content triangle
    h_lo: float = 0.0
    h_hi: float = 1.0
    material: int = 0
    params: DisplacementParameters = DisplacementParameters()
    auto_segments: int = 16
    # the skip-walk box BVH over the prism boxes, from 2,048 base triangles
    prism_bvh: Optional[PrismBVH] = None


def build_shell_geometry(positions, indices, uvs, shell_positions,
                         shell_indices, params=None, material: int = 0,
                         normals=None, shell_materials=None,
                         arity: int = 8, max_leaf: int = 4) -> ShellGeometry:
    """Host build (numpy; CPU tensors). shell_positions are (u, v, hn) with
    hn in [0, 1]; the contents' BVH is the wide builder's at `arity`, as
    skip links."""
    from gfxexp_torch.accel.bvh_build import build_bvh
    from gfxexp_torch.accel.skiplink import build_skip_links
    from gfxexp_torch.scene.builder import compute_smooth_normals
    from gfxexp_torch.techniques.tfdm import build_prism_bvh

    params = params or DisplacementParameters()
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    uvs = np.asarray(uvs, np.float32)
    if normals is None:
        normals = compute_smooth_normals(positions, indices)
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]

    sp = np.asarray(shell_positions, np.float32)
    si = np.asarray(shell_indices, np.int32)
    s0, s1, s2 = sp[si[:, 0]], sp[si[:, 1]], sp[si[:, 2]]
    snrm = compute_smooth_normals(sp, si)
    bvh, perm = build_bvh(s0, s1 - s0, s2 - s0, arity=arity,
                          max_leaf=max_leaf)
    skip = build_skip_links(bvh.child_min, bvh.child_max, bvh.child_idx,
                            bvh.child_count, max_leaf=max_leaf)
    s0, s1, s2 = s0[perm], s1[perm], s2[perm]
    n_s = s0.shape[0]
    zeros2 = torch.zeros((n_s, 2))
    shell_tris = TriangleSoA(
        p0=_t32(s0), e1=_t32(s1 - s0), e2=_t32(s2 - s0),
        n0=_t32(snrm[si[:, 0]][perm]), n1=_t32(snrm[si[:, 1]][perm]),
        n2=_t32(snrm[si[:, 2]][perm]),
        uv0=zeros2, uv1=zeros2, uv2=zeros2,
        unit_id=torch.zeros((n_s,), dtype=torch.int32))
    if shell_materials is None:
        shell_mat = np.full(n_s, material, np.int32)
    else:
        shell_mat = np.asarray(shell_materials, np.int32)[perm]

    p = params
    d_lo = p.h_offset + p.h_scale * (0.0 - p.h_bias)
    d_hi = p.h_offset + p.h_scale * (1.0 - p.h_bias)
    h_lo_w = float(min(d_lo, d_hi))
    h_hi_w = float(max(d_lo, d_hi))
    prism_bvh = None
    if len(i0) >= 2048:
        corners = _prism_corners(positions, normals, i0, i1, i2, h_lo_w,
                                 h_hi_w)
        prism_bvh = build_prism_bvh(corners.min(axis=1) - 1e-5,
                                    corners.max(axis=1) + 1e-5)
    auto_segments = _estimate_shell_segments(
        np.stack([positions[i0], positions[i1], positions[i2]], axis=1),
        np.stack([normals[i0], normals[i1], normals[i2]], axis=1),
        np.stack([uvs[i0], uvs[i1], uvs[i2]], axis=1),
        float(min(d_lo, d_hi)), float(max(d_lo, d_hi)))
    return ShellGeometry(
        p0=_t32(positions[i0]), p1=_t32(positions[i1]),
        p2=_t32(positions[i2]),
        n0=_t32(normals[i0]), n1=_t32(normals[i1]), n2=_t32(normals[i2]),
        uv0=_t32(uvs[i0]), uv1=_t32(uvs[i1]), uv2=_t32(uvs[i2]),
        shell_tris=shell_tris, shell_bvh=skip,
        shell_mat=torch.from_numpy(np.ascontiguousarray(shell_mat)),
        h_lo=float(min(d_lo, d_hi)), h_hi=float(max(d_lo, d_hi)),
        material=int(material), params=params,
        auto_segments=auto_segments, prism_bvh=prism_bvh)


def shell_from_numpy(g) -> ShellGeometry:
    """A gfxexp_tpu ShellGeometry (read by attribute name) -> the port's on
    the CPU, with its contents' triangles and skip-link BVH."""
    from gfxexp_torch.core.tensors import from_numpy
    from gfxexp_torch.techniques.tfdm import (
        params_from_numpy,
        prism_bvh_from_numpy,
    )

    return ShellGeometry(
        **{k: torch.from_numpy(np.array(getattr(g, k))) for k in (
            "p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
            "shell_mat")},
        shell_tris=from_numpy(g.shell_tris), shell_bvh=from_numpy(g.shell_bvh),
        h_lo=float(g.h_lo), h_hi=float(g.h_hi), material=int(g.material),
        params=params_from_numpy(g.params),
        auto_segments=int(g.auto_segments),
        prism_bvh=prism_bvh_from_numpy(g.prism_bvh))


def _estimate_shell_segments(P, N, UV, h_lo, h_hi, eps: float = 2e-3,
                             max_segments: int = 48) -> int:
    """The chords a prism of the piecewise-linear trace (host numpy):
    each base triangle's world chords between prism corners (bottom i to
    top j, i != j) are inverted at their midpoint by Newton on the shell
    map S(b1, b2, h) = base + h n; the midpoint's texture-space deviation
    from the ends' average is the one-chord error, and as the error is
    second order in the chord's length, n = ceil(sqrt(dev / eps)) chords
    keep each within eps (in (u, v, hn) units). Straight shells measure
    dev = 0: one chord, exact."""
    P = np.asarray(P, np.float64)  # [B, 3, 3] corners
    N = np.asarray(N, np.float64)
    UV = np.asarray(UV, np.float64)  # [B, 3, 2]
    h_span = max(h_hi - h_lo, 1e-12)
    dev_max = 0.0
    nb = P.shape[0]
    for i in range(3):
        for j in range(3):
            if i == j:
                continue
            xa = P[:, i] + h_lo * N[:, i]
            xb = P[:, j] + h_hi * N[:, j]
            xm = 0.5 * (xa + xb)
            # the ends' texture coordinates are the corners' exactly
            qa = np.concatenate([UV[:, i], np.zeros((nb, 1))], 1)
            qb = np.concatenate([UV[:, j], np.ones((nb, 1))], 1)
            # Newton on S at the world midpoint, from the parameter midpoint
            b1 = np.full(nb, 1.0 / 3)
            b2 = np.full(nb, 1.0 / 3)
            h = np.full(nb, 0.5 * (h_lo + h_hi))
            e1p = P[:, 1] - P[:, 0]
            e2p = P[:, 2] - P[:, 0]
            e1n = N[:, 1] - N[:, 0]
            e2n = N[:, 2] - N[:, 0]
            ok = np.ones(nb, bool)
            for _ in range(12):
                nbv = (N[:, 0] + b1[:, None] * e1n + b2[:, None] * e2n)
                S = (P[:, 0] + b1[:, None] * e1p + b2[:, None] * e2p
                     + h[:, None] * nbv)
                J = np.stack([e1p + h[:, None] * e1n,
                              e2p + h[:, None] * e2n, nbv], axis=-1)
                det = np.linalg.det(J)
                ok = ok & (np.abs(det) > 1e-18)
                Js = np.where(ok[:, None, None], J, np.eye(3))
                step = np.linalg.solve(Js, (xm - S)[..., None])[..., 0]
                b1 = b1 + np.where(ok, step[:, 0], 0.0)
                b2 = b2 + np.where(ok, step[:, 1], 0.0)
                h = h + np.where(ok, step[:, 2], 0.0)
            # only converged solves count: the residual must be tiny
            nbv = (N[:, 0] + b1[:, None] * e1n + b2[:, None] * e2n)
            S = (P[:, 0] + b1[:, None] * e1p + b2[:, None] * e2p
                 + h[:, None] * nbv)
            scale = np.linalg.norm(xb - xa, axis=-1) + 1e-12
            ok = ok & (np.linalg.norm(S - xm, axis=-1) < 1e-6 * scale)
            uvm = (UV[:, 0] + b1[:, None] * (UV[:, 1] - UV[:, 0])
                   + b2[:, None] * (UV[:, 2] - UV[:, 0]))
            qm = np.concatenate(
                [uvm, ((h - h_lo) / h_span)[:, None]], axis=1)
            dev = np.linalg.norm(qm - 0.5 * (qa + qb), axis=-1)
            dev = np.where(ok, dev, 0.0)
            if dev.size:
                dev_max = max(dev_max, float(dev.max()))
    n = int(np.ceil(np.sqrt(dev_max / eps))) if dev_max > 0 else 1
    return int(np.clip(n, 1, max_segments))


@dataclass
class ShellHit(TensorData):
    t: torch.Tensor  # [R]
    hit: torch.Tensor
    position: torch.Tensor  # [R, 3]
    normal: torch.Tensor
    uv: torch.Tensor  # [R, 2]
    prim: torch.Tensor  # [R] int32 base triangle
    mat: torch.Tensor  # [R] int32 material slot of the hit
    steps: torch.Tensor  # [R] int32 chords traced


def intersect_shell(geom: ShellGeometry, o, d, t_min=1e-4, t_max=1e30,
                    k_candidates: int = 2,
                    n_segments: Optional[int] = None) -> ShellHit:
    """The closest shell-content hit: each ray's candidate prisms stream
    nearest first until the next prism box lies past the best hit; in a
    prism the texture-space curve is traced as n_segments chords
    (geom.auto_segments when None), nearest first, each against the
    contents' BVH (one closest-hit query a chord a round, rays that need
    no query given t_max = -1). A round traces only the rays that enter a
    prism."""
    trace.count("tfdm.shell_calls")
    if n_segments is None:
        n_segments = geom.auto_segments
    n = o.shape[0]
    dev = o.device
    lo, hi = prism_boxes(geom)
    p = geom.params
    t_min_v = _rays(t_min, n, dev)
    h_span = max(geom.h_hi - geom.h_lo, 1e-9)
    state0 = _state0(n, t_max, dev) + (
        torch.full((n,), geom.material, dtype=torch.int32, device=dev),)
    e3 = torch.eye(3, device=dev)

    def process(state, cid, near, far):
        best_t = state[0]
        far = torch.minimum(far, best_t)
        sel = _select((cid >= 0) & (near < far))
        if sel.numel() == 0:
            return state
        m = sel.numel()
        cid, near, far, bt = cid[sel], near[sel], far[sel], best_t[sel]
        # the height solve gets an interval widened by an epsilon: the
        # samples at the prism box's entry and exit lie on h_lo and h_hi
        # exactly, and rounding would otherwise flip their validity; hn is
        # clamped back to the unit shell
        h_pad = 1e-3 * h_span
        pr = _Prism.of(geom, cid.to(torch.int64), o[sel], d[sel],
                       torch.full((m,), geom.h_lo - h_pad, device=dev),
                       torch.full((m,), geom.h_hi + h_pad, device=dev))
        uv_a, uv_b, uv_c = pr.uv

        # the curve's n_segments + 1 sample points, together
        ts = [near + (far - near) * (i / n_segments)
              for i in range(n_segments + 1)]
        x = pr.o + torch.stack(ts)[..., None] * pr.d
        h, b1, b2, ok = find_height(*pr.p, *pr.n, x, pr.h_lo, pr.h_hi)
        w = 1.0 - b1 - b2
        uv = _uv_transform(p, w[..., None] * uv_a + b1[..., None] * uv_b
                           + b2[..., None] * uv_c)
        hn = torch.clamp((h - geom.h_lo) * _rcp(h_span), 0.0, 1.0)
        q_all = torch.cat([uv, hn[..., None]], -1)  # [n_segments + 1, m, 3]
        in_all = ok & (b1 >= -1e-3) & (b2 >= -1e-3) & (w >= -1e-3)

        found = torch.zeros((m,), dtype=torch.bool, device=dev)
        seg_t = torch.zeros((m,), device=dev)
        seg_tri = torch.zeros((m,), dtype=torch.int32, device=dev)
        seg_q = torch.zeros((m, 3), device=dev)
        for i in range(1, n_segments + 1):
            q_prev, q_cur = q_all[i - 1], q_all[i]
            seg_vec = q_cur - q_prev
            seg_len = length_rn(seg_vec)
            live = (~found & in_all[i - 1] & in_all[i] & (seg_len > 1e-9))
            sdir = seg_vec / torch.clamp(seg_len[:, None], min=1e-12)
            sh = intersect_closest(geom.shell_bvh, geom.shell_tris, q_prev,
                                   sdir, t_min=0.0,
                                   t_max=torch.where(live, seg_len, -1.0))
            take = live & sh.hit
            frac = sh.t / torch.clamp(seg_len, min=1e-12)
            t_world = ts[i - 1] + (ts[i] - ts[i - 1]) * frac
            seg_t = torch.where(take, t_world, seg_t)
            seg_tri = torch.where(take, sh.tri, seg_tri)
            seg_q = torch.where(take[:, None],
                                q_prev + sh.t[:, None] * sdir, seg_q)
            found = found | take
        steps = torch.full((m,), n_segments, dtype=torch.int32, device=dev)
        take = found & (seg_t > t_min_v[sel]) & (seg_t < bt)

        # the world normal: the content triangle's texture-space normal
        # through the inverse transpose of the forward map S(u, v, hn)'s
        # Jacobian, by finite differences
        tri = torch.clamp(seg_tri, min=0).to(torch.int64)
        n_tex = cross(geom.shell_tris.e1[tri], geom.shell_tris.e2[tri])
        n_tex = n_tex / torch.clamp(length_rn(n_tex, keepdim=True), min=1e-20)
        duv1 = uv_b - uv_a
        duv2 = uv_c - uv_a
        det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
        safe = torch.where(torch.abs(det_uv) > 1e-12, det_uv, 1.0)
        eps = 1e-3
        # the hit and its three offsets, together: world_of([4, m, 3])
        qs = seg_q[None] + torch.cat([torch.zeros((1, 3), device=dev),
                                      eps * e3])[:, None, :]
        rel = qs[..., :2] - uv_a
        wb1 = (rel[..., 0] * duv2[:, 1] - rel[..., 1] * duv2[:, 0]) / safe
        wb2 = (duv1[:, 0] * rel[..., 1] - duv1[:, 1] * rel[..., 0]) / safe
        ww = 1.0 - wb1 - wb2
        base = (ww[..., None] * pr.p[0] + wb1[..., None] * pr.p[1]
                + wb2[..., None] * pr.p[2])
        nsh = (ww[..., None] * pr.n[0] + wb1[..., None] * pr.n[1]
               + wb2[..., None] * pr.n[2])
        hw = geom.h_lo + qs[..., 2] * h_span
        world = base + hw[..., None] * nsh
        ju, jv, jh = ((world[k] - world[0]) * _rcp(eps) for k in (1, 2, 3))
        nw = (n_tex[:, 0:1] * cross(jv, jh) + n_tex[:, 1:2] * cross(jh, ju)
              + n_tex[:, 2:3] * cross(ju, jv))
        nw = nw / torch.clamp(length_rn(nw, keepdim=True), min=1e-20)
        nw = nw * torch.sign(-dot(nw, pr.d, keepdim=True) + 1e-12)

        out = _scatter(state[:5], sel, torch.where(take, seg_t, bt),
                       torch.where(take, cid, state[1][sel]),
                       torch.where(take[:, None], seg_q[:, :2],
                                   state[2][sel]),
                       torch.where(take[:, None], nw, state[3][sel]), steps)
        mat = state[5].index_put((sel,), torch.where(
            take, geom.shell_mat[tri], state[5][sel]))
        return out + (mat,)

    best_t, best_prim, best_uv, best_nrm, steps, best_mat = \
        iterate_candidates(lo, hi, o, d, t_min, t_max, k_candidates, state0,
                           process, lambda st: st[0],
                           prism_bvh=geom.prism_bvh)
    return ShellHit(t=best_t, hit=best_prim >= 0,
                    position=o + best_t[:, None] * d, normal=best_nrm,
                    uv=best_uv, prim=best_prim, mat=best_mat, steps=steps)
