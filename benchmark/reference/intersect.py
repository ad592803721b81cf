"""The reference's ray queries: Möller-Trumbore against every triangle of
each block whose box the ray enters before its current closest hit
(t_min < t < t_max, |det| > 1e-12, u, v >= 0, u + v <= 1, position
p0 + u e1 + v e2). Plain torch in the scene's dtype; no acceleration
structure of the port's."""

from __future__ import annotations

import torch

from reference.shading import cross, dot

_CHUNK = 1 << 22  # rays x triangles a step


def _slab(o, inv_d, lo, hi):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    return near, far


def closest(scene, o, d, t_min, t_max):
    """(t, tri, u, v, hit) [R]: tri -1 and hit False on a miss; rays with
    t_max < t_min trace nothing."""
    dt = o.dtype
    r = o.shape[0]
    dev = o.device
    t_min = torch.broadcast_to(torch.as_tensor(t_min, dtype=dt, device=dev),
                               (r,))
    best_t = torch.broadcast_to(torch.as_tensor(t_max, dtype=dt, device=dev),
                                (r,)).clone()
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(r, dtype=dt, device=dev)
    best_v = torch.zeros(r, dtype=dt, device=dev)
    tiny = torch.where(d < 0, -1e-12, 1e-12).to(dt)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)
    live = best_t > t_min
    for b, (s, e) in enumerate(scene.blocks):
        near, far = _slab(o, inv_d, scene.block_lo[b], scene.block_hi[b])
        sel = (live & (near <= far) & (far > t_min)
               & (near < best_t)).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        p0, e1, e2 = scene.p0[s:e], scene.e1[s:e], scene.e2[s:e]
        step = max(1, _CHUNK // (e - s))
        for c in range(0, sel.numel(), step):
            idx = sel[c:c + step]
            oo, dd = o[idx][:, None, :], d[idx][:, None, :]
            pv = cross(dd, e2[None])
            det = dot(e1[None], pv)
            ok_det = torch.abs(det) > 1e-12
            inv = torch.where(ok_det, 1.0 / torch.where(det == 0, 1.0, det),
                              0.0)
            tv = oo - p0[None]
            u = dot(tv, pv) * inv
            qv = cross(tv, e1[None])
            v = dot(dd, qv) * inv
            t = dot(e2[None], qv) * inv
            ok = (ok_det & (u >= 0) & (v >= 0) & (u + v <= 1.0)
                  & (t > t_min[idx][:, None]) & (t < best_t[idx][:, None]))
            tm = torch.where(ok, t, float("inf"))
            tb, j = tm.min(1)
            better = torch.isfinite(tb)
            k = idx[better]
            jj = j[better]
            best_t[k] = tb[better]
            best_tri[k] = s + jj
            best_u[k] = u[better, jj]
            best_v[k] = v[better, jj]
    hit = best_tri >= 0
    return best_t, best_tri, best_u, best_v, hit


def occluded(scene, o, d, t_min, t_max):
    """Any hit with t_min < t < t_max [R]."""
    return closest(scene, o, d, t_min, t_max)[4]
