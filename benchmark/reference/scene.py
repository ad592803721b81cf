"""The reference's scene: a recipe (scenes/*.py) flattened into world-space
triangles at animation time t, the units (one an instance and geometry),
materials, the light-selection tables, and blocks of triangles with their
boxes for the reference's ray queries. Float64 by default; any float dtype.

Light selection is the port's published scheme: a unit by its emitted
power (area x luminance), then a triangle of the unit by the same weight,
through Vose alias tables built on the host for a static scene, and
through a CDF search over the tables the animation rebuilds for an animated
one (its alias tables are not rebuilt)."""

from __future__ import annotations

import numpy as np
import torch

from reference.shading import cross

_LUMA = np.array([0.2126729, 0.7151522, 0.0721750])


def vose(weights):
    """Vose's alias construction (prob, alias) in float64, in the order of
    the port's host builder: the last small and last large entry paired
    first."""
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    n = w.shape[0]
    total = w.sum()
    p = np.full(n, 1.0 / n) if total <= 0.0 else w / total
    scaled = p * n
    prob = np.ones(n)
    alias = np.arange(n)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for i in large + small:
        prob[i] = 1.0
    return prob, alias


def _slerp(q0, q1, t):
    q0 = np.asarray(q0, np.float32)
    q1 = np.asarray(q1, np.float32)
    t = np.asarray(t, np.float32)[..., None]
    one = np.float32(1)
    d = (q0 * q1).sum(-1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d)
    theta = np.arccos(np.clip(d, -one, one))
    s = np.sin(theta)
    lerp = s < np.float32(1e-5)
    den = np.where(lerp, one, s)
    w0 = np.where(lerp, one - t, np.sin((one - t) * theta) / den)
    w1 = np.where(lerp, t, np.sin(t * theta) / den)
    q = w0 * q0 + w1 * q1
    return q / np.sqrt(np.maximum((q * q).sum(-1, keepdims=True),
                                  np.float32(1e-20)))


def _quat_matrix(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y), 2 * (x * y + w * z),
                     1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1).reshape(q.shape[:-1]
                                                          + (3, 3))


def controller_transform(c, t: float) -> np.ndarray:
    """[3, 4] transform of keyframe controller `c` at time t: a triangle
    wave between its begin and end pose, one cycle per 1 / frequency s."""
    cycle = (c["initial_time"] + t) * c["frequency"] % 1.0
    s = 1.0 - abs(2.0 * cycle - 1.0)
    q = _slerp(c["begin_orientation"], c["end_orientation"], np.float32(s))
    rot = _quat_matrix(q.astype(np.float64))
    scale = (1.0 - s) * c["begin_scale"] + s * c["end_scale"]
    pos = ((1.0 - s) * np.asarray(c["begin_position"], np.float64)
           + s * np.asarray(c["end_position"], np.float64))
    return np.concatenate([rot * scale, pos[:, None]], 1)


def instance_transforms(recipe, t):
    """[I, 3, 4] float64 transforms at time t (None: the recipe's own, the
    scene as built, before any update)."""
    m = np.stack([np.asarray(i["transform"], np.float64)
                  for i in recipe.instances])
    if t is not None:
        for c in recipe.controllers:
            m[c["instance"]] = controller_transform(c, t)
    return m


class RefScene:
    def __init__(self, recipe, t, prev_t, animated: bool, dtype, device,
                 block_tris: int = 4096):
        """The scene at time t; prev_t is the time of the transforms the
        motion vectors come from (None: the recipe's own)."""
        self.dtype, self.device = dtype, device
        m = instance_transforms(recipe, t)
        mp = instance_transforms(recipe, prev_t)
        p0s, e1s, e2s, ns, units, blocks = [], [], [], [], [], []
        unit_mat, unit_inst, unit_imp, tri_w = [], [], [], []
        cursor = 0
        for ii, inst in enumerate(recipe.instances):
            rot, tr = m[ii, :, :3], m[ii, :, 3]
            nrm_mat = np.linalg.inv(rot).T
            for gi in inst["geometries"]:
                g = recipe.geometries[gi]
                pos = np.asarray(g["positions"], np.float64)
                idx = g["indices"]
                o0 = pos[idx[:, 0]]
                oe1 = pos[idx[:, 1]] - o0
                oe2 = pos[idx[:, 2]] - o0
                p0 = o0 @ rot.T + tr
                e1 = oe1 @ rot.T
                e2 = oe2 @ rot.T
                nn = np.asarray(g["normals"], np.float64) @ nrm_mat.T
                nn /= np.linalg.norm(nn, axis=1, keepdims=True)
                u = len(unit_mat)
                nt = len(idx)
                p0s.append(p0)
                e1s.append(e1)
                e2s.append(e2)
                ns.append(np.stack([nn[idx[:, k]] for k in range(3)], 1))
                units.append(np.full(nt, u))
                area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
                emit = recipe.materials[g["material"]]["emittance"]
                w = area * float(np.dot(_LUMA, emit))
                tri_w.append(w)
                unit_mat.append(g["material"])
                unit_inst.append(ii)
                unit_imp.append(float(w.sum()))
                for s in range(0, nt, block_tris):
                    blocks.append((cursor + s,
                                   cursor + min(nt, s + block_tris)))
                cursor += nt
        dev = device
        f64 = np.float64

        def T(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        self.p0, self.e1, self.e2 = (T(np.concatenate(x)) for x in
                                     (p0s, e1s, e2s))
        self.n = T(np.concatenate(ns))  # [T, 3 vertices, 3]
        self.unit = T(np.concatenate(units), torch.int64)
        self.unit_material = T(unit_mat, torch.int64)
        self.unit_instance = T(unit_inst, torch.int64)
        self.transform, self.prev_transform = T(m), T(mp)
        self.inv_transform = T(np.stack([
            np.concatenate([np.linalg.inv(x[:, :3]),
                            (-np.linalg.inv(x[:, :3]) @ x[:, 3])[:, None]],
                           1) for x in m]))
        mats = recipe.materials
        self.diffuse = T([mt["diffuse"] for mt in mats])
        self.f0 = T([mt["f0"] for mt in mats])
        self.roughness = T([min(mt["roughness"], 0.999) for mt in mats])
        self.lambert = T([mt["bsdf"] == "lambert" for mt in mats], torch.bool)
        self.emittance = T([mt["emittance"] for mt in mats])

        # light tables in light order (= triangle order here)
        imp = np.asarray(unit_imp, f64)
        total = imp.sum()
        self.surface_ok = total > 0
        unit_pmf = imp / total if total > 0 else np.zeros_like(imp)
        counts = np.asarray([len(w) for w in tri_w])
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        tri_pmf = np.concatenate([w / w.sum() if w.sum() > 0
                                  else np.zeros_like(w) for w in tri_w])
        self.unit_pmf = T(unit_pmf)
        self.tri_pmf = T(tri_pmf)
        self.unit_offset = T(offsets, torch.int64)
        self.unit_count = T(counts, torch.int64)
        self.animated = animated
        if animated:
            cdf = np.concatenate([[0.0], np.cumsum(unit_pmf)])
            self.unit_cdf = T(cdf / max(cdf[-1], 1e-20))
            self.tri_cdf = T(np.concatenate([np.concatenate(
                [[0.0], np.cumsum(tri_pmf[o:o + c])[:-1]])
                for o, c in zip(offsets, counts)]))
        else:
            ap, ai = vose(imp)
            self.unit_alias_prob, self.unit_alias = T(ap), T(ai, torch.int64)
            tp, ta = zip(*[vose(w) for w in tri_w])
            self.tri_alias_prob = T(np.concatenate(tp))
            self.tri_alias = T(np.concatenate(ta), torch.int64)
        # blocks of triangles and their boxes, for culling ray queries
        self.blocks = blocks
        lo, hi = [], []
        p0n = np.concatenate(p0s)
        v = np.stack([p0n, p0n + np.concatenate(e1s),
                      p0n + np.concatenate(e2s)], 1)
        for s, e in blocks:
            lo.append(v[s:e].min(axis=(0, 1)))
            hi.append(v[s:e].max(axis=(0, 1)))
        pad = 1e-4 * max(1.0, float(np.abs(v).max()))
        self.block_lo = T(np.asarray(lo) - pad)
        self.block_hi = T(np.asarray(hi) + pad)
        c = cross(self.e1, self.e2)
        cr = torch.sqrt(torch.clamp((c * c).sum(-1), min=0))
        # NEE area pdf of each triangle (0 on a dark unit)
        self.area_pdf = torch.where(
            cr > 0, self.unit_pmf[self.unit] * self.tri_pmf
            * (2.0 / torch.clamp(cr, min=1e-20)), 0.0)

    # -- light selection ---------------------------------------------------

    def _alias(self, prob, alias, base, n, u):
        scaled = u * n.to(u.dtype)
        bucket = torch.minimum(torch.clamp(scaled.to(torch.int64), min=0),
                               torch.clamp(n - 1, min=0))
        frac = scaled - bucket.to(u.dtype)
        p = prob[base + bucket]
        keep = frac < p
        local = torch.where(keep, bucket, alias[base + bucket])
        u_re = torch.where(keep, frac / torch.clamp(p, min=1e-12),
                           (frac - p) / torch.clamp(1.0 - p, min=1e-12))
        return local, torch.clamp(u_re, 0.0, 1.0 - 1e-7)

    def select_light(self, u):
        """The light triangle for uniforms u [R]."""
        n_units = self.unit_material.shape[0]
        if self.animated:
            cdf = self.unit_cdf
            unit = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0,
                               n_units - 1)
            lo = cdf[unit]
            width = cdf[unit + 1] - lo
            u_re = torch.clamp(torch.where(
                width > 0, (u - lo) / torch.where(width > 0, width, 1.0),
                0.0), 0.0, 1.0 - 1e-7)
            off, cnt = self.unit_offset[unit], self.unit_count[unit]
            lo_i = torch.zeros_like(off)
            hi_i = torch.clamp(cnt - 1, min=0)
            top = hi_i
            for _ in range(20):
                mid = (lo_i + hi_i + 1) // 2
                val = self.tri_cdf[off + torch.minimum(mid, top)]
                right = (val <= u_re) & (mid <= hi_i)
                lo_i = torch.where(right, mid, lo_i)
                hi_i = torch.where(right, hi_i, mid - 1)
            return off + lo_i
        n = torch.full(u.shape, n_units, dtype=torch.int64, device=u.device)
        unit, u_re = self._alias(self.unit_alias_prob, self.unit_alias,
                                 torch.zeros_like(n), n, u)
        off, cnt = self.unit_offset[unit], self.unit_count[unit]
        local, _ = self._alias(self.tri_alias_prob, self.tri_alias, off, cnt,
                               u_re)
        return off + local

    def sample_light(self, u_sel, u0, u1):
        """(position, normal, emittance, area pdf) of a light sample."""
        tri = self.select_light(u_sel)
        b_a, b_b = 0.5 * u0, 0.5 * u1
        off = b_b - b_a
        b_b2 = torch.where(off > 0, b_b + off, b_b)
        b_a2 = torch.where(off > 0, b_a, b_a - off)
        b_c = 1.0 - b_a2 - b_b2
        pos = (self.p0[tri] + b_b2[..., None] * self.e1[tri]
               + b_c[..., None] * self.e2[tri])
        n = self.n[tri]
        nrm = (b_a2[..., None] * n[:, 0] + b_b2[..., None] * n[:, 1]
               + b_c[..., None] * n[:, 2])
        nrm = nrm / torch.clamp(torch.sqrt((nrm * nrm).sum(-1, keepdim=True)),
                                min=1e-20)
        emit = self.emittance[self.unit_material[self.unit[tri]]]
        pdf = self.area_pdf[tri] if self.surface_ok else torch.zeros_like(u0)
        return pos, nrm, emit, pdf

    def material_params(self, mat):
        return dict(diffuse=self.diffuse[mat], f0=self.f0[mat],
                    roughness=self.roughness[mat], lambert=self.lambert[mat])
