"""The port's NRTDSM (techniques/nrtdsm.py) against gfxexp_tpu's on the same
inputs, made from numpy seeds: the cubic solver, the shell height solve,
the canonical- and texture-space ray coefficients, the prism interval, the
geometry build (and its prism BVH from 2,048 base triangles), from_numpy,
the exact curved-ray tests, and the three intersectors (the per-triangle
oracle, v2 over the slab sweep and over the prism BVH, the exact
two-triangle one ordered and flat), on patches with radially tilted vertex
normals (curved shells).

Bars, held two ways:
- against JAX as the tests run it, whose XLA CPU backend contracts
  multiply-adds into FMAs: the coefficients within 1e-5 relative; the
  cubic solver's found flags equal and its roots within 1e-5 on >= 0.995
  of cubics (a scan sample beside a root can take the other sign and
  bracket another root); the intersectors' hits equal on
  >= 0.995 of rays and t within rtol 1e-4 on >= 0.97 of the rays that both
  hit (1e-3 on all), prims equal where both hit, uv within 1e-3 there;
- against the same JAX functions compiled without FMA: bit for bit
  (tests/test_torch_nrtdsm_nofma.py).
The build is bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfxexp_torch.scene.types import from_numpy
from gfxexp_torch.techniques import nrtdsm as TN
from gfxexp_torch.techniques import shell as TS
from gfxexp_torch.techniques import tfdm as TT
from gfxexp_torch.utils import trace
from gfxexp_tpu.apps.tfdm import procedural_height, subdivided_plane
from gfxexp_tpu.techniques import nrtdsm as JN
from gfxexp_tpu.techniques import shell as JS
from gfxexp_tpu.techniques import tfdm as JT

torch.set_num_threads(2)


# the shared inputs of the NRTDSM and shell tests (test_torch_shell.py and
# test_torch_nrtdsm_nofma.py import them)


def mesh(base, tilt=0.3):
    """The tfdm app's patch of 2 x base^2 triangles, its vertex normals
    tilted radially (the nrtdsm app's -normal-tilt)."""
    pos, idx, uvs, nrm = subdivided_plane(base)
    radial = pos * np.asarray([[1.0, 0.0, 1.0]], np.float32)
    nrm = nrm + tilt * radial
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                           1e-12)
    return pos, idx, uvs, nrm


def nrtdsm_geoms(base, size=32, lit=2, tilt=0.3, packages="jt", **kw):
    """NRTDSMGeometry of the patch from JAX ("j") and the port ("t")."""
    pos, idx, uvs, nrm = mesh(base, tilt)
    h = procedural_height(size, "ridges")
    out = []
    for pkg in packages:
        N, T = (JN, JT) if pkg == "j" else (TN, TT)
        out.append(N.build_nrtdsm_geometry(
            pos, idx, uvs, h, normals=nrm,
            params=T.DisplacementParameters(
                h_scale=0.25, local_intersection_type=lit, **kw)))
    return tuple(out)


def box_mesh(lo, hi):
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]],
                       np.float32)
    faces = np.array([
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]], np.int32)
    return corners, faces


def shell_contents(grid=3):
    """grid x grid boxes of two heights in (u, v, hn), a material slot
    each box (0, 1, 2 in turn)."""
    pos, idx, mats = [], [], []
    cell = 1.0 / grid
    for i in range(grid):
        for j in range(grid):
            top = 0.45 if (i + j) % 2 else 0.8
            c, f = box_mesh([i * cell + 0.1 * cell, j * cell + 0.15 * cell,
                             0.05], [(i + 0.8) * cell, (j + 0.9) * cell, top])
            idx.append(f + 8 * len(pos))
            pos.append(c)
            mats.append(np.full(len(f), (i * grid + j) % 3, np.int32))
    return np.concatenate(pos), np.concatenate(idx), np.concatenate(mats)


def shell_geoms(base, tilt=0.3, h_scale=0.25, packages="jt", grid=3,
                materials=False):
    """ShellGeometry of the patch over shell_contents(grid) from JAX ("j")
    and the port ("t")."""
    pos, idx, uvs, nrm = mesh(base, tilt)
    spos, sidx, smat = shell_contents(grid)
    out = []
    for pkg in packages:
        S, T = (JS, JT) if pkg == "j" else (TS, TT)
        out.append(S.build_shell_geometry(
            pos, idx, uvs, spos, sidx,
            params=T.DisplacementParameters(h_scale=h_scale), normals=nrm,
            material=5, shell_materials=smat if materials else None))
    return tuple(out)


def rays(n, seed):
    """Rays from above the 2x2 patch toward it, a third of them grazing."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-1, 1, n), rng.uniform(0.5, 2, n),
                  rng.uniform(-1, 1, n)], -1).astype(np.float32)
    tgt = np.stack([rng.uniform(-1, 1, n), np.zeros(n),
                    rng.uniform(-1, 1, n)], -1)
    d = tgt - o
    d[: n // 3, 1] *= 0.05
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def find_height_inputs(conv, n=500):
    """A patch's prism attributes by random base triangle, points around
    the shell and the height range, through conv (jnp.asarray or
    torch.from_numpy): find_height's arguments."""
    pos, idx, uvs, nrm = mesh(2)
    rng = np.random.default_rng(2)
    b = rng.integers(0, len(idx), n)
    x = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.1, 0.3, n),
                  rng.uniform(-1, 1, n)], -1).astype(np.float32)
    corners = [pos[idx[b, i]] for i in range(3)]
    normals = [nrm[idx[b, i]].astype(np.float32) for i in range(3)]
    lo = np.full(n, -0.05, np.float32)
    hi = np.full(n, 0.3, np.float32)
    return tuple(conv(np.ascontiguousarray(a)) for a in (
        *corners, *normals, x, lo, hi))


def _close(t, j, rel=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=rel * max(np.abs(j).max(), 1.0))


def _compare(jh, th):
    jhit, thit = np.asarray(jh.hit), th.hit.numpy()
    assert (jhit == thit).mean() >= 0.995
    both = jhit & thit
    assert both.sum() > 20
    jt, tt = np.asarray(jh.t)[both], th.t.numpy()[both]
    rel = np.abs(jt - tt) / np.abs(jt)
    assert (rel <= 1e-4).mean() >= 0.97
    assert rel.max() <= 1e-3, rel.max()
    np.testing.assert_array_equal(np.asarray(jh.prim)[both],
                                  th.prim.numpy()[both])
    assert np.abs(np.asarray(jh.uv)[both] - th.uv.numpy()[both]).max() <= 1e-3


def _cubics(n, seed):
    """Cubics with roots spread over [-1, 1] and intervals around them."""
    rng = np.random.default_rng(seed)
    roots = rng.uniform(-1, 1, (n, 3))
    lead = rng.uniform(0.5, 2, n) * rng.choice([-1, 1], n)
    r1, r2, r3 = roots.T
    k = np.stack([-lead * r1 * r2 * r3,
                  lead * (r1 * r2 + r1 * r3 + r2 * r3),
                  -lead * (r1 + r2 + r3), lead], -1).astype(np.float32)
    lo = rng.uniform(-1.2, 0, n).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 1.5, n)).astype(np.float32)
    return k, lo, hi


def test_solve_cubic_matches_jax():
    k, lo, hi = _cubics(2000, 1)
    for n_scan in (8, 16):
        tr, tf = TN.solve_cubic_in_interval(
            torch.from_numpy(k), torch.from_numpy(lo), torch.from_numpy(hi),
            n_scan=n_scan)
        jr, jf = JN.solve_cubic_in_interval(jnp.asarray(k), jnp.asarray(lo),
                                            jnp.asarray(hi), n_scan=n_scan)
        assert (tf.numpy() == np.asarray(jf)).mean() >= 0.995
        assert tf.numpy().mean() > 0.5
        # a scan sample next to a root can take the other sign under FMA
        # and so bracket another root
        jr = np.asarray(jr)
        err = np.abs(tr.numpy() - jr) / np.maximum(np.abs(jr), 1.0)
        assert (err <= 1e-5).mean() >= 0.995


def test_find_height_and_coefficients_match_jax():
    jg, tg = nrtdsm_geoms(2)
    rng = np.random.default_rng(2)
    n = 500
    b = rng.integers(0, 8, n)
    x = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.1, 0.3, n),
                  rng.uniform(-1, 1, n)], -1).astype(np.float32)
    ta = [getattr(tg, f)[torch.from_numpy(b)] for f in (
        "p0", "p1", "p2", "n0", "n1", "n2")]
    ja = [getattr(jg, f)[b] for f in ("p0", "p1", "p2", "n0", "n1", "n2")]
    _close(TN.height_cubic_coeffs(*ta, torch.from_numpy(x)),
           JN.height_cubic_coeffs(*ja, jnp.asarray(x)))
    lo = np.full(n, tg.h_lo, np.float32)
    hi = np.full(n, tg.h_hi, np.float32)
    th = TN.find_height(*ta, torch.from_numpy(x), torch.from_numpy(lo),
                        torch.from_numpy(hi))
    jh = JN.find_height(*ja, jnp.asarray(x), jnp.asarray(lo),
                        jnp.asarray(hi))
    np.testing.assert_array_equal(th[3].numpy(), np.asarray(jh[3]))
    for t, j in zip(th[:3], jh[:3]):
        _close(t, j, 1e-4)
    _close(TN.shell_point(*ta, *th[1:3], th[0]),
           JN.shell_point(*ja, *jh[1:3], jh[0]), 1e-4)
    # the ray coefficients, in a basis orthogonal to random directions
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    e0 = np.cross(d, [0.0, 1.0, 0.0]).astype(np.float32)
    e0 /= np.linalg.norm(e0, axis=-1, keepdims=True)
    e1 = np.cross(d, e0).astype(np.float32)
    tc = TN.compute_canonical_space_ray_coeffs(
        torch.from_numpy(x), torch.from_numpy(e0), torch.from_numpy(e1), *ta)
    jc = JN.compute_canonical_space_ray_coeffs(
        jnp.asarray(x), jnp.asarray(e0), jnp.asarray(e1), *ja)
    for t, j in zip(tc, jc):
        _close(t, j)
    tuv = [tg.uv0[torch.from_numpy(b)], tg.uv1[torch.from_numpy(b)],
           tg.uv2[torch.from_numpy(b)]]
    juv = [jg.uv0[b], jg.uv1[b], jg.uv2[b]]
    for t, j in zip(TN.compute_texture_space_ray_coeffs(*tuv, *tc),
                    JN.compute_texture_space_ray_coeffs(*juv, *jc)):
        _close(t, j)


def test_prism_interval_matches_jax():
    jg, tg = nrtdsm_geoms(1)
    o, d = rays(300, 3)
    for b in range(2):
        ta = [getattr(tg, f)[b] for f in ("p0", "p1", "p2", "n0", "n1",
                                          "n2")]
        ja = [getattr(jg, f)[b] for f in ("p0", "p1", "p2", "n0", "n1",
                                          "n2")]
        tr = TN.test_ray_vs_prism(torch.from_numpy(o), torch.from_numpy(d),
                                  *ta, tg.h_lo, tg.h_hi,
                                  torch.full((300,), 1e-4),
                                  torch.full((300,), 1e30))
        jr = JN.test_ray_vs_prism(jnp.asarray(o), jnp.asarray(d), *ja,
                                  jg.h_lo, jg.h_hi, jnp.full((300,), 1e-4),
                                  jnp.full((300,), 1e30))
        for t, j in zip(tr, jr):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def bvh_geoms():
    """2,048 base triangles (-base-res 32): the prism BVH's broad phase."""
    return nrtdsm_geoms(32, 64)


@pytest.mark.parametrize("case", ["plain", "two_triangle_uv", "bvh"])
def test_build_matches_jax(case, bvh_geoms):
    if case == "bvh":
        jg, tg = bvh_geoms
    elif case == "plain":
        jg, tg = nrtdsm_geoms(4)
    else:
        jg, tg = nrtdsm_geoms(4, 64, lit=1, h_offset=0.05, h_bias=0.2,
                        uv_scale=1.5, uv_rotation=0.3)
    fields = ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
              "height")
    for f in fields:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_array_equal(tg.minmax.levels.numpy(),
                                  np.asarray(jg.minmax.levels))
    assert (tg.h_lo, tg.h_hi, tg.material) == (jg.h_lo, jg.h_hi,
                                               jg.material)
    assert (tg.prism_bvh is None) == (jg.prism_bvh is None) == (
        case != "bvh")
    if case == "bvh":
        jskip, jperm = jg.prism_bvh
        for f in ("aabb_min", "aabb_max", "first", "count", "skip"):
            np.testing.assert_array_equal(
                getattr(tg.prism_bvh.skip, f).numpy(),
                np.asarray(getattr(jskip, f)), err_msg=f)
        np.testing.assert_array_equal(tg.prism_bvh.perm.numpy(),
                                      np.asarray(jperm))
    fg = from_numpy(jg)
    assert isinstance(fg, TN.NRTDSMGeometry)
    for f in fields:
        assert torch.equal(getattr(fg, f), getattr(tg, f)), f
    assert fg.params == tg.params and (fg.h_lo, fg.h_hi) == (tg.h_lo,
                                                             tg.h_hi)
    if case == "bvh":
        assert torch.equal(fg.prism_bvh.skip.node_pack,
                           tg.prism_bvh.skip.node_pack)


def test_intersect_nrtdsm_v1_matches_jax():
    jg, tg = nrtdsm_geoms(1)
    o, d = rays(200, 5)
    jh = JN.intersect_nrtdsm(jg, jnp.asarray(o), jnp.asarray(d))
    th = TN.intersect_nrtdsm(tg, torch.from_numpy(o), torch.from_numpy(d))
    _compare(jh, th)
    np.testing.assert_array_equal(np.asarray(jh.steps), th.steps.numpy())


@pytest.mark.parametrize("case", ["v2", "v2_uv_transform", "exact",
                                  "exact_flat"])
def test_intersectors_match_jax(case):
    kw = {}
    if case == "v2_uv_transform":
        kw = dict(uv_scale=1.3, uv_rotation=0.2, uv_offset=(0.1, -0.2))
    lit = 1 if case.startswith("exact") else 2
    jg, tg = nrtdsm_geoms(3, 32, lit=lit, **kw)
    o, d = rays(300, 6)
    if case.startswith("exact"):
        ordered = case == "exact"
        jh = JN.intersect_nrtdsm_exact(jg, jnp.asarray(o), jnp.asarray(d),
                                       ordered=ordered)
        trace.reset_counters("tfdm.")
        th = TN.intersect_nrtdsm_exact(tg, torch.from_numpy(o),
                                       torch.from_numpy(d), ordered=ordered)
        assert (trace.counters("tfdm.").get("tfdm.exact_iterations", 0)
                > 0) == ordered
    else:
        jh = JN.intersect_nrtdsm_v2(jg, jnp.asarray(o), jnp.asarray(d))
        th = TN.intersect_nrtdsm_v2(tg, torch.from_numpy(o),
                                    torch.from_numpy(d))
    _compare(jh, th)
    assert (np.asarray(jh.steps) == th.steps.numpy()).mean() >= 0.995


def test_intersect_v2_prism_bvh_matches_jax(bvh_geoms):
    jg, tg = bvh_geoms
    o, d = rays(150, 7)
    trace.reset_counters("tfdm.")
    jh = JN.intersect_nrtdsm_v2(jg, jnp.asarray(o), jnp.asarray(d))
    th = TN.intersect_nrtdsm_v2(tg, torch.from_numpy(o), torch.from_numpy(d))
    assert trace.counters("tfdm.").get("tfdm.bvh_iterations", 0) > 0
    _compare(jh, th)


def test_nonlinear_ray_tests_match_jax():
    """nonlinear_ray_vs_aabb (affine bounds) and
    nonlinear_ray_vs_micro_triangle (the exact cubic) on the texture-space
    curves of random rays through a tilted prism."""
    jg, tg = nrtdsm_geoms(1, lit=1)
    rng = np.random.default_rng(9)
    n = 400
    o, d = rays(n, 9)
    up = np.where((np.abs(d[:, 0]) < 0.8)[:, None], [1.0, 0, 0], [0, 1.0, 0])
    e0 = np.cross(d, up)
    e0 = (e0 / np.linalg.norm(e0, axis=-1, keepdims=True)).astype(np.float32)
    e1 = np.cross(d, e0).astype(np.float32)
    ta = [getattr(tg, f)[0] for f in ("p0", "p1", "p2", "n0", "n1", "n2")]
    ja = [getattr(jg, f)[0] for f in ("p0", "p1", "p2", "n0", "n1", "n2")]
    tc = TN.compute_canonical_space_ray_coeffs(
        torch.from_numpy(o), torch.from_numpy(e0), torch.from_numpy(e1), *ta)
    jc = JN.compute_canonical_space_ray_coeffs(
        jnp.asarray(o), jnp.asarray(e0), jnp.asarray(e1), *ja)
    tt = TN.compute_texture_space_ray_coeffs(tg.uv0[0], tg.uv1[0],
                                             tg.uv2[0], *tc)
    jt = JN.compute_texture_space_ray_coeffs(jg.uv0[0], jg.uv1[0],
                                             jg.uv2[0], *jc)
    h_lo = np.full(n, tg.h_lo, np.float32)
    h_hi = np.full(n, tg.h_hi, np.float32)
    box_lo = rng.uniform(0, 0.8, (n, 3)).astype(np.float32)
    box_lo[:, 2] = rng.uniform(-0.05, 0.2, n)
    box_hi = (box_lo + rng.uniform(0.02, 0.3, (n, 3))).astype(np.float32)
    tov = TN.nonlinear_ray_vs_aabb(*tt, *tc[3:], torch.from_numpy(h_lo),
                                   torch.from_numpy(h_hi),
                                   torch.from_numpy(box_lo),
                                   torch.from_numpy(box_hi))
    jov = JN.nonlinear_ray_vs_aabb(*jt, *jc[3:], jnp.asarray(h_lo),
                                   jnp.asarray(h_hi), jnp.asarray(box_lo),
                                   jnp.asarray(box_hi))
    assert (tov.numpy() == np.asarray(jov)).mean() >= 0.995
    assert 0.05 < tov.numpy().mean() < 0.95
    tri = rng.uniform(0, 1, (n, 3, 3)).astype(np.float32)
    tri[..., 2] = rng.uniform(0.0, 0.2, (n, 3))
    tm = TN.nonlinear_ray_vs_micro_triangle(
        *tt, *tc[3:], *(torch.from_numpy(tri[:, i]) for i in range(3)),
        torch.from_numpy(h_lo), torch.from_numpy(h_hi))
    jm = JN.nonlinear_ray_vs_micro_triangle(
        *jt, *jc[3:], *(jnp.asarray(tri[:, i]) for i in range(3)),
        jnp.asarray(h_lo), jnp.asarray(h_hi))
    hit_t, hit_j = tm[0].numpy(), np.asarray(jm[0])
    assert (hit_t == hit_j).mean() >= 0.995
    both = hit_t & hit_j
    assert both.sum() > 10
    _close(tm[1][torch.from_numpy(both)], np.asarray(jm[1])[both], 1e-4)
