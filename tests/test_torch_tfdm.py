"""The port's TFDM (techniques/tfdm.py) against gfxexp_tpu's on the same
inputs, made from numpy seeds: the min/max pyramid (footprints 2 and 4),
the geometry build (prism AABBs, the texture transform, the prism BVH over
2,048 prisms), sample_height for the four local surface types, the first
intersector, the candidate iterator, and intersect_tfdm_v2 (conservative
or not, the full pyramid or three levels, the slab sweep and the prism
BVH's walk).

Bars. The build is bit-equal. The queries are held two ways:
- against JAX as the tests run it, whose XLA CPU backend contracts
  multiply-adds into FMAs: hits agree on >= 0.995 of rays; where both hit,
  uv within 1e-4 and normals within 1e-3 (B-spline and the smooth types;
  the box surface steps: see below), t within rtol 1e-4 on >= 0.97 of
  them and within 1e-3 on all; steps equal on >= 0.5 of rays, within 2 on
  >= 0.9, and the mean within 2%. Each march step lands 1e-7 past a texel
  edge, about one ulp of the grid coordinate, so a rounding of its own
  moves a step's landing across the edge and adds or saves a step, and
  the final bisection then brackets from another start (the cause of
  ROADMAP Queue C's TFDM entry);
- against the same JAX functions compiled without FMA (a subprocess with
  XLA_FLAGS=--xla_cpu_max_isa=SSE4_2): t, uv, prim, hit and steps equal
  bit for bit, normals within 2e-6.
The box surface's t within rtol 1e-4 on >= 0.95 and 5e-2 on all (its
height steps at texel edges). sample_height within 1e-6 (box: equal but
where the grid coordinate's rounding crosses a texel edge, at most 1 in
1,000 rays).
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfxexp_torch.techniques import tfdm as T
from gfxexp_torch.scene.types import from_numpy
from gfxexp_torch.utils import trace
from gfxexp_tpu.apps.tfdm import procedural_height, subdivided_plane
from gfxexp_tpu.techniques import tfdm as J

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LITS = {"box": T.LOCAL_INTERSECTION_BOX,
        "two_triangle": T.LOCAL_INTERSECTION_TWO_TRIANGLE,
        "bilinear": T.LOCAL_INTERSECTION_BILINEAR,
        "bspline": T.LOCAL_INTERSECTION_BSPLINE}


def _params(mod, lit=T.LOCAL_INTERSECTION_BILINEAR, **kw):
    return mod.DisplacementParameters(h_scale=0.25,
                                      local_intersection_type=lit, **kw)


def _geoms(base, size=64, lit=T.LOCAL_INTERSECTION_BILINEAR, kind="ridges",
           **kw):
    pos, idx, uvs, nrm = subdivided_plane(base)
    h = procedural_height(size, kind)
    return (J.build_tfdm_geometry(pos, idx, uvs, h, params=_params(J, lit,
                                                                   **kw),
                                  normals=nrm),
            T.build_tfdm_geometry(pos, idx, uvs, h, params=_params(T, lit,
                                                                   **kw),
                                  normals=nrm))


def _rays(n, seed):
    """Rays from above the 2x2 plane toward it, a third of them grazing."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-1, 1, n), rng.uniform(0.5, 2, n),
                  rng.uniform(-1, 1, n)], -1).astype(np.float32)
    tgt = np.stack([rng.uniform(-1, 1, n), np.zeros(n),
                    rng.uniform(-1, 1, n)], -1)
    d = tgt - o
    d[: n // 3, 1] *= 0.05
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _np(x):
    return np.asarray(x)


def _compare(jh, th, smooth=True):
    """The bars of the module docstring; `smooth=False` (the box surface,
    whose height steps at texel edges, so a step's rounding can move a hit
    to the next box) takes t within rtol 1e-4 on >= 0.95 and 5e-2 on all,
    and no uv or normal bar."""
    jhit, thit = _np(jh.hit), th.hit.numpy()
    assert (jhit == thit).mean() >= 0.995
    both = jhit & thit
    assert both.sum() > 20
    jt, tt = _np(jh.t)[both], th.t.numpy()[both]
    rel = np.abs(jt - tt) / np.abs(jt)
    assert (rel <= 1e-4).mean() >= (0.97 if smooth else 0.95)
    assert rel.max() <= (1e-3 if smooth else 5e-2), rel.max()
    if smooth:
        assert np.abs(_np(jh.uv)[both] - th.uv.numpy()[both]).max() <= 1e-4
        assert np.abs(_np(jh.normal)[both]
                      - th.normal.numpy()[both]).max() <= 1e-3
    js, ts = _np(jh.steps), th.steps.numpy()
    assert (js == ts).mean() >= 0.5
    assert (np.abs(js - ts) <= 2).mean() >= 0.9
    assert abs(ts.mean() - js.mean()) <= 0.02 * js.mean()


@pytest.mark.parametrize("footprint", [2, 4])
def test_minmax_pyramid_matches_jax(footprint):
    h = np.random.default_rng(footprint).random((32, 32)).astype(np.float32)
    jm = J.build_minmax_mipmap(h, footprint=footprint)
    tm = T.build_minmax_mipmap(h, footprint=footprint)
    assert (tm.base_size, tm.n_levels) == (jm.base_size, jm.n_levels) == (
        32, 6)
    np.testing.assert_array_equal(tm.levels.numpy(), _np(jm.levels))


GEOMETRY_CASES = {
    "bilinear": dict(lit=LITS["bilinear"]),
    "bspline": dict(lit=LITS["bspline"]),
    "uv_transform": dict(lit=LITS["bilinear"], uv_scale=1.7,
                         uv_rotation=0.4, uv_offset=(0.1, -0.3)),
    "offset_bias": dict(lit=LITS["two_triangle"], h_offset=0.05,
                        h_bias=0.2),
}


@pytest.mark.parametrize("case", list(GEOMETRY_CASES))
def test_build_geometry_matches_jax(case):
    kw = dict(GEOMETRY_CASES[case])
    lit = kw.pop("lit")
    jg, tg = _geoms(6, 64, lit, **kw)
    for f in ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
              "height", "aabb_min", "aabb_max"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      _np(getattr(jg, f)), err_msg=f)
    np.testing.assert_array_equal(tg.minmax.levels.numpy(),
                                  _np(jg.minmax.levels))
    assert tg.prism_bvh is None and jg.prism_bvh is None
    fg = from_numpy(jg)
    for f in ("aabb_min", "height", "uv2"):
        assert torch.equal(getattr(fg, f), getattr(tg, f))
    assert fg.params == tg.params and fg.material == tg.material


@pytest.fixture(scope="module")
def bvh_geoms():
    """2,048 prisms (-base-res 32): the prism BVH's broad phase."""
    return _geoms(32, 128)


def test_prism_bvh_matches_jax(bvh_geoms):
    jg, tg = bvh_geoms
    jskip, jperm = jg.prism_bvh
    skip = tg.prism_bvh.skip
    for f in ("aabb_min", "aabb_max", "first", "count", "skip"):
        np.testing.assert_array_equal(getattr(skip, f).numpy(),
                                      _np(getattr(jskip, f)), err_msg=f)
    np.testing.assert_array_equal(tg.prism_bvh.perm.numpy(), _np(jperm))
    fg = from_numpy(jg)
    assert torch.equal(fg.prism_bvh.perm, tg.prism_bvh.perm)
    assert torch.equal(fg.prism_bvh.skip.node_pack, skip.node_pack)


@pytest.mark.parametrize("lit", list(LITS))
def test_sample_height_matches_jax(lit):
    jg, tg = _geoms(2, 32, LITS[lit])
    uv = np.random.default_rng(3).uniform(-1.5, 2.5, (1000, 2)).astype(
        np.float32)
    jh = _np(J.sample_height(jg, jnp.asarray(uv)))
    th = T.sample_height(tg, torch.from_numpy(uv)).numpy()
    if lit == "box":
        assert (jh != th).mean() <= 1e-3
    else:
        np.testing.assert_allclose(th, jh, rtol=0, atol=1e-6)


def test_intersect_tfdm_v1_matches_jax():
    jg, tg = _geoms(2, 32)
    o, d = _rays(200, 5)
    jh = J.intersect_tfdm(jg, jnp.asarray(o), jnp.asarray(d))
    th = T.intersect_tfdm(tg, torch.from_numpy(o), torch.from_numpy(d))
    assert (_np(jh.prim) == th.prim.numpy()).mean() >= 0.995
    _compare(jh, th)


V2_CASES = {
    "conservative_full": dict(),
    "conservative_three_levels": dict(full_pyramid=False),
    "fixed_step_full": dict(conservative=False),
    "fixed_step_three_levels": dict(conservative=False, full_pyramid=False),
}


@pytest.fixture(scope="module")
def scan_geoms():
    return _geoms(6, 64)


@pytest.mark.parametrize("case", list(V2_CASES))
def test_intersect_tfdm_v2_matches_jax(scan_geoms, case):
    jg, tg = scan_geoms
    o, d = _rays(400, 1)
    kw = V2_CASES[case]
    jh = J.intersect_tfdm_v2(jg, jnp.asarray(o), jnp.asarray(d), **kw)
    th = T.intersect_tfdm_v2(tg, torch.from_numpy(o), torch.from_numpy(d),
                             **kw)
    _compare(jh, th)


@pytest.mark.parametrize("lit", ["box", "two_triangle", "bspline"])
def test_intersect_tfdm_v2_local_types_match_jax(lit):
    jg, tg = _geoms(6, 64, LITS[lit])
    o, d = _rays(300, 2)
    jh = J.intersect_tfdm_v2(jg, jnp.asarray(o), jnp.asarray(d))
    th = T.intersect_tfdm_v2(tg, torch.from_numpy(o), torch.from_numpy(d))
    _compare(jh, th, smooth=lit != "box")


def test_intersect_tfdm_v2_prism_bvh_matches_jax(bvh_geoms):
    jg, tg = bvh_geoms
    o, d = _rays(300, 3)
    trace.reset_counters("tfdm.")
    jh = J.intersect_tfdm_v2(jg, jnp.asarray(o), jnp.asarray(d))
    th = T.intersect_tfdm_v2(tg, torch.from_numpy(o), torch.from_numpy(d))
    assert trace.counters("tfdm.").get("tfdm.bvh_iterations", 0) > 0
    _compare(jh, th)


@pytest.mark.parametrize("walk", ["scan", "bvh"])
def test_iterate_candidates_matches_jax(walk):
    """A recording narrow phase over the candidate stream, with a small
    max_extra: the same candidates in the same rounds (ids folded into a
    hash per ray), and the same best t."""
    jg, tg = _geoms(8 if walk == "scan" else 32, 64)
    o, d = _rays(300, 7)
    n = o.shape[0]
    pb = None
    if walk == "bvh":
        pb = (J.build_prism_bvh(_np(jg.aabb_min), _np(jg.aabb_max))
              if jg.prism_bvh is None else jg.prism_bvh)

    def j_process(st, cid, near, far):
        best_t, acc = st
        hit = (cid >= 0) & (cid % 3 == 0)
        return (jnp.where(hit, jnp.minimum(best_t, far), best_t),
                acc * 31 + (cid + 2))

    def t_process(st, cid, near, far):
        best_t, acc = st
        hit = (cid >= 0) & (cid % 3 == 0)
        return (torch.where(hit, torch.minimum(best_t, far), best_t),
                acc * 31 + (cid + 2))

    for extra in (2, None):
        jt, jacc = J.iterate_candidates(
            jg.aabb_min, jg.aabb_max, jnp.asarray(o), jnp.asarray(d), 1e-4,
            1e30, 4, (jnp.full((n,), 1e30, jnp.float32),
                      jnp.zeros((n,), jnp.int32)), j_process,
            lambda st: st[0], max_extra=extra, prism_bvh=pb)
        tt, tacc = T.iterate_candidates(
            tg.aabb_min, tg.aabb_max, torch.from_numpy(o),
            torch.from_numpy(d), 1e-4, 1e30, 4,
            (torch.full((n,), 1e30), torch.zeros((n,), dtype=torch.int32)),
            t_process, lambda st: st[0], max_extra=extra,
            prism_bvh=tg.prism_bvh if walk == "bvh" else None)
        np.testing.assert_array_equal(tacc.numpy(), _np(jacc))
        np.testing.assert_array_equal(tt.numpy(), _np(jt))


_EXACT = textwrap.dedent("""
    import json, sys
    import numpy as np, jax.numpy as jnp
    from gfxexp_tpu.apps.tfdm import procedural_height, subdivided_plane
    from gfxexp_tpu.techniques import tfdm as J
    out = {}
    for name, base, size, lit, kw, seed in json.loads(sys.argv[1]):
        pos, idx, uvs, nrm = subdivided_plane(base)
        g = J.build_tfdm_geometry(
            pos, idx, uvs, procedural_height(size, "ridges"),
            params=J.DisplacementParameters(h_scale=0.25,
                                            local_intersection_type=lit),
            normals=nrm)
        rays = np.load(sys.argv[2] + f"/{name}.npz")
        h = J.intersect_tfdm_v2(g, jnp.asarray(rays["o"]),
                                jnp.asarray(rays["d"]), **kw)
        np.savez(sys.argv[2] + f"/{name}_jax.npz",
                 **{k: np.asarray(getattr(h, k)) for k in
                    ("t", "hit", "uv", "normal", "prim", "steps")})
""")

EXACT_CASES = [("bilinear", 6, 64, 2, {}, 11),
               ("fixed_step", 6, 64, 2, {"conservative": False}, 12),
               ("bspline", 6, 64, 3, {}, 13),
               ("prism_bvh", 32, 128, 2, {}, 14)]


def test_intersect_tfdm_v2_equals_jax_without_fma(tmp_path):
    """JAX compiled without FMA contraction computes what the port does:
    equal t, uv, hits, prims and steps, on the slab sweep, the fixed-step
    march, the B-spline surface and the prism BVH."""
    for name, base, size, lit, kw, seed in EXACT_CASES:
        o, d = _rays(300, seed)
        np.savez(tmp_path / f"{name}.npz", o=o, d=d)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _EXACT,
                          json.dumps(EXACT_CASES), str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    for name, base, size, lit, kw, seed in EXACT_CASES:
        jh = np.load(tmp_path / f"{name}_jax.npz")
        rays = np.load(tmp_path / f"{name}.npz")
        _, tg = _geoms(base, size, lit)
        th = T.intersect_tfdm_v2(tg, torch.from_numpy(rays["o"]),
                                 torch.from_numpy(rays["d"]), **kw)
        for k in ("t", "hit", "uv", "prim", "steps"):
            np.testing.assert_array_equal(getattr(th, k).numpy(), jh[k],
                                          err_msg=f"{name}.{k}")
        np.testing.assert_allclose(th.normal.numpy(), jh["normal"], rtol=0,
                                   atol=2e-6, err_msg=f"{name}.normal")
        assert jh["hit"].sum() > 50
