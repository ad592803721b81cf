"""The port's shading modules against gfxexp_tpu's on the same inputs: BSDF
sample / evaluate / pdf, light sampling and pdfs, the 2D environment
distribution, and the surface-point / frame math of the tracer."""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch.core import distributions as tdist  # noqa: E402
from gfxexp_torch.core import math as tmath  # noqa: E402
from gfxexp_torch.render import bsdf as tbsdf  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.scene import lights as tlights  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_tpu.core import distributions as jdist  # noqa: E402
from gfxexp_tpu.core import math as jmath  # noqa: E402
from gfxexp_tpu.render import bsdf as jbsdf  # noqa: E402
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.scene import lights as jlights  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(1)
N = 4096
TOL = dict(rtol=2e-5, atol=2e-6)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, ref, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **(kw or TOL))


def _dirs(rng, n, upper=False):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return v


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    diffuse = rng.random((N, 3), np.float32)
    f0 = (rng.random((N, 3)) * 0.5).astype(np.float32)
    rough = rng.uniform(0.05, 0.999, N).astype(np.float32)
    lam = rng.random(N) < 0.3
    jp = jbsdf.BSDFParams(diffuse=jnp.asarray(diffuse), f0=jnp.asarray(f0),
                          roughness=jnp.asarray(rough),
                          is_lambert=jnp.asarray(lam))
    tp = tbsdf.BSDFParams(diffuse=_t(diffuse), f0=_t(f0), roughness=_t(rough),
                          is_lambert=_t(lam))
    return jp, tp, rng


def test_bsdf_sample_matches_jax(params):
    jp, tp, rng = params
    v = _dirs(rng, N)
    u0, u1 = rng.random((2, N), np.float32)
    jl, jf, jpdf = jbsdf.bsdf_sample(jp, jnp.asarray(v), jnp.asarray(u0),
                                     jnp.asarray(u1))
    tl, tf, tpdf = tbsdf.bsdf_sample(tp, _t(v), _t(u0), _t(u1))
    _close(tl, jl, rtol=1e-4, atol=1e-5)
    _close(tf, jf, rtol=1e-4, atol=1e-5)
    _close(tpdf, jpdf, rtol=1e-4, atol=1e-5)


def test_bsdf_evaluate_and_pdf_match_jax(params):
    jp, tp, rng = params
    v, w = _dirs(rng, N), _dirs(rng, N)
    _close(tbsdf.bsdf_evaluate(tp, _t(v), _t(w)),
           jbsdf.bsdf_evaluate(jp, jnp.asarray(v), jnp.asarray(w)),
           rtol=1e-4, atol=1e-6)
    _close(tbsdf.bsdf_pdf(tp, _t(v), _t(w)),
           jbsdf.bsdf_pdf(jp, jnp.asarray(v), jnp.asarray(w)),
           rtol=1e-4, atol=1e-6)


def test_frame_and_offset_match_jax():
    rng = np.random.default_rng(1)
    n = _dirs(rng, N)
    v = _dirs(rng, N)
    jt, jb = jmath.make_frame(jnp.asarray(n))
    tt, tb = tmath.make_frame(_t(n))
    _close(tt, jt)
    _close(tb, jb)
    _close(tmath.to_local(tt, tb, _t(n), _t(v)),
           jmath.to_local(jt, jb, jnp.asarray(n), jnp.asarray(v)))
    p = (rng.normal(size=(N, 3)) * np.array([1.0, 1e-3, 10.0])).astype(
        np.float32)
    np.testing.assert_array_equal(
        tmath.offset_ray_origin(_t(p), _t(n)).numpy(),
        np.asarray(jmath.offset_ray_origin(jnp.asarray(p), jnp.asarray(n))))


def test_continuous_2d_matches_jax():
    rng = np.random.default_rng(2)
    imp = (rng.random((16, 32)) ** 3).astype(np.float32)
    jd = jdist.build_continuous_2d(imp)
    td = tdist.build_continuous_2d(imp)
    _close(td.pdf, jd.pdf, rtol=1e-5)
    _close(td.marginal_cdf, jd.marginal_cdf, atol=1e-6)
    u0, u1 = rng.random((2, N), np.float32)
    ju, jv, jpdf = jdist.sample_continuous_2d(jd, jnp.asarray(u0),
                                              jnp.asarray(u1))
    tu, tv, tpdf = tdist.sample_continuous_2d(td, _t(u0), _t(u1))
    # the CDFs are cumulative sums taken in a different order by XLA and
    # torch; the in-bin offset divides their ulp-level difference by a bin
    # width, so (u, v) agree to 1e-3, not to float precision
    _close(tu, ju, atol=1e-3)
    _close(tv, jv, atol=1e-3)
    _close(tpdf, jpdf, rtol=1e-4)
    _close(tdist.continuous_2d_pdf(td, tu, tv),
           jdist.continuous_2d_pdf(jd, ju, jv), rtol=1e-4)
    p, prob, alias, _ = tdist.vose_alias_arrays(imp.ravel())
    jp_, jprob, jalias, _ = jdist.vose_alias_arrays(imp.ravel())
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(alias, jalias)


@pytest.fixture(scope="module")
def lit_scene():
    """Box with a ceiling light plus an environment: both light families."""
    env = (np.random.default_rng(3).random((8, 16, 3)) + 0.2).astype(
        np.float32)

    def make(mod):
        b = S.box_scene(mod)
        b.set_environment(env, power_coeff=0.7, rotation=0.3)
        return b

    js, _ = jcompile(make(JB), traversal="widerow")
    ts, _ = tcompile(make(TB), traversal="widerow")
    return js, ts


def test_light_sampling_matches_jax(lit_scene):
    js, ts = lit_scene
    jpk = jlights.pack_light_rows(js)
    tpk = tlights.pack_light_rows(ts)
    _close(tpk, jpk)
    rng = np.random.default_rng(4)
    ul, u0, u1 = rng.random((3, N), np.float32)
    jl = jlights.sample_light(js, jnp.asarray(ul), jnp.asarray(u0),
                              jnp.asarray(u1), packed=jpk)
    tl = tlights.sample_light(ts, _t(ul), _t(u0), _t(u1), tpk)
    np.testing.assert_array_equal(tl.at_infinity.numpy(),
                                  np.asarray(jl.at_infinity))
    for f in ("position", "normal", "emittance", "pdf"):
        _close(getattr(tl, f), getattr(jl, f), rtol=1e-4, atol=1e-5)
    d = _dirs(rng, N)
    _close(tlights.env_radiance(ts.env, _t(d)),
           jlights.env_radiance(js.env, jnp.asarray(d)), rtol=1e-4, atol=1e-5)
    _close(tlights.env_pdf(ts.env, _t(d)),
           jlights.env_pdf(js.env, jnp.asarray(d)), rtol=1e-4, atol=1e-5)
    tri = rng.integers(0, ts.num_triangles, N)
    _close(tlights.surface_light_pdf(ts, _t(tri)),
           jlights.surface_light_pdf(js, jnp.asarray(tri)))
    for a, b in zip(tlights.light_selection_probs(ts),
                    jlights.light_selection_probs(js)):
        _close(a, b)


def test_light_selection_cdf_branch_matches_alias_pmf(lit_scene):
    """Without the alias tables the selection falls back to CDF search;
    both pick triangles with the same probabilities."""
    _, ts = lit_scene
    u = _t(np.random.default_rng(5).random(20000, np.float32))
    _, pos_alias, _ = tlights._select_light_pos(ts, u)
    units = ts.units
    no_alias = dataclasses.replace(
        ts, light_unit_alias_prob=None, light_unit_alias_idx=None,
        units=dataclasses.replace(units, light_tri_alias_prob=None,
                                  light_tri_alias_local=None))
    _, pos_cdf, _ = tlights._select_light_pos(no_alias, u)
    n = units.light_tri_index.shape[0]
    ha = torch.bincount(pos_alias, minlength=n).float() / u.numel()
    hc = torch.bincount(pos_cdf, minlength=n).float() / u.numel()
    assert (ha - hc).abs().max() < 0.02


def test_surface_point_matches_jax(lit_scene):
    js, ts = lit_scene
    rng = np.random.default_rng(6)
    tri = rng.integers(-1, ts.num_triangles, N).astype(np.int32)
    u, v = rng.random((2, N), np.float32) * 0.5
    jpk = jpt.pack_tri_attrs(js.triangles, js)
    tpk = tpt.pack_tri_attrs(ts.triangles, ts)
    np.testing.assert_allclose(tpk.numpy()[:, 25:], np.asarray(jpk)[:, 25:],
                               rtol=1e-6)
    jsp = jpt.compute_surface_point(js, jnp.asarray(tri), jnp.asarray(u),
                                    jnp.asarray(v), packed=jpk)
    tsp = tpt.compute_surface_point(ts, _t(tri), _t(u), _t(v), packed=tpk)
    for f in ("position", "geom_normal", "shading_normal", "texcoord",
              "tangent", "emittance"):
        _close(getattr(tsp, f), getattr(jsp, f), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tsp.material.numpy(),
                                  np.asarray(jsp.material))
