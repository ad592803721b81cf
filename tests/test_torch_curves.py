"""The port's curves (core/curves.py) against gfxexp_tpu's on the same
inputs, made from numpy seeds: the evaluators of the five curve types, the
tube tessellation, the round-linear intersector, the segment and span
builds, and the two scene-level intersectors (segments, and spans by
multi-seeded Newton).

Bars: the span build and the linear segment build equal bit for bit; the
evaluators, the tessellation and the polyline build within 2e-6 relative
(XLA sums a dot product otherwise than the port's written-out sums); the
intersectors: hits equal on >= 0.995 of rays, t within rtol 1e-4 where
both hit, prims equal on >= 0.995 of rays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfxexp_torch.core import curves as TC
from gfxexp_tpu.core import curves as JC

torch.set_num_threads(2)
TYPES = ["linear", "quadratic_bspline", "cubic_bspline", "catmull_rom",
         "bezier"]
K = {"linear": 2, "quadratic_bspline": 3, "cubic_bspline": 4,
     "catmull_rom": 4, "bezier": 4}
CP = np.array([[0, 0, 0], [1, 1.2, 0.3], [2, -0.8, -0.4], [3, 0.2, 0.5],
               [4, 1.0, 0.0], [5, -0.3, 0.2], [6, 0.6, -0.1]], np.float32)
RADII = np.array([0.22, 0.15, 0.3, 0.18, 0.25, 0.2, 0.17], np.float32)


def _close(t, j, rel=2e-6):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, rtol=0,
                               atol=rel * max(np.abs(j).max(), 1.0))


@pytest.mark.parametrize("ct", TYPES)
def test_evaluators_match_jax(ct):
    rng = np.random.default_rng(K[ct])
    n = 200
    cp = rng.normal(size=(n, K[ct], 3)).astype(np.float32)
    rr = rng.uniform(0.05, 0.3, (n, K[ct])).astype(np.float32)
    t = rng.uniform(0, 1, n).astype(np.float32)
    hit = rng.normal(size=(n, 3)).astype(np.float32)
    tp, tr = TC.evaluate(ct, torch.from_numpy(cp), torch.from_numpy(t),
                         torch.from_numpy(rr))
    jp, jr = JC.evaluate(ct, jnp.asarray(cp), jnp.asarray(t),
                         jnp.asarray(rr))
    _close(tp, jp)
    _close(tr, jr)
    _close(TC.evaluate_derivative(ct, torch.from_numpy(cp),
                                  torch.from_numpy(t)),
           JC.evaluate_derivative(ct, jnp.asarray(cp), jnp.asarray(t)))
    tn = TC.surface_normal(ct, torch.from_numpy(cp), torch.from_numpy(t),
                           torch.from_numpy(hit), torch.from_numpy(rr))
    jn = JC.surface_normal(ct, jnp.asarray(cp), jnp.asarray(t),
                           jnp.asarray(hit), jnp.asarray(rr))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("ct", ["bezier", "cubic_bspline", "linear"])
def test_tessellation_matches_jax(ct):
    cp, rr = CP[:K[ct]], RADII[:K[ct]]
    tv, tn, tf = TC.tessellate_curve(ct, cp, rr, n_axial=6, n_radial=7)
    jv, jn, jf = JC.tessellate_curve(ct, cp, rr, n_axial=6, n_radial=7)
    np.testing.assert_array_equal(tf, jf)
    _close(tv, jv)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-5)


def _rays_at(points, n, seed, spread=0.25):
    """Rays from above toward jittered points of a curve."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 5, size=(n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(2.0, 4.0, size=n)
    tgt = points[rng.integers(0, len(points), size=n)]
    tgt = tgt + rng.normal(0.0, spread, size=(n, 3))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _compare(th, jh):
    jhit, thit = np.asarray(jh.hit), th.hit.numpy()
    assert (jhit == thit).mean() >= 0.995
    both = jhit & thit
    assert both.sum() > 20
    jt = np.asarray(jh.t)[both]
    assert (np.abs(th.t.numpy()[both] - jt) <= 1e-4 * np.abs(jt)).all()
    assert (np.asarray(jh.prim) == th.prim.numpy()).mean() >= 0.995


def test_round_linear_matches_jax():
    rng = np.random.default_rng(3)
    n = 400
    p0 = rng.normal(size=(n, 3)).astype(np.float32)
    p1 = p0 + rng.normal(size=(n, 3)).astype(np.float32)
    r0 = rng.uniform(0.05, 0.4, n).astype(np.float32)
    r1 = rng.uniform(0.05, 0.4, n).astype(np.float32)
    mid = 0.5 * (p0 + p1)
    o = (mid + rng.normal(size=(n, 3)) * 3).astype(np.float32)
    d = mid + rng.normal(size=(n, 3)) * 0.3 - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    th = TC.intersect_round_linear(*(torch.from_numpy(x) for x in (
        p0, r0, p1, r1, o, d)))
    jh = JC.intersect_round_linear(*(jnp.asarray(x) for x in (
        p0, r0, p1, r1, o, d)))
    hit_t, hit_j = th[0].numpy(), np.asarray(jh[0])
    assert (hit_t == hit_j).mean() >= 0.995
    both = hit_t & hit_j
    assert both.sum() > 100
    jt = np.asarray(jh[1])[both]
    assert (np.abs(th[1].numpy()[both] - jt) <= 1e-4 * np.abs(jt)).all()
    np.testing.assert_allclose(th[2].numpy()[both], np.asarray(jh[2])[both],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(th[3].numpy()[both], np.asarray(jh[3])[both],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("ct", ["linear", "cubic_bspline", "bezier"])
def test_segment_build_matches_jax(ct):
    n_cp = 7 if ct in ("linear", "bezier") else 5
    tg = TC.build_curve_segments(CP[:n_cp], RADII[:n_cp], material=3,
                                 curve_type=ct, n_subdiv=8)
    jg = JC.build_curve_segments(CP[:n_cp], RADII[:n_cp], material=3,
                                 curve_type=ct, n_subdiv=8)
    assert tg.material == jg.material == 3
    for f in ("p0", "p1", "r0", "r1"):
        if ct == "linear":
            np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                          np.asarray(getattr(jg, f)))
        else:
            _close(getattr(tg, f), getattr(jg, f))


@pytest.mark.parametrize("ct", TYPES[1:])
def test_span_build_matches_jax(ct):
    n_cp = 7 if ct == "bezier" else K[ct] + 2
    tg = TC.build_curve_spans(CP[:n_cp], RADII[:n_cp], material=2,
                              curve_type=ct)
    jg = JC.build_curve_spans(CP[:n_cp], RADII[:n_cp], material=2,
                              curve_type=ct)
    for f in ("coef", "rcoef", "lo", "hi"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert tg.material == 2
    with pytest.raises(ValueError, match="whole spans"):
        TC.build_curve_spans(CP[:K[ct] - 1], RADII[:K[ct] - 1],
                             curve_type=ct)


@pytest.mark.parametrize("ct", ["linear", "cubic_bspline"])
def test_intersect_curve_segments_matches_jax(ct):
    tg = TC.build_curve_segments(CP, RADII, curve_type=ct, n_subdiv=6)
    jg = JC.build_curve_segments(CP, RADII, curve_type=ct, n_subdiv=6)
    o, d = _rays_at(tg.p0.numpy(), 300, 11)
    th = TC.intersect_curve_segments(tg, torch.from_numpy(o),
                                     torch.from_numpy(d))
    jh = JC.intersect_curve_segments(jg, jnp.asarray(o), jnp.asarray(d))
    _compare(th, jh)
    np.testing.assert_allclose(th.uv.numpy()[th.hit.numpy()],
                               np.asarray(jh.uv)[th.hit.numpy()], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("ct", TYPES[1:])
def test_intersect_curve_spans_matches_jax(ct):
    n_cp = 7 if ct == "bezier" else K[ct] + 1
    tg = TC.build_curve_spans(CP[:n_cp], RADII[:n_cp], curve_type=ct)
    jg = JC.build_curve_spans(CP[:n_cp], RADII[:n_cp], curve_type=ct)
    poly = TC.build_curve_segments(CP[:n_cp], RADII[:n_cp], curve_type=ct,
                                   n_subdiv=16)
    o, d = _rays_at(poly.p0.numpy(), 200, 12)
    th = TC.intersect_curve_spans(tg, torch.from_numpy(o),
                                  torch.from_numpy(d))
    jh = JC.intersect_curve_spans(jg, jnp.asarray(o), jnp.asarray(d))
    _compare(th, jh)


def test_swept_sphere_span_matches_jax():
    """One span a ray, given per ray, and a t_max that cuts some hits."""
    tg = TC.build_curve_spans(CP[:6], RADII[:6], curve_type="catmull_rom")
    poly = TC.build_curve_segments(CP[:6], RADII[:6],
                                   curve_type="catmull_rom", n_subdiv=16)
    o, d = _rays_at(poly.p0.numpy(), 256, 13, spread=0.15)
    span = np.random.default_rng(4).integers(0, tg.coef.shape[0], 256)
    t_max = np.where(np.arange(256) % 5 == 0, 3.0, 1e30).astype(np.float32)
    coef, rcoef = tg.coef.numpy()[span], tg.rcoef.numpy()[span]
    th = TC.intersect_swept_sphere_span(
        torch.from_numpy(coef), torch.from_numpy(rcoef), torch.from_numpy(o),
        torch.from_numpy(d), 1e-4, torch.from_numpy(t_max))
    jh = JC.intersect_swept_sphere_span(
        jnp.asarray(coef), jnp.asarray(rcoef), jnp.asarray(o),
        jnp.asarray(d), 1e-4, jnp.asarray(t_max))
    hit_t, hit_j = th[0].numpy(), np.asarray(jh[0])
    assert (hit_t == hit_j).mean() >= 0.995
    both = hit_t & hit_j
    assert both.sum() > 30
    jt = np.asarray(jh[1])[both]
    assert (np.abs(th[1].numpy()[both] - jt) <= 1e-4 * np.abs(jt)).all()


def _curve_scene(B):
    """A floor, a lamp, and a curve as a tube and as direct round-linear
    segments side by side (JAX's render graph over direct spans takes
    minutes to compile on the CPU; the spans' intersector is held above)."""
    b = B.SceneBuilder()
    floor = b.add_lambert_material((0.8, 0.8, 0.8))
    red = b.add_lambert_material((0.8, 0.2, 0.2))
    light = b.add_lambert_material((0, 0, 0), emittance=(80.0,) * 3)
    b.add_instance(b.add_rectangle(3.0, 3.0, floor))
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    b.add_instance(b.add_rectangle(0.5, 0.5, light),
                   B.affine(rotation=flip, translation=[0, 1.5, 0]))
    cp = np.array([[-0.4, 0.25, -0.6], [0.4, 0.3, -0.6]], np.float32)
    rr = np.array([0.12, 0.18], np.float32)
    b.add_instance(b.add_curve(cp, rr, red, curve_type="linear", n_axial=4,
                               n_radial=12))
    b.add_curve(cp + [0.0, 0.0, 0.6], rr, red, curve_type="linear",
                direct=True)
    return b


def test_curve_render_matches_jax():
    """render_sample at 16x16 on the curve scene, skip-link, one sample:
    mean relative image difference < 5e-3 against JAX, equal rays."""
    import math

    import gfxexp_tpu.scene.builder as JB
    import gfxexp_torch.scene.builder as TB
    from gfxexp_torch.render import pathtrace as tpt
    from gfxexp_torch.render.camera import make_camera as tcam
    from gfxexp_torch.scene.compile import compile_scene as tcompile
    from gfxexp_tpu.render import pathtrace as jpt
    from gfxexp_tpu.render.camera import make_camera as jcam
    from gfxexp_tpu.scene.compile import compile_scene as jcompile

    cam = dict(position=[0.0, 0.9, 1.8], fov_y=math.radians(50), aspect=1.0,
               target=[0.0, 0.2, 0.0])
    js, jb = jcompile(_curve_scene(JB), traversal="skip")
    ts, tb = tcompile(_curve_scene(TB), traversal="skip")
    assert [type(g).__name__ for g in ts.displaced] == ["CurveSegments"]
    jimg, jr = jpt.render_sample(js, jb, jcam(**cam), 16, 16,
                                 jnp.uint32(0), jpt.PTConfig(count_rays=True))
    timg, tr = tpt.render_sample(ts, tb, tcam(**cam), 16, 16, 0,
                                 tpt.PTConfig(count_rays=True))
    jimg, timg = np.asarray(jimg), timg.numpy()
    assert np.abs(timg - jimg).mean() / np.abs(jimg).mean() < 5e-3
    assert float(tr) == float(jr) and timg.mean() > 0
