"""The port's ReSTIR DI (techniques/restir_di.py) against gfxexp_tpu's, pass
by pass and frame by frame, at 16x16.

Scene: 16 small emitters of random intensity over a floor, with three
spheres that cast shadows (torch_scenes.many_light_scene), compiled as
skip-link scenes (JAX traces them with accel/tiled.py on the CPU, the port
with its plain skip walk). A pass is fed JAX's inputs (G-buffer, contexts,
reservoirs, visibility flags, light pool) carried into the port's classes
by from_numpy, so only the pass itself can differ. The configuration is cut
to keep JAX's compiles short (4 candidates, one spatial pass of 2
neighbours, a pool of 8 x 64 lights); the frames test runs the defaults'
pass structure at that size.

A reservoir's acceptance test `u * sum_w < weight` flips where the two
sums differ by an ulp (XLA contracts multiply-adds, the port rounds each
operation), and a flip selects another light. So a pass is compared as
the share of pixels whose selected sample differs (bar: at most 2%;
measured 0 on these inputs) and, where the selection agrees, sum_w,
stream length, reciprocal pdf and target within rtol 1e-4 (atol 1e-6).
Visibility flags and shadow-ray counts are equal. restir_di_frame, three
frames of each pipeline (classic, rearchitected) and estimator (biased,
unbiased): the mean relative image difference under 1e-3 each frame
(measured at most 2.4e-6 at the default configuration).
"""

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
from gfxexp_torch.render import camera as tcam  # noqa: E402
from gfxexp_torch.render.gbuffer import render_gbuffer as t_gbuffer  # noqa
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.types import from_numpy  # noqa: E402
from gfxexp_torch.techniques import restir_di as tr  # noqa: E402
from gfxexp_tpu.render import camera as jcam  # noqa: E402
from gfxexp_tpu.render.gbuffer import render_gbuffer as j_gbuffer  # noqa
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402
from gfxexp_tpu.techniques import restir_di as jr  # noqa: E402

torch.set_num_threads(2)
RES = 16
N = RES * RES
CAM = dict(position=[0.0, 3.0, 4.0], fov_y=np.deg2rad(50), aspect=1.0,
           target=[0.0, 0.0, 0.0])
MOVED = dict(CAM, position=[0.15, 3.0, 4.0])
SMALL = dict(log2_num_candidates=2, num_spatial_passes=1,
             num_spatial_neighbors=2, num_light_subsets=8,
             light_subset_size=64)
SEL_BAR = 0.02


def _cfgs(**kw):
    return jr.ReSTIRConfig(**SMALL, **kw), tr.ReSTIRConfig(**SMALL, **kw)


def _flat(gb, n=N):
    return [gb.hit.reshape(n), gb.position.reshape(n, 3),
            gb.normal.reshape(n, 3)]


@pytest.fixture(scope="module")
def setup():
    """The scene both ways, and JAX's G-buffers and contexts of frame 0
    (still camera) and frame 1 (camera moved by 0.15 since frame 0, so the
    motion vectors are not zero)."""
    js, jb = jcompile(S.many_light_scene(JB, 16, occluders=3))
    ts, tb = tcompile(S.many_light_scene(TB, 16, occluders=3))
    cam0, cam1 = jcam.make_camera(**CAM), jcam.make_camera(**MOVED)
    gb0 = j_gbuffer(js, jb, cam0, cam0, RES, RES, jnp.uint32(0), True)
    gb1 = j_gbuffer(js, jb, cam1, cam0, RES, RES, jnp.uint32(1), True)
    assert np.abs(np.asarray(gb1.motion)).max() > 0.5
    ctx0, ctx1 = jr.pixel_ctx(js, gb0, cam0), jr.pixel_ctx(js, gb1, cam1)
    pixel = jnp.arange(N, dtype=jnp.uint32)
    # JAX's frame-0 and frame-1 initial reservoirs (initial_ris reads only
    # the candidate count and reuse_visibility, the same in every _cfgs)
    jcfg, _ = _cfgs()
    prev = jr.initial_ris(js, jb, ctx0, pixel, jnp.uint32(0), jcfg)
    cur = jr.initial_ris(js, jb, ctx1, pixel, jnp.uint32(1), jcfg)
    return dict(js=js, jb=jb, ts=ts, tb=tb, cam1=cam1, gb0=gb0, gb1=gb1,
                ctx0=ctx0, ctx1=ctx1, pixel=pixel, res=(prev, cur))


def _t(x):
    return from_numpy(x)


def compare_res(t, j):
    """The share of pixels whose selected sample differs; the reservoirs'
    numbers where it agrees."""
    jpos = np.asarray(j.pos)
    same = ((np.abs(t.pos.numpy() - jpos).max(-1) <= 1e-5 * (
        1 + np.abs(jpos).max(-1))) & (t.at_inf.numpy() == np.asarray(
            j.at_inf)))
    assert 1.0 - same.mean() <= SEL_BAR, 1.0 - same.mean()
    for name in ("sum_w", "stream_len", "rec_pdf", "target"):
        np.testing.assert_allclose(getattr(t, name).numpy()[same],
                                   np.asarray(getattr(j, name))[same],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    return same


def test_pixel_ctx_matches_jax(setup):
    s = setup
    ctx = tr.pixel_ctx(s["ts"], _t(s["gb1"]), _t(s["cam1"]))
    j = s["ctx1"]
    for name in ("pos", "v_out_local", "t", "b", "n", "cam_dist"):
        np.testing.assert_allclose(getattr(ctx, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert torch.equal(ctx.valid, torch.from_numpy(np.asarray(j.valid)))
    np.testing.assert_array_equal(ctx.params.diffuse.numpy(),
                                  np.asarray(j.params.diffuse))


@pytest.mark.parametrize("reuse_visibility", [True, False])
def test_initial_ris_matches_jax(setup, reuse_visibility):
    s = setup
    jcfg, tcfg = _cfgs(reuse_visibility=reuse_visibility)
    j = jr.initial_ris(s["js"], s["jb"], s["ctx1"], s["pixel"],
                       jnp.uint32(1), jcfg)
    t = tr.initial_ris(s["ts"], s["tb"], _t(s["ctx1"]),
                       torch.arange(N), 1, tcfg)
    same = compare_res(t, j)
    assert (np.asarray(j.rec_pdf)[same] > 0).mean() > 0.5


def test_presampled_ris_matches_jax(setup):
    s = setup
    jcfg, tcfg = _cfgs(use_rearchitected_pipeline=True)
    jpool = jr.presample_lights(s["js"], jnp.uint32(1), jcfg)
    tpool = tr.presample_lights(s["ts"], 1, tcfg)
    for k, v in jpool.items():
        np.testing.assert_allclose(tpool[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    j = jr.initial_ris_presampled(s["js"], s["jb"], s["ctx1"], jpool,
                                  s["gb1"], s["pixel"], jnp.uint32(1), jcfg)
    pool = {k: torch.from_numpy(np.asarray(v)) for k, v in jpool.items()}
    t = tr.initial_ris_presampled(s["ts"], s["tb"], _t(s["ctx1"]), pool,
                                  _t(s["gb1"]), torch.arange(N), 1, tcfg)
    compare_res(t, j)


@pytest.mark.parametrize("unbiased", [False, True])
def test_temporal_reuse_matches_jax(setup, unbiased):
    s = setup
    jcfg, tcfg = _cfgs(use_unbiased_estimator=unbiased)
    prev, cur = s["res"]
    j = jr.temporal_reuse(s["js"], cur, prev, s["ctx1"], s["ctx0"], s["gb1"],
                          *_flat(s["gb0"]), s["cam1"], s["pixel"],
                          jnp.uint32(1), jcfg)
    t = tr.temporal_reuse(s["ts"], _t(cur), _t(prev), _t(s["ctx1"]),
                          _t(s["ctx0"]), _t(s["gb1"]),
                          *map(_t, _flat(s["gb0"])), _t(s["cam1"]),
                          torch.arange(N), 1, tcfg)
    compare_res(t, j)
    # the temporal neighbour was merged somewhere
    assert (np.asarray(j.stream_len) > np.asarray(cur.stream_len)).any()


@pytest.mark.parametrize("kw", [{}, {"use_unbiased_estimator": True},
                                {"use_low_discrepancy_neighbors": False},
                                {"use_unbiased_estimator": True,
                                 "use_mis_ris": False}],
                         ids=["biased", "unbiased", "random", "unbiased_nomis"])
def test_spatial_reuse_matches_jax(setup, kw):
    s = setup
    jcfg, tcfg = _cfgs(**kw)
    _, cur = s["res"]
    j = jr.spatial_reuse(s["js"], s["jb"], cur, s["ctx1"], s["gb1"],
                         s["cam1"], s["pixel"], jnp.uint32(5), 0, jcfg)
    t = tr.spatial_reuse(s["ts"], s["tb"], _t(cur), _t(s["ctx1"]),
                         _t(s["gb1"]), _t(s["cam1"]), torch.arange(N), 5, 0,
                         tcfg)
    compare_res(t, j)


def _vis_inputs(s):
    prev, cur = s["res"]
    # the previous frame's selected-sample visibility: seeded flags
    sel = jnp.asarray(np.random.default_rng(4).random(N) < 0.7)
    prev_vis = dataclasses.replace(jr.empty_sample_visibility(N),
                                   selected=sel)
    return prev, cur, prev_vis


VIS_CASES = {"biased": {}, "unbiased": {"use_unbiased_estimator": True},
             "reuse_vis_temporal": {"reuse_visibility_for_temporal": True}}


@pytest.mark.parametrize("case", list(VIS_CASES))
def test_trace_shadow_rays_matches_jax(setup, case):
    s = setup
    jcfg, tcfg = _cfgs(use_rearchitected_pipeline=True, **VIS_CASES[case])
    prev, cur, prev_vis = _vis_inputs(s)
    jvis, jrays = jr.trace_shadow_rays(
        s["js"], s["jb"], s["ctx1"], cur, prev, prev_vis, s["ctx0"],
        s["gb1"], *_flat(s["gb0"]), s["cam1"], s["pixel"], jcfg)
    tvis, trays = tr.trace_shadow_rays(
        s["ts"], s["tb"], _t(s["ctx1"]), _t(cur), _t(prev), _t(prev_vis),
        _t(s["ctx0"]), _t(s["gb1"]), *map(_t, _flat(s["gb0"])),
        _t(s["cam1"]), torch.arange(N), tcfg)
    for name in ("new", "temporal_passed", "temporal", "new_on_temporal",
                 "selected"):
        np.testing.assert_array_equal(getattr(tvis, name).numpy(),
                                      np.asarray(getattr(jvis, name)), name)
    assert float(trays) == float(jrays) > 0
    assert not np.asarray(jvis.new).all()  # the spheres shadow some


@pytest.mark.parametrize("unbiased", [False, True])
def test_shade_and_resample_matches_jax(setup, unbiased):
    s = setup
    jcfg, tcfg = _cfgs(use_rearchitected_pipeline=True,
                       use_unbiased_estimator=unbiased)
    prev, cur, prev_vis = _vis_inputs(s)
    jvis, _ = jr.trace_shadow_rays(
        s["js"], s["jb"], s["ctx1"], cur, prev, prev_vis, s["ctx0"],
        s["gb1"], *_flat(s["gb0"]), s["cam1"], s["pixel"], jcfg)
    jcol, jres, jvis2 = jr.shade_and_resample(
        s["js"], cur, prev, jvis, s["ctx1"], s["ctx0"], s["gb1"],
        s["pixel"], jnp.uint32(1), jcfg)
    tcol, tres, tvis2 = tr.shade_and_resample(
        s["ts"], _t(cur), _t(prev), _t(jvis), _t(s["ctx1"]), _t(s["ctx0"]),
        _t(s["gb1"]), torch.arange(N), 1, tcfg)
    same = compare_res(tres, jres)
    np.testing.assert_allclose(tcol.numpy().reshape(N, 3)[same],
                               np.asarray(jcol).reshape(N, 3)[same],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tvis2.selected.numpy()[same],
                                  np.asarray(jvis2.selected)[same])


def test_shade_matches_jax(setup):
    s = setup
    jcfg, _ = _cfgs()
    _, cur = s["res"]
    jcol = jr.shade(s["js"], s["jb"], cur, s["ctx1"], s["gb1"])
    tcol = tr.shade(s["ts"], s["tb"], _t(cur), _t(s["ctx1"]), _t(s["gb1"]))
    assert tcol.shape == (RES, RES, 3)
    np.testing.assert_allclose(tcol.numpy(), np.asarray(jcol), rtol=1e-5,
                               atol=1e-6)


FRAME_CASES = {
    "classic_biased": {},
    "classic_unbiased": {"use_unbiased_estimator": True},
    "rearch_biased": {"use_rearchitected_pipeline": True},
    "rearch_unbiased": {"use_rearchitected_pipeline": True,
                        "use_unbiased_estimator": True},
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_restir_di_frame_matches_jax(setup, case):
    """Three frames of the whole frame, both packages carrying their own
    state, on their own G-buffers of the still camera."""
    s = setup
    jcfg, tcfg = _cfgs(**FRAME_CASES[case])
    cam_j, cam_t = jcam.make_camera(**CAM), tcam.make_camera(**CAM)
    jres, jvis = jr.empty_reservoir(N), jr.empty_sample_visibility(N)
    tres = tr.empty_reservoir(N, "cpu")
    tvis = tr.empty_sample_visibility(N, "cpu")
    jctx, tctx = s["ctx0"], _t(s["ctx0"])
    jprev, tprev = _flat(s["gb0"]), list(map(_t, _flat(s["gb0"])))
    for f in range(3):
        jgb = j_gbuffer(s["js"], s["jb"], cam_j, cam_j, RES, RES,
                        jnp.uint32(f), True)
        tgb = t_gbuffer(s["ts"], s["tb"], cam_t, cam_t, RES, RES, f, True)
        jcol, jres, jctx, jvis = jr.restir_di_frame(
            s["js"], s["jb"], jgb, cam_j, jres, jctx, *jprev, jnp.uint32(f),
            jcfg, jvis)
        tcol, tres, tctx, tvis = tr.restir_di_frame(
            s["ts"], s["tb"], tgb, cam_t, tres, tctx, *tprev, f, tcfg, tvis)
        jprev, tprev = _flat(jgb), _flat(tgb)
        assert tcol.shape == (RES, RES, 3) and torch.isfinite(tcol).all()
        assert float(tcol.mean()) > 0
        assert S.image_rel_diff(tcol.numpy(), np.asarray(jcol)) < 1e-3


def _instanced_scene(mod):
    """tests/test_restir.py's instanced scene: a floor and a lamp."""
    b = mod.SceneBuilder()
    floor = b.add_lambert_material((0.6,) * 3)
    lamp = b.add_lambert_material((0, 0, 0), emittance=(30.0,) * 3)
    b.add_instance(b.add_rectangle(20.0, 20.0, floor))
    b.add_instance(b.add_rectangle(0.3, 0.3, lamp),
                   mod.affine(rotation=S.FLIP_X, translation=[0, 2.0, 0]))
    return b


def test_restir_on_instanced_scene():
    """tests/test_restir.py's instanced case on the port: RIS over the
    two-level structure (instanced G-buffer, shadow rays and light pdfs)
    converges to the mean of the flattened wide-row compile of the same
    scene, within 5% over 100 frames."""
    cam = dict(position=[0.4, 1.0, 0.4], fov_y=np.deg2rad(10), aspect=1.0,
               target=[0.0, 0.0, 0.0])
    cfg = tr.ReSTIRConfig(enable_temporal_reuse=False,
                          enable_spatial_reuse=False, reuse_visibility=False)
    tc = tcam.make_camera(**cam)
    means = []
    for traversal in ("widerow", "instanced"):
        ts, tb = tcompile(_instanced_scene(TB), traversal=traversal)
        gb = t_gbuffer(ts, tb, tc, tc, RES, RES, 0, False)
        res, ctx = tr.empty_reservoir(N, "cpu"), tr.pixel_ctx(ts, gb, tc)
        acc = torch.zeros(RES, RES, 3)
        for f in range(100):
            col, res, ctx, _ = tr.restir_di_frame(ts, tb, gb, tc, res, ctx,
                                                  *_flat(gb), f, cfg)
            acc += col
        means.append(float(acc.mean()) / 100)
    flat_mean, inst_mean = means
    assert np.isfinite(inst_mean) and inst_mean > 0
    assert abs(inst_mean - flat_mean) / flat_mean < 0.05, means

