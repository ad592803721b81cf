"""The port's ReGIR (techniques/regir.py) and the path tracer's `nee_fn` hook
against gfxexp_tpu's, on the same scene, cameras, frames and reservoirs.

Scene: 16 small emitters of random intensity over a floor with three
spheres that cast shadows (torch_scenes.many_light_scene), compiled as
skip-link scenes (JAX traces them with accel/tiled.py on the CPU, the port
with its plain skip walk), at 16x16 with max path length 3. The grid is
cut to (4, 2, 4) cells x 16 slots to keep JAX's compiles short.

Bars. The cell build over three frames (0, 1 and 9, with cells touched in
between, so that the temporal merge runs and, at frame 9, the LRU keeps
the cells idle since frame 0): every slot's selected sample equal (the
position within 1e-5, at_inf equal) and sum_w, stream length, reciprocal
pdf and target within rtol 1e-4 (atol 1e-6); measured: all selections
equal, sum_w within 1.9e-6 absolute. The ReGIR sample: touch counts
equal, ray counts equal, and the mean relative image difference under
1e-5 (measured 3-6e-7). The hook: a hook that runs the default NEE gives
the default image bit for bit and the default ray count, and its aux (the
alive lanes it saw) equals JAX's for the same hook.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch.render import camera as tcam  # noqa: E402
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.types import regir_state_from_numpy  # noqa: E402
from gfxexp_torch.techniques import regir as tg  # noqa: E402
from gfxexp_tpu.render import camera as jcam  # noqa: E402
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402
from gfxexp_tpu.techniques import regir as jg  # noqa: E402

torch.set_num_threads(2)
RES = 16
N = RES * RES
CAM = dict(position=[0.0, 3.0, 4.0], fov_y=np.deg2rad(50), aspect=1.0,
           target=[0.0, 0.0, 0.0])
SMALL = dict(grid_dimension=(4, 2, 4), num_light_slots_per_cell=16)
FRAMES = (0, 1, 9)
IMAGE_BAR = 1e-5


def _cfgs(**kw):
    return jg.ReGIRConfig(**SMALL, **kw), tg.ReGIRConfig(**SMALL, **kw)


@pytest.fixture(scope="module")
def setup():
    js, jb = jcompile(S.many_light_scene(JB, 16, occluders=3))
    ts, tb = tcompile(S.many_light_scene(TB, 16, occluders=3))
    jcfg, tcfg = _cfgs()
    return dict(js=js, jb=jb, ts=ts, tb=tb, jcam=jcam.make_camera(**CAM),
                tcam=tcam.make_camera(**CAM),
                jgrid=jg.make_grid(js, jcfg), tgrid=tg.make_grid(ts, tcfg))


def compare_state(t, j):
    jpos = np.asarray(j.pos)
    same = ((np.abs(t.pos.numpy() - jpos).max(-1)
             <= 1e-5 * (1 + np.abs(jpos).max(-1)))
            & (t.at_inf.numpy() == np.asarray(j.at_inf)))
    assert same.all(), 1.0 - same.mean()
    for name in ("sum_w", "stream_len", "rec_pdf", "target"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for name in ("last_access", "num_accesses"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)


def test_grid_matches_jax(setup):
    s = setup
    for name in ("origin", "cell_size"):
        np.testing.assert_array_equal(getattr(s["tgrid"], name).numpy(),
                                      np.asarray(getattr(s["jgrid"], name)))
    g = regir_state_from_numpy(s["jgrid"])
    assert isinstance(g, tg.GridInfo)
    p = np.random.default_rng(2).uniform(-12, 12, (500, 3)).astype(
        np.float32)
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    np.testing.assert_array_equal(
        tg.cell_index(s["tgrid"], tcfg, torch.from_numpy(p)).numpy(),
        np.asarray(jg.cell_index(s["jgrid"], jcfg, jnp.asarray(p))))


@pytest.mark.parametrize("temporal", [True, False])
def test_build_cell_reservoirs_matches_jax(setup, temporal):
    """Three frames, each package carrying its own state; even cells are
    touched after every frame, so at frame 9 the odd ones (last access 0)
    are idle and keep their reservoirs."""
    s = setup
    jcfg, tcfg = _cfgs(enable_temporal_reuse=temporal)
    jst, tst = jg.make_regir_state(jcfg), tg.make_regir_state(tcfg, "cpu")
    cells = np.arange(jcfg.num_cells)
    even = cells % 2 == 0
    for f in FRAMES:
        prev = tst
        jst = jg.build_cell_reservoirs(s["js"], jst, s["jgrid"],
                                       jnp.uint32(f), jcfg)
        tst = tg.build_cell_reservoirs(s["ts"], tst, s["tgrid"], f, tcfg)
        compare_state(tst, jst)
        slot_cell = np.arange(tst.sum_w.shape[0]) // 16
        if f == 9:
            idle = ~even[slot_cell]
            assert torch.equal(tst.sum_w[idle], prev.sum_w[idle])
            assert torch.equal(tst.pos[idle], prev.pos[idle])
            assert not torch.equal(tst.sum_w[~idle], prev.sum_w[~idle])
        if temporal and f == 1:
            assert (tst.stream_len.numpy() > 8).any()
        jst = jg.finalize_frame(jg.touch_cells(
            jst, jnp.asarray(cells, jnp.int32), jnp.asarray(even)), f)
        tst = tg.finalize_frame(tg.touch_cells(
            tst, torch.from_numpy(cells), torch.from_numpy(even)), f)
        compare_state(tst, jst)


@pytest.mark.parametrize("randomize", [True, False])
def test_render_sample_regir_matches_jax(setup, randomize):
    """One sample from the same reservoirs (JAX's, carried by
    regir_state_from_numpy): image, touch counts and ray counts."""
    s = setup
    jcfg, tcfg = _cfgs(enable_cell_randomization=randomize)
    jst = jg.make_regir_state(jcfg)
    for f in range(2):
        jst = jg.build_cell_reservoirs(s["js"], jst, s["jgrid"],
                                       jnp.uint32(f), jcfg)
    tst = regir_state_from_numpy(jst)
    assert isinstance(tst, tg.ReGIRState)
    pj = jpt.PTConfig(max_path_length=3, count_rays=True)
    pt = tpt.PTConfig(max_path_length=3, count_rays=True)
    jimg, jst2, jrays = jg.render_sample_regir(
        s["js"], s["jb"], s["jcam"], jst, s["jgrid"], RES, RES,
        jnp.uint32(2), pj, jcfg)
    timg, tst2, trays = tg.render_sample_regir(
        s["ts"], s["tb"], s["tcam"], tst, s["tgrid"], RES, RES, 2, pt, tcfg)
    assert timg.shape == (N, 3) and bool(torch.isfinite(timg).all())
    assert float(timg.mean()) > 0
    assert S.image_rel_diff(timg.numpy(), np.asarray(jimg)) < IMAGE_BAR
    np.testing.assert_array_equal(tst2.num_accesses.numpy(),
                                  np.asarray(jst2.num_accesses))
    assert int(tst2.num_accesses.sum()) > N
    assert float(trays) == float(jrays)


def test_frames_match_jax(setup):
    """The app's loop (build, sample, finalize) for three frames, each
    package on its own state: images and LRU bookkeeping."""
    s = setup
    jcfg, tcfg = _cfgs()
    jst, tst = jg.make_regir_state(jcfg), tg.make_regir_state(tcfg, "cpu")
    pj, pt = jpt.PTConfig(max_path_length=3), tpt.PTConfig(max_path_length=3)
    for f in range(3):
        jst = jg.build_cell_reservoirs(s["js"], jst, s["jgrid"],
                                       jnp.uint32(f), jcfg)
        tst = tg.build_cell_reservoirs(s["ts"], tst, s["tgrid"], f, tcfg)
        jimg, jst = jg.render_sample_regir(
            s["js"], s["jb"], s["jcam"], jst, s["jgrid"], RES, RES,
            jnp.uint32(f), pj, jcfg)
        timg, tst = tg.render_sample_regir(
            s["ts"], s["tb"], s["tcam"], tst, s["tgrid"], RES, RES, f, pt,
            tcfg)
        jst, tst = jg.finalize_frame(jst, f), tg.finalize_frame(tst, f)
        compare_state(tst, jst)
        assert S.image_rel_diff(timg.numpy(), np.asarray(jimg)) < IMAGE_BAR


def _j_hook(scene, bvh, sp, v_out_local, frame, params, rs, cfg, alive,
            aux):
    return (jpt._next_event(scene, bvh, sp, v_out_local, frame, params, rs,
                            cfg, alive), aux + jnp.sum(alive.astype(
                                jnp.int32)))


def _t_hook(scene, bvh, sp, v_out_local, frame, params, rs, cfg, alive,
            aux):
    return (tpt._next_event(scene, bvh, sp, v_out_local, frame, params, rs,
                            cfg, alive), aux + alive.sum().to(torch.int32))


@pytest.mark.parametrize("count_rays", [False, True])
def test_nee_hook(setup, count_rays):
    """A hook that runs the default NEE and counts the alive lanes it
    sees: the image (and ray count) equal the default's bit for bit, and
    the count equals JAX's for the same hook."""
    s = setup
    pt = tpt.PTConfig(max_path_length=4, count_rays=count_rays)
    args = (s["ts"], s["tb"], s["tcam"], RES, RES, 0, N, 5, pt)
    default = tpt.render_lanes(*args)
    out, aux = tpt.render_lanes(*args, nee_fn=_t_hook,
                                nee_aux=torch.zeros((), dtype=torch.int32))
    if count_rays:
        assert torch.equal(out[0], default[0])
        assert float(out[1]) == float(default[1])
    else:
        assert torch.equal(out, default)
    pj = jpt.PTConfig(max_path_length=4, count_rays=count_rays)
    jfn = jax.jit(functools.partial(
        jpt.render_lanes, width=RES, height=RES, lane_start=0, lane_count=N,
        cfg=pj, nee_fn=_j_hook))
    jout, jaux = jfn(s["js"], s["jb"], s["jcam"], sample_idx=jnp.uint32(5),
                     nee_aux=jnp.zeros((), jnp.int32))
    assert int(aux) == int(jaux) > 0
    timg = out[0] if count_rays else out
    jimg = jout[0] if count_rays else jout
    assert S.image_rel_diff(timg.numpy(), np.asarray(jimg)) < 5e-3


def test_default_path_has_no_aux(setup):
    """Without nee_aux the result is the bare image, as before the hook."""
    s = setup
    out = tpt.render_lanes(s["ts"], s["tb"], s["tcam"], RES, RES, 0, N, 1,
                           tpt.PTConfig(max_path_length=2))
    assert isinstance(out, torch.Tensor) and out.shape == (N, 3)
    _, aux = tpt.render_lanes(
        s["ts"], s["tb"], s["tcam"], RES, RES, 0, N, 1,
        tpt.PTConfig(max_path_length=2), nee_fn=_t_hook,
        nee_aux=torch.zeros((), dtype=torch.int32))
    assert int(aux) == N  # one NEE bounce, every primary ray hits


def test_regir_matches_standard_nee(setup):
    """tests/test_regir.py's calibration on the port alone: ReGIR's mean
    over 24 frames within 8% of plain NEE's (implicit hits off in both,
    as ReGIR forces), at 16x16."""
    s = setup
    _, tcfg = _cfgs()
    pt = tpt.PTConfig(max_path_length=2, use_implicit_light_sampling=False)
    frames = 24
    ref = sum(float(tpt.render_sample(s["ts"], s["tb"], s["tcam"], RES, RES,
                                      f, pt).mean()) for f in range(frames))
    st = tg.make_regir_state(tcfg, "cpu")
    got = 0.0
    for f in range(frames):
        st = tg.build_cell_reservoirs(s["ts"], st, s["tgrid"], f, tcfg)
        img, st = tg.render_sample_regir(s["ts"], s["tb"], s["tcam"], st,
                                         s["tgrid"], RES, RES, f, pt, tcfg)
        st = tg.finalize_frame(st, f)
        got += float(img.mean())
    assert np.isfinite(got) and abs(got - ref) / ref < 0.08, (got, ref)


def test_regir_app_renders_on_the_cpu(tmp_path):
    from gfxexp_torch.apps import regir as app

    hdr = app.main(["-device", "cpu", "-width", "16", "-height", "16",
                    "-frames", "2", "-grid-dim", "4", "4", "4",
                    "-light-slots", "8", "-output", str(tmp_path / "r"),
                    "-no-temporal", "-no-cell-randomization"])
    assert hdr.shape == (16, 16, 3) and np.isfinite(hdr).all()
    assert hdr.mean() > 0 and (tmp_path / "r.png").exists()


def test_state_is_a_tensor_container():
    _, tcfg = _cfgs()
    st = tg.make_regir_state(tcfg, "cpu")
    assert st.device == torch.device("cpu")
    assert st.pos.shape == (tcfg.num_cells * 16, 3)
    moved = dataclasses.replace(st, sum_w=st.sum_w + 1.0).to("cpu")
    assert float(moved.sum_w.mean()) == 1.0
