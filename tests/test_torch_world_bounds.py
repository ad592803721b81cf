"""ReGIR's grid and NRC's box on a two-level scene (scene.types.world_bounds):
the BLAS triangles are in object space, so both bound them through each
instance's transform, and `big` compiled two-level gives the grid, box and
images of the same scene flattened into world triangles.

Bars: origin, cell size and box within 1e-6 (absolute; the flattened
scene's world vertices round once to float32, the two-level ones are
transformed in float64 from float32 object vertices; measured 0). One
ReGIR frame at 32x32: the cell reservoirs equal, ray and touch counts
equal, the image within 5e-5: the two structures' walks round a hit's
u, v apart (the plain path tracer's images differ by 3.0e-6 here), and a
shifted hit point can resample another light of its cell (measured
1.1e-5, one pixel; the bar of tests/test_torch_regir.py, 1e-5, holds the
same structure against JAX). One render_sample_nrc at 32x32 within the
bars of tests/test_torch_nrc.py (1e-5; 2e-3 with the cache read) and
equal training masks.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

from gfxexp_torch.bench import bench_camera, build_bench_scene  # noqa: E402
from gfxexp_torch.render.pathtrace import PTConfig  # noqa: E402
from gfxexp_torch.scene.types import world_bounds  # noqa: E402
from gfxexp_torch.techniques import regir as tg  # noqa: E402
from gfxexp_torch.techniques.nrc import cache as tcache  # noqa: E402
from gfxexp_torch.techniques.nrc import network as tn  # noqa: E402

torch.set_num_threads(2)
RES = 32
CFG = tg.ReGIRConfig(grid_dimension=(8, 4, 8), num_light_slots_per_cell=16)


@pytest.fixture(scope="module")
def big():
    return {t: build_bench_scene("big", traversal=t)
            for t in ("instanced", "widerow")}


def test_world_bounds(big):
    inst, flat = world_bounds(big["instanced"][0]), world_bounds(
        big["widerow"][0])
    for a, b in zip(inst, flat):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # the light at y = 1.5 lies inside; object space stops at y = 0.25
    assert inst[1][1] == pytest.approx(1.5)
    obj = big["instanced"][0].triangles
    assert float((obj.p0[:, 1]).max()) <= 0.25 + 1e-6


def test_regir_grid_and_frame(big):
    cam = bench_camera(RES, RES, "big")
    out = {}
    for t, (scene, bvh) in big.items():
        grid = tg.make_grid(scene, CFG)
        st = tg.build_cell_reservoirs(scene, tg.make_regir_state(CFG, "cpu"),
                                      grid, 0, CFG)
        img, st2, rays = tg.render_sample_regir(
            scene, bvh, cam, st, grid, RES, RES, 0,
            PTConfig(max_path_length=3, count_rays=True), CFG)
        out[t] = (grid, img.numpy(), st, float(rays), st2.num_accesses)
    gi, ii, si, ri, ai = out["instanced"]
    gf, if_, sf, rf, af = out["widerow"]
    for name in ("origin", "cell_size"):
        np.testing.assert_allclose(getattr(gi, name).numpy(),
                                   getattr(gf, name).numpy(), rtol=0,
                                   atol=1e-6)
    assert float(gi.origin[1]) < 0.0 < 1.5 < float(
        gi.origin[1] + 4 * gi.cell_size[1])
    for name in ("pos", "sum_w", "target", "rec_pdf"):
        assert torch.equal(getattr(si, name), getattr(sf, name)), name
    assert np.isfinite(ii).all() and ii.mean() > 0
    assert S.image_rel_diff(ii, if_) < 5e-5
    assert ri == rf
    np.testing.assert_array_equal(ai.numpy(), af.numpy())
    # the hits spread over the grid's height, not into its top layer
    touched = ai.numpy().reshape(8, 4, 8) > 0
    assert touched[:, 0].any() and not touched[:, 3].all()


@pytest.mark.parametrize("read_cache", [False, True])
def test_nrc_box_and_frame(big, read_cache):
    cfg = tn.NRCConfig()
    ema = tn.init_nrc(cfg=cfg, device="cpu")["ema"]
    if read_cache:
        # a fresh cache predicts 0; give its output layer weights
        g = torch.Generator().manual_seed(3)
        ema["weights"][-1] = 0.1 * torch.randn(ema["weights"][-1].shape,
                                               generator=g)
    cam = bench_camera(RES, RES, "big")
    icfg = tcache.NRCIntegratorConfig(train_stride=8)
    out = {}
    for t, (scene, bvh) in big.items():
        lo, hi = tcache.scene_aabb(scene)
        out[t] = (lo, hi, tcache.render_sample_nrc(
            scene, bvh, cam, ema, lo, hi, RES, RES, 1, icfg, cfg))
    (li, hi_, ri), (lf, hf, rf) = out["instanced"], out["widerow"]
    np.testing.assert_allclose(li.numpy(), lf.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(hi_.numpy(), hf.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ri[3].numpy(), rf[3].numpy())
    bar = 2e-3 if read_cache else 1e-5
    assert np.isfinite(ri[0].numpy()).all() and float(ri[0].mean()) > 0
    assert S.image_rel_diff(ri[0].numpy(), rf[0].numpy()) < bar
