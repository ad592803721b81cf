"""The port's neural radiance cache against the benchmark's float64
reference (benchmark/reference/nrc.py, the one copy the benchmark's check
runs): the encodings, the MLP and its gradients, Adam with the EMA, the
targets' propagation, and NRC samples of the Cornell box at 32x18 with the
hash grid, on weights drawn from seeded generators.

Bars (the port is float32, the reference float64):
- the hash grid and OneBlob within 1e-5 relative (float32 sums of eight
  corners and float32 exponentials; measured ~1e-7);
- the MLP rounds its operands to bfloat16, so where a float32 sum lands
  on the other side of a rounding than the float64 one, an activation
  moves by 2^-8 of itself: predictions within 2^-7 of the largest
  prediction, and all but 2% of them within 1e-5 relative (measured:
  all, the largest difference 1.1e-7 of the largest); the loss
  within 1e-5 relative; each gradient leaf within 2^-7 of its largest
  entry (its entries are rounded to bfloat16 as well);
- two optimizer steps from the same gradients: parameters, moments and
  EMA within 1e-6 relative (float32 rounding of each update);
- a frame's training (two steps, the app's permutation): MLP weights
  within the benchmark's MLP_TOL x lr and hash-table entries within its
  TABLE_TOL x lr, the loss within 1e-5 relative;
- propagate_targets within 1e-6 relative;
- an NRC sample, with the cache read (a non-zero output layer) and not (a
  zero one): at most 2% of pixels and of training paths off by the
  benchmark's test (the loop's `mismatch`: compare.mismatch, a cache
  read's part allowed CACHE_RTOL of itself): float32 and float64 paths
  part where a Russian roulette or termination test falls near its
  threshold (measured 0 and 1 of 576 pixels, 0 of 144 paths).
"""

import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
# last, so that no module of tests/ is shadowed by the benchmark's
sys.path.append(BENCH)

import harness  # noqa: E402
from loops import neural_radiance_caching as nrc_loop  # noqa: E402
from reference import compare  # noqa: E402
from reference import nrc as ref  # noqa: E402
from reference.scene import RefScene  # noqa: E402
from reference.shading import camera_frame  # noqa: E402

from gfxexp_torch.techniques.nrc import cache as tcache  # noqa: E402
from gfxexp_torch.techniques.nrc import encoding as tenc  # noqa: E402
from gfxexp_torch.techniques.nrc import network as tn  # noqa: E402

F64 = torch.float64
W, H = 32, 18
BENCHMARK = harness.load_json(harness.ROOT, "BENCHMARK.json")
_, CFG, TRAFFIC = harness.cell(BENCHMARK, "cornellbox.nrc_hashgrid")
NET = CFG["nrc"]
NCFG = tn.NRCConfig(position_encoding="hash_grid")


def _state(seed=3, out_scale=0.1):
    """A fresh hash-grid state with a non-zero output layer and a table
    of 1e-2 (so that the cache's reads and gradients are not trivially
    0)."""
    g = torch.Generator().manual_seed(seed)
    st = tn.init_nrc(g, NCFG, device="cpu")
    w = torch.randn(st["params"]["weights"][-1].shape, generator=g)
    table = torch.rand(st["params"]["hash_table"].shape, generator=g)
    for part in ("params", "ema"):
        st[part]["weights"][-1] = w * out_scale
        st[part]["hash_table"] = (table - 0.5) * 2e-2
    return st


def _f64(tree):
    return {"weights": [w.to(F64) for w in tree["weights"]],
            "hash_table": tree["hash_table"].to(F64)}


def _batch(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 14), generator=g),
            torch.rand((n, 3), generator=g) * 2.0,
            torch.rand(n, generator=g) < 0.8)


@pytest.mark.parametrize("kind", ["hash_grid", "one_blob"])
def test_encodings_match_reference(kind):
    g = torch.Generator().manual_seed(1)
    if kind == "hash_grid":
        x = torch.rand((400, 3), generator=g)
        x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                              [0.5, 0.25, 1.0], [1e-7, 1 - 1e-7, 0.5]])
        table = _state()["params"]["hash_table"]
        a = tenc.hash_grid_encoding(table, x)
        b = ref.hash_grid(table.to(F64), x.to(F64), NET)[0]
    else:
        x = torch.rand((400, 5), generator=g)
        a = tenc.one_blob_encoding(x)
        b = ref.one_blob(x.to(F64), NET["one_blob_bins"])
    torch.testing.assert_close(a.to(F64), b, rtol=1e-5,
                               atol=1e-5 * float(b.abs().max()))


def test_apply_and_gradients_match_reference():
    st = _state()
    q, t, m = _batch(512)
    a = tn.apply(st["params"], q, NCFG).to(F64)
    b = ref.forward(_f64(st["params"]), q.to(F64), NET)[0]
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= 2 ** -7 * scale
    close = ((a - b).abs() <= 1e-5 * b.abs() + 1e-12).all(-1)
    assert float(close.to(F64).mean()) >= 0.98
    la, ga = tn.loss_and_grads(st["params"], q, t, m, NCFG)
    lb, gb = ref.loss_and_grads(_f64(st["params"]), q.to(F64), t.to(F64),
                                m, NET)
    assert abs(float(la) - float(lb)) <= 1e-5 * abs(float(lb))
    for x, y in zip(list(ga["weights"]) + [ga["hash_table"]],
                    list(gb["weights"]) + [gb["hash_table"]]):
        assert float((x.to(F64) - y).abs().max()) <= 2 ** -7 * float(
            y.abs().max())


def test_two_optimizer_steps_match_reference():
    st = _state()
    q, t, m = _batch(256)
    grads = tn.loss_and_grads(st["params"], q, t, m, NCFG)[1]
    port = tn.apply_step(tn.apply_step(st, grads, NCFG), grads, NCFG)
    want = nrc_loop._state(st, F64)
    g64 = _f64(grads)
    for _ in range(2):
        want = ref.adam_step(want, g64, NET)
    got = nrc_loop._state(port, F64)
    assert got["count"] == want["count"] == 2
    for part in ("params", "ema", "mu", "nu"):
        for x, y in zip(got[part]["weights"] + [got[part]["hash_table"]],
                        want[part]["weights"] + [want[part]["hash_table"]]):
            torch.testing.assert_close(x, y, rtol=1e-6,
                                       atol=1e-6 * float(y.abs().max()))


def test_train_on_frame_matches_reference():
    st = _state()
    q, t, m = _batch(402)
    perm = torch.randperm(402, generator=torch.Generator().manual_seed(0))
    port, loss = tn.train_on_frame(st, q, t, m, NCFG, 2, perm=perm)
    want, want_loss, _ = ref.train_frame(nrc_loop._state(st, F64),
                                         q.to(F64), t.to(F64), m, perm, 2,
                                         NET)
    lr = NET["learning_rate"]
    for part in ("params", "ema"):
        for x, y in zip(port[part]["weights"], want[part]["weights"]):
            assert float((x.to(F64) - y).abs().max()) <= \
                nrc_loop.MLP_TOL * lr
        d = (port[part]["hash_table"].to(F64)
             - want[part]["hash_table"]).abs()
        assert float(d.max()) <= nrc_loop.TABLE_TOL * lr
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)


def test_propagate_targets_matches_reference():
    g = torch.Generator().manual_seed(4)
    n, L = 64, 5
    direct = torch.rand((n, L, 3), generator=g)
    thru = torch.rand((n, L, 3), generator=g)
    valid = torch.rand((n, L), generator=g) < 0.7
    end = torch.rand((n, 3), generator=g)
    has = torch.rand(n, generator=g) < 0.5
    a = tcache.propagate_targets(direct, thru, valid, end, has)
    b = ref.propagate(direct.to(F64), thru.to(F64), valid,
                      torch.where(has[:, None], end.to(F64), 0.0))
    torch.testing.assert_close(a.to(F64), b, rtol=1e-6, atol=1e-7)


def _recipe():
    """The benchmark's Cornell box recipe. tests/ has a module `scenes`
    too, which other test files import: the benchmark's package is
    imported in its place for the build, and the module put back after."""
    def ours():
        return [k for k in sys.modules if k.split(".")[0] == "scenes"]

    saved = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, BENCH)
    try:
        return harness.load_module("scenes", CFG["recipe"]).build(CFG, 0)
    finally:
        sys.path.remove(BENCH)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)


@pytest.fixture(scope="module")
def box():
    recipe = _recipe()
    scene, bvh, cam, _ = harness.build_program_scene(
        recipe, CFG["traversal"], torch.device("cpu"), W, H)
    return scene, bvh, cam, recipe


@pytest.mark.parametrize("cache_read", [False, True])
def test_render_sample_nrc_matches_reference(box, cache_read):
    scene, bvh, cam, recipe = box
    st = _state(out_scale=0.1 if cache_read else 0.0)
    stride, frame = 4, 5
    icfg = tcache.NRCIntegratorConfig(
        max_path_length=NET["max_path_length"], train_stride=stride,
        unbiased_fraction=NET["unbiased_fraction"])
    lo, hi = tcache.scene_aabb(scene)
    radiance, tq, tt, tm = tcache.render_sample_nrc(
        scene, bvh, cam, st["ema"], lo, hi, W, H, frame, icfg, NCFG)
    rscene = RefScene(recipe, None, None, False, F64, "cpu")
    pos, frame_m = camera_frame(recipe.camera["position"],
                                recipe.camera["target"], F64, "cpu")
    rcam = {"position": pos, "frame": frame_m,
            "fov_y": np.radians(recipe.camera["fov_y_deg"])}
    pix = torch.arange(W * H)
    icfg64 = {"train_stride": stride, "jitter": True,
              "unbiased_fraction": NET["unbiased_fraction"]}
    want, cached, rec = ref.sample(rscene, rcam, W, H, pix, frame,
                                   _f64(st["ema"]), NET, icfg64)
    assert compare.share(nrc_loop.mismatch(radiance, want, cached)) <= 0.02
    has = rec["row"] >= 0
    rows = rec["row"][has]
    L = NET["max_path_length"]
    assert int(tm.sum()) > 0
    bad = (tm.reshape(-1, L)[rows] != rec["valid"][has]).any(-1)
    bad |= compare.mismatch(tq.reshape(-1, L * 14)[rows],
                            rec["query"][has].reshape(-1, L * 14))
    bad |= nrc_loop.mismatch(tt.reshape(-1, L, 3)[rows],
                             rec["target"][has], rec["target_cached"][has])
    assert compare.share(bad) <= 0.02
    assert sorted(rows.tolist()) == list(range(W * H // stride))
