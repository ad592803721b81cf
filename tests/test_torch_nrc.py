"""The port's neural radiance cache (techniques/nrc: encodings, MLP, Adam
with the EMA, the cache-terminated path tracer) and its checkpoints
against gfxexp_tpu's, on the same numpy-seeded inputs and weights (JAX's
state carried into the port by nrc_state_from_jax).

Bars:
- encodings: TriangleWave atol 1e-6, OneBlob rtol 1e-6 (atol 1e-7), the
  hash grid rtol 1e-5 (atol 1e-9; measured 1.8e-11 absolute);
- the MLP: the bf16-rounded activations can move by 2^-8 relative where an
  accumulation-order ulp changes a rounding, so predictions within rtol
  1e-2 (atol 1e-4; measured 1.2e-7); gradients within rtol 1e-2 of the
  largest entry (measured 0 for the weights, 9e-10 for the hash table);
- one optimizer step from JAX's own gradients: params and EMA within 1e-6
  absolute (measured 6e-8), Adam's moments within 1e-6 of each leaf's
  largest entry (the second moment reaches ~20, where an ulp is 2e-6),
  the count equal; a whole train_step within 1e-5;
- train_on_frame with JAX's permutation (362 records, 4 steps: 2 records
  dropped), the loss within rtol 1e-5 and the params within 1e-5; and
  with a mask that leaves three of the four slices empty, whose losses
  count as 0 in the mean;
- propagate_targets: within 1e-6;
- render_sample_nrc at 24x24 (stride 8) and 20x21 (a lane count that is
  not a multiple of the stride: the trailing tile trains nowhere): masks
  equal; queries within 1e-5 but for the polar angles theta (columns 4
  and 6), within 2e-4, since arccos near the pole turns an ulp of a
  normal into 1e-4; with a zero output layer (no cache read) radiance and
  targets within a mean relative difference of 1e-5 (measured 4e-7);
  reading the cache, whose bf16 rounding follows the queries' ulps, 2e-3
  (measured 3-7e-4).
"""

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
from gfxexp_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from gfxexp_torch.render import camera as tcam  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.techniques.nrc import cache as tcache  # noqa: E402
from gfxexp_torch.techniques.nrc import encoding as tenc  # noqa: E402
from gfxexp_torch.techniques.nrc import network as tn  # noqa: E402
from gfxexp_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)
from gfxexp_tpu.render import camera as jcam  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402
from gfxexp_tpu.techniques.nrc import cache as jcache  # noqa: E402
from gfxexp_tpu.techniques.nrc import encoding as jenc  # noqa: E402
from gfxexp_tpu.techniques.nrc import network as jn  # noqa: E402

torch.set_num_threads(2)
ENCODINGS = ["triangle_wave", "hash_grid"]
CAM = dict(position=[0.0, 0.5, 1.9], fov_y=np.deg2rad(75), aspect=1.0,
           target=[0, 0.3, -1.0])


def _np(x):
    return np.asarray(x)


def _jax_state(enc, seed=1, out_scale=0.1):
    """JAX's fresh state with a non-zero output layer (params and EMA), so
    that predictions and gradients are not trivially 0."""
    cfg = jn.NRCConfig(position_encoding=enc)
    st = jn.init_nrc(jax.random.PRNGKey(seed), cfg)
    w = jax.random.normal(jax.random.PRNGKey(seed + 4),
                          st["params"]["weights"][-1].shape) * out_scale
    for part in ("params", "ema"):
        st[part]["weights"] = list(st[part]["weights"])
        st[part]["weights"][-1] = jnp.array(w)  # a buffer of its own
    return cfg, tn.NRCConfig(position_encoding=enc), st


def _port(jstate):
    return tn.nrc_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 device="cpu")


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.random((n, 14)).astype(np.float32)
    t = (rng.random((n, 3)) * 2.0).astype(np.float32)
    m = rng.random(n) < 0.8
    return q, t, m


def _j_loss(cfg, q, t, m):
    def loss(params):
        pred = jn.apply(params, jnp.asarray(q), cfg)
        lum = 0.2126 * pred[..., 0] + 0.7152 * pred[..., 1] + 0.0722 * pred[
            ..., 2]
        denom = jax.lax.stop_gradient(lum * lum) + 0.01
        per = jnp.sum((pred - jnp.asarray(t)) ** 2, axis=-1) / denom
        per = jnp.where(jnp.asarray(m), per, 0.0)
        return jnp.sum(per) / jnp.maximum(jnp.sum(jnp.asarray(m)), 1.0)
    return loss


def test_triangle_wave_and_one_blob_match_jax():
    rng = np.random.default_rng(0)
    x3 = rng.random((300, 3)).astype(np.float32)
    x5 = rng.random((300, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tenc.triangle_wave_encoding(torch.from_numpy(x3)).numpy(),
        _np(jenc.triangle_wave_encoding(jnp.asarray(x3))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tenc.one_blob_encoding(torch.from_numpy(x5)).numpy(),
        _np(jenc.one_blob_encoding(jnp.asarray(x5))), rtol=1e-6, atol=1e-7)


def test_hash_grid_matches_jax():
    """The one-gather hash grid against JAX's (which equals its naive
    per-level loop to rtol 1e-5), on JAX's table, corners included."""
    table = _np(jenc.init_hash_table(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(1)
    p = rng.random((400, 3)).astype(np.float32)
    p[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1],
             [0.25, 0.75, 1.0], [1e-7, 1 - 1e-7, 0.5], [0, 1, 0], [1, 0, 0]]
    a = tenc.hash_grid_encoding(torch.from_numpy(table.copy()),
                                torch.from_numpy(p)).numpy()
    b = _np(jenc.hash_grid_encoding(jnp.asarray(table), jnp.asarray(p)))
    assert a.shape == (400, tenc.HASH_LEVELS * tenc.HASH_FEATURES)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
    # the port's table is U(-1e-4, 1e-4) from a torch generator
    t = tenc.init_hash_table(torch.Generator().manual_seed(0), device="cpu")
    assert t.shape == table.shape and float(t.abs().max()) <= 1e-4


@pytest.mark.parametrize("enc", ENCODINGS)
def test_apply_and_gradients_match_jax(enc):
    jcfg, tcfg, jst = _jax_state(enc)
    tst = _port(jst)
    q, t, m = _batch(512)
    pa = tn.apply(tst["params"], torch.from_numpy(q), tcfg).numpy()
    pb = _np(jn.apply(jst["params"], jnp.asarray(q), jcfg))
    assert np.abs(pb).max() > 0.1
    np.testing.assert_allclose(pa, pb, rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(
        tn.infer(tst, torch.from_numpy(q), tcfg).numpy(),
        _np(jn.infer(jst, jnp.asarray(q), jcfg)), rtol=1e-2, atol=1e-4)
    jl, jg = jax.value_and_grad(_j_loss(jcfg, q, t, m))(jst["params"])
    tl, tg = tn.loss_and_grads(tst["params"], torch.from_numpy(q),
                               torch.from_numpy(t), torch.from_numpy(m), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        b = _np(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-2 * np.abs(b).max())


@pytest.mark.parametrize("enc", ENCODINGS)
def test_optimizer_step_from_jax_gradients(enc):
    """Adam (weight decay, bias correction, eps outside the root), -lr and
    the EMA, fed JAX's gradients, against optax's update: 1e-6. Two steps,
    so that the moments and the count carry."""
    jcfg, tcfg, jst = _jax_state(enc)
    tst = _port(jst)
    for k in range(2):
        q, t, m = _batch(256, seed=10 + k)
        _, jg = jax.value_and_grad(_j_loss(jcfg, q, t, m))(jst["params"])
        jst, _ = jn.train_step(jst, jnp.asarray(q), jnp.asarray(t),
                               jnp.asarray(m), jcfg)
        grads = tree_map(torch.from_numpy, jax.tree_util.tree_map(
            lambda x: np.array(x), jg))
        tst = tn.apply_step(tst, grads, tcfg)
        ref = _port(jst)
        for part in ("params", "ema"):
            for a, b in zip(tree_leaves(tst[part]), tree_leaves(ref[part])):
                assert a.dtype == b.dtype
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                           atol=1e-6, err_msg=part)
        # the moments to an ulp of each leaf's largest entry (the second
        # moment reaches ~20; the first cancels where 0.1 g ~ -0.9 mu)
        for a, b in zip(tree_leaves(tst["opt"]), tree_leaves(ref["opt"])):
            assert a.dtype == b.dtype
            b = b.numpy()
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())
        assert int(tst["step"]) == int(ref["step"]) == k + 1
        assert int(tst["opt"]["count"]) == k + 1


def test_train_step_matches_jax():
    jcfg, tcfg, jst = _jax_state("triangle_wave")
    tst = _port(jst)
    q, t, m = _batch(384, seed=3)
    jst2, jl = jn.train_step(jst, jnp.asarray(q), jnp.asarray(t),
                             jnp.asarray(m), jcfg)
    tst2, tl = tn.train_step(tst, torch.from_numpy(q), torch.from_numpy(t),
                             torch.from_numpy(m), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    ref = _port(jst2)
    for a, b in zip(tree_leaves(tst2["params"]), tree_leaves(ref["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("enc", ENCODINGS)
def test_train_on_frame_matches_jax(enc):
    """JAX's permutation passed in; 362 records in 4 steps drop the last 2
    (changing them changes nothing)."""
    jcfg, tcfg, jst = _jax_state(enc)
    tst = _port(jst)
    q, t, m = _batch(362, seed=5)
    key = jax.random.PRNGKey(7)
    perm = _np(jax.random.permutation(key, 362))
    jst2, jl = jn.train_on_frame(jst, jnp.asarray(q), jnp.asarray(t),
                                 jnp.asarray(m), key, jcfg, 4)
    tst2, tl = tn.train_on_frame(tst, torch.from_numpy(q),
                                 torch.from_numpy(t), torch.from_numpy(m),
                                 tcfg, 4, perm=perm)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    ref = _port(jst2)
    for a, b in zip(tree_leaves(tst2["params"]), tree_leaves(ref["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert int(tst2["step"]) == 4
    # the dropped tail: other values there give the same state
    t2 = t.copy()
    t2[perm[360:]] = 1e3
    tst3, tl3 = tn.train_on_frame(tst, torch.from_numpy(q),
                                  torch.from_numpy(t2), torch.from_numpy(m),
                                  tcfg, 4, perm=perm)
    assert float(tl3) == float(tl)
    for a, b in zip(tree_leaves(tst3["params"]),
                    tree_leaves(tst2["params"])):
        assert torch.equal(a, b)


def test_train_on_frame_counts_empty_slices():
    """Valid records only in the first of 4 slices: the loss is that
    slice's over 4, as in JAX."""
    jcfg, tcfg, jst = _jax_state("triangle_wave")
    tst = _port(jst)
    q, t, _ = _batch(400, seed=6)
    key = jax.random.PRNGKey(2)
    perm = _np(jax.random.permutation(key, 400))
    m = np.zeros(400, bool)
    m[perm[:100]] = True
    jst2, jl = jn.train_on_frame(jst, jnp.asarray(q), jnp.asarray(t),
                                 jnp.asarray(m), key, jcfg, 4)
    tst2, tl = tn.train_on_frame(tst, torch.from_numpy(q),
                                 torch.from_numpy(t), torch.from_numpy(m),
                                 tcfg, 4, perm=perm)
    _, first = tn.train_step(tst, torch.from_numpy(q[perm[:100]]),
                             torch.from_numpy(t[perm[:100]]),
                             torch.from_numpy(m[perm[:100]]), tcfg)
    np.testing.assert_allclose(float(tl), float(first) / 4, rtol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_train_on_frame_generator_is_deterministic():
    _, tcfg, jst = _jax_state("triangle_wave")
    q, t, m = (torch.from_numpy(x) for x in _batch(200, seed=8))
    runs = [tn.train_on_frame(_port(jst), q, t, m, tcfg, 4,
                              torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert float(runs[0][1]) == float(runs[1][1])
    fresh = tn.init_nrc(torch.Generator().manual_seed(0), tcfg, "cpu")
    again = tn.init_nrc(None, tcfg, "cpu")
    for a, b in zip(tree_leaves(fresh), tree_leaves(again)):
        assert torch.equal(a, b)
    assert float(fresh["params"]["weights"][-1].abs().max()) == 0.0


def test_propagate_targets_matches_jax():
    rng = np.random.default_rng(4)
    n, L = 50, 5
    direct = rng.random((n, L, 3)).astype(np.float32)
    thru = rng.random((n, L, 3)).astype(np.float32)
    valid = rng.random((n, L)) < 0.7
    pred = rng.random((n, 3)).astype(np.float32)
    has = rng.random(n) < 0.5
    a = tcache.propagate_targets(*map(torch.from_numpy,
                                      (direct, thru, valid, pred, has)))
    b = jcache.propagate_targets(*map(jnp.asarray,
                                      (direct, thru, valid, pred, has)))
    np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-6)
    # tests/test_nrc.py's hand-worked chain
    d = torch.tensor([[[1.0, 0, 0], [0.5, 0, 0], [0.25, 0, 0]]])
    out = tcache.propagate_targets(d, torch.full((1, 3, 3), 0.5),
                                   torch.ones(1, 3, dtype=torch.bool),
                                   torch.tensor([[8.0, 0, 0]]),
                                   torch.tensor([True]))
    assert torch.allclose(out[0, :, 0], torch.tensor([2.3125, 2.625, 4.25]))


@pytest.fixture(scope="module")
def box():
    js, jb = jcompile(S.box_scene(JB))
    ts, tb = tcompile(S.box_scene(TB))
    return dict(js=js, jb=jb, ts=ts, tb=tb, jlo=jcache.scene_aabb(js),
                tlo=tcache.scene_aabb(ts))


def _render_pair(b, w, h, sidx, zero_out):
    jcfg, tcfg, jst = _jax_state("triangle_wave", seed=0)
    ema = jst["ema"]
    if zero_out:
        ema["weights"][-1] = ema["weights"][-1] * 0.0
    tema = tree_map(lambda x: torch.from_numpy(np.array(x)), ema)
    jic = jcache.NRCIntegratorConfig(train_stride=8)
    tic = tcache.NRCIntegratorConfig(train_stride=8)
    jr = jcache.render_sample_nrc(
        b["js"], b["jb"], jcam.make_camera(**dict(CAM, aspect=w / h)), ema,
        *b["jlo"], w, h, jnp.uint32(sidx), jic, jcfg)
    tr = tcache.render_sample_nrc(
        b["ts"], b["tb"], tcam.make_camera(**dict(CAM, aspect=w / h)), tema,
        *b["tlo"], w, h, sidx, tic, tcfg)
    return [x.numpy() for x in tr], [_np(x) for x in jr]


@pytest.mark.parametrize("size,sidx", [((24, 24), 0), ((24, 24), 17),
                                       ((20, 21), 3)])
@pytest.mark.parametrize("zero_out", [True, False])
def test_render_sample_nrc_matches_jax(box, size, sidx, zero_out):
    (rad, q, tgt, mask), (jrad, jq, jtgt, jmask) = _render_pair(
        box, *size, sidx, zero_out)
    w, h = size
    assert rad.shape == (w * h, 3) and np.isfinite(rad).all()
    assert q.shape == ((w * h // 8) * 5, 14) and tgt.shape[0] == q.shape[0]
    np.testing.assert_array_equal(mask, jmask)
    assert 0 < mask.sum() < mask.size
    polar = [4, 6]
    rest = [c for c in range(14) if c not in polar]
    np.testing.assert_allclose(q[:, rest], jq[:, rest], rtol=0, atol=1e-5)
    np.testing.assert_allclose(q[:, polar], jq[:, polar], rtol=0, atol=2e-4)
    bar = 1e-5 if zero_out else 2e-3
    assert S.image_rel_diff(rad, jrad) < bar
    assert S.image_rel_diff(tgt[mask], jtgt[jmask]) < bar
    assert rad.mean() > 0 and tgt[mask].mean() > 0


def test_unbiased_tiles_ignore_the_cache(box, monkeypatch):
    """tests/test_nrc.py's check on the port: with every suffix unbiased
    (unbiased_fraction 1) and terminals forced on every bounce, the
    targets do not depend on the cache's weights; with the default
    fraction they do."""
    monkeypatch.setattr(tcache, "PATH_TERMINATION_FACTOR", 0.0)
    tcfg = tn.NRCConfig()
    cam = tcam.make_camera(**CAM)
    p_a = tn.init_nrc(torch.Generator().manual_seed(0), tcfg, "cpu")["ema"]
    p_b = tree_map(lambda x: x * 3.0 + 0.1, tn.init_nrc(
        torch.Generator().manual_seed(7), tcfg, "cpu")["ema"])

    def targets(params, uf):
        ic = tcache.NRCIntegratorConfig(max_path_length=4, train_stride=8,
                                        unbiased_fraction=uf)
        _, _, tt, tm = tcache.render_sample_nrc(
            box["ts"], box["tb"], cam, params, *box["tlo"], 24, 24, 3, ic,
            tcfg)
        return tt.numpy(), tm.numpy()

    ta, ma = targets(p_a, 1)
    tb, mb = targets(p_b, 1)
    assert (ma == mb).all() and np.allclose(ta[ma], tb[mb])
    ta16, ma16 = targets(p_a, 16)
    tb16, _ = targets(p_b, 16)
    assert ma16.any() and not np.allclose(ta16[ma16], tb16[ma16])


def test_checkpoint_round_trip(tmp_path):
    tcfg = tn.NRCConfig(position_encoding="hash_grid", num_hidden_layers=1)
    st = tn.init_nrc(torch.Generator().manual_seed(1), tcfg, "cpu")
    q, t, m = (torch.from_numpy(x) for x in _batch(64))
    st, _ = tn.train_step(st, q, t, m, tcfg)
    path = str(tmp_path / "nrc.npz")
    save_checkpoint(path, st)
    like = tn.init_nrc(torch.Generator().manual_seed(2), tcfg, "cpu")
    back = load_checkpoint(path, like=like)
    assert sorted(back) == sorted(st)
    for a, b in zip(tree_leaves(back), tree_leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the file holds no pickle, and the structure is checked
    with np.load(path, allow_pickle=False) as data:
        assert len(data.files) == len(tree_leaves(st)) + 1
    other = tn.init_nrc(torch.Generator().manual_seed(2), tn.NRCConfig(),
                        "cpu")
    with pytest.raises(ValueError):
        load_checkpoint(path, like=other)
    with pytest.raises(ValueError):
        load_checkpoint(path)
    single = str(tmp_path / "one.npz")
    save_checkpoint(single, torch.arange(5))
    assert torch.equal(load_checkpoint(single), torch.arange(5))


def test_nrc_app_checkpoint_and_resume(tmp_path):
    """-checkpoint writes the state the frames trained; -resume starts the
    next run from it (a run of 0 frames saves it back unchanged)."""
    from gfxexp_torch.apps import neural_radiance_caching as app

    ck, ck2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    base = ["-device", "cpu", "-width", "16", "-height", "16",
            "-output", str(tmp_path / "n")]
    hdr = app.main(base + ["-frames", "2", "-checkpoint", ck,
                           "-visualize-cache"])
    assert hdr.shape == (16, 16, 3) and np.isfinite(hdr).all()
    assert (tmp_path / "n_cache.png").exists()
    app.main(base + ["-frames", "0", "-resume", ck, "-checkpoint", ck2])
    like = tn.init_nrc(None, tn.NRCConfig(), "cpu")
    a, b = load_checkpoint(ck, like=like), load_checkpoint(ck2, like=like)
    assert int(a["step"]) == 8
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
