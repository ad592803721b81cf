"""The port's SVGF (techniques/svgf.py) against gfxexp_tpu's, pass by pass,
on the same numpy-seeded inputs at 32x32, and the properties of
tests/test_svgf.py run on the port.

The G-buffer is synthetic (seeded): two surfaces of different depth slope,
normal, unit and material, a block of miss pixels (depth inf), albedos
with some below the 0.001 clamp, and per-pixel motion of up to ~2 pixels,
so the reprojection's taps land in and out of the image and on both
surfaces. JAX's passes run jitted (svgf_frame is; the others are wrapped
in jax.jit here, which is many times faster than their eager op-by-op
dispatch); XLA may contract multiply-adds there.

Bars (absolute, unless said): temporal_accumulate's colour and moments
within 1e-6 and its count equal; estimate_variance within 1e-6; each
à-trous kernel's colour within 1e-5 and variance within 1e-6; taa within
1e-6; svgf_frame over 3 frames: the mean relative image difference under
1e-5 and every pixel within 1e-4 (the weights raise a normal's dot product
to the power 128 and take exp of depth and luminance distances, where
XLA's and torch's exp and pow may differ by an ulp, and XLA contracts the
jitted frame's multiply-adds). Measured on these inputs: temporal 2.4e-7,
variance 4.9e-7, à-trous colour 3.1e-6 and variance 2.8e-7, svgf_frame
3.6e-7 relative and 4.8e-6 per pixel.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

from gfxexp_torch.render.gbuffer import GBuffer as TGBuffer  # noqa: E402
from gfxexp_torch.techniques import svgf as tsv  # noqa: E402
from gfxexp_torch.techniques.svgf import SVGFState  # noqa: E402
from gfxexp_tpu.render.gbuffer import GBuffer as JGBuffer  # noqa: E402
from gfxexp_tpu.techniques import svgf as jsv  # noqa: E402

torch.set_num_threads(2)
H = W = 32
KERNELS = (tsv.ATROUS_BOX3, tsv.ATROUS_GAUSS3, tsv.ATROUS_GAUSS5)
_jit = functools.partial(jax.jit, static_argnames=("cfg",))
J_TEMPORAL = _jit(jsv.temporal_accumulate)
J_VARIANCE = _jit(jsv.estimate_variance)
J_ATROUS = jax.jit(jsv.atrous_stage, static_argnames=("cfg", "step"))
J_TAA = _jit(jsv.taa)


def synthetic_gbuffer(seed: int, motion_scale: float = 0.8) -> dict:
    """numpy planes of a G-buffer (see the module docstring)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    left = xx < W // 2 + 3
    depth = np.where(left, 2.0 + 0.03 * xx + 0.01 * yy, 3.5 - 0.02 * yy)
    depth = (depth + rng.normal(0, 1e-3, (H, W))).astype(np.float32)
    n = np.where(left[..., None], [0.0, 0.0, 1.0], [0.6, 0.0, 0.8])
    n = n + rng.normal(0, 0.03, (H, W, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    hit = np.ones((H, W), bool)
    hit[2:7, 20:27] = False
    pos = np.stack([0.05 * xx, 0.05 * yy, -depth], -1).astype(np.float32)
    albedo = rng.uniform(0.05, 0.9, (H, W, 3)).astype(np.float32)
    albedo[rng.random((H, W)) < 0.05] = 5e-4
    unit = np.where(left, 0, 1).astype(np.int32)
    motion = rng.normal(0, motion_scale, (H, W, 2)).astype(np.float32)
    hm = hit[..., None]
    planes = dict(
        position=np.where(hm, pos, 0), normal=np.where(hm, n, 0),
        geom_normal=np.where(hm, n, 0), albedo=np.where(hm, albedo, 0),
        emittance=np.zeros((H, W, 3)),
        texcoord=np.where(hm, rng.random((H, W, 2)), 0),
        motion=np.where(hm, motion, 0), depth=np.where(hit, depth, np.inf),
        tri=np.where(hit, unit, -1), bary=rng.random((H, W, 2)),
        unit=np.where(hit, unit, -1), material=np.where(hit, unit + 3, -1),
        hit=hit,
        view_dir=np.broadcast_to([0.0, 0.0, -1.0], (H, W, 3)))
    return {k: (v.astype(np.float32) if v.dtype.kind == "f"
                else v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in planes.items()}


def both(planes):
    """(port GBuffer, JAX GBuffer) of the same planes."""
    return (TGBuffer(**{k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in planes.items()}),
            JGBuffer(**{k: jnp.asarray(v) for k, v in planes.items()}))


def lighting(seed):
    return np.random.default_rng(seed).gamma(
        2.0, 0.3, (H, W, 3)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def history(seed):
    """A previous frame's state with a history (count 1-6), as numpy."""
    rng = np.random.default_rng(seed)
    prev = synthetic_gbuffer(seed + 1)
    return dict(
        prev_noisy=rng.gamma(2.0, 0.3, (H, W, 3)).astype(np.float32),
        moments=rng.uniform(0.0, 0.5, (H, W, 2)).astype(np.float32),
        sample_count=rng.integers(1, 7, (H, W)).astype(np.float32),
        prev_position=prev["position"], prev_normal=prev["normal"],
        prev_unit=prev["unit"], prev_material=prev["material"],
        taa_history=rng.gamma(2.0, 0.3, (H, W, 3)).astype(np.float32),
        first_frame=np.asarray(False))


def states(seed):
    h = history(seed)
    return (SVGFState(**{k: _t(v) for k, v in h.items()}),
            jsv.SVGFState(**{k: jnp.asarray(v) for k, v in h.items()}))


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def test_temporal_accumulate_matches_jax():
    tgb, jgb = both(synthetic_gbuffer(1))
    tst, jst = states(2)
    dem = lighting(3)
    out = tsv.temporal_accumulate(tst, tgb, _t(dem), tsv.SVGFConfig())
    jout = J_TEMPORAL(jst, jgb, jnp.asarray(dem), cfg=jsv.SVGFConfig())
    # the reprojection found history for most pixels, and not for all
    valid = tsv._reproject(tst, tgb, tsv.SVGFConfig())[3].numpy()
    assert 0.3 < valid.mean() < 1.0
    close(out[0], jout[0], 1e-6)
    close(out[1], jout[1], 1e-6)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
    off = tsv.temporal_accumulate(
        tst, tgb, _t(dem), tsv.SVGFConfig(enable_temporal_accumulation=False))
    assert (off[2] == 1).all() and torch.equal(off[0], _t(dem))


def test_estimate_variance_matches_jax():
    planes = synthetic_gbuffer(4)
    rng = np.random.default_rng(5)
    mom = rng.uniform(0.0, 0.5, (H, W, 2)).astype(np.float32)
    count = rng.integers(1, 7, (H, W)).astype(np.float32)
    args = [planes["depth"], planes["normal"], planes["hit"]]
    var = tsv.estimate_variance(_t(mom), _t(count), *map(_t, args),
                                tsv.SVGFConfig())
    jvar = J_VARIANCE(jnp.asarray(mom), jnp.asarray(count),
                      *map(jnp.asarray, args), cfg=jsv.SVGFConfig())
    assert torch.isfinite(var).all()
    close(var, jvar, 1e-6)


@pytest.mark.parametrize("kernel", KERNELS)
def test_atrous_stage_matches_jax(kernel):
    """Each kernel at one step width (1, 2 and 4)."""
    planes = synthetic_gbuffer(6)
    color = lighting(7)
    var = np.random.default_rng(8).uniform(0, 0.2, (H, W)).astype(np.float32)
    args = [color, var, planes["depth"], planes["normal"], planes["hit"]]
    step = {tsv.ATROUS_BOX3: 1, tsv.ATROUS_GAUSS3: 2,
            tsv.ATROUS_GAUSS5: 4}[kernel]
    out = tsv.atrous_stage(*map(_t, args), step,
                           tsv.SVGFConfig(atrous_kernel=kernel))
    jout = J_ATROUS(*map(jnp.asarray, args), step=step,
                    cfg=jsv.SVGFConfig(atrous_kernel=kernel))
    close(out[0], jout[0], 1e-5)
    close(out[1], jout[1], 1e-6)


def test_taa_matches_jax():
    planes = synthetic_gbuffer(9, motion_scale=1.5)
    color, hist = lighting(10), lighting(11)
    for first in (False, True):
        out = tsv.taa(_t(color), _t(hist), _t(planes["motion"]),
                      torch.tensor(first), tsv.SVGFConfig())
        jout = J_TAA(jnp.asarray(color), jnp.asarray(hist),
                     jnp.asarray(planes["motion"]), jnp.asarray(first),
                     cfg=jsv.SVGFConfig())
        close(out, jout, 1e-6)
    assert torch.equal(out, _t(color))  # the first frame has no history


@pytest.mark.parametrize("cfg", [
    {}, {"feedback_1st_filtered": True, "atrous_kernel": tsv.ATROUS_GAUSS5,
         "num_filter_stages": 3, "enable_taa": False},
    {"enable_svgf": False, "enable_temporal_accumulation": False}],
    ids=["default", "feedback_gauss5_no_taa", "no_svgf_no_temporal"])
def test_svgf_frame_matches_jax(cfg):
    """Three frames with motion from a fresh state; each frame's G-buffer
    and lighting made anew from the seed."""
    tst = tsv.make_svgf_state(W, H, "cpu")
    jst = jsv.make_svgf_state(W, H)
    for f in range(3):
        tgb, jgb = both(synthetic_gbuffer(20 + f))
        light = lighting(30 + f)
        out, tst = tsv.svgf_frame(tst, tgb, _t(light), tsv.SVGFConfig(**cfg))
        jout, jst = jsv.svgf_frame(jst, jgb, jnp.asarray(light),
                                   jsv.SVGFConfig(**cfg))
        assert out.shape == (H, W, 3) and torch.isfinite(out).all()
        assert S.image_rel_diff(out.numpy(), np.asarray(jout)) < 1e-5
        close(out, jout, 1e-4)
    for name in ("prev_noisy", "moments", "sample_count", "taa_history"):
        close(getattr(tst, name), getattr(jst, name), 1e-4)
    assert not bool(tst.first_frame)


def test_shift_fills_and_keeps_masks_first():
    """Shifted neighbours outside the image read the fill value (inf for
    depth, False for hit), for float and bool planes alike."""
    d = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    s = tsv._shift(d, 1, -2, fill=float("inf"))
    assert torch.equal(s[:2, 2:], d[1:, :2]) and torch.isinf(s[2]).all()
    assert torch.isinf(s[:, :2]).all()
    b = tsv._shift(torch.ones(3, 4, dtype=torch.bool), -1, 1, fill=False)
    assert b.dtype == torch.bool and not b[0].any() and not b[:, 3].any()
    assert b[1:, :3].all()
    assert not tsv._shift(d, 5, 0).any()


# ---------------------------------------------------------------------------
# the properties of tests/test_svgf.py, on the port
# ---------------------------------------------------------------------------


def _flat_gbuffer(normal=(0.0, 0.0, 1.0), depth=2.0, albedo=0.5):
    n = torch.tensor(normal, dtype=torch.float32).expand(H, W, 3)
    return TGBuffer(
        position=torch.zeros(H, W, 3), normal=n, geom_normal=n,
        albedo=torch.full((H, W, 3), albedo), emittance=torch.zeros(H, W, 3),
        texcoord=torch.zeros(H, W, 2), motion=torch.zeros(H, W, 2),
        depth=torch.full((H, W), depth), tri=torch.zeros(H, W, dtype=torch.int32),
        bary=torch.zeros(H, W, 2), unit=torch.zeros(H, W, dtype=torch.int32),
        material=torch.zeros(H, W, dtype=torch.int32),
        hit=torch.ones(H, W, dtype=torch.bool),
        view_dir=torch.tensor([0.0, 0.0, -1.0]).expand(H, W, 3))


@pytest.mark.parametrize("kernel", KERNELS)
def test_atrous_preserves_constant_and_denoises(kernel):
    gb = _flat_gbuffer()
    cfg = tsv.SVGFConfig(atrous_kernel=kernel)
    const = torch.full((H, W, 3), 0.7)
    var = torch.full((H, W), 0.1)
    out, var_out = tsv.atrous_stage(const, var, gb.depth, gb.normal, gb.hit,
                                    2, cfg)
    assert torch.allclose(out, const, atol=1e-5)
    assert (var_out <= 0.1 + 1e-6).all()
    g = torch.Generator().manual_seed(0)
    noisy = 0.5 + 0.2 * torch.randn(H, W, 3, generator=g)
    out, _ = tsv.atrous_stage(noisy, torch.full((H, W), 0.04), gb.depth,
                              gb.normal, gb.hit, 1, cfg)
    assert out.std() < noisy.std()


def test_temporal_convergence_static_scene():
    """A static scene and noisy 1-spp inputs: the output's spread across
    pixels is far below the input's (~0.28)."""
    gb = _flat_gbuffer()
    state = tsv.make_svgf_state(W, H, "cpu")
    rng = np.random.default_rng(1234)
    for _ in range(12):
        noise = rng.gamma(2.0, 0.2, size=(H, W, 1)).astype(np.float32)
        out, state = tsv.svgf_frame(state, gb,
                                    torch.from_numpy(np.repeat(noise, 3, 2)))
    inner = out[4:-4, 4:-4, 0]
    assert abs(float(inner.mean()) - 0.4) < 0.08
    assert float(inner.std()) < 0.03


def test_edge_stopping_across_normals():
    """Two halves with opposing normals and different lighting: the filter
    does not leak across the edge."""
    nx = torch.tensor([1.0, 0.0, 0.0]).expand(H, W // 2, 3)
    nz = torch.tensor([0.0, 0.0, 1.0]).expand(H, W // 2, 3)
    gb = _flat_gbuffer()
    normal = torch.cat([nx, nz], dim=1)
    color = torch.cat([torch.full((H, W // 2, 3), 0.2),
                       torch.full((H, W // 2, 3), 0.9)], dim=1)
    var = torch.full((H, W), 0.05)
    out = color
    for step in (1, 2, 4):
        out, var = tsv.atrous_stage(out, var, gb.depth, normal, gb.hit, step,
                                    tsv.SVGFConfig())
    assert torch.allclose(out[:, :W // 2 - 1], torch.tensor(0.2), atol=1e-3)
    assert torch.allclose(out[:, W // 2 + 1:], torch.tensor(0.9), atol=1e-3)


def test_demodulation_roundtrip():
    light = torch.from_numpy(np.random.default_rng(0).uniform(
        0.1, 1.0, (H, W, 3)).astype(np.float32))
    albedo = torch.full((H, W, 3), 0.5)
    dem = tsv.demodulate_albedo(light, albedo)
    assert torch.allclose(dem * albedo, light, atol=1e-5)
    # a tiny albedo is clamped to zero: no inf or nan
    assert (tsv.demodulate_albedo(light, torch.full((H, W, 3), 1e-4))
            == 0).all()
