"""The port's interval and affine arithmetic (core/interval.py) and Perlin
noise (core/noise.py) against gfxexp_tpu's on the same inputs, made from
numpy seeds.

Bars: every interval and affine operation equal bit for bit (each is a
handful of float32 operations in the same order); perlin3d and
multi_octave_perlin3d within atol 1e-6, the permutation table equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfxexp_torch.core import interval as TI
from gfxexp_torch.core import noise as TN
from gfxexp_tpu.core import interval as JI
from gfxexp_tpu.core import noise as JN

torch.set_num_threads(2)


def _pair(rng, n=512, scale=3.0):
    """Intervals [lo, hi] with some straddling 0, some tiny, some equal."""
    a = rng.normal(size=n).astype(np.float32) * scale
    b = rng.normal(size=n).astype(np.float32) * scale
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    hi[: n // 8] = lo[: n // 8]
    return lo, hi


def _eq(t, j):
    if isinstance(t, tuple):
        for x, y in zip(t, j):
            _eq(x, y)
        return
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


IV_BINARY = ["iv_add", "iv_sub", "iv_mul", "iv_overlaps"]
IV_UNARY = ["iv_neg", "iv_sqr", "iv_recip", "iv_sqrt"]


@pytest.mark.parametrize("name", IV_BINARY + IV_UNARY + ["iv_scale"])
def test_interval_ops_match_jax(name):
    rng = np.random.default_rng(len(name))
    a = _pair(rng)
    b = _pair(rng)
    ta = tuple(torch.from_numpy(x) for x in a)
    tb = tuple(torch.from_numpy(x) for x in b)
    ja = tuple(jnp.asarray(x) for x in a)
    jb = tuple(jnp.asarray(x) for x in b)
    tf, jf = getattr(TI, name), getattr(JI, name)
    if name in IV_BINARY:
        _eq(tf(ta, tb), jf(ja, jb))
    elif name == "iv_scale":
        s = rng.normal(size=a[0].shape).astype(np.float32)
        _eq(tf(ta, torch.from_numpy(s)), jf(ja, jnp.asarray(s)))
    else:
        _eq(tf(ta), jf(ja))
    _eq(TI.iv(ta[0]), JI.iv(ja[0]))


def _aa(mod, lib, c0, cs, r):
    return lib(c0), lib(cs), lib(r)


@pytest.mark.parametrize("name", ["aa_add", "aa_sub", "aa_mul", "aa_sqr",
                                  "aa_scale", "aa_to_iv", "aa_rad",
                                  "aa_poly2", "aa_var", "aa_const"])
def test_affine_ops_match_jax(name):
    rng = np.random.default_rng(100 + len(name))
    n, k = 256, 3
    parts = [(rng.normal(size=n).astype(np.float32),
              rng.normal(size=(n, k)).astype(np.float32) * 0.3,
              np.abs(rng.normal(size=n)).astype(np.float32) * 0.1)
             for _ in range(2)]
    ta = tuple(torch.from_numpy(x) for x in parts[0])
    tb = tuple(torch.from_numpy(x) for x in parts[1])
    ja = tuple(jnp.asarray(x) for x in parts[0])
    jb = tuple(jnp.asarray(x) for x in parts[1])
    c = rng.normal(size=(3, n)).astype(np.float32)
    tf, jf = getattr(TI, name), getattr(JI, name)
    if name in ("aa_add", "aa_sub", "aa_mul"):
        _eq(tf(ta, tb), jf(ja, jb))
    elif name in ("aa_sqr", "aa_to_iv", "aa_rad"):
        _eq(tf(ta), jf(ja))
    elif name == "aa_scale":
        _eq(tf(ta, torch.from_numpy(c[0])), jf(ja, jnp.asarray(c[0])))
    elif name == "aa_poly2":
        _eq(tf(*(torch.from_numpy(x) for x in c), ta),
            jf(*(jnp.asarray(x) for x in c), ja))
    elif name == "aa_var":
        lo, hi = np.sort(c[:2], axis=0)
        _eq(tf(torch.from_numpy(lo), torch.from_numpy(hi), 1, k),
            jf(jnp.asarray(lo), jnp.asarray(hi), 1, k))
    else:
        _eq(tf(torch.from_numpy(c[0]), k), jf(jnp.asarray(c[0]), k))


def test_perlin_matches_jax():
    rng = np.random.default_rng(5)
    p = (rng.normal(size=(4096, 3)) * 6.0).astype(np.float32)
    np.testing.assert_array_equal(TN._perm_table(torch.device("cpu"))
                                  .numpy(), np.asarray(JN._perm_table()))
    tp = TN.perlin3d(torch.from_numpy(p)).numpy()
    jp = np.asarray(JN.perlin3d(jnp.asarray(p)))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    assert tp.std() > 0.1
    # lattice points have zero noise
    lat = np.floor(p[:64])
    assert np.abs(TN.perlin3d(torch.from_numpy(lat)).numpy()).max() == 0.0


@pytest.mark.parametrize("octaves, persistence, frequency",
                         [(4, 0.5, 1.0), (6, 0.6, 2.5), (1, 0.5, 0.7)])
def test_multi_octave_perlin_matches_jax(octaves, persistence, frequency):
    rng = np.random.default_rng(octaves)
    p = (rng.normal(size=(2048, 3)) * 3.0).astype(np.float32)
    tp = TN.multi_octave_perlin3d(torch.from_numpy(p), octaves, persistence,
                                  frequency).numpy()
    jp = np.asarray(JN.multi_octave_perlin3d(jnp.asarray(p), octaves,
                                             persistence, frequency))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
