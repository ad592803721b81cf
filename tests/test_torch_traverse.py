"""The port's wide-row walk (gfxexp_torch/accel/persistent.py) against
gfxexp_tpu's persistent Pallas kernel, run in interpret mode as
tests/test_persistent.py runs it (rows=8, pool=16), and against the
brute-force oracle. On the CPU the wrappers run the plain version; the CUDA
kernel is compared with it on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfxexp_torch.accel.persistent import (
    intersect_any_widerow,
    intersect_closest_widerow,
    walk_cuda,
    walk_plain,
)
from gfxexp_torch.accel.traverse import (
    intersect_any,
    intersect_closest,
    intersect_closest_brute,
)
from gfxexp_torch.accel.widerow import build_widerow as t_build
from gfxexp_torch.csrc import build as kbuild
from gfxexp_torch.scene.types import TriangleSoA as TSoA
from gfxexp_torch.utils import trace
from gfxexp_tpu.accel.pallas_persistent import (
    intersect_any_persistent,
    intersect_closest_persistent,
)
from gfxexp_tpu.accel.pallas_widestack import build_widerow as j_build
from gfxexp_tpu.accel.traverse import intersect_closest_brute as j_brute
from gfxexp_tpu.scene.types import TriangleSoA as JSoA

torch.set_num_threads(1)


def _soup(seed, n=400):
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=(n, 3)).astype(np.float32)
    e1 = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    return p0, e1, e2


def _rays(seed, nr):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(nr, 3)) * 3).astype(np.float32)
    d = rng.normal(size=(nr, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jsoa(p0, e1, e2):
    z3 = jnp.zeros_like(jnp.asarray(p0))
    z2 = jnp.zeros((p0.shape[0], 2), jnp.float32)
    return JSoA(p0=jnp.asarray(p0), e1=jnp.asarray(e1), e2=jnp.asarray(e2),
                n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
                unit_id=jnp.zeros((p0.shape[0],), jnp.int32))


def _tsoa(p0, e1, e2):
    z3 = torch.zeros(p0.shape)
    z2 = torch.zeros((p0.shape[0], 2))
    return TSoA(p0=torch.from_numpy(p0), e1=torch.from_numpy(e1),
                e2=torch.from_numpy(e2), n0=z3, n1=z3, n2=z3, uv0=z2,
                uv1=z2, uv2=z2,
                unit_id=torch.zeros(p0.shape[0], dtype=torch.int32))


def _both(seed, n=400, arity=4):
    """Both packages' tables for one soup (they are byte-identical) and the
    leaf-order triangles."""
    p0, e1, e2 = _soup(seed, n)
    jb, jperm = j_build(p0, e1, e2, arity=arity)
    tb, tperm = t_build(p0, e1, e2, arity=arity)
    np.testing.assert_array_equal(np.asarray(jperm), tperm)
    q = (p0[tperm], e1[tperm], e2[tperm])
    return jb, tb, q


def _check_closest(h, ref):
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(ref.tri))
    m = np.asarray(ref.hit)
    np.testing.assert_allclose(h.t.numpy()[m], np.asarray(ref.t)[m],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h.u.numpy()[m], np.asarray(ref.u)[m],
                               atol=2e-3)


@pytest.mark.parametrize("arity", [4, 8])
def test_closest_matches_brute(arity):
    jb, tb, q = _both(1234, arity=arity)
    o, d = _rays(99, 3000)
    h = intersect_closest_widerow(tb, torch.from_numpy(o),
                                  torch.from_numpy(d))
    _check_closest(h, j_brute(_jsoa(*q), jnp.asarray(o), jnp.asarray(d)))
    # the port's own oracle agrees with the reference's
    _check_closest(intersect_closest_brute(_tsoa(*q), torch.from_numpy(o),
                                           torch.from_numpy(d)),
                   j_brute(_jsoa(*q), jnp.asarray(o), jnp.asarray(d)))


def test_closest_matches_jax_persistent():
    jb, tb, q = _both(7)
    o, d = _rays(8, 3000)
    ref = intersect_closest_persistent(jb, _jsoa(*q), jnp.asarray(o),
                                       jnp.asarray(d), rows=8, pool=16)
    h = intersect_closest(tb, None, torch.from_numpy(o), torch.from_numpy(d))
    _check_closest(h, ref)
    miss = ~h.hit
    assert (h.tri[miss] == -1).all() and (h.t[miss] == 1e30).all()
    assert (h.u[miss] == 0).all() and (h.v[miss] == 0).all()


def test_anyhit_matches_jax_persistent():
    """Per-ray t_max including dead lanes (t_max < 0: no work, never hit)."""
    jb, tb, q = _both(21)
    o, d = _rays(22, 2000)
    idx = np.arange(2000)
    t_max = np.where(idx % 5 == 0, -1.0,
                     2.0 + (idx % 7)).astype(np.float32)
    ref = np.asarray(intersect_any_persistent(
        jb, _jsoa(*q), jnp.asarray(o), jnp.asarray(d),
        t_max=jnp.asarray(t_max), rows=8, pool=16))
    got = intersect_any(tb, None, torch.from_numpy(o), torch.from_numpy(d),
                        t_max=torch.from_numpy(t_max)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[::5].any()
    # the accepted triangle of any hit is a real hit within [t_min, t_max)
    h = walk_plain(tb, torch.from_numpy(o), torch.from_numpy(d), 1e-4,
                   torch.from_numpy(t_max), any_hit=True)
    m = h.hit.numpy()
    assert (h.t.numpy()[m] < t_max[m]).all() and (h.tri.numpy()[m] >= 0).all()


@pytest.mark.parametrize("nr", [37, 1024, 2000])
def test_ragged_ray_counts_match_jax_persistent(nr):
    jb, tb, q = _both(5, n=120)
    o, d = _rays(nr, nr)
    ref = intersect_closest_persistent(jb, _jsoa(*q), jnp.asarray(o),
                                       jnp.asarray(d), rows=8, pool=32)
    h = intersect_closest_widerow(tb, torch.from_numpy(o),
                                  torch.from_numpy(d))
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(ref.tri))


def test_cpu_tensors_never_launch_the_kernel():
    _, tb, _ = _both(3, n=64)
    o, d = _rays(4, 256)
    trace.reset_counters("walk.kernel1.")
    intersect_closest_widerow(tb, torch.from_numpy(o), torch.from_numpy(d))
    intersect_any_widerow(tb, torch.from_numpy(o), torch.from_numpy(d))
    assert trace.counters("walk.kernel1.") == {}
    with pytest.raises(ValueError):
        walk_cuda(tb, torch.from_numpy(o), torch.from_numpy(d), 1e-4, 1e30,
                  any_hit=False)


def test_bad_inputs_raise():
    _, tb, _ = _both(3, n=64)
    o, d = _rays(4, 16)
    with pytest.raises(ValueError):
        intersect_closest_widerow(tb, torch.from_numpy(o).double(),
                                  torch.from_numpy(d).double())
    with pytest.raises(ValueError):
        intersect_closest_widerow(tb, torch.from_numpy(o)[:, :2],
                                  torch.from_numpy(d)[:, :2])
    with pytest.raises(TypeError):
        intersect_closest(object(), None, torch.from_numpy(o),
                          torch.from_numpy(d))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """Without a compiler the kernel cannot be built, and load_library
    raises instead of falling back."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kbuild, "_libs", {})
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    real_exists = kbuild.os.path.exists
    monkeypatch.setattr(kbuild.os.path, "exists",
                        lambda p: False if p.endswith("nvcc")
                        else real_exists(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        kbuild.load_library("widerow_traverse")

