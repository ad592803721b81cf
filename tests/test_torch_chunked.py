"""The port's chunked wide-row tables and kernel 2's plain walk
(gfxexp_torch/accel/widerow.py, accel/persistent.py) against gfxexp_tpu's
build_widerow and its static tile-grid kernel (pallas_widestack.py `_run`,
kernel 2), run in interpret mode with rows=4 as tests/test_accel.py runs it,
and against brute force. The CUDA kernel is compared with the plain walk on
the card by tests/test_torch_cuda.py.

Bars: torch_scenes.check_against_jax (the per-ray walk and the TPU's
per-row walk agree except on exact ties in t), with u, v within UV_ATOL =
2e-4 instead of 2e-5: XLA contracts the leaf test's multiply-adds into
fused multiply-adds (ROADMAP Queue C), and on these random soups, seen from
up to 17 units away, sliver triangles (|U|, |V| up to ~1e2) turn t's last
bits into u, v errors of up to 1.1e-4. Against brute force (Moller-Trumbore
against the walk's Baldwin-Weber rows) t agrees to rtol 1e-4, as in
tests/test_torch_traverse.py."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

from gfxexp_torch.accel import persistent, widerow  # noqa: E402
from gfxexp_torch.accel.persistent import (  # noqa: E402
    walk_chunked_cuda,
    walk_chunked_plain,
    walk_plain,
)
from gfxexp_torch.accel.traverse import (  # noqa: E402
    intersect_any,
    intersect_closest,
    intersect_closest_brute,
)
from gfxexp_torch.accel.widerow import build_widerow as t_build  # noqa: E402
from gfxexp_torch.scene.types import TriangleSoA as TSoA  # noqa: E402
from gfxexp_torch.scene.types import from_numpy  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402
from gfxexp_tpu.accel import pallas_widestack  # noqa: E402
from gfxexp_tpu.accel.pallas_widestack import (  # noqa: E402
    build_widerow as j_build,
)
from gfxexp_tpu.accel.pallas_widestack import (  # noqa: E402
    intersect_any_widestack,
    intersect_closest_widestack,
)
from gfxexp_tpu.scene.types import TriangleSoA as JSoA  # noqa: E402

torch.set_num_threads(2)
SPREAD = 6.0
UV_ATOL = 2e-4


def _soup(seed, n=600):
    return S.soup(np.random.default_rng(seed), n, SPREAD)


def _bits(x):
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


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


def _rays(seed, soup, n=300):
    o, d = S.aimed_rays(np.random.default_rng(seed), n, *soup)
    t_max = np.where(np.arange(n) % 7 == 3, -1.0, 1e30).astype(np.float32)
    return o, d, t_max


@pytest.mark.parametrize("arity", [4, 8])
@pytest.mark.parametrize("max_rows", [80, 13000])
def test_tables_bit_identical_to_jax(arity, max_rows):
    """The divergence before chunking was ported: over max_rows rows the
    port built one table, JAX chunk tables with another triangle order.
    Now both give the same nodes, perm, chunk boxes and depth."""
    p0, e1, e2 = _soup(1)
    jb, jperm = j_build(p0, e1, e2, arity=arity, max_rows=max_rows)
    tb, tperm = t_build(p0, e1, e2, arity=arity, max_rows=max_rows)
    assert tuple(tb.nodes.shape) == jb.nodes.shape
    assert (tb.num_chunks > 1) == (max_rows == 80)
    np.testing.assert_array_equal(_bits(tb.nodes.numpy()), _bits(jb.nodes))
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    assert tb.max_depth == jb.max_depth
    if max_rows == 80:
        for f in ("chunk_lo", "chunk_hi"):
            np.testing.assert_array_equal(
                _bits(getattr(tb, f).numpy()), _bits(getattr(jb, f)),
                err_msg=f)
    else:
        assert tb.chunk_lo is None and jb.chunk_lo is None
    # from_numpy carries the JAX table across unchanged
    fb = from_numpy(jb)
    np.testing.assert_array_equal(_bits(fb.nodes.numpy()),
                                  _bits(tb.nodes.numpy()))
    assert fb.num_chunks == tb.num_chunks and fb.max_depth == tb.max_depth
    assert (fb.chunk_lo is None) == (tb.chunk_lo is None)


def test_chunked_walk_matches_jax():
    p0, e1, e2 = _soup(2)
    jb, perm = j_build(p0, e1, e2, max_rows=80)
    tb, _ = t_build(p0, e1, e2, max_rows=80)
    assert tb.num_chunks >= 4 and not persistent.use_kernel1(tb)
    o, d, t_max = _rays(3, (p0, e1, e2))
    soa = _jsoa(p0[perm], e1[perm], e2[perm])
    jh = intersect_closest_widestack(jb, soa, jnp.asarray(o), jnp.asarray(d),
                                     t_max=jnp.asarray(t_max), rows=4)
    trace.reset_counters("walk.")
    h = intersect_closest(tb, None, torch.from_numpy(o), torch.from_numpy(d),
                          t_max=torch.from_numpy(t_max))
    assert int(h.hit.sum()) > 100
    S.check_single_against_jax(h, jh, UV_ATOL)
    ja = intersect_any_widestack(jb, soa, jnp.asarray(o), jnp.asarray(d),
                                 t_max=jnp.asarray(t_max), rows=4)
    a = intersect_any(tb, None, torch.from_numpy(o), torch.from_numpy(d),
                      t_max=torch.from_numpy(t_max))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert not a.numpy()[t_max < 0].any()
    # CPU tensors take the plain walk, never a kernel
    assert trace.counters("walk.kernel1.") == {}
    assert trace.counters("walk.chunked.") == {}
    with pytest.raises(ValueError):
        walk_chunked_cuda(tb, torch.from_numpy(o), torch.from_numpy(d), 1e-4,
                          1e30, any_hit=False)


def test_single_chunk_with_the_switch_off_matches_jax(monkeypatch):
    """`nopersist`: a single-chunk table takes kernel 2 on both sides (the
    JAX static grid over one chunk; the port's chunked walk over one
    table), with the same hits as kernel 1."""
    p0, e1, e2 = _soup(4, n=300)
    jb, perm = j_build(p0, e1, e2)
    tb, _ = t_build(p0, e1, e2)
    assert tb.num_chunks == 1 and tb.chunk_lo is None
    monkeypatch.setattr(pallas_widestack, "PERSISTENT", False)
    monkeypatch.setattr(widerow, "PERSISTENT", False)
    assert not persistent.use_kernel1(tb)
    o, d, t_max = _rays(5, (p0, e1, e2))
    soa = _jsoa(p0[perm], e1[perm], e2[perm])
    jh = intersect_closest_widestack(jb, soa, jnp.asarray(o), jnp.asarray(d),
                                     t_max=jnp.asarray(t_max), rows=4)
    h = intersect_closest(tb, None, torch.from_numpy(o), torch.from_numpy(d),
                          t_max=torch.from_numpy(t_max))
    S.check_single_against_jax(h, jh, UV_ATOL)
    ja = intersect_any_widestack(jb, soa, jnp.asarray(o), jnp.asarray(d),
                                 t_max=jnp.asarray(t_max), rows=4)
    a = intersect_any(tb, None, torch.from_numpy(o), torch.from_numpy(d),
                      t_max=torch.from_numpy(t_max))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    k1 = walk_plain(tb, torch.from_numpy(o), torch.from_numpy(d), 1e-4,
                    torch.from_numpy(t_max), False)
    for f in ("hit", "t", "u", "v", "tri"):
        assert torch.equal(getattr(h, f), getattr(k1, f)), f


@pytest.mark.parametrize("arity", [4, 8])
def test_chunked_walk_matches_brute(arity):
    p0, e1, e2 = _soup(6, n=500)
    tb, perm = t_build(p0, e1, e2, arity=arity, max_rows=60)
    assert tb.num_chunks >= 4
    o, d, t_max = _rays(7, (p0, e1, e2), n=400)
    args = (torch.from_numpy(o), torch.from_numpy(d), 1e-4,
            torch.from_numpy(t_max))
    h, rows, chunks, _ = walk_chunked_plain(tb, *args, any_hit=False,
                                            with_stats=True)
    ref = intersect_closest_brute(_tsoa(p0[perm], e1[perm], e2[perm]),
                                  *args)
    assert torch.equal(h.hit, ref.hit) and int(h.hit.sum()) > 100
    m = ref.hit
    tie = (h.t[m] - ref.t[m]).abs() <= 1e-6 * ref.t[m]
    assert ((h.tri[m] == ref.tri[m]) | tie).all()
    np.testing.assert_allclose(h.t[m].numpy(), ref.t[m].numpy(), rtol=1e-4)
    a = walk_chunked_plain(tb, *args, any_hit=True)
    assert torch.equal(a.hit, ref.hit)
    # dead rays visit nothing; a live ray visits at most every chunk
    dead = torch.from_numpy(t_max < 0)
    assert int(rows[dead].max()) == 0 and int(chunks[dead].max()) == 0
    assert int(chunks.max()) <= tb.num_chunks and int(rows.sum()) > 0


def test_chunked_table_needs_its_boxes():
    p0, e1, e2 = _soup(8, n=200)
    tb, _ = t_build(p0, e1, e2, max_rows=40)
    tb.chunk_lo = None
    o, d, _ = _rays(9, (p0, e1, e2), n=16)
    with pytest.raises(ValueError, match="chunk boxes"):
        walk_chunked_plain(tb, torch.from_numpy(o), torch.from_numpy(d),
                           1e-4, 1e30, any_hit=False)
