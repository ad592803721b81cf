"""The port's quantized rows (gfxexp_torch/accel/qrow.py) against
gfxexp_tpu's pallas_qrow: build_qrow bit for bit (one table and chunked),
the plain walk against the Pallas kernel in interpret mode (rows=4, as
tests/test_accel.py runs it) and against brute force over the dequantized
soup, compile_scene(traversal="qrow") and a render through it. The CUDA
kernel is compared with the plain walk on the card by
tests/test_torch_cuda.py.

Bars: torch_scenes.check_against_jax, with u, v within UV_ATOL = 5e-4: XLA
contracts the Moller-Trumbore sums into fused multiply-adds (ROADMAP Queue
C), and sliver triangles of these random soups, hit from up to 17 units
away by rays aimed at them, turn that into u, v errors of up to 2.1e-4.
Against brute force over the dequantized soup: the walk dequantizes the
vertices in float32 and takes their differences, where build_qrow gives
the soup's edges from float64, so t agrees to rtol 5e-4 (1.5e-4 seen on a
grazing hit) and the triangle except where the two t are that close."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch.accel import qrow  # noqa: E402
from gfxexp_torch.accel.qrow import build_qrow as t_build  # noqa: E402
from gfxexp_torch.accel.qrow import (  # noqa: E402
    walk_qrow_cuda,
    walk_qrow_plain,
)
from gfxexp_torch.accel.traverse import (  # noqa: E402
    intersect_any,
    intersect_closest,
    intersect_closest_brute,
)
from gfxexp_torch.render import pathtrace as tpt  # noqa: E402
from gfxexp_torch.render.camera import make_camera  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.scene.types import TriangleSoA as TSoA  # noqa: E402
from gfxexp_torch.scene.types import from_numpy  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402
from gfxexp_tpu.accel.pallas_qrow import build_qrow as j_build  # noqa: E402
from gfxexp_tpu.accel.pallas_qrow import (  # noqa: E402
    intersect_any_qrow,
    intersect_closest_qrow,
)
from gfxexp_tpu.render import pathtrace as jpt  # noqa: E402
from gfxexp_tpu.render.camera import make_camera as j_camera  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402
from gfxexp_tpu.scene.types import TriangleSoA as JSoA  # noqa: E402

torch.set_num_threads(2)
SPREAD = 6.0
UV_ATOL = 5e-4
T_RTOL = 5e-4  # against brute force over the dequantized soup


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
    t_max[np.arange(n) % 11 == 5] = 0.0  # dead under any hit only
    return o, d, t_max


@pytest.mark.parametrize("max_rows", [64, 26000])
def test_build_bit_identical_to_jax(max_rows):
    p0, e1, e2 = _soup(1)
    jb, jperm, jdq = j_build(p0, e1, e2, max_rows=max_rows)
    tb, tperm, tdq = t_build(p0, e1, e2, max_rows=max_rows)
    assert (tb.num_chunks > 2) == (max_rows == 64)
    assert tuple(tb.nodes.shape) == jb.nodes.shape
    np.testing.assert_array_equal(_bits(tb.nodes.numpy()), _bits(jb.nodes))
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    for a, b in zip(tdq, jdq):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert tb.max_depth == jb.max_depth
    if max_rows == 64:
        for f in ("chunk_lo", "chunk_hi"):
            np.testing.assert_array_equal(
                _bits(getattr(tb, f).numpy()), _bits(getattr(jb, f)),
                err_msg=f)
    fb = from_numpy(jb)
    assert isinstance(fb, qrow.QRowBVH) and fb.max_depth == tb.max_depth
    np.testing.assert_array_equal(_bits(fb.nodes.numpy()),
                                  _bits(tb.nodes.numpy()))
    assert (fb.chunk_lo is None) == (tb.chunk_lo is None)


@pytest.mark.parametrize("max_rows", [64, 26000])
def test_walk_matches_jax(max_rows):
    p0, e1, e2 = _soup(2)
    jb, _, jdq = j_build(p0, e1, e2, max_rows=max_rows)
    tb, _, tdq = t_build(p0, e1, e2, max_rows=max_rows)
    o, d, t_max = _rays(3, (p0, e1, e2))
    soa = _jsoa(*jdq)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    jh = intersect_closest_qrow(jb, soa, jnp.asarray(o), jnp.asarray(d),
                                t_max=jnp.asarray(t_max), rows=4)
    trace.reset_counters("walk.qrow.")
    h = intersect_closest(tb, None, *args, t_max=torch.from_numpy(t_max))
    assert int(h.hit.sum()) > 100
    S.check_single_against_jax(h, jh, UV_ATOL)
    ja = intersect_any_qrow(jb, soa, jnp.asarray(o), jnp.asarray(d),
                            t_max=jnp.asarray(t_max), rows=4)
    a = intersect_any(tb, None, *args, t_max=torch.from_numpy(t_max))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert not a.numpy()[t_max <= 0].any()
    assert trace.counters("walk.qrow.") == {}
    with pytest.raises(ValueError):
        walk_qrow_cuda(tb, *args, 1e-4, 1e30, any_hit=False)


@pytest.mark.parametrize("max_rows", [64, 26000])
def test_walk_matches_brute_over_the_dequantized_soup(max_rows):
    p0, e1, e2 = _soup(4, n=500)
    tb, _, dq = t_build(p0, e1, e2, max_rows=max_rows)
    o, d, t_max = _rays(5, (p0, e1, e2), n=400)
    args = (torch.from_numpy(o), torch.from_numpy(d), 1e-4,
            torch.from_numpy(t_max))
    h, rows, chunks = walk_qrow_plain(tb, *args, any_hit=False,
                                      with_stats=True)
    ref = intersect_closest_brute(_tsoa(*dq), *args)
    assert torch.equal(h.hit, ref.hit) and int(h.hit.sum()) > 100
    m = ref.hit
    tie = (h.t[m] - ref.t[m]).abs() <= T_RTOL * ref.t[m]
    assert ((h.tri[m] == ref.tri[m]) | tie).all()
    np.testing.assert_allclose(h.t[m].numpy(), ref.t[m].numpy(),
                               rtol=T_RTOL)
    a = walk_qrow_plain(tb, *args, any_hit=True)
    assert torch.equal(a.hit, ref.hit & torch.from_numpy(t_max > 0))
    dead = torch.from_numpy(t_max < 0)
    assert int(rows[dead].max()) == 0 and int(rows.sum()) > 0
    assert int(chunks.max()) <= tb.num_chunks


def test_compile_scene_matches_jax():
    """The scene's tables, its triangles replaced by the dequantized ones
    in traversal order, and the structure, all equal to JAX's."""
    js, jb = jcompile(S.box_scene(JB), traversal="qrow")
    ts, tb = tcompile(S.box_scene(TB), traversal="qrow")
    assert isinstance(tb, qrow.QRowBVH)
    np.testing.assert_array_equal(_bits(tb.nodes.numpy()), _bits(jb.nodes))
    assert tb.max_depth == jb.max_depth
    for part in ("triangles", "units", "materials", "instances"):
        tobj, jobj = getattr(ts, part), getattr(js, part)
        for f in tobj.__dataclass_fields__:
            tv = getattr(tobj, f)
            if isinstance(tv, torch.Tensor):
                np.testing.assert_array_equal(
                    _bits(tv.numpy()), _bits(getattr(jobj, f)),
                    err_msg=f"{part}.{f}")


def test_render_matches_jax():
    """A 48x48 render of the box scene through the quantized rows (JAX's
    qrow kernel in interpret mode) within the golden bar."""
    js, jb = jcompile(S.box_scene(JB), traversal="qrow")
    ts, tb = tcompile(S.box_scene(TB), traversal="qrow")
    jc = j_camera(**S.BOX_CAMERA)
    tc = make_camera(**S.BOX_CAMERA)
    cfg = dict(max_path_length=3, count_rays=True)
    jimg, jnr = jpt.render_sample(js, jb, jc, 48, 48, jnp.uint32(0),
                                  jpt.PTConfig(**cfg))
    img, nr = tpt.render_sample(ts, tb, tc, 48, 48, 0, tpt.PTConfig(**cfg))
    assert torch.isfinite(img).all() and float(img.mean()) > 0
    assert S.image_rel_diff(img.numpy(), np.asarray(jimg)) < 5e-3
    assert abs(float(nr) - float(jnr)) <= 5e-3 * float(jnr)


def test_instanced_qrow_raises():
    b = TB.SceneBuilder()
    m = b.add_lambert_material((0.5, 0.5, 0.5))
    b.add_instance(b.add_rectangle(1.0, 1.0, m))
    with pytest.raises(ValueError, match="qrow"):
        b.compile_instanced(node_format="qrow")
