"""The port's lane-group walk (gfxexp_torch/accel/lanegroup.py, plain
version) against gfxexp_tpu's intersect_closest_lanegroup, run in interpret
mode with rows=4 as tests/test_lanegroup.py runs it, and against the
per-ray walk. The CUDA kernel is compared with the plain walk on the card
by tests/test_torch_cuda.py.

Bars: torch_scenes.check_against_jax, with u, v within UV_ATOL = 5e-4:
XLA contracts the leaf test's multiply-adds into fused multiply-adds
(ROADMAP Queue C), and sliver triangles of these random soups, hit by rays
aimed at them, turn t's last bits into u, v errors of up to 2.1e-4.
Against the per-ray walk
(walk_plain) hits and t are equal, and the triangle could differ only on
exact ties in t (none in these random soups): a lane takes part only in
the rows its own box tests lead to, so the shared cursor changes the
order, not the closest hit."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

from gfxexp_torch.accel.lanegroup import (  # noqa: E402
    intersect_closest_lanegroup,
    walk_lanegroup_cuda,
    walk_lanegroup_plain,
)
from gfxexp_torch.accel.persistent import walk_plain  # noqa: E402
from gfxexp_torch.accel.widerow import build_widerow as t_build  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402
from gfxexp_tpu.accel.pallas_lanegroup import (  # noqa: E402
    intersect_closest_lanegroup as j_lanegroup,
)
from gfxexp_tpu.accel.pallas_widestack import (  # noqa: E402
    build_widerow as j_build,
)
from gfxexp_tpu.scene.types import TriangleSoA as JSoA  # noqa: E402

torch.set_num_threads(2)
UV_ATOL = 5e-4


def _soup(seed, n=400):
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=(n, 3)).astype(np.float32)
    e1 = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    return p0, e1, e2


def _jsoa(p0, e1, e2):
    z3 = jnp.zeros_like(jnp.asarray(p0))
    z2 = jnp.zeros((p0.shape[0], 2), jnp.float32)
    return JSoA(p0=jnp.asarray(p0), e1=jnp.asarray(e1), e2=jnp.asarray(e2),
                n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
                unit_id=jnp.zeros((p0.shape[0],), jnp.int32))


def _case(seed, n_tris, n_rays):
    p0, e1, e2 = _soup(seed, n_tris)
    jb, perm = j_build(p0, e1, e2)
    tb, _ = t_build(p0, e1, e2)
    o, d = S.aimed_rays(np.random.default_rng(seed + 1), n_rays, p0, e1, e2,
                        box=4.0)
    t_max = np.where(np.arange(n_rays) % 7 == 3, -1.0, 1e30).astype(
        np.float32)
    return jb, tb, _jsoa(p0[perm], e1[perm], e2[perm]), o, d, t_max


def _check_per_ray(h, ref):
    """Equal hits and t; random soups have no exact ties in t, so the
    triangles and barycentrics are equal too."""
    for f in ("hit", "t", "tri", "u", "v"):
        assert torch.equal(getattr(h, f), getattr(ref, f)), f


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_matches_jax_and_the_per_ray_walk(groups):
    jb, tb, soa, o, d, t_max = _case(11, 400, 600)
    jh = j_lanegroup(jb, soa, jnp.asarray(o), jnp.asarray(d),
                     t_max=jnp.asarray(t_max), rows=4, groups=groups)
    trace.reset_counters("walk.lanegroup.")
    h, rows = intersect_closest_lanegroup(
        tb, None, torch.from_numpy(o), torch.from_numpy(d),
        t_max=torch.from_numpy(t_max), groups=groups, with_stats=True)
    assert int(h.hit.sum()) > 200
    S.check_single_against_jax(h, jh, UV_ATOL)
    ref = walk_plain(tb, torch.from_numpy(o), torch.from_numpy(d), 1e-4,
                     torch.from_numpy(t_max), any_hit=False)
    _check_per_ray(h, ref)
    dead = torch.from_numpy(t_max < 0)
    assert int(rows[dead].max()) == 0 and int(rows[~dead].min()) >= 1
    assert trace.counters("walk.lanegroup.") == {}


@pytest.mark.parametrize("n_rays", [37, 700])
def test_ragged_batches(n_rays):
    """Batches that are not a multiple of 128: the last group is padded
    with dead rays. t within rtol 1e-4: on this soup a grazing hit moves
    by 2.7e-5 relative under XLA's fused multiply-adds."""
    jb, tb, soa, o, d, t_max = _case(21, 120, n_rays)
    jh = j_lanegroup(jb, soa, jnp.asarray(o), jnp.asarray(d),
                     t_max=jnp.asarray(t_max), rows=4, groups=2)
    h = walk_lanegroup_plain(tb, torch.from_numpy(o), torch.from_numpy(d),
                             1e-4, torch.from_numpy(t_max), groups=2)
    assert h.t.shape == (n_rays,)
    S.check_single_against_jax(h, jh, UV_ATOL, t_rtol=1e-4)


def test_refuses_what_it_does_not_take():
    p0, e1, e2 = _soup(31, 200)
    chunked, _ = t_build(p0, e1, e2, max_rows=40)
    one, _ = t_build(p0, e1, e2)
    o = torch.zeros(8, 3)
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(8, 1)
    with pytest.raises(ValueError, match="single-chunk"):
        intersect_closest_lanegroup(chunked, None, o, d)
    with pytest.raises(ValueError, match="groups"):
        walk_lanegroup_plain(one, o, d, 1e-4, 1e30, groups=3)
    with pytest.raises(ValueError):
        walk_lanegroup_cuda(one, o, d, 1e-4, 1e30, groups=2)
