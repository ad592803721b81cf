"""The port's two-level walk (gfxexp_torch/accel/instanced.py, plain version)
against gfxexp_tpu's static-grid and ray-sorted TLAS Pallas kernels, run in
interpret mode as tests/test_persistent_inst.py runs them, and against
world-space brute force. (The persistent kernel, the JAX default, is in
tests/test_torch_instanced_persist.py, to spread the interpret-mode
compiles over two files.)

Bars: torch_scenes.check_against_jax. Per-ray and per-row orders agree
except on exact ties in t."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

from gfxexp_torch.accel import instanced  # noqa: E402
from gfxexp_torch.accel.instanced import (  # noqa: E402
    build_instanced as t_build,
)
from gfxexp_torch.accel.instanced import (  # noqa: E402
    intersect_any_instanced,
    intersect_closest_instanced,
    walk_instanced_cuda,
    walk_instanced_plain,
    walk_tlas,
)
from gfxexp_torch.accel.traverse import (  # noqa: E402
    intersect_any,
    intersect_closest,
    intersect_closest_brute,
)
from gfxexp_torch.scene.types import TriangleSoA  # noqa: E402
from gfxexp_torch.utils import trace  # noqa: E402
from gfxexp_tpu.accel.pallas_widestack import (  # noqa: E402
    _traverse_instanced,
    _traverse_instanced_tlas,
)
from gfxexp_tpu.accel.pallas_widestack import (  # noqa: E402
    build_instanced as j_build,
)

torch.set_num_threads(2)
CASES = S.instanced_walk_cases()


def _accs(key):
    geoms, inst, rebraid, o, d = CASES[key]
    jacc, _ = j_build(geoms, inst, rebraid=rebraid)
    tacc, perms = t_build(geoms, inst, rebraid=rebraid)
    return jacc, tacc, perms, o, d


def _inst(acc, ent):
    return torch.where(ent >= 0, acc.inst_of_chunk[ent.clamp(min=0).long()],
                       -1)


@pytest.mark.parametrize("key", list(CASES))
def test_build_order_matches_jax_static_grid(key):
    jacc, tacc, _, o, d = _accs(key)
    jh, ji = _traverse_instanced(jacc, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                 1e30, any_hit=False)
    h, ent = walk_instanced_plain(tacc, torch.from_numpy(o),
                                  torch.from_numpy(d), 1e-4, 1e30, False,
                                  route="build")
    S.check_against_jax(h, _inst(tacc, ent), jh, ji)
    miss = ~h.hit
    assert (h.tri[miss] == -1).all() and (ent[miss] == -1).all()
    assert (h.t[miss] == 1e30).all()


@pytest.mark.parametrize("key", list(CASES))
def test_tlas_route_matches_jax_tlas(key):
    jacc, tacc, _, o, d = _accs(key)
    jh, ji = _traverse_instanced_tlas(jacc, jnp.asarray(o), jnp.asarray(d),
                                      1e-4, 1e30, any_hit=False)
    tacc.use_tlas = True
    h, inst = intersect_closest_instanced(tacc, torch.from_numpy(o),
                                          torch.from_numpy(d))
    S.check_against_jax(h, inst, jh, ji)
    # the ray-sorted route is the nearest-first function, permuted
    hn, en = walk_instanced_plain(tacc, torch.from_numpy(o),
                                  torch.from_numpy(d), 1e-4, 1e30, False,
                                  route="nearest")
    for f in ("t", "u", "v", "tri", "hit"):
        assert torch.equal(getattr(h, f), getattr(hn, f)), f
    assert torch.equal(inst, _inst(tacc, en))


def test_any_hit_matches_jax():
    """333 rays with per-ray t_max, dead rays included: occlusion equals the
    JAX static grid's for every route."""
    jacc, tacc, _, o, d = _accs("ragged")
    idx = np.arange(o.shape[0])
    t_max = np.where(idx % 5 == 0, -1.0, 1.0 + (idx % 9)).astype(np.float32)
    jh, _ = _traverse_instanced(jacc, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                jnp.asarray(t_max), any_hit=True)
    ref = np.asarray(jh.hit)
    assert ref.any() and not ref.all()
    tm = torch.from_numpy(t_max)
    for route in ("nearest", "build"):
        h, ent = walk_instanced_plain(tacc, torch.from_numpy(o),
                                      torch.from_numpy(d), 1e-4, tm, True,
                                      route=route)
        np.testing.assert_array_equal(h.hit.numpy(), ref)
        assert not h.hit[tm < 0].any()
        # the accepted triangle is a real hit inside [t_min, t_max)
        assert (h.t[h.hit] < tm[h.hit]).all() and (ent[h.hit] >= 0).all()
    h, _ = walk_tlas(walk_instanced_plain, tacc, torch.from_numpy(o),
                     torch.from_numpy(d), 1e-4, tm, True)
    np.testing.assert_array_equal(h.hit.numpy(), ref)


def _world_soup(tacc, perms, geoms, inst):
    """The scene's world-space triangles, instance-major, each instance's in
    its BLAS's leaf order; and the map from (instance, global BLAS id) to
    the world id."""
    p0s, e1s, e2s, base = [], [], [], []
    blas_base = np.cumsum([0] + [g[0].shape[0] for g in geoms])
    off = 0
    for b, m in inst:
        p0, e1, e2 = (x[perms[b]].astype(np.float64) for x in geoms[b])
        r = m[:, :3].astype(np.float64)
        p0s.append(p0 @ r.T + m[:, 3])
        e1s.append(e1 @ r.T)
        e2s.append(e2 @ r.T)
        base.append(off - blas_base[b])
        off += p0.shape[0]
    cat = [torch.from_numpy(np.concatenate(x).astype(np.float32))
           for x in (p0s, e1s, e2s)]
    z3 = torch.zeros_like(cat[0])
    z2 = torch.zeros(cat[0].shape[0], 2)
    soup = TriangleSoA(p0=cat[0], e1=cat[1], e2=cat[2], n0=z3, n1=z3, n2=z3,
                       uv0=z2, uv1=z2, uv2=z2,
                       unit_id=torch.zeros(cat[0].shape[0],
                                           dtype=torch.int32))
    return soup, torch.tensor(base)


@pytest.mark.parametrize("key", ["two_blas", "rebraid"])
def test_closest_matches_world_brute_force(key):
    """tests/test_torch_traverse.py's bars against brute force over the
    flattened world triangles: hit, and the same world triangle, t rtol
    1e-4, u atol 2e-3."""
    geoms, inst, rebraid, o, d = CASES[key]
    tacc, perms = t_build(geoms, inst, rebraid=rebraid)
    soup, base = _world_soup(tacc, perms, geoms, inst)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    ref = intersect_closest_brute(soup, o, d)
    for route in ("nearest", "build"):
        h, ent = walk_instanced_plain(tacc, o, d, 1e-4, 1e30, False,
                                      route=route)
        assert torch.equal(h.hit, ref.hit)
        m = h.hit
        ii = _inst(tacc, ent)[m].long()
        assert torch.equal(base[ii] + h.tri[m], ref.tri[m].long())
        np.testing.assert_allclose(h.t[m].numpy(), ref.t[m].numpy(),
                                   rtol=1e-4)
        np.testing.assert_allclose(h.u[m].numpy(), ref.u[m].numpy(),
                                   atol=2e-3)


def test_dispatch_and_routing_on_cpu():
    """traverse.py hands InstancedAccel to the two-level walk and fills
    HitInfo.inst; the routing follows set_persistent; CPU tensors never
    launch the kernel, and the kernel's wrapper refuses them."""
    _, tacc, _, o, d = _accs("two_blas")
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    trace.reset_counters("walk.instanced.")
    try:
        for persist in (True, False):
            instanced.set_persistent(persist)
            h = intersect_closest(tacc, None, o, d)
            route = "nearest" if persist else "build"
            ref, ent = walk_instanced_plain(tacc, o, d, 1e-4, 1e30, False,
                                            route=route)
            assert torch.equal(h.t, ref.t) and torch.equal(h.tri, ref.tri)
            assert torch.equal(h.inst, _inst(tacc, ent).to(torch.int32))
            occ = intersect_any(tacc, None, o, d)
            assert torch.equal(occ, intersect_any_instanced(tacc, o, d))
    finally:
        instanced.set_persistent(None)
    assert not any(trace.counters("walk.instanced.").values())
    with pytest.raises(ValueError, match="CUDA"):
        walk_instanced_cuda(tacc, o, d, 1e-4, 1e30, False, route="nearest")
    with pytest.raises(ValueError):
        walk_instanced_plain(tacc, o.double(), d.double(), 1e-4, 1e30, False,
                             route="nearest")
