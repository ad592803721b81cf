"""The port's shell mapping (techniques/shell.py) against gfxexp_tpu's on
the same inputs (tests/test_torch_nrtdsm.py's patch and a 3 x 3 grid of
boxes as contents), made from numpy seeds: the build (the base mesh, the
contents' triangles and normals, their wide BVH as skip links, the
material slots, the chord count, the prism BVH from 2,048 base triangles),
from_numpy, the chord count's estimate, and intersect_shell on straight and
tilted shells, one material and several.

Bars: the build and from_numpy equal field for field; against JAX as the
tests run it (XLA contracts multiply-adds into FMAs on the CPU): hits equal
on >= 0.995 of rays, t within rtol 1e-4 on >= 0.97 of the rays that both
hit (1e-3 on all), the base triangle equal where both hit, and the material
equal where t is (JAX walks the contents through accel/tiled.py, the port
through the plain skip-link walk: at one t either may report either of two
triangles). Bit for bit without FMA: tests/test_torch_nrtdsm_nofma.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_nrtdsm import mesh, rays, shell_geoms

from gfxexp_torch.scene.types import from_numpy
from gfxexp_torch.techniques import shell as TS
from gfxexp_tpu.techniques import shell as JS

torch.set_num_threads(2)

BASE_FIELDS = ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
               "shell_mat")
TRI_FIELDS = ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "unit_id")
SKIP_FIELDS = ("aabb_min", "aabb_max", "first", "count", "skip")


@pytest.fixture(scope="module")
def bvh_geoms():
    """2,048 base triangles (-base-res 32): the prism BVH's broad phase."""
    return shell_geoms(32)


@pytest.mark.parametrize("case", ["straight", "tilted_materials", "bvh"])
def test_build_matches_jax(case, bvh_geoms):
    if case == "bvh":
        jg, tg = bvh_geoms
    elif case == "straight":
        jg, tg = shell_geoms(3, tilt=0.0, h_scale=0.5)
    else:
        jg, tg = shell_geoms(3, materials=True)
    for g in (tg, from_numpy(jg)):
        assert isinstance(g, TS.ShellGeometry)
        for f in BASE_FIELDS:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(jg, f)),
                                          err_msg=f)
        for f in TRI_FIELDS:
            np.testing.assert_array_equal(
                getattr(g.shell_tris, f).numpy(),
                np.asarray(getattr(jg.shell_tris, f)), err_msg=f)
        for f in SKIP_FIELDS:
            np.testing.assert_array_equal(
                getattr(g.shell_bvh, f).numpy(),
                np.asarray(getattr(jg.shell_bvh, f)), err_msg=f)
        assert (g.h_lo, g.h_hi, g.material, g.auto_segments) == (
            jg.h_lo, jg.h_hi, jg.material, jg.auto_segments)
        assert g.params == tg.params
        assert (g.prism_bvh is None) == (jg.prism_bvh is None) == (
            case != "bvh")
        if case == "bvh":
            jskip, jperm = jg.prism_bvh
            for f in SKIP_FIELDS:
                np.testing.assert_array_equal(
                    getattr(g.prism_bvh.skip, f).numpy(),
                    np.asarray(getattr(jskip, f)), err_msg=f)
            np.testing.assert_array_equal(g.prism_bvh.perm.numpy(),
                                          np.asarray(jperm))
    assert (tg.auto_segments == 1) == (case == "straight")


@pytest.mark.parametrize("tilt", [0.0, 0.15, 0.6])
def test_estimate_segments_matches_jax(tilt):
    pos, idx, uvs, nrm = mesh(4, tilt)
    args = (np.stack([pos[idx[:, i]] for i in range(3)], 1),
            np.stack([nrm[idx[:, i]] for i in range(3)], 1),
            np.stack([uvs[idx[:, i]] for i in range(3)], 1), 0.0, 0.25)
    n = TS._estimate_shell_segments(*args)
    assert n == JS._estimate_shell_segments(*args)
    assert (n == 1) == (tilt == 0.0)


def _compare(jh, th):
    jhit, thit = np.asarray(jh.hit), th.hit.numpy()
    assert (jhit == thit).mean() >= 0.995
    both = jhit & thit
    assert both.sum() > 20
    jt, tt = np.asarray(jh.t)[both], th.t.numpy()[both]
    rel = np.abs(jt - tt) / np.abs(jt)
    assert (rel <= 1e-4).mean() >= 0.97
    assert rel.max() <= 1e-3, rel.max()
    np.testing.assert_array_equal(np.asarray(jh.prim)[both],
                                  th.prim.numpy()[both])
    same_t = both & (np.asarray(jh.t) == th.t.numpy())
    np.testing.assert_array_equal(np.asarray(jh.mat)[same_t],
                                  th.mat.numpy()[same_t])
    assert np.abs(np.asarray(jh.uv)[both] - th.uv.numpy()[both]).max() <= 1e-3


@pytest.mark.parametrize("case, kw", [
    ("straight", dict(tilt=0.0, h_scale=0.5)),
    ("tilted", dict()),
    ("tilted_materials", dict(materials=True)),
])
def test_intersect_shell_matches_jax(case, kw):
    jg, tg = shell_geoms(2, **kw)
    o, d = rays(300, 31)
    seg = {"n_segments": 4} if case == "straight" else {}
    jh = JS.intersect_shell(jg, jnp.asarray(o), jnp.asarray(d), **seg)
    th = TS.intersect_shell(tg, torch.from_numpy(o), torch.from_numpy(d),
                            **seg)
    _compare(jh, th)
    np.testing.assert_array_equal(np.asarray(jh.steps), th.steps.numpy())
    if case == "tilted_materials":
        assert len(np.unique(th.mat.numpy()[th.hit.numpy()])) == 3
    else:
        assert (th.mat.numpy() == 5).all()


def test_intersect_shell_prism_bvh_matches_jax(bvh_geoms):
    jg, tg = bvh_geoms
    o, d = rays(300, 32)
    jh = JS.intersect_shell(jg, jnp.asarray(o), jnp.asarray(d))
    th = TS.intersect_shell(tg, torch.from_numpy(o), torch.from_numpy(d))
    _compare(jh, th)


def test_from_numpy_shell_intersects_as_port_build():
    jg, tg = shell_geoms(2, materials=True)
    o, d = (torch.from_numpy(x) for x in rays(200, 33))
    a = TS.intersect_shell(from_numpy(jg), o, d)
    b = TS.intersect_shell(tg, o, d)
    for k in ("t", "hit", "uv", "normal", "prim", "mat", "steps"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
