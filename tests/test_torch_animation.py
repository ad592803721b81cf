"""gfxexp_torch's animation against gfxexp_tpu's on the same scene and
controllers: the transform math, controller transforms (atol 1e-6), instance
transforms and world geometry (atol 1e-5), the skip-link refit (atol 1e-6),
the light distributions rebuilt on the device (rtol 1e-5), and the rigid
two-level update (atol 1e-5); and the port's refit after a move against
brute force over the moved triangles."""

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
from gfxexp_torch.accel.skiplink import walk_skip_plain  # noqa: E402
from gfxexp_torch.accel.traverse import intersect_closest  # noqa: E402
from gfxexp_torch.accel.traverse import intersect_closest_brute  # noqa: E402
from gfxexp_torch.core import math as tm  # noqa: E402
from gfxexp_torch.scene import animation as ta  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_tpu.core import math as jm  # noqa: E402
from gfxexp_tpu.scene import animation as ja  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402

torch.set_num_threads(2)
TIMES = (0.0, 0.3, 0.75, 1.9)


def _j(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def skip_scenes():
    js, jb = jcompile(S.instanced_spheres_scene(JB), traversal="skip")
    return (_j(js), jb), tcompile(S.instanced_spheres_scene(TB),
                                  traversal="skip")


def test_transform_math_matches_jax():
    rng = np.random.default_rng(2)
    m = rng.normal(size=(64, 3, 4)).astype(np.float32)
    m[:, :, :3] += 3.0 * np.eye(3, dtype=np.float32)  # well conditioned
    v = rng.normal(size=(64, 3)).astype(np.float32)
    tmt, vt = torch.from_numpy(m), torch.from_numpy(v)
    for tf, jf in ((tm.transform_point, jm.transform_point),
                   (tm.transform_vector, jm.transform_vector),
                   (tm.transform_normal, jm.transform_normal)):
        np.testing.assert_allclose(_np(tf(tmt, vt)), _np(jf(m, v)),
                                   atol=1e-5)
    np.testing.assert_allclose(_np(tm.invert_transform(tmt)),
                               _np(jm.invert_transform(m)), atol=1e-5)
    q0 = rng.normal(size=(64, 4)).astype(np.float32)
    q1 = rng.normal(size=(64, 4)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q1[:4] = q0[:4]  # the lerp branch
    t = rng.random(64).astype(np.float32)
    jq = _np(jm.slerp(q0, q1, t[:, None]))
    np.testing.assert_allclose(
        _np(tm.slerp(torch.from_numpy(q0), torch.from_numpy(q1),
                     torch.from_numpy(t))), jq, atol=1e-6)
    np.testing.assert_allclose(tm.np_slerp(q0, q1, t), jq, atol=1e-6)
    jr = _np(jm.quaternion_to_matrix(q0))
    np.testing.assert_allclose(_np(tm.quaternion_to_matrix(
        torch.from_numpy(q0))), jr, atol=1e-6)
    np.testing.assert_allclose(tm.np_quaternion_to_matrix(q0), jr, atol=1e-6)


@pytest.mark.parametrize("t", TIMES)
def test_controller_transforms_match_jax(skip_scenes, t):
    (js, _), (ts, _) = skip_scenes
    tc, jc = S.spheres_controllers(ta), S.spheres_controllers(ja)
    np.testing.assert_allclose(
        _np(ta.controller_transforms(ts, tc, t)),
        _np(ja.controller_transforms(js, jc, t)), atol=1e-6)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.transform_at(t), b.transform_at(t),
                                   atol=1e-6)


def _moved(skip_scenes, t):
    (js, jb), (ts, tb) = skip_scenes
    jtf = ja.controller_transforms(js, S.spheres_controllers(ja), t)
    ttf = torch.from_numpy(np.array(jtf))  # both sides get the same input
    js = ja.update_world_geometry(ja.set_instance_transforms(js, jtf))
    ts = ta.update_world_geometry(ta.set_instance_transforms(ts, ttf))
    return js, jb, ts, tb


def test_world_geometry_matches_jax(skip_scenes):
    js, _, ts, _ = _moved(skip_scenes, 0.75)
    for f in ("transform", "inv_transform", "prev_transform",
              "uniform_scale"):
        np.testing.assert_allclose(_np(getattr(ts.instances, f)),
                                   _np(getattr(js.instances, f)), atol=1e-5,
                                   err_msg=f)
    for f in ("p0", "e1", "e2", "n0", "n1", "n2"):
        np.testing.assert_allclose(_np(getattr(ts.triangles, f)),
                                   _np(getattr(js.triangles, f)), atol=1e-5,
                                   err_msg=f)


def test_refit_matches_jax(skip_scenes):
    js, jb, ts, tb = _moved(skip_scenes, 0.75)
    # refit both over the same world triangles
    tris = ts.triangles
    jtris = js.triangles.replace(p0=jnp.asarray(_np(tris.p0)),
                                 e1=jnp.asarray(_np(tris.e1)),
                                 e2=jnp.asarray(_np(tris.e2)))
    jr = ja.refit_skip_bvh(jb, jtris)
    tr = ta.refit_skip_bvh(tb, tris)
    for f in ("aabb_min", "aabb_max"):
        np.testing.assert_allclose(_np(getattr(tr, f)), _np(getattr(jr, f)),
                                   atol=1e-6, err_msg=f)
    assert not np.allclose(_np(tr.aabb_min), _np(tb.aabb_min))
    m = tr.num_nodes
    np.testing.assert_array_equal(tr.node_pack[:m, 3:6].numpy(),
                                  tr.aabb_max.numpy())
    np.testing.assert_array_equal(tr.tri_pack[:tris.count, 0:3].numpy(),
                                  tris.p0.numpy())


def test_light_rebuild_matches_jax(skip_scenes):
    js, _, ts, _ = _moved(skip_scenes, 0.3)
    # the same world triangles on both sides
    js = js.replace(triangles=js.triangles.replace(
        e1=jnp.asarray(_np(ts.triangles.e1)),
        e2=jnp.asarray(_np(ts.triangles.e2))))
    jr = ja.rebuild_light_distributions(js)
    tr = ta.rebuild_light_distributions(ts)
    for f in ("light_tri_cdf", "light_tri_pmf", "emissive_importance"):
        np.testing.assert_allclose(_np(getattr(tr.units, f)),
                                   _np(getattr(jr.units, f)), rtol=1e-5,
                                   err_msg=f)
    for f in ("light_unit_cdf", "light_unit_pmf",
              "total_emissive_importance"):
        np.testing.assert_allclose(_np(getattr(tr, f)), _np(getattr(jr, f)),
                                   rtol=1e-5, err_msg=f)
    assert tr.light_unit_alias_prob is None
    assert tr.units.light_tri_alias_prob is None


def test_advance_frame_instanced_matches_jax():
    js, jacc = jcompile(S.instanced_spheres_scene(JB), traversal="instanced")
    ts, tacc = tcompile(S.instanced_spheres_scene(TB), traversal="instanced")
    js, jacc = ja.advance_frame_instanced(_j(js), _j(jacc),
                                          S.spheres_controllers(ja), 0.3)
    ts, tacc = ta.advance_frame_instanced(ts, tacc,
                                          S.spheres_controllers(ta), 0.3)
    for f in ("inv_transforms", "chunk_lo", "chunk_hi"):
        np.testing.assert_allclose(_np(getattr(tacc, f)),
                                   _np(getattr(jacc, f)), atol=1e-5,
                                   err_msg=f)
    for f in ("light_unit_cdf", "light_unit_pmf",
              "total_emissive_importance"):
        np.testing.assert_allclose(_np(getattr(ts, f)), _np(getattr(js, f)),
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(_np(ts.units.emissive_importance),
                               _np(js.units.emissive_importance), atol=1e-5)
    np.testing.assert_allclose(_np(ts.instances.transform),
                               _np(js.instances.transform), atol=1e-5)
    # the moved structure still finds the flattened scene's hits
    fs, fb = ta.advance_frame(*tcompile(S.instanced_spheres_scene(TB),
                                        traversal="skip"),
                              S.spheres_controllers(ta), 0.3)
    o, d = _rays(400, 6)
    hi = intersect_closest(tacc, ts.triangles, o, d)
    hf = intersect_closest(fb, fs.triangles, o, d)
    assert torch.equal(hi.hit, hf.hit)
    torch.testing.assert_close(hi.t[hf.hit], hf.t[hf.hit], rtol=1e-4,
                               atol=1e-5)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.8, 1.8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("t", [0.3, 1.9])
def test_refit_after_move_matches_brute_force(skip_scenes, t):
    """advance_frame (refit included) against brute force over the moved
    world triangles: same hits and triangles, closest and any hit."""
    _, (ts, tb) = skip_scenes
    ts, tb = ta.advance_frame(ts, tb, S.spheres_controllers(ta), t)
    o, d = _rays(1500, 11)
    h = walk_skip_plain(tb, ts.triangles, o, d, 1e-4, 1e30, False)
    hb = intersect_closest_brute(ts.triangles, o, d, 1e-4, 1e30)
    assert torch.equal(h.hit, hb.hit) and torch.equal(h.tri, hb.tri)
    torch.testing.assert_close(h.t, hb.t, rtol=1e-6, atol=0)
    occ = walk_skip_plain(tb, ts.triangles, o, d, 1e-4, 1.0, True).hit
    assert torch.equal(occ, intersect_closest_brute(ts.triangles, o, d, 1e-4,
                                                    1.0).hit)
