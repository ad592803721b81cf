"""Shared tiny scenes for the parity tests of gfxexp_torch against gfxexp_tpu.

Each scene is built through the SceneBuilder API that both packages share,
given the builder module (gfxexp_tpu.scene.builder or
gfxexp_torch.scene.builder), so the two packages compile the same content.
The bodies follow tests/scenes.py.
"""

import numpy as np

FLIP_X = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)


def furnace_scene(mod, albedo=0.5, env_radiance=1.0, env_res=(16, 32)):
    """Lambert sphere in a constant environment."""
    b = mod.SceneBuilder()
    mat = b.add_lambert_material((albedo, albedo, albedo))
    geom = b.add_sphere(1.0, mat, n_theta=24, n_phi=48)
    b.add_instance(geom)
    h, w = env_res
    b.set_environment(np.full((h, w, 3), env_radiance, np.float32))
    return b


def box_scene(mod, albedo=0.7):
    """Closed box with a ceiling light."""
    b = mod.SceneBuilder()
    wall = b.add_lambert_material((albedo, albedo, albedo))
    light_mat = b.add_lambert_material((0.0, 0.0, 0.0),
                                       emittance=(20.0, 20.0, 20.0))
    s = 2.0
    floor = b.add_rectangle(2 * s, 2 * s, wall)
    b.add_instance(floor, mod.affine(translation=[0, -s, 0]))
    ceil = b.add_rectangle(2 * s, 2 * s, wall)
    b.add_instance(ceil, mod.affine(rotation=FLIP_X, translation=[0, s, 0]))
    rot_zp = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)
    back = b.add_rectangle(2 * s, 2 * s, wall)
    b.add_instance(back, mod.affine(rotation=rot_zp, translation=[0, 0, -s]))
    rot_zm = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float64)
    front = b.add_rectangle(2 * s, 2 * s, wall)
    b.add_instance(front, mod.affine(rotation=rot_zm, translation=[0, 0, s]))
    rot_xp = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float64)
    left = b.add_rectangle(2 * s, 2 * s, wall)
    b.add_instance(left, mod.affine(rotation=rot_xp, translation=[-s, 0, 0]))
    rot_xm = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
    right = b.add_rectangle(2 * s, 2 * s, wall)
    b.add_instance(right, mod.affine(rotation=rot_xm, translation=[s, 0, 0]))
    lamp = b.add_rectangle(0.8, 0.8, light_mat)
    b.add_instance(lamp, mod.affine(rotation=FLIP_X,
                                    translation=[0, s - 0.01, 0]))
    return b


def instanced_spheres_scene(mod):
    """The box with three instances of one sphere on its floor (the scene of
    tests/test_pathtrace.py's instanced test): compiled two-level, the three
    share one BLAS."""
    b = box_scene(mod)
    mat = b.add_lambert_material((0.6, 0.3, 0.3))
    sph = b.add_sphere(0.35, mat, n_theta=12, n_phi=24)
    for t in ([-0.8, -1.2, 0.0], [0.0, -1.4, -0.8], [0.9, -1.1, 0.4]):
        b.add_instance(sph, mod.affine(translation=t))
    return b


def spheres_controllers(mod):
    """Controllers for instanced_spheres_scene, given an animation module
    (gfxexp_tpu.scene.animation or gfxexp_torch.scene.animation): the lamp
    (instance 6) moves down keeping its downward orientation, one sphere (7)
    moves and grows, one (8) turns about a tilted axis; phases and
    frequencies differ."""
    q = np.asarray([0.3, 0.5, -0.2, 0.8])
    q = tuple(float(x) for x in q / np.linalg.norm(q))
    flip = (1.0, 0.0, 0.0, 0.0)  # pi about x
    return [
        mod.InstanceController(instance=6, begin_position=(0, 1.99, 0),
                               end_position=(0, 1.4, 0),
                               begin_orientation=flip, end_orientation=flip,
                               frequency=0.5),
        mod.InstanceController(instance=7, begin_position=(-0.8, -1.2, 0.0),
                               end_position=(-0.4, -1.0, 0.4),
                               end_scale=1.5, frequency=0.8,
                               initial_time=0.1),
        mod.InstanceController(instance=8, begin_position=(0.0, -1.4, -0.8),
                               end_position=(0.0, -1.4, -0.8),
                               end_orientation=q, frequency=1.3),
    ]


def soup(rng, n, spread):
    """Random triangle soup (p0, e1, e2) around the origin, as
    tests/test_persistent_inst.py makes it."""
    c = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    return c, e1, e2


def grid_instances(nx, nz, spacing=2.5):
    """(blas 0, translation) instances on an nx x nz grid."""
    out = []
    for gx in range(nx):
        for gz in range(nz):
            m = np.zeros((3, 4), np.float32)
            m[0, 0] = m[1, 1] = m[2, 2] = 1.0
            m[:, 3] = [gx * spacing, 0.0, gz * spacing]
            out.append((0, m))
    return out


def instanced_walk_cases():
    """The scenes of tests/test_persistent_inst.py as (BLAS geometries,
    instances, rebraid, ray origins, ray directions), from numpy seeds."""
    cases = {}
    rng = np.random.default_rng(7)

    def rays(n, lo=-4, hi=12):
        o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return o, d

    # two BLAS on a 3x3 grid
    p, q = soup(rng, 60, 0.8), soup(rng, 35, 0.6)
    inst = grid_instances(3, 3)
    for j in (1, 4, 7):
        inst[j] = (1, inst[j][1])
    cases["two_blas"] = ([p, q], inst, 0.0, *rays(500))
    # grazing rays marching down the rows of a 4x4 grid
    p = soup(rng, 40, 0.5)
    n = 512
    o = np.random.default_rng(3).uniform(-4, 0, size=(n, 3)).astype(
        np.float32)
    o[:, 1] *= 0.2
    d = (np.array([1.0, 0.0, 0.0]) + np.random.default_rng(4).normal(
        scale=0.05, size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cases["grazing"] = ([p], grid_instances(4, 4), 0.0, o, d)
    # 333 rays (not a multiple of 128)
    p = soup(rng, 50, 0.7)
    cases["ragged"] = ([p], grid_instances(2, 3), 0.0, *rays(333))
    # rebraided: the largest instances opened into subtree entries
    p = soup(rng, 80, 1.2)
    cases["rebraid"] = ([p], grid_instances(3, 2), 3.0, *rays(400))
    return cases


def frame_soup(rng, n=24, inner=0.6, outer=1.0):
    """A soup (p0, e1, e2) of n small triangles in the square ring
    inner <= max(|x|, |y|) <= outer around the z axis: an open frame, which
    a ray through its middle misses."""
    pts = []
    while len(pts) < n:
        p = rng.uniform(-outer, outer, 2)
        if np.abs(p).max() >= inner:
            pts.append(p)
    c = np.concatenate([np.asarray(pts), rng.uniform(-0.05, 0.05, (n, 1))],
                       axis=1).astype(np.float32)
    e1 = rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    return c, e1, e2


def stacked_frames(n_inst=300, spacing=0.2, n_rays=4096, seed=11):
    """(BLAS geometries, instances, ray origins, ray directions): n_inst open
    frames stacked along +z, each shifted a little in x and y, and rays
    from in front of the stack along the axis. A ray enters hundreds of
    entry boxes and misses most frames before it hits one, so the
    nearest-first pick runs through its buffer and refills it."""
    rng = np.random.default_rng(seed)
    blas = [frame_soup(rng)]
    inst = []
    for k in range(n_inst):
        m = np.zeros((3, 4), np.float32)
        m[0, 0] = m[1, 1] = m[2, 2] = 1.0
        m[:, 3] = [*rng.uniform(-0.35, 0.35, 2), k * spacing]
        inst.append((0, m))
    o = np.concatenate([rng.uniform(-0.8, 0.8, (n_rays, 2)),
                        np.full((n_rays, 1), -2.0)], axis=1)
    d = np.concatenate([rng.normal(scale=0.02, size=(n_rays, 2)),
                        np.ones((n_rays, 1))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return blas, inst, o.astype(np.float32), d.astype(np.float32)


def flatten(blas, inst):
    """The world triangle soup (p0, e1, e2) of instances (blas id, 3x4
    object->world matrix)."""
    out = [[], [], []]
    for b, m in inst:
        p0, e1, e2 = blas[b]
        r = m[:, :3].astype(np.float64)
        out[0].append(p0 @ r.T + m[:, 3])
        out[1].append(e1 @ r.T)
        out[2].append(e2 @ r.T)
    return tuple(np.concatenate(x).astype(np.float32) for x in out)


BOX_CAMERA = dict(position=[0, 0.5, 1.9], fov_y=np.deg2rad(75), aspect=1.0,
                  target=[0, 0.3, -1.0])
INSTANCED_CAMERA = dict(position=[0, 0.5, 1.9], fov_y=np.deg2rad(75),
                        aspect=1.0, target=[0, 0.0, -1.0])
FURNACE_CAMERA = dict(position=[0, 0, 3.0], fov_y=np.deg2rad(45),
                      aspect=1.0, target=[0, 0, 0])


def image_rel_diff(a, b):
    """Mean relative absolute image difference (the golden test's bar)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6)


def check_against_jax(h, inst, jh, jinst, uv_atol=2e-5, t_rtol=1e-5):
    """The two-level walk's bars against a JAX kernel: hit and instance
    equal; triangle ids equal except on ties (|dt| <= 1e-6 t); t within
    rtol 1e-5 and u, v within 2e-5. XLA on the CPU contracts the transform's
    and the leaf test's multiply-adds into fused multiply-adds (a*b + c*d +
    e*f + g becomes fma(e, f, fma(a, b, c*d)) + g), which the port, like its
    kernel, does not; on tests/test_persistent_inst.py's scenes that moves
    u, v by up to 1.05e-5. Random soups seen from afar, with sliver
    triangles (|U|, |V| up to ~1e2), move them more: those tests pass a
    larger uv_atol (or t_rtol) and say why."""
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(jh.hit))
    m = np.asarray(jh.hit)
    np.testing.assert_array_equal(inst.numpy()[m], np.asarray(jinst)[m])
    t, jt = h.t.numpy()[m], np.asarray(jh.t)[m]
    tie = np.abs(t - jt) <= 1e-6 * np.abs(jt)
    same = h.tri.numpy()[m] == np.asarray(jh.tri)[m]
    assert (same | tie).all()
    np.testing.assert_allclose(t, jt, rtol=t_rtol)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(h, f).numpy()[m][same],
                                   np.asarray(getattr(jh, f))[m][same],
                                   atol=uv_atol)


def check_single_against_jax(h, jh, uv_atol=2e-5, t_rtol=1e-5):
    """check_against_jax's bars for a single-level walk (no instances)."""
    import torch

    none = np.full(np.asarray(jh.hit).shape, -1, np.int32)
    check_against_jax(h, torch.from_numpy(none), jh, none, uv_atol, t_rtol)


def aimed_rays(rng, n, p0, e1, e2, box=10.0):
    """n rays from origins uniform in [-box, box]^3 aimed at random points
    of random triangles of the soup (p0, e1, e2): most of them hit."""
    o = rng.uniform(-box, box, size=(n, 3)).astype(np.float32)
    j = rng.integers(0, p0.shape[0], n)
    a, b = rng.random((2, n, 1)) * 0.5
    d = p0[j] + a * e1[j] + b * e2[j] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def quad_light_scene(mod, emittance=(30.0, 30.0, 30.0), albedo=0.6,
                     light_y=2.0, light_dim=0.5):
    """A Lambert ground plane and a downward-facing rectangle light above
    it (tests/scenes.py quad_light_scene)."""
    b = mod.SceneBuilder()
    floor_mat = b.add_lambert_material((albedo, albedo, albedo))
    light_mat = b.add_lambert_material((0.0, 0.0, 0.0), emittance=emittance)
    b.add_instance(b.add_rectangle(10.0, 10.0, floor_mat))
    b.add_instance(b.add_rectangle(light_dim, light_dim, light_mat),
                   mod.affine(rotation=FLIP_X, translation=[0.0, light_y,
                                                            0.0]))
    return b


def many_light_scene(mod, n_lights=64, seed=3, albedo=0.6, occluders=0):
    """A grid of small emitters of random intensity over a ground plane
    (tests/scenes.py many_light_scene), and optionally `occluders` spheres
    between them and the floor that cast shadows."""
    rng = np.random.default_rng(seed)
    b = mod.SceneBuilder()
    floor_mat = b.add_lambert_material((albedo, albedo, albedo))
    b.add_instance(b.add_rectangle(20.0, 20.0, floor_mat))
    side = int(np.sqrt(n_lights))
    for i in range(side):
        for j in range(side):
            e = float(rng.uniform(1.0, 60.0))
            m = b.add_lambert_material((0, 0, 0), emittance=(e, e, e))
            g = b.add_rectangle(0.15, 0.15, m)
            x = (i - side / 2 + 0.5) * 1.2
            z = (j - side / 2 + 0.5) * 1.2
            b.add_instance(g, mod.affine(rotation=FLIP_X,
                                         translation=[x, 2.0, z]))
    if occluders:
        mat = b.add_lambert_material((0.5, 0.4, 0.3))
        sph = b.add_sphere(0.35, mat, n_theta=10, n_phi=20)
        for k in range(occluders):
            x, z = rng.uniform(-1.5, 1.5, 2)
            b.add_instance(sph, mod.affine(translation=[x, 0.6, z]))
    return b


def glossy_box_scene(mod):
    """box_scene with a diffuse + GGX floor and two diffuse + GGX spheres,
    one rough and one near-mirror, on it."""
    b = box_scene(mod)
    floor = b.add_diffuse_specular_material((0.5, 0.45, 0.4), (0.04,) * 3,
                                            smoothness=0.7)
    b.add_instance(b.add_rectangle(3.9, 3.9, floor),
                   mod.affine(translation=[0, -1.99, 0]))
    rough = b.add_diffuse_specular_material((0.6, 0.2, 0.2), (0.3,) * 3,
                                            smoothness=0.4)
    mirror = b.add_diffuse_specular_material((0.05, 0.05, 0.05),
                                             (0.9, 0.9, 0.9),
                                             smoothness=0.97)
    for mat, t in ((rough, [-0.7, -1.4, -0.3]), (mirror, [0.8, -1.3, 0.2])):
        sph = b.add_sphere(0.55, mat, n_theta=16, n_phi=32)
        b.add_instance(sph, mod.affine(translation=t))
    return b
