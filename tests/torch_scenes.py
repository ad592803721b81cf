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


BOX_CAMERA = dict(position=[0, 0.5, 1.9], fov_y=np.deg2rad(75), aspect=1.0,
                  target=[0, 0.3, -1.0])
FURNACE_CAMERA = dict(position=[0, 0, 3.0], fov_y=np.deg2rad(45),
                      aspect=1.0, target=[0, 0, 0])


def image_rel_diff(a, b):
    """Mean relative absolute image difference (the golden test's bar)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6)
