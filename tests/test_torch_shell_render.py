"""The shell-mapped nrtdsm scene through the path tracer (the torus OBJ
tiled 2 x 2 inside curved shells, intersect_shell with a material per hit)
against gfxexp_tpu's render_sample at 16x16, and the nrtdsm CLI with -shell
on the CPU, with the bars of tests/test_torch_nrtdsm_render.py: mean
relative image difference < 5e-3 (measured 3.7e-7), equal ray counts, the
scene carried across by from_numpy rendering bit for bit as the port's
build."""

from test_torch_nrtdsm_render import (  # noqa: F401  (torus_obj: a fixture)
    check_cli_writes_images,
    check_render_matches_jax,
    torus_obj,
)


def test_shell_render_matches_jax(torus_obj):  # noqa: F811
    check_render_matches_jax("shell", torus_obj)


def test_nrtdsm_cli_shell_writes_images(tmp_path, torus_obj):  # noqa: F811
    check_cli_writes_images(tmp_path, torus_obj,
                            ["-shell", "-shell-grid", "2", "-heatmap"])
