"""The port's app framework against gfxexp_tpu's: the scene DSL builds the
same scene and controllers, and `python -m gfxexp_torch.apps.path_tracing`
(`main`) renders an animated scene on the CPU (`-device cpu`) into a PNG,
through the skip-link refit and through the two-level rigid update, and a
static one through the wide-row and the quantized-row tables. The svgf and
restir_di apps (classic and -rearch) and path_tracing -denoise render 32x32
images on the CPU; the Denoiser and pick_info match JAX's on one
G-buffer."""

import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch

from gfxexp_torch.apps import common as tcommon
from gfxexp_torch.apps import path_tracing as tpt_app
from gfxexp_torch.apps import restir_di as trestir_app
from gfxexp_torch.apps import svgf as tsvgf_app
from gfxexp_tpu.apps import common as jcommon

torch.set_num_threads(2)

DSL = ["-name", "floor", "-rectangle", "4", "4", "-inst", "floor",
       "-name", "ball", "-sphere", "0.4", "-inst", "ball", "-position", "0",
       "0.4", "0", "-begin-pos", "0", "0.4", "0", "-end-pos", "0.3", "0.9",
       "0", "-begin-scale", "1", "-end-scale", "1.5", "-freq", "2",
       "-time", "0.25",
       "-name", "lamp", "-emittance", "30", "30", "30", "-sphere", "0.3",
       "-inst", "lamp", "-position", "0", "2", "0"]
VIEW = ["-cam-pos", "0", "1", "3.2", "-cam-pitch", "-12"]


def _build(mod, argv):
    args = mod.parse_scene_args(mod.make_arg_parser("path_tracing"), argv)
    return args, mod.build_scene_from_dsl(args, args.scene_args)


def test_dsl_builds_the_same_scene_and_controllers():
    _, (tb, tctl) = _build(tcommon, VIEW + DSL)
    _, (jb, jctl) = _build(jcommon, VIEW + DSL)
    assert len(tb.instances) == len(jb.instances) == 3
    for a, b in zip(tb.instances, jb.instances):
        assert a.geometries == b.geometries
        np.testing.assert_array_equal(a.transform, b.transform)
    for a, b in zip(tb.geometries, jb.geometries):
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.material == b.material
    assert [m.emittance for m in tb.materials] == [
        m.emittance for m in jb.materials]
    assert [dataclasses.asdict(c) for c in tctl] == [
        dataclasses.asdict(c) for c in jctl]
    assert len(tctl) == 1 and tctl[0].instance == 1
    # the camera: same orientation matrix and parameters
    targs, _ = _build(tcommon, VIEW + DSL)
    jargs, _ = _build(jcommon, VIEW + DSL)
    tc = tcommon.make_camera_from_args(targs)
    jc = jcommon.make_camera_from_args(jargs)
    np.testing.assert_allclose(tc.orientation.numpy(),
                               np.asarray(jc.orientation), atol=1e-6)
    np.testing.assert_allclose(tc.position.numpy(), np.asarray(jc.position))


def _read_png_size(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = zlib.decompress(idat)
    assert len(raw) == h * (1 + 3 * w)
    return w, h


@pytest.mark.parametrize("traversal", ["skip", "instanced"])
def test_main_renders_an_animated_scene_on_the_cpu(tmp_path, traversal,
                                                   capsys):
    out = tmp_path / "pt"
    argv = ["-device", "cpu", "-width", "24", "-height", "16", "-frames",
            "3", "-max-path-length", "3", "-stats", "-output", str(out),
            *VIEW, *DSL]
    if traversal == "instanced":
        argv = ["-traversal", "instanced", *argv]
    hdr = tpt_app.main(argv)
    assert hdr.shape == (16, 24, 3) and np.isfinite(hdr).all()
    assert hdr.mean() > 0.0
    assert _read_png_size(str(out) + ".png") == (24, 16)
    err = capsys.readouterr().err
    assert "update:" in err and "pathTrace:" in err


@pytest.mark.parametrize("traversal", ["widerow", "qrow"])
def test_main_renders_a_static_scene_on_the_cpu(tmp_path, traversal):
    """`-traversal widerow` and `-traversal qrow` on a scene without
    animation (the lamp and the floor of DSL, the ball at rest)."""
    static = list(DSL)
    i = static.index("-begin-pos")
    del static[i:i + 16]  # the ball's -begin-pos ... -time 0.25
    out = tmp_path / traversal
    hdr = tpt_app.main(["-device", "cpu", "-width", "24", "-height", "16",
                        "-frames", "2", "-max-path-length", "3",
                        "-traversal", traversal, "-output", str(out), *VIEW,
                        *static])
    assert hdr.shape == (16, 24, 3) and np.isfinite(hdr).all()
    assert hdr.mean() > 0.0
    assert _read_png_size(str(out) + ".png") == (24, 16)


def test_unported_options_raise(tmp_path):
    """Without a card the apps' default device raises and names the fix
    (every option of the apps is ported; -live is tested in
    tests/test_torch_utils.py)."""
    if not torch.cuda.is_available():
        for app in (tpt_app, tsvgf_app, trestir_app):
            with pytest.raises(RuntimeError, match="-device cpu"):
                app.main(["-output", str(tmp_path / "y")])


def test_env_texture_and_texture_lod_build_as_jax(tmp_path):
    """-env-texture reads a lat-long EXR into the environment and
    -texture-lod makes the builder keep mips, in both packages alike."""
    from gfxexp_torch.utils.image_io import save_exr

    sky = str(tmp_path / "sky.exr")
    save_exr(sky, np.linspace(0.1, 2.0, 8 * 16 * 4, dtype=np.float32)
             .reshape(8, 16, 4), half=False)
    argv = ["-env-texture", sky, "-env-power", "0.5", "-texture-lod"] + DSL
    (_, (tb, _)), (_, (jb, _)) = _build(tcommon, argv), _build(jcommon, argv)
    np.testing.assert_array_equal(tb.env_radiance, jb.env_radiance)
    assert tb.env_radiance.shape == (8, 16, 3) and tb.env_power == 0.5
    assert tb.atlas.mips and jb.atlas.mips


def test_path_tracing_options(tmp_path):
    """-exr writes the accumulated image (read back within half precision),
    -debug-switches reach the tracer (bit 0, no NEE, darkens the box and
    lamp of a command line without a scene), and -bump,
    -texture-lod and -fused-shadow-rays run."""
    from gfxexp_torch.utils.image_io import load_exr

    base = ["-device", "cpu", "-width", "16", "-height", "12", "-frames",
            "2", "-max-path-length", "3"]
    out = str(tmp_path / "pt")
    hdr = tpt_app.main(base + ["-output", out, "-exr", "-bump",
                               "-texture-lod", "-fused-shadow-rays"])
    back = load_exr(out + ".exr")
    assert back.shape == (12, 16, 3)
    np.testing.assert_allclose(back, hdr, rtol=1e-3, atol=1e-6)
    dark = tpt_app.main(base + ["-output", out + "_nonee",
                                "-debug-switches", "1"])
    assert 0.0 < dark.mean() < 0.8 * hdr.mean()


STATIC = DSL[:DSL.index("-begin-pos")] + DSL[DSL.index("-begin-pos") + 16:]
# case: (app, options, DSL scene (the box and lamp when empty), lit). The
# DSL's materials are black, so SVGF, which remodulates by the albedo,
# shows them black: its animated case is checked for a finite image only
TECHNIQUE_APPS = {
    "svgf": (tsvgf_app, ["-cam-pos", "0", "0", "3.16"], [], True),
    "svgf_gauss_feedback": (tsvgf_app, ["-cam-pos", "0", "0", "3.16",
                                        "-filter-stages", "3",
                                        "-feedback-1st", "-no-taa"], [],
                            True),
    "svgf_animated": (tsvgf_app, VIEW, DSL, False),
    "restir_di": (trestir_app, VIEW, STATIC, True),
    "restir_di_rearch_denoise": (trestir_app, [*VIEW, "-rearch", "-denoise",
                                               "-light-subsets", "8",
                                               "-light-subset-size", "64"],
                                 DSL, True),
    "path_tracing_denoise": (tpt_app, [*VIEW, "-denoise"], STATIC, True),
}


@pytest.mark.parametrize("case", list(TECHNIQUE_APPS))
def test_technique_apps_render_on_the_cpu(tmp_path, case, capsys):
    """Each app's main at 32x32, 3 frames on the CPU: a finite image of the
    right size (lit where the scene allows), its PNG, and the -stats line
    with its passes."""
    mod, extra, dsl, lit = TECHNIQUE_APPS[case]
    out = tmp_path / case
    hdr = mod.main(["-device", "cpu", "-width", "32", "-height", "32",
                    "-frames", "3", "-max-path-length", "3", "-stats",
                    "-output", str(out), *extra, *dsl])
    assert hdr.shape == (32, 32, 3) and np.isfinite(hdr).all()
    assert hdr.mean() > 0.0 or not lit
    assert _read_png_size(str(out) + ".png") == (32, 32)
    err = capsys.readouterr().err
    passes = {"svgf": ("gbuffer:", "pathTrace:", "svgf:"),
              "restir_di": ("gbuffer:", "restir:"),
              "path_tracing": ("pathTrace:", "denoise:")}[mod.__name__.split(
                  ".")[-1]]
    assert all(p in err for p in passes), err
    if dsl is DSL:
        assert "update:" in err
    if "-denoise" in extra:
        assert "denoise:" in err


def test_denoiser_and_pick_info_match_jax():
    """The port's Denoiser and pick_info against JAX's on the same
    G-buffer (JAX's, carried over) and accumulated image: the denoised
    image within 1e-4 (svgf_frame's bar, tests/test_torch_svgf.py) over
    two steps, and the picked pixel's fields equal (positions within
    1e-6)."""
    import jax.numpy as jnp

    import gfxexp_torch.scene.builder as TB
    import gfxexp_tpu.scene.builder as JB
    from gfxexp_torch.render.camera import make_camera as t_camera
    from gfxexp_torch.scene.compile import compile_scene as tcompile
    from gfxexp_torch.scene.types import from_numpy
    from gfxexp_tpu.render.camera import make_camera as j_camera
    from gfxexp_tpu.render.gbuffer import render_gbuffer
    from gfxexp_tpu.scene.compile import compile_scene as jcompile

    sys_path = __import__("sys").path
    if "tests" not in sys_path:
        sys_path.insert(0, "tests")
    import torch_scenes as S

    js, jb = jcompile(S.box_scene(JB))
    ts, tb = tcompile(S.box_scene(TB))
    jc, tc = j_camera(**S.BOX_CAMERA), t_camera(**S.BOX_CAMERA)
    jden = jcommon.Denoiser(16, 16)
    tden = tcommon.Denoiser(16, 16, device="cpu")
    rng = np.random.default_rng(3)
    for f in range(2):
        jgb = render_gbuffer(js, jb, jc, jc, 16, 16, jnp.uint32(f), True)
        hdr = rng.gamma(2.0, 0.3, (16, 16, 3)).astype(np.float32)
        jout = jden.step(js, jb, jc, f, jnp.asarray(hdr), gb=jgb)
        tout = tden.step(ts, tb, tc, f, torch.from_numpy(hdr),
                         gb=from_numpy(jgb))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-4)
    assert tden.image is tout
    for x, y in ((3, 4), (15, 0)):
        a = tcommon.pick_info(ts, from_numpy(jgb), x, y)
        b = jcommon.pick_info(js, jgb, x, y)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                       np.asarray(b[k], np.float64),
                                       rtol=0, atol=1e-6, err_msg=k)
