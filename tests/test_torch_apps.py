"""The port's app framework against gfxexp_tpu's: the scene DSL builds the
same scene and controllers, and `python -m gfxexp_torch.apps.path_tracing`
(`main`) renders an animated scene on the CPU (`-device cpu`) into a PNG,
through the skip-link refit and through the two-level rigid update, and a
static one through the wide-row and the quantized-row tables."""

import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch

from gfxexp_torch.apps import common as tcommon
from gfxexp_torch.apps import path_tracing as tpt_app
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
    base = ["-device", "cpu", "-output", str(tmp_path / "x")]
    for extra in (["-exr"], ["-denoise"], ["-live"],
                  ["-env-texture", "sky.exr"], ["-obj", "m.obj", "1"]):
        with pytest.raises(NotImplementedError):
            tpt_app.main(base + extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="-device cpu"):
            tpt_app.main(["-output", str(tmp_path / "y")])
