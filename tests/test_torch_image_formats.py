"""The port's image decoders (utils/image_io.py, utils/jpeg.py,
utils/image_formats.py) against the JAX package's load_png, which reads
through PIL, on files written here by PIL or, for the variants PIL cannot
write, by tests/torch_images/writers.py.

Bars: the port's load_png equals JAX's bit for bit, with to_linear off and
on, except where JAX's result is not an image in [0, 1]:
- palettes expand in the port: it equals PIL's convert("RGB") or
  convert("RGBA") / 255 (and sRGB to linear, JAX's formula);
- 16-bit grey (PNG, PNM with a maxval over 255): port * 65535 equals
  jax * 255 (both rounded to the nearest integer, the sample);
- 1-bit grey (PNG, PNM P1 / P4, BMP): port equals jax * 255.
JPEG: progressive files cut after each scan (libjpeg's block smoothing)
and lossless (SOF3) files decode to PIL's uint8 samples too; every JPEG
frame PIL refuses raises in the port.
Also: an OBJ whose MTL names a .jpg and a GLB with an embedded JPEG build
atlases equal to JAX's; the tfdm app reads a 16-bit grey height map at full
precision; save_png / encode_png write files that decode to JAX's pixels;
TIFF and WebP raise NotImplementedError naming the format; the committed
fixtures (tests/torch_images/) decode to their recorded digests, in the
port and in JAX.
"""

import hashlib
import io
import json
import os
import struct
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, "tests")
sys.path.insert(0, os.path.join("tests", "torch_images"))

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
import writers as W  # noqa: E402
from gfxexp_torch import bench  # noqa: E402
from gfxexp_torch.scene import loaders as TL  # noqa: E402
from gfxexp_torch.utils import image_io as tio  # noqa: E402
from gfxexp_tpu.scene import loaders as JL  # noqa: E402
from gfxexp_tpu.utils import image_io as jio  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_images")


def _srgb_to_linear(arr):
    return np.where(arr <= 0.04045, arr / 12.92,
                    np.power((arr + 0.055) / 1.055, 2.4))


def _check(tmp_path, data, kind="equal", ext=".img"):
    """Write data, load it through both packages, hold them to the bar of
    `kind`: "equal", "palette" (PIL's conversion to RGB / RGBA),
    "grey16" or "grey1"."""
    from PIL import Image

    path = str(tmp_path / f"f{ext}")
    with open(path, "wb") as f:
        f.write(data)
    for to_linear in (False, True):
        port = tio.load_png(path, to_linear)
        jax = jio.load_png(path, to_linear)
        assert port.dtype == np.float32
        if kind == "equal":
            np.testing.assert_array_equal(port, jax)
        elif kind == "palette":
            im = Image.open(path)
            mode = "RGBA" if port.shape[-1] == 4 else "RGB"
            want = np.asarray(im.convert(mode)).astype(np.float32) / 255.0
            if to_linear:
                want = _srgb_to_linear(want)
            np.testing.assert_array_equal(port, want)
            assert jax.ndim == 2  # JAX hands back the indices
        elif kind == "grey16":
            if not to_linear:
                np.testing.assert_array_equal(np.rint(port * 65535.0),
                                              np.rint(jax * 255.0))
                raw = port
            else:
                np.testing.assert_array_equal(port, _srgb_to_linear(raw))
        elif kind == "grey1":
            if not to_linear:
                np.testing.assert_array_equal(port, jax * 255.0)
            assert set(np.unique(port)) <= {0.0, 1.0}
    return port


# ---------------------------------------------------------------------------
# PNG: every bit depth and colour type, plain and Adam7
# ---------------------------------------------------------------------------

PNG_CASES = [(d, c) for c, ds in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                  (3, (1, 2, 4, 8)), (4, (8, 16)),
                                  (6, (8, 16))) for d in ds]


def _png_file(depth, ctype, interlace, trns, rng, h=13, w=11):
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = rng.integers(0, 1 << depth, (h, w, c))
    px[2::4] = px[1::4][:len(px[2::4])]  # repeated rows give filters work
    palette, t = None, None
    if ctype == 3:
        n = min(1 << depth, 40)
        px %= n
        palette = rng.integers(0, 256, (n, 3))
        if trns:
            t = rng.integers(0, 256, max(1, n // 2)).tolist()
    elif trns:
        t = list(struct.pack(">" + "H" * (3 if ctype == 2 else 1),
                             *px[0, 0, :3].tolist()))
    return W.png(px, depth, ctype, interlace, palette, t)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("depth,ctype", PNG_CASES)
def test_png_matches_jax(tmp_path, depth, ctype, interlace):
    rng = np.random.default_rng(depth * 10 + ctype)
    data = _png_file(depth, ctype, interlace, False, rng)
    kind = ("palette" if ctype == 3 else "grey16" if (ctype, depth) == (
        0, 16) else "grey1" if (ctype, depth) == (0, 1) else "equal")
    port = _check(tmp_path, data, kind)
    assert port.shape[:2] == (13, 11)


@pytest.mark.parametrize("depth,ctype", [(8, 0), (16, 0), (1, 0), (8, 2),
                                         (16, 2), (4, 3), (8, 3)])
def test_png_with_trns_matches_jax(tmp_path, depth, ctype):
    """tRNS: PIL ignores it on grey and RGB (as the port does) and gives a
    palette its alpha."""
    rng = np.random.default_rng(50 + depth)
    data = _png_file(depth, ctype, depth == 8, True, rng)
    kind = ("palette" if ctype == 3 else "grey16" if (ctype, depth) == (
        0, 16) else "grey1" if (ctype, depth) == (0, 1) else "equal")
    port = _check(tmp_path, data, kind)
    if ctype == 3:
        assert port.shape[-1] == 4


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


def _photo(h, w, c, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([np.sin(x / (3 + k)) * 80 + np.cos(y / (4 + k)) * 60 + 128
                  for k in range(c)], -1) + rng.normal(0, 20, (h, w, c))
    return np.clip(a, 0, 255).astype(np.uint8)


PIL_JPEG = {
    "baseline_444": ("RGB", 37, 53, dict(subsampling=0, quality=90)),
    "baseline_422": ("RGB", 37, 53, dict(subsampling=1, quality=75)),
    "baseline_420": ("RGB", 64, 64, dict(subsampling=2, quality=50)),
    "baseline_420_tiny": ("RGB", 5, 3, dict(subsampling=2)),
    "baseline_420_width4": ("RGB", 9, 4, dict(subsampling=2)),
    "optimized_422": ("RGB", 21, 30, dict(subsampling=1, optimize=True)),
    "restart_420": ("RGB", 40, 48, dict(subsampling=2,
                                        restart_marker_blocks=3)),
    "progressive_420": ("RGB", 64, 64, dict(subsampling=2,
                                            progressive=True)),
    "progressive_444": ("RGB", 19, 23, dict(subsampling=0, progressive=True,
                                            quality=95)),
    "progressive_restart": ("RGB", 33, 41, dict(progressive=True,
                                                restart_marker_rows=1)),
    "grey": ("L", 29, 31, dict(quality=80)),
    "grey_progressive": ("L", 29, 31, dict(progressive=True)),
    "cmyk": ("CMYK", 24, 17, dict(quality=85)),
    "cmyk_progressive": ("CMYK", 17, 24, dict(progressive=True)),
}


@pytest.mark.parametrize("case", list(PIL_JPEG))
def test_jpeg_written_by_pil_matches_jax(tmp_path, case):
    from PIL import Image

    mode, h, w, kw = PIL_JPEG[case]
    c = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    a = _photo(h, w, c, len(case))
    buf = io.BytesIO()
    Image.fromarray(a[..., 0] if c == 1 else a, mode).save(buf, "JPEG", **kw)
    port = _check(tmp_path, buf.getvalue(), ext=".jpg")
    assert port.shape == ((h, w) if c == 1 else (h, w, c))


_JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _adobe(transform):
    return (b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
            + bytes([transform]))


# (components, sampling factors, ids, APP segments, restart, interleaved,
# SOF marker)
CUSTOM_JPEG = {
    "h1v2_440": (3, [(1, 2), (1, 1), (1, 1)], None, _JFIF, 0, True, 0xC0),
    "h4v1_411": (3, [(4, 1), (1, 1), (1, 1)], None, _JFIF, 0, True, 0xC0),
    "h2v2_chroma_h1v2": (3, [(2, 2), (1, 2), (1, 2)], None, _JFIF, 0, True,
                         0xC0),
    "h3v1_replicated": (3, [(3, 1), (1, 1), (1, 1)], None, _JFIF, 0, True,
                        0xC0),
    "h4v1_chroma_h2v1": (3, [(4, 1), (2, 1), (2, 1)], None, _JFIF, 0, True,
                         0xC0),
    "luma_subsampled": (3, [(1, 1), (2, 2), (2, 2)], None, _JFIF, 0, True,
                        0xC0),
    "non_interleaved": (3, [(2, 2), (1, 1), (1, 1)], None, _JFIF, 0, False,
                        0xC0),
    "extended_sof1_restart": (3, [(2, 1), (1, 1), (1, 1)], None, _JFIF, 2,
                              True, 0xC1),
    "adobe_rgb": (3, [(1, 1)] * 3, None, _adobe(0), 0, True, 0xC0),
    "ids_rgb": (3, [(1, 1)] * 3, [82, 71, 66], b"", 0, True, 0xC0),
    "no_marker_ycc": (3, [(2, 1), (1, 1), (1, 1)], None, b"", 0, True, 0xC0),
    "adobe_ycck": (4, [(2, 2), (1, 1), (1, 1), (2, 2)], None, _adobe(2), 0,
                   True, 0xC0),
    "adobe_cmyk": (4, [(1, 1)] * 4, None, _adobe(0), 0, True, 0xC0),
    "grey_h2v2": (1, [(2, 2)], None, _JFIF, 0, True, 0xC0),
    "arith_sequential": (3, [(2, 2), (1, 1), (1, 1)], None, _JFIF, 0, True,
                         0xC9),
    "arith_sequential_restart": (3, [(2, 1), (1, 1), (1, 1)], None, _JFIF,
                                 3, True, 0xC9),
    "arith_progressive": (3, [(2, 2), (1, 1), (1, 1)], None, _JFIF, 0, True,
                          0xCA),
    "arith_grey": (1, [(1, 1)], None, _JFIF, 0, True, 0xC9),
}


@pytest.mark.parametrize("case", list(CUSTOM_JPEG))
def test_jpeg_variant_matches_jax(tmp_path, case):
    nc, factors, ids, app, restart, inter, sof = CUSTOM_JPEG[case]
    h, w = (27, 35) if nc > 1 else (21, 19)
    a = _photo(h, w, nc, len(case) + 7)
    data = W.jpeg([a[..., i] for i in range(nc)], factors, ids, app,
                  restart, inter, sof)
    port = _check(tmp_path, data, ext=".jpg")
    assert port.shape[:2] == (h, w)


def test_jpeg_unsupported_frames_raise():
    """Frames PIL refuses raise in the port too: 12-bit lossless, lossless
    with arithmetic coding (SOF11) and hierarchical (SOF5); a stream cut
    inside a scan raises ValueError."""
    from PIL import Image

    from gfxexp_torch.utils.jpeg import decode_jpeg

    a = _photo(8, 8, 1, 0)
    data = W.jpeg([a[..., 0]], [(1, 1)])
    for frame, match in (
            (W.jpeg_lossless([a[..., 0].astype(np.int64) * 16],
                             precision=12), "12-bit lossless"),
            (W.jpeg_lossless([a[..., 0]], sof=0xCB), "SOF11"),
            (data.replace(b"\xff\xc0", b"\xff\xc5", 1), "SOF5")):
        with pytest.raises(Exception):
            Image.open(io.BytesIO(frame)).load()
        with pytest.raises(NotImplementedError, match=match):
            decode_jpeg(frame)
    with pytest.raises(ValueError):
        decode_jpeg(data[:len(data) // 2])


def _pil_samples(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _check_jpeg(tmp_path, data, shape=None):
    """The port's decode_jpeg equals PIL's uint8 samples, and its load_png
    JAX's (to_linear off and on)."""
    from gfxexp_torch.utils.jpeg import decode_jpeg

    np.testing.assert_array_equal(decode_jpeg(data), _pil_samples(data))
    port = _check(tmp_path, data, ext=".jpg")
    if shape is not None:
        assert port.shape == shape


# progressive files cut after each scan: libjpeg smooths the blocks whose
# low coefficients are not yet whole. 24x9 4:2:0 has a luma component of 3
# block rows in 2 iMCU rows and 2 block columns: the edges of the 5x5
# neighbourhood.
PIL_CUT = {
    "grey": ("L", 29, 31, {}),
    "420": ("RGB", 40, 35, dict(subsampling=2)),
    "420_narrow": ("RGB", 24, 9, dict(subsampling=2)),
    "444": ("RGB", 19, 23, dict(subsampling=0, quality=90)),
    "cmyk": ("CMYK", 17, 24, {}),
}


@pytest.mark.parametrize("case", list(PIL_CUT))
def test_jpeg_cut_after_each_scan_matches_jax(tmp_path, case):
    from PIL import Image

    mode, h, w, kw = PIL_CUT[case]
    c = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    a = _photo(h, w, c, len(case) + 40)
    buf = io.BytesIO()
    Image.fromarray(a[..., 0] if c == 1 else a, mode).save(
        buf, "JPEG", progressive=True, **kw)
    data = buf.getvalue()
    n = len(W.jpeg_scan_ends(data))
    assert n >= 6
    for k in range(1, n):
        _check_jpeg(tmp_path, W.jpeg_cut(data, k),
                    (h, w) if c == 1 else (h, w, c))


# the writer's progressive scripts stopped after each scan, Huffman (SOF2)
# and arithmetic (SOF10); luma 2x2 against chroma 1x1, and 4x1 / 1x2
WRITER_CUT = {
    "huffman_420": (0xC2, 3, [(2, 2), (1, 1), (1, 1)]),
    "arith_420": (0xCA, 3, [(2, 2), (1, 1), (1, 1)]),
    "huffman_grey": (0xC2, 1, [(1, 1)]),
    "arith_h4v1_h1v2": (0xCA, 3, [(4, 1), (1, 2), (1, 1)]),
}


@pytest.mark.parametrize("case", list(WRITER_CUT))
def test_jpeg_script_stopped_early_matches_jax(tmp_path, case):
    sof, nc, factors = WRITER_CUT[case]
    h, w = 27, 35
    a = _photo(h, w, nc, len(case) + 50)
    script = W.progressive_script(nc)
    for k in range(1, len(script)):
        data = W.jpeg([a[..., i] for i in range(nc)], factors,
                      app=_JFIF if nc == 3 else b"", sof=sof,
                      restart=3 if k % 2 else 0, scans=script[:k])
        _check_jpeg(tmp_path, data, (h, w) if nc == 1 else (h, w, nc))


@pytest.mark.parametrize("sof", [0xC2, 0xCA])
def test_jpeg_whole_script_left_unrefined_matches_jax(tmp_path, sof):
    """A complete file whose script never refines AC to Al 0; and one whose
    DC scans are one per component, so that a cut after the first leaves
    two components without a scan (libjpeg gives them 128)."""
    a = _photo(26, 30, 3, sof)
    planes = [a[..., i] for i in range(3)]
    factors = [(2, 1), (1, 1), (1, 1)]
    unrefined = [([0, 1, 2], 0, 0, 0, 0)] + [([s], 1, 63, 0, 2)
                                             for s in range(3)]
    _check_jpeg(tmp_path, W.jpeg(planes, factors, app=_JFIF, sof=sof,
                                 scans=unrefined), (26, 30, 3))
    separate = [([s], 0, 0, 0, 0) for s in range(3)] + [
        ([s], 1, 63, 0, 0) for s in range(3)]
    data = W.jpeg(planes, factors, app=_JFIF, sof=sof, scans=separate)
    for k in (1, 2, 4):
        _check_jpeg(tmp_path, W.jpeg_cut(data, k), (26, 30, 3))


@pytest.mark.parametrize("zero", [1, 24, 32])
def test_jpeg_zero_quantiser_step_turns_smoothing_off(tmp_path, zero):
    """A zero step at any of coefficients 0-9 (natural positions 1 and 24:
    Q01, Q30), in the chroma table alone, turns smoothing off for every
    component; a zero elsewhere (32) leaves it on."""
    import gfxexp_torch.utils.jpeg as J

    a = _photo(24, 32, 3, zero)
    q = 2 + np.add.outer(np.arange(8), np.arange(8))
    qz = q.copy()
    qz.reshape(64)[zero] = 0
    data = W.jpeg([a[..., i] for i in range(3)], [(2, 2), (1, 1), (1, 1)],
                  app=_JFIF, sof=0xC2, q=(q, qz),
                  scans=W.progressive_script(3)[:3])
    _check_jpeg(tmp_path, data, (24, 32, 3))
    frame = {"progressive": True}
    comps = []
    for table in (q, qz):
        c = J._Component()
        c.qtable = table.reshape(64)
        c.coef_bits = [0] + [2] * 9 + [-1] * 54
        comps.append(c)
    assert J._smoothing_ok(frame, comps) == (zero == 32)


# lossless (SOF3) frames at 8 bits: every predictor, point transforms 0
# and 2; restarts; 1, 3 and 4 components with the colour spaces libjpeg
# reads without conversion; subsampled components, which it replicates


@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_jpeg_lossless_predictors_match_jax(tmp_path, predictor, pt):
    a = _photo(13, 17, 1, predictor)[..., 0]
    data = W.jpeg_lossless([a], predictor, pt)
    _check_jpeg(tmp_path, data, (13, 17))
    np.testing.assert_array_equal(_pil_samples(data), (a >> pt) << pt)


@pytest.mark.parametrize("predictor", [1, 6])
def test_jpeg_lossless_restart_matches_jax(tmp_path, predictor):
    a = _photo(11, 9, 3, predictor)
    _check_jpeg(tmp_path, W.jpeg_lossless([a[..., 0]], predictor,
                                          restart=9), (11, 9))
    _check_jpeg(tmp_path, W.jpeg_lossless([a[..., i] for i in range(3)],
                                          predictor, restart=18),
                (11, 9, 3))


# (components, ids, APP segment, PIL's mode)
LOSSLESS_COLOUR = {
    "ids_123": (3, None, b"", "RGB"),
    "ids_rgb": (3, [82, 71, 66], b"", "RGB"),
    "adobe_rgb": (3, None, _adobe(0), "RGB"),
    "cmyk": (4, None, b"", "CMYK"),
    "adobe_cmyk": (4, None, _adobe(0), "CMYK"),
}


@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("case", list(LOSSLESS_COLOUR))
def test_jpeg_lossless_colour_matches_jax(tmp_path, case, interleaved):
    from PIL import Image

    nc, ids, app, mode = LOSSLESS_COLOUR[case]
    a = _photo(10, 12, nc, nc + len(case))
    data = W.jpeg_lossless([a[..., i] for i in range(nc)], 4, 0, ids, app,
                           interleaved=interleaved)
    assert Image.open(io.BytesIO(data)).mode == mode
    _check_jpeg(tmp_path, data, (10, 12, nc))
    np.testing.assert_array_equal(_pil_samples(data),
                                  a if nc == 3 else 255 - a)


# sampling factors; interleaved or not; restart interval in MCUs
LOSSLESS_SUBSAMPLED = {
    "h2v2": ([(2, 2), (1, 1), (1, 1)], True, 0),
    "h2v2_separate_restart": ([(2, 2), (1, 1), (1, 1)], False, 16),
    "h4v1_h2v1": ([(4, 1), (2, 1), (1, 1)], True, 4),
    "h1v2_grey": ([(1, 2)], True, 16),
}


@pytest.mark.parametrize("case", list(LOSSLESS_SUBSAMPLED))
def test_jpeg_lossless_subsampled_matches_jax(tmp_path, case):
    factors, interleaved, restart = LOSSLESS_SUBSAMPLED[case]
    h, w = 11, 16
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    planes = [_photo(-(-h * v // vmax), -(-w * fh // hmax), 1, i)[..., 0]
              for i, (fh, v) in enumerate(factors)]
    data = W.jpeg_lossless(planes, 5, 1, restart=restart,
                           interleaved=interleaved, factors=factors)
    nc = len(factors)
    _check_jpeg(tmp_path, data, (h, w) if nc == 1 else (h, w, nc))


# lossless frames PIL refuses: a colour conversion, a restart interval
# that is not a whole number of MCU rows, a bad predictor, 2-bit samples
LOSSLESS_REFUSED = {
    "jfif_ycc": ([0, 1, 2], _JFIF, {}, NotImplementedError),
    "adobe_ycc": ([0, 1, 2], _adobe(1), {}, NotImplementedError),
    "adobe_ycck": ([0, 1, 2, 3], _adobe(2), {}, NotImplementedError),
    "restart_in_row": ([0], b"", dict(restart=5), ValueError),
    "predictor_0": ([0], b"", dict(ss=0), ValueError),
    "2_bit": ([0], b"", dict(precision=2), NotImplementedError),
}


@pytest.mark.parametrize("case", list(LOSSLESS_REFUSED))
def test_jpeg_lossless_refused_by_pil_raises(case):
    from gfxexp_torch.utils.jpeg import decode_jpeg

    slots, app, kw, error = LOSSLESS_REFUSED[case]
    kw = dict(kw)
    a = _photo(8, 10, len(slots), 3)
    if kw.get("precision") == 2:
        a = a >> 6
    ss = kw.pop("ss", None)
    data = W.jpeg_lossless([a[..., i] for i in slots], app=app, **kw)
    if ss is not None:  # the selection value, after Ns, Cs and Td / Ta
        o = data.index(b"\xff\xda") + 7
        data = data[:o] + bytes([ss]) + data[o + 1:]
    with pytest.raises(Exception):
        _pil_samples(data)
    with pytest.raises(error):
        decode_jpeg(data)


# ---------------------------------------------------------------------------
# TGA, BMP, GIF, PNM
# ---------------------------------------------------------------------------


def _pil_bytes(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _tga_case(case, rng):
    from PIL import Image

    h, w = 9, 14
    if case.startswith("pil_"):
        mode, rle, ori = case[4:].split("_")
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        a = rng.integers(0, 256, (h, w, c), np.uint8)
        a[3:6] = a[2]  # runs for the RLE
        im = Image.fromarray(a[..., 0] if c == 1 else a, mode)
        return _pil_bytes(im, "TGA", rle=rle == "rle",
                          orientation=1 if ori == "top" else -1), "equal"
    if case == "P_pil":
        im = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        return _pil_bytes(im.quantize(30), "TGA"), "palette"
    itype, depth, flags, cmap_depth = {
        "rgb16": (2, 16, 0x20, 0), "rgb16_rle_bottom": (10, 16, 0, 0),
        "rgb24_right_to_left": (2, 24, 0x10, 0),
        "rgb32_rle_top_right": (10, 32, 0x30, 0),
        "grey_alpha16_rle": (11, 16, 0x20, 0),
        "cmap24_rle": (9, 8, 0, 24), "cmap24_top": (1, 8, 0x20, 24),
        "cmap16": (1, 8, 0, 16)}[case]
    bpp = depth // 8
    pix = rng.integers(0, 256, (h, w, bpp), np.uint8)
    pix[2:5] = pix[1]
    cmap = None
    if cmap_depth:
        pix %= 20
        cmap = rng.integers(0, 256, (20, cmap_depth // 8), np.uint8)
    data = W.tga(pix, itype, depth, flags, cmap, cmap_depth or 24,
                 cmap_start=0, ident=b"id")
    return data, "palette" if cmap_depth else "equal"


TGA_CASES = ["pil_L_raw_bottom", "pil_L_rle_top", "pil_LA_raw_top",
             "pil_RGB_rle_bottom", "pil_RGB_raw_top", "pil_RGBA_rle_top",
             "pil_RGBA_raw_bottom", "P_pil", "rgb16", "rgb16_rle_bottom",
             "rgb24_right_to_left", "rgb32_rle_top_right",
             "grey_alpha16_rle", "cmap24_rle", "cmap24_top", "cmap16"]


@pytest.mark.parametrize("case", TGA_CASES)
def test_tga_matches_jax(tmp_path, case):
    data, kind = _tga_case(case, np.random.default_rng(len(case)))
    port = _check(tmp_path, data, kind, ext=".tga")
    assert port.shape[:2] == (9, 14)


def _bmp_case(case, rng):
    from PIL import Image

    h, w = 7, 13
    if case.startswith("pil_"):
        mode = case[4:]
        if mode == "1":
            im = Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
        elif mode == "P":
            im = Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                              np.uint8)).quantize(40)
        else:
            c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
            a = rng.integers(0, 256, (h, w, c), np.uint8)
            im = Image.fromarray(a[..., 0] if c == 1 else a, mode)
        kind = {"P": "palette", "1": "grey1"}.get(mode, "equal")
        return _pil_bytes(im, "BMP"), kind
    pal = rng.integers(0, 256, (16, 3)).tolist()
    if case in ("rle8", "rle4"):
        idx = rng.integers(0, 16, (h, w))
        idx[:, 2:7] = idx[:, 2:3]  # runs
        return W.bmp(W.bmp_rle(idx, case == "rle4"), 8 if case == "rle8"
                     else 4, w, h, pal, 1 if case == "rle8" else 2), \
            "palette"
    if case == "bits1":  # two colours, not black and white
        idx = rng.integers(0, 2, (h, w))
        rows = [np.packbits(r.astype(np.uint8)).tobytes() for r in idx[::-1]]
        return W.bmp(rows, 1, w, h, pal[:2]), "palette"
    if case in ("bits4", "bits4_top_down", "os2_bits8"):
        bits = 8 if case == "os2_bits8" else 4
        idx = rng.integers(0, 16, (h, w))
        rows = []
        for r in idx[::-1] if case != "bits4_top_down" else idx:
            if bits == 4:
                r = np.append(r, 0) if w % 2 else r
                rows.append(bytes(((r[0::2] << 4) | r[1::2]).tolist()))
            else:
                rows.append(bytes(r.tolist()))
        return W.bmp(rows, bits, w, h, pal, header=12 if bits == 8 else 40,
                     top_down=case == "bits4_top_down"), "palette"
    if case == "grey_ramp8":
        idx = rng.integers(0, 256, (h, w))
        return W.bmp([bytes(r.tolist()) for r in idx[::-1]], 8, w, h,
                     [(i, i, i) for i in range(256)]), "equal"
    bits, masks, header = {
        "rgb16": (16, None, 40), "bitfields565": (16, (0xF800, 0x7E0, 0x1F),
                                                  40),
        "bitfields555_v3": (16, (0x7C00, 0x3E0, 0x1F, 0), 56),
        "rgb32": (32, None, 40),
        "bitfields_bgra_v5": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 124),
        "bitfields_rgba_v4": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 108),
        "bitfields_xbgr": (32, (0xFF000000, 0xFF0000, 0xFF00, 0), 40),
        "rgb24_top_down": (24, None, 40)}[case]
    px = rng.integers(0, 256, (h, w, bits // 8), np.uint8)
    rows = [r.tobytes() for r in px]
    return W.bmp(rows, bits, w, h, compression=3 if masks else 0,
                 masks=masks, header=header,
                 top_down=case == "rgb24_top_down"), "equal"


BMP_CASES = ["pil_1", "pil_L", "pil_P", "pil_RGB", "pil_RGBA", "rle8",
             "rle4", "bits1", "bits4", "bits4_top_down", "os2_bits8",
             "grey_ramp8",
             "rgb16", "bitfields565", "bitfields555_v3", "rgb32",
             "bitfields_bgra_v5", "bitfields_rgba_v4", "bitfields_xbgr",
             "rgb24_top_down"]


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp_matches_jax(tmp_path, case):
    data, kind = _bmp_case(case, np.random.default_rng(len(case) + 3))
    port = _check(tmp_path, data, kind, ext=".bmp")
    assert port.shape[:2] == (7, 13)


def _gif_case(case, rng):
    from PIL import Image

    h, w = 11, 9
    if case.startswith("pil_"):
        im = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        if case == "pil_grey":
            im = im.convert("L")
        else:
            im = im.quantize(60)
        kw = {"interlace": case == "pil_interlaced"}
        if case == "pil_transparent":
            kw["transparency"] = 5
        data = _pil_bytes(im, "GIF", **kw)
        # PIL writes a grey image with the grey levels it uses as a palette
        return data, ("equal" if Image.open(io.BytesIO(data)).mode == "L"
                      else "palette")
    idx = rng.integers(0, 32, (h, w))
    pal = rng.integers(0, 256, (32, 3))
    if case == "local_offset_transparent":
        return W.gif(idx, (w + 5, h + 3), (3, 2), global_palette=pal[::-1],
                     local_palette=pal, transparency=7), "palette"
    if case == "interlaced_beyond_screen":
        return W.gif(idx, (w - 2, h), (1, 0), global_palette=pal,
                     interlace=True), "palette"
    return W.gif(idx, (w, h), global_palette=None), "equal"  # no palette


GIF_CASES = ["pil_palette", "pil_interlaced", "pil_transparent", "pil_grey",
             "local_offset_transparent", "interlaced_beyond_screen",
             "no_palette"]


@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_matches_jax(tmp_path, case):
    data, kind = _gif_case(case, np.random.default_rng(len(case) + 5))
    _check(tmp_path, data, kind, ext=".gif")


PNM_CASES = {
    "P1": (b"P1", None, "grey1"), "P4": (b"P4", None, "grey1"),
    "P2_255": (b"P2", 255, "equal"), "P2_100": (b"P2", 100, "equal"),
    "P2_1000": (b"P2", 1000, "grey16"), "P3_255": (b"P3", 255, "equal"),
    "P3_7": (b"P3", 7, "equal"), "P5_255": (b"P5", 255, "equal"),
    "P5_200": (b"P5", 200, "equal"), "P5_65535": (b"P5", 65535, "grey16"),
    "P5_4095": (b"P5", 4095, "grey16"), "P6_255": (b"P6", 255, "equal"),
    "P6_31": (b"P6", 31, "equal"), "P6_65535": (b"P6", 65535, "equal"),
}


@pytest.mark.parametrize("case", list(PNM_CASES))
def test_pnm_matches_jax(tmp_path, case):
    magic, maxval, kind = PNM_CASES[case]
    rng = np.random.default_rng(len(case))
    shape = (6, 10, 3) if magic in (b"P3", b"P6") else (6, 10)
    v = rng.integers(0, (maxval or 1) + 1, shape)
    port = _check(tmp_path, W.pnm(magic, v, maxval), kind, ext=".pnm")
    assert port.shape == shape


def test_port_reads_files_pil_refuses():
    """The port follows the formats where PIL's readers stop: TGA RLE
    packets that cross scanlines and a 32-bit colour map; a JPEG whose EOI
    is missing after its last scan."""
    from gfxexp_torch.utils import image_formats as fmt
    from gfxexp_torch.utils.jpeg import decode_jpeg

    rng = np.random.default_rng(11)
    pix = rng.integers(0, 256, (3, 4, 3), np.uint8)
    pix[1, 2:] = pix[2, :2] = pix[1, 1]  # a run across two rows
    flat = pix.reshape(-1, 3)
    body = bytes([5]) + flat[:6].tobytes() + bytes([0x83]) + \
        flat[6].tobytes() + bytes([1]) + flat[10:].tobytes()
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, 4, 3, 24,
                       0x20)
    np.testing.assert_array_equal(fmt.decode_tga(head + body),
                                  pix[:, :, ::-1])
    cmap = rng.integers(0, 256, (8, 4), np.uint8)
    idx = rng.integers(0, 8, (2, 5), np.uint8)
    data = W.tga(idx[:, :, None], 1, 8, 0x20, cmap, 32)
    np.testing.assert_array_equal(fmt.decode_tga(data),
                                  cmap[idx][:, :, [2, 1, 0, 3]])
    a = _photo(16, 16, 3, 4)
    whole = W.jpeg([a[..., i] for i in range(3)], [(2, 2), (1, 1), (1, 1)])
    np.testing.assert_array_equal(decode_jpeg(whole[:-2]),
                                  decode_jpeg(whole))


def test_bmp_rle_escapes_follow_the_format():
    """A delta escape skips right and up (index 0 there) and an odd RLE4
    absolute run keeps its last pixel: PIL's decoder reads a delta's
    offsets twice and drops that pixel, so JAX differs on such files."""
    from gfxexp_torch.utils import image_formats as fmt

    pal = [(0, 0, 0), (255, 0, 0), (0, 255, 0), (0, 0, 255)]
    # 4x2, bottom row first: four 1s, end of line; delta (2, 0), two 3s
    rle8 = b"\x04\x01\x00\x00\x00\x02\x02\x00\x02\x03\x00\x01"
    got = fmt.decode_bmp(W.bmp(rle8, 8, 4, 2, pal, 1))
    np.testing.assert_array_equal(
        got, np.asarray(pal, np.uint8)[np.array([[0, 0, 3, 3],
                                                 [1, 1, 1, 1]])])
    # 3x1: an absolute run of three pixels, 1 2 3, padded to a word
    rle4 = b"\x00\x03\x12\x30\x00\x01"
    got = fmt.decode_bmp(W.bmp(rle4, 4, 3, 1, pal, 2))
    np.testing.assert_array_equal(got, np.asarray(pal, np.uint8)[[[1, 2,
                                                                   3]]])


@pytest.mark.parametrize("fmt", ["TIFF", "WebP"])
def test_unported_format_raises_naming_it(tmp_path, fmt):
    from PIL import Image

    im = Image.fromarray(np.zeros((4, 4, 3), np.uint8))
    path = str(tmp_path / "image.png")  # the name does not decide
    im.save(path, fmt)
    assert jio.load_png(path).shape == (4, 4, 3)
    with pytest.raises(NotImplementedError, match=fmt):
        tio.load_png(path)


def test_signature_decides_not_the_name(tmp_path):
    from PIL import Image

    a = _photo(16, 16, 3, 1)
    path = str(tmp_path / "texture.png")
    Image.fromarray(a).save(path, "JPEG")
    np.testing.assert_array_equal(tio.load_png(path), jio.load_png(path))
    with open(path, "rb") as f:
        np.testing.assert_array_equal(tio.decode_image(f.read(), False),
                                      jio.load_png(path, False))


# ---------------------------------------------------------------------------
# the loaders, the tfdm app, save_png
# ---------------------------------------------------------------------------


def _atlases_equal(jb, tb):
    assert len(jb.atlas.images) == len(tb.atlas.images) >= 1
    for a, b in zip(jb.atlas.images, tb.atlas.images):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_obj_with_jpeg_map_matches_jax(tmp_path):
    from PIL import Image

    paths = bench.write_mesh_files(str(tmp_path))
    Image.fromarray(_photo(24, 32, 3, 2)).save(
        str(tmp_path / "kd.jpg"), quality=80, subsampling=2)
    with open(paths["mtl"]) as f:
        mtl = f.read().replace(os.path.basename(paths["png"]), "kd.jpg")
    with open(paths["mtl"], "w") as f:
        f.write(mtl)
    jb, tb = JB.SceneBuilder(), TB.SceneBuilder()
    assert JL.load_mesh(paths["obj"], jb) == TL.load_mesh(paths["obj"], tb)
    assert tb.materials[0].diffuse_tex == 0
    _atlases_equal(jb, tb)


def test_glb_with_embedded_jpeg_matches_jax(tmp_path):
    from PIL import Image

    t = bench.torus_mesh(8, 6)
    pos, nrm, uv = t[0], t[1], t[2]
    quads = t[4]
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    doc, data = bench._gltf_doc(pos, nrm, uv, tris)
    buf = io.BytesIO()
    Image.fromarray(_photo(20, 28, 3, 3)).save(buf, "JPEG", progressive=True)
    jpg = buf.getvalue()
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(data),
                               "byteLength": len(jpg)})
    data += jpg + b"\0" * ((-len(jpg)) % 4)
    doc["buffers"][0]["byteLength"] = len(data)
    doc["images"] = [{"bufferView": len(doc["bufferViews"]) - 1,
                      "mimeType": "image/jpeg"}]
    doc["textures"] = [{"source": 0}]
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
        "index": 0}
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    path = str(tmp_path / "jpeg.glb")
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            12 + 8 + len(js) + 8 + len(data)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(data), 0x004E4942) + data)
    jb, tb = JB.SceneBuilder(), TB.SceneBuilder()
    assert JL.load_mesh(path, jb) == TL.load_mesh(path, tb)
    assert tb.materials[0].diffuse_tex == 0
    _atlases_equal(jb, tb)


def test_tfdm_reads_lossless_jpeg_height_map(tmp_path):
    """The lossless grey fixture as -height-map: the samples / 255, as
    JAX's load_png reads them, cut to 64x64, and a frame renders."""
    from gfxexp_torch.apps import tfdm as tfdm_app

    path = os.path.join(FIXTURES, "height_64_lossless.jpg")
    with open(path, "rb") as f:
        samples = tio.decode_samples(f.read(), path)
    height = tfdm_app.load_or_procedural_height(types.SimpleNamespace(
        height_map=path, height_kind="ridges"))
    np.testing.assert_array_equal(height, samples.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(height, jio.load_png(path, False))
    hdr = tfdm_app.main(["-device", "cpu", "-width", "16", "-height", "16",
                         "-frames", "1", "-base-res", "3", "-height-map",
                         path, "-output", str(tmp_path / "tfdm")])
    assert hdr.shape == (16, 16, 3) and np.isfinite(hdr).all()
    assert hdr.mean() > 0


def test_tfdm_reads_16bit_height_map(tmp_path):
    from gfxexp_torch.apps import tfdm as tfdm_app

    rng = np.random.default_rng(9)
    y, x = np.mgrid[0:20, 0:20]
    v = (32768 + 20000 * np.sin(x / 3.0) * np.cos(y / 4.0)
         + rng.integers(0, 200, (20, 20))).astype(np.uint16)
    path = str(tmp_path / "height16.png")
    with open(path, "wb") as f:
        f.write(W.png(v, 16, 0))
    height = tfdm_app.load_or_procedural_height(types.SimpleNamespace(
        height_map=path, height_kind="ridges"))
    # full precision: the samples / 65535, cut to 16x16; JAX's load_png
    # holds the same samples / 255
    np.testing.assert_array_equal(height, (v[:16, :16].astype(np.float32)
                                           / 65535.0))
    np.testing.assert_array_equal(np.rint(height * 65535.0),
                                  np.rint(jio.load_png(path, False)[:16, :16]
                                          * 255.0))
    hdr = tfdm_app.main(["-device", "cpu", "-width", "16", "-height", "16",
                         "-frames", "1", "-base-res", "3", "-height-map",
                         path, "-output", str(tmp_path / "tfdm")])
    assert hdr.shape == (16, 16, 3) and np.isfinite(hdr).all()
    assert hdr.mean() > 0


SAVE_CASES = {"grey": (9, 7), "grey_alpha": (9, 7, 2), "rgb": (9, 7, 3),
              "rgba": (9, 7, 4), "rgb_uint8": (9, 7, 3),
              "grey_uint8": (9, 7)}


@pytest.mark.parametrize("case", list(SAVE_CASES))
@pytest.mark.parametrize("apply_srgb", [True, False])
def test_save_png_matches_jax(tmp_path, case, apply_srgb):
    rng = np.random.default_rng(len(case))
    shape = SAVE_CASES[case]
    if case.endswith("uint8"):
        img = rng.integers(0, 256, shape, np.uint8)
    else:
        img = rng.random(shape) * 1.2 - 0.1  # float64, outside [0, 1] too
        img[0, 0] = 0.5 / 255.0  # a value at a rounding edge
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    tio.save_png(a, img, apply_srgb)
    jio.save_png(b, img, apply_srgb)
    for to_linear in (False, True):
        np.testing.assert_array_equal(jio.load_png(a, to_linear),
                                      jio.load_png(b, to_linear))
        np.testing.assert_array_equal(tio.load_png(a, to_linear),
                                      jio.load_png(b, to_linear))
    with open(a, "rb") as f:
        assert f.read() == tio.encode_png(img, apply_srgb)


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------


def _fixtures():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_fixtures()))
def test_fixture_digest_matches_port_and_jax(name):
    rec = _fixtures()[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        px = tio.decode_samples(f.read(), name)
    assert str(px.dtype) == rec["dtype"] and list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    # JAX's load_png: PIL's samples / 255
    jax = jio.load_png(path, False)
    np.testing.assert_array_equal(np.rint(jax * 255.0),
                                  px.astype(np.float64))


def test_fixtures_stay_small():
    total = sum(os.path.getsize(os.path.join(FIXTURES, n))
                for n in os.listdir(FIXTURES))
    assert total < 200_000, total


# chip_smoke.py phase 36's files in place of the textured scene's PNG and
# DDS files
SCENE_TEXTURES = {"normal": "normal_64_rgb16_adam7.png",
                  "bc1": "photo_512_progressive420.jpg",
                  "bc7": "albedo_64_rle.tga"}


def test_textured_scene_with_fixture_textures_matches_jax(tmp_path):
    import torch

    from gfxexp_torch.render.pathtrace import PTConfig, render_sample
    from gfxexp_torch.scene.compile import compile_scene

    files = {k: os.path.join(FIXTURES, v) for k, v in SCENE_TEXTURES.items()}
    jb = bench.textured_scene_builder(JB.SceneBuilder(texture_mips=True),
                                      str(tmp_path / "j"), files=files)
    tb = bench.textured_scene_builder(TB.SceneBuilder(texture_mips=True),
                                      str(tmp_path / "t"), files=files)
    _atlases_equal(jb, tb)
    assert any(np.asarray(im).shape[:2] == (512, 512)
               for im in tb.atlas.images)
    scene, bvh = compile_scene(tb, traversal="widerow")
    img = render_sample(scene, bvh, bench.textured_camera(8, 8), 8, 8, 0,
                        PTConfig())
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
