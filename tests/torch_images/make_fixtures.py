"""Write the image fixtures of this directory and their digests.

    python tests/torch_images/make_fixtures.py

Each fixture is written with PIL, or by writers.py where PIL cannot write
the variant (Adam7, 16-bit RGB, arithmetic coding, lossless JPEG, a
progressive JPEG cut after a scan), from seeded numpy data. digests.json records, for each, the sha256 of PIL's decode
(np.asarray(Image.open(path)).tobytes()), its dtype and shape: every
fixture is one whose PIL decode is not a palette, so the port's
decode_samples hands back the same array. tests/test_torch_image_formats.py
checks the digests against the port and the JAX package's load_png;
chip_smoke.py checks them on the card's machine, which has no PIL.
"""

import hashlib
import json
import os

import numpy as np
from PIL import Image

import writers as W

HERE = os.path.dirname(os.path.abspath(__file__))


def _texture(h, w, c, seed, noise=6.0):
    """A smooth, photo-like pattern with a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    chans = []
    for k in range(c):
        v = (128 + 70 * np.sin(x / (11 + 3 * k) + k)
             * np.cos(y / (17 + 2 * k)) + 40 * np.sin((x + y) / (29 + k)))
        chans.append(v)
    a = np.stack(chans, -1) + rng.normal(0, noise, (h, w, c))
    return np.clip(a, 0, 255).astype(np.uint8)


def write_all():
    files = {}

    def pil(name, im, fmt, **kw):
        im.save(os.path.join(HERE, name), fmt, **kw)
        files[name] = None

    def raw(name, data):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        files[name] = None

    # the timing image: 512^2, progressive, 4:2:0
    pil("photo_512_progressive420.jpg", Image.fromarray(
        _texture(512, 512, 3, 1, noise=9.0)), "JPEG", quality=70,
        subsampling=2, progressive=True)
    # the same file cut after its first AC scan (luma AC 1-5 at Al 2,
    # chroma DC only): libjpeg's block smoothing, both of its branches
    with open(os.path.join(HERE, "photo_512_progressive420.jpg"), "rb") as f:
        raw("photo_512_progressive420_cut2.jpg", W.jpeg_cut(f.read(), 2))
    pil("diffuse_64_baseline422_restart.jpg", Image.fromarray(
        _texture(64, 64, 3, 2)), "JPEG", quality=85, subsampling=1,
        restart_marker_blocks=4)
    pil("cmyk_32_adobe.jpg", Image.fromarray(_texture(32, 32, 4, 3),
                                             "CMYK"), "JPEG", quality=90)
    t = _texture(48, 40, 3, 4)
    raw("arith_48x40_progressive.jpg",
        W.jpeg([t[..., i] for i in range(3)], [(2, 2), (1, 1), (1, 1)],
               app=b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                   b"\x00\x00", sof=0xCA))
    # a tangent-space normal map, 16-bit RGB, Adam7
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    n = np.stack([0.5 * np.sin(8 * np.pi * xx), 0.5 * np.sin(6 * np.pi * yy),
                  np.ones_like(xx)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    raw("normal_64_rgb16_adam7.png",
        W.png(np.round((0.5 * n + 0.5) * 65535).astype(np.uint16), 16, 2,
              interlace=1))
    h16 = np.round((0.5 + 0.4 * np.sin(10 * np.pi * xx)
                    * np.sin(10 * np.pi * yy)) * 65535).astype(np.uint16)
    raw("height_64_grey16.png", W.png(h16, 16, 0))
    # an 8-bit lossless (SOF3) height map, predictor 7, a restart every 8
    # rows
    raw("height_64_lossless.jpg", W.jpeg_lossless(
        [(h16 >> 8).astype(np.uint8)], predictor=7, restart=8 * 64))
    pil("albedo_64_rle.tga", Image.fromarray(_texture(64, 64, 3, 5,
                                                      noise=0.0)),
        "TGA", rle=True)
    pil("albedo_64.bmp", Image.fromarray(_texture(64, 64, 3, 6)), "BMP")
    ramp = np.arange(256, dtype=np.uint8).reshape(-1, 1).repeat(3, 1)
    idx = _texture(40, 40, 1, 7, noise=0.0)[..., 0]
    raw("ramp_40.gif", W.gif(idx, (40, 40), global_palette=ramp))
    pil("rgb_24.ppm", Image.fromarray(_texture(24, 24, 3, 8)), "PPM")

    digests = {}
    for name in sorted(files):
        px = np.asarray(Image.open(os.path.join(HERE, name)))
        px = np.ascontiguousarray(px)
        digests[name] = {"sha256": hashlib.sha256(px.tobytes()).hexdigest(),
                         "dtype": str(px.dtype), "shape": list(px.shape)}
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return digests


if __name__ == "__main__":
    for name, rec in write_all().items():
        size = os.path.getsize(os.path.join(HERE, name))
        print(f"{name}: {size} bytes, {rec['dtype']} {rec['shape']}")
