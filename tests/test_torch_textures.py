"""The port's textures (scene/textures.py, scene/bc67.py), image I/O
(utils/image_io.py), probability texture (core/distributions.py), solid-angle
and probability-texture light sampling (scene/lights.py) and textured
material parameters (render/bsdf.py) against gfxexp_tpu's on the same
inputs, made from numpy seeds; then the G-buffer, a ReSTIR frame and an NRC
frame on the textured scene (gfxexp_torch.bench.textured_scene_builder,
whose texture files the scene builder writes: a PNG and two DDS files).

Bars: the atlas layers and mip chain, every BC decode, load_dds and the
probability texture's levels bit-equal; load_png equal to PIL's reader
(gfxexp_tpu's load_png) on 8-bit grey, grey + alpha, RGB and RGBA files,
and to PIL's RGB / RGBA conversion on palette files (JAX's reader hands
back palette indices; every other format and depth is in
tests/test_torch_image_formats.py); load_dds raising ValueError in both
packages on a DDS that is not BC1-7; the EXR codec round trip exact (float) and equal
across the packages; samplers, normal readers and bump within 1e-6;
probability-texture draws equal in texel, pmf and remapped uniforms within
1e-6; solid-angle light samples as that test states; the textured G-buffer's
albedo within 1e-6 plus 1024 times its texcoord's difference (a texel is
1/512 of uv, so the texcoord's rounding, up to ~1e-5 from XLA's fused
multiply-adds, moves a 1-texel checker by up to a step), ReSTIR and
NRC images within the bars of tests/test_torch_{restir,nrc}.py (1e-3 and
2e-3).
"""

import dataclasses
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

import gfxexp_torch.scene.builder as TB  # noqa: E402
import gfxexp_tpu.scene.builder as JB  # noqa: E402
from gfxexp_torch import bench  # noqa: E402
from gfxexp_torch.core import distributions as td  # noqa: E402
from gfxexp_torch.render import bsdf as tbsdf  # noqa: E402
from gfxexp_torch.render import camera as tcam  # noqa: E402
from gfxexp_torch.scene import bc67 as tbc  # noqa: E402
from gfxexp_torch.scene import lights as tl  # noqa: E402
from gfxexp_torch.scene import textures as tt  # noqa: E402
from gfxexp_torch.scene.compile import compile_scene as tcompile  # noqa: E402
from gfxexp_torch.core.tensors import TensorData  # noqa: E402
from gfxexp_torch.scene.types import from_numpy  # noqa: E402
from gfxexp_torch.utils import image_io as tio  # noqa: E402
from gfxexp_tpu.core import distributions as jd  # noqa: E402
from gfxexp_tpu.render import bsdf as jbsdf  # noqa: E402
from gfxexp_tpu.render import camera as jcam  # noqa: E402
from gfxexp_tpu.scene import bc67 as jbc  # noqa: E402
from gfxexp_tpu.scene import lights as jl  # noqa: E402
from gfxexp_tpu.scene import textures as jt  # noqa: E402
from gfxexp_tpu.scene.compile import compile_scene as jcompile  # noqa: E402
from gfxexp_tpu.utils import image_io as jio  # noqa: E402

torch.set_num_threads(2)
TEX_CAMERA = dict(position=[0.0, 1.6, 3.0], fov_y=np.deg2rad(45),
                  aspect=1.0, target=[0.0, 0.3, 0.0])
RES = 16


def _np(x):
    return np.asarray(x)


def _images(rng):
    """Images of every shape AtlasBuilder takes: grey 2D, 1-4 channels,
    smaller, larger and equal to the layer size."""
    return [rng.random((20, 12)), rng.random((32, 32, 1)),
            rng.random((7, 9, 2)), rng.random((40, 33, 3)),
            rng.random((32, 32, 4))]


def _atlases(mips, seed=0):
    rng = np.random.default_rng(seed)
    jb, tb = jt.AtlasBuilder(size=32, mips=mips), tt.AtlasBuilder(
        size=32, mips=mips)
    for img in _images(rng):
        assert jb.add(img) == tb.add(img)
    return jb.build(), tb.build()


@pytest.mark.parametrize("mips", [False, True])
def test_atlas_and_mips_bit_equal(mips):
    ja, ta = _atlases(mips)
    assert ta.count == ja.count == 5
    np.testing.assert_array_equal(ta.layers.numpy(), _np(ja.layers))
    if mips:
        assert ta.n_levels == ja.n_levels == 6
        np.testing.assert_array_equal(ta.mip_flat.numpy(), _np(ja.mip_flat))
        np.testing.assert_array_equal(ta.mip_offsets.numpy(),
                                      _np(ja.mip_offsets))
    else:
        assert ta.mip_flat is None and ja.mip_flat is None
    carried = from_numpy(ja)
    assert isinstance(carried, tt.TextureAtlas) and carried.count == 5
    assert torch.equal(carried.layers, ta.layers)


def _lookups(rng, n=4096, count=5):
    tid = rng.integers(-1, count, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    return tid, uv


def test_sample_bilinear_matches_jax():
    ja, ta = _atlases(False)
    tid, uv = _lookups(np.random.default_rng(1))
    a = tt.sample_bilinear(ta, torch.from_numpy(tid), torch.from_numpy(uv))
    b = jt.sample_bilinear(ja, jnp.asarray(tid), jnp.asarray(uv))
    np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-6)


def test_sample_trilinear_matches_jax():
    ja, ta = _atlases(True)
    rng = np.random.default_rng(2)
    tid, uv = _lookups(rng)
    lod = rng.uniform(-1.0, 7.0, tid.shape).astype(np.float32)
    a = tt.sample_trilinear(ta, torch.from_numpy(tid), torch.from_numpy(uv),
                            torch.from_numpy(lod))
    b = jt.sample_trilinear(ja, jnp.asarray(tid), jnp.asarray(uv),
                            jnp.asarray(lod))
    np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-6)
    # an atlas without mips samples bilinearly
    _, flat = _atlases(False)
    assert torch.equal(
        tt.sample_trilinear(flat, torch.from_numpy(tid), torch.from_numpy(uv),
                            torch.from_numpy(lod)),
        tt.sample_bilinear(flat, torch.from_numpy(tid), torch.from_numpy(uv)))


def test_atlas_on_another_device_is_an_error():
    _, ta = _atlases(False)
    uv = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="atlas"):
        tt.sample_bilinear(ta, torch.zeros(4, dtype=torch.int32,
                                           device="meta"), uv)


def test_normal_readers_and_bump_match_jax():
    rng = np.random.default_rng(3)
    n = 2048
    texel = rng.random((n, 4)).astype(np.float32)
    for two in (False, True):
        np.testing.assert_allclose(
            tt.decode_normal_map(torch.from_numpy(texel), two).numpy(),
            _np(jt.decode_normal_map(jnp.asarray(texel), two)), atol=1e-6)
    ja, ta = _atlases(False)
    tid, uv = _lookups(rng, n)
    for scale in (1.0, 0.25):
        np.testing.assert_allclose(
            tt.normal_from_height_map(ta, torch.from_numpy(tid),
                                      torch.from_numpy(uv), scale).numpy(),
            _np(jt.normal_from_height_map(ja, jnp.asarray(tid),
                                          jnp.asarray(uv), scale)),
            atol=1e-6)
    frame = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(
        tt.apply_bump(*map(torch.from_numpy, frame)).numpy(),
        _np(jt.apply_bump(*map(jnp.asarray, frame))), atol=1e-6)


BC_SIZES = {"BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC5": 16}


@pytest.mark.parametrize("fmt", list(BC_SIZES))
def test_bc1_to_bc5_decode_bit_equal(fmt):
    rng = np.random.default_rng(4)
    w, h = 13, 10  # 4 x 3 blocks, cropped
    data = rng.integers(0, 256, 12 * BC_SIZES[fmt], np.uint8).tobytes()
    a = tt._decode_bc(b"\x00" * 7 + data, 7, w, h, fmt)
    b = jt._decode_bc(b"\x00" * 7 + data, 7, w, h, fmt)
    assert a.shape == b.shape == (h, w, {"BC4": 1, "BC5": 2}.get(fmt, 4))
    np.testing.assert_array_equal(a, b)
    blocks8 = rng.integers(0, 256, (64, 8), np.uint8)
    np.testing.assert_array_equal(tt._decode_bc4_channel(blocks8),
                                  jt._decode_bc4_channel(blocks8))


@pytest.mark.parametrize("fmt", ["BC6H", "BC7"])
def test_bc6h_and_bc7_decode_bit_equal(fmt):
    rng = np.random.default_rng(5)
    w, h = 16, 12
    data = rng.integers(0, 256, 12 * 16, np.uint8).tobytes()
    if fmt == "BC7":
        a, b = tbc.decode_bc7(data, 0, w, h), jbc.decode_bc7(data, 0, w, h)
    else:
        a, b = (tbc.decode_bc6h(data, 0, w, h),
                jbc.decode_bc6h(data, 0, w, h))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


DDS_FILES = {"DXT1": (b"DXT1", None, 8), "DXT3": (b"DXT3", None, 16),
             "DXT5": (b"DXT5", None, 16), "ATI1": (b"ATI1", None, 8),
             "ATI2": (b"ATI2", None, 16), "BC6H": (None, 95, 16),
             "BC7": (None, 98, 16)}


@pytest.mark.parametrize("name", list(DDS_FILES))
def test_load_dds_bit_equal(tmp_path, name):
    fourcc, dxgi, block = DDS_FILES[name]
    rng = np.random.default_rng(6)
    w, h = 10, 7
    path = str(tmp_path / f"{name}.dds")
    bench._write_dds(path, rng.integers(0, 256, 3 * 2 * block,
                                        np.uint8).tobytes(), w, h,
                     fourcc=fourcc, dxgi=dxgi)
    a, b = tt.load_dds(path), jt.load_dds(path)
    assert a.shape[:2] == (h, w)
    np.testing.assert_array_equal(a, b)


def test_load_dds_raises_for_other_formats(tmp_path):
    """Both packages raise ValueError on a DDS that is not BC1-7."""
    path = str(tmp_path / "rgba.dds")
    bench._write_dds(path, b"\x00" * 64, 4, 4, fourcc=b"RGBA")
    with pytest.raises(ValueError) as jax_err:
        jt.load_dds(path)
    with pytest.raises(ValueError) as port_err:
        tt.load_dds(path)
    assert type(port_err.value) is type(jax_err.value)


def _png_filtered(path, px):
    """An 8-bit PNG of px [H, W, C] with scanline filters 0-4 in turn."""
    h, w, c = px.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = px.reshape(h, w * c).astype(np.int32)
    raw = b""
    prior = np.zeros(w * c, np.int32)
    for y in range(h):
        ft = y % 5
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(
                p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, up_left))
        raw += bytes([ft]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
        prior = cur
    tio_chunk = tio._chunk
    data = (b"\x89PNG\r\n\x1a\n"
            + tio_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                             0))
            + tio_chunk(b"IDAT", zlib.compress(raw))
            + tio_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "PA"])
def test_load_png_matches_pil(tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(7)
    chans = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 3, "PA": 3}[mode]
    px = rng.integers(0, 256, (11, 13, chans), np.uint8)
    px[1::3] = px[0]  # repeated rows give the encoder's filters work
    path = str(tmp_path / "pil.png")
    if mode in ("P", "PA"):
        im = Image.fromarray(px).quantize(colors=200)
        kw = {"transparency": bytes(range(0, 250, 5))} if mode == "PA" else {}
        im.save(path, **kw)
        want = np.asarray(Image.open(path).convert(
            "RGBA" if mode == "PA" else "RGB")).astype(np.float32) / 255.0
        np.testing.assert_array_equal(tio.load_png(path, False), want)
        return
    Image.fromarray(px[:, :, 0] if chans == 1 else px, mode).save(
        path, optimize=True)
    filtered = str(tmp_path / "filtered.png")
    _png_filtered(filtered, px)
    for to_linear in (False, True):
        want = jio.load_png(path, to_linear)
        np.testing.assert_array_equal(tio.load_png(path, to_linear), want)
        np.testing.assert_array_equal(tio.load_png(filtered, to_linear), want)
        np.testing.assert_array_equal(jio.load_png(filtered, to_linear), want)


def test_load_png_of_save_png(tmp_path):
    rng = np.random.default_rng(8)
    img = rng.random((9, 14, 3)).astype(np.float32)
    path = str(tmp_path / "port.png")
    tio.save_png(path, img)
    for to_linear in (False, True):
        np.testing.assert_array_equal(tio.load_png(path, to_linear),
                                      jio.load_png(path, to_linear))
    # sRGB out and back in: within half an 8-bit step of the linear input
    np.testing.assert_allclose(tio.load_png(path), img, atol=5e-3)


@pytest.mark.parametrize("half", [False, True])
def test_exr_round_trip(tmp_path, half):
    rng = np.random.default_rng(9)
    img = (rng.random((37, 21, 4)) * 50).astype(np.float32)
    img[5:9] = 1.0  # compressible blocks
    a, b = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    tio.save_exr(a, img, half=half)
    jio.save_exr(b, img, half=half)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got = tio.load_exr(a)
    np.testing.assert_array_equal(got, jio.load_exr(a))
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(got, want)


def test_probability_texture_matches_jax():
    rng = np.random.default_rng(10)
    w = rng.random((16, 16)) ** 3
    w[3, :] = 0.0
    jpt, tpt = jd.build_probability_texture(w), td.build_probability_texture(w)
    assert (tpt.size, tpt.n_levels) == (jpt.size, jpt.n_levels) == (16, 5)
    np.testing.assert_array_equal(tpt.levels.numpy(), _np(jpt.levels))
    assert float(tpt.integral) == float(jpt.integral)
    u0, u1 = rng.random((2, 8192)).astype(np.float32)
    a = td.sample_probability_texture(tpt, torch.from_numpy(u0),
                                      torch.from_numpy(u1))
    b = jd.sample_probability_texture(jpt, jnp.asarray(u0), jnp.asarray(u1))
    np.testing.assert_array_equal(a[0].numpy(), _np(b[0]))
    np.testing.assert_array_equal(a[1].numpy(), _np(b[1]))
    for x, y in zip(a[2:], b[2:]):
        np.testing.assert_allclose(x.numpy(), _np(y), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        td.probability_texture_pmf(tpt, a[0], a[1]).numpy(),
        _np(jd.probability_texture_pmf(jpt, b[0], b[1])), atol=1e-7)
    assert not (a[1] == 3).any()  # a row of weight 0 is never drawn
    carried = from_numpy(jpt)
    assert carried.n_levels == 5 and torch.equal(carried.levels, tpt.levels)


@pytest.fixture(scope="module")
def lights():
    """The 64-emitter scene both ways with the probability texture, and
    random shading points above its floor."""
    js, jb = jcompile(S.many_light_scene(JB, 64), use_probability_texture=True)
    ts, tb = tcompile(S.many_light_scene(TB, 64), use_probability_texture=True)
    rng = np.random.default_rng(11)
    n = 4096
    pts = np.stack([rng.uniform(-5, 5, n), rng.uniform(0.05, 1.5, n),
                    rng.uniform(-5, 5, n)], -1).astype(np.float32)
    us = rng.random((3, n)).astype(np.float32)
    return js, ts, pts, us


def test_probability_texture_light_selection_matches_jax(lights):
    js, ts, _, us = lights
    assert ts.light_unit_probtex is not None
    np.testing.assert_array_equal(ts.light_unit_probtex.levels.numpy(),
                                  _np(js.light_unit_probtex.levels))
    u_sel, u0, u1 = us
    a = tl._select_emissive_triangle(ts, torch.from_numpy(u_sel),
                                     torch.from_numpy(u0))
    b = jl._select_emissive_triangle(js, jnp.asarray(u_sel), jnp.asarray(u0))
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x.numpy(), _np(y))
    for x, y in zip(a[2:], b[2:]):
        np.testing.assert_allclose(x.numpy(), _np(y), atol=1e-6)
    # a packed surface sample takes the remapped uniform
    ls_t = tl.sample_surface_light(ts, *map(torch.from_numpy, us),
                                   tl.pack_light_rows(ts))
    ls_j = jl.sample_surface_light(js, *map(jnp.asarray, us),
                                   packed=jl.pack_light_rows(js))
    np.testing.assert_allclose(ls_t.position.numpy(), _np(ls_j.position),
                               atol=1e-5)
    np.testing.assert_allclose(ls_t.pdf.numpy(), _np(ls_j.pdf), rtol=1e-5)


def _double(x):
    """A port container with its float32 tensors in float64."""
    if isinstance(x, TensorData):
        return dataclasses.replace(x, **{
            f.name: _double(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.double()
    return x


@pytest.mark.parametrize("env", [False, True])
def test_solid_angle_light_samples_match_jax(lights, env):
    """Arvo's construction subtracts nearly equal angles when a 0.15
    emitter is seen from metres away, so float32 samples of either package
    sit about 9e-4 (mean) from a float64 evaluation of the same function:
    the port must be no further from it than JAX (1.25x), equal to JAX in
    the light it selects, and near JAX in the median sample."""
    js, ts, pts, us = lights
    if env:
        b = S.many_light_scene(JB, 64)
        b.set_environment(np.full((8, 16, 3), 0.5, np.float32))
        js, _ = jcompile(b)
        b = S.many_light_scene(TB, 64)
        b.set_environment(np.full((8, 16, 3), 0.5, np.float32))
        ts, _ = tcompile(b)
    tp, tu = torch.from_numpy(pts), [torch.from_numpy(u) for u in us]
    a = tl.sample_light_solid_angle(ts, tp, *tu)
    ref = tl.sample_light_solid_angle(_double(ts), tp.double(),
                                      *[u.double() for u in tu])
    b = jl.sample_light_solid_angle(js, jnp.asarray(pts),
                                    *map(jnp.asarray, us))
    inf = _np(b.at_infinity)
    np.testing.assert_array_equal(a.at_infinity.numpy(), inf)
    np.testing.assert_array_equal(a.emittance.numpy(), _np(b.emittance))
    np.testing.assert_array_equal(a.pdf.numpy() > 0, _np(b.pdf) > 0)
    surf = ~inf
    assert surf.sum() > 2000 and (a.pdf.numpy()[surf] > 0).all()
    pos = {"port": a.position.numpy()[surf],
           "jax": _np(b.position)[surf]}
    want = ref.position.numpy()[surf]
    err = {k: np.abs(v - want).max(-1).mean() for k, v in pos.items()}
    assert err["port"] <= 1.25 * err["jax"], err
    rpdf = ref.pdf.numpy()[surf]
    perr = {k: (np.abs(v - rpdf) / rpdf).mean() for k, v in (
        ("port", a.pdf.numpy()[surf]), ("jax", _np(b.pdf)[surf]))}
    assert perr["port"] <= 1.25 * perr["jax"], perr
    # measured: median 1.4e-4 in position, 1.4e-3 relative in pdf
    assert np.median(np.abs(pos["port"] - pos["jax"]).max(-1)) < 5e-4
    assert np.median(np.abs(a.pdf.numpy()[surf] - _np(b.pdf)[surf])
                     / _np(b.pdf)[surf]) < 5e-3
    # the sample lies on the emitters' plane (y = 2)
    assert np.abs(pos["port"][:, 1] - 2.0).max() < 1e-4
    if env:
        np.testing.assert_allclose(a.position.numpy()[inf],
                                   _np(b.position)[inf], atol=1e-5)


@pytest.mark.parametrize("lod", [False, True])
def test_material_params_textured_matches_jax(lod):
    ja, ta = _atlases(True)
    rng = np.random.default_rng(12)
    b = TB.SceneBuilder()
    jbld = JB.SceneBuilder()
    for bld, mod in ((b, TB), (jbld, JB)):
        for k in range(6):
            bld.add_material(mod.HostMaterial(
                diffuse_color=(0.1 * k, 0.5, 0.9), roughness=0.1 * k,
                diffuse_tex=k - 1))
        bld.add_instance(bld.add_rectangle(1.0, 1.0, 0))
    tmat = b.compile().materials
    jmat = jbld.compile().materials
    n = 4096
    mat = rng.integers(0, 6, n).astype(np.int32)
    uv = rng.uniform(-1, 2, (n, 2)).astype(np.float32)
    level = rng.uniform(0, 6, n).astype(np.float32) if lod else None
    a = tbsdf.material_params_textured(
        tmat, ta, torch.from_numpy(mat), torch.from_numpy(uv),
        None if level is None else torch.from_numpy(level))
    j = jbsdf.material_params_textured(
        jmat, ja, jnp.asarray(mat), jnp.asarray(uv),
        None if level is None else jnp.asarray(level))
    np.testing.assert_allclose(a.diffuse.numpy(), _np(j.diffuse), atol=1e-6)
    np.testing.assert_array_equal(a.roughness.numpy(), _np(j.roughness))
    const = mat == 0
    np.testing.assert_array_equal(a.diffuse.numpy()[const],
                                  np.tile([0.0, 0.5, 0.9], (const.sum(), 1))
                                  .astype(np.float32))


def test_builder_textures_and_cache(tmp_path):
    b = TB.SceneBuilder(texture_mips=True)
    bench.textured_scene_builder(b, str(tmp_path))
    n = len(b.atlas.images)
    png = str(tmp_path / "normal.png")
    assert b.load_texture(png, to_linear=False) == b.load_texture(
        png, to_linear=False)
    assert len(b.atlas.images) == n
    assert b.load_texture(png) == n  # another conversion is another layer
    scene, _ = tcompile(b)
    assert scene.textures.count == n + 1 and scene.textures.n_levels == 10
    moved = scene.to("meta")
    assert moved.textures.layers.device.type == "meta"
    assert moved.textures.mip_offsets.device.type == "meta"
    assert moved.textures.n_levels == 10


# ---------------------------------------------------------------------------
# the techniques on the textured scene
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tex"))
    ts, tb = tcompile(bench.textured_scene_builder(
        TB.SceneBuilder(texture_mips=True), d))
    js, jb = jcompile(bench.textured_scene_builder(
        JB.SceneBuilder(texture_mips=True), d))
    return dict(ts=ts, tb=tb, js=js, jb=jb, tc=tcam.make_camera(**TEX_CAMERA),
                jc=jcam.make_camera(**TEX_CAMERA))


def test_textured_gbuffer_matches_jax(textured):
    from gfxexp_torch.render.gbuffer import render_gbuffer as t_gbuffer
    from gfxexp_tpu.render.gbuffer import render_gbuffer as j_gbuffer

    s = textured
    a = t_gbuffer(s["ts"], s["tb"], s["tc"], s["tc"], RES, RES, 2, True)
    b = j_gbuffer(s["js"], s["jb"], s["jc"], s["jc"], RES, RES, jnp.uint32(2),
                  True)
    np.testing.assert_array_equal(a.hit.numpy(), _np(b.hit))
    np.testing.assert_array_equal(a.material.numpy(), _np(b.material))
    # a texel is 1/512 of uv and its values lie in [0, 1]: the albedo
    # moves by at most 2 x 512 times the texcoord's difference
    dtc = np.abs(a.texcoord.numpy() - _np(b.texcoord)).max(-1)
    assert np.median(dtc) < 1e-6
    dalb = np.abs(a.albedo.numpy() - _np(b.albedo)).max(-1)
    assert (dalb <= 1e-6 + 1024 * dtc).all(), (dalb.max(), dtc.max())
    np.testing.assert_allclose(a.emittance.numpy(), _np(b.emittance),
                               atol=1e-6)
    # the checker shows: the floor's albedo takes both of its values
    floor = a.material.numpy() == 0
    alb = a.albedo.numpy()[floor][:, 0]
    assert alb.min() < 0.3 and alb.max() > 0.6


def test_textured_restir_frame_matches_jax(textured):
    from gfxexp_torch.render.gbuffer import render_gbuffer as t_gbuffer
    from gfxexp_torch.techniques import restir_di as tr
    from gfxexp_tpu.render.gbuffer import render_gbuffer as j_gbuffer
    from gfxexp_tpu.techniques import restir_di as jr

    s = textured
    n = RES * RES
    small = dict(log2_num_candidates=2, num_spatial_passes=1,
                 num_spatial_neighbors=2)
    jcfg, tcfg = jr.ReSTIRConfig(**small), tr.ReSTIRConfig(**small)
    jgb = j_gbuffer(s["js"], s["jb"], s["jc"], s["jc"], RES, RES,
                    jnp.uint32(0), False)
    tgb = t_gbuffer(s["ts"], s["tb"], s["tc"], s["tc"], RES, RES, 0, False)

    def flat(gb):
        return [gb.hit.reshape(n), gb.position.reshape(n, 3),
                gb.normal.reshape(n, 3)]

    jcol, *_ = jr.restir_di_frame(
        s["js"], s["jb"], jgb, s["jc"], jr.empty_reservoir(n),
        jr.pixel_ctx(s["js"], jgb, s["jc"]), *flat(jgb), jnp.uint32(0), jcfg)
    tcol, *_ = tr.restir_di_frame(
        s["ts"], s["tb"], tgb, s["tc"], tr.empty_reservoir(n, "cpu"),
        tr.pixel_ctx(s["ts"], tgb, s["tc"]), *flat(tgb), 0, tcfg)
    assert torch.isfinite(tcol).all() and float(tcol.mean()) > 0
    assert S.image_rel_diff(tcol.numpy(), _np(jcol)) < 1e-3


def test_textured_nrc_frame_matches_jax(textured):
    from gfxexp_torch.core.tree import tree_map
    from gfxexp_torch.techniques.nrc import cache as tcache
    from gfxexp_torch.techniques.nrc import network as tn
    from gfxexp_tpu.techniques.nrc import cache as jcache
    from gfxexp_tpu.techniques.nrc import network as jn

    s = textured
    jcfg, tcfg = jn.NRCConfig(), tn.NRCConfig()
    import jax

    jst = jn.init_nrc(jax.random.PRNGKey(0), jcfg)
    ema = jax.tree_util.tree_map(np.asarray, jst["ema"])
    tema = tree_map(lambda x: torch.from_numpy(np.array(x)), ema)
    jic = jcache.NRCIntegratorConfig(train_stride=8)
    tic = tcache.NRCIntegratorConfig(train_stride=8)
    jr = jcache.render_sample_nrc(s["js"], s["jb"], s["jc"], ema,
                                  *jcache.scene_aabb(s["js"]), RES, RES,
                                  jnp.uint32(1), jic, jcfg)
    tr = tcache.render_sample_nrc(s["ts"], s["tb"], s["tc"], tema,
                                  *tcache.scene_aabb(s["ts"]), RES, RES, 1,
                                  tic, tcfg)
    assert np.isfinite(tr[0].numpy()).all()
    np.testing.assert_array_equal(tr[3].numpy(), _np(jr[3]))
    assert S.image_rel_diff(tr[0].numpy(), _np(jr[0])) < 2e-3


def test_build_mip_pyramid_bit_equal():
    rng = np.random.default_rng(13)
    img = rng.random((24, 10, 3)).astype(np.float32)
    a, b = tt.build_mip_pyramid(img), jt.build_mip_pyramid(img)
    assert len(a) == len(b) == 4 and a[-1].shape[:2] == (3, 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
