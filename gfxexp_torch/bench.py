"""Path-tracing ray throughput of the port on one CUDA device.

The configurations are bench.py's (the JAX package's benchmark), procedural
branch (the teapot and bunny meshes are not in the repository, so spheres
stand in for them, as in bench.py): NEE+MIS path tracing with max path
length 5, 16 timed samples.

- the small scene: floor + area light + two spheres, at 512x512
  (render_accumulate) and at 1920x1080 (8 tiles of 259,200 lanes through
  render_tile_accumulate), traced through the wide-row table;
- `big`: a 6x6 grid of sphere pairs (74 instances) on a 4x4 floor, and
  `city`: a 16x16 grid (514 instances) on a 10x10 floor, compiled two-level
  (traversal="instanced") by default and rendered at 512x512. `rebraid<k>`
  opens the largest instances into about k entries per instance (k = 4 when
  omitted) and `tlas` routes the queries through the ray-sorted pass.

Format tokens, as bench.py takes them: `widerow` or `qrow` compile the
scene single-level (`big` and `city` flattened into world triangles:
chunked tables over 13,000 wide rows or 26,000 quantized rows),
`instanced` two-level; `a8` builds arity 8 (wide rows and two-level
tables). `persist` / `nopersist` set the one routing switch
(widerow.set_persistent): on, single-chunk wide-row tables take kernel 1
and two-level tables the nearest-first walk; off, every wide-row table
takes kernel 2 and two-level tables the build-order walk.

Mrays/s counts the closest-hit and shadow rays the integrator traced
(cfg.count_rays), divided by the wall time of the timed run fenced with
torch.cuda.synchronize().

    python -m gfxexp_torch.bench            # small scene, both sizes
    python -m gfxexp_torch.bench 512        # one size
    python -m gfxexp_torch.bench 1080p
    python -m gfxexp_torch.bench big        # 512x512
    python -m gfxexp_torch.bench city rebraid4 tlas
    python -m gfxexp_torch.bench big widerow
    python -m gfxexp_torch.bench city qrow
    python -m gfxexp_torch.bench 512 nopersist

Prints one JSON line of bench.py's shape: metric, value, unit, vs_baseline.
Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from gfxexp_torch.accel import instanced, lanegroup, widerow
from gfxexp_torch.render.camera import generate_rays_for_lanes, make_camera
from gfxexp_torch.render.pathtrace import (
    PTConfig,
    render_accumulate,
    render_tile_accumulate,
)
from gfxexp_torch.scene.builder import SceneBuilder, affine
from gfxexp_torch.scene.compile import compile_scene
from gfxexp_torch.utils import trace

MAX_PATH_LENGTH = 5
TIMED_SAMPLES = 16
TARGET_MRAYS = 100.0  # bench.py's north-star, Mrays/s per device
HD_TILES = 8
SIZES = {"512": (512, 512), "1080p": (1920, 1080)}
SCENES = ("small", "big", "city")
# per scene: floor side, instance grid (cells per side, 0 = one pair),
# camera position and target (bench.py:119-132, 205-219)
_LAYOUT = {
    "small": (2.0, 0, [0.0, 0.8, 1.6], [0.0, 0.2, 0.0]),
    "big": (4.0, 6, [0.0, 2.2, 3.4], [0.0, 0.1, 0.0]),
    "city": (10.0, 16, [0.0, 4.5, 8.0], [0.0, 0.1, 0.0]),
}


def bench_scene_builder(b=None, scene: str = "small"):
    """Populate a SceneBuilder (the port's by default) with bench.py's
    procedural scene: a floor, a light of emittance 300 facing down at
    y = 1.5 (0.3 x the floor's side), and diffuse-specular spheres (r 0.25)
    paired with Lambert spheres (r 0.2): one pair for "small", a 6x6 grid
    for "big", a 16x16 grid for "city". The spheres are two geometries
    shared by every instance. Any builder with the same API works, so tests
    can build the identical scene in the JAX package."""
    b = SceneBuilder() if b is None else b
    side, cells, _, _ = _LAYOUT[scene]
    floor = b.add_lambert_material((0.8, 0.8, 0.8))
    light = b.add_lambert_material((0.0, 0.0, 0.0),
                                   emittance=(300.0, 300.0, 300.0))
    b.add_instance(b.add_rectangle(side, side, floor))
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    b.add_instance(b.add_rectangle(0.6 * side / 2, 0.6 * side / 2, light),
                   affine(rotation=flip, translation=[0.0, 1.5, 0.0]))
    spheres = {}

    def sphere(key, radius, make_mat):
        if key not in spheres:
            spheres[key] = b.add_sphere(radius, make_mat())
        return spheres[key]

    def pair(tx, tz, bx):
        a = sphere("a", 0.25, lambda: b.add_diffuse_specular_material(
            (0.7, 0.4, 0.2), (0.2,) * 3, 0.7))
        b.add_instance(a, affine(translation=[tx, 0.25, tz]))
        s = sphere("b", 0.2, lambda: b.add_lambert_material((0.3, 0.6, 0.3)))
        b.add_instance(s, affine(translation=[bx, 0.2, tz]))

    if cells == 0:
        pair(-0.3, 0.0, 0.35)
    for gx in range(cells):
        for gz in range(cells):
            tx = (gx - (cells - 1) / 2) * 0.62
            tz = (gz - (cells - 1) / 2) * 0.62
            pair(tx, tz, tx + 0.28)
    return b


def build_bench_scene(scene: str = "small", rebraid: float = 0.0,
                      tlas: bool = False, traversal: str = None,
                      arity: int = 4):
    """(SceneData, acceleration structure) of a bench scene on the CPU, as
    bench.py builds it: by default a WideRowBVH for "small" and an
    InstancedAccel for "big" and "city"; `traversal` "widerow", "qrow" or
    "skip" compiles the scene single-level (flattened into world
    triangles), "instanced" two-level."""
    if traversal is None:
        traversal = "widerow" if scene == "small" else "instanced"
    b = bench_scene_builder(scene=scene)
    if traversal != "instanced":
        return compile_scene(b, arity=arity, max_leaf=4, traversal=traversal)
    s, acc = compile_scene(b, arity=arity, max_leaf=4, traversal="instanced",
                           rebraid=rebraid)
    acc.use_tlas = tlas
    return s, acc


def _write_dds(path: str, blocks: bytes, width: int, height: int,
               fourcc: bytes = None, dxgi: int = None):
    """A DDS file of BC blocks: a legacy FourCC header, or the DX10 header
    with a DXGI format."""
    import struct

    head = struct.pack("<IIIII", 0x20534444, 124, 0x1007, height, width)
    head += b"\x00" * (76 - len(head))
    head += struct.pack("<II4s", 32, 0x4, b"DX10" if dxgi else fourcc)
    head += b"\x00" * (128 - len(head))
    if dxgi:
        head += struct.pack("<IIIII", dxgi, 3, 0, 1, 0)
    with open(path, "wb") as f:
        f.write(head + blocks)


def textured_scene_builder(b, tex_dir: str, seed: int = 5,
                           files: dict = None):
    """Populate a fresh SceneBuilder (either package's: tests build the
    same scene in the JAX package) with the textured scene, writing its
    texture files into `tex_dir` first: a 4x4 floor with a checker of
    1-texel squares (at the atlas size, 512) and a 2-channel normal map;
    a sphere with a tangent-space normal map read from a PNG and a BC1
    diffuse texture, one with a height map and a BC7 diffuse texture (both
    DDS files of random blocks from `seed`); a 1x1 lamp facing down at
    y = 2 whose emission is a striped texture (emittance 40 and 10, the
    constant 25 weights it for NEE); a dim constant environment (0.1).
    `files` names other image files to load in place of the PNG and DDS
    files, by key: "normal" (the normal map), "bc1" and "bc7" (the
    spheres' diffuse textures)."""
    import importlib
    import os

    from gfxexp_torch.scene.textures import ATLAS_SIZE
    from gfxexp_torch.utils.image_io import save_png

    rng = np.random.default_rng(seed)
    s = ATLAS_SIZE
    os.makedirs(tex_dir, exist_ok=True)
    checker = (np.indices((s, s)).sum(0) % 2).astype(np.float32)
    checker = np.stack([0.2 + 0.6 * checker] * 3, axis=-1)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64.0
    ripple = np.stack([0.5 + 0.3 * np.sin(12 * np.pi * xx),
                       0.5 + 0.3 * np.cos(10 * np.pi * yy)], axis=-1)
    n = np.stack([0.6 * np.sin(8 * np.pi * xx), 0.6 * np.sin(6 * np.pi * yy),
                  np.ones_like(xx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal_png = os.path.join(tex_dir, "normal.png")
    save_png(normal_png, 0.5 * n + 0.5, apply_srgb=False)
    height = 0.5 + 0.5 * np.sin(10 * np.pi * xx) * np.sin(10 * np.pi * yy)
    bc1 = os.path.join(tex_dir, "bc1.dds")
    _write_dds(bc1, rng.integers(0, 256, 16 * 16 * 8, np.uint8).tobytes(),
               64, 64, fourcc=b"DXT1")
    bc7 = os.path.join(tex_dir, "bc7.dds")
    _write_dds(bc7, rng.integers(0, 256, 16 * 16 * 16, np.uint8).tobytes(),
               64, 64, dxgi=98)
    files = {"normal": normal_png, "bc1": bc1, "bc7": bc7, **(files or {})}
    stripes = np.where((np.arange(32) // 4) % 2 == 0, 40.0, 10.0)
    stripes = np.broadcast_to(stripes[None, :, None], (32, 32, 3))

    host_material = importlib.import_module(type(b).__module__).HostMaterial

    def material(**kw):
        return b.add_material(host_material(**kw))

    floor = material(diffuse_color=(1.0, 1.0, 1.0),
                     diffuse_tex=b.add_texture(checker),
                     normal_tex=b.add_texture(ripple), normal_map_kind=1)
    ball_a = material(diffuse_color=(1.0, 1.0, 1.0),
                      diffuse_tex=b.load_texture(files["bc1"]),
                      normal_tex=b.load_texture(files["normal"],
                                                to_linear=False),
                      normal_map_kind=0)
    ball_b = material(diffuse_color=(1.0, 1.0, 1.0),
                      diffuse_tex=b.load_texture(files["bc7"]),
                      normal_tex=b.add_texture(height), normal_map_kind=2)
    lamp = material(diffuse_color=(0.0, 0.0, 0.0),
                    emittance=(25.0, 25.0, 25.0),
                    emittance_tex=b.add_texture(stripes))
    b.add_instance(b.add_rectangle(4.0, 4.0, floor))
    b.add_instance(b.add_sphere(0.4, ball_a),
                   affine(translation=[-0.6, 0.4, 0.0]))
    b.add_instance(b.add_sphere(0.4, ball_b),
                   affine(translation=[0.6, 0.4, 0.0]))
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    b.add_instance(b.add_rectangle(1.0, 1.0, lamp),
                   affine(rotation=flip, translation=[0.0, 2.0, 0.0]))
    b.set_environment(np.full((8, 16, 3), 0.1, np.float32))
    return b


def torus_mesh(n_major: int = 24, n_minor: int = 12, major: float = 0.35,
               minor: float = 0.15):
    """A torus about +y: (positions [V, 3], normals, uvs [V, 2], colours
    [V, 3] uint8, quads [F, 4] of vertex ids), float32, on the host."""
    i, j = np.meshgrid(np.arange(n_major + 1), np.arange(n_minor + 1),
                       indexing="ij")
    u = i / n_major
    v = j / n_minor
    a, b = 2 * np.pi * u, 2 * np.pi * v
    ring = np.stack([np.cos(a), np.zeros_like(a), np.sin(a)], -1)
    nrm = np.cos(b)[..., None] * ring + np.sin(b)[..., None] * np.array(
        [0.0, 1.0, 0.0])
    pos = major * ring + minor * nrm
    colours = np.stack([255 * u, 255 * v, 128 + 0 * u], -1).astype(np.uint8)
    k = np.arange((n_major + 1) * (n_minor + 1)).reshape(n_major + 1,
                                                         n_minor + 1)
    quads = np.stack([k[:-1, :-1], k[:-1, 1:], k[1:, 1:], k[1:, :-1]],
                     -1).reshape(-1, 4)
    flat = (lambda x: x.reshape(-1, x.shape[-1]))
    return (flat(pos).astype(np.float32), flat(nrm).astype(np.float32),
            flat(np.stack([u, v], -1)).astype(np.float32), flat(colours),
            quads)


def _write_ply(path: str, pos, nrm, uv, colours, tris, ascii: bool):
    head = ["ply", "format " + ("ascii 1.0" if ascii
                                else "binary_little_endian 1.0"),
            "comment torus", f"element vertex {len(pos)}"]
    head += [f"property float {c}" for c in
             ("x", "y", "z", "nx", "ny", "nz", "u", "v")]
    head += [f"property uchar {c}" for c in ("red", "green", "blue")]
    head += [f"element face {len(tris)}",
             "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        if ascii:
            for p, n, t, c in zip(pos, nrm, uv, colours):
                f.write((" ".join(repr(float(x)) for x in (*p, *n, *t))
                         + " " + " ".join(str(int(x)) for x in c)
                         + "\n").encode("ascii"))
            for t in tris:
                f.write(("3 " + " ".join(str(int(x)) for x in t)
                         + "\n").encode("ascii"))
            return
        vert = np.zeros(len(pos), dtype=[("f", "<f4", 8), ("c", "u1", 3)])
        vert["f"] = np.concatenate([pos, nrm, uv], 1)
        vert["c"] = colours
        f.write(vert.tobytes())
        face = np.zeros(len(tris), dtype=[("k", "u1"), ("i", "<i4", 3)])
        face["k"] = 3
        face["i"] = tris
        f.write(face.tobytes())


def _gltf_doc(pos, nrm, uv, tris):
    """The glTF JSON of one mesh (and its binary buffer): positions,
    normals, uvs (v flipped, glTF's origin is top-left) and uint16
    indices, a pbrMetallicRoughness material, and three nodes: a TRS root
    with a matrix child, and a second root by matrix."""
    blobs = [pos.tobytes(), nrm.tobytes(),
             np.stack([uv[:, 0], 1.0 - uv[:, 1]], 1).astype(
                 np.float32).tobytes(),
             tris.astype(np.uint16).tobytes()]
    views, off = [], 0
    for blob in blobs:
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(blob)})
        off += len(blob) + (-len(blob)) % 4
    data = b"".join(blob + b"\0" * ((-len(blob)) % 4) for blob in blobs)
    n = len(pos)
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(data)}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": n,
             "type": "VEC3", "min": pos.min(0).tolist(),
             "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": n,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": n,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123,
             "count": int(tris.size), "type": "SCALAR"}],
        "materials": [{"name": "gold", "pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.7, 0.3, 1.0], "metallicFactor": 0.8,
            "roughnessFactor": 0.35}}],
        "meshes": [{"name": "torus", "primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "nodes": [
            {"mesh": 0, "translation": [0.9, 0.25, -0.2],
             "rotation": [0.0, 0.3826834, 0.0, 0.9238795],
             "scale": [0.8, 0.8, 0.8], "children": [1]},
            {"mesh": 0, "matrix": [0.5, 0, 0, 0, 0, 0.5, 0, 0, 0, 0, 0.5, 0,
                                   0.0, 0.45, 0.0, 1]},
            {"mesh": 0, "matrix": [0.7, 0, 0, 0, 0, 0, 0.7, 0, 0, -0.7, 0, 0,
                                   -0.9, 0.3, 0.3, 1]}],
        "scenes": [{"nodes": [0, 2]}], "scene": 0,
    }
    return doc, data


def write_mesh_files(out_dir: str) -> dict:
    """The mesh files the loaders' checks read, written into `out_dir`: a
    torus as an OBJ with two MTL materials (a diffuse map written as PNG,
    a specular one; quads, negative indices), as binary and ASCII PLY
    (normals, uvs, vertex colours), as GLB and as glTF JSON with a data-URI
    buffer (TRS and matrix nodes). Returns their paths by kind."""
    import base64
    import json
    import os
    import struct

    from gfxexp_torch.utils.image_io import save_png

    os.makedirs(out_dir, exist_ok=True)
    pos, nrm, uv, colours, quads = torus_mesh()
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    paths = {k: os.path.join(out_dir, f"torus.{k}")
             for k in ("obj", "mtl", "ply", "glb", "gltf")}
    paths["ply_ascii"] = os.path.join(out_dir, "torus_ascii.ply")
    paths["png"] = os.path.join(out_dir, "torus_kd.png")
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    save_png(paths["png"], np.stack([0.3 + 0.6 * (xx > 0.5), 0.4 + 0 * xx,
                                     0.3 + 0.6 * (yy > 0.5)], -1))
    with open(paths["mtl"], "w") as f:
        f.write("# two materials\nnewmtl body\nKd 0.8 0.6 0.5\n"
                "Ks 0.04 0.04 0.04\nNs 250\nPr 0.4\nPm 0.1\n"
                f"map_Kd {os.path.basename(paths['png'])}\n"
                "newmtl shiny\nKd 0.2 0.3 0.7\nKs 0.5 0.5 0.5\nNs 900\n"
                "Pr 0.2\nPm 0.9\n")
    with open(paths["obj"], "w") as f:
        f.write(f"# torus\nmtllib {os.path.basename(paths['mtl'])}\n")
        for tag, rows in (("v", pos), ("vt", uv), ("vn", nrm)):
            f.writelines(f"{tag} " + " ".join(repr(float(x)) for x in r)
                         + "\n" for r in rows)
        half = len(quads) // 2
        for start, stop, mat in ((0, half, "body"),
                                 (half, len(quads), "shiny")):
            f.write(f"usemtl {mat}\n")
            for q in quads[start:stop]:
                if mat == "shiny":  # relative (negative) indices
                    q = q - len(pos)
                else:
                    q = q + 1
                f.write("f " + " ".join(f"{k}/{k}/{k}" for k in q) + "\n")
    _write_ply(paths["ply"], pos, nrm, uv, colours, tris, ascii=False)
    _write_ply(paths["ply_ascii"], pos, nrm, uv, colours, tris, ascii=True)
    doc, data = _gltf_doc(pos, nrm, uv, tris)
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    with open(paths["glb"], "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            12 + 8 + len(js) + 8 + len(data)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(data), 0x004E4942) + data)
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(data).decode())
    with open(paths["gltf"], "w") as f:
        json.dump(doc, f)
    return paths


def mesh_scene_builder(b, mesh_dir: str):
    """Populate a fresh SceneBuilder (either package's) with the meshes of
    write_mesh_files (written into `mesh_dir` first) on a 4x4 floor under
    a 1x1 lamp facing down at y = 2: the binary PLY at the origin (one
    material), the GLB's node tree (three instances)."""
    import importlib

    loaders = importlib.import_module(
        type(b).__module__.replace(".builder", ".loaders"))
    paths = write_mesh_files(mesh_dir)
    floor = b.add_lambert_material((0.7, 0.7, 0.7))
    lamp = b.add_lambert_material((0, 0, 0), emittance=(30.0, 30.0, 30.0))
    b.add_instance(b.add_rectangle(4.0, 4.0, floor))
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    b.add_instance(b.add_rectangle(1.0, 1.0, lamp),
                   affine(rotation=flip, translation=[0.0, 2.0, 0.0]))
    b.add_instance(loaders.load_mesh(paths["ply"], b),
                   affine(translation=[0.0, 0.15, 0.0]))
    loaders.load_mesh(paths["glb"], b)
    return b


def build_textured_scene(tex_dir: str, traversal: str = "skip",
                         texture_mips: bool = True,
                         use_probability_texture: bool = False,
                         files: dict = None):
    """(SceneData, structure) of the textured scene on the CPU, compiled
    as the apps compile a scene (`skip` by default, as compile_scene);
    `files` as textured_scene_builder takes them."""
    b = textured_scene_builder(SceneBuilder(texture_mips=texture_mips),
                               tex_dir, files=files)
    return compile_scene(b, traversal=traversal,
                         use_probability_texture=use_probability_texture)


def textured_camera(width: int, height: int):
    return make_camera([0.0, 1.6, 3.0], fov_y=np.deg2rad(45),
                       aspect=width / height, target=[0.0, 0.3, 0.0])


def bench_controllers(scene: str = "big"):
    """The animated cells' controllers (t = frame / 60, as the app runs
    them): the light (instance 1) moves from y 1.5 to 1.2 and back at 0.5
    Hz, keeping its downward orientation; every Lambert sphere bobs between
    y 0.20 and 0.45 at 0.5 Hz with phase (gx + gz) / 32."""
    from gfxexp_torch.scene.animation import InstanceController

    flip = (1.0, 0.0, 0.0, 0.0)  # pi about x, the light's orientation
    out = [InstanceController(instance=1, begin_position=(0.0, 1.5, 0.0),
                              end_position=(0.0, 1.2, 0.0),
                              begin_orientation=flip, end_orientation=flip,
                              frequency=0.5)]
    cells = _LAYOUT[scene][1]
    for gx in range(cells):
        for gz in range(cells):
            tx = (gx - (cells - 1) / 2) * 0.62
            tz = (gz - (cells - 1) / 2) * 0.62
            out.append(InstanceController(
                instance=2 + 2 * (gx * cells + gz) + 1,
                begin_position=(tx + 0.28, 0.20, tz),
                end_position=(tx + 0.28, 0.45, tz), frequency=0.5,
                initial_time=(gx + gz) / 32.0))
    return out


def bench_camera(width: int, height: int, scene: str = "small"):
    _, _, position, target = _LAYOUT[scene]
    return make_camera(position, fov_y=np.deg2rad(45),
                       aspect=width / height, target=target)


def walk_rays(first_hit, scene: str, device, seed: int = 7,
              batch: int = 512 * 512, stride: int = 1, first: int = 0):
    """Four batches of `batch` rays over a bench scene, for timing and
    checking the walks: jittered primary rays at 512x512 (through pixels
    first, first + stride, first + 2 * stride, ... in row-major order),
    then three batches of random bounce directions from the primary hits;
    every 7th ray dead (t_max < 0). Shadow rays from the same origins to
    random points on the light, every 5th dead. `first_hit(o, d)` gives the
    primary hits' t and hit mask. Returns (o, d, t_min, t_max, shadow d,
    shadow t_max)."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    cam = bench_camera(512, 512, scene).to(dev)
    jit = torch.from_numpy(rng.random((2, batch), np.float32)).to(dev)
    lane = first + torch.arange(batch, device=dev) * stride
    o0, d0 = generate_rays_for_lanes(cam, 512, 512, lane, jit[0], jit[1])
    t0, h0 = first_hit(o0, d0)
    p = torch.where(h0[:, None], o0 + t0[:, None] * d0, o0)
    dirs = rng.normal(size=(3 * batch, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = torch.cat([o0, p, p, p]).contiguous()
    d = torch.cat([d0, torch.from_numpy(dirs).to(dev)]).contiguous()
    n = o.shape[0]
    idx = torch.arange(n, device=dev)
    t_min = torch.where(idx < batch, 0.0, 1e-4)
    t_max = torch.where(idx % 7 == 3, -1.0, 1e30)
    # shadow rays towards the light: 0.3 x the floor's side, at y = 1.5
    half = 0.3 * _LAYOUT[scene][0] / 2
    xz = torch.from_numpy(rng.uniform(-half, half, (n, 2)).astype(np.float32))
    target = torch.stack([xz[:, 0], torch.full((n,), 1.5), xz[:, 1]], 1)
    vec = target.to(dev) - o
    dist = torch.linalg.vector_norm(vec, dim=1)
    sd = (vec / dist[:, None]).contiguous()
    s_max = torch.where(idx % 5 == 1, -1.0, dist * 0.9999)
    return o, d, t_min, t_max, sd, s_max


def device_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time in ms of fn() over reps launches (after one warm
    call), from CUDA events on the current stream."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def render_frame(scene, bvh, camera, width, height, start_idx, n_samples,
                 cfg):
    """Mean radiance [H*W, 3] and total rays of n_samples samples, the way
    bench.py drives each size: one render_accumulate at 512x512, a loop of
    render_tile_accumulate over HD_TILES tiles at 1080p (lane order there is
    raw row-major, since 1080 is not a multiple of the 16-pixel block)."""
    if (width, height) == SIZES["512"]:
        return render_accumulate(scene, bvh, camera, width, height,
                                 start_idx, n_samples, cfg)
    n = width * height
    lanes = n // HD_TILES
    assert lanes * HD_TILES == n
    imgs, rays = [], torch.zeros((), device=scene.device)
    for ti in range(HD_TILES):
        img, nr = render_tile_accumulate(scene, bvh, camera, width, height,
                                         ti * lanes, lanes, start_idx,
                                         n_samples, cfg)
        imgs.append(img)
        rays = rays + nr
    return torch.cat(imgs) / n_samples, rays


def _counts():
    """Launches so far of every kernel a single- or two-level scene can
    reach: kernel 1 (widerow_*), kernel 2 (chunked_*), the quantized walk
    (qrow_*), the two-level walk (instanced_*) and the lane-group walk
    (lanegroup_g*), which no bench route takes; the path tracer's
    bounces shaded by its kernel (shade_kernel) or by the eager stages on
    the card (shade_eager); and ReSTIR DI's initial streams and spatial
    passes run by its resampling kernels (restir_kernel_initial,
    restir_kernel_spatial) or by their plain versions on the card
    (restir_eager_initial, restir_eager_spatial)."""
    c = trace.counters()
    qs = ("closest", "any")
    names = {**{f"widerow_{q}": f"walk.kernel1.{q}" for q in qs},
             **{f"chunked_{q}": f"walk.chunked.{q}" for q in qs},
             **{f"qrow_{q}": f"walk.qrow.{q}" for q in qs},
             **{f"instanced_{q}_{r}": f"walk.instanced.{q}_{r}"
                for q in qs for r in instanced.ROUTES},
             **{f"lanegroup_g{g}": f"walk.lanegroup.{g}"
                for g in lanegroup.GROUPS},
             "shade_kernel": "pathtrace.shade.kernel",
             "shade_eager": "pathtrace.shade.eager",
             **{f"restir_{r}_{s}": f"restir.{r}.{s}"
                for r in ("kernel", "eager") for s in ("initial", "spatial")}}
    return {k: c.get(name, 0) for k, name in names.items()}


def measure(size: str, scene=None, bvh=None, device="cuda",
            which: str = "small", cfg: PTConfig = None) -> dict:
    """Time TIMED_SAMPLES samples of bench scene `which` at `size` ('512'
    or '1080p') on `device`, with bench.py's PTConfig unless `cfg` is
    given (it must count rays). Returns bench.py's JSON fields plus the
    run's details."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("gfxexp_torch.bench measures on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    width, height = SIZES[size]
    if scene is None:
        scene, bvh = build_bench_scene(which)
    scene, bvh = scene.to(dev), bvh.to(dev)
    camera = bench_camera(width, height, which).to(dev)
    if cfg is None:
        cfg = PTConfig(max_path_length=MAX_PATH_LENGTH, count_rays=True)

    # warm-up: nothing compiles in the port, but the first sample builds
    # the kernel and fills the caching allocator
    render_frame(scene, bvh, camera, width, height, 0, 1, cfg)
    torch.cuda.synchronize(dev)
    before = _counts()
    t0 = time.perf_counter()
    img, rays = render_frame(scene, bvh, camera, width, height, 100,
                             TIMED_SAMPLES, cfg)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    after = _counts()
    launches = {k: after[k] - before[k] for k in before}
    total_rays = float(rays)
    mrays = total_rays / elapsed / 1e6
    return {
        "metric": f"pt_ray_throughput_{size if which == 'small' else which}",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / TARGET_MRAYS, 4),
        "seconds": elapsed,
        "rays": total_rays,
        "mean_radiance": float(img.mean()),
        "finite": bool(torch.isfinite(img).all()),
        "launches": launches,  # kernel launches of the timed run
        "device": torch.cuda.get_device_name(dev),
        "image": img,
        "width": width,
        "height": height,
    }


def _line(row: dict) -> dict:
    return {k: row[k] for k in ("metric", "value", "unit", "vs_baseline")}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    which = next((w for w in ("city", "big") if w in argv), "small")
    rebraid = 0.0
    fmt = None
    arity = 4
    for a in argv:
        if a.startswith("rebraid"):
            rebraid = float(a[7:] or 4.0)
        elif a in ("widerow", "qrow", "instanced"):
            fmt = a
        elif a == "a8":
            arity = 8
    if "persist" in argv or "nopersist" in argv:
        widerow.set_persistent("persist" in argv)
    sizes = [s for s in SIZES if s in argv] or (
        list(SIZES) if which == "small" else ["512"])
    scene, bvh = build_bench_scene(which, rebraid, tlas="tlas" in argv,
                                   traversal=fmt, arity=arity)
    rows = {}
    for size in sizes:
        rows[size] = measure(size, scene, bvh, which=which)
        r = rows[size]
        sys.stderr.write(
            f"bench: {which} {size} {scene.num_triangles} tris, "
            f"{TIMED_SAMPLES} samples in {r['seconds']:.3f}s, "
            f"{r['rays'] / 1e6:.2f} Mrays, mean radiance "
            f"{r['mean_radiance']:.4f}, launches {r['launches']} on "
            f"{r['device']}\n")
    if len(sizes) == 1:
        print(json.dumps(_line(rows[sizes[0]])))
        return
    hd = rows["1080p"]
    print(json.dumps({
        "metric": "pt_ray_throughput",
        "value": hd["value"],
        "unit": "Mrays/s",
        "vs_baseline": hd["vs_baseline"],
        "extra": {"resolution": "1920x1080",
                  "mrays_512": rows["512"]["value"]},
    }))


if __name__ == "__main__":
    main()
