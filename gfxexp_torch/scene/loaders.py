"""Mesh loading (port of gfxexp_tpu/scene/loaders.py): Wavefront OBJ with
its MTL materials, PLY (ASCII and binary little-endian) and glTF 2.0 (JSON
with external or data-URI buffers, and GLB), parsed on the host with numpy
into a SceneBuilder.

OBJ materials follow one of two conventions: "trad" (diffuse + specular
from Kd / Ks / Ns) and "simple_pbr" (base colour, roughness Pr, metallic
Pm). glTF materials are always the simple PBR model, from
pbrMetallicRoughness; the node tree's TRS or matrix transforms are
flattened into instances. Texture maps load through
SceneBuilder.load_texture (BC1-7 DDS, and PNG, JPEG, TGA, BMP, GIF and PNM
through load_png); glTF images in a buffer view decode through
decode_image. A glTF image the port cannot decode leaves the material's
constant colour.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from gfxexp_torch.scene.builder import (
    HostMaterial,
    SceneBuilder,
    compute_smooth_normals,
    simple_pbr_material,
)
from gfxexp_torch.scene.types import BSDF_DIFFUSE_SPECULAR, BSDF_SIMPLE_PBR
from gfxexp_torch.utils.image_io import decode_image


def parse_mtl(path: str) -> Dict[str, dict]:
    """Parse a .mtl file into raw property dicts."""
    mats: Dict[str, dict] = {}
    cur: Optional[dict] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = {}
                mats[" ".join(parts[1:])] = cur
            elif cur is not None:
                if key in ("Kd", "Ks", "Ke", "Ka"):
                    cur[key] = [float(x) for x in parts[1:4]]
                elif key in ("Ns", "d", "Ni", "Pr", "Pm"):
                    cur[key] = float(parts[1])
                elif key.startswith("map_"):
                    cur[key] = parts[-1]
    return mats


def _mtl_to_material(props: dict, convention: str, builder=None,
                     base_dir: str = "") -> HostMaterial:
    kd = props.get("Kd", [0.8, 0.8, 0.8])
    ks = props.get("Ks", [0.0, 0.0, 0.0])
    ke = props.get("Ke", [0.0, 0.0, 0.0])
    ns = props.get("Ns", 10.0)
    diffuse_tex = -1
    normal_tex = -1
    if builder is not None:
        if "map_Kd" in props:
            p = os.path.join(base_dir, props["map_Kd"])
            if os.path.exists(p):
                diffuse_tex = builder.load_texture(p, to_linear=True)
        for key in ("map_Bump", "map_bump", "bump", "norm"):
            if key in props:
                p = os.path.join(base_dir, props[key])
                if os.path.exists(p):
                    normal_tex = builder.load_texture(p, to_linear=False)
                break
    if convention == "simple_pbr":
        # base colour, roughness and metallic
        return simple_pbr_material(
            kd, props.get("Pr", 0.5), props.get("Pm", 0.0), emittance=ke,
            diffuse_tex=diffuse_tex, normal_tex=normal_tex)
    # traditional: the Phong exponent Ns -> smoothness sqrt(Ns / 1000)
    smoothness = float(np.clip(np.sqrt(max(ns, 0.0) / 1000.0), 0.0, 1.0))
    return HostMaterial(
        bsdf_type=BSDF_DIFFUSE_SPECULAR,
        diffuse_color=tuple(kd),
        specular_f0=tuple(ks),
        roughness=1.0 - smoothness,
        emittance=tuple(ke),
        diffuse_tex=diffuse_tex,
        normal_tex=normal_tex,
    )


def load_obj(
    path: str,
    builder: SceneBuilder,
    material_convention: str = "trad",
    default_material: Optional[int] = None,
) -> List[int]:
    """Parse an OBJ file, add its materials + geometry (one HostGeometry per
    used material) to `builder`. Returns geometry ids (a 'group' to instance).
    """
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    mtl_defs: Dict[str, dict] = {}
    mat_slot: Dict[str, int] = {}
    # per-material face buckets: list of (vi, ti, ni) triples
    buckets: Dict[str, List[List[Tuple[int, int, int]]]] = {}
    cur_mat = "__default__"

    base_dir = os.path.dirname(os.path.abspath(path))

    def parse_index(token: str) -> Tuple[int, int, int]:
        comps = token.split("/")
        vi = int(comps[0])
        ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
        ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
        return vi, ti, ni

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vt":
                texcoords.append((float(parts[1]), float(parts[2])
                                  if len(parts) > 2 else 0.0))
            elif key == "mtllib":
                mtl_defs.update(parse_mtl(
                    os.path.join(base_dir, " ".join(parts[1:]))))
            elif key == "usemtl":
                cur_mat = " ".join(parts[1:])
            elif key == "f":
                corners = [parse_index(t) for t in parts[1:]]
                bucket = buckets.setdefault(cur_mat, [])
                for k in range(1, len(corners) - 1):  # fan triangulation
                    bucket.append([corners[0], corners[k], corners[k + 1]])

    pos_arr = np.asarray(positions, np.float32)
    nrm_arr = np.asarray(normals, np.float32) if normals else None
    uv_arr = np.asarray(texcoords, np.float32) if texcoords else None

    geom_ids: List[int] = []
    for mat_name, faces in buckets.items():
        if mat_name not in mat_slot:
            if mat_name in mtl_defs:
                mat_slot[mat_name] = builder.add_material(
                    _mtl_to_material(mtl_defs[mat_name], material_convention,
                                     builder=builder, base_dir=base_dir)
                )
            elif default_material is not None:
                mat_slot[mat_name] = default_material
            else:
                mat_slot[mat_name] = builder.add_material(
                    HostMaterial(name=mat_name))

        # re-index: unique (v, vt, vn) corners -> compact vertex buffer
        # [F, 3, 3] 1-based, 0 = absent
        faces_arr = np.asarray(faces, np.int64)
        flat = faces_arr.reshape(-1, 3)
        # resolve negative indices (relative addressing)
        for col, count in ((0, len(positions)), (1, len(texcoords)),
                           (2, len(normals))):
            neg = flat[:, col] < 0
            flat[neg, col] += count + 1
        uniq, inv = np.unique(flat, axis=0, return_inverse=True)
        v = pos_arr[uniq[:, 0] - 1]
        uv = (
            uv_arr[np.clip(uniq[:, 1] - 1, 0, None)]
            if uv_arr is not None
            else np.zeros((len(uniq), 2), np.float32)
        )
        if uv_arr is not None:
            uv[uniq[:, 1] == 0] = 0.0
        idx = inv.reshape(-1, 3).astype(np.int32)
        if nrm_arr is not None and np.all(uniq[:, 2] > 0):
            n = nrm_arr[uniq[:, 2] - 1]
        else:
            n = compute_smooth_normals(v, idx)
        geom_ids.append(
            builder.add_geometry(v, idx, mat_slot[mat_name], normals=n,
                                 texcoords=uv)
        )
    return geom_ids


def load_ply(path: str, builder: SceneBuilder,
             material: Optional[int] = None) -> List[int]:
    """Parse a PLY mesh (ascii or binary_little_endian) and add it to
    `builder`. Supports vertex properties x/y/z [nx/ny/nz] [u/v | s/t] and
    triangle/polygon faces (fan-triangulated); other vertex properties
    (colours) are read and ignored."""
    import struct as _struct

    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(type, prop), ...])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3],
                                            parts[4]))
                else:
                    elements[-1][2].append(("scalar", parts[1], parts[2]))
            elif parts[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format {fmt}")

        _SIZES = {"char": "b", "uchar": "B", "int8": "b", "uint8": "B",
                  "short": "h", "ushort": "H", "int16": "h", "uint16": "H",
                  "int": "i", "uint": "I", "int32": "i", "uint32": "I",
                  "float": "f", "float32": "f", "double": "d",
                  "float64": "d"}

        verts = None
        vert_props = None
        faces = []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().decode().split())
                if name == "vertex":
                    vert_props = [p[1] if p[0] == "scalar" else None
                                  for p in props]
                    verts = np.asarray([[float(x) for x in r] for r in rows],
                                       np.float64)
                    vert_props = [p[2] for p in props if p[0] == "scalar"]
                elif name == "face":
                    for r in rows:
                        k = int(r[0])
                        idxs = [int(x) for x in r[1:1 + k]]
                        for j in range(1, k - 1):
                            faces.append([idxs[0], idxs[j], idxs[j + 1]])
            else:
                if name == "vertex":
                    assert all(p[0] == "scalar" for p in props), \
                        "list property on vertices unsupported"
                    fmt_str = "<" + "".join(_SIZES[p[1]] for p in props)
                    sz = _struct.calcsize(fmt_str)
                    buf = f.read(sz * count)
                    verts = np.asarray(
                        [_struct.unpack_from(fmt_str, buf, i * sz)
                         for i in range(count)], np.float64)
                    vert_props = [p[2] for p in props]
                elif name == "face":
                    _, cnt_t, idx_t, _name = [
                        p for p in props if p[0] == "list"][0]
                    cfmt = "<" + _SIZES[cnt_t]
                    ifmt_c = _SIZES[idx_t]
                    csz = _struct.calcsize(cfmt)
                    isz = _struct.calcsize("<" + ifmt_c)
                    for _ in range(count):
                        (k,) = _struct.unpack(cfmt, f.read(csz))
                        idxs = _struct.unpack("<" + ifmt_c * k,
                                              f.read(isz * k))
                        for j in range(1, k - 1):
                            faces.append([idxs[0], idxs[j], idxs[j + 1]])
                else:
                    # skip unknown fixed-size elements
                    fmt_str = "<" + "".join(
                        _SIZES[p[1]] for p in props if p[0] == "scalar")
                    f.read(_struct.calcsize(fmt_str) * count)

    if verts is None or not faces:
        raise ValueError(f"{path}: no vertex/face data")
    names = vert_props
    def col(*cands):
        for c in cands:
            if c in names:
                return verts[:, names.index(c)]
        return None

    pos = np.stack([col("x"), col("y"), col("z")], -1).astype(np.float32)
    idx = np.asarray(faces, np.int32)
    nx = col("nx")
    normals = (np.stack([nx, col("ny"), col("nz")], -1).astype(np.float32)
               if nx is not None else None)
    u = col("u", "s", "texture_u")
    uv = (np.stack([u, col("v", "t", "texture_v")], -1).astype(np.float32)
          if u is not None else None)
    if material is None:
        material = builder.add_material(
            HostMaterial(name=os.path.basename(path)))
    return [builder.add_geometry(pos, idx, material, normals=normals,
                                 texcoords=uv)]


def load_mesh(path: str, builder: SceneBuilder, **kw) -> List[int]:
    """Extension-dispatched mesh import (OBJ / PLY / glTF / GLB)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path, builder, **kw)
    if ext == ".ply":
        return load_ply(path, builder, **kw)
    if ext in (".gltf", ".glb"):
        kw.pop("material_convention", None)  # glTF is always PBR
        return load_gltf(path, builder, **kw)
    raise ValueError(f"unsupported mesh format: {ext}")


# ---------------------------------------------------------------------------
# glTF 2.0 (.gltf JSON / .glb binary container): buffers, buffer views and
# accessors, pbrMetallicRoughness materials, and the node tree's TRS or
# matrix transforms instanced through the builder.
# ---------------------------------------------------------------------------

_GLTF_COMP = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _gltf_read_buffers(doc: dict, base_dir: str, glb_bin: Optional[bytes]):
    import base64

    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            assert glb_bin is not None, "buffer without uri outside GLB"
            buffers.append(glb_bin)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            from urllib.parse import unquote

            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                buffers.append(f.read())
    return buffers


def _gltf_accessor(doc: dict, buffers, idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    ncomp = _GLTF_NCOMP[acc["type"]]
    dtype = _GLTF_COMP[acc["componentType"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize
    if "bufferView" not in acc:  # sparse-only/zero-filled accessor
        return np.zeros((count, ncomp), dtype)
    bv = doc["bufferViews"][acc["bufferView"]]
    raw = buffers[bv["buffer"]]
    off = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", 0) or ncomp * itemsize
    rows = np.frombuffer(raw, np.uint8, count=(count - 1) * stride
                         + ncomp * itemsize, offset=off)
    if stride == ncomp * itemsize:
        out = rows.view(dtype).reshape(count, ncomp)
    else:
        idxs = (np.arange(count)[:, None] * stride
                + np.arange(ncomp * itemsize)[None, :])
        out = rows[idxs].copy().view(dtype).reshape(count, ncomp)
    if acc.get("normalized"):
        info = np.iinfo(dtype)
        out = out.astype(np.float32) / float(info.max)
        if info.min < 0:
            out = np.maximum(out, -1.0)
    return out


def _gltf_node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
             2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
             2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w),
             1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def load_gltf(path: str, builder: SceneBuilder,
              instantiate: bool = True) -> List[int]:
    """Load a .gltf/.glb scene: geometry per mesh primitive (SimplePBR
    materials from pbrMetallicRoughness), node-tree transforms flattened
    and instanced (instantiate=True). Returns all created geometry ids."""
    import json

    base_dir = os.path.dirname(os.path.abspath(path))
    glb_bin = None
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":  # GLB container
            import struct as _struct

            data = f.read()
            _, version, _ = _struct.unpack_from("<III", data, 0)
            assert version == 2, f"GLB version {version}"
            off = 12
            doc = None
            while off < len(data):
                clen, ctype = _struct.unpack_from("<II", data, off)
                chunk = data[off + 8:off + 8 + clen]
                if ctype == 0x4E4F534A:  # JSON
                    doc = json.loads(chunk)
                elif ctype == 0x004E4942:  # BIN
                    glb_bin = chunk
                off += 8 + clen + (-clen) % 4
            assert doc is not None, "GLB without JSON chunk"
        else:
            with open(path, "r") as jf:
                doc = json.load(jf)

    buffers = _gltf_read_buffers(doc, base_dir, glb_bin)

    # --- textures -> atlas ids (external image files through
    # builder.load_texture; images in a buffer view through decode_image) ---
    tex_atlas: dict = {}

    def texture_id(tex_index: Optional[int], srgb: bool) -> int:
        if tex_index is None:
            return -1
        if tex_index in tex_atlas:
            return tex_atlas[tex_index]
        tid = -1
        try:
            img_idx = doc["textures"][tex_index].get("source")
            img = doc["images"][img_idx]
            if "uri" in img and not img["uri"].startswith("data:"):
                from urllib.parse import unquote

                tid = builder.load_texture(
                    os.path.join(base_dir, unquote(img["uri"])),
                    to_linear=srgb)
            elif "bufferView" in img:
                bv = doc["bufferViews"][img["bufferView"]]
                blob = buffers[bv["buffer"]][
                    bv.get("byteOffset", 0):
                    bv.get("byteOffset", 0) + bv["byteLength"]]
                tid = builder.add_texture(decode_image(
                    blob, to_linear=srgb, name=f"{path} image {img_idx}"))
        except Exception as e:  # missing/unsupported image: constant color
            print(f"gltf: texture {tex_index} skipped ({e})")
        tex_atlas[tex_index] = tid
        return tid

    # --- materials (pbrMetallicRoughness -> SimplePBR convention) ---
    mat_ids = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        emis = m.get("emissiveFactor", [0.0, 0.0, 0.0])
        strength = m.get("extensions", {}).get(
            "KHR_materials_emissive_strength", {}).get(
            "emissiveStrength", 1.0)
        bct = pbr.get("baseColorTexture", {}).get("index")
        nrm = m.get("normalTexture", {}).get("index")
        mat_ids.append(builder.add_material(HostMaterial(
            bsdf_type=BSDF_SIMPLE_PBR,
            diffuse_color=tuple(base[:3]),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            emittance=tuple(float(e) * strength for e in emis),
            diffuse_tex=texture_id(bct, srgb=True),
            normal_tex=texture_id(nrm, srgb=False),
            name=m.get("name", ""),
        )))
    default_mat = None

    # --- meshes -> geometry groups ---
    mesh_geoms: List[List[int]] = []
    all_geoms: List[int] = []
    for mesh in doc.get("meshes", []):
        ids = []
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                print(f"gltf: skipping non-triangle primitive in "
                      f"{mesh.get('name', '?')}")
                continue
            attrs = prim["attributes"]
            pos = _gltf_accessor(doc, buffers, attrs["POSITION"]) \
                .astype(np.float32)
            if "indices" in prim:
                idx = _gltf_accessor(doc, buffers, prim["indices"]) \
                    .reshape(-1).astype(np.int64)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int64)
            idx = idx.reshape(-1, 3).astype(np.int32)
            nrm = None
            if "NORMAL" in attrs:
                nrm = _gltf_accessor(doc, buffers, attrs["NORMAL"]) \
                    .astype(np.float32)
            uv = None
            if "TEXCOORD_0" in attrs:
                uvd = _gltf_accessor(doc, buffers, attrs["TEXCOORD_0"]) \
                    .astype(np.float32)
                # glTF uv origin is top-left; the sampler's v flip expects
                # GL-style bottom-left
                uv = np.stack([uvd[:, 0], 1.0 - uvd[:, 1]], axis=1)
            if "material" in prim:
                mat = mat_ids[prim["material"]]
            else:
                if default_mat is None:
                    default_mat = builder.add_material(HostMaterial())
                mat = default_mat
            ids.append(builder.add_geometry(pos, idx, mat, normals=nrm,
                                            texcoords=uv))
        mesh_geoms.append(ids)
        all_geoms.extend(ids)

    # --- node tree -> flattened instances ---
    if instantiate:
        nodes = doc.get("nodes", [])
        scene_idx = doc.get("scene", 0)
        scenes = doc.get("scenes", [])
        roots = scenes[scene_idx]["nodes"] if scenes else range(len(nodes))

        def walk(ni: int, parent: np.ndarray):
            node = nodes[ni]
            m = parent @ _gltf_node_matrix(node)
            if "mesh" in node and mesh_geoms[node["mesh"]]:
                builder.add_instance(mesh_geoms[node["mesh"]],
                                     m[:3, :4].astype(np.float32))
            for child in node.get("children", []):
                walk(child, m)

        for r in roots:
            walk(r, np.eye(4))
    return all_geoms
