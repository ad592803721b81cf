"""Host-side scene construction -> SceneData (port of
gfxexp_tpu/scene/builder.py: materials, textures, meshes, rectangles,
spheres, curves, instances, displaced meshes (TFDM, NRTDSM) and shells,
the environment light, and both compiles).

`compile()` flattens the instance graph into world-space triangle tables and
per-unit light distributions with numpy, as the JAX package does, and returns
them as CPU tensors; move the result with `.to(device)`. `compile_instanced()`
keeps one object-space BLAS per geometry group, shared by its instances.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from gfxexp_torch.core.distributions import (
    build_continuous_2d,
    build_probability_texture,
    vose_alias_arrays,
)
from gfxexp_torch.core.math import np_normalize
from gfxexp_torch.scene.types import (
    BSDF_DIFFUSE_SPECULAR,
    BSDF_LAMBERT,
    BSDF_SIMPLE_PBR,
    EnvLight,
    InstanceTable,
    MaterialTable,
    ObjectTriangles,
    SceneData,
    TriangleSoA,
    UnitTable,
)
from gfxexp_torch.scene.textures import AtlasBuilder, load_dds
from gfxexp_torch.utils.image_io import load_png

_LUMA = np.array([0.2126729, 0.7151522, 0.0721750])


@dataclasses.dataclass
class HostMaterial:
    bsdf_type: int = BSDF_LAMBERT
    diffuse_color: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    specular_f0: Tuple[float, float, float] = (0.04, 0.04, 0.04)
    roughness: float = 0.3
    metallic: float = 0.0
    emittance: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diffuse_tex: int = -1
    emittance_tex: int = -1
    normal_tex: int = -1
    normal_map_kind: int = 0
    name: str = ""


def simple_pbr_material(base_color, roughness, metallic, emittance=(0, 0, 0),
                        name="", **fields) -> HostMaterial:
    """A SimplePBR material on the diffuse + specular parameterisation:
    diffuse = base (1 - metallic), F0 = 0.04 (1 - metallic) + base metallic;
    `fields` sets the other HostMaterial fields (textures)."""
    base = np.asarray(base_color, np.float64)
    m = float(metallic)
    return HostMaterial(
        bsdf_type=BSDF_SIMPLE_PBR, diffuse_color=tuple(base * (1.0 - m)),
        specular_f0=tuple(0.04 * (1.0 - m) + base * m),
        roughness=float(roughness), metallic=m, emittance=tuple(emittance),
        name=name, **fields)


@dataclasses.dataclass
class HostGeometry:
    """One triangle mesh with a single material slot (object space)."""

    positions: np.ndarray  # [V, 3] float32
    normals: np.ndarray  # [V, 3]
    texcoords: np.ndarray  # [V, 2]
    indices: np.ndarray  # [F, 3] int32
    material: int


@dataclasses.dataclass
class HostInstance:
    """Placement of a list of geometries in the world."""

    geometries: List[int]
    transform: np.ndarray  # [3, 4] object -> world
    # scene/animation.py InstanceController; stored, read by no build
    controller: Optional[object] = None


def affine(rotation=None, translation=None, scale=None) -> np.ndarray:
    r = np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
    if scale is not None:
        s = np.broadcast_to(np.atleast_1d(np.asarray(scale, np.float64)), (3,))
        r = r * s[None, :]
    t = (np.zeros(3) if translation is None
         else np.asarray(translation, np.float64))
    return np.concatenate([r, t[:, None]], axis=1).astype(np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


class SceneBuilder:
    """Accumulates materials, geometries and instances, then `compile()`s to
    a SceneData of CPU tensors."""

    def __init__(self, texture_mips: bool = False):
        self.materials: List[HostMaterial] = []
        self.geometries: List[HostGeometry] = []
        self.instances: List[HostInstance] = []
        self.env_radiance: Optional[np.ndarray] = None  # [H, W, 3]
        self.env_power: float = 1.0
        self.env_rotation: float = 0.0
        # texture_mips=True builds each layer's mip chain, for trilinear
        # sampling at a per-lane LOD (PTConfig.texture_lod)
        self.atlas = AtlasBuilder(mips=texture_mips)
        self._texture_cache: dict = {}
        # add_displaced's base meshes, add_shell's and add_curve(direct=
        # True)'s, built by compile() into SceneData.displaced: (kind,
        # positions, indices, uvs, height, params, material, normals)
        self.displaced_geoms: List[tuple] = []

    # -- textures ----------------------------------------------------------

    def add_texture(self, image: np.ndarray) -> int:
        """Register a texture image ([H, W, C] float linear); returns its
        id."""
        return self.atlas.add(image)

    def load_texture(self, path: str, to_linear: bool = True) -> int:
        """Load a texture file once and return its id: a `.dds` through the
        BC decoders, any other file through load_png, which reads PNG,
        JPEG, TGA, BMP, GIF and PNM by their signatures. A second load of
        the same path and conversion returns the first id."""
        key = (path, to_linear)
        if key not in self._texture_cache:
            if path.lower().endswith(".dds"):
                img = load_dds(path)
            else:
                img = load_png(path, to_linear=to_linear)
            self._texture_cache[key] = self.add_texture(img)
        return self._texture_cache[key]

    def _textures(self):
        return self.atlas.build() if self.atlas.images else None

    # -- curves ------------------------------------------------------------

    def add_curve(self, control_points, radii, material,
                  curve_type: str = "cubic_bspline",
                  n_axial: int = 8, n_radial: int = 8,
                  direct: bool = False) -> int:
        """A swept-sphere curve (core/curves.py). direct=False (the
        default) tessellates it into a triangle tube, a geometry like any
        other (the returned id). direct=True traces it exactly beside the
        displaced meshes (SceneData.displaced): a linear curve as
        round-linear segments, the other types as power-basis spans; the
        returned id is then its index there, which cannot be instanced."""
        if direct:
            self.displaced_geoms.append(
                ("curve", np.asarray(control_points, np.float32),
                 None, None, np.asarray(radii, np.float32),
                 curve_type, int(material), None))
            return len(self.displaced_geoms) - 1
        from gfxexp_torch.core.curves import tessellate_curve

        v, n, f = tessellate_curve(
            curve_type, np.asarray(control_points, np.float32),
            np.asarray(radii, np.float32), n_axial=n_axial, n_radial=n_radial)
        return self.add_geometry(v, f, material, normals=n)

    # -- materials ---------------------------------------------------------

    def add_material(self, mat: HostMaterial) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_lambert_material(self, reflectance, emittance=(0, 0, 0),
                             name="") -> int:
        return self.add_material(HostMaterial(
            bsdf_type=BSDF_LAMBERT, diffuse_color=tuple(reflectance),
            emittance=tuple(emittance), name=name))

    def add_diffuse_specular_material(self, diffuse, specular_f0, smoothness,
                                      emittance=(0, 0, 0), name="") -> int:
        return self.add_material(HostMaterial(
            bsdf_type=BSDF_DIFFUSE_SPECULAR, diffuse_color=tuple(diffuse),
            specular_f0=tuple(specular_f0),
            roughness=float(1.0 - smoothness), emittance=tuple(emittance),
            name=name))

    def add_simple_pbr_material(self, base_color, roughness, metallic,
                                emittance=(0, 0, 0), name="") -> int:
        return self.add_material(simple_pbr_material(
            base_color, roughness, metallic, emittance=emittance, name=name))

    # -- geometry ----------------------------------------------------------

    def add_geometry(self, positions, indices, material, normals=None,
                     texcoords=None) -> int:
        """A triangle mesh; normals default to the area-weighted vertex
        normals, texcoords to zeros."""
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        if normals is None:
            normals = compute_smooth_normals(positions, indices)
        else:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)
        if texcoords is None:
            texcoords = np.zeros((positions.shape[0], 2), np.float32)
        else:
            texcoords = np.asarray(texcoords, np.float32).reshape(-1, 2)
        self.geometries.append(HostGeometry(positions, normals, texcoords,
                                            indices, int(material)))
        return len(self.geometries) - 1

    def add_rectangle(self, dim_x, dim_z, material) -> int:
        """XZ-plane rectangle centred at the origin, +Y normal."""
        hx, hz = dim_x * 0.5, dim_z * 0.5
        positions = np.array(
            [[-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz]],
            np.float32)
        normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
        texcoords = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
        # winding chosen so cross(e1, e2) == +Y == the shading normal
        indices = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
        self.geometries.append(HostGeometry(positions, normals, texcoords,
                                            indices, int(material)))
        return len(self.geometries) - 1

    def add_sphere(self, radius, material, n_theta=32, n_phi=64) -> int:
        """UV sphere."""
        th = np.linspace(0, np.pi, n_theta + 1)
        ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
        tt, pp = np.meshgrid(th, ph, indexing="ij")
        x = np.sin(tt) * np.cos(pp)
        y = np.cos(tt)
        z = np.sin(tt) * np.sin(pp)
        pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
        nrm = pos.copy()
        uv = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi],
                      axis=-1).reshape(-1, 2)
        idx = []
        for i in range(n_theta):
            for j in range(n_phi):
                a = i * n_phi + j
                b = i * n_phi + (j + 1) % n_phi
                c = (i + 1) * n_phi + j
                d = (i + 1) * n_phi + (j + 1) % n_phi
                if i > 0:
                    idx.append([a, b, c])
                if i < n_theta - 1:
                    idx.append([b, d, c])
        self.geometries.append(HostGeometry(
            pos * radius, nrm.astype(np.float32), uv.astype(np.float32),
            np.asarray(idx, np.int32), int(material)))
        return len(self.geometries) - 1

    # -- instances ---------------------------------------------------------

    def add_instance(self, geometries, transform=None,
                     controller=None) -> int:
        if isinstance(geometries, int):
            geometries = [geometries]
        if transform is None:
            transform = affine()
        self.instances.append(HostInstance(
            list(geometries), np.asarray(transform, np.float32), controller))
        return len(self.instances) - 1

    # -- displaced geometry ------------------------------------------------

    def add_displaced(self, positions, indices, uvs, height, params=None,
                      material: int = 0, kind: str = "tfdm",
                      normals=None) -> int:
        """A height-mapped base mesh traced as a displaced surface beside
        the triangles (SceneData.displaced): kind "tfdm" (the tangent-space
        texel walk, techniques/tfdm.py) or "nrtdsm" (the exact nonlinear
        shells, techniques/nrtdsm.py)."""
        self.displaced_geoms.append(
            (kind, np.asarray(positions, np.float32),
             np.asarray(indices, np.int32), np.asarray(uvs, np.float32),
             np.asarray(height, np.float32), params, int(material), normals))
        return len(self.displaced_geoms) - 1

    def add_shell(self, positions, indices, uvs, shell_positions,
                  shell_indices, params=None, material: int = 0,
                  normals=None, shell_materials=None) -> int:
        """A shell-mapped base mesh: triangle contents in (u, v, hn)
        instanced inside each prism (techniques/shell.py), with a material
        slot a content triangle (`material` for all by default)."""
        self.displaced_geoms.append(
            ("shell", np.asarray(positions, np.float32),
             np.asarray(indices, np.int32), np.asarray(uvs, np.float32),
             (np.asarray(shell_positions, np.float32),
              np.asarray(shell_indices, np.int32), shell_materials),
             params, int(material), normals))
        return len(self.displaced_geoms) - 1

    def _build_displaced(self):
        """The geometry of each displaced entry (host build, CPU tensors),
        or None without any: curves as segments (linear) or spans, shells,
        TFDM, and NRTDSM for every other kind, as the JAX package
        dispatches."""
        if not self.displaced_geoms:
            return None
        out = []
        for (kind, pos, idx, uvs, height, params, mat,
             normals) in self.displaced_geoms:
            if kind == "curve":
                from gfxexp_torch.core.curves import (
                    CURVE_LINEAR,
                    build_curve_segments,
                    build_curve_spans,
                )

                build = (build_curve_segments if params == CURVE_LINEAR
                         else build_curve_spans)
                out.append(build(pos, height, material=mat,
                                 curve_type=params))
            elif kind == "shell":
                from gfxexp_torch.techniques.shell import build_shell_geometry

                spos, sidx, smats = height
                out.append(build_shell_geometry(
                    pos, idx, uvs, spos, sidx, params=params, material=mat,
                    normals=normals, shell_materials=smats))
            elif kind == "tfdm":
                from gfxexp_torch.techniques.tfdm import build_tfdm_geometry

                out.append(build_tfdm_geometry(
                    pos, idx, uvs, height, params=params, material=mat,
                    normals=normals))
            else:
                from gfxexp_torch.techniques.nrtdsm import (
                    build_nrtdsm_geometry,
                )

                out.append(build_nrtdsm_geometry(
                    pos, idx, uvs, height, params=params, material=mat,
                    normals=normals))
        return tuple(out)

    # -- environment -------------------------------------------------------

    def set_environment(self, radiance_hw3, power_coeff=1.0, rotation=0.0):
        self.env_radiance = np.asarray(radiance_hw3, np.float32)
        self.env_power = float(power_coeff)
        self.env_rotation = float(rotation)

    # -- compile -----------------------------------------------------------

    def _materials_table(self, mats) -> MaterialTable:
        def col(key, dtype):
            return _t(np.asarray([getattr(m, key) for m in mats], dtype))

        return MaterialTable(
            bsdf_type=col("bsdf_type", np.int32),
            diffuse_color=col("diffuse_color", np.float32),
            specular_f0=col("specular_f0", np.float32),
            roughness=col("roughness", np.float32),
            metallic=col("metallic", np.float32),
            emittance=col("emittance", np.float32),
            diffuse_tex=col("diffuse_tex", np.int32),
            emittance_tex=col("emittance_tex", np.int32),
            normal_tex=col("normal_tex", np.int32),
            normal_map_kind=col("normal_map_kind", np.int32),
        )

    def _env_light(self):
        if self.env_radiance is None:
            return None
        # importance = luminance x sin(theta) (lat-long solid-angle factor)
        h = self.env_radiance.shape[0]
        lum = self.env_radiance @ _LUMA
        sin_t = np.sin(np.pi * (np.arange(h) + 0.5) / h)
        return EnvLight(
            radiance=_t(self.env_radiance),
            importance=build_continuous_2d(lum * sin_t[:, None]),
            power_coeff=torch.tensor(self.env_power, dtype=torch.float32),
            rotation=torch.tensor(self.env_rotation, dtype=torch.float32),
            enabled=torch.tensor(True),
        )

    def compile(self, use_probability_texture: bool = False) -> SceneData:
        """Flatten the instance graph to world-space SoA tables and light
        distributions (CPU tensors). use_probability_texture also builds the
        units' probability texture (SceneData.light_unit_probtex)."""
        if not self.instances:
            raise ValueError("scene has no instances")
        mats = self.materials or [HostMaterial()]

        tri_chunks = {k: [] for k in (
            "p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "unit",
            "op0", "oe1", "oe2", "on0", "on1", "on2", "inst")}
        unit_material, unit_instance = [], []
        unit_tri_offset, unit_tri_count = [], []
        unit_importance = []
        tri_pmf_chunks, tri_cdf_chunks = [], []
        tri_aprob_chunks, tri_aidx_chunks = [], []
        inst_transform, inst_scale = [], []

        tri_cursor = 0
        unit_cursor = 0
        for inst_id, inst in enumerate(self.instances):
            m = inst.transform.astype(np.float64)
            rot = m[:, :3]
            inst_transform.append(inst.transform)
            inst_scale.append(
                float(np.cbrt(max(abs(np.linalg.det(rot)), 1e-30))))
            nrm_mat = np.linalg.inv(rot).T
            for geom_id in inst.geometries:
                g = self.geometries[geom_id]
                v = g.positions @ rot.T + m[:, 3]
                n = np_normalize(g.normals @ nrm_mat.T)
                i0, i1, i2 = g.indices[:, 0], g.indices[:, 1], g.indices[:, 2]
                p0, p1, p2 = v[i0], v[i1], v[i2]
                tri_chunks["p0"].append(p0)
                tri_chunks["e1"].append(p1 - p0)
                tri_chunks["e2"].append(p2 - p0)
                tri_chunks["n0"].append(n[i0])
                tri_chunks["n1"].append(n[i1])
                tri_chunks["n2"].append(n[i2])
                tri_chunks["uv0"].append(g.texcoords[i0])
                tri_chunks["uv1"].append(g.texcoords[i1])
                tri_chunks["uv2"].append(g.texcoords[i2])
                nt = len(g.indices)
                tri_chunks["unit"].append(np.full(nt, unit_cursor, np.int32))
                # object-space copies for animation (types.ObjectTriangles)
                op0 = g.positions[i0]
                tri_chunks["op0"].append(op0)
                tri_chunks["oe1"].append(g.positions[i1] - op0)
                tri_chunks["oe2"].append(g.positions[i2] - op0)
                tri_chunks["on0"].append(g.normals[i0])
                tri_chunks["on1"].append(g.normals[i1])
                tri_chunks["on2"].append(g.normals[i2])
                tri_chunks["inst"].append(np.full(nt, inst_id, np.int32))

                # per-triangle emissive importance = world area x luminance
                area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0),
                                            axis=-1)
                emit_lum = float(np.dot(_LUMA, mats[g.material].emittance))
                w = area * emit_lum
                total = w.sum()
                pmf = w / total if total > 0 else np.zeros(nt)
                cdf = np.concatenate([[0.0], np.cumsum(pmf)[:-1]])
                tri_pmf_chunks.append(pmf.astype(np.float32))
                tri_cdf_chunks.append(cdf.astype(np.float32))
                _, a_prob, a_idx, _ = vose_alias_arrays(w)
                tri_aprob_chunks.append(a_prob.astype(np.float32))
                tri_aidx_chunks.append(a_idx.astype(np.int32))

                unit_material.append(g.material)
                unit_instance.append(inst_id)
                unit_tri_offset.append(tri_cursor)
                unit_tri_count.append(nt)
                unit_importance.append(float(total))
                tri_cursor += nt
                unit_cursor += 1

        def cat(key):
            return _t(np.concatenate(tri_chunks[key]).astype(
                np.int32 if key in ("unit", "inst") else np.float32))

        triangles = TriangleSoA(
            p0=cat("p0"), e1=cat("e1"), e2=cat("e2"),
            n0=cat("n0"), n1=cat("n1"), n2=cat("n2"),
            uv0=cat("uv0"), uv1=cat("uv1"), uv2=cat("uv2"),
            unit_id=cat("unit"))

        unit_importance = np.asarray(unit_importance, np.float64)
        total_imp = unit_importance.sum()
        unit_pmf = (unit_importance / total_imp if total_imp > 0
                    else np.zeros_like(unit_importance))
        unit_cdf = np.concatenate([[0.0], np.cumsum(unit_pmf)])
        _, unit_aprob, unit_aidx, _ = vose_alias_arrays(unit_importance)
        unit_probtex = None
        if use_probability_texture:
            # units row-major in the smallest power-of-two square
            n_u = len(unit_importance)
            side = 1
            while side * side < n_u:
                side *= 2
            grid = np.zeros((side, side), np.float64)
            grid.flat[:n_u] = unit_importance
            unit_probtex = build_probability_texture(grid)

        units = UnitTable(
            material=_t(np.asarray(unit_material, np.int32)),
            instance=_t(np.asarray(unit_instance, np.int32)),
            tri_offset=_t(np.asarray(unit_tri_offset, np.int32)),
            tri_count=_t(np.asarray(unit_tri_count, np.int32)),
            light_tri_cdf=_t(np.concatenate(tri_cdf_chunks).astype(
                np.float32)),
            light_tri_index=torch.arange(tri_cursor, dtype=torch.int32),
            light_tri_pmf=_t(np.concatenate(tri_pmf_chunks).astype(
                np.float32)),
            emissive_importance=_t(unit_importance.astype(np.float32)),
            light_tri_alias_prob=_t(np.concatenate(tri_aprob_chunks).astype(
                np.float32)),
            light_tri_alias_local=_t(np.concatenate(tri_aidx_chunks).astype(
                np.int32)),
        )

        transforms = np.stack(inst_transform).astype(np.float32)
        inv = np.zeros_like(transforms)
        for i, t in enumerate(transforms):
            r_inv = np.linalg.inv(t[:, :3].astype(np.float64))
            inv[i, :, :3] = r_inv
            inv[i, :, 3] = -r_inv @ t[:, 3].astype(np.float64)
        instances = InstanceTable(
            transform=_t(transforms), inv_transform=_t(inv),
            prev_transform=_t(transforms.copy()),
            uniform_scale=_t(np.asarray(inst_scale, np.float32)))

        return SceneData(
            materials=self._materials_table(mats),
            triangles=triangles,
            units=units,
            instances=instances,
            light_unit_cdf=_t(unit_cdf.astype(np.float32)),
            light_unit_pmf=_t(unit_pmf.astype(np.float32)),
            light_unit_alias_prob=_t(unit_aprob.astype(np.float32)),
            light_unit_alias_idx=_t(unit_aidx.astype(np.int32)),
            light_unit_probtex=unit_probtex,
            total_emissive_importance=torch.tensor(np.float32(total_imp)),
            env=self._env_light(),
            textures=self._textures(),
            object_triangles=ObjectTriangles(
                p0=cat("op0"), e1=cat("oe1"), e2=cat("oe2"), n0=cat("on0"),
                n1=cat("on1"), n2=cat("on2"), instance=cat("inst")),
            displaced=self._build_displaced(),
        )

    def compile_instanced(self, arity: int = 4, max_leaf: int = 4,
                          node_format: str = "widerow",
                          rebraid: float = 0.0):
        """Two-level compile: per-group BLAS tables shared by instances.

        Returns (SceneData, InstancedAccel) of CPU tensors. SceneData.
        triangles hold OBJECT-space BLAS triangles (unit_id = local geometry
        index within the group); light-order arrays are per UNIT (instance x
        geometry), for emissive units only, with world-space importances,
        and light_tri_index maps light-order positions to global BLAS
        triangle ids."""
        from gfxexp_torch.accel.instanced import build_instanced

        if node_format != "widerow":
            raise ValueError(f"unsupported instanced node_format "
                             f"{node_format!r}")
        if not self.instances:
            raise ValueError("scene has no instances")
        mats = self.materials or [HostMaterial()]

        # ---- dedupe geometry groups -> BLAS ids ----
        group_key_to_blas = {}
        blas_groups = []  # geometry-id tuples
        inst_blas = []
        for inst in self.instances:
            key = tuple(inst.geometries)
            if key not in group_key_to_blas:
                group_key_to_blas[key] = len(blas_groups)
                blas_groups.append(key)
            inst_blas.append(group_key_to_blas[key])

        # ---- per-BLAS object-space triangle arrays (pre-permutation) ----
        blas_raw = []  # per blas: (SoA chunks, geom local bases, counts)
        blas_tri_base = []  # global base of each blas in concatenated order
        cursor = 0
        for group in blas_groups:
            chunks = {k: [] for k in ("p0", "e1", "e2", "n0", "n1", "n2",
                                      "uv0", "uv1", "uv2", "unit")}
            geom_base, geom_count = [], []
            local = 0
            for k, geom_id in enumerate(group):
                g = self.geometries[geom_id]
                i0, i1, i2 = g.indices[:, 0], g.indices[:, 1], g.indices[:, 2]
                p0, p1, p2 = g.positions[i0], g.positions[i1], g.positions[i2]
                chunks["p0"].append(p0)
                chunks["e1"].append(p1 - p0)
                chunks["e2"].append(p2 - p0)
                chunks["n0"].append(g.normals[i0])
                chunks["n1"].append(g.normals[i1])
                chunks["n2"].append(g.normals[i2])
                chunks["uv0"].append(g.texcoords[i0])
                chunks["uv1"].append(g.texcoords[i1])
                chunks["uv2"].append(g.texcoords[i2])
                nt = len(g.indices)
                chunks["unit"].append(np.full(nt, k, np.int32))
                geom_base.append(local)
                geom_count.append(nt)
                local += nt
            cat = {k: np.concatenate(v).astype(
                np.int32 if k == "unit" else np.float32)
                for k, v in chunks.items()}
            blas_raw.append((cat, geom_base, geom_count))
            blas_tri_base.append(cursor)
            cursor += local

        # ---- build BLAS BVHs (permutes each blas's triangles) ----
        acc, perms = build_instanced(
            [(b[0]["p0"], b[0]["e1"], b[0]["e2"]) for b in blas_raw],
            [(inst_blas[i], self.instances[i].transform)
             for i in range(len(self.instances))],
            arity=arity, max_leaf=max_leaf, rebraid=rebraid)
        # apply per-blas permutations; light order stays GEOMETRY order
        blas_cat = {k: [] for k in blas_raw[0][0]}
        inv_perms = []
        for b, (cat, _, _) in enumerate(blas_raw):
            p = perms[b]
            inv = np.empty_like(p)
            inv[p] = np.arange(len(p), dtype=p.dtype)
            inv_perms.append(inv)
            for k in blas_cat:
                blas_cat[k].append(np.asarray(cat[k])[p])
        triangles = TriangleSoA(
            **{("unit_id" if k == "unit" else k): _t(np.concatenate(v))
               for k, v in blas_cat.items()})

        # ---- units: instance-major, group order ----
        unit_material, unit_instance = [], []
        unit_tri_offset, unit_tri_count, unit_tri_base = [], [], []
        unit_importance = []
        tri_pmf_chunks, tri_cdf_chunks, tri_idx_chunks = [], [], []
        tri_aprob_chunks, tri_aidx_chunks = [], []
        inst_transform, inst_scale, inst_unit_base = [], [], []
        light_cursor = 0
        unit_cursor = 0
        for inst_id, inst in enumerate(self.instances):
            b = inst_blas[inst_id]
            cat, geom_base, geom_count = blas_raw[b]
            m = inst.transform.astype(np.float64)
            rot = m[:, :3]
            inst_transform.append(inst.transform)
            inst_scale.append(
                float(np.cbrt(max(abs(np.linalg.det(rot)), 1e-30))))
            inst_unit_base.append(unit_cursor)
            for k, geom_id in enumerate(blas_groups[b]):
                g = self.geometries[geom_id]
                nt = geom_count[k]
                lo = geom_base[k]
                emit_lum = float(np.dot(_LUMA, mats[g.material].emittance))
                # only emissive units get light-order segments; the others
                # keep (offset=cursor, count=0) and unit pmf 0
                if emit_lum > 0.0:
                    # world-space emissive importance under this instance
                    e1w = cat["e1"][lo:lo + nt] @ rot.T
                    e2w = cat["e2"][lo:lo + nt] @ rot.T
                    area = 0.5 * np.linalg.norm(np.cross(e1w, e2w), axis=-1)
                    w = area * emit_lum
                    total = w.sum()
                    pmf = w / total if total > 0 else np.zeros(nt)
                    cdf = np.concatenate([[0.0], np.cumsum(pmf)[:-1]])
                    tri_pmf_chunks.append(pmf.astype(np.float32))
                    tri_cdf_chunks.append(cdf.astype(np.float32))
                    _, a_prob, a_idx, _ = vose_alias_arrays(w)
                    tri_aprob_chunks.append(a_prob.astype(np.float32))
                    tri_aidx_chunks.append(a_idx.astype(np.int32))
                    # light-order position -> global blas triangle id
                    glob = blas_tri_base[b] + inv_perms[b][lo:lo + nt]
                    tri_idx_chunks.append(glob.astype(np.int32))
                    nt_light = nt
                else:
                    total = 0.0
                    nt_light = 0
                unit_material.append(g.material)
                unit_instance.append(inst_id)
                unit_tri_offset.append(light_cursor)
                unit_tri_count.append(nt_light)
                unit_tri_base.append(lo)  # geometry-order base within blas
                unit_importance.append(float(total))
                light_cursor += nt_light
                unit_cursor += 1

        unit_importance = np.asarray(unit_importance, np.float64)
        total_imp = unit_importance.sum()
        unit_pmf = (unit_importance / total_imp if total_imp > 0
                    else np.zeros_like(unit_importance))
        unit_cdf = np.concatenate([[0.0], np.cumsum(unit_pmf)])
        _, unit_aprob, unit_aidx, _ = vose_alias_arrays(unit_importance)

        def cat_or_zero(chunks, dtype):
            # no emissive unit: 1-element zero arrays keep gathers in range
            if not chunks:
                return _t(np.zeros(1, dtype))
            return _t(np.concatenate(chunks).astype(dtype))

        units = UnitTable(
            material=_t(np.asarray(unit_material, np.int32)),
            instance=_t(np.asarray(unit_instance, np.int32)),
            tri_offset=_t(np.asarray(unit_tri_offset, np.int32)),
            tri_count=_t(np.asarray(unit_tri_count, np.int32)),
            light_tri_cdf=cat_or_zero(tri_cdf_chunks, np.float32),
            light_tri_index=cat_or_zero(tri_idx_chunks, np.int32),
            # LIGHT-ORDER pmf in instanced scenes (see lights.py)
            light_tri_pmf=cat_or_zero(tri_pmf_chunks, np.float32),
            emissive_importance=_t(unit_importance.astype(np.float32)),
            light_tri_alias_prob=cat_or_zero(tri_aprob_chunks, np.float32),
            light_tri_alias_local=cat_or_zero(tri_aidx_chunks, np.int32),
        )

        transforms = np.stack(inst_transform).astype(np.float32)
        inv = np.zeros_like(transforms)
        for i, t in enumerate(transforms):
            r_inv = np.linalg.inv(t[:, :3].astype(np.float64))
            inv[i, :, :3] = r_inv
            inv[i, :, 3] = -r_inv @ t[:, 3].astype(np.float64)
        instances = InstanceTable(
            transform=_t(transforms), inv_transform=_t(inv),
            prev_transform=_t(transforms.copy()),
            uniform_scale=_t(np.asarray(inst_scale, np.float32)))

        # traversal (BVH-permuted) global tri -> blas-wide geometry-order
        # index
        tri_light_local = np.empty(cursor, np.int32)
        for b in range(len(blas_groups)):
            lo = blas_tri_base[b]
            tri_light_local[lo:lo + len(perms[b])] = perms[b].astype(
                np.int32)

        scene = SceneData(
            materials=self._materials_table(mats),
            triangles=triangles,
            units=units,
            instances=instances,
            light_unit_cdf=_t(unit_cdf.astype(np.float32)),
            light_unit_pmf=_t(unit_pmf.astype(np.float32)),
            light_unit_alias_prob=_t(unit_aprob.astype(np.float32)),
            light_unit_alias_idx=_t(unit_aidx.astype(np.int32)),
            total_emissive_importance=torch.tensor(np.float32(total_imp)),
            env=self._env_light(),
            textures=self._textures(),
            inst_unit_base=_t(np.asarray(inst_unit_base, np.int32)),
            unit_tri_base=_t(np.asarray(unit_tri_base, np.int32)),
            tri_light_local=_t(tri_light_local),
            inst_tri_start=_t(np.asarray(
                [blas_tri_base[b] for b in inst_blas], np.int32)),
            inst_tri_count=_t(np.asarray(
                [len(perms[b]) for b in inst_blas], np.int32)),
        )
        return scene, acc


def compute_smooth_normals(positions: np.ndarray,
                           indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals [V, 3] float32 (numpy, on the host)."""
    n = np.zeros_like(positions, dtype=np.float64)
    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    for k in range(3):
        np.add.at(n, indices[:, k], fn)
    return np_normalize(n).astype(np.float32)
