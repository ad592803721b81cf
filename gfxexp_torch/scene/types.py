"""Scene data model: dataclasses of tensors (port of gfxexp_tpu/scene/types.py).

Instances are flattened into world-space "units" (instance x geometry) at
compile time; the light tables keep per-unit windows into flat arrays. A
two-level (instanced) scene keeps object-space BLAS triangles instead and
sets `inst_unit_base` (see SceneData); a flattened scene also keeps an
object-space copy of its triangles for animation (`object_triangles`).
`from_numpy` carries a gfxexp_tpu object (by attribute name, no jax import)
into the port's classes; a scene's displaced geometry comes along.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from gfxexp_torch.core.distributions import (
    Continuous2D,
    ProbabilityTexture,
)
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.core.tensors import from_numpy as _from_numpy

BSDF_LAMBERT = 0
BSDF_DIFFUSE_SPECULAR = 1
BSDF_SIMPLE_PBR = 2


@dataclass
class MaterialTable(TensorData):
    bsdf_type: torch.Tensor  # [M] int32
    diffuse_color: torch.Tensor  # [M, 3]
    specular_f0: torch.Tensor  # [M, 3]
    roughness: torch.Tensor  # [M]
    metallic: torch.Tensor  # [M]
    emittance: torch.Tensor  # [M, 3]
    diffuse_tex: torch.Tensor  # [M] int32, -1 = constant
    emittance_tex: torch.Tensor  # [M] int32
    normal_tex: torch.Tensor  # [M] int32
    normal_map_kind: Optional[torch.Tensor] = None  # [M] int32


@dataclass
class TriangleSoA(TensorData):
    """World-space triangles in traversal order (p0, e1 = p1-p0, e2 = p2-p0)
    with per-corner shading attributes."""

    p0: torch.Tensor  # [T, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor  # [T, 3] unit shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # [T, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    unit_id: torch.Tensor  # [T] int32

    @property
    def count(self):
        return self.p0.shape[0]


@dataclass
class UnitTable(TensorData):
    """Flattened (instance, geometry) pairs with their emissive light
    distributions in light order (units contiguous)."""

    material: torch.Tensor  # [U] int32
    instance: torch.Tensor  # [U] int32
    tri_offset: torch.Tensor  # [U] int32
    tri_count: torch.Tensor  # [U] int32
    light_tri_cdf: torch.Tensor  # [T] per-unit exclusive prefix
    light_tri_index: torch.Tensor  # [T] int32 light order -> traversal id
    light_tri_pmf: torch.Tensor  # [T] indexed by traversal id
    emissive_importance: torch.Tensor  # [U]
    light_tri_alias_prob: Optional[torch.Tensor] = None  # [T]
    light_tri_alias_local: Optional[torch.Tensor] = None  # [T] int32


@dataclass
class InstanceTable(TensorData):
    transform: torch.Tensor  # [I, 3, 4] object -> world
    inv_transform: torch.Tensor  # [I, 3, 4]
    prev_transform: torch.Tensor  # [I, 3, 4]
    uniform_scale: torch.Tensor  # [I]


@dataclass
class EnvLight(TensorData):
    """Lat-long environment light."""

    radiance: torch.Tensor  # [H, W, 3]
    importance: Continuous2D
    power_coeff: torch.Tensor  # []
    rotation: torch.Tensor  # [] radians
    enabled: torch.Tensor  # [] bool


@dataclass
class ObjectTriangles(TensorData):
    """Object-space copy of the triangles in traversal order, kept for
    animation: each frame's world geometry is the instance transforms
    applied to these (scene/animation.py update_world_geometry)."""

    p0: torch.Tensor  # [T, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    instance: torch.Tensor  # [T] int32 owning instance


@dataclass
class SceneData(TensorData):
    """Everything the device code needs for one frame."""

    materials: MaterialTable
    triangles: TriangleSoA
    units: UnitTable
    instances: InstanceTable
    light_unit_cdf: torch.Tensor  # [U+1]
    light_unit_pmf: torch.Tensor  # [U]
    total_emissive_importance: torch.Tensor  # []
    env: Optional[EnvLight] = None
    # flattened scenes (compile()): object-space triangles for animation
    object_triangles: Optional[ObjectTriangles] = None
    # scene/textures.py TextureAtlas, None when the scene has no texture
    textures: Optional[TensorData] = None
    light_unit_alias_prob: Optional[torch.Tensor] = None  # [U]
    light_unit_alias_idx: Optional[torch.Tensor] = None  # [U] int32
    # the units' weights laid row-major into an S x S probability texture
    # (compile(use_probability_texture=True)): unit selection by quad
    # descent instead of the alias table
    light_unit_probtex: Optional[ProbabilityTexture] = None
    # two-level (instanced) scenes (compile_scene(traversal="instanced")):
    # `triangles` holds OBJECT-space BLAS triangles shared by the instances
    # (unit_id = local geometry index within the BLAS group), hits carry an
    # instance, and unit = inst_unit_base[inst] + triangles.unit_id[tri].
    inst_unit_base: Optional[torch.Tensor] = None  # [I] int32
    # light-order position of (unit u, traversal tri t) =
    #   units.tri_offset[u] + tri_light_local[t] - unit_tri_base[u]
    unit_tri_base: Optional[torch.Tensor] = None  # [U] int32
    tri_light_local: Optional[torch.Tensor] = None  # [T] int32
    # the traversal-order triangle range of each instance's BLAS
    inst_tri_start: Optional[torch.Tensor] = None  # [I] int32
    inst_tri_count: Optional[torch.Tensor] = None  # [I] int32
    # displaced geometry traced beside the triangles (TFDMGeometry,
    # NRTDSMGeometry, ShellGeometry, CurveSegments, CurveSpans: the path
    # tracer's displaced hooks), flattened scenes only; None without any
    displaced: Optional[tuple] = None

    @property
    def is_instanced(self):
        return self.inst_unit_base is not None

    @property
    def num_triangles(self):
        return self.triangles.count

    @property
    def num_units(self):
        return self.units.material.shape[0]

    @property
    def has_emissive(self):
        """Bool tensor [] on the scene's device (no host sync)."""
        return self.total_emissive_importance > 0.0


def world_bounds(scene: SceneData):
    """The world-space AABB of the scene's triangles, (lo [3], hi [3])
    float32 numpy, on the host. A two-level scene's BLAS triangles go
    through the transform of each instance that places them."""
    tris = scene.triangles
    p0 = tris.p0.cpu().numpy()
    p1 = p0 + tris.e1.cpu().numpy()
    p2 = p0 + tris.e2.cpu().numpy()
    if not scene.is_instanced:
        lo = np.minimum(np.minimum(p0.min(0), p1.min(0)), p2.min(0))
        hi = np.maximum(np.maximum(p0.max(0), p1.max(0)), p2.max(0))
        return lo, hi
    if scene.inst_tri_start is None:
        raise ValueError("a two-level scene needs inst_tri_start and "
                         "inst_tri_count (SceneBuilder.compile_instanced) "
                         "for its world bounds")
    m = scene.instances.transform.cpu().numpy().astype(np.float64)
    start = scene.inst_tri_start.cpu().numpy()
    count = scene.inst_tri_count.cpu().numpy()
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for i in range(m.shape[0]):
        sl = slice(int(start[i]), int(start[i] + count[i]))
        v = np.concatenate([p0[sl], p1[sl], p2[sl]]).astype(np.float64)
        v = v @ m[i, :, :3].T + m[i, :, 3]
        lo = np.minimum(lo, v.min(0))
        hi = np.maximum(hi, v.max(0))
    return lo.astype(np.float32), hi.astype(np.float32)


def from_numpy(obj):
    """gfxexp_tpu object (SceneData, its tables, Camera, WideRowBVH one table
    or chunked, QRowBVH, InstancedAccel, a displaced geometry, ...) -> the
    port's object on the CPU. Reads fields by attribute name; fields the
    port does not model are ignored. Textures, the probability texture and
    a scene's displaced geometry (TFDM and NRTDSM meshes with their prism
    BVHs, shells with their contents' triangles and skip links, curve
    segments and spans) come along."""
    # containers register on import; make sure the ones outside this module
    # are known
    import gfxexp_torch.accel.instanced  # noqa: F401
    import gfxexp_torch.accel.qrow  # noqa: F401
    import gfxexp_torch.accel.widerow  # noqa: F401
    import gfxexp_torch.core.curves  # noqa: F401
    import gfxexp_torch.render.camera  # noqa: F401
    import gfxexp_torch.scene.textures  # noqa: F401

    convert = _displaced_from_numpy(obj)
    if convert is not None:
        return convert
    displaced = getattr(obj, "displaced", None)
    if not displaced:
        return _from_numpy(obj)
    out = tuple(_displaced_from_numpy(g) for g in displaced)
    for g, o in zip(displaced, out):
        if o is None:
            raise TypeError(f"no displaced geometry {type(g).__name__} in "
                            f"the port")
    return replace(_from_numpy(obj.replace(displaced=None)), displaced=out)


def _displaced_from_numpy(g):
    """The port's counterpart of one gfxexp_tpu displaced geometry, or None
    when `g` is none of them."""
    from gfxexp_torch.techniques.nrtdsm import nrtdsm_from_numpy
    from gfxexp_torch.techniques.shell import shell_from_numpy
    from gfxexp_torch.techniques.tfdm import tfdm_from_numpy

    convert = {"TFDMGeometry": tfdm_from_numpy,
               "NRTDSMGeometry": nrtdsm_from_numpy,
               "ShellGeometry": shell_from_numpy,
               "CurveSegments": _from_numpy,
               "CurveSpans": _from_numpy}.get(type(g).__name__)
    return None if convert is None else convert(g)


def regir_state_from_numpy(obj):
    """gfxexp_tpu's ReGIRState or GridInfo (numpy or JAX arrays, read by
    attribute name) -> the port's (techniques/regir.py) on the CPU."""
    import gfxexp_torch.techniques.regir  # noqa: F401  (registers them)

    if type(obj).__name__ not in ("ReGIRState", "GridInfo"):
        raise TypeError(f"expected a ReGIRState or a GridInfo, got "
                        f"{type(obj).__name__}")
    return _from_numpy(obj)
