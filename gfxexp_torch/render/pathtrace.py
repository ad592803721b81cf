"""Wavefront path tracer: NEE + implicit-hit MIS (power heuristic) + Russian
roulette, progressive accumulation (port of gfxexp_tpu/render/pathtrace.py).

All paths advance one vertex at a time over SoA tensors with masked lanes.
The RNG is counter-based and keyed by (pixel, sample, stream), with the JAX
package's call order, so both packages draw the same numbers for the same
path vertex: camera jitter on stream 0xFFFF; per bounce (stream = bounce)
u_rr (not on the first bounce, not on the collect-only last one), then
u_light, u0, u1 for NEE, then u0, u1 for the BSDF.

Options are decided on the host: the debug switches are a Python int, and
the texture, bump and LOD branches are taken only when the scene has
texture layers, so the default path launches no kernel for them. With
`fuse_shadow_rays` each bounce's closest-hit rays and the previous
bounce's shadow rays go through one closest-hit walk of 2N lanes.

The default NEE leaves each bounce's term and shadow ray to the next
bounce: its walks trace the shadow rays (an any-hit walk, or inside the
closest-hit walk), and its shading adds the unoccluded terms before its
own emission, the order of sums of tracing them at once. Where
shade_kernel_admits takes a call (one level, no texture layers, displaced
geometry or environment, the default NEE and ray order), a bounce's
shading is shade_bounce: one CUDA kernel on the card
(csrc/shade_bounce.cu), whose plain version, _shade_bounce_plain, shades
every other call and every call on the CPU.

A scene's displaced geometry (SceneData.displaced: TFDM and NRTDSM meshes,
shells, direct curves; techniques/, core/curves.py) is traced after the
triangle walk with its hit distance as tmax, and their
hits replace the triangle hit's position, normals, texcoord, tangent,
material and emittance; with `displaced_shadows` the shadow rays test them
too. `fuse_shadow_rays` is ignored on such scenes. A scene without them
takes none of these branches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gfxexp_torch.accel.traverse import (
    HitInfo,
    intersect_any,
    intersect_closest,
    walk_library,
)
from gfxexp_torch.core.math import (
    cross,
    dot,
    length,
    luminance,
    make_frame,
    normalize,
    offset_ray_origin,
    rotate,
    to_local,
    to_world,
)
from gfxexp_torch.core.rng import SampleStream, _as_i32
from gfxexp_torch.core.tensors import TensorData
from gfxexp_torch.render.bsdf import (
    bsdf_evaluate,
    bsdf_pdf,
    bsdf_sample,
    material_params_textured,
)
from gfxexp_torch.render.camera import (
    Camera,
    generate_rays_for_lanes,
    lane_from_pixel,
    pixel_from_lane,
)
from gfxexp_torch.scene.lights import (
    env_pdf,
    env_radiance,
    light_selection_probs,
    pack_light_rows,
    sample_light,
    sample_light_solid_angle,
    surface_light_pdf,
)
from gfxexp_torch.scene.textures import (
    apply_bump,
    decode_normal_map,
    normal_from_height_map,
    sample_bilinear,
)
from gfxexp_torch.scene.types import SceneData
from gfxexp_torch.utils import trace

_PI = float(np.pi)


@dataclasses.dataclass(frozen=True)
class PTConfig:
    """Integrator configuration: the fields and defaults of gfxexp_tpu's
    PTConfig. `sort_secondary_rays` sorts each bounce's closest-hit rays
    by direction octant (dead lanes last) before the walk;
    `compact_rays` partitions the lanes alive-first at each bounce after
    the first; both leave the image bit-identical (the RNG is keyed by
    pixel). `displaced_shadows` traces shadow rays against the scene's
    displaced meshes too. `texture_lod` needs an atlas with mips
    (SceneBuilder(texture_mips=True)); `fuse_shadow_rays` is ignored with
    a custom `nee_fn`, on scenes with displaced meshes, and with ray
    sorting or compaction."""

    max_path_length: int = 5
    enable_jitter: bool = True
    enable_env: bool = True
    use_implicit_light_sampling: bool = True
    use_explicit_light_sampling: bool = True
    russian_roulette: bool = True
    count_rays: bool = False
    enable_bump_mapping: bool = False
    sort_secondary_rays: bool = False
    compact_rays: bool = False
    use_solid_angle_sampling: bool = False
    mollify_specular: bool = False
    displaced_shadows: bool = True
    texture_lod: bool = False
    fuse_shadow_rays: bool = False

    @property
    def use_mis(self):
        return (self.use_implicit_light_sampling
                and self.use_explicit_light_sampling)


@dataclass(frozen=True)
class DebugSwitches:
    """The 8 debug switches, decided on the host from a bitfield: bit 0 no
    NEE, 1 no implicit or env emission past the primary hit, 2 no Russian
    roulette, 3 no environment light (implicit and NEE), 4 no bump or
    normal mapping, 5 no pixel jitter, 6 white albedo (0.8 diffuse), 7
    shade with the geometric normal."""

    no_nee: bool = False
    no_implicit: bool = False
    no_rr: bool = False
    no_env: bool = False
    no_bump: bool = False
    no_jitter: bool = False
    white_albedo: bool = False
    geom_normal: bool = False

    @classmethod
    def from_bits(cls, bits) -> "DebugSwitches":
        """From None, an int or a 0-d tensor (read once, on the host)."""
        sw = 0 if bits is None else int(bits)
        return cls(*(bool(sw >> i & 1) for i in range(8)))


def has_textures(scene: SceneData) -> bool:
    return scene.textures is not None and scene.textures.count > 0


@dataclass
class SurfacePoint(TensorData):
    position: torch.Tensor  # [R, 3]
    geom_normal: torch.Tensor  # [R, 3]
    shading_normal: torch.Tensor  # [R, 3]
    texcoord: torch.Tensor  # [R, 2]
    tangent: torch.Tensor  # [R, 3]
    unit: torch.Tensor  # [R] int64
    material: torch.Tensor  # [R] int64
    emittance: torch.Tensor  # [R, 3]
    # sqrt(uv area / world area): texels per world unit, for the mip LOD
    texel_density: Optional[torch.Tensor] = None  # [R]


def pack_tri_attrs(tris, scene: SceneData = None) -> torch.Tensor:
    """[T, 27] per-triangle shading rows, so a surface point is one row
    gather: p0 e1 e2 n0 n1 n2 (0:18) uv0 uv1 uv2 (18:24), bitcast unit id
    (24), hypothetical NEE area pdf (25, when `scene` is given and is not
    instanced; a two-level scene's pdf depends on the instance), texel
    density (26)."""
    cols = [tris.p0, tris.e1, tris.e2, tris.n0, tris.n1, tris.n2,
            tris.uv0, tris.uv1, tris.uv2,
            tris.unit_id.to(torch.int32).view(torch.float32)[:, None]]
    cr_len = length(cross(tris.e1, tris.e2))
    if scene is not None and not scene.is_instanced:
        rec_area = 2.0 / torch.clamp(cr_len, min=1e-20)
        pdf = (scene.light_unit_pmf[tris.unit_id.to(torch.int64)]
               * scene.units.light_tri_pmf * rec_area)
        cols.append(pdf[:, None])
    else:
        cols.append(torch.zeros_like(cr_len)[:, None])
    duv1 = tris.uv1 - tris.uv0
    duv2 = tris.uv2 - tris.uv0
    uv_det = torch.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    cols.append(torch.sqrt(uv_det / torch.clamp(cr_len, min=1e-20))[:, None])
    return torch.cat(cols, dim=1)


def compute_surface_point(scene: SceneData, tri_idx, u, v, inst=None,
                          packed=None) -> SurfacePoint:
    """Hit attributes from one packed-row gather (missed lanes gather row 0
    and are masked out by the caller). In a two-level scene the triangle is
    in object space and `inst` [R] (the hit instance) brings it into world
    space; normals go through the inverse transpose. An emissive texture
    replaces the material's emittance where it is set."""
    tri_idx = torch.clamp(tri_idx.to(torch.int64), min=0)
    if packed is None:
        packed = pack_tri_attrs(scene.triangles)
    rows = packed[tri_idx]
    p0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    if scene.is_instanced:
        insti = torch.clamp(inst.to(torch.int64), min=0)
        m = scene.instances.transform[insti]
        p0 = rotate(m, p0) + m[:, :, 3]
        e1 = rotate(m, e1)
        e2 = rotate(m, e2)
    u1, v1 = u[..., None], v[..., None]
    position = p0 + u1 * e1 + v1 * e2
    gn = normalize(cross(e1, e2))
    w1 = (1.0 - u - v)[..., None]
    sn = w1 * rows[:, 9:12] + u1 * rows[:, 12:15] + v1 * rows[:, 15:18]
    if scene.is_instanced:
        ninv = scene.instances.inv_transform[insti][:, :, :3]
        sn = (ninv * sn[:, :, None]).sum(1)
    sn = normalize(sn)
    uv0, uv1, uv2 = rows[:, 18:20], rows[:, 20:22], rows[:, 22:24]
    tc = w1 * uv0 + u1 * uv1 + v1 * uv2
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    tan = duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2
    fallback, _ = make_frame(sn)
    tan = torch.where((torch.abs(det) < 1e-12)[..., None], fallback, tan)
    tan = normalize(tan - dot(tan, sn, keepdim=True) * sn)
    unit = rows[:, 24].contiguous().view(torch.int32).to(torch.int64)
    if scene.is_instanced:
        unit = scene.inst_unit_base[insti].to(torch.int64) + unit
    mat = scene.units.material[unit].to(torch.int64)
    emit = scene.materials.emittance[mat]
    if has_textures(scene):
        etid = scene.materials.emittance_tex[mat]
        etex = sample_bilinear(scene.textures, etid, tc)
        emit = torch.where((etid >= 0)[:, None], etex[:, :3], emit)
    return SurfacePoint(
        position=position, geom_normal=gn, shading_normal=sn, texcoord=tc,
        tangent=tan, unit=unit, material=mat, emittance=emit,
        texel_density=rows[:, 26] if has_textures(scene) else None)


def _next_event_setup(scene, sp: SurfacePoint, v_out_local, frame, params,
                      rs, cfg: PTConfig, alive=None, light_packed=None,
                      env_off: bool = False):
    """NEE without the occlusion trace: light sample, MIS weight,
    unshadowed contribution and the shadow ray. Returns (contrib [R, 3],
    shadow_dir [R, 3], shadow_tmax [R]); shadow_tmax < 0 on lanes that
    cannot contribute (the walk skips them). `env_off` drops environment
    samples (debug switch bit 3)."""
    t, b, n = frame
    u_light = rs.next()
    u0, u1 = rs.next2()
    if cfg.use_solid_angle_sampling:
        ls = sample_light_solid_angle(scene, sp.position, u_light, u0, u1)
    else:
        ls = sample_light(scene, u_light, u0, u1, light_packed)

    inf3 = ls.at_infinity[..., None]
    shadow_vec = torch.where(inf3, ls.position, ls.position - sp.position)
    dist2 = torch.clamp(dot(shadow_vec, shadow_vec), min=1e-12)
    dist = torch.sqrt(dist2)
    shadow_dir = shadow_vec / dist[..., None]
    v_in_local = to_local(t, b, n, shadow_dir)

    lp_cos = dot(-shadow_dir, ls.normal)
    sp_cos = v_in_local[..., 2]

    if cfg.use_mis:
        bsdf_p = (bsdf_pdf(params, v_out_local, v_in_local)
                  * torch.abs(lp_cos) / dist2)
        bsdf_p = torch.where(torch.isfinite(bsdf_p), bsdf_p, 0.0)
        light_p = ls.pdf
        mis = torch.where(
            light_p > 0.0,
            light_p ** 2 / torch.clamp(bsdf_p ** 2 + light_p ** 2, min=1e-30),
            0.0)
    else:
        mis = torch.ones_like(ls.pdf)

    potential = (ls.pdf > 0.0) & (lp_cos > 0.0)
    if alive is not None:
        potential = potential & alive
    if env_off and scene.env is not None:
        potential = potential & ~ls.at_infinity
    # the reference traces with tmax = 0.9999 dist (env: 1e10)
    shadow_tmax = torch.where(ls.at_infinity, 1e10, dist * 0.9999)
    shadow_tmax = torch.where(potential, shadow_tmax, -1.0)

    le = ls.emittance / _PI  # diffuse emitter
    f_val = bsdf_evaluate(params, v_out_local, v_in_local)
    g = lp_cos * torch.abs(sp_cos) / dist2
    g = torch.where(ls.at_infinity, torch.abs(sp_cos), g)
    contrib = f_val * le * (g * mis / torch.clamp(ls.pdf, min=1e-30))[..., None]
    contrib = torch.where(potential[..., None], contrib, 0.0)
    return contrib, shadow_dir, shadow_tmax


def _displaced_hit(g, o, d, tmax):
    """The closest hit of rays against one displaced geometry, clipped to
    tmax, and the material of each ray's hit: TFDM, curve segments and
    spans, shells (a material a content triangle) and NRTDSM (the exact
    intersector on the two-triangle surface, else v2)."""
    from gfxexp_torch.core.curves import (
        CurveSegments,
        CurveSpans,
        intersect_curve_segments,
        intersect_curve_spans,
    )
    from gfxexp_torch.techniques.nrtdsm import (
        intersect_nrtdsm_exact,
        intersect_nrtdsm_v2,
    )
    from gfxexp_torch.techniques.shell import ShellGeometry, intersect_shell
    from gfxexp_torch.techniques.tfdm import (
        LOCAL_INTERSECTION_TWO_TRIANGLE,
        TFDMGeometry,
        intersect_tfdm_v2,
    )

    if isinstance(g, ShellGeometry):
        dh = intersect_shell(g, o, d, t_min=1e-4, t_max=tmax)
        return dh, dh.mat
    if isinstance(g, TFDMGeometry):
        fn = intersect_tfdm_v2
    elif isinstance(g, CurveSegments):
        fn = intersect_curve_segments
    elif isinstance(g, CurveSpans):
        fn = intersect_curve_spans
    elif (g.params.local_intersection_type
          == LOCAL_INTERSECTION_TWO_TRIANGLE):
        fn = intersect_nrtdsm_exact
    else:
        fn = intersect_nrtdsm_v2
    dh = fn(g, o, d, t_min=1e-4, t_max=tmax)
    return dh, torch.full_like(dh.prim, g.material)


def _displaced_closest(scene: SceneData, ray_o, ray_d, tmax):
    """Closest hit against the scene's displaced geometry, each clipped to
    `tmax` [R] (the triangle hit's distance; < 0 on dead lanes), composited
    by distance: (t, hit, position, normal, uv, material) [R, ...]."""
    best = None
    for g in scene.displaced:
        dh, mat = _displaced_hit(g, ray_o, ray_d, tmax)
        if best is None:
            best = (dh.t, dh.hit, dh.position, dh.normal, dh.uv, mat)
        else:
            take = dh.hit & (dh.t < best[0])
            t3 = take[:, None]
            best = (torch.where(take, dh.t, best[0]), best[1] | dh.hit,
                    torch.where(t3, dh.position, best[2]),
                    torch.where(t3, dh.normal, best[3]),
                    torch.where(t3, dh.uv, best[4]),
                    torch.where(take, mat, best[5]))
    return best


def _displaced_occluded(scene: SceneData, o, d, tmax):
    """Any hit of shadow rays against the scene's displaced geometry [R]."""
    occ = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    for g in scene.displaced:
        occ = occ | _displaced_hit(g, o, d, tmax)[0].hit
    return occ


def _next_event(scene, bvh, sp: SurfacePoint, v_out_local, frame, params, rs,
                cfg: PTConfig, alive=None, light_packed=None,
                env_off: bool = False):
    """NEE with MIS: [R, 3] contribution after the any-hit shadow query
    (against the displaced meshes too, with cfg.displaced_shadows)."""
    contrib, shadow_dir, shadow_tmax = _next_event_setup(
        scene, sp, v_out_local, frame, params, rs, cfg, alive, light_packed,
        env_off)
    occluded = intersect_any(bvh, scene.triangles, sp.position, shadow_dir,
                             t_min=0.0, t_max=shadow_tmax)
    if scene.displaced and cfg.displaced_shadows:
        occluded = occluded | _displaced_occluded(scene, sp.position,
                                                  shadow_dir, shadow_tmax)
    return torch.where(occluded[..., None], 0.0, contrib)


def _intersect_closest_sorted(bvh, tris, ray_o, ray_d, alive):
    """Closest hit with the rays sorted by direction octant, dead lanes
    last with tmax < 0 (no walk work), and the hits put back in lane order:
    one stable argsort and the gathers."""
    key = ((ray_d[:, 0] >= 0).to(torch.int64)
           + 2 * (ray_d[:, 1] >= 0).to(torch.int64)
           + 4 * (ray_d[:, 2] >= 0).to(torch.int64))
    key = torch.where(alive, key, 8)
    perm = torch.argsort(key, stable=True)
    inv = torch.argsort(perm, stable=True)
    t_max = torch.where(alive[perm], 1e30, -1.0)
    hit = intersect_closest(bvh, tris, ray_o[perm], ray_d[perm], t_min=0.0,
                            t_max=t_max)
    return HitInfo(t=hit.t[inv], tri=hit.tri[inv], u=hit.u[inv],
                   v=hit.v[inv], hit=hit.hit[inv],
                   inst=None if hit.inst is None else hit.inst[inv])


def _alive_first(alive):
    """The stable alive-first order of the lanes [R] (JAX's cumsum
    partition and scatter)."""
    n = alive.shape[0]
    a = alive.to(torch.int64)
    n_alive = torch.cumsum(a, 0)
    pos = torch.where(alive, n_alive - 1,
                      n_alive[-1] + torch.cumsum(1 - a, 0) - 1)
    return torch.zeros(n, dtype=torch.int64, device=alive.device).scatter_(
        0, pos, torch.arange(n, device=alive.device))


def _bump_normal(scene: SceneData, sp: SurfacePoint, nrm):
    """The shading normal rotated by the material's normal texture: a
    3-channel or 2-channel normal map or a height map, by the material's
    normal_map_kind (0, 1, 2); lanes without a normal texture keep `nrm`."""
    atlas = scene.textures
    ntid = scene.materials.normal_tex[sp.material]
    texel = sample_bilinear(atlas, ntid, sp.texcoord)
    if scene.materials.normal_map_kind is not None:
        kind = scene.materials.normal_map_kind[sp.material]
    else:
        kind = torch.zeros_like(ntid)
    n3 = decode_normal_map(texel)
    n2 = decode_normal_map(texel, two_channel=True)
    nh = normal_from_height_map(atlas, ntid, sp.texcoord)
    local_n = torch.where((kind == 2)[:, None], nh,
                          torch.where((kind == 1)[:, None], n2, n3))
    bumped = normalize(apply_bump(nrm, sp.tangent, cross(nrm, sp.tangent),
                                  local_n))
    return torch.where((ntid < 0)[:, None], nrm, bumped)


def shade_kernel_admits(scene: SceneData, cfg: PTConfig, nee_fn=None) -> bool:
    """Whether render_lanes shades its bounces with shade_bounce
    (csrc/shade_bounce.cu on the card) rather than _shade_bounce_plain: a
    single-level scene without texture layers, displaced geometry,
    environment or light-unit probability texture, the default next-event
    estimation, and none of ray sorting, compaction, solid-angle light
    sampling or fused shadow rays. It reads the scene and the
    configuration only."""
    return (not scene.is_instanced and not has_textures(scene)
            and not scene.displaced and scene.env is None
            and scene.light_unit_probtex is None and nee_fn is None
            and not cfg.sort_secondary_rays and not cfg.compact_rays
            and not cfg.use_solid_angle_sampling
            and not cfg.fuse_shadow_rays and cfg.max_path_length >= 1)


@dataclass
class _Setting:
    """What every bounce of one render_lanes call reads besides the
    lanes."""

    scene: SceneData
    bvh: object
    cfg: PTConfig
    dbg: DebugSwitches
    sample_idx: int
    tri_packed: torch.Tensor  # pack_tri_attrs
    light_packed: Optional[torch.Tensor]  # pack_light_rows
    p_env_sel: torch.Tensor
    p_surf_sel: torch.Tensor
    use_env: bool
    bump: bool
    lod_texels: Optional[torch.Tensor]
    nee_fn: object
    # the shadow rays join the next bounce's closest-hit walk
    fuse: bool


@dataclass
class _Lanes:
    """The lanes' state, carried from bounce to bounce."""

    pixel: torch.Tensor  # [N] int64
    ray_o: torch.Tensor  # [N, 3]
    ray_d: torch.Tensor  # [N, 3]
    throughput: torch.Tensor  # [N, 3]
    alive: torch.Tensor  # [N] bool
    prev_pdf: torch.Tensor  # [N]
    contribution: torch.Tensor  # [N, 3]
    rays_traced: torch.Tensor  # []
    nee_aux: object = None
    # the NEE term a bounce leaves to the next bounce's walk: (contribution
    # with throughput and gates applied, shadow origins, directions, tmax <
    # 0 = none)
    pending: Optional[tuple] = None
    # each lane's first lane (compaction permutes the lanes)
    lane_ids: Optional[torch.Tensor] = None
    # the shading kernel's output buffers, made at bounce 1
    buffers: Optional[dict] = None


def _trace(s: _Setting, st: _Lanes, first: bool):
    """A bounce's walks: the previous bounce's shadow rays (an any-hit
    walk, or with s.fuse inside the closest-hit walk), then the closest-hit
    walk (after compaction, sorted, against the displaced geometry).
    Returns (hit, occluded [N] of st.pending or None, displaced hits:
    None or (hits, lanes they replace))."""
    scene, cfg = s.scene, s.cfg
    n = st.alive.shape[0]
    occluded = None
    if st.pending is not None and not s.fuse:
        _, p_o, p_d, p_tmax = st.pending
        occluded = intersect_any(s.bvh, scene.triangles, p_o, p_d, t_min=0.0,
                                 t_max=p_tmax)
        if scene.displaced and cfg.displaced_shadows:
            occluded = occluded | _displaced_occluded(scene, p_o, p_d, p_tmax)
    if cfg.compact_rays and not first:
        # dead lanes gather at the end, whole rows of them leave the walks
        # at once; every lane keeps its pixel's random numbers
        order = _alive_first(st.alive)
        for f in ("ray_o", "ray_d", "throughput", "alive", "prev_pdf",
                  "contribution", "pixel", "lane_ids"):
            setattr(st, f, getattr(st, f)[order])
        if occluded is not None:
            occluded = occluded[order]
            st.pending = tuple(x[order] for x in st.pending)
    if cfg.count_rays:
        st.rays_traced = st.rays_traced + st.alive.sum().to(torch.float32)
    # dead lanes trace with tmax < 0: no traversal work
    tmax = torch.where(st.alive, 1e30, -1.0)
    if st.pending is not None and s.fuse:
        # one closest-hit walk over this bounce's rays and the previous
        # bounce's shadow rays
        _, p_o, p_d, p_tmax = st.pending
        bh = intersect_closest(s.bvh, scene.triangles,
                               torch.cat([st.ray_o, p_o]),
                               torch.cat([st.ray_d, p_d]), t_min=0.0,
                               t_max=torch.cat([tmax, p_tmax]))
        hit = HitInfo(t=bh.t[:n], tri=bh.tri[:n], u=bh.u[:n], v=bh.v[:n],
                      hit=bh.hit[:n],
                      inst=None if bh.inst is None else bh.inst[:n])
        occluded = bh.hit[n:]
    elif cfg.sort_secondary_rays and not first and not scene.displaced:
        hit = _intersect_closest_sorted(s.bvh, scene.triangles, st.ray_o,
                                        st.ray_d, st.alive)
    else:
        hit = intersect_closest(s.bvh, scene.triangles, st.ray_o, st.ray_d,
                                t_min=0.0, t_max=tmax)
    if not scene.displaced:
        return hit, occluded, None
    # the displaced hits are clipped by the triangle hit's t, so a reported
    # one is the nearer
    disp = _displaced_closest(scene, st.ray_o, st.ray_d,
                              torch.where(st.alive, hit.t, -1.0))
    d_take = st.alive & disp[1]
    hit = dataclasses.replace(hit, t=torch.where(d_take, disp[0], hit.t),
                              hit=hit.hit | d_take)
    return hit, occluded, (disp, d_take)


def _shade_bounce_plain(s: _Setting, st: _Lanes, hit: HitInfo, bounce: int,
                        first: bool, collect_only: bool, occluded=None,
                        disp=None):
    """The stages .surface, .bsdf and .nee of one bounce after its walks,
    updating `st`: the previous bounce's NEE term (st.pending) where
    `occluded` [N] is False, the environment and emitter hits, Russian
    roulette, the BSDF, next-event estimation (the default one leaves its
    term and shadow ray in st.pending for the next bounce's walk) and the
    next ray. `disp`: the displaced hits and the lanes they replace (from
    _trace). The plain version of csrc/shade_bounce.cu (shade_bounce)."""
    scene, cfg, dbg = s.scene, s.cfg, s.dbg
    dev = st.alive.device
    n = st.alive.shape[0]
    name = f"gfx.pathtrace.bounce{bounce}"
    rs = SampleStream(st.pixel, s.sample_idx, stream=bounce)
    ray_d, alive, throughput = st.ray_d, st.alive, st.throughput
    if occluded is not None:
        # the previous bounce's NEE term, where its shadow ray is
        # unoccluded: before this bounce's emission, the order of sums of
        # tracing it at once
        st.contribution = st.contribution + torch.where(
            occluded[..., None], 0.0, st.pending[0])
    st.pending = None

    with trace.span(name + ".surface"):
        hit_ok = alive & hit.hit
        miss = alive & ~hit.hit
        emission = cfg.use_implicit_light_sampling or first
        if not first and dbg.no_implicit:
            emission = False

        # ---- miss: environment ------------------------------------------
        if s.use_env and emission:
            env_l = env_radiance(scene.env, ray_d)
            if first or not cfg.use_mis:
                env_mis = torch.ones(n, device=dev)
            else:
                light_p = s.p_env_sel * env_pdf(scene.env, ray_d)
                env_mis = st.prev_pdf ** 2 / torch.clamp(
                    st.prev_pdf ** 2 + light_p ** 2, min=1e-30)
            st.contribution = st.contribution + torch.where(
                miss[..., None], throughput * env_l * env_mis[..., None],
                0.0)

        sp = compute_surface_point(scene, hit.tri, hit.u, hit.v,
                                   inst=hit.inst, packed=s.tri_packed)
        if disp is not None:
            (_, _, d_pos, d_nrm, d_uv, d_mat), d_take = disp
            d3 = d_take[:, None]
            d_mat = d_mat.to(torch.int64)
            sp = dataclasses.replace(
                sp, position=torch.where(d3, d_pos, sp.position),
                geom_normal=torch.where(d3, d_nrm, sp.geom_normal),
                shading_normal=torch.where(d3, d_nrm, sp.shading_normal),
                texcoord=torch.where(d3, d_uv, sp.texcoord),
                tangent=torch.where(d3, make_frame(d_nrm)[0], sp.tangent),
                material=torch.where(d_take, d_mat, sp.material),
                emittance=torch.where(
                    d3, scene.materials.emittance[d_mat], sp.emittance))
        v_out = -ray_d
        front = dot(v_out, sp.geom_normal) >= 0.0
        gn_signed = torch.where(front[..., None], sp.geom_normal,
                                -sp.geom_normal)
        pos_off = offset_ray_origin(sp.position, gn_signed)
        nrm = sp.shading_normal
        if s.bump:
            nrm = _bump_normal(scene, sp, nrm)
        if dbg.geom_normal:
            nrm = gn_signed
        t, b = make_frame(nrm)
        v_out_local = to_local(t, b, nrm, v_out)

        # ---- implicit emitter hit ---------------------------------------
        if emission:
            emissive = ((sp.emittance > 0.0).any(dim=-1)
                        & (v_out_local[..., 2] > 0.0))
            if first or not cfg.use_mis:
                mis_w = torch.ones(n, device=dev)
            else:
                dist2 = torch.clamp(hit.t ** 2, min=1e-12)
                tri = torch.clamp(hit.tri.to(torch.int64), min=0)
                if scene.is_instanced:
                    hyp_area = surface_light_pdf(scene, tri, inst=hit.inst)
                else:
                    hyp_area = s.tri_packed[tri, 25]
                light_p = (s.p_surf_sel * hyp_area * dist2
                           / torch.clamp(v_out_local[..., 2], min=1e-6))
                mis_w = st.prev_pdf ** 2 / torch.clamp(
                    st.prev_pdf ** 2 + light_p ** 2, min=1e-30)
            gate = hit_ok & emissive
            st.contribution = st.contribution + torch.where(
                gate[..., None],
                throughput * sp.emittance * (mis_w / _PI)[..., None], 0.0)

        alive = st.alive = hit_ok
    if collect_only:
        return

    with trace.span(name + ".bsdf"):
        # ---- Russian roulette (skipped where it cannot change the image)
        if cfg.russian_roulette and not first:
            if dbg.no_rr:
                # continuation probability 1: the draw is consumed, and
                # u < 1 keeps every lane
                rs.skip(1)
            else:
                cont_prob = torch.clamp(luminance(throughput), max=1.0)
                u_rr = rs.next()
                alive = alive & (u_rr < cont_prob)
                throughput = throughput / torch.clamp(
                    cont_prob, min=1e-8)[..., None]

        # ---- the BSDF at the hit ----------------------------------------
        lod = None
        if s.lod_texels is not None:
            cosg = torch.abs(dot(v_out, sp.geom_normal))
            footprint = hit.t * s.lod_texels / torch.clamp(cosg, min=0.1)
            lod = torch.log2(torch.clamp(footprint * sp.texel_density,
                                         min=1.0))
        params = material_params_textured(scene.materials, scene.textures,
                                          sp.material, sp.texcoord, lod=lod)
        if cfg.mollify_specular and not first:
            params.roughness = 1.0 - 0.5 * (1.0 - params.roughness)
        if dbg.white_albedo:
            params.diffuse = torch.full_like(params.diffuse, 0.8)

    with trace.span(name + ".nee"):
        sp_off = dataclasses.replace(sp, position=pos_off)
        if cfg.use_explicit_light_sampling:
            if cfg.count_rays:
                st.rays_traced = (st.rays_traced
                                  + alive.sum().to(torch.float32))
            frame = (t, b, nrm)
            if s.nee_fn is not None:
                nee, st.nee_aux = s.nee_fn(scene, s.bvh, sp_off, v_out_local,
                                           frame, params, rs, cfg, alive,
                                           st.nee_aux)
                if not dbg.no_nee:
                    st.contribution = st.contribution + torch.where(
                        alive[..., None], throughput * nee, 0.0)
            elif dbg.no_nee:
                rs.skip(3)  # u_light, u0, u1
            else:
                # the shadow ray goes to the next bounce's walk; throughput
                # and gates fold into its contribution now (its tmax is
                # already < 0 on dead lanes)
                nee_c, sdir, stmax = _next_event_setup(
                    scene, sp_off, v_out_local, frame, params, rs, cfg,
                    alive, s.light_packed, dbg.no_env)
                st.pending = (torch.where(alive[..., None],
                                          throughput * nee_c, 0.0),
                              pos_off, sdir, stmax)

    with trace.span(name + ".bsdf"):
        # ---- next direction ---------------------------------------------
        u0, u1 = rs.next2()
        v_in_local, f_val, pdf = bsdf_sample(params, v_out_local, u0, u1)
        valid = (pdf > 0.0) & torch.isfinite(pdf)
        thr = f_val * (torch.abs(v_in_local[..., 2])
                       / torch.clamp(pdf, min=1e-30))[..., None]
        st.throughput = torch.where((alive & valid)[..., None],
                                    throughput * thr, throughput)
        st.alive = alive & valid
        st.ray_o = pos_off
        st.ray_d = normalize(to_world(t, b, nrm, v_in_local))
        st.prev_pdf = pdf


# the kernel's per-launch switches (csrc/shade_bounce.cu, enum k*)
_SHADE_FLAGS = {name: 1 << i for i, name in enumerate((
    "first", "collect_only", "emission", "mis", "roulette", "no_rr",
    "explicit", "no_nee", "mollify", "white", "geom_normal", "pending",
    "count", "alias_units", "alias_tris"))}

_SHADE_INTS = ("n", "flags", "sample", "stream", "n_units", "n_light_rows")
_SHADE_PTRS = (
    "pixel", "hit_t", "hit_tri", "hit_u", "hit_v", "hit_hit", "tri_rows",
    "unit_material", "bsdf_type", "diffuse", "f0", "roughness", "emittance",
    "light_rows", "unit_alias_prob", "unit_alias_idx", "unit_cdf",
    "tri_offset", "tri_count", "tri_alias_prob", "tri_alias_local",
    "tri_cdf", "emissive_total", "d_in", "ray_o", "ray_d", "throughput",
    "contribution", "alive", "prev_pdf", "shadow_d", "shadow_tmax",
    "pending", "occluded", "counts")


class _ShadeArgs(ctypes.Structure):
    """csrc/shade_bounce.cu's ShadeArgs."""

    _fields_ = ([(f, ctypes.c_int) for f in _SHADE_INTS]
                + [(f, ctypes.c_void_p) for f in _SHADE_PTRS])


def shade_bounce(s: _Setting, st: _Lanes, hit: HitInfo, bounce: int,
                 first: bool, collect_only: bool, occluded=None):
    """One bounce's shading on the route shade_kernel_admits takes, after
    its walks, updating `st` as _shade_bounce_plain does. On a CUDA tensor
    it launches csrc/shade_bounce.cu (counter `pathtrace.shade.kernel`),
    whose lanes start at bounce 1, and raises on what the kernel does not
    take; on a CPU tensor it runs _shade_bounce_plain."""
    dev = st.pixel.device
    if dev.type == "cpu":
        return _shade_bounce_plain(s, st, hit, bounce, first, collect_only,
                                   occluded)
    if dev.type != "cuda":
        raise ValueError(f"shade_bounce runs on CPU and CUDA tensors, got "
                         f"{dev}")
    from gfxexp_torch.csrc.build import int32_bits, launch

    scene, cfg, dbg = s.scene, s.cfg, s.dbg
    n = st.pixel.shape[0]
    if first:
        st.buffers = {
            "pixel": _as_i32(st.pixel),
            "ray_o": torch.empty((n, 3), device=dev),
            "ray_d": torch.empty((n, 3), device=dev),
            "shadow_d": torch.empty((n, 3), device=dev),
            "shadow_tmax": torch.empty(n, device=dev),
            "pending": torch.empty((n, 3), device=dev),
            # a bounce's NEE rays, one slot a bounce
            "counts": (torch.zeros(cfg.max_path_length, dtype=torch.int32,
                                   device=dev) if cfg.count_rays else None)}
    elif st.buffers is None:
        raise ValueError("shade_bounce: the kernel's lanes start at bounce 1")
    buf = st.buffers
    emission = first or (cfg.use_implicit_light_sampling
                         and not dbg.no_implicit)
    explicit = cfg.use_explicit_light_sampling
    units = scene.units
    switches = {
        "first": first, "collect_only": collect_only, "emission": emission,
        "mis": cfg.use_mis, "roulette": cfg.russian_roulette and not first,
        "no_rr": dbg.no_rr, "explicit": explicit, "no_nee": dbg.no_nee,
        "mollify": cfg.mollify_specular and not first,
        "white": dbg.white_albedo, "geom_normal": dbg.geom_normal,
        "pending": occluded is not None, "count": cfg.count_rays,
        "alias_units": scene.light_unit_alias_prob is not None,
        "alias_tris": units.light_tri_alias_prob is not None}
    flags = sum(_SHADE_FLAGS[k] for k, on in switches.items() if on)
    n_units = scene.num_units
    light = s.light_packed if explicit else None
    n_light = 0 if light is None else light.shape[0]
    light_order = None if light is None else (n_light,)
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    mats = scene.materials
    n_mat = mats.bsdf_type.shape[0]
    n_tri = s.tri_packed.shape[0]
    counts = buf["counts"]
    inputs = {
        "pixel": (buf["pixel"], i32, (n,)),
        "hit_t": (hit.t, f32, (n,)), "hit_tri": (hit.tri, i32, (n,)),
        "hit_u": (hit.u, f32, (n,)), "hit_v": (hit.v, f32, (n,)),
        "hit_hit": (hit.hit, u8, (n,)),
        "tri_rows": (s.tri_packed, f32, (n_tri, 27)),
        "unit_material": (units.material, i32, (n_units,)),
        "bsdf_type": (mats.bsdf_type, i32, (n_mat,)),
        "diffuse": (mats.diffuse_color, f32, (n_mat, 3)),
        "f0": (mats.specular_f0, f32, (n_mat, 3)),
        "roughness": (mats.roughness, f32, (n_mat,)),
        "emittance": (mats.emittance, f32, (n_mat, 3)),
        "light_rows": (light, f32, (n_light, 22)),
        "unit_alias_prob": (scene.light_unit_alias_prob, f32, (n_units,)),
        "unit_alias_idx": (scene.light_unit_alias_idx, i32, (n_units,)),
        "unit_cdf": (scene.light_unit_cdf, f32, (n_units + 1,)),
        "tri_offset": (units.tri_offset, i32, (n_units,)),
        "tri_count": (units.tri_count, i32, (n_units,)),
        "tri_alias_prob": (units.light_tri_alias_prob, f32, light_order),
        "tri_alias_local": (units.light_tri_alias_local, i32, light_order),
        "tri_cdf": (units.light_tri_cdf, f32, light_order),
        "emissive_total": (scene.total_emissive_importance, f32, ()),
        "d_in": (st.ray_d, f32, (n, 3)),
        "throughput": (st.throughput, f32, (n, 3)),
        "contribution": (st.contribution, f32, (n, 3)),
        "alive": (st.alive, u8, (n,)),
        "prev_pdf": (st.prev_pdf, f32, (n,)),
        "occluded": (occluded, u8, (n,)),
        "counts": (None if counts is None
                   else counts[bounce - 1:bounce], i32, (1,)),
        **{k: (buf[k], f32, (n, 3)) for k in (
            "ray_o", "ray_d", "shadow_d", "pending")},
        "shadow_tmax": (buf["shadow_tmax"], f32, (n,))}
    ints = dict(n=n, flags=flags, sample=int32_bits(s.sample_idx),
                stream=int32_bits(bounce), n_units=n_units,
                n_light_rows=n_light)
    with trace.span(f"gfx.pathtrace.bounce{bounce}.shade"):
        launch("shade_bounce", "shade_bounce", _ShadeArgs, ints, inputs, dev)
    trace.count("pathtrace.shade.kernel")
    st.pending = None
    if collect_only:
        return
    if explicit and cfg.count_rays:
        # the kernel's count, summed where the plain version sums it
        st.rays_traced = st.rays_traced + counts[bounce - 1].to(torch.float32)
    st.ray_o, st.ray_d = buf["ray_o"], buf["ray_d"]
    if explicit and not dbg.no_nee:
        st.pending = (buf["pending"], buf["ray_o"], buf["shadow_d"],
                      buf["shadow_tmax"])


def _start(scene: SceneData, bvh, camera: Camera, width: int, height: int,
           lane_start, lane_count: int, sample_idx, cfg: PTConfig,
           nee_fn=None, nee_aux=None, debug_switches=None):
    """A render_lanes call's setting and its lanes at bounce 1 (the camera
    rays)."""
    dbg = DebugSwitches.from_bits(debug_switches)
    dev = scene.triangles.p0.device
    n = lane_count
    lane = int(lane_start) + torch.arange(n, dtype=torch.int64, device=dev)
    pixel = pixel_from_lane(lane, width, height)
    sample_idx = int(sample_idx)

    rs_cam = SampleStream(pixel, sample_idx, stream=0xFFFF)
    if cfg.enable_jitter and not dbg.no_jitter:
        jx, jy = rs_cam.next2()
    else:
        jx = torch.full((n,), 0.5, device=dev)
        jy = torch.full((n,), 0.5, device=dev)
    ray_o, ray_d = generate_rays_for_lanes(camera, width, height, pixel,
                                           jx, jy)
    st = _Lanes(pixel=pixel, ray_o=ray_o, ray_d=ray_d,
                throughput=torch.ones((n, 3), device=dev),
                alive=torch.ones(n, dtype=torch.bool, device=dev),
                prev_pdf=torch.zeros(n, device=dev),
                contribution=torch.zeros((n, 3), device=dev),
                rays_traced=torch.zeros((), device=dev), nee_aux=nee_aux,
                lane_ids=(torch.arange(n, device=dev)
                          if cfg.compact_rays else None))

    p_env_sel, p_surf_sel = light_selection_probs(scene)
    textured = has_textures(scene)
    lod_texels = None
    if cfg.texture_lod and textured and scene.textures.mip_flat is not None:
        # texels a pixel's angle covers at distance 1: the pixel footprint
        # heuristic (primary rays' differentials; bounces reuse the last
        # segment's length)
        lod_texels = (2.0 * torch.tan(camera.fov_y * 0.5) / height
                      * scene.textures.layers.shape[1])
    s = _Setting(
        scene=scene, bvh=bvh, cfg=cfg, dbg=dbg, sample_idx=sample_idx,
        tri_packed=pack_tri_attrs(scene.triangles, scene),
        light_packed=(pack_light_rows(scene)
                      if cfg.use_explicit_light_sampling else None),
        p_env_sel=p_env_sel, p_surf_sel=p_surf_sel,
        use_env=cfg.enable_env and scene.env is not None and not dbg.no_env,
        bump=cfg.enable_bump_mapping and textured and not dbg.no_bump,
        lod_texels=lod_texels, nee_fn=nee_fn,
        fuse=(cfg.fuse_shadow_rays and cfg.use_explicit_light_sampling
              and nee_fn is None and not scene.displaced
              and not cfg.sort_secondary_rays and not cfg.compact_rays))
    return s, st


def render_lanes(scene: SceneData, bvh, camera: Camera, width: int,
                 height: int, lane_start, lane_count: int, sample_idx,
                 cfg: PTConfig = PTConfig(), nee_fn=None, nee_aux=None,
                 debug_switches=None):
    """Render one sample for `lane_count` consecutive lanes starting at
    `lane_start`. Returns radiance [lane_count, 3] in lane order (and the
    traced-ray count as a 0-d tensor when cfg.count_rays). Runs on the
    device that holds `scene`.

    A bounce is its walks (_trace) and its shading: shade_bounce (one
    kernel on the card) where shade_kernel_admits(scene, cfg, nee_fn),
    else _shade_bounce_plain. Both give the same image.

    `nee_fn(scene, bvh, sp, v_out_local, (t, b, n), params, rs, cfg, alive,
    aux) -> (radiance, aux)` takes the place of the default next-event
    estimation (ReGIR's cell resampling uses it): it draws from `rs` after
    Russian roulette, as the default does, and its radiance is gated by
    `alive` and weighted by the throughput. `aux` starts as `nee_aux` and
    is threaded through the bounces; when `nee_aux` is not None the result
    comes back as (result, final aux).

    `debug_switches` is the 8-bit field of DebugSwitches (None, an int or
    a 0-d tensor, read once on the host)."""
    kernel = shade_kernel_admits(scene, cfg, nee_fn)
    s, st = _start(scene, bvh, camera, width, height, lane_start, lane_count,
                   sample_idx, cfg, nee_fn, nee_aux, debug_switches)
    cuda = st.alive.device.type == "cuda"
    if kernel and cuda:
        # the shading kernel and the walk build at once at first use
        from gfxexp_torch.csrc.build import load_libraries

        load_libraries(["shade_bounce"]
                       + [x for x in (walk_library(bvh),) if x])
    L = cfg.max_path_length
    # the first bounce (MIS weight 1) and the last (collect only: no NEE,
    # no new direction) are peeled, as in the reference
    for bounce in range(1, max(L, 1) + 1):
        first, last = bounce == 1, bounce == L
        with trace.span(f"gfx.pathtrace.bounce{bounce}"):
            with trace.span(f"gfx.pathtrace.bounce{bounce}.trace"):
                hit, occluded, disp = _trace(s, st, first)
            if kernel:
                shade_bounce(s, st, hit, bounce, first, last, occluded)
            else:
                if cuda:
                    trace.count("pathtrace.shade.eager")
                _shade_bounce_plain(s, st, hit, bounce, first, last,
                                    occluded, disp)
    if cfg.compact_rays and L > 1:
        with trace.span("gfx.pathtrace.resolve"):
            # undo the bounces' alive-first orders
            st.contribution = torch.zeros_like(
                st.contribution).index_copy_(0, st.lane_ids, st.contribution)

    result = ((st.contribution, st.rays_traced) if cfg.count_rays
              else st.contribution)
    if nee_aux is not None:
        return result, st.nee_aux
    return result


def _pixel_order(width: int, height: int, device):
    return lane_from_pixel(torch.arange(width * height, device=device),
                           width, height)


def render_sample(scene: SceneData, bvh, camera: Camera, width: int,
                  height: int, sample_idx, cfg: PTConfig = PTConfig(),
                  debug_switches=None):
    """One sample for every pixel: radiance [H*W, 3] in row-major pixel
    order (plus the ray count when cfg.count_rays)."""
    with trace.span("gfx.pathtrace"):
        out = render_lanes(scene, bvh, camera, width, height, 0,
                           width * height, sample_idx, cfg,
                           debug_switches=debug_switches)
        with trace.span("gfx.pathtrace.resolve"):
            order = _pixel_order(width, height, scene.triangles.p0.device)
            if cfg.count_rays:
                contribution, nrays = out
                return contribution[order], nrays
            return out[order]


def render_tile(scene: SceneData, bvh, camera: Camera, width: int,
                height: int, lane_start, lane_count: int, sample_idx,
                cfg: PTConfig = PTConfig()):
    """One sample of one lane tile (bounds the live per-lane state)."""
    return render_lanes(scene, bvh, camera, width, height, lane_start,
                        lane_count, sample_idx, cfg)


def accumulate(accum, new_sample, num_accum_frames):
    """Progressive running mean."""
    w = 1.0 / (1.0 + num_accum_frames)
    return (1.0 - w) * accum + w * new_sample


def render_tile_accumulate(scene: SceneData, bvh, camera: Camera, width: int,
                           height: int, lane_start, lane_count: int,
                           start_idx, n_samples: int,
                           cfg: PTConfig = PTConfig()):
    """n_samples samples of one lane tile: (summed radiance [lane_count, 3]
    in lane order, total rays when cfg.count_rays)."""
    dev = scene.triangles.p0.device
    acc = torch.zeros((lane_count, 3), device=dev)
    rays = torch.zeros((), device=dev)
    for s in range(n_samples):
        out = render_lanes(scene, bvh, camera, width, height, lane_start,
                           lane_count, int(start_idx) + s, cfg)
        if cfg.count_rays:
            out, nr = out
            rays = rays + nr
        acc = acc + out
    if cfg.count_rays:
        return acc, rays
    return acc


def render_accumulate(scene: SceneData, bvh, camera: Camera, width: int,
                      height: int, start_idx, n_samples: int,
                      cfg: PTConfig = PTConfig()):
    """Mean of n_samples samples (sample s = render_sample(start_idx + s)):
    (mean radiance [H*W, 3] in pixel order, total rays when
    cfg.count_rays)."""
    n = width * height
    out = render_tile_accumulate(scene, bvh, camera, width, height, 0, n,
                                 start_idx, n_samples, cfg)
    acc, rays = out if cfg.count_rays else (out, None)
    mean = (acc / n_samples)[_pixel_order(width, height, acc.device)]
    if cfg.count_rays:
        return mean, rays
    return mean
