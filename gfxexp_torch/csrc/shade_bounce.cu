// One bounce of the wavefront path tracer's shading, one thread a lane:
// everything render_lanes does between a bounce's closest-hit walk and its
// any-hit walk, in registers.
//
// Replaces no TPU kernel: the JAX integrator (gfxexp_tpu/render/pathtrace.py)
// is plain jnp, which XLA fuses on the TPU. In the port the same stages ran
// as ~1,330 PyTorch launches a bounce (the stages .surface, .bsdf and .nee of
// render_lanes), each a pass over [N] or [N, 3] tensors, and the frame waited
// on the host that launched them. This kernel is those stages for the scenes
// and options pathtrace.shade_kernel_admits takes (one level, no texture, no
// displaced geometry, no environment, the default light sampling). Its plain
// PyTorch version is pathtrace._shade_bounce_plain, which the other routes
// run as well.
//
// A lane, in the plain version's order: the previous bounce's NEE term where
// its shadow ray found no occluder (added before this bounce's emission, so
// every sum into the contribution keeps the eager order); the surface point
// from one row of pack_tri_attrs, the shading frame and the implicit emitter
// hit with its MIS weight; Russian roulette; the material's BSDF parameters;
// NEE: light selection (alias tables or CDF search), the packed light row,
// the MIS weight and the unshadowed contribution, written with the shadow
// ray for the any-hit walk; the BSDF sample, the new throughput, `alive`,
// `prev_pdf` and the next ray. Random numbers are PCG4D keyed by (pixel,
// sample, bounce), drawn in the plain version's order.
//
// Rounding: every operation rounds as the PyTorch CUDA kernel that the
// plain version launches for it does (--fmad=false; a division by a Python
// number is a product with its float reciprocal, `c / x` of a Python number
// c is `(1 / x) * c`, `x ** 2` is `x * x`), so the card's plain version and
// this kernel agree bit for bit but where a library function (cosf, sinf)
// differs.
//
// What bounds it: bytes. A lane reads the hit (17 B), its ray direction,
// throughput, contribution and pending NEE term (4 x 12 B), `alive`,
// `prev_pdf`, the occlusion flag and its pixel (10 B), and writes the next
// ray, throughput, contribution, `alive`, `prev_pdf`, the shadow ray and
// the pending term (81 B): about 156 B, against a few
// hundred flops. The scene's tables (triangle rows, materials, lights) are
// small and stay in L1/L2. One thread a lane with no shared memory keeps
// every lane's loads independent; the [N, 3] arrays are read and written
// whole by each warp (384 contiguous bytes), so they coalesce.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing.

#include "shading.cuh"

// The arguments, one struct (pathtrace.py _ShadeArgs mirrors it).
struct ShadeArgs {
  int n, flags, sample, stream, n_units, n_light_rows;
  const int* pixel;  // [n] the uint32 bits of each lane's pixel index
  // the closest hit
  const float* hit_t;
  const int* hit_tri;
  const float* hit_u;
  const float* hit_v;
  const unsigned char* hit_hit;
  // the scene
  const float* tri_rows;  // [T, 27] pack_tri_attrs
  const int* unit_material;
  const int* bsdf_type;
  const float* diffuse;  // [M, 3]
  const float* f0;       // [M, 3]
  const float* roughness;
  const float* emittance;    // [M, 3]
  const float* light_rows;   // [TL, 22] pack_light_rows
  const float* unit_alias_prob;
  const int* unit_alias_idx;
  const float* unit_cdf;  // [U + 1]
  const int* tri_offset;
  const int* tri_count;
  const float* tri_alias_prob;
  const int* tri_alias_local;
  const float* tri_cdf;
  const float* emissive_total;  // [] total_emissive_importance
  // the lanes
  const float* d_in;  // [n, 3] this bounce's ray directions
  float* ray_o;       // [n, 3] out: the next ray (and the shadow ray) origin
  float* ray_d;       // [n, 3] out (may be d_in)
  float* throughput;  // [n, 3] in (but at bounce 1) and out
  float* contribution;
  unsigned char* alive;
  float* prev_pdf;
  float* shadow_d;  // [n, 3] out
  float* shadow_tmax;
  float* pending;  // [n, 3] in (kPending) and out
  const unsigned char* occluded;  // [n] the pending term's shadow ray
  int* counts;  // [1] (kCount): NEE rays, added to
};

namespace {

constexpr int kBlock = 128;

// The per-launch switches (pathtrace.py _SHADE_FLAGS spells the same bits).
enum : int {
  kFirst = 1 << 0,        // bounce 1: the lane state starts fresh
  kCollectOnly = 1 << 1,  // the last bounce: emission only
  kEmission = 1 << 2,     // implicit emitter hits count
  kMis = 1 << 3,          // implicit and explicit light sampling, MIS
  kRoulette = 1 << 4,     // Russian roulette at this bounce
  kNoRR = 1 << 5,         // debug: the roulette draw consumed, every lane kept
  kExplicit = 1 << 6,     // NEE
  kNoNee = 1 << 7,        // debug: NEE's three draws consumed, no term
  kMollify = 1 << 8,      // roughness 1 - (1 - r) / 2
  kWhite = 1 << 9,        // debug: diffuse 0.8
  kGeomNormal = 1 << 10,  // debug: shade with the geometric normal
  kPending = 1 << 11,     // the previous bounce left a NEE term
  kCount = 1 << 12,       // count the rays traced
  kAliasUnits = 1 << 13,  // light units by alias table (else CDF search)
  kAliasTris = 1 << 14,   // light triangles by alias table (else CDF)
};

// ---- lights.py -------------------------------------------------------------

// _alias_pick over the window of n buckets at base; u_re: the remapped
// uniform (nullptr: not wanted)
__device__ __forceinline__ int alias_pick(const float* prob, const int* alias,
                                          int base, int n, int len, float u,
                                          float* u_re) {
  const float scaled = u * (float)n;
  const long long trunc = (long long)scaled;
  const long long cap = n - 1 > 0 ? n - 1 : 0;
  const long long lo = trunc > 0 ? trunc : 0;
  const int bucket = (int)(lo < cap ? lo : cap);
  const float frac = scaled - (float)bucket;
  const int at = min(max(base + bucket, 0), max(len - 1, 0));
  const float pr = prob[at];
  const bool keep = frac < pr;
  if (u_re != nullptr) {
    const float ur = keep ? frac / clamp_min(pr, 1e-12f)
                          : (frac - pr) / clamp_min(1.0f - pr, 1e-12f);
    *u_re = clamp(ur, 0.0f, kOneMinus);
  }
  return keep ? bucket : alias[at];
}

// torch.searchsorted(cdf[0:len], u, right=True): the first i with cdf[i] > u
__device__ __forceinline__ int upper_bound(const float* cdf, int len,
                                           float u) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// _segment_searchsorted: the largest i in [0, count) with
// cdf[offset + i] <= u, in the plain version's 20 steps
__device__ __forceinline__ int segment_search(const float* cdf, int offset,
                                              int count, int len, float u) {
  const int top = max(count - 1, 0);
  int lo = 0, hi = top;
  for (int s = 0; s < 20; ++s) {
    const int mid = (lo + hi + 1) / 2;
    const int at = min(max(offset + min(mid, top), 0), max(len - 1, 0));
    const bool go_right = (cdf[at] <= u) && (mid <= hi);
    if (go_right) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Shades lane i; returns 1 where it counts a NEE ray, else 0.
__device__ int shade_lane(const ShadeArgs& a, int i) {
  const int fl = a.flags;
  const bool first = fl & kFirst;
  int n_nee = 0;

  V3 thr, con;
  bool alive;
  float prev_pdf;
  if (first) {
    thr = V3{1.0f, 1.0f, 1.0f};
    con = V3{0.0f, 0.0f, 0.0f};
    alive = true;
    prev_pdf = 0.0f;
  } else {
    thr = load3(a.throughput, i);
    con = load3(a.contribution, i);
    alive = a.alive[i] != 0;
    prev_pdf = a.prev_pdf[i];
  }

  // 1. the previous bounce's NEE term where its shadow ray is unoccluded
  if (fl & kPending) {
    const V3 pend = load3(a.pending, i);
    const bool occ = a.occluded[i] != 0;
    con = add(con, occ ? V3{0.0f, 0.0f, 0.0f} : pend);
  }

  // 2. the surface point, the shading frame and the emitter hit
  const bool hit_ok = alive && a.hit_hit[i] != 0;
  const float hu = a.hit_u[i], hv = a.hit_v[i];
  const int tri = max(a.hit_tri[i], 0);
  const float* row = a.tri_rows + 27 * (size_t)tri;
  const V3 p0 = row3(row + 0), e1 = row3(row + 3), e2 = row3(row + 6);
  const V3 position = add(add(p0, scale(e1, hu)), scale(e2, hv));
  const V3 gn = normalize(cross(e1, e2));
  const float w1 = 1.0f - hu - hv;
  const V3 sn = normalize(add(add(scale(row3(row + 9), w1),
                                  scale(row3(row + 12), hu)),
                              scale(row3(row + 15), hv)));
  const int unit_id = __float_as_int(row[24]);
  const int mat = a.unit_material[unit_id];
  const V3 emit = load3(a.emittance, mat);

  const V3 d_in = load3(a.d_in, i);
  const V3 v_out = neg(d_in);
  const bool front = dot(v_out, gn) >= 0.0f;
  const V3 gn_signed = front ? gn : neg(gn);
  const V3 pos_off = offset_ray_origin(position, gn_signed);
  const V3 nrm = (fl & kGeomNormal) ? gn_signed : sn;
  V3 ft, fb;
  make_frame(nrm, ft, fb);
  const V3 v_out_local = to_local(ft, fb, nrm, v_out);
  const bool surface_ok = a.emissive_total[0] > 0.0f;

  if (fl & kEmission) {
    const bool emissive = (emit.x > 0.0f || emit.y > 0.0f || emit.z > 0.0f) &&
                          v_out_local.z > 0.0f;
    float mis_w = 1.0f;
    if (!first && (fl & kMis)) {
      const float ht = a.hit_t[i];
      const float dist2 = clamp_min(ht * ht, 1e-12f);
      const float p_surf_sel = surface_ok ? 1.0f : 0.0f;
      const float light_p =
          p_surf_sel * row[25] * dist2 / clamp_min(v_out_local.z, 1e-6f);
      const float pp2 = prev_pdf * prev_pdf;
      mis_w = pp2 / clamp_min(pp2 + light_p * light_p, 1e-30f);
    }
    const bool gate = hit_ok && emissive;
    const V3 term = scale(mul(thr, emit), mis_w * kInvPi);
    con = add(con, gate ? term : V3{0.0f, 0.0f, 0.0f});
  }
  alive = hit_ok;

  if (fl & kCollectOnly) {
    store3(a.throughput, i, thr);
    store3(a.contribution, i, con);
    a.alive[i] = alive ? 1 : 0;
    a.prev_pdf[i] = prev_pdf;
    return n_nee;
  }

  Rng rs;
  rs.lane = (unsigned int)a.pixel[i];
  rs.sample = (unsigned int)a.sample;
  rs.stream = (unsigned int)a.stream;
  rs.dim = 0;
  rs.used = 4;

  // 3. Russian roulette, and the BSDF at the hit
  if (fl & kRoulette) {
    if (fl & kNoRR) {
      rs.skip(1);
    } else {
      const float cont_prob = clamp_max(luminance(thr), 1.0f);
      const float u_rr = rs.next();
      alive = alive && (u_rr < cont_prob);
      const float c = clamp_min(cont_prob, 1e-8f);
      thr = V3{thr.x / c, thr.y / c, thr.z / c};
    }
  }
  Params prm;
  prm.diffuse =
      (fl & kWhite) ? V3{0.8f, 0.8f, 0.8f} : load3(a.diffuse, mat);
  prm.f0 = load3(a.f0, mat);
  prm.rough = clamp_max(a.roughness[mat], 0.999f);
  if (fl & kMollify) prm.rough = 1.0f - 0.5f * (1.0f - prm.rough);
  prm.lambert = a.bsdf_type[mat] == 0;

  // 4. NEE: the light sample, its MIS weight and unshadowed term, and the
  // shadow ray
  if (fl & kExplicit) {
    n_nee = alive ? 1 : 0;
    if (fl & kNoNee) {
      rs.skip(3);
    } else {
      const float u_light = rs.next();
      const float u0 = rs.next();
      const float u1 = rs.next();
      // the unit, then the triangle in the unit
      int unit_l;
      float u_re;
      if (fl & kAliasUnits) {
        unit_l = alias_pick(a.unit_alias_prob, a.unit_alias_idx, 0,
                            a.n_units, a.n_units, u_light, &u_re);
      } else {
        const int k = upper_bound(a.unit_cdf, a.n_units + 1, u_light);
        unit_l = min(max(k - 1, 0), a.n_units - 1);
        const float lo = a.unit_cdf[unit_l];
        const float width = a.unit_cdf[unit_l + 1] - lo;
        u_re = clamp(width > 0.0f ? (u_light - lo) / width : 0.0f, 0.0f,
                     kOneMinus);
      }
      const int offset = a.tri_offset[unit_l];
      const int count = a.tri_count[unit_l];
      const int local =
          (fl & kAliasTris)
              ? alias_pick(a.tri_alias_prob, a.tri_alias_local, offset, count,
                           a.n_light_rows, u_re, nullptr)
              : segment_search(a.tri_cdf, offset, count, a.n_light_rows,
                               u_re);
      const int lpos =
          min(max(offset + local, 0), max(a.n_light_rows - 1, 0));
      const float* lr = a.light_rows + 22 * (size_t)lpos;
      // the square -> triangle map
      const float b_a = 0.5f * u0;
      const float b_b = 0.5f * u1;
      const float off = b_b - b_a;
      const float b_b2 = off > 0.0f ? b_b + off : b_b;
      const float b_a2 = off > 0.0f ? b_a : b_a - off;
      const float b_c = 1.0f - b_a2 - b_b2;
      const V3 l_pos =
          add(add(row3(lr + 0), scale(row3(lr + 3), b_b2)),
              scale(row3(lr + 6), b_c));
      V3 l_nrm = add(add(scale(row3(lr + 9), b_a2), scale(row3(lr + 12), b_b2)),
                     scale(row3(lr + 15), b_c));
      const float ln = clamp_min(length(l_nrm), 1e-20f);
      l_nrm = V3{l_nrm.x / ln, l_nrm.y / ln, l_nrm.z / ln};
      const float l_pdf =
          (surface_ok && a.n_light_rows > 0) ? lr[18] : 0.0f;
      const V3 l_emit = row3(lr + 19);

      const V3 shadow_vec = sub(l_pos, pos_off);
      const float dist2 = clamp_min(dot(shadow_vec, shadow_vec), 1e-12f);
      const float dist = sqrtf(dist2);
      const V3 sdir =
          V3{shadow_vec.x / dist, shadow_vec.y / dist, shadow_vec.z / dist};
      const V3 v_in_local = to_local(ft, fb, nrm, sdir);
      const float lp_cos = dot(neg(sdir), l_nrm);
      const float sp_cos = v_in_local.z;
      float mis = 1.0f;
      if (fl & kMis) {
        float bsdf_p = bsdf_pdf(prm, v_out_local, v_in_local) *
                       fabsf(lp_cos) / dist2;
        if (!isfinite(bsdf_p)) bsdf_p = 0.0f;
        mis = l_pdf > 0.0f
                  ? l_pdf * l_pdf /
                        clamp_min(bsdf_p * bsdf_p + l_pdf * l_pdf, 1e-30f)
                  : 0.0f;
      }
      const bool potential = (l_pdf > 0.0f) && (lp_cos > 0.0f) && alive;
      const float stmax = potential ? dist * 0.9999f : -1.0f;
      const V3 le = scale(l_emit, kInvPi);
      const V3 f_val = bsdf_evaluate(prm, v_out_local, v_in_local);
      const float g = lp_cos * fabsf(sp_cos) / dist2;
      const float w = g * mis / clamp_min(l_pdf, 1e-30f);
      const V3 contrib =
          potential ? scale(mul(f_val, le), w) : V3{0.0f, 0.0f, 0.0f};
      store3(a.pending, i, alive ? mul(thr, contrib) : V3{0.0f, 0.0f, 0.0f});
      store3(a.shadow_d, i, sdir);
      a.shadow_tmax[i] = stmax;
    }
  }

  // 5. the next direction
  const float u0 = rs.next();
  const float u1 = rs.next();
  V3 f_val;
  float pdf;
  const V3 v_in_local = bsdf_sample(prm, v_out_local, u0, u1, f_val, pdf);
  const bool valid = (pdf > 0.0f) && isfinite(pdf);
  const float s = fabsf(v_in_local.z) / clamp_min(pdf, 1e-30f);
  if (alive && valid) thr = mul(thr, scale(f_val, s));
  alive = alive && valid;
  store3(a.throughput, i, thr);
  store3(a.contribution, i, con);
  a.alive[i] = alive ? 1 : 0;
  a.prev_pdf[i] = pdf;
  store3(a.ray_o, i, pos_off);
  store3(a.ray_d, i, normalize(to_world(ft, fb, nrm, v_in_local)));
  return n_nee;
}

__global__ void __launch_bounds__(kBlock)
shade_bounce_kernel(const ShadeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_nee = i < a.n ? shade_lane(a, i) : 0;
  if (a.flags & kCount) {
    // one integer atomic a block
    const int nee = __syncthreads_count(n_nee);
    if (threadIdx.x == 0 && nee) atomicAdd(a.counts, nee);
  }
}

}  // namespace

extern "C" {

// sizeof(ShadeArgs), so the caller can check its layout
int shade_bounce_args_size() { return (int)sizeof(ShadeArgs); }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int shade_bounce_launch(const ShadeArgs* args, cudaStream_t stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const ShadeArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.n_units <= 0 || ((a.flags & kCount) && a.counts == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  shade_bounce_kernel<<<(a.n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
