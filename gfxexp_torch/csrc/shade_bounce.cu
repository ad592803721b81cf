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

#include <stdint.h>

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

constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 1.0f / kPi;
constexpr float kPi2 = (float)(3.14159265358979323846 / 2.0);
constexpr float kPi4 = (float)(3.14159265358979323846 / 4.0);
constexpr float kOneMinus = (float)(1.0 - 1e-7);
constexpr float kDiffuseRough = (float)(1.0 / 1.51 - 1.0);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return V3{p[3 * i + 0], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i + 0] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 row3(const float* r) {
  return V3{r[0], r[1], r[2]};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }
// core/math.py dot: a0*b0 + a1*b1 + a2*b2, left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// core/math.py safe_divide (eps 0)
__device__ __forceinline__ float sdiv(float a, float b) {
  return b != 0.0f ? a / b : 0.0f;
}
// core/math.py normalize: v * (1 / sqrt(max(|v|^2, 1e-20)))
__device__ __forceinline__ V3 normalize(V3 v) {
  return scale(v, 1.0f / sqrtf(clamp_min(dot(v, v), 1e-20f)));
}
// core/math.py length
__device__ __forceinline__ float length(V3 v) {
  return sqrtf(clamp_min(dot(v, v), 0.0f));
}
// bsdf.py _unit: v / max(|v|, 1e-20)
__device__ __forceinline__ V3 unit(V3 v) {
  const float l = clamp_min(length(v), 1e-20f);
  return V3{v.x / l, v.y / l, v.z / l};
}
__device__ __forceinline__ float luminance(V3 c) {
  return c.x * 0.2126729f + c.y * 0.7151522f + c.z * 0.0721750f;
}
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

// core/math.py make_frame (Duff et al. 2017)
__device__ __forceinline__ void make_frame(V3 n, V3& t, V3& b) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -(1.0f / (sign + n.z));
  const float bb = n.x * n.y * a;
  t = V3{1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x};
  b = V3{bb, sign + n.y * n.y * a, -n.y};
}
__device__ __forceinline__ V3 to_local(V3 t, V3 b, V3 n, V3 v) {
  return V3{dot(v, t), dot(v, b), dot(v, n)};
}
__device__ __forceinline__ V3 to_world(V3 t, V3 b, V3 n, V3 v) {
  return add(add(scale(t, v.x), scale(b, v.y)), scale(n, v.z));
}

// core/math.py offset_ray_origin
__device__ __forceinline__ float offset1(float p, float n) {
  const float int_off = n * 256.0f;
  const int off = (int)(p < 0.0f ? -int_off : int_off);
  const float p_int = __int_as_float(
      (int)((unsigned int)__float_as_int(p) + (unsigned int)off));
  const float p_float = p + n * (1.0f / 65536.0f);
  return fabsf(p) < (1.0f / 32.0f) ? p_float : p_int;
}
__device__ __forceinline__ V3 offset_ray_origin(V3 p, V3 n) {
  return V3{offset1(p.x, n.x), offset1(p.y, n.y), offset1(p.z, n.z)};
}

// core/rng.py SampleStream: PCG4D of (lane, sample, stream, dim), four
// draws a dimension, taken in order
struct Rng {
  unsigned int lane, sample, stream, dim;
  unsigned int buf[4];
  int used;

  __device__ void fill() {
    unsigned int x = lane * 1664525u + 1013904223u;
    unsigned int y = sample * 1664525u + 1013904223u;
    unsigned int z = stream * 1664525u + 1013904223u;
    unsigned int w = dim * 1664525u + 1013904223u;
    x += y * w;
    y += z * x;
    z += x * y;
    w += y * z;
    x ^= x >> 16;
    y ^= y >> 16;
    z ^= z >> 16;
    w ^= w >> 16;
    x += y * w;
    y += z * x;
    z += x * y;
    w += y * z;
    buf[0] = x;
    buf[1] = y;
    buf[2] = z;
    buf[3] = w;
    dim += 1;
    used = 0;
  }
  __device__ unsigned int raw() {
    if (used == 4) fill();
    const unsigned int r = used == 0   ? buf[0]
                           : used == 1 ? buf[1]
                           : used == 2 ? buf[2]
                                       : buf[3];
    used += 1;
    return r;
  }
  __device__ float next() {
    return (float)((raw() >> 8) & 0xFFFFFFu) * (1.0f / 16777216.0f);
  }
  __device__ void skip(int k) {
    for (int j = 0; j < k; ++j) raw();
  }
};

// ---- bsdf.py ---------------------------------------------------------------

struct Params {
  V3 diffuse, f0;
  float rough;
  bool lambert;
};

__device__ __forceinline__ float ggx_d(V3 m, float alpha) {
  const float ma = m.z * alpha;
  const float temp = m.x * m.x + m.y * m.y + ma * ma;
  const float d = sdiv(alpha * alpha, kPi * temp * temp);
  return m.z > 0.0f ? d : 0.0f;
}

__device__ __forceinline__ float ggx_smith_g1(V3 v, V3 m, float alpha) {
  const bool chi = dot(v, m) * v.z > 0.0f;
  const float vz2 = v.z * v.z;
  const float temp = sdiv(alpha * alpha * (v.x * v.x + v.y * v.y), vz2);
  return chi ? (1.0f / (1.0f + sqrtf(1.0f + temp))) * 2.0f : 0.0f;
}

__device__ __forceinline__ float ggx_lambda(V3 v, float alpha) {
  const float vz2 = v.z * v.z;
  const float a2t2 = sdiv(alpha * alpha * (v.x * v.x + v.y * v.y), vz2);
  return 0.5f * (sqrtf(1.0f + a2t2) + -1.0f);
}

__device__ __forceinline__ float ggx_height_correlated_g(V3 v1, V3 v2, V3 m,
                                                         float alpha) {
  const bool chi1 = sdiv(dot(v1, m), v1.z) > 0.0f;
  const bool chi2 = sdiv(dot(v2, m), v2.z) > 0.0f;
  const float l1 = ggx_lambda(v1, alpha);
  const float l2 = ggx_lambda(v2, alpha);
  return chi1 && chi2 ? 1.0f / (1.0f + l1 + l2) : 0.0f;
}

__device__ __forceinline__ float ggx_pdf(V3 v, V3 m, float alpha) {
  const float d = ggx_d(m, alpha);
  return sdiv(ggx_smith_g1(v, m, alpha) * fabsf(dot(v, m)) * d, fabsf(v.z));
}

// Heitz 2014 visible-normal sampling: (m, pdf_m)
__device__ __forceinline__ V3 ggx_sample_vndf(V3 v, float u0, float u1,
                                              float alpha, float& pdf) {
  const V3 s0 = V3{alpha * v.x, alpha * v.y, v.z};
  const float ls = length(s0);
  const V3 sv = V3{s0.x / ls, s0.y / ls, s0.z / ls};
  const float dist2d = sqrtf(sv.x * sv.x + sv.y * sv.y);
  const float rec = dist2d != 0.0f ? 1.0f / dist2d : 0.0f;
  const bool straight = sv.z >= 0.9999f;
  const V3 t1 = straight ? V3{1.0f, 0.0f, 0.0f}
                         : V3{sv.y * rec, -sv.x * rec, 0.0f};
  const V3 t2 = V3{t1.y * sv.z, -t1.x * sv.z, dist2d};
  const float aa = 1.0f / (1.0f + sv.z);
  const float r = sqrtf(clamp_min(u0, 0.0f));
  const bool lower = u1 < aa;
  const float phi =
      kPi * (lower ? sdiv(u1, aa) : 1.0f + sdiv(u1 - aa, 1.0f - aa));
  const float p1 = r * cosf(phi);
  const float p2 = r * sinf(phi) * (lower ? 1.0f : sv.z);
  const float p3 = sqrtf(clamp_min(1.0f - p1 * p1 - p2 * p2, 0.0f));
  V3 m = add(add(scale(t1, p1), scale(t2, p2)), scale(sv, p3));
  m = unit(V3{alpha * m.x, alpha * m.y, m.z});
  const float d = ggx_d(m, alpha);
  pdf = ggx_smith_g1(v, m, alpha) * fabsf(dot(v, m)) * d;
  pdf = sdiv(pdf, fabsf(v.z));
  return m;
}

__device__ __forceinline__ void lobe_weights(const Params& p, V3 v_given,
                                             float& dw, float& sw) {
  const float r = p.rough;
  const float vz = v_given.z;
  const float om5 = pow5(1.0f - fabsf(vz));
  const float efd90 = 0.5f * r + 2.0f * r * vz * vz;
  const float edf = 1.0f + (efd90 - 1.0f) * om5;
  dw = luminance(p.diffuse) * (edf * edf) * (1.0f + kDiffuseRough * r);
  const float lf0 = luminance(p.f0);
  sw = lf0 + (1.0f - lf0) * om5;
}

// diffuse + specular f for upper-hemisphere V, L and half vector m
__device__ __forceinline__ V3 ds_eval_common(const Params& p, V3 dv, V3 dl,
                                             V3 m) {
  const float r = p.rough;
  const float alpha = r * r;
  const float dot_lh = clamp_max(dot(dl, m), 1.0f);
  const float olh5 = pow5(1.0f - dot_lh);
  const float d = ggx_d(m, alpha);
  const float g = ggx_height_correlated_g(dl, dv, m, alpha);
  const V3 f = V3{p.f0.x + (1.0f - p.f0.x) * olh5,
                  p.f0.y + (1.0f - p.f0.y) * olh5,
                  p.f0.z + (1.0f - p.f0.z) * olh5};
  const float denom = 4.0f * dl.z * dv.z;
  V3 spec = scale(f, sdiv(d * g, denom));
  if (!(g > 0.0f)) spec = V3{0.0f, 0.0f, 0.0f};
  const float fd90 = 0.5f * r + 2.0f * r * dot_lh * dot_lh;
  const float ovn5 = pow5(1.0f - dv.z);
  const float oln5 = pow5(1.0f - dl.z);
  const float f_out = 1.0f + (fd90 - 1.0f) * ovn5;
  const float f_in = 1.0f + (fd90 - 1.0f) * oln5;
  const float k = f_out * f_in * (1.0f + kDiffuseRough * r) * kInvPi;
  return add(scale(p.diffuse, k), spec);
}

// bsdf_evaluate: f(V, L), two-sided
__device__ __forceinline__ V3 bsdf_evaluate(const Params& p, V3 vg, V3 vs) {
  const bool same_side = vg.z * vs.z > 0.0f;
  if (!same_side) return V3{0.0f, 0.0f, 0.0f};
  if (p.lambert) return scale(p.diffuse, kInvPi);
  const float sign = vg.z >= 0.0f ? 1.0f : -1.0f;
  const V3 dv = scale(vg, sign);
  const V3 dl = scale(vs, sign);
  const V3 m = unit(add(dl, dv));
  return ds_eval_common(p, dv, dl, m);
}

// bsdf_pdf: the solid-angle pdf of sampling L given V
__device__ __forceinline__ float bsdf_pdf(const Params& p, V3 vg, V3 vs) {
  const bool same_side = vg.z * vs.z > 0.0f;
  if (!same_side) return 0.0f;
  const float sign = vg.z >= 0.0f ? 1.0f : -1.0f;
  const V3 dv = scale(vg, sign);
  const V3 dl = scale(vs, sign);
  const float diffuse_pdf = dl.z * kInvPi;
  float pdf = diffuse_pdf;
  if (!p.lambert) {
    const V3 m = unit(add(dl, dv));
    const float alpha = p.rough * p.rough;
    const float common = sdiv(1.0f, 4.0f * dot(dl, m));
    const float specular_pdf = common * ggx_pdf(dv, m, alpha);
    float dw, sw;
    lobe_weights(p, dv, dw, sw);
    pdf = sdiv(diffuse_pdf * dw + specular_pdf * sw, dw + sw);
  }
  return clamp_min(pdf, 0.0f);
}

// core/math.py cosine_sample_hemisphere (concentric disk)
__device__ __forceinline__ V3 cosine_sample_hemisphere(float u0, float u1) {
  const float r0 = 2.0f * u0 - 1.0f;
  const float r1 = 2.0f * u1 - 1.0f;
  const bool use_r0 = fabsf(r0) > fabsf(r1);
  const float r = use_r0 ? r0 : r1;
  const float safe = r == 0.0f ? 1.0f : r;
  float theta = use_r0 ? kPi4 * (r1 / safe) : kPi2 - kPi4 * (r0 / safe);
  if (r == 0.0f) theta = 0.0f;
  const float x = r * cosf(theta);
  const float y = r * sinf(theta);
  const float z = sqrtf(clamp_min(1.0f - x * x - y * y, 0.0f));
  return V3{x, y, z};
}

// bsdf_sample: L given V, with f and pdf
__device__ __forceinline__ V3 bsdf_sample(const Params& p, V3 vg, float u0,
                                          float u1, V3& f, float& pdf) {
  const float sign = vg.z >= 0.0f ? 1.0f : -1.0f;
  const V3 dv = scale(vg, sign);
  const float alpha = p.rough * p.rough;
  float dw, sw;
  lobe_weights(p, dv, dw, sw);
  const float sum_w = dw + sw;
  const bool pick_spec = (u1 * sum_w >= dw) && !p.lambert;
  const float u1_diff =
      p.lambert ? u1 : clamp(sdiv(u1 * sum_w, dw), 0.0f, kOneMinus);
  const V3 l_diff = cosine_sample_hemisphere(u0, u1_diff);
  V3 dl = l_diff;
  bool spec_ok = true;
  if (p.lambert) {
    pdf = dl.z * kInvPi;
    f = scale(p.diffuse, kInvPi);
  } else {
    const float u1_spec = clamp(sdiv(u1 * sum_w - dw, sw), 0.0f, kOneMinus);
    float m_pdf;
    const V3 m_spec = ggx_sample_vndf(dv, u0, u1_spec, alpha, m_pdf);
    const float dot_vh = clamp_max(dot(dv, m_spec), 1.0f);
    const V3 l_spec = sub(scale(m_spec, 2.0f * dot_vh), dv);
    dl = pick(pick_spec, l_spec, l_diff);
    if (pick_spec) spec_ok = dl.z * dv.z > 0.0f;
    const V3 m = pick_spec ? m_spec : unit(add(l_diff, dv));
    const float dot_lh = clamp_max(dot(dl, m), 1.0f);
    const float common = sdiv(1.0f, 4.0f * dot_lh);
    const float diffuse_pdf = dl.z * kInvPi;
    const float specular_pdf =
        common * (pick_spec ? m_pdf : ggx_pdf(dv, m, alpha));
    pdf = sdiv(diffuse_pdf * dw + specular_pdf * sw, sum_w);
    f = ds_eval_common(p, dv, dl, m);
  }
  if (!(spec_ok && sum_w > 0.0f)) pdf = 0.0f;
  if (!(pdf > 0.0f)) f = V3{0.0f, 0.0f, 0.0f};
  return scale(dl, sign);
}

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
