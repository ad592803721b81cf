// The device math the port's CUDA kernels share: float3 arithmetic, the
// shading frame, the ray-origin offset, the PCG4D sample stream and the
// BSDF (Lambert, diffuse + GGX), one lane at a time in registers.
//
// Each function repeats the plain PyTorch version named beside it
// (core/math.py, core/rng.py, render/bsdf.py) operation by operation, as
// PyTorch's CUDA kernels round it: the kernels that include this header are
// built with --fmad=false, so no multiply and add fuse, and a division by a
// Python number is a product with its float reciprocal. A change to the
// plain version on a kernel's route must be made here too. Included by
// shade_bounce.cu (the path tracer's shading) and restir_resample.cu
// (ReSTIR DI's resampling).

#pragma once

#include <stdint.h>

namespace {

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

}  // namespace
