// The per-ray wide-row walk shared by widerow_traverse.cu (one table),
// chunked_traverse.cu (the chunk tables of a large scene) and
// instanced_traverse.cu (one BLAS table per entry of a two-level scene), and
// the nearest-first pick over boxes shared by the last two and
// qrow_traverse.cu.
//
// Row format: gfxexp_torch/accel/widerow.py. The walk's plain PyTorch version
// is walk_plain in gfxexp_torch/accel/persistent.py; both apply the same
// operations in the same order, so with --fmad=false their results are equal.
//
// What bounds it: each step is one dependent load of a 256-byte row (internal
// rows read 7*K floats, leaf rows 12 floats a triangle) followed by a few
// dozen FLOPs, so a walk is bound by the latency of those dependent loads,
// not by arithmetic. Every thread walks on its own (no packets) and reads
// rows as float4 through the read-only path; the tables of the bench scenes
// (about 1 MB for one table, about 2 MB for the padded BLAS tables) stay
// resident in the 50 MB L2. The stack lives in local memory.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace widerow {

constexpr int kWidth = 64;       // floats per row
constexpr int kMaxStack = 128;   // compile-time stack bound (entries)

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v < 0.0f ? -1e-12f : 1e-12f;
  return 1.0f / (fabsf(v) < 1e-12f ? tiny : v);
}

// compare-swap on (entry distance, child row, valid): ascending, ties keep
// their order (the plain version's `swap = near[a] > near[b]`)
__device__ __forceinline__ void cswap(float* nr, int* mt, bool* vd, int a,
                                      int b) {
  if (nr[a] > nr[b]) {
    const float tn = nr[a]; nr[a] = nr[b]; nr[b] = tn;
    const int tm = mt[a]; mt[a] = mt[b]; mt[b] = tm;
    const bool tv = vd[a]; vd[a] = vd[b]; vd[b] = tv;
  }
}

template <int K>
__device__ __forceinline__ void sort_children(float* nr, int* mt, bool* vd);

template <>
__device__ __forceinline__ void sort_children<4>(float* nr, int* mt,
                                                 bool* vd) {
  cswap(nr, mt, vd, 0, 1); cswap(nr, mt, vd, 2, 3);
  cswap(nr, mt, vd, 0, 2); cswap(nr, mt, vd, 1, 3);
  cswap(nr, mt, vd, 1, 2);
}

template <>
__device__ __forceinline__ void sort_children<8>(float* nr, int* mt,
                                                 bool* vd) {
  cswap(nr, mt, vd, 0, 1); cswap(nr, mt, vd, 2, 3);
  cswap(nr, mt, vd, 4, 5); cswap(nr, mt, vd, 6, 7);
  cswap(nr, mt, vd, 0, 2); cswap(nr, mt, vd, 1, 3);
  cswap(nr, mt, vd, 4, 6); cswap(nr, mt, vd, 5, 7);
  cswap(nr, mt, vd, 1, 2); cswap(nr, mt, vd, 5, 6);
  cswap(nr, mt, vd, 0, 4); cswap(nr, mt, vd, 3, 7);
  cswap(nr, mt, vd, 1, 5); cswap(nr, mt, vd, 2, 6);
  cswap(nr, mt, vd, 3, 6); cswap(nr, mt, vd, 2, 4);
  cswap(nr, mt, vd, 1, 2); cswap(nr, mt, vd, 3, 5);
  cswap(nr, mt, vd, 4, 5); cswap(nr, mt, vd, 3, 4);
}

// The best hit a ray has found so far; carried across walks (the entries of
// a two-level scene).
struct Best {
  float t, u, v;
  int tri;
};

// The triangles of a leaf row (tail = its cols 60..63): Baldwin-Weber
// tests, ids first | count << 24. Returns true when kAnyHit and a triangle
// was accepted (the walk stops there).
template <bool kAnyHit>
__device__ __forceinline__ bool leaf_hits(const float4* __restrict__ row,
                                          float4 tail, int max_leaf,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float tmin, Best& best) {
  const int packed = __float_as_int(tail.x);
  const int fst = packed & 0xFFFFFF;
  const int cnt = packed >> 24;
  for (int j = 0; j < max_leaf && j < cnt; ++j) {
    const float4 pn = __ldg(row + 3 * j + 0);  // n.xyz d0
    const float4 pu = __ldg(row + 3 * j + 1);  // U.xyz Ud
    const float4 pv = __ldg(row + 3 * j + 2);  // V.xyz Vd
    const float den = pn.x * dx + pn.y * dy + pn.z * dz;
    const float num = pn.x * ox + pn.y * oy + pn.z * oz + pn.w;
    const bool den_ok = fabsf(den) > 1e-12f;
    const float t = -num / (den_ok ? den : 1.0f);
    const float px = ox + t * dx;
    const float py = oy + t * dy;
    const float pz = oz + t * dz;
    const float u = pu.x * px + pu.y * py + pu.z * pz + pu.w;
    const float v = pv.x * px + pv.y * py + pv.z * pz + pv.w;
    if (den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
        t < best.t) {
      best.t = t;
      best.u = u;
      best.v = v;
      best.tri = fst + j;
      if (kAnyHit) return true;
    }
  }
  return false;
}

// Walk the table from row `start`. Child rows in the table are relative to
// `base` (a BLAS's first row in the flat [B*R, 64] table; 0 for one table);
// row addresses are clamped to the table as the plain version clamps them.
// Slab tests run against [tmin, best.t]; leaf triangles are Baldwin-Weber
// tests `den_ok & u>=0 & v>=0 & u+v<=1 & t>tmin & t<best.t`. Returns true
// when kAnyHit and a triangle was accepted (the caller stops there).
template <bool kAnyHit, int K>
__device__ __forceinline__ bool walk(const float* __restrict__ nodes,
                                     int n_rows, int base, int start,
                                     int max_leaf, float ox, float oy,
                                     float oz, float dx, float dy, float dz,
                                     float tmin, Best& best, int* stack) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  int sp = 0;
  int cur = start;
  while (cur >= 0) {
    const int r = min(base + cur, n_rows - 1);
    const float4* row =
        reinterpret_cast<const float4*>(nodes + (size_t)r * kWidth);
    const float4 tail = __ldg(row + 15);  // cols 60..63
    int nxt = -1;
    if (tail.w > 0.5f) {
      if (leaf_hits<kAnyHit>(row, tail, max_leaf, ox, oy, oz, dx, dy, dz,
                             tmin, best)) {
        return true;
      }
    } else {
      // internal: K children of 7 floats (lo.xyz hi.xyz child row)
      float c[7 * K];
#pragma unroll
      for (int q = 0; q < 7 * K / 4; ++q) {
        const float4 f = __ldg(row + q);
        c[4 * q + 0] = f.x;
        c[4 * q + 1] = f.y;
        c[4 * q + 2] = f.z;
        c[4 * q + 3] = f.w;
      }
      float nr[K];
      int mt[K];
      bool vd[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float* b = c + 7 * k;
        const float tx0 = (b[0] - ox) * ix;
        const float tx1 = (b[3] - ox) * ix;
        const float ty0 = (b[1] - oy) * iy;
        const float ty1 = (b[4] - oy) * iy;
        const float tz0 = (b[2] - oz) * iz;
        const float tz1 = (b[5] - oz) * iz;
        const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                 fmaxf(fminf(tz0, tz1), tmin));
        const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                fminf(fmaxf(tz0, tz1), best.t));
        const int meta = __float_as_int(b[6]);
        const bool ok = near <= far && meta >= 0;
        nr[k] = ok ? near : CUDART_INF_F;
        mt[k] = meta;
        vd[k] = ok;
      }
      sort_children<K>(nr, mt, vd);
#pragma unroll
      for (int s = K - 1; s >= 1; --s) {
        if (vd[s]) {
          if (sp < kMaxStack) stack[sp] = mt[s];
          ++sp;
        }
      }
      nxt = vd[0] ? mt[0] : -1;
    }
    if (nxt < 0 && sp > 0) {
      --sp;
      nxt = sp < kMaxStack ? stack[sp] : -1;
    }
    cur = nxt;
  }
  return false;
}

// Entry distance of the ray into box c of lo, hi ([C, 3] each); `ok` when it
// enters within [tmin, best_t]. The same slab test as a BVH child.
__device__ __forceinline__ float box_near(const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          int c, float ox, float oy, float oz,
                                          float ix, float iy, float iz,
                                          float tmin, float best_t, bool& ok) {
  const float tx0 = (__ldg(lo + 3 * c + 0) - ox) * ix;
  const float tx1 = (__ldg(hi + 3 * c + 0) - ox) * ix;
  const float ty0 = (__ldg(lo + 3 * c + 1) - oy) * iy;
  const float ty1 = (__ldg(hi + 3 * c + 1) - oy) * iy;
  const float tz0 = (__ldg(lo + 3 * c + 2) - oz) * iz;
  const float tz1 = (__ldg(hi + 3 * c + 2) - oz) * iz;
  const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fmaxf(fminf(tz0, tz1), tmin));
  const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                          fminf(fmaxf(tz0, tz1), best_t));
  ok = near <= far;
  return near;
}

// Nearest-first order over `count` boxes (the chunks of a large table, the
// TLAS entries of a two-level scene): each step takes the box with the
// smallest key (entry distance, index) strictly after the last key taken,
// among the boxes the ray enters within [tmin, best.t], and stops when that
// distance is >= best.t. visit(c) walks box c (updating best) and returns
// true to stop (an accepted any hit). No visited set and no per-thread sort:
// each pick is an O(C) scan of the boxes, which every thread of a warp reads
// alike (a broadcast from L1/L2).
template <class Visit>
__device__ __forceinline__ void nearest_first(
    const float* __restrict__ lo, const float* __restrict__ hi, int count,
    float ox, float oy, float oz, float ix, float iy, float iz, float tmin,
    const Best& best, Visit visit) {
  float last_near = -CUDART_INF_F;
  int last_c = -1;
  while (true) {
    float pick_near = CUDART_INF_F;
    int pick = -1;
    for (int c = 0; c < count; ++c) {
      bool ok;
      const float nr =
          box_near(lo, hi, c, ox, oy, oz, ix, iy, iz, tmin, best.t, ok);
      const bool after = nr > last_near || (nr == last_near && c > last_c);
      if (ok && after && nr < pick_near) {
        pick_near = nr;
        pick = c;
      }
    }
    if (pick < 0 || pick_near >= best.t) break;
    if (visit(pick)) break;
    last_near = pick_near;
    last_c = pick;
  }
}

}  // namespace widerow
