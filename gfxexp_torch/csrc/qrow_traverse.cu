// Quantized-row walk: closest hit and any hit over the 128-byte arity-8 rows
// of a QRowBVH (gfxexp_torch/accel/qrow.py), one thread per ray.
//
// Replaces the TPU kernel _make_kernel_q (gfxexp_tpu/accel/pallas_qrow.py
// :302, launched by _run_q :560), the walk of compile_scene(traversal=
// "qrow"). The TPU kernel walked each 128-lane row of rays with one cursor
// over per-tile chunk worklists; here each thread walks its own ray and
// takes the chunks nearest first as the chunked wide-row walk does
// (widerow::nearest_first in widerow_walk.cuh).
//
// A step reads one row as 8 float4 (the internal rows' first 7). Internal:
// the scales 2^(e-127) come from moving each exponent byte into a float32,
// (e & 0xFF) << 23; the 8 child boxes dequantize to lo = plo + q * s and
// hi = plo + (qhi + 1) * s; they are slab-tested against [t_min, best_t],
// sorted by entry distance with the 8-wide network, and the hit ones
// descended nearest first, the rest pushed far to near. Leafness rides bit
// 30 of the child entries and of the stack entries. Leaf: up to 5 triangles
// of 9 uint16 coordinates each dequantize to base + q * scale and are tested
// with Moller-Trumbore, accepting det_ok (|det| > 1e-12) & u >= 0 & v >= 0 &
// u + v <= 1 & t > t_min & t < best_t. Any hit stops at the first accepted
// triangle. A ray with t_max < 0 does no work, under any hit one with
// t_max <= 0 (the TPU kernel's rule).
//
// What bounds it: the latency of the dependent 128-byte row loads (half the
// wide-row format's bytes a step, with twice the arity) and the chunk
// scans. The plain PyTorch version is walk_qrow_plain in
// gfxexp_torch/accel/qrow.py; both apply the same operations in the same
// order, so with --fmad=false their results are equal.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <stdint.h>

#include "widerow_walk.cuh"

namespace {

using widerow::Best;

constexpr int kBlock = 128;
constexpr int kQWidth = 32;    // floats per row
constexpr int kMaxLeaf = 5;
constexpr int kLeafBit = 1 << 30;
constexpr int kQMaxStack = 256;  // compile-time stack bound (entries)

__device__ __forceinline__ float exp_scale(int e) {
  return __int_as_float((e & 0xFF) << 23);
}

// Walk the table whose root is row `base` of the flat [C*R, 32] table.
// Returns true when kAnyHit and a triangle was accepted.
template <bool kAnyHit>
__device__ __forceinline__ bool qwalk(const float4* __restrict__ nodes,
                                      int n_rows, int base, float ox,
                                      float oy, float oz, float dx, float dy,
                                      float dz, float tmin, Best& best,
                                      int* stack) {
  const float ix = widerow::safe_inv(dx);
  const float iy = widerow::safe_inv(dy);
  const float iz = widerow::safe_inv(dz);
  int sp = 0;
  int cur = 0;
  while (cur >= 0) {
    const int r = min(max(base + (cur & (kLeafBit - 1)), 0), n_rows - 1);
    const float4* row = nodes + (size_t)r * (kQWidth / 4);
    int nxt = -1;
    if (cur & kLeafBit) {
      float4 q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = __ldg(row + k);
      const float* f = reinterpret_cast<const float*>(q);
      auto w = [f](int c) { return __float_as_int(f[c]); };
      const float bx = f[0], by = f[1], bz = f[2];
      const float sx = f[3], sy = f[4], sz = f[5];
      const int packed = w(29);
      const int fst = packed & 0xFFFFFF;
      const int cnt = packed >> 24;
#pragma unroll
      for (int j = 0; j < kMaxLeaf; ++j) {
        if (j >= cnt) break;
        float c[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int s = 9 * j + k;
          const int h = (w(6 + (s >> 1)) >> (16 * (s & 1))) & 0xFFFF;
          c[k] = (float)h;
        }
        const float ax = bx + c[0] * sx;
        const float ay = by + c[1] * sy;
        const float az = bz + c[2] * sz;
        const float e1x = (bx + c[3] * sx) - ax;
        const float e1y = (by + c[4] * sy) - ay;
        const float e1z = (bz + c[5] * sz) - az;
        const float e2x = (bx + c[6] * sx) - ax;
        const float e2y = (by + c[7] * sy) - ay;
        const float e2z = (bz + c[8] * sz) - az;
        const float px = dy * e2z - dz * e2y;  // d x e2
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool det_ok = fabsf(det) > 1e-12f;
        const float inv = 1.0f / (det_ok ? det : 1.0f);
        const float tx = ox - ax;
        const float ty = oy - ay;
        const float tz = oz - az;
        const float u = (tx * px + ty * py + tz * pz) * inv;
        const float qx = ty * e1z - tz * e1y;  // (o - a) x e1
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
        if (det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
            t < best.t) {
          best.t = t;
          best.u = u;
          best.v = v;
          best.tri = fst + j;
          if (kAnyHit) return true;
        }
      }
    } else {
      float4 q[7];  // cols 0..27
#pragma unroll
      for (int k = 0; k < 7; ++k) q[k] = __ldg(row + k);
      const float* f = reinterpret_cast<const float*>(q);
      auto w = [f](int c) { return __float_as_int(f[c]); };
      const float plx = f[0], ply = f[1], plz = f[2];
      const int sc = w(3);
      const float sx = exp_scale(sc);
      const float sy = exp_scale(sc >> 8);
      const float sz = exp_scale(sc >> 16);
      float nr[8];
      int mt[8];
      bool vd[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int meta = w(4 + k);
        const int c0 = w(12 + 2 * k);
        const int c1 = w(13 + 2 * k);
        const float lox = plx + (float)(c0 & 0xFF) * sx;
        const float loy = ply + (float)((c0 >> 8) & 0xFF) * sy;
        const float loz = plz + (float)((c0 >> 16) & 0xFF) * sz;
        const float hix = plx + (float)(((c0 >> 24) & 0xFF) + 1) * sx;
        const float hiy = ply + (float)((c1 & 0xFF) + 1) * sy;
        const float hiz = plz + (float)(((c1 >> 8) & 0xFF) + 1) * sz;
        const float tx0 = (lox - ox) * ix;
        const float tx1 = (hix - ox) * ix;
        const float ty0 = (loy - oy) * iy;
        const float ty1 = (hiy - oy) * iy;
        const float tz0 = (loz - oz) * iz;
        const float tz1 = (hiz - oz) * iz;
        const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                 fmaxf(fminf(tz0, tz1), tmin));
        const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                fminf(fmaxf(tz0, tz1), best.t));
        const bool ok = near <= far && meta >= 0;
        nr[k] = ok ? near : CUDART_INF_F;
        mt[k] = meta;
        vd[k] = ok;
      }
      widerow::sort_children<8>(nr, mt, vd);
#pragma unroll
      for (int s = 7; s >= 1; --s) {
        if (vd[s]) {
          if (sp < kQMaxStack) stack[sp] = mt[s];
          ++sp;
        }
      }
      nxt = vd[0] ? mt[0] : -1;
    }
    if (nxt < 0 && sp > 0) {
      --sp;
      nxt = sp < kQMaxStack ? stack[sp] : -1;
    }
    cur = nxt;
  }
  return false;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
qrow_walk(const float4* __restrict__ nodes, int n_chunks, int rows_per_chunk,
          const float* __restrict__ lo, const float* __restrict__ hi, int n,
          const float* __restrict__ o, const float* __restrict__ d,
          const float* __restrict__ tmin_in,
          const float* __restrict__ tmax_in, float* __restrict__ out_t,
          float* __restrict__ out_u, float* __restrict__ out_v,
          int* __restrict__ out_tri, unsigned char* __restrict__ out_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = tmax_in[i];
  Best best{tmax, 0.0f, 0.0f, -1};
  if (kAnyHit ? tmax > 0.0f : tmax >= 0.0f) {
    const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float tmin = tmin_in[i];
    const int n_rows = n_chunks * rows_per_chunk;
    int stack[kQMaxStack];
    if (lo == nullptr) {
      qwalk<kAnyHit>(nodes, n_rows, 0, ox, oy, oz, dx, dy, dz, tmin, best,
                     stack);
    } else {
      widerow::nearest_first(
          lo, hi, n_chunks, ox, oy, oz, widerow::safe_inv(dx),
          widerow::safe_inv(dy), widerow::safe_inv(dz), tmin, best,
          [&](int c) {
            return qwalk<kAnyHit>(nodes, n_rows, c * rows_per_chunk, ox, oy,
                                  oz, dx, dy, dz, tmin, best, stack);
          });
    }
  }
  out_t[i] = best.t;
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_tri[i] = best.tri;
  out_hit[i] = best.tri >= 0 ? 1 : 0;
}

template <bool kAnyHit>
cudaError_t launch(const float4* nodes, int n_chunks, int rows_per_chunk,
                   const float* lo, const float* hi, int n, const float* o,
                   const float* d, const float* tmin, const float* tmax,
                   float* t, float* u, float* v, int* tri, unsigned char* hit,
                   cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  qrow_walk<kAnyHit><<<grid, kBlock, 0, stream>>>(
      nodes, n_chunks, rows_per_chunk, lo, hi, n, o, d, tmin, tmax, t, u, v,
      tri, hit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int qrow_max_stack() { return kQMaxStack; }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take). nodes:
// [n_chunks, rows_per_chunk, 32] float32, 16-byte aligned; lo, hi:
// [n_chunks, 3] chunk boxes, or both null for one table walked whole.
// stack_depth is the table's bound, checked against kQMaxStack.
int qrow_walk_launch(int any_hit, const float* nodes, int n_chunks,
                     int rows_per_chunk, int stack_depth, const float* lo,
                     const float* hi, int n, const float* o, const float* d,
                     const float* tmin, const float* tmax, float* t, float* u,
                     float* v, int* tri, unsigned char* hit,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_chunks <= 0 || rows_per_chunk <= 0 ||
      (int64_t)n_chunks * rows_per_chunk >= kLeafBit ||
      stack_depth > kQMaxStack || (lo == nullptr) != (hi == nullptr) ||
      (lo == nullptr && n_chunks != 1) ||
      (reinterpret_cast<uintptr_t>(nodes) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
  return (int)(any_hit
                   ? launch<true>(nodes4, n_chunks, rows_per_chunk, lo, hi, n,
                                  o, d, tmin, tmax, t, u, v, tri, hit, stream)
                   : launch<false>(nodes4, n_chunks, rows_per_chunk, lo, hi,
                                   n, o, d, tmin, tmax, t, u, v, tri, hit,
                                   stream));
}

}  // extern "C"
