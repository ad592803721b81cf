// Quantized-row walk: closest hit and any hit over the 128-byte arity-8 rows
// of a QRowBVH (gfxexp_torch/accel/qrow.py), one thread per ray.
//
// Replaces the TPU kernel _make_kernel_q (gfxexp_tpu/accel/pallas_qrow.py
// :302, launched by _run_q :560), the walk of compile_scene(traversal=
// "qrow"). The TPU kernel walked each 128-lane row of rays with one cursor
// over per-tile chunk worklists; here each thread walks its own ray and
// takes the chunks nearest first, from one scan of the chunk boxes, as the
// chunked wide-row walk does (widerow::nearest_first in widerow_walk.cuh).
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
// What bounded it: the chunk pick rescanned every chunk box at every pick
// (see widerow_walk.cuh), and a row cost twice a wide row's time for half
// its bytes: each of the 8 children paid 6 byte extracts and 6 int->float
// conversions before its slab test, each leaf triangle 9 short extracts
// and conversions, and every internal row the 19 compare-swaps of the
// 8-wide sort network. What bounds it now: the latency of the dependent
// 128-byte row loads and the decode's remaining instructions (a byte
// permute, a subtraction and a fused multiply-add a value). The row is
// cheaper without a changed bit:
//   - every quantized value q is below 2^23, so one byte permute builds the
//     float 2^23 + q (0x4B000000 | q) exactly, and subtracting 2^23 (or
//     2^23 - 1 for the hi corners' q + 1) gives exactly (float)q (or
//     (float)(q + 1)): no conversion instruction is left;
//   - q * 2^(e-127) is exact, so the box corners' multiply and add round
//     once either way and one fused multiply-add gives the plain version's
//     bits;
//   - a row with at most one hit child skips the sort network
//     (widerow::descend says why the order is the same).
// Measured on the card and dropped, because they did not pay: a loop that
// runs the internal and leaf steps of a warp in separate inner loops (the
// while-while loop, without speculation), a shared-memory stack top, and
// capping the registers for more blocks a SM; the 256-entry stack stays in
// local memory. The plain PyTorch version is walk_qrow_plain in
// gfxexp_torch/accel/qrow.py; both apply the same operations in the same
// order (the pick's order by widerow_walk.cuh's argument), so with
// --fmad=false their results are equal, bit for bit.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <stdint.h>

#include "widerow_walk.cuh"

// The arguments, one struct (accel/qrow.py _QrowArgs mirrors it). nodes:
// [n_chunks, rows_per_chunk, 32] float32, 16-byte aligned; lo, hi:
// [n_chunks, 3] chunk boxes, or both null for one table walked whole.
// stack_depth is the table's bound, checked against kQMaxStack.
struct QrowArgs {
  int any_hit, n_chunks, rows_per_chunk, stack_depth, n;
  const float* nodes;
  const float* lo;
  const float* hi;
  const float *o, *d;  // [n, 3]
  const float *tmin, *tmax;
  float *t, *u, *v;  // out
  int* tri;
  unsigned char* hit;
};

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

// Exact int -> float of a value q < 2^23 without the conversion
// instruction: `bits` is 0x4B000000 | q (the float 2^23 + q, exact), so
// subtracting 2^23 gives q and subtracting 2^23 - 1 gives q + 1, both
// exactly, as (float)q and (float)(q + 1) do.
__device__ __forceinline__ float q_float(unsigned bits) {
  return __uint_as_float(bits) - 8388608.0f;
}

__device__ __forceinline__ float q_float_plus1(unsigned bits) {
  return __uint_as_float(bits) - 8388607.0f;
}

// 0x4B000000 | byte b of w, and | short h of w (PRMT selectors)
__device__ __forceinline__ unsigned byte_bits(int w, int b) {
  return __byte_perm(static_cast<unsigned>(w), 0x4B000000u, 0x7440u | b);
}

__device__ __forceinline__ unsigned short_bits(int w, int h) {
  return __byte_perm(static_cast<unsigned>(w), 0x4B000000u,
                     h ? 0x7432u : 0x7410u);
}

// plo + q * s for a scale s = 2^(e-127) (or 0, or inf): q * s is exact, so
// one rounding (a fused multiply-add) gives the bits of the two roundings
// of the plain version's multiply and add.
__device__ __forceinline__ float dequant(float q, float s, float plo) {
  return __fmaf_rn(q, s, plo);
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
    if (!(cur & kLeafBit)) {
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
        const float lox = dequant(q_float(byte_bits(c0, 0)), sx, plx);
        const float loy = dequant(q_float(byte_bits(c0, 1)), sy, ply);
        const float loz = dequant(q_float(byte_bits(c0, 2)), sz, plz);
        const float hix = dequant(q_float_plus1(byte_bits(c0, 3)), sx, plx);
        const float hiy = dequant(q_float_plus1(byte_bits(c1, 0)), sy, ply);
        const float hiz = dequant(q_float_plus1(byte_bits(c1, 1)), sz, plz);
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
      nxt = widerow::descend<8, kQMaxStack>(nr, mt, vd, stack, sp);
    } else {
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
          c[k] = q_float(short_bits(w(6 + (s >> 1)), s & 1));
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
  extern __shared__ float4 pick_tile[];  // pick_smem_bytes(n_chunks)
  // no early return: every thread reaches the pick's barriers
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float tmax = i < n ? tmax_in[i] : -1.0f;
  const bool live = kAnyHit ? tmax > 0.0f : tmax >= 0.0f;
  Best best{tmax, 0.0f, 0.0f, -1};
  const int j = live ? i : 0;
  const float ox = o[3 * j + 0], oy = o[3 * j + 1], oz = o[3 * j + 2];
  const float dx = d[3 * j + 0], dy = d[3 * j + 1], dz = d[3 * j + 2];
  const float tmin = tmin_in[j];
  const int n_rows = n_chunks * rows_per_chunk;
  int stack[kQMaxStack];
  if (lo == nullptr) {
    if (live) {
      qwalk<kAnyHit>(nodes, n_rows, 0, ox, oy, oz, dx, dy, dz, tmin, best,
                     stack);
    }
  } else {
    widerow::nearest_first(
        lo, hi, n_chunks, pick_tile, live, ox, oy, oz, widerow::safe_inv(dx),
        widerow::safe_inv(dy), widerow::safe_inv(dz), tmin, best,
        [&](int c) {
          return qwalk<kAnyHit>(nodes, n_rows, c * rows_per_chunk, ox, oy,
                                oz, dx, dy, dz, tmin, best, stack);
        });
  }
  if (i >= n) return;
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
  const int smem = lo != nullptr ? widerow::pick_smem_bytes(n_chunks) : 0;
  qrow_walk<kAnyHit><<<grid, kBlock, smem, stream>>>(
      nodes, n_chunks, rows_per_chunk, lo, hi, n, o, d, tmin, tmax, t, u, v,
      tri, hit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(QrowArgs), so the caller can check its layout
int qrow_walk_args_size() { return (int)sizeof(QrowArgs); }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int qrow_walk_launch(const QrowArgs* args, cudaStream_t stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const QrowArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.n_chunks <= 0 || a.rows_per_chunk <= 0 ||
      (int64_t)a.n_chunks * a.rows_per_chunk >= kLeafBit ||
      a.stack_depth > kQMaxStack || (a.lo == nullptr) != (a.hi == nullptr) ||
      (a.lo == nullptr && a.n_chunks != 1) ||
      (reinterpret_cast<uintptr_t>(a.nodes) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const float4* nodes4 = reinterpret_cast<const float4*>(a.nodes);
  return (int)(a.any_hit
                   ? launch<true>(nodes4, a.n_chunks, a.rows_per_chunk, a.lo,
                                  a.hi, a.n, a.o, a.d, a.tmin, a.tmax, a.t,
                                  a.u, a.v, a.tri, a.hit, stream)
                   : launch<false>(nodes4, a.n_chunks, a.rows_per_chunk, a.lo,
                                   a.hi, a.n, a.o, a.d, a.tmin, a.tmax, a.t,
                                   a.u, a.v, a.tri, a.hit, stream));
}

}  // extern "C"
