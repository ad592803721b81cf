// Chunked wide-row walk: closest hit and any hit over the C chunk tables of
// a large single-level scene (gfxexp_torch/accel/widerow.py), one thread per
// ray.
//
// Replaces the TPU kernel _make_kernel (gfxexp_tpu/accel/pallas_widestack.py
// :307, launched by _run :659): the walk of every wide-row table over
// 13,000 rows, and of single-chunk tables with the persistent switch off.
// The TPU kernel walked each 128-lane row of rays over a per-tile worklist
// of chunks in nearest-first order, skipping a step once every lane's best
// t beat its entry distance, and streamed each chunk's table through VMEM.
// Here each thread takes its own chunks nearest first
// (widerow::nearest_first, the pick of the two-level walk): the chunk boxes
// the ray enters within [t_min, best_t] in ascending (entry distance,
// index), stopping at the first whose distance is >= best_t; one scan of
// the boxes, staged in shared memory, feeds the whole walk. Chunk c is
// walked with kernel 1's walk (widerow_walk.cuh) from row c * R of the flat
// [C*R, 64] table; leaf rows hold global triangle ids, so no remap. Without
// chunk boxes (lo == nullptr, a single table) the table is walked whole.
// Any hit stops at the first accepted triangle; a ray with t_max < 0 does
// no work.
//
// What bounds it: the latency of the dependent 256-byte row loads of each
// chunk walk, plus the one scan of the chunk boxes per ray. The tables of
// the flattened bench scenes do not fit the 50 MB L2 (big: 11 chunks, about
// 37 MB; city: about 79 chunks, 263 MB). The plain PyTorch version is
// walk_chunked_plain in gfxexp_torch/accel/persistent.py; it visits the
// same chunks in the same order with the same arithmetic, so with
// --fmad=false the results are equal.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <stdint.h>

#include "widerow_walk.cuh"

namespace {

using widerow::Best;
using widerow::kMaxStack;

constexpr int kBlock = 128;

template <bool kAnyHit, int K>
__global__ void __launch_bounds__(kBlock)
chunked_walk(const float* __restrict__ nodes, int n_chunks,
             int rows_per_chunk, int max_leaf, const float* __restrict__ lo,
             const float* __restrict__ hi, int n,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmin_in,
             const float* __restrict__ tmax_in, float* __restrict__ out_t,
             float* __restrict__ out_u, float* __restrict__ out_v,
             int* __restrict__ out_tri, unsigned char* __restrict__ out_hit) {
  extern __shared__ float4 pick_tile[];  // pick_smem_bytes(n_chunks)
  // no early return: every thread reaches the pick's barriers
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float tmax = i < n ? tmax_in[i] : -1.0f;
  const bool live = tmax >= 0.0f;
  Best best{tmax, 0.0f, 0.0f, -1};
  const int j = live ? i : 0;
  const float ox = o[3 * j + 0], oy = o[3 * j + 1], oz = o[3 * j + 2];
  const float dx = d[3 * j + 0], dy = d[3 * j + 1], dz = d[3 * j + 2];
  const float tmin = tmin_in[j];
  const int n_rows = n_chunks * rows_per_chunk;
  int stack[kMaxStack];
  if (lo == nullptr) {
    if (live) {
      widerow::walk<kAnyHit, K>(nodes, n_rows, 0, 0, max_leaf, ox, oy, oz,
                                dx, dy, dz, tmin, best, stack);
    }
  } else {
    widerow::nearest_first(
        lo, hi, n_chunks, pick_tile, live, ox, oy, oz, widerow::safe_inv(dx),
        widerow::safe_inv(dy), widerow::safe_inv(dz), tmin, best,
        [&](int c) {
          return widerow::walk<kAnyHit, K>(nodes, n_rows, c * rows_per_chunk,
                                           0, max_leaf, ox, oy, oz, dx, dy,
                                           dz, tmin, best, stack);
        });
  }
  if (i >= n) return;
  out_t[i] = best.t;
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_tri[i] = best.tri;
  out_hit[i] = best.tri >= 0 ? 1 : 0;
}

template <bool kAnyHit, int K>
cudaError_t launch(const float* nodes, int n_chunks, int rows_per_chunk,
                   int max_leaf, const float* lo, const float* hi, int n,
                   const float* o, const float* d, const float* tmin,
                   const float* tmax, float* t, float* u, float* v, int* tri,
                   unsigned char* hit, cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  const int smem = lo != nullptr ? widerow::pick_smem_bytes(n_chunks) : 0;
  chunked_walk<kAnyHit, K><<<grid, kBlock, smem, stream>>>(
      nodes, n_chunks, rows_per_chunk, max_leaf, lo, hi, n, o, d, tmin, tmax,
      t, u, v, tri, hit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int chunked_max_stack() { return kMaxStack; }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take). nodes:
// [n_chunks, rows_per_chunk, 64] float32; lo, hi: [n_chunks, 3] chunk boxes,
// or both null for one table walked whole. stack_depth is the table's
// bound, checked against kMaxStack.
int chunked_walk_launch(int any_hit, int arity, const float* nodes,
                        int n_chunks, int rows_per_chunk, int max_leaf,
                        int stack_depth, const float* lo, const float* hi,
                        int n, const float* o, const float* d,
                        const float* tmin, const float* tmax, float* t,
                        float* u, float* v, int* tri, unsigned char* hit,
                        cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_chunks <= 0 || rows_per_chunk <= 0 ||
      (int64_t)n_chunks * rows_per_chunk > INT32_MAX || max_leaf < 0 ||
      max_leaf > 5 || stack_depth > kMaxStack ||
      (lo == nullptr) != (hi == nullptr) ||
      (lo == nullptr && n_chunks != 1)) {
    return (int)cudaErrorInvalidValue;
  }
#define GFX_LAUNCH(A, K)                                                     \
  launch<A, K>(nodes, n_chunks, rows_per_chunk, max_leaf, lo, hi, n, o, d,   \
               tmin, tmax, t, u, v, tri, hit, stream)
  cudaError_t err;
  if (arity == 4) {
    err = any_hit ? GFX_LAUNCH(true, 4) : GFX_LAUNCH(false, 4);
  } else if (arity == 8) {
    err = any_hit ? GFX_LAUNCH(true, 8) : GFX_LAUNCH(false, 8);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef GFX_LAUNCH
  return (int)err;
}

}  // extern "C"
