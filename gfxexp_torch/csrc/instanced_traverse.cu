// Two-level (instanced) wide-row walk: closest hit and any hit, one thread
// per ray, over the TLAS entries of an InstancedAccel
// (gfxexp_torch/accel/instanced.py).
//
// Replaces three TPU kernels that compute the same function:
//   - gfxexp_tpu/accel/pallas_persistent_inst.py:70 _make_kernel (launched by
//     _run :378): nearest-first entries with distance termination, the
//     default route;
//   - gfxexp_tpu/accel/pallas_widestack.py:307 _make_kernel(instanced=True)
//     as launched by _run_instanced :1068: the static grid, build order;
//   - the same body as launched by _run_instanced_pass :1189 behind
//     _run_tlas_wavefront :1273: rays sorted by their nearest entry, then
//     nearest-first.
// The TPU kernels' row slots, pools, sched_k batching and per-128-lane
// worklists existed to keep VMEM rows busy; here each thread takes its own
// entries. Two instantiations:
//   - kNearest: the entries whose world AABB the ray enters within
//     [t_min, best_t], in ascending key (entry distance, entry index),
//     stopping at the first whose distance is >= best_t
//     (widerow::nearest_first, shared with the chunked and quantized walks).
//   - build order: entries in their stored (BLAS-sorted) order, each visited
//     when the ray enters its world AABB within [t_min, best_t].
// A visited entry transforms the ray into object space with the 12 floats of
// its 3x4 world->object matrix (m0*ox + m1*oy + m2*oz + m3; the direction is
// not renormalised, so t is preserved) and walks BLAS blas_ids[c] from row
// start_rows[c] of the flat [B*R, 64] table (widerow_walk.cuh); best_t
// carries across entries. Any hit stops at the first accepted triangle.
//
// What bounded it: the nearest-first pick rescanned every entry box at every
// pick, so a ray that visited v entries paid v + 1 scans of all C boxes (514
// on `city`, 2,056 with rebraid4), which took most of the kernel's time. Now
// the block stages the boxes in shared memory and a ray scans them once,
// keeping its nearest kPick keys in registers (widerow_walk.cuh says why it
// still visits exactly what the rescan visited, in the same order). What
// bounds it now: that one scan (two shared-memory loads and about 30
// operations a box per ray, so it grows with C) and the dependent row loads
// of the BLAS walks; lanes of a warp that walk different BLASes diverge
// (rays sorted by their nearest entry, the ray-sorted route, run about a
// fifth faster). The BLAS stack stays in local memory: a shared-memory top
// of 32 entries with overflow in local memory was slower on the card (L1
// holds the stack's top as it is). The bench scenes' four BLAS tables hold
// 7,940 triangles and, padded to the largest BLAS's row count, about 2 MB,
// which stays in L2. The plain PyTorch version is walk_instanced_plain in
// gfxexp_torch/accel/instanced.py; it visits entries in the same order with
// the same arithmetic, so with --fmad=false the results are equal, bit for
// bit.
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

struct Entries {
  int count;
  const int* __restrict__ blas;   // [C]
  const int* __restrict__ start;  // [C] BLAS row the entry starts at
  const float* __restrict__ tf;   // [C, 16] world->object 3x4, row-major
  const float* __restrict__ lo;   // [C, 3] world AABB
  const float* __restrict__ hi;   // [C, 3]
};

// Transform the ray into entry c's object space and walk its BLAS. Returns
// true when kAnyHit and a triangle was accepted.
template <bool kAnyHit, int K>
__device__ __forceinline__ bool visit(const float* __restrict__ nodes,
                                      int n_rows, int n_blas_rows,
                                      int max_leaf, const Entries& e, int c,
                                      float ox, float oy, float oz, float dx,
                                      float dy, float dz, float tmin,
                                      Best& best, int* stack) {
  const float4* m = reinterpret_cast<const float4*>(e.tf + 16 * c);
  const float4 r0 = __ldg(m + 0);
  const float4 r1 = __ldg(m + 1);
  const float4 r2 = __ldg(m + 2);
  const float ox2 = r0.x * ox + r0.y * oy + r0.z * oz + r0.w;
  const float oy2 = r1.x * ox + r1.y * oy + r1.z * oz + r1.w;
  const float oz2 = r2.x * ox + r2.y * oy + r2.z * oz + r2.w;
  const float dx2 = r0.x * dx + r0.y * dy + r0.z * dz;
  const float dy2 = r1.x * dx + r1.y * dy + r1.z * dz;
  const float dz2 = r2.x * dx + r2.y * dy + r2.z * dz;
  const int base = __ldg(e.blas + c) * n_blas_rows;
  // without the row batch: its registers spill under the cap of 6 blocks a
  // SM below, and the walks ran 10-25% slower with it (PERF.md)
  return widerow::walk<kAnyHit, K, false>(
      nodes, n_rows, base, __ldg(e.start + c), max_leaf, ox2, oy2, oz2, dx2,
      dy2, dz2, tmin, best, stack);
}

// At least 6 blocks a SM: the compiler's own choice (about 95 registers)
// leaves room for 5, and the walk, bound by the latency of its dependent
// loads, ran faster on the card with the registers capped for 6.
template <bool kAnyHit, int K, bool kNearest>
__global__ void __launch_bounds__(kBlock, 6)
instanced_walk(const float* __restrict__ nodes, int n_rows, int n_blas_rows,
               int max_leaf, Entries e, int n, const float* __restrict__ o,
               const float* __restrict__ d,
               const float* __restrict__ tmin_in,
               const float* __restrict__ tmax_in, float* __restrict__ out_t,
               float* __restrict__ out_u, float* __restrict__ out_v,
               int* __restrict__ out_tri, unsigned char* __restrict__ out_hit,
               int* __restrict__ out_entry) {
  extern __shared__ float4 pick_tile[];  // pick_smem_bytes(e.count)
  // no early return: every thread reaches the pick's barriers
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float tmax = i < n ? tmax_in[i] : -1.0f;
  const bool live = tmax >= 0.0f;
  Best best{tmax, 0.0f, 0.0f, -1};
  int best_entry = -1;
  const int j = live ? i : 0;
  const float ox = o[3 * j + 0], oy = o[3 * j + 1], oz = o[3 * j + 2];
  const float dx = d[3 * j + 0], dy = d[3 * j + 1], dz = d[3 * j + 2];
  const float tmin = tmin_in[j];
  const float ix = widerow::safe_inv(dx);
  const float iy = widerow::safe_inv(dy);
  const float iz = widerow::safe_inv(dz);
  int stack[kMaxStack];
  if (kNearest) {
    widerow::nearest_first(
        e.lo, e.hi, e.count, pick_tile, live, ox, oy, oz, ix, iy, iz, tmin,
        best, [&](int c) {
          const float before = best.t;
          const bool stop = visit<kAnyHit, K>(nodes, n_rows, n_blas_rows,
                                              max_leaf, e, c, ox, oy, oz, dx,
                                              dy, dz, tmin, best, stack);
          if (best.t < before) best_entry = c;
          return stop;
        });
  } else if (live) {
    for (int c = 0; c < e.count; ++c) {
      bool ok;
      widerow::box_near(e.lo, e.hi, c, ox, oy, oz, ix, iy, iz, tmin, best.t,
                        ok);
      if (!ok) continue;
      const float before = best.t;
      const bool stop =
          visit<kAnyHit, K>(nodes, n_rows, n_blas_rows, max_leaf, e, c, ox,
                            oy, oz, dx, dy, dz, tmin, best, stack);
      if (best.t < before) best_entry = c;
      if (stop) break;
    }
  }
  if (i >= n) return;
  out_t[i] = best.t;
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_tri[i] = best.tri;
  out_hit[i] = best.tri >= 0 ? 1 : 0;
  out_entry[i] = best_entry;
}

template <bool kAnyHit, int K, bool kNearest>
cudaError_t launch(const float* nodes, int n_rows, int n_blas_rows,
                   int max_leaf, const Entries& e, int n, const float* o,
                   const float* d, const float* tmin, const float* tmax,
                   float* t, float* u, float* v, int* tri,
                   unsigned char* hit, int* entry, cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  const int smem = kNearest ? widerow::pick_smem_bytes(e.count) : 0;
  instanced_walk<kAnyHit, K, kNearest><<<grid, kBlock, smem, stream>>>(
      nodes, n_rows, n_blas_rows, max_leaf, e, n, o, d, tmin, tmax, t, u, v,
      tri, hit, entry);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(int any_hit, int nearest, const float* nodes,
                     int n_rows, int n_blas_rows, int max_leaf,
                     const Entries& e, int n, const float* o, const float* d,
                     const float* tmin, const float* tmax, float* t, float* u,
                     float* v, int* tri, unsigned char* hit, int* entry,
                     cudaStream_t stream) {
#define GFX_LAUNCH(A, N)                                                   \
  launch<A, K, N>(nodes, n_rows, n_blas_rows, max_leaf, e, n, o, d, tmin,  \
                  tmax, t, u, v, tri, hit, entry, stream)
  if (any_hit) {
    return nearest ? GFX_LAUNCH(true, true) : GFX_LAUNCH(true, false);
  }
  return nearest ? GFX_LAUNCH(false, true) : GFX_LAUNCH(false, false);
#undef GFX_LAUNCH
}

}  // namespace

extern "C" {

int instanced_max_stack() { return kMaxStack; }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
// stack_depth is the deepest BLAS's bound, checked against kMaxStack.
int instanced_walk_launch(int any_hit, int nearest, int arity,
                          const float* nodes, int n_rows, int n_blas_rows,
                          int max_leaf, int stack_depth, int n_entries,
                          const int* blas_ids, const int* start_rows,
                          const float* inv_transforms, const float* entry_lo,
                          const float* entry_hi, int n, const float* o,
                          const float* d, const float* tmin,
                          const float* tmax, float* t, float* u, float* v,
                          int* tri, unsigned char* hit, int* entry,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || n_blas_rows <= 0 || n_entries < 0 || max_leaf < 0 ||
      max_leaf > 5 || stack_depth > kMaxStack) {
    return (int)cudaErrorInvalidValue;
  }
  const Entries e{n_entries, blas_ids, start_rows, inv_transforms, entry_lo,
                  entry_hi};
  if (arity == 4) {
    return (int)dispatch<4>(any_hit, nearest, nodes, n_rows, n_blas_rows,
                            max_leaf, e, n, o, d, tmin, tmax, t, u, v, tri,
                            hit, entry, stream);
  }
  if (arity == 8) {
    return (int)dispatch<8>(any_hit, nearest, nodes, n_rows, n_blas_rows,
                            max_leaf, e, n, o, d, tmin, tmax, t, u, v, tri,
                            hit, entry, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
