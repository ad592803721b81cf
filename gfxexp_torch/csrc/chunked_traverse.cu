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
// the boxes feeds the whole walk. Chunk c is walked with kernel 1's walk
// (widerow_walk.cuh) from row c * R of the flat [C*R, 64] table; leaf rows
// hold global triangle ids, so no remap. Without chunk boxes (lo ==
// nullptr, a single table) the table is walked whole. Any hit stops at the
// first accepted triangle; a ray with t_max < 0 does no work.
//
// What bounds it: the chain of dependent row loads of each chunk walk, and
// the issue slots and resident warps to hide them, plus the one scan of the
// chunk boxes per ray. The tables of the flattened bench scenes do not fit
// the 50 MB L2 (big: 11 chunks, about 37 MB; city: about 79 chunks, 263 MB).
// Two designs here, both bit for bit equal to the earlier walk:
//   - One load batch a row (widerow::walk with kBatch): the earlier walk
//     loaded a row's tail, branched on it, then loaded the children (two
//     round trips an internal row, as its SASS showed) and a leaf's
//     triangles one at a time. City's trips per live ray fell from 49.9 to
//     24.0 (closest; gfxexp_torch/walk_trips.py), its time to 0.92.
//   - A persistent grid fed by a counter: as many blocks as the SMs hold,
//     each warp taking 32 rays at a time until none are left, so no block
//     waits on its slowest warp and no partial last wave idles. Where the
//     chunk boxes fit one shared-memory tile (every bench scene) each block
//     stages them once; more boxes are read through __ldg by each ray's
//     scan, a table without boxes is walked whole. With the batch: 0.866 /
//     0.886 of the earlier walk's time on city (closest / any), 0.891 /
//     0.895 on big (H100 80GB HBM3 at 700 W; PERF.md). The grid's size is
//     asked of the card once, and the counters live with the caller, who
//     zeroes them once; each launch's last warp sets them back to 0, so a
//     launch costs the host no fill and no query.
// Timed and dropped: registers capped for 5 blocks a SM (even with the
// uncapped 109-128, 4 blocks) and for 6 (1.08-1.18x: spills). The plain
// PyTorch version is walk_chunked_plain in gfxexp_torch/accel/persistent.py;
// it visits the same chunks in the same order with the same arithmetic, so
// with --fmad=false the results are equal.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing (the grid's counters come from the
// caller).

#include <stdint.h>

#include "widerow_walk.cuh"

// The arguments, one struct (accel/persistent.py _ChunkedArgs mirrors it).
// nodes: [n_chunks, rows_per_chunk, 64] float32; lo, hi: [n_chunks, 3]
// chunk boxes, or both null for one table walked whole. stack_depth is the
// table's bound, checked against kMaxStack. counters: two unsigned ints on
// the device, zero before the first launch on the stream; each launch
// leaves them zero again.
struct ChunkedArgs {
  int any_hit, arity, n_chunks, rows_per_chunk, max_leaf, stack_depth, n;
  const float* nodes;
  const float* lo;
  const float* hi;
  unsigned int* counters;
  const float *o, *d;  // [n, 3]
  const float *tmin, *tmax;
  float *t, *u, *v;  // out
  int* tri;
  unsigned char* hit;
};

namespace {

using widerow::Best;
using widerow::kMaxStack;

constexpr int kBlock = 128;
constexpr int kMaxDevices = 64;  // cards whose grid size a launch caches

// How a launch finds the chunks a ray walks: one table walked whole (no
// chunk boxes); the boxes staged once in shared memory by each block
// (count <= kBoxTile); or the boxes read through __ldg by each ray's scan.
enum Chunks { kWhole, kTile, kLdg };

// A persistent grid: with kTile each block stages the chunk boxes once;
// then each warp takes the next 32 rays from counters[0], walks them (the
// pick's one scan, no barrier), and comes back until the rays run out. The
// last warp to finish (counted in counters[1]) sets both counters back to
// 0, so the next launch on the stream finds them as the first did.
template <bool kAnyHit, int K, Chunks kChunks>
__global__ void __launch_bounds__(kBlock)
chunked_walk(const float* __restrict__ nodes, int n_chunks,
             int rows_per_chunk, int max_leaf, const float* __restrict__ lo,
             const float* __restrict__ hi, int n,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmin_in,
             const float* __restrict__ tmax_in, float* __restrict__ out_t,
             float* __restrict__ out_u, float* __restrict__ out_v,
             int* __restrict__ out_tri, unsigned char* __restrict__ out_hit,
             unsigned int* __restrict__ counters) {
  extern __shared__ float4 pick_tile[];  // pick_smem_bytes(n_chunks), kTile
  if (kChunks == kTile) {
    widerow::stage_boxes(lo, hi, 0, n_chunks,
                         reinterpret_cast<float*>(pick_tile));
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int n_rows = n_chunks * rows_per_chunk;
  int stack[kMaxStack];
  while (true) {
    unsigned int base = 0;
    if (lane == 0) base = atomicAdd(counters, 32u);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= (unsigned int)n) break;
    const int i = (int)base + lane;
    const float tmax = i < n ? tmax_in[i] : -1.0f;
    Best best{tmax, 0.0f, 0.0f, -1};
    if (tmax >= 0.0f) {
      const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
      const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
      const float tmin = tmin_in[i];
      if (kChunks == kWhole) {
        widerow::walk<kAnyHit, K, true>(nodes, n_rows, 0, 0, max_leaf, ox,
                                        oy, oz, dx, dy, dz, tmin, best,
                                        stack);
      } else {
        constexpr widerow::BoxScan kScan = kChunks == kTile
                                               ? widerow::BoxScan::kStaged
                                               : widerow::BoxScan::kLdg;
        widerow::nearest_first<kScan>(
            lo, hi, n_chunks, pick_tile, true, ox, oy, oz,
            widerow::safe_inv(dx), widerow::safe_inv(dy),
            widerow::safe_inv(dz), tmin, best, [&](int c) {
              return widerow::walk<kAnyHit, K, true>(
                  nodes, n_rows, c * rows_per_chunk, 0, max_leaf, ox, oy, oz,
                  dx, dy, dz, tmin, best, stack);
            });
      }
    }
    if (i < n) {
      out_t[i] = best.t;
      out_u[i] = best.u;
      out_v[i] = best.v;
      out_tri[i] = best.tri;
      out_hit[i] = best.tri >= 0 ? 1 : 0;
    }
  }
  if (lane == 0) {
    __threadfence();  // this warp's last take from counters[0] comes first
    const unsigned int warps = gridDim.x * (kBlock / 32);
    if (atomicAdd(counters + 1, 1u) == warps - 1) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }
}

template <bool kAnyHit, int K, Chunks kChunks>
cudaError_t launch_chunks(const float* nodes, int n_chunks,
                          int rows_per_chunk, int max_leaf, const float* lo,
                          const float* hi, int n, const float* o,
                          const float* d, const float* tmin,
                          const float* tmax, float* t, float* u, float* v,
                          int* tri, unsigned char* hit, cudaStream_t stream,
                          unsigned int* counters) {
  // as many blocks as the card holds at once (asked once per card, at the
  // largest tile), and no more than the rays need
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, chunked_walk<kAnyHit, K, kChunks>, kBlock,
          kChunks == kTile ? widerow::pick_smem_bytes(widerow::kBoxTile)
                           : 0);
    }
    if (err != cudaSuccess) return err;
    resident[dev] = sms * max(per_sm, 1);
  }
  const int grid = min(resident[dev], (n + kBlock - 1) / kBlock);
  const int smem = kChunks == kTile ? widerow::pick_smem_bytes(n_chunks) : 0;
  chunked_walk<kAnyHit, K, kChunks><<<grid, kBlock, smem, stream>>>(
      nodes, n_chunks, rows_per_chunk, max_leaf, lo, hi, n, o, d, tmin, tmax,
      t, u, v, tri, hit, counters);
  return cudaGetLastError();
}

template <bool kAnyHit, int K>
cudaError_t launch(const float* nodes, int n_chunks, int rows_per_chunk,
                   int max_leaf, const float* lo, const float* hi, int n,
                   const float* o, const float* d, const float* tmin,
                   const float* tmax, float* t, float* u, float* v, int* tri,
                   unsigned char* hit, cudaStream_t stream,
                   unsigned int* counters) {
#define GFX_LAUNCH(C)                                                        \
  launch_chunks<kAnyHit, K, C>(nodes, n_chunks, rows_per_chunk, max_leaf,   \
                               lo, hi, n, o, d, tmin, tmax, t, u, v, tri,   \
                               hit, stream, counters)
  if (lo == nullptr) return GFX_LAUNCH(kWhole);
  return n_chunks <= widerow::kBoxTile ? GFX_LAUNCH(kTile) : GFX_LAUNCH(kLdg);
#undef GFX_LAUNCH
}

}  // namespace

extern "C" {

// sizeof(ChunkedArgs), so the caller can check its layout
int chunked_walk_args_size() { return (int)sizeof(ChunkedArgs); }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int chunked_walk_launch(const ChunkedArgs* args, cudaStream_t stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const ChunkedArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.n_chunks <= 0 || a.rows_per_chunk <= 0 || a.counters == nullptr ||
      (int64_t)a.n_chunks * a.rows_per_chunk > INT32_MAX || a.max_leaf < 0 ||
      a.max_leaf > 5 || a.stack_depth > kMaxStack ||
      (a.lo == nullptr) != (a.hi == nullptr) ||
      (a.lo == nullptr && a.n_chunks != 1)) {
    return (int)cudaErrorInvalidValue;
  }
#define GFX_LAUNCH(A, K)                                                     \
  launch<A, K>(a.nodes, a.n_chunks, a.rows_per_chunk, a.max_leaf, a.lo,      \
               a.hi, a.n, a.o, a.d, a.tmin, a.tmax, a.t, a.u, a.v, a.tri,    \
               a.hit, stream, a.counters)
  cudaError_t err;
  if (a.arity == 4) {
    err = a.any_hit ? GFX_LAUNCH(true, 4) : GFX_LAUNCH(false, 4);
  } else if (a.arity == 8) {
    err = a.any_hit ? GFX_LAUNCH(true, 8) : GFX_LAUNCH(false, 8);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef GFX_LAUNCH
  return (int)err;
}

}  // extern "C"
