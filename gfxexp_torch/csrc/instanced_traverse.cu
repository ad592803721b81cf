// Two-level (instanced) wide-row walk: closest hit and any hit, each ray
// walked on its own, over the TLAS entries of an InstancedAccel
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
// worklists existed to keep VMEM rows busy; here each ray takes its own
// entries. Two kernels:
//   - instanced_walk, nearest-first, one thread per ray: the entries whose
//     world AABB the ray enters within [t_min, best_t], in ascending key
//     (entry distance, entry index), stopping at the first whose distance
//     is >= best_t (widerow::nearest_first, shared with the chunked and
//     quantized walks).
//   - build_walk, build order: entries in their stored (BLAS-sorted) order,
//     each visited when the ray enters its world AABB within [t_min,
//     best_t].
// A visited entry transforms the ray into object space with the 12 floats of
// its 3x4 world->object matrix (m0*ox + m1*oy + m2*oz + m3; the direction is
// not renormalised, so t is preserved) and walks BLAS blas_ids[c] from row
// start_rows[c] of the flat [B*R, 64] table (widerow_walk.cuh); best_t
// carries across entries. Any hit stops at the first accepted triangle.
//
// Nearest-first. What bounded it: the pick rescanned every entry box at
// every pick (v + 1 scans of all C boxes for v visits; 514 on `city`, 2,056
// with rebraid4). Now the block stages the boxes in shared memory and a ray
// scans them once, keeping its nearest kPick keys in registers
// (widerow_walk.cuh says why it still visits exactly what the rescan
// visited). What bounds it now: that one scan (two shared-memory loads and
// about 30 operations a box per ray) and the dependent row loads of the
// BLAS walks; lanes of a warp that walk different BLASes diverge (the
// ray-sorted route runs about a fifth faster). The BLAS stack stays in local
// memory: a shared-memory top of 32 entries was slower (L1 holds the
// stack's top as it is).
//
// Build order. What bounded it: a warp ran its lanes through the entries in
// step, so at each entry some lane visited, the others waited for its BLAS
// walk; a warp paid, for every entry in the union of its lanes' lists, the
// longest walk there (lane utilisation 0.10 on `city` closest hit,
// gfxexp_torch/walk_trips.py), and every lane tested every box (514 on
// `city`: the scan is the whole of the kernel's bound by operations). It
// also carried the nearest-first kernel's register cap and so walked without
// the row batch. Now (build_walk): a persistent grid fed by a counter; the
// warp tests a window of 32 boxes in step into each lane's mask of
// candidates, skipping the window, and inside it each run of kSub boxes,
// where no lane enters their union box; each lane then visits its own
// candidates of the window, so the lanes' walks overlap (utilisation 0.10
// -> 0.13 on `city` closest hit); the walks take the row batch, the
// registers uncapped (107-114, 4 blocks a SM, no spills). `city`, per
// 262,144-ray batch, closest / any: 0.748 / 0.565 of the parent's time,
// rebraid4 0.731 / 0.495, `big` 0.956 / 0.960; windows without the runs of
// 8 0.764 / 0.604, 0.758 / 0.532, 0.949 / 0.979 (H100 80GB HBM3 at 700 W;
// PERF.md). Measured against windows alone and dropped: no union boxes
// (0.910 / 0.979 on `city`, where they skip 32% / 67% of the windows), no
// row batch (0.779 / 0.586, but `big` any 1.061),
// registers capped for 6 blocks (0.771 / 0.616, spills) or 5 (0.730 /
// 0.602, rebraid4 0.757 / 0.552, spills), and each lane on its own cursor
// over all boxes, skipping windows it misses (1.071 / 0.842, rebraid4 2.36
// / 1.33: its scans no longer run in step and read scattered boxes). The
// bench scenes' four BLAS tables hold 7,940 triangles and, padded to the
// largest BLAS's row count, about 2 MB, which stays in L2.
//
// The plain PyTorch version is walk_instanced_plain in
// gfxexp_torch/accel/instanced.py; it visits entries in the same order with
// the same arithmetic, so with --fmad=false the results are equal, bit for
// bit.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing (the build order's counters and window
// boxes come from the caller).

#include <stdint.h>

#include "widerow_walk.cuh"

// The arguments, one struct (accel/instanced.py _InstancedArgs mirrors
// it). stack_depth is the deepest BLAS's bound, checked against kMaxStack.
// Build order only (else unused): counters, two unsigned ints on the
// device, zero before the first launch on the stream, which each launch
// leaves zero again; group_lo, group_hi [ceil(C / 32) + ceil(C / 8), 3],
// the union of each run of 32 entry boxes, then of each run of 8.
struct InstancedArgs {
  int any_hit, nearest, arity, n_rows, n_blas_rows, max_leaf, stack_depth,
      n_entries, n;
  const float* nodes;
  const int* blas_ids;  // [n_entries]
  const int* start_rows;
  const float* inv_transforms;  // [n_entries, 16]
  const float* entry_lo;        // [n_entries, 3]
  const float* entry_hi;
  int* entry;  // [n] out
  unsigned int* counters;
  const float* group_lo;
  const float* group_hi;
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
// Build order: the entries a candidate mask covers (a window), tested only
// where some lane of the warp enters their union box (Entries::glo, ghi).
constexpr int kWindow = 32;
static_assert(kWindow == 32, "a window's candidates are one 32-bit mask");
// boxes under one union box inside a window (kWindow: none)
constexpr int kSub = 8;
static_assert(kWindow % kSub == 0, "a window holds whole runs of kSub");

struct Entries {
  int count;
  const int* __restrict__ blas;   // [C]
  const int* __restrict__ start;  // [C] BLAS row the entry starts at
  const float* __restrict__ tf;   // [C, 16] world->object 3x4, row-major
  const float* __restrict__ lo;   // [C, 3] world AABB
  const float* __restrict__ hi;   // [C, 3]
  // [n_windows + ceil(C / kSub), 3]: the union of each window's boxes, then
  // of each run of kSub boxes (build order)
  const float* __restrict__ glo;
  const float* __restrict__ ghi;
  int n_windows;  // ceil(C / kWindow)
};

// Transform the ray into entry c's object space and walk its BLAS (with the
// row batch when kBatch, widerow::step). Returns true when kAnyHit and a
// triangle was accepted.
template <bool kAnyHit, int K, bool kBatch>
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
  return widerow::walk<kAnyHit, K, kBatch>(
      nodes, n_rows, base, __ldg(e.start + c), max_leaf, ox2, oy2, oz2, dx2,
      dy2, dz2, tmin, best, stack);
}

// Nearest-first. At least 6 blocks a SM: the compiler's own choice (about 95
// registers) leaves room for 5, and the walk, bound by the latency of its
// dependent loads, ran faster on the card with the registers capped for 6.
// Its BLAS walks go without the row batch: its registers spill under that
// cap, and the walks ran 10-25% slower with it (PERF.md).
template <bool kAnyHit, int K>
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
  widerow::nearest_first(
      e.lo, e.hi, e.count, pick_tile, live, ox, oy, oz, ix, iy, iz, tmin,
      best, [&](int c) {
        const float before = best.t;
        const bool stop = visit<kAnyHit, K, false>(
            nodes, n_rows, n_blas_rows, max_leaf, e, c, ox, oy, oz, dx, dy,
            dz, tmin, best, stack);
        if (best.t < before) best_entry = c;
        return stop;
      });
  if (i >= n) return;
  out_t[i] = best.t;
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_tri[i] = best.tri;
  out_hit[i] = best.tri >= 0 ? 1 : 0;
  out_entry[i] = best_entry;
}

// Build order, on a persistent grid: each warp takes 32 rays from
// counters[0] until none are left (the last warp to finish, counted in
// counters[1], sets both back to 0). The warp runs through the entries a
// window of kWindow at a time. In step, each lane tests the window's boxes
// against its best.t (broadcast loads: every lane reads the same box) into
// a mask of candidates; the window, and each run of kSub boxes in it, is
// skipped where no lane enters its union box (a ray that misses the union
// misses each member: the slab test is monotone in the corners). Then each
// lane takes its own candidates in ascending order: it tests the next one
// again against best.t as it now stands (the mask's test used the best.t of
// the window's start, which is no smaller, and a box that failed against it
// fails against any smaller), skips it if it fails, else visits it. So a
// ray visits exactly the entries the plain version visits, in the same
// order, each tested against the best.t it holds at that point, and the
// lanes' walks of a window overlap where the lock-step loop ran them one
// entry at a time.
template <bool kAnyHit, int K>
__global__ void __launch_bounds__(kBlock)
build_walk(const float* __restrict__ nodes, int n_rows, int n_blas_rows,
           int max_leaf, Entries e, int n, const float* __restrict__ o,
           const float* __restrict__ d, const float* __restrict__ tmin_in,
           const float* __restrict__ tmax_in, float* __restrict__ out_t,
           float* __restrict__ out_u, float* __restrict__ out_v,
           int* __restrict__ out_tri, unsigned char* __restrict__ out_hit,
           int* __restrict__ out_entry, unsigned int* __restrict__ counters) {
  const unsigned int full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int stack[kMaxStack];
  while (true) {
    unsigned int base = 0;
    if (lane == 0) base = atomicAdd(counters, 32u);
    base = __shfl_sync(full, base, 0);
    if (base >= (unsigned int)n) break;
    const int i = (int)base + lane;
    const float tmax = i < n ? tmax_in[i] : -1.0f;
    Best best{tmax, 0.0f, 0.0f, -1};
    int best_entry = -1;
    bool done = !(tmax >= 0.0f);  // a ray with t_max < 0 does no work
    const int j = done ? 0 : i;
    const float ox = o[3 * j + 0], oy = o[3 * j + 1], oz = o[3 * j + 2];
    const float dx = d[3 * j + 0], dy = d[3 * j + 1], dz = d[3 * j + 2];
    const float tmin = tmin_in[j];
    const float ix = widerow::safe_inv(dx);
    const float iy = widerow::safe_inv(dy);
    const float iz = widerow::safe_inv(dz);
    for (int w0 = 0; w0 < e.count; w0 += kWindow) {
      if (__all_sync(full, done)) break;
      const int m = min(kWindow, e.count - w0);
      const float scan_t = best.t;
      bool scan = !done;
      if (scan) {
        widerow::box_near(e.glo, e.ghi, w0 / kWindow, ox, oy, oz, ix, iy, iz,
                          tmin, scan_t, scan);
      }
      if (!__any_sync(full, scan)) continue;
      unsigned int mask = 0;
      for (int s0 = 0; s0 < m; s0 += kSub) {
        // the runs' union boxes follow the windows' in glo, ghi
        bool sub = scan;
        if (kSub < kWindow) {
          if (sub) {
            const int g = e.n_windows + (w0 + s0) / kSub;
            widerow::box_near(e.glo, e.ghi, g, ox, oy, oz, ix, iy, iz, tmin,
                              scan_t, sub);
          }
          if (!__any_sync(full, sub)) continue;
        }
        if (sub) {
          for (int b = s0; b < min(s0 + kSub, m); ++b) {
            bool ok;
            widerow::box_near(e.lo, e.hi, w0 + b, ox, oy, oz, ix, iy, iz,
                              tmin, scan_t, ok);
            mask |= (ok ? 1u : 0u) << b;
          }
        }
      }
      while (true) {
        // the next candidate that still passes (the same test, unless
        // best.t has not moved since the mask's)
        int c = -1;
        while (mask != 0) {
          const int b = __ffs(mask) - 1;
          mask &= mask - 1;
          bool ok = true;
          if (best.t != scan_t) {
            widerow::box_near(e.lo, e.hi, w0 + b, ox, oy, oz, ix, iy, iz,
                              tmin, best.t, ok);
          }
          if (ok) {
            c = w0 + b;
            break;
          }
        }
        if (c < 0) break;
        const float before = best.t;
        const bool stop = visit<kAnyHit, K, true>(
            nodes, n_rows, n_blas_rows, max_leaf, e, c, ox, oy, oz, dx, dy,
            dz, tmin, best, stack);
        if (best.t < before) best_entry = c;
        if (stop) {
          done = true;
          break;
        }
      }
    }
    if (i < n) {
      out_t[i] = best.t;
      out_u[i] = best.u;
      out_v[i] = best.v;
      out_tri[i] = best.tri;
      out_hit[i] = best.tri >= 0 ? 1 : 0;
      out_entry[i] = best_entry;
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

template <bool kAnyHit, int K>
cudaError_t launch_nearest(const float* nodes, int n_rows, int n_blas_rows,
                           int max_leaf, const Entries& e, int n,
                           const float* o, const float* d, const float* tmin,
                           const float* tmax, float* t, float* u, float* v,
                           int* tri, unsigned char* hit, int* entry,
                           cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  instanced_walk<kAnyHit, K>
      <<<grid, kBlock, widerow::pick_smem_bytes(e.count), stream>>>(
          nodes, n_rows, n_blas_rows, max_leaf, e, n, o, d, tmin, tmax, t, u,
          v, tri, hit, entry);
  return cudaGetLastError();
}

template <bool kAnyHit, int K>
cudaError_t launch_build(const float* nodes, int n_rows, int n_blas_rows,
                         int max_leaf, const Entries& e, int n,
                         const float* o, const float* d, const float* tmin,
                         const float* tmax, float* t, float* u, float* v,
                         int* tri, unsigned char* hit, int* entry,
                         cudaStream_t stream, unsigned int* counters) {
  // as many blocks as the card holds at once (asked once per card), and no
  // more than the rays need
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
          &per_sm, build_walk<kAnyHit, K>, kBlock, 0);
    }
    if (err != cudaSuccess) return err;
    resident[dev] = sms * max(per_sm, 1);
  }
  const int grid = min(resident[dev], (n + kBlock - 1) / kBlock);
  build_walk<kAnyHit, K><<<grid, kBlock, 0, stream>>>(
      nodes, n_rows, n_blas_rows, max_leaf, e, n, o, d, tmin, tmax, t, u, v,
      tri, hit, entry, counters);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(int any_hit, int nearest, const float* nodes,
                     int n_rows, int n_blas_rows, int max_leaf,
                     const Entries& e, int n, const float* o, const float* d,
                     const float* tmin, const float* tmax, float* t, float* u,
                     float* v, int* tri, unsigned char* hit, int* entry,
                     cudaStream_t stream, unsigned int* counters) {
#define GFX_NEAREST(A)                                                     \
  launch_nearest<A, K>(nodes, n_rows, n_blas_rows, max_leaf, e, n, o, d,   \
                       tmin, tmax, t, u, v, tri, hit, entry, stream)
#define GFX_BUILD(A)                                                       \
  launch_build<A, K>(nodes, n_rows, n_blas_rows, max_leaf, e, n, o, d,     \
                     tmin, tmax, t, u, v, tri, hit, entry, stream, counters)
  if (any_hit) return nearest ? GFX_NEAREST(true) : GFX_BUILD(true);
  return nearest ? GFX_NEAREST(false) : GFX_BUILD(false);
#undef GFX_NEAREST
#undef GFX_BUILD
}

}  // namespace

extern "C" {

// sizeof(InstancedArgs), so the caller can check its layout
int instanced_walk_args_size() { return (int)sizeof(InstancedArgs); }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int instanced_walk_launch(const InstancedArgs* args, cudaStream_t stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const InstancedArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.n_rows <= 0 || a.n_blas_rows <= 0 || a.n_entries < 0 ||
      a.max_leaf < 0 || a.max_leaf > 5 || a.stack_depth > kMaxStack ||
      (!a.nearest &&
       (a.counters == nullptr ||
        (a.n_entries > 0 &&
         (a.group_lo == nullptr || a.group_hi == nullptr))))) {
    return (int)cudaErrorInvalidValue;
  }
  const Entries e{a.n_entries,      a.blas_ids, a.start_rows,
                  a.inv_transforms, a.entry_lo, a.entry_hi,
                  a.group_lo,       a.group_hi,
                  (a.n_entries + kWindow - 1) / kWindow};
  if (a.arity == 4) {
    return (int)dispatch<4>(a.any_hit, a.nearest, a.nodes, a.n_rows,
                            a.n_blas_rows, a.max_leaf, e, a.n, a.o, a.d,
                            a.tmin, a.tmax, a.t, a.u, a.v, a.tri, a.hit,
                            a.entry, stream, a.counters);
  }
  if (a.arity == 8) {
    return (int)dispatch<8>(a.any_hit, a.nearest, a.nodes, a.n_rows,
                            a.n_blas_rows, a.max_leaf, e, a.n, a.o, a.d,
                            a.tmin, a.tmax, a.t, a.u, a.v, a.tri, a.hit,
                            a.entry, stream, a.counters);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
