// Wide-row BVH walk over one table: closest hit on a persistent grid whose
// lanes each take a new ray as theirs ends, any hit one thread per ray.
//
// Replaces the TPU kernel _make_persistent_kernel
// (gfxexp_tpu/accel/pallas_persistent.py:102, launched by _run_persistent
// :352). The walk itself (and what bounds a step) is in widerow_walk.cuh,
// shared with the chunked and two-level walks. The plain PyTorch version is
// walk_plain in gfxexp_torch/accel/persistent.py; each ray takes the same
// rows in the same order with the same arithmetic, so with --fmad=false the
// results are equal.
//
// What bounds it: the chain of dependent row loads of each ray's walk (the
// small bench scene's table, 0.9 MB, stays in L2), the warps resident to
// hide them, and lanes that have nothing to do. With one thread per ray on
// a static grid a warp lasts as long as its longest ray; walk lengths are
// skewed and rays with t_max < 0 idle from the start, so on the small
// scene's bounce rays a lane walks 0.27 of its warp's steps on closest hit
// (gfxexp_torch/walk_trips.py). For closest hit (widerow_walk) the grid
// holds as many blocks as the card runs at once and each lane holds one
// ray's state (ray, reciprocals, best hit, row, stack pointer; the stack in
// local memory). The warp steps its lanes one row at a time
// (widerow::step); a lane whose ray ends writes the result and goes idle,
// and when kRefill lanes are idle the warp takes that many rays from
// counters[0] with one atomicAdd (each idle lane the base plus its rank
// among them): the persistent while-while walk with ray replacement of Aila
// and Laine, "Understanding the Efficiency of Ray Traversal on GPUs" (HPG
// 2009). Lanes then walk 0.77-0.96 of the steps (kRefill 16 to 1) where
// they walked 0.27. It ran 0.888-0.902 of the static grid's time (kRefill
// 16; 8: 0.897-0.902; 1: 0.933; 32, per-warp feeding: 1.098), at 96
// registers, 5 blocks of 128 a SM as the static grid holds, on an H100
// 80GB HBM3 at 700 W (PERF.md). Measured and
// dropped: a leaf's triangles past the first batch loaded one at a time
// (1.003), registers capped for 5, 6 or 8 blocks a SM (0.902, 1.088,
// 1.534: spills). Any hit keeps one thread per ray (widerow_walk_rays):
// shadow rays are short and coherent, and on the fed grid they ran
// 1.147-1.347 of its time.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing (the grid's counters come from the
// caller).

#include <stdint.h>

#include "widerow_walk.cuh"

// The arguments, one struct (accel/persistent.py _WiderowArgs mirrors it).
// stack_depth is the table's bound, checked against kMaxStack. counters:
// two unsigned ints on the device, zero before the first launch on the
// stream; each launch leaves them zero again.
struct WiderowArgs {
  int any_hit, arity, n_rows, max_leaf, stack_depth, n;
  const float* nodes;  // [n_rows, 64]
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
// Idle lanes a warp waits for before it takes new rays (1: as soon as one
// is idle; 32: per-warp feeding).
constexpr int kRefill = 16;

// One thread per ray on a static grid (any hit).
template <bool kAnyHit, int K>
__global__ void __launch_bounds__(kBlock)
widerow_walk_rays(const float* __restrict__ nodes, int n_rows, int max_leaf,
                  int n, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ tmin_in,
                  const float* __restrict__ tmax_in,
                  float* __restrict__ out_t, float* __restrict__ out_u,
                  float* __restrict__ out_v, int* __restrict__ out_tri,
                  unsigned char* __restrict__ out_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = tmax_in[i];
  Best best{tmax, 0.0f, 0.0f, -1};
  if (tmax >= 0.0f) {
    int stack[kMaxStack];
    widerow::walk<kAnyHit, K, true>(
        nodes, n_rows, 0, 0, max_leaf, o[3 * i + 0], o[3 * i + 1],
        o[3 * i + 2], d[3 * i + 0], d[3 * i + 1], d[3 * i + 2], tmin_in[i],
        best, stack);
  }
  out_t[i] = best.t;
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_tri[i] = best.tri;
  out_hit[i] = best.tri >= 0 ? 1 : 0;
}

// The fed grid with per-lane refill (closest hit).
template <bool kAnyHit, int K>
__global__ void __launch_bounds__(kBlock)
widerow_walk(const float* __restrict__ nodes, int n_rows, int max_leaf,
             int n, const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmin_in,
             const float* __restrict__ tmax_in, float* __restrict__ out_t,
             float* __restrict__ out_u, float* __restrict__ out_v,
             int* __restrict__ out_tri, unsigned char* __restrict__ out_hit,
             unsigned int* __restrict__ counters) {
  const unsigned int full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1u;
  int stack[kMaxStack];
  int i = -1;  // this lane's ray, -1 when the lane is idle
  int cur = -1, sp = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f, tmin = 0.0f;
  Best best{0.0f, 0.0f, 0.0f, -1};
  bool more = true;  // rays left to take (the same in every lane)
  while (true) {
    const unsigned int idle = __ballot_sync(full, i < 0);
    const int n_idle = __popc(idle);
    if (more && (n_idle >= kRefill || idle == full)) {
      unsigned int base = 0;
      if (lane == 0) base = atomicAdd(counters, (unsigned int)n_idle);
      base = __shfl_sync(full, base, 0);
      more = base + (unsigned int)n_idle < (unsigned int)n;
      const unsigned int j = base + __popc(idle & below);
      if (i < 0 && j < (unsigned int)n) {
        i = (int)j;
        const float tmax = tmax_in[i];
        best = Best{tmax, 0.0f, 0.0f, -1};
        ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
        dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
        ix = widerow::safe_inv(dx);
        iy = widerow::safe_inv(dy);
        iz = widerow::safe_inv(dz);
        tmin = tmin_in[i];
        sp = 0;
        cur = tmax >= 0.0f ? 0 : -1;  // a ray with t_max < 0 does no work
      }
    } else if (idle == full) {
      break;
    }
    if (i >= 0) {
      if (cur >= 0) {
        cur = widerow::step<kAnyHit, K>(nodes, n_rows, cur, max_leaf, ox,
                                        oy, oz, dx, dy, dz, ix, iy, iz, tmin,
                                        best, stack, sp);
      }
      if (cur < 0) {
        out_t[i] = best.t;
        out_u[i] = best.u;
        out_v[i] = best.v;
        out_tri[i] = best.tri;
        out_hit[i] = best.tri >= 0 ? 1 : 0;
        i = -1;
      }
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
cudaError_t launch(const float* nodes, int n_rows, int max_leaf, int n,
                   const float* o, const float* d, const float* tmin,
                   const float* tmax, float* t, float* u, float* v, int* tri,
                   unsigned char* hit, cudaStream_t stream,
                   unsigned int* counters) {
  if constexpr (kAnyHit) {
    widerow_walk_rays<kAnyHit, K><<<(n + kBlock - 1) / kBlock, kBlock, 0,
                                    stream>>>(nodes, n_rows, max_leaf, n, o,
                                              d, tmin, tmax, t, u, v, tri,
                                              hit);
  } else {
    // as many blocks as the card holds at once (asked once per card), and
    // no more than the rays need
    static int resident[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, widerow_walk<kAnyHit, K>, kBlock, 0);
      }
      if (err != cudaSuccess) return err;
      resident[dev] = sms * max(per_sm, 1);
    }
    const int grid = min(resident[dev], (n + kBlock - 1) / kBlock);
    widerow_walk<kAnyHit, K><<<grid, kBlock, 0, stream>>>(
        nodes, n_rows, max_leaf, n, o, d, tmin, tmax, t, u, v, tri, hit,
        counters);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(WiderowArgs), so the caller can check its layout
int widerow_walk_args_size() { return (int)sizeof(WiderowArgs); }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int widerow_walk_launch(const WiderowArgs* args, cudaStream_t stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const WiderowArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.n_rows <= 0 || a.max_leaf < 0 || a.max_leaf > 5 ||
      a.stack_depth > kMaxStack || a.counters == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
#define GFX_LAUNCH(A, K)                                                     \
  launch<A, K>(a.nodes, a.n_rows, a.max_leaf, a.n, a.o, a.d, a.tmin, a.tmax, \
               a.t, a.u, a.v, a.tri, a.hit, stream, a.counters)
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
