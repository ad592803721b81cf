// Lane-group wide-row walk: closest hit over a single-chunk wide-row table
// (gfxexp_torch/accel/widerow.py) with one cursor and one stack shared by
// each group of 128 / G consecutive rays, G in {1, 2, 4}.
//
// Replaces the TPU kernel _make_kernel (gfxexp_tpu/accel/pallas_lanegroup.py
// :49, launched by _run :241), a measurement prototype that only tests and
// perf/ reach. The TPU kernel split each 128-lane row of rays into G groups
// with a cursor each and built lane-mixed component vectors so one VPU pass
// tested every lane against its group's row; here a block of 128 threads
// holds the G groups. G = 4: a group is a warp and votes with __ballot_sync
// style reductions (__reduce_or_sync, shuffles); G = 2 or 1: a group is 2
// or 4 warps, which combine their warps' votes through shared memory with
// __syncthreads, so every thread of the block runs every step (as the
// block scope of skiplink_traverse.cu does).
//
// A step: the group reads one row. Internal: every lane slab-tests the K
// children against its own [t_min, best_t] where it took part in the row; a
// child is valid when some lane of the group hit it; the valid children are
// sorted by the group's smallest entry distance (the K-wide network of
// widerow_walk.cuh) and the nearest descended, the rest pushed far to near.
// Each stack entry carries in bit 30 whether this lane's own test hit the
// child, so a lane takes part in a row (votes, tests a leaf's triangles,
// counts the row) only where its own box tests led there; its result is
// then the per-ray walk's, up to ties in t. Leaf: the lanes that took part
// run the Baldwin-Weber tests of widerow_walk.cuh. Rays past the end of the
// batch and rays with t_max < 0 take part as dead rays.
//
// What bounds it: the dependent row loads, shared by the group (one row
// serves up to 128 lanes), and the votes: K warp reductions a step, plus
// two block barriers when a group spans warps. The plain PyTorch version
// is walk_lanegroup_plain in gfxexp_torch/accel/lanegroup.py; both apply
// the same operations in the same order, so with --fmad=false their results
// are equal.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <stdint.h>

#include "widerow_walk.cuh"

namespace {

using widerow::Best;
using widerow::kMaxStack;
using widerow::kWidth;

constexpr int kBlock = 128;
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr int kOwnBit = 1 << 30;  // stack entries: this lane's test hit it
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    x = fminf(x, __shfl_xor_sync(kFull, x, s));
  }
  return x;
}

template <int G, int K>
__global__ void __launch_bounds__(kBlock)
lanegroup_walk(const float* __restrict__ nodes, int n_rows, int max_leaf,
               int n, const float* __restrict__ o,
               const float* __restrict__ d,
               const float* __restrict__ tmin_in,
               const float* __restrict__ tmax_in, float* __restrict__ out_t,
               float* __restrict__ out_u, float* __restrict__ out_v,
               int* __restrict__ out_tri, unsigned char* __restrict__ out_hit,
               int* __restrict__ out_rows) {
  constexpr int kWarps = kWarpsPerBlock / G;  // warps of a group
  __shared__ float s_near[kWarpsPerBlock][K];
  __shared__ unsigned s_vote[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first_warp = warp / kWarps * kWarps;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = i < n;
  const float tmax = valid ? tmax_in[i] : -1.0f;
  Best best{tmax, 0.0f, 0.0f, -1};
  bool here = tmax >= 0.0f;  // this lane takes part in the group's row
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 0.0f, dz = 0.0f;
  float tmin = 0.0f;
  if (valid) {
    ox = o[3 * i + 0];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i + 0];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    tmin = tmin_in[i];
  }
  const float ix = widerow::safe_inv(dx);
  const float iy = widerow::safe_inv(dy);
  const float iz = widerow::safe_inv(dz);
  int stack[kMaxStack];  // the group's entries, each lane's own bit in 30
  int cur = 0;           // uniform over the group
  int sp = 0;
  int rows = 0;
  while (true) {
    if (kWarps == 1) {
      if (cur < 0) break;  // uniform over the warp
    } else if (!__syncthreads_or(cur >= 0)) {
      break;
    }
    const bool active = cur >= 0;
    const int r = min(max(cur, 0), n_rows - 1);
    const float4* row =
        reinterpret_cast<const float4*>(nodes + (size_t)r * kWidth);
    bool leaf = true;
    float nr[K];
    int mt[K];
    bool own[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      nr[k] = CUDART_INF_F;
      mt[k] = -1;
      own[k] = false;
    }
    if (active) {
      rows += here ? 1 : 0;
      const float4 tail = __ldg(row + 15);
      leaf = tail.w > 0.5f;
      if (leaf) {
        if (here) {
          widerow::leaf_hits<false>(row, tail, max_leaf, ox, oy, oz, dx, dy,
                                    dz, tmin, best);
        }
      } else {
        float c[7 * K];
#pragma unroll
        for (int q = 0; q < 7 * K / 4; ++q) {
          const float4 f = __ldg(row + q);
          c[4 * q + 0] = f.x;
          c[4 * q + 1] = f.y;
          c[4 * q + 2] = f.z;
          c[4 * q + 3] = f.w;
        }
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
          own[k] = here && near <= far && meta >= 0;
          nr[k] = own[k] ? near : CUDART_INF_F;
          mt[k] = meta;
        }
      }
    }
    // the group's vote: which children some lane hit, and their smallest
    // entry distance over the lanes that hit them
    unsigned vote = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) vote |= own[k] ? 1u << k : 0u;
    vote = __reduce_or_sync(kFull, vote);
#pragma unroll
    for (int k = 0; k < K; ++k) nr[k] = warp_min(nr[k]);
    if (kWarps > 1) {
      if (lane == 0) {
        s_vote[warp] = vote;
#pragma unroll
        for (int k = 0; k < K; ++k) s_near[warp][k] = nr[k];
      }
      __syncthreads();
      vote = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) nr[k] = CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        vote |= s_vote[first_warp + w];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          nr[k] = fminf(nr[k], s_near[first_warp + w][k]);
        }
      }
      // the next step's __syncthreads_or orders these reads before the
      // next writes
    }
    if (active) {
      int nxt = -1;
      bool here_nxt = false;
      if (!leaf) {
        bool vd[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          vd[k] = (vote >> k) & 1u;
          if (!vd[k]) nr[k] = CUDART_INF_F;
          mt[k] = own[k] ? (mt[k] | kOwnBit) : mt[k];
        }
        widerow::sort_children<K>(nr, mt, vd);
#pragma unroll
        for (int s = K - 1; s >= 1; --s) {
          if (vd[s]) {
            if (sp < kMaxStack) stack[sp] = mt[s];
            ++sp;
          }
        }
        if (vd[0]) {
          nxt = mt[0] & ~kOwnBit;
          here_nxt = (mt[0] & kOwnBit) != 0;
        }
      }
      if (nxt < 0 && sp > 0) {
        --sp;
        const int e = sp < kMaxStack ? stack[sp] : -1;
        nxt = e < 0 ? -1 : (e & ~kOwnBit);
        here_nxt = e >= 0 && (e & kOwnBit) != 0;
      }
      cur = nxt;
      here = here_nxt;
    }
  }
  if (valid) {
    out_t[i] = best.t;
    out_u[i] = best.u;
    out_v[i] = best.v;
    out_tri[i] = best.tri;
    out_hit[i] = best.tri >= 0 ? 1 : 0;
    if (out_rows != nullptr) out_rows[i] = rows;
  }
}

template <int G, int K>
cudaError_t launch(const float* nodes, int n_rows, int max_leaf, int n,
                   const float* o, const float* d, const float* tmin,
                   const float* tmax, float* t, float* u, float* v, int* tri,
                   unsigned char* hit, int* rows, cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  lanegroup_walk<G, K><<<grid, kBlock, 0, stream>>>(
      nodes, n_rows, max_leaf, n, o, d, tmin, tmax, t, u, v, tri, hit, rows);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(int groups, const float* nodes, int n_rows,
                     int max_leaf, int n, const float* o, const float* d,
                     const float* tmin, const float* tmax, float* t,
                     float* u, float* v, int* tri, unsigned char* hit,
                     int* rows, cudaStream_t stream) {
#define GFX_LAUNCH(G)                                                        \
  launch<G, K>(nodes, n_rows, max_leaf, n, o, d, tmin, tmax, t, u, v, tri,   \
               hit, rows, stream)
  switch (groups) {
    case 1:
      return GFX_LAUNCH(1);
    case 2:
      return GFX_LAUNCH(2);
    case 4:
      return GFX_LAUNCH(4);
    default:
      return cudaErrorInvalidValue;
  }
#undef GFX_LAUNCH
}

}  // namespace

extern "C" {

int lanegroup_max_stack() { return kMaxStack; }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take). nodes:
// [n_rows, 64] float32 (one table); rows: per-ray rows taken part in, or
// null. stack_depth is the table's bound, checked against kMaxStack.
int lanegroup_walk_launch(int groups, int arity, const float* nodes,
                          int n_rows, int max_leaf, int stack_depth, int n,
                          const float* o, const float* d, const float* tmin,
                          const float* tmax, float* t, float* u, float* v,
                          int* tri, unsigned char* hit, int* rows,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || n_rows >= kOwnBit || max_leaf < 0 || max_leaf > 5 ||
      stack_depth > kMaxStack) {
    return (int)cudaErrorInvalidValue;
  }
  if (arity == 4) {
    return (int)dispatch<4>(groups, nodes, n_rows, max_leaf, n, o, d, tmin,
                            tmax, t, u, v, tri, hit, rows, stream);
  }
  if (arity == 8) {
    return (int)dispatch<8>(groups, nodes, n_rows, max_leaf, n, o, d, tmin,
                            tmax, t, u, v, tri, hit, rows, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
