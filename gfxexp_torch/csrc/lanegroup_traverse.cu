// Lane-group wide-row walk: closest hit over a single-chunk wide-row table
// (gfxexp_torch/accel/widerow.py) with one cursor and one stack shared by
// each group of 128 / G consecutive rays, G in {1, 2, 4}.
//
// Replaces the TPU kernel _make_kernel (gfxexp_tpu/accel/pallas_lanegroup.py
// :49, launched by _run :241), a measurement prototype that only tests and
// perf/ reach. The TPU kernel split each 128-lane row of rays into G groups
// with a cursor each and built lane-mixed component vectors so one VPU pass
// tested every lane against its group's row; here a block of 128 threads
// holds the G groups: G = 4, a group is a warp; G = 2 or 1, it is 2 or 4
// warps, which combine their warps' votes through shared memory behind one
// barrier a step (named barrier 1 + group for G = 2, so a group that has
// finished no longer steps with its neighbour; the vote slots are
// double-buffered by the parity of the group's votes).
//
// A step: each warp stages the group's row in shared memory (16 lanes, one
// float4 each) and reads it back by broadcast. Internal: the lanes that
// take part are listed (ballot, popc) and their (ray, child) pairs spread
// over the warp, pair p = slot * K + child on lane p % 32, each running the
// slab test against its ray's [t_min, best_t]; per child, __reduce_or_sync
// gives the warp's lanes whose test hit it and __reduce_min_sync the
// smallest entry distance, as an order-preserving unsigned key, for the
// children some lane hit. The valid children are sorted by the group's
// smallest entry distance (the K-wide network of widerow_walk.cuh, skipped
// when at most one is valid) and the nearest descended, the rest pushed
// far to near onto the group's stack in shared memory (each warp's copy:
// the row and the mask of its lanes whose own test hit it). A lane takes
// part in a row (tests, leaf triangles, counts the row) only where its own
// box tests led there, so its result is the per-ray walk's, up to ties in
// t. Leaf: the lanes that take part run the Baldwin-Weber tests of
// widerow_walk.cuh on the staged row. Rays past the end of the batch and
// rays with t_max < 0 take part as dead rays. The plain PyTorch version is
// walk_lanegroup_plain in gfxexp_torch/accel/lanegroup.py; both apply the
// same operations in the same order, so with --fmad=false their results
// (and the rows each ray took part in) are equal.
//
// What bounds it: the instructions each warp issues at every step of its
// group (on the small scene 92 / 159 / 273 steps a group for G = 4 / 2 /
// 1, with 0.098 / 0.057 / 0.033 of the lanes taking part,
// gfxexp_torch/walk_trips.py), not the row loads (the table stays in L2)
// nor the barriers alone. The earlier kernel had every lane load the row
// (14-16 __ldg), run K slab tests and K float reductions of 5 shuffles,
// keep the stack in a 512-byte local array and pass two block barriers a
// step; this one reads 0.605 / 0.629 / 0.823 of its time (G = 1 / 2 / 4,
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md) at 56-64
// registers and no stack (the earlier: 512 bytes). Timed and
// dropped: the same step with K reductions of each kind always and the
// network always 0.711 / 0.846 / 0.882; a leaf's tests as (ray, triangle)
// pairs spread over the warp, each ray taking its results in triangle
// order, 0.634 / 0.658 / 0.847.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <stdint.h>

#include "widerow_walk.cuh"

// The arguments, one struct (accel/lanegroup.py _LanegroupArgs mirrors
// it). nodes: [n_rows, 64] float32 (one table); rows: per-ray rows taken
// part in, or null. stack_depth is the table's bound, checked against
// kMaxStack.
struct LanegroupArgs {
  int groups, arity, n_rows, max_leaf, stack_depth, n;
  const float* nodes;
  int* rows;  // [n] out, or null
  const float *o, *d;  // [n, 3]
  const float *tmin, *tmax;
  float *t, *u, *v;  // out
  int* tri;
  unsigned char* hit;
};

namespace {

using widerow::Best;
using widerow::kMaxStack;
using widerow::kWidth;

constexpr int kBlock = 128;
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr int kRowQuads = kWidth / 4;  // float4 of a row
constexpr unsigned kFull = 0xffffffffu;

// An order-preserving unsigned key of a float, for __reduce_min_sync (float
// redux.sync is sm_100a only): f >= 0 -> bits ^ 0x80000000, else ~bits. The
// minimum is exact; -0.0 keys below +0.0, which the sort network compares
// equal, so the children's order does not change.
__device__ __forceinline__ unsigned near_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b ^ 0x80000000u);
}

__device__ __forceinline__ float key_near(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// The K-wide network of widerow::sort_children (the plain version's), also
// carrying each child's mask of the warp's lanes whose own test hit it.
__device__ __forceinline__ void cswap(float* nr, int* mt, bool* vd,
                                      unsigned* mk, int a, int b) {
  if (nr[a] > nr[b]) {
    const float tn = nr[a]; nr[a] = nr[b]; nr[b] = tn;
    const int tm = mt[a]; mt[a] = mt[b]; mt[b] = tm;
    const bool tv = vd[a]; vd[a] = vd[b]; vd[b] = tv;
    const unsigned tk = mk[a]; mk[a] = mk[b]; mk[b] = tk;
  }
}

template <int K>
__device__ __forceinline__ void sort_children(float* nr, int* mt, bool* vd,
                                              unsigned* mk);

template <>
__device__ __forceinline__ void sort_children<4>(float* nr, int* mt,
                                                 bool* vd, unsigned* mk) {
  cswap(nr, mt, vd, mk, 0, 1); cswap(nr, mt, vd, mk, 2, 3);
  cswap(nr, mt, vd, mk, 0, 2); cswap(nr, mt, vd, mk, 1, 3);
  cswap(nr, mt, vd, mk, 1, 2);
}

template <>
__device__ __forceinline__ void sort_children<8>(float* nr, int* mt,
                                                 bool* vd, unsigned* mk) {
  cswap(nr, mt, vd, mk, 0, 1); cswap(nr, mt, vd, mk, 2, 3);
  cswap(nr, mt, vd, mk, 4, 5); cswap(nr, mt, vd, mk, 6, 7);
  cswap(nr, mt, vd, mk, 0, 2); cswap(nr, mt, vd, mk, 1, 3);
  cswap(nr, mt, vd, mk, 4, 6); cswap(nr, mt, vd, mk, 5, 7);
  cswap(nr, mt, vd, mk, 1, 2); cswap(nr, mt, vd, mk, 5, 6);
  cswap(nr, mt, vd, mk, 0, 4); cswap(nr, mt, vd, mk, 3, 7);
  cswap(nr, mt, vd, mk, 1, 5); cswap(nr, mt, vd, mk, 2, 6);
  cswap(nr, mt, vd, mk, 3, 6); cswap(nr, mt, vd, mk, 2, 4);
  cswap(nr, mt, vd, mk, 1, 2); cswap(nr, mt, vd, mk, 3, 5);
  cswap(nr, mt, vd, mk, 4, 5); cswap(nr, mt, vd, mk, 3, 4);
}

// The barrier of a group of kWarps warps: the block's for one group, else
// named barrier 1 + group over its 32 * kWarps threads, so a group that has
// finished no longer steps with its neighbour.
template <int kWarps>
__device__ __forceinline__ void group_sync(int group) {
  static_assert(kWarps == kWarpsPerBlock || kWarps == 2,
                "a group spans one block or half of one");
  if (kWarps == kWarpsPerBlock) {
    __syncthreads();
  } else if (group == 0) {
    asm volatile("bar.sync 1, 64;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 64;\n" ::: "memory");
  }
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
  // per warp: the group's current row, its lanes' rays (o.xyz t_min |
  // 1/d.xyz best t), the list of its lanes that take part, and its copy of
  // the group's stack (row, mask of its lanes whose own test hit the row)
  __shared__ float4 s_row[kWarpsPerBlock][kRowQuads];
  __shared__ float4 s_ray[kWarpsPerBlock][32][2];
  __shared__ int s_list[kWarpsPerBlock][32];
  __shared__ int2 s_stack[kWarpsPerBlock][kMaxStack];
  // per warp of a group that spans warps: its vote and its smallest entry
  // key per child, double-buffered by the parity of the group's votes
  __shared__ unsigned s_vote[2][kWarpsPerBlock];
  __shared__ unsigned s_key[2][kWarpsPerBlock][K];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp / kWarps;
  const int first_warp = group * kWarps;
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
  s_ray[warp][lane][0] = make_float4(ox, oy, oz, tmin);
  s_ray[warp][lane][1] = make_float4(ix, iy, iz, best.t);
  float* best_t_slot = reinterpret_cast<float*>(&s_ray[warp][lane][1]) + 3;
  const float* row_f = reinterpret_cast<const float*>(s_row[warp]);
  const int kc = lane % K;  // the child this lane tests (32 % K == 0)
  int cur = 0;  // uniform over the group
  int sp = 0;
  int rows = 0;
  int phase = 0;
  while (cur >= 0) {
    // the row, staged by the warp: 16 lanes load a float4 each
    const int r = min(cur, n_rows - 1);
    __syncwarp();  // the last step's reads (and writes) are done
    if (lane < kRowQuads) {
      s_row[warp][lane] = __ldg(
          reinterpret_cast<const float4*>(nodes + (size_t)r * kWidth) + lane);
    }
    __syncwarp();
    rows += here ? 1 : 0;
    const float4 tail = s_row[warp][kRowQuads - 1];
    int nxt = -1;
    if (tail.w > 0.5f) {
      // leaf: the lanes that take part test its triangles, in order
      if (here) {
        const int packed = __float_as_int(tail.x);
        const int fst = packed & 0xFFFFFF;
        const int cnt = packed >> 24;
        for (int j = 0; j < max_leaf && j < cnt; ++j) {
          widerow::tri_hit(s_row[warp][3 * j], s_row[warp][3 * j + 1],
                           s_row[warp][3 * j + 2], fst + j, ox, oy, oz, dx,
                           dy, dz, tmin, best);
        }
        *best_t_slot = best.t;
      }
    } else {
      // internal: the (ray, child) pairs of the lanes that take part, spread
      // over the warp, pair p = slot * K + child on lane p % 32; per child,
      // the warp's lanes whose test hit it (mk) and their smallest entry
      // key (kmin), reduced only for the children some lane hit
      unsigned mk[K], kmin[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        mk[k] = 0u;
        kmin[k] = ~0u;
      }
      unsigned vote = 0u;
      const unsigned part = __ballot_sync(kFull, here);
      if (part != 0u) {  // uniform over the warp
        if (here) s_list[warp][__popc(part & ((1u << lane) - 1u))] = lane;
        __syncwarp();
        const int pairs = __popc(part) * K;
        unsigned own = 0u, key = ~0u;
        if (lane < pairs) {
          float c[7];
#pragma unroll
          for (int q = 0; q < 7; ++q) c[q] = row_f[7 * kc + q];
          const int meta = __float_as_int(c[6]);
          for (int p = lane; p < pairs; p += 32) {
            const int src = s_list[warp][p / K];
            const float4 ro = s_ray[warp][src][0];
            const float4 ri = s_ray[warp][src][1];
            const float tx0 = (c[0] - ro.x) * ri.x;
            const float tx1 = (c[3] - ro.x) * ri.x;
            const float ty0 = (c[1] - ro.y) * ri.y;
            const float ty1 = (c[4] - ro.y) * ri.y;
            const float tz0 = (c[2] - ro.z) * ri.z;
            const float tz1 = (c[5] - ro.z) * ri.z;
            const float near =
                fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                      fmaxf(fminf(tz0, tz1), ro.w));
            const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                    fminf(fmaxf(tz0, tz1), ri.w));
            if (near <= far && meta >= 0) {
              own |= 1u << src;
              key = min(key, near_key(near));
            }
          }
        }
        vote = __reduce_or_sync(kFull, own != 0u ? 1u << kc : 0u);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if ((vote >> k) & 1u) {  // uniform
            mk[k] = __reduce_or_sync(kFull, kc == k ? own : 0u);
            kmin[k] = __reduce_min_sync(kFull, kc == k ? key : ~0u);
          }
        }
      }
      if constexpr (kWarps > 1) {
        if (lane == 0) {
          s_vote[phase][warp] = vote;
#pragma unroll
          for (int k = 0; k < K; ++k) s_key[phase][warp][k] = kmin[k];
        }
        group_sync<kWarps>(group);
        vote = 0u;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) vote |= s_vote[phase][first_warp + w];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if ((vote >> k) & 1u) {
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
              kmin[k] = min(kmin[k], s_key[phase][first_warp + w][k]);
            }
          }
        }
        // the next vote writes the other slots; the one after, these,
        // only once every warp of the group has passed the next barrier
        phase ^= 1;
      }
      if (__popc(vote) <= 1) {
        // at most one child hit: the network would leave it first and push
        // nothing, so it is skipped (as widerow::descend skips it)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if ((vote >> k) & 1u) {
            nxt = __float_as_int(row_f[7 * k + 6]);
            here = (mk[k] >> lane) & 1u;
          }
        }
      } else {
        float nr[K];
        int mt[K];
        bool vd[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          vd[k] = (vote >> k) & 1u;
          nr[k] = vd[k] ? key_near(kmin[k]) : CUDART_INF_F;
          mt[k] = __float_as_int(row_f[7 * k + 6]);
        }
        sort_children<K>(nr, mt, vd, mk);
#pragma unroll
        for (int s = K - 1; s >= 1; --s) {
          if (vd[s]) {
            if (lane == 0 && sp < kMaxStack) {
              s_stack[warp][sp] = make_int2(mt[s], (int)mk[s]);
            }
            ++sp;
          }
        }
        if (vd[0]) {
          nxt = mt[0];
          here = (mk[0] >> lane) & 1u;
        }
      }
    }
    if (nxt < 0 && sp > 0) {
      --sp;
      const int2 e = sp < kMaxStack ? s_stack[warp][sp] : make_int2(-1, 0);
      nxt = e.x < 0 ? -1 : e.x;
      here = e.x >= 0 && ((unsigned)e.y >> lane) & 1u;
    }
    cur = nxt;
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

// sizeof(LanegroupArgs), so the caller can check its layout
int lanegroup_walk_args_size() { return (int)sizeof(LanegroupArgs); }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int lanegroup_walk_launch(const LanegroupArgs* args, cudaStream_t stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const LanegroupArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.n_rows <= 0 || a.max_leaf < 0 || a.max_leaf > 5 ||
      a.stack_depth > kMaxStack) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.arity == 4) {
    return (int)dispatch<4>(a.groups, a.nodes, a.n_rows, a.max_leaf, a.n,
                            a.o, a.d, a.tmin, a.tmax, a.t, a.u, a.v, a.tri,
                            a.hit, a.rows, stream);
  }
  if (a.arity == 8) {
    return (int)dispatch<8>(a.groups, a.nodes, a.n_rows, a.max_leaf, a.n,
                            a.o, a.d, a.tmin, a.tmax, a.t, a.u, a.v, a.tri,
                            a.hit, a.rows, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
