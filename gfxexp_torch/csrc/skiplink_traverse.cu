// Skip-link BVH walk: closest hit and any hit over the packed tables of a
// SkipBVH (gfxexp_torch/accel/skiplink.py), with the cursor kept at one of
// three scopes.
//
// Replaces two TPU kernels that compute the same function:
//   - gfxexp_tpu/accel/pallas_traverse.py:63 _make_kernel (launched by _run
//     :178): one skip-link cursor per 4,096-ray tile, the TPU path of every
//     traversal="skip" scene (animated scenes);
//   - gfxexp_tpu/accel/pallas_rowcursor.py:76 _make_kernel (launched by _run
//     :206): one cursor per 128-lane row.
// Scopes (the C entry's `scope`):
//   - kThread: one cursor per ray (the default on the main path);
//   - kWarp: one cursor per 32 rays, descending when __any_sync of the
//     lanes' box tests hits (kernel 8's row cursor; its own kernel,
//     skiplink_warp_walk);
//   - kBlock: one cursor per 128-thread block, with __syncthreads_or (kernel
//     6's tile cursor); under any hit the block stops once no ray of it is
//     still live.
// A shared cursor changes which nodes are visited, never the result: a
// node's box contains its descendants' and the slab test rounds
// monotonically, so a ray that misses a node misses every leaf below it, and
// a lane tests a leaf only when its own box test hits.
//
// The step: descend (cur + 1) iff the slab test against [t_min, best_t] hits
// an internal node, else jump to its skip link; a leaf runs Moller-Trumbore
// on its count (<= max_leaf) triangles, accepting
// det_ok & u >= 0 & v >= 0 & u + v <= 1 & t > t_min & t < best_t. Any hit
// stops at the first accepted triangle; a ray with t_max < 0 does no work.
// The plain PyTorch version is walk_skip_plain in accel/skiplink.py; both
// apply the same operations in the same order, so with --fmad=false the
// results are equal bit for bit.
//
// What bounds the thread scope: one dependent 32-byte node load per step
// (two float4 loads through the read-only path) and, at leaves, 48-byte
// triangle rows, and the warps resident to hide those chains: each step
// does little else. There is no stack, so nothing spills to local memory.
// Tables of large scenes (city: 29 MB of nodes, 97.5 MB of triangles) do
// not fit the 50 MB L2. The earlier walk loaded a hit leaf's triangles one
// dependent row at a time; the closest-hit walk now loads a leaf's rows in
// one batch (`leaf` with kLeaf = the table's max_leaf of 4 or 8), which cut
// city's round trips per live ray from 83.2 to 73.6
// (gfxexp_torch/walk_trips.py) and its time to 0.859 of the earlier walk's
// (big 0.897; H100 80GB HBM3 at 700 W, PERF.md).
// Any hit keeps the one-row loop, its registers capped at 40 (12 blocks a
// SM, as the earlier walk held them; uncapped it took 45 and ran 1.09x
// slower). Timed and dropped (thread scope, city, closest / any): runs of 2
// and 4 nodes loaded at once so a descent to cur + 1 costs no trip (1.02 /
// 1.30 and 1.24 / 1.52: they fetch nodes the walk does not take and raise
// registers to 88-150), the same runs held in an array (nvcc put it in
// local memory: 1.65 / 2.21 and 2.78 / 3.90), the run from skip(cur) loaded
// as soon as node cur arrives (1.25 / 1.51 with runs of 2), the leaf batch
// for any hit (1.045 at 72 registers, 1.41-1.78 capped: spills), and
// closest hit capped for 8 blocks a SM (1.12).
//
// What bounds the warp scope: its warp walks the union of its 32 rays'
// nodes (city, closest hit: 1,139 steps a warp against 100 nodes a ray),
// one after another, and each step's box test, vote and branch are
// instructions every lane issues. The node loads were L1 hits, not trips
// to memory: a node is 32 bytes, so a 128-byte line holds four, and the
// warp's cursor walks forward through lines it has just read. The window
// (lane k holds node base + k, the current node comes by __shfl_sync) makes
// 1,139 node loads 263 window loads (walk_trips.warp_windows), and the
// leaf's staged rows serve every lane that hit it from one load; it reads
// 0.927 / 0.994 of the earlier warp scope on city, closest / any (big
// 0.944 / 0.927; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)
// at 56 / 61 registers, no spills. Timed and dropped against the
// earlier warp scope (big closest / any, city closest / any, one call):
// the window in shared memory filled by cp.async 1.278 / 1.316 (city, with
// the next window prefetched; 1.196 / 1.260 without), the window in
// registers with the next window prefetched 1.155 / 1.205 (1.069 / 1.116
// without the prefetch), all three with one
// __reduce_or_sync a step of "a lane hit" and "a lane is live" (the redux
// vote: 1.18 against 1.04 for __any_sync with each node through __ldg);
// each node through __ldg, no window, with the leaf's rows loaded by each
// lane 1.028 / 0.968 / 1.025 / 0.961 (staged: 1.044 / 1.014 / 1.110 /
// 1.011); the window with each lane loading the leaf's rows 1.025 / 0.938
// / 0.957 / 1.024.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

// The arguments, one struct (accel/skip_traverse.py _SkiplinkArgs mirrors
// it). nodes: [n_nodes + 1, 8] float32; tris: [n_tri_rows, 12] float32
// with n_tri_rows = triangles + max_leaf, both 16-byte aligned; scope 0
// thread, 1 warp, 2 block.
struct SkiplinkArgs {
  int any_hit, scope, n_nodes, n_tri_rows, max_leaf, n;
  const float* nodes;
  const float* tris;
  const float *o, *d;  // [n, 3]
  const float *tmin, *tmax;
  float *t, *u, *v;  // out
  int* tri;
  unsigned char* hit;
};

namespace {

constexpr int kBlock = 128;
constexpr int kCountShift = 24;
constexpr int kMaxLeaf = 127;
constexpr int kThread = 0;
constexpr int kWarp = 1;
constexpr int kBlockScope = 2;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
// the warp scope's window: kWin consecutive nodes, one a lane
constexpr int kWin = 32;
// triangles of a hit leaf the warp stages at a time (3 float4 each)
constexpr int kTriChunk = 10;
// Blocks a SM the per-ray any-hit walk keeps: its registers capped at 40,
// as the earlier walk held them without a cap.
constexpr int kAnyBlocks = 12;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

struct Best {
  float t, u, v;
  int tri;
};

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v < 0.0f ? -1e-12f : 1e-12f;
  return 1.0f / (fabsf(v) < 1e-12f ? tiny : v);
}

// node row: a = lo.x lo.y lo.z hi.x, b = hi.y hi.z packed skip
__device__ __forceinline__ bool slab(const float4& a, const float4& b,
                                     const Ray& r, float best_t) {
  const float tx0 = (a.x - r.ox) * r.ix;
  const float tx1 = (a.w - r.ox) * r.ix;
  const float ty0 = (a.y - r.oy) * r.iy;
  const float ty1 = (b.x - r.oy) * r.iy;
  const float tz0 = (a.z - r.oz) * r.iz;
  const float tz1 = (b.y - r.oz) * r.iz;
  const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fmaxf(fminf(tz0, tz1), r.tmin));
  const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                          fminf(fmaxf(tz0, tz1), best_t));
  return near <= far;
}

// Moller-Trumbore on one triangle row (q0 = p0.xyz e1.x, q1 = e1.yz e2.xy,
// e2z = e2.z) against [t_min, best_t]; updates best and returns true when
// the triangle `id` is accepted.
__device__ __forceinline__ bool tri_hit(float4 q0, float4 q1, float e2z,
                                        int id, const Ray& r, Best& best) {
  const float p0x = q0.x, p0y = q0.y, p0z = q0.z;
  const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
  const float e2x = q1.z, e2y = q1.w;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = fabsf(det) > 1e-12f;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  if (det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.tmin &&
      t < best.t) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.tri = id;
    return true;
  }
  return false;
}

// Moller-Trumbore on triangles [fst, fst + cnt), in order. Returns true when
// kAnyHit and a triangle was accepted (the walk then stops). kLeaf > 0 (the
// table's max_leaf, so cnt <= kLeaf): the rows j < cnt are loaded in one
// batch, issued before the first test. kLeaf == 0: one row at a time.
template <bool kAnyHit, int kLeaf>
__device__ __forceinline__ bool leaf(const float4* __restrict__ tris,
                                     int fst, int cnt, const Ray& r,
                                     Best& best) {
  if (kLeaf == 0) {
    for (int j = 0; j < cnt; ++j) {
      const float4* row = tris + 3 * (fst + j);
      if (tri_hit(__ldg(row), __ldg(row + 1),
                  __ldg(reinterpret_cast<const float*>(row + 2)), fst + j, r,
                  best) &&
          kAnyHit) {
        return true;
      }
    }
    return false;
  }
  constexpr int kL = kLeaf > 0 ? kLeaf : 1;
  float4 q0[kL], q1[kL];
  float e2z[kL];
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    if (j < cnt) {
      const float4* row = tris + 3 * (fst + j);
      q0[j] = __ldg(row);
      q1[j] = __ldg(row + 1);
      e2z[j] = __ldg(reinterpret_cast<const float*>(row + 2));
    }
  }
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    if (j < cnt && tri_hit(q0[j], q1[j], e2z[j], fst + j, r, best) &&
        kAnyHit) {
      return true;
    }
  }
  return false;
}

template <int kScope>
__device__ __forceinline__ bool any_of(bool x) {
  return __syncthreads_or(x) != 0;
}

template <bool kAnyHit, int kScope, int kLeaf>
__global__ void __launch_bounds__(kBlock,
                                  kScope == kThread && kAnyHit ? kAnyBlocks
                                                               : 1)
skiplink_walk(const float4* __restrict__ nodes, int n_nodes,
              const float4* __restrict__ tris, int n,
              const float* __restrict__ o,
              const float* __restrict__ d, const float* __restrict__ tmin_in,
              const float* __restrict__ tmax_in, float* __restrict__ out_t,
              float* __restrict__ out_u, float* __restrict__ out_v,
              int* __restrict__ out_tri, unsigned char* __restrict__ out_hit) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  // in the block scope every thread of the block takes part in the votes,
  // rays past n included (as dead rays)
  const bool valid = i < n;
  if (kScope == kThread && !valid) return;
  const float tmax = valid ? tmax_in[i] : -1.0f;
  Best best{tmax, 0.0f, 0.0f, -1};
  const bool live = tmax >= 0.0f;
  Ray r{};
  if (live) {
    r.ox = o[3 * i + 0];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i + 0];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    r.tmin = tmin_in[i];
  }
  if (kScope == kThread) {
    int cur = live ? 0 : n_nodes;
    while (cur < n_nodes) {
      const float4 a = __ldg(nodes + 2 * cur);
      const float4 b = __ldg(nodes + 2 * cur + 1);
      int nxt = __float_as_int(b.w);
      if (slab(a, b, r, best.t)) {
        const int packed = __float_as_int(b.z);
        const int cnt = packed >> kCountShift;
        if (cnt > 0) {
          if (leaf<kAnyHit, kLeaf>(tris, packed & ((1 << kCountShift) - 1),
                                   cnt, r, best)) {
            break;
          }
        } else {
          nxt = cur + 1;
        }
      }
      cur = nxt;
    }
  } else {
    bool done = !live;  // done: the ray takes no further part
    int cur = 0;        // uniform over the block
    while (cur < n_nodes) {
      const float4 a = __ldg(nodes + 2 * cur);
      const float4 b = __ldg(nodes + 2 * cur + 1);
      const bool h = !done && slab(a, b, r, best.t);
      int nxt = __float_as_int(b.w);
      if (any_of<kScope>(h)) {
        const int packed = __float_as_int(b.z);
        const int cnt = packed >> kCountShift;
        if (cnt > 0) {
          if (h && leaf<kAnyHit, kLeaf>(tris,
                                        packed & ((1 << kCountShift) - 1),
                                        cnt, r, best)) {
            done = true;
          }
        } else {
          nxt = cur + 1;
        }
      }
      if (kAnyHit && !any_of<kScope>(!done)) break;
      cur = nxt;
    }
  }
  if (valid) {
    out_t[i] = best.t;
    out_u[i] = best.u;
    out_v[i] = best.v;
    out_tri[i] = best.tri;
    out_hit[i] = best.tri >= 0 ? 1 : 0;
  }
}

// The warp scope (kernel 8's row cursor): one cursor per 32 rays over a
// window of kWin consecutive nodes [base, base + kWin) held in registers,
// lane k holding node base + k; the current node comes to every lane by
// __shfl_sync, and a new window is loaded at the cursor when it passes the
// window's end (a node's skip link and its first child lie after it, so
// the cursor only moves forward). A hit leaf's triangle rows are staged
// for the warp in shared memory, kTriChunk triangles at a time, and each
// lane that hit the leaf tests them in order. One __any_sync a step of the
// lanes' box tests; under any hit, one more of the live lanes after a
// leaf, where alone a lane can end.
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
skiplink_warp_walk(const float4* __restrict__ nodes, int n_nodes,
                   const float4* __restrict__ tris, int n,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmin_in,
                   const float* __restrict__ tmax_in,
                   float* __restrict__ out_t, float* __restrict__ out_u,
                   float* __restrict__ out_v, int* __restrict__ out_tri,
                   unsigned char* __restrict__ out_hit) {
  __shared__ float4 s_tri[kWarps][3 * kTriChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  // every lane takes part in the votes, rays past n as dead rays
  const bool valid = i < n;
  const float tmax = valid ? tmax_in[i] : -1.0f;
  Best best{tmax, 0.0f, 0.0f, -1};
  bool done = !(tmax >= 0.0f);  // done: the ray takes no further part
  Ray r{};
  if (!done) {
    r.ox = o[3 * i + 0];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i + 0];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    r.tmin = tmin_in[i];
  }
  // uniform over the warp: the cursor and the window's first node; a warp
  // of dead rays does not walk
  int cur = __any_sync(kFull, !done) ? 0 : n_nodes;
  int base = cur;
  // node base + lane (clamped at the sentinel row n_nodes, so a window at
  // the table's end reads no row past it)
  int k = min(base + lane, n_nodes);
  float4 wa = __ldg(nodes + 2 * k);
  float4 wb = __ldg(nodes + 2 * k + 1);
  while (cur < n_nodes) {
    if (cur - base >= kWin) {  // the cursor left the window (uniform)
      base = cur;
      k = min(base + lane, n_nodes);
      wa = __ldg(nodes + 2 * k);
      wb = __ldg(nodes + 2 * k + 1);
    }
    const int off = cur - base;
    float4 a, b;
    a.x = __shfl_sync(kFull, wa.x, off);
    a.y = __shfl_sync(kFull, wa.y, off);
    a.z = __shfl_sync(kFull, wa.z, off);
    a.w = __shfl_sync(kFull, wa.w, off);
    b.x = __shfl_sync(kFull, wb.x, off);
    b.y = __shfl_sync(kFull, wb.y, off);
    b.w = __shfl_sync(kFull, wb.w, off);
    const bool h = !done && slab(a, b, r, best.t);
    int nxt = __float_as_int(b.w);
    if (__any_sync(kFull, h)) {
      // the packed first | count, read only where a lane hit the node
      const int packed = __float_as_int(__shfl_sync(kFull, wb.z, off));
      const int cnt = packed >> kCountShift;
      if (cnt > 0) {
        // the leaf's rows, kTriChunk triangles (3 float4 each) at a time,
        // staged by the warp; the lanes that hit it test them in order
        const int fst = packed & ((1 << kCountShift) - 1);
        bool stop = !h;
        for (int j0 = 0; j0 < cnt; j0 += kTriChunk) {
          const int m = min(cnt - j0, kTriChunk);
          __syncwarp();  // every lane is done with the last chunk
          if (lane < 3 * m) {
            s_tri[warp][lane] = __ldg(tris + 3 * (fst + j0) + lane);
          }
          __syncwarp();
          if (!stop) {
#pragma unroll
            for (int j = 0; j < kTriChunk; ++j) {
              if (j < m && !stop &&
                  tri_hit(s_tri[warp][3 * j], s_tri[warp][3 * j + 1],
                          s_tri[warp][3 * j + 2].x, fst + j0 + j, r, best) &&
                  kAnyHit) {
                stop = true;
                done = true;
              }
            }
          }
        }
        if (kAnyHit && !__any_sync(kFull, !done)) break;
      } else {
        nxt = cur + 1;
      }
    }
    cur = nxt;
  }
  if (valid) {
    out_t[i] = best.t;
    out_u[i] = best.u;
    out_v[i] = best.v;
    out_tri[i] = best.tri;
    out_hit[i] = best.tri >= 0 ? 1 : 0;
  }
}

template <bool kAnyHit, int kScope, int kLeaf>
cudaError_t launch(const float4* nodes, int n_nodes, const float4* tris,
                   int n, const float* o, const float* d, const float* tmin,
                   const float* tmax, float* t, float* u, float* v, int* tri,
                   unsigned char* hit, cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  if constexpr (kScope == kWarp) {
    skiplink_warp_walk<kAnyHit><<<grid, kBlock, 0, stream>>>(
        nodes, n_nodes, tris, n, o, d, tmin, tmax, t, u, v, tri, hit);
  } else {
    skiplink_walk<kAnyHit, kScope, kLeaf><<<grid, kBlock, 0, stream>>>(
        nodes, n_nodes, tris, n, o, d, tmin, tmax, t, u, v, tri, hit);
  }
  return cudaGetLastError();
}

template <bool kAnyHit, int kLeaf>
cudaError_t dispatch(int scope, const float4* nodes, int n_nodes,
                     const float4* tris, int n, const float* o,
                     const float* d, const float* tmin, const float* tmax,
                     float* t, float* u, float* v, int* tri,
                     unsigned char* hit, cudaStream_t stream) {
#define GFX_LAUNCH(S)                                                        \
  launch<kAnyHit, S, kLeaf>(nodes, n_nodes, tris, n, o, d, tmin, tmax, t, u, \
                            v, tri, hit, stream)
  switch (scope) {
    case kThread:
      return GFX_LAUNCH(kThread);
    case kWarp:
      return GFX_LAUNCH(kWarp);
    case kBlockScope:
      return GFX_LAUNCH(kBlockScope);
    default:
      return cudaErrorInvalidValue;
  }
#undef GFX_LAUNCH
}

// The leaf batch's size: for closest hit the table's max_leaf where it is
// instantiated (the bench tables' 4, and 8), else 0 (one row at a time).
// Any hit tests one row at a time: it stops at its first accepted triangle,
// and the batch's registers (72 a thread, with its cap 40 spills) cost more
// than the trips it saves (PERF.md).
template <bool kAnyHit>
cudaError_t dispatch_leaf(int max_leaf, int scope, const float4* nodes,
                          int n_nodes, const float4* tris, int n,
                          const float* o, const float* d, const float* tmin,
                          const float* tmax, float* t, float* u, float* v,
                          int* tri, unsigned char* hit, cudaStream_t stream) {
#define GFX_DISPATCH(L)                                                      \
  dispatch<kAnyHit, L>(scope, nodes, n_nodes, tris, n, o, d, tmin, tmax, t, \
                       u, v, tri, hit, stream)
  switch (max_leaf) {
    case 4:
      return GFX_DISPATCH(kAnyHit ? 0 : 4);
    case 8:
      return GFX_DISPATCH(kAnyHit ? 0 : 8);
    default:
      return GFX_DISPATCH(0);
  }
#undef GFX_DISPATCH
}

}  // namespace

extern "C" {

// sizeof(SkiplinkArgs), so the caller can check its layout
int skiplink_walk_args_size() { return (int)sizeof(SkiplinkArgs); }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int skiplink_walk_launch(const SkiplinkArgs* args, cudaStream_t stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const SkiplinkArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.n_nodes <= 0 || a.max_leaf <= 0 || a.max_leaf > kMaxLeaf ||
      a.n_tri_rows < a.max_leaf || a.n_tri_rows >= (1 << kCountShift) ||
      (reinterpret_cast<uintptr_t>(a.nodes) & 15) ||
      (reinterpret_cast<uintptr_t>(a.tris) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const float4* nodes4 = reinterpret_cast<const float4*>(a.nodes);
  const float4* tris4 = reinterpret_cast<const float4*>(a.tris);
  if (a.any_hit) {
    return (int)dispatch_leaf<true>(a.max_leaf, a.scope, nodes4, a.n_nodes,
                                    tris4, a.n, a.o, a.d, a.tmin, a.tmax, a.t,
                                    a.u, a.v, a.tri, a.hit, stream);
  }
  return (int)dispatch_leaf<false>(a.max_leaf, a.scope, nodes4, a.n_nodes,
                                   tris4, a.n, a.o, a.d, a.tmin, a.tmax, a.t,
                                   a.u, a.v, a.tri, a.hit, stream);
}

}  // extern "C"
