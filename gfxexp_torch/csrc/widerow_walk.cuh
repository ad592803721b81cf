// The per-ray wide-row walk shared by widerow_traverse.cu (one table),
// chunked_traverse.cu (the chunk tables of a large scene) and
// instanced_traverse.cu (one BLAS table per entry of a two-level scene), and
// the nearest-first pick over boxes shared by the last two and
// qrow_traverse.cu.
//
// Row format: gfxexp_torch/accel/widerow.py. The walk's plain PyTorch version
// is walk_plain in gfxexp_torch/accel/persistent.py; both apply the same
// operations in the same order, so with --fmad=false their results are equal.
//
// What bounds it: each step loads a 256-byte row (internal rows read 7*K
// floats, leaf rows 12 floats a triangle) and does a few dozen FLOPs, so a
// walk is bound by its chain of dependent loads and by the warps resident
// to hide them, not by arithmetic. Every thread walks on its own (no
// packets) and reads rows as float4 through the read-only path; the tables
// of the bench scenes (about 1 MB for one table, about 2 MB for the padded
// BLAS tables) stay resident in the 50 MB L2. The stack lives in local
// memory. An internal row with at most one hit child skips the sort
// network (descend). With kBatch a step issues the row's tail and its
// first head_quads<K>() float4 together, before it branches on the row's
// kind, and a leaf tests its first triangles from those registers: an
// internal row costs one round trip where it cost two (tail, then
// children), a leaf one or two where it cost one and one a triangle.
// Kernels 1 and 2 take it (0.92 / 0.88 of the time without it on the small
// scene, closest / any; kernel 2 in chunked_traverse.cu), and so does the
// two-level walk in build order, whose registers are not capped; the
// nearest-first two-level walk does not: its registers, capped for 6 blocks
// a SM, spill with it, and it ran 1.10-1.25x slower (PERF.md). Kernel 1's
// fed grid walks its lanes' rays a row at a time (step).
//
// The walk is written for one thread per ray. On the card a warp runs its
// 32 lanes' walks together, so it lasts as long as its longest walk. The
// kernels that take new work per lane (kernel 1's refill, the build-order
// two-level walk's windows) are there for that.
//
// What bounded the pick: it rescanned all C boxes at every pick, six __ldg
// and about 30 operations a box, so a ray that visited v boxes paid v + 1
// scans (514 boxes each on two-level `city`). nearest_first now scans once:
// the block stages the boxes in shared memory, tile by tile, and each ray
// keeps the kPick smallest keys (entry distance, index) of the boxes it
// enters within [t_min, t_max) in registers, sorted, and takes them in key
// order. Only when those run out while more boxes passed the first scan
// does it look again, for the keys after the last one taken: among the
// keys it kept in local memory, or, past kSpill of them, in every box.
// kPick = 8 was timed on the card against 4 and 16 keys, the spill list
// against refilling from a scan of every box, and the staged first scan
// against one through __ldg (PERF.md); what bounds the pick now is
// its one scan, a slab test of every box per ray.
//
// Why it visits exactly what the rescanning pick visited, in the same order:
// the plain version (walk_entries_plain in accel/persistent.py) takes, at
// each step, the smallest key after the last one taken among the boxes the
// ray enters within [t_min, best_t], and stops when that distance is >=
// best_t. A box's entry distance does not depend on best_t, and its test
// near <= min(far_x, far_y, far_z, best_t) splits into near <= the box's
// own far (fixed) and near <= best_t. As best_t only falls, the boxes that
// pass at a later step are those of the first scan with near <= best_t. So
// the next pick is the next buffered key; if its distance is >= best_t, the
// plain version stops there or finds nothing (every later key is as far),
// and the walk stops too. The boxes with near == t_max that the plain
// version admits would stop it on the spot, so the scan leaves them out.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace widerow {

constexpr int kWidth = 64;       // floats per row
constexpr int kMaxStack = 128;   // compile-time stack bound (entries)
constexpr int kPick = 8;         // keys a ray keeps in registers
constexpr int kSpill = 32;       // keys a ray keeps in local memory
constexpr int kBoxTile = 512;    // boxes staged in shared memory at a time

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v < 0.0f ? -1e-12f : 1e-12f;
  return 1.0f / (fabsf(v) < 1e-12f ? tiny : v);
}

// compare-swap on (entry distance, child row, valid): ascending, ties keep
// their order (the plain version's `swap = near[a] > near[b]`)
__device__ __forceinline__ void cswap(float* nr, int* mt, bool* vd, int a,
                                      int b) {
  if (nr[a] > nr[b]) {
    const float tn = nr[a]; nr[a] = nr[b]; nr[b] = tn;
    const int tm = mt[a]; mt[a] = mt[b]; mt[b] = tm;
    const bool tv = vd[a]; vd[a] = vd[b]; vd[b] = tv;
  }
}

template <int K>
__device__ __forceinline__ void sort_children(float* nr, int* mt, bool* vd);

template <>
__device__ __forceinline__ void sort_children<4>(float* nr, int* mt,
                                                 bool* vd) {
  cswap(nr, mt, vd, 0, 1); cswap(nr, mt, vd, 2, 3);
  cswap(nr, mt, vd, 0, 2); cswap(nr, mt, vd, 1, 3);
  cswap(nr, mt, vd, 1, 2);
}

template <>
__device__ __forceinline__ void sort_children<8>(float* nr, int* mt,
                                                 bool* vd) {
  cswap(nr, mt, vd, 0, 1); cswap(nr, mt, vd, 2, 3);
  cswap(nr, mt, vd, 4, 5); cswap(nr, mt, vd, 6, 7);
  cswap(nr, mt, vd, 0, 2); cswap(nr, mt, vd, 1, 3);
  cswap(nr, mt, vd, 4, 6); cswap(nr, mt, vd, 5, 7);
  cswap(nr, mt, vd, 1, 2); cswap(nr, mt, vd, 5, 6);
  cswap(nr, mt, vd, 0, 4); cswap(nr, mt, vd, 3, 7);
  cswap(nr, mt, vd, 1, 5); cswap(nr, mt, vd, 2, 6);
  cswap(nr, mt, vd, 3, 6); cswap(nr, mt, vd, 2, 4);
  cswap(nr, mt, vd, 1, 2); cswap(nr, mt, vd, 3, 5);
  cswap(nr, mt, vd, 4, 5); cswap(nr, mt, vd, 3, 4);
}

// The next row after an internal row whose K children have entry distance
// nr, child entry mt and hit flag vd: the nearest hit child, the other hit
// children pushed far to near, in the order of the plain version's K-wide
// network (whose tie order this shares). With at most one hit child the
// network would leave that child first and push nothing (or, at an entry
// distance as infinite as the misses', push it and pop it straight back),
// so the network is skipped. A push past kCap entries would be dropped;
// the launch wrappers check the table's depth against kCap, so none is.
template <int K, int kCap>
__device__ __forceinline__ int descend(float* nr, int* mt, bool* vd,
                                       int* stack, int& sp) {
  int n_hit = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) n_hit += vd[k] ? 1 : 0;
  if (n_hit <= 1) {
    int nxt = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) nxt = vd[k] ? mt[k] : nxt;
    return nxt;
  }
  sort_children<K>(nr, mt, vd);
#pragma unroll
  for (int s = K - 1; s >= 1; --s) {
    if (vd[s]) {
      if (sp < kCap) stack[sp] = mt[s];
      ++sp;
    }
  }
  return vd[0] ? mt[0] : -1;
}

// The best hit a ray has found so far; carried across walks (the entries of
// a two-level scene).
struct Best {
  float t, u, v;
  int tri;
};

// One Baldwin-Weber test of triangle `id` (n.xyz d0 | U.xyz Ud | V.xyz Vd)
// against [tmin, best.t]; updates best and returns true when accepted.
__device__ __forceinline__ bool tri_hit(float4 pn, float4 pu, float4 pv,
                                        int id, float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float tmin, Best& best) {
  const float den = pn.x * dx + pn.y * dy + pn.z * dz;
  const float num = pn.x * ox + pn.y * oy + pn.z * oz + pn.w;
  const bool den_ok = fabsf(den) > 1e-12f;
  const float t = -num / (den_ok ? den : 1.0f);
  const float px = ox + t * dx;
  const float py = oy + t * dy;
  const float pz = oz + t * dz;
  const float u = pu.x * px + pu.y * py + pu.z * pz + pu.w;
  const float v = pv.x * px + pv.y * py + pv.z * pz + pv.w;
  if (den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
      t < best.t) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.tri = id;
    return true;
  }
  return false;
}

// The triangles of a leaf row (tail = its cols 60..63): Baldwin-Weber
// tests, ids first | count << 24, one load of a triangle at a time. Returns
// true when kAnyHit and a triangle was accepted (the walk stops there).
template <bool kAnyHit>
__device__ __forceinline__ bool leaf_hits(const float4* __restrict__ row,
                                          float4 tail, int max_leaf,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float tmin, Best& best) {
  const int packed = __float_as_int(tail.x);
  const int fst = packed & 0xFFFFFF;
  const int cnt = packed >> 24;
  for (int j = 0; j < max_leaf && j < cnt; ++j) {
    if (tri_hit(__ldg(row + 3 * j + 0), __ldg(row + 3 * j + 1),
                __ldg(row + 3 * j + 2), fst + j, ox, oy, oz, dx, dy, dz, tmin,
                best) &&
        kAnyHit) {
      return true;
    }
  }
  return false;
}

// float4 of a row loaded with its tail before the walk knows the row's
// kind: an internal row's K children (7 floats each), which also hold a leaf
// row's first triangles (12 floats each).
template <int K>
__host__ __device__ constexpr int head_quads() {
  return 7 * K / 4;
}

// The triangles of a leaf row from registers: q[0, kHead) came with the
// tail; the float4 a leaf of more triangles still needs (up to 3 * count - 1,
// at most 14, all inside the 256-byte row) are loaded in one batch, issued
// before the first test. Then the tests run in order, as leaf_hits runs
// them, so best keeps its bits.
template <bool kAnyHit, int kHead>
__device__ __forceinline__ bool leaf_rows(const float4* __restrict__ row,
                                          float4 (&q)[15], float4 tail,
                                          int max_leaf, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float tmin, Best& best) {
  const int packed = __float_as_int(tail.x);
  const int fst = packed & 0xFFFFFF;
  const int n = min(packed >> 24, max_leaf);
#pragma unroll
  for (int i = kHead; i < 15; ++i) {
    if (i < 3 * n) q[i] = __ldg(row + i);
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    if (j < n && tri_hit(q[3 * j], q[3 * j + 1], q[3 * j + 2], fst + j, ox,
                         oy, oz, dx, dy, dz, tmin, best) &&
        kAnyHit) {
      return true;
    }
  }
  return false;
}

// Walk the table from row `start`. Child rows in the table are relative to
// `base` (a BLAS's first row in the flat [B*R, 64] table; 0 for one table);
// row addresses are clamped to the table as the plain version clamps them.
// Slab tests run against [tmin, best.t]; leaf triangles are Baldwin-Weber
// tests `den_ok & u>=0 & v>=0 & u+v<=1 & t>tmin & t<best.t`. Returns true
// when kAnyHit and a triangle was accepted (the caller stops there).
//
// kBatch: a step issues the row's tail and its first head_quads<K>() float4
// in one batch, before it branches on the row's kind, and a leaf tests its
// triangles from registers (leaf_rows): an internal row costs one round
// trip to memory, a leaf row one, or two when it holds more triangles than
// the batch did. Without it, a step loads the tail, then the children, and
// a leaf loads one triangle at a time.
template <bool kAnyHit, int K, bool kBatch>
__device__ __forceinline__ bool walk(const float* __restrict__ nodes,
                                     int n_rows, int base, int start,
                                     int max_leaf, float ox, float oy,
                                     float oz, float dx, float dy, float dz,
                                     float tmin, Best& best, int* stack) {
  constexpr int kHead = head_quads<K>();
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  int sp = 0;
  int cur = start;
  while (cur >= 0) {
    const int r = min(base + cur, n_rows - 1);
    const float4* row =
        reinterpret_cast<const float4*>(nodes + (size_t)r * kWidth);
    float4 q[15];
    if (kBatch) {
#pragma unroll
      for (int i = 0; i < kHead; ++i) q[i] = __ldg(row + i);
    }
    const float4 tail = __ldg(row + 15);  // cols 60..63
    int nxt = -1;
    if (tail.w > 0.5f) {
      if (kBatch ? leaf_rows<kAnyHit, kHead>(row, q, tail, max_leaf, ox, oy,
                                             oz, dx, dy, dz, tmin, best)
                 : leaf_hits<kAnyHit>(row, tail, max_leaf, ox, oy, oz, dx,
                                      dy, dz, tmin, best)) {
        return true;
      }
    } else {
      // internal: K children of 7 floats (lo.xyz hi.xyz child row)
      if (!kBatch) {
#pragma unroll
        for (int i = 0; i < kHead; ++i) q[i] = __ldg(row + i);
      }
      float c[7 * K];
#pragma unroll
      for (int i = 0; i < kHead; ++i) {
        c[4 * i + 0] = q[i].x;
        c[4 * i + 1] = q[i].y;
        c[4 * i + 2] = q[i].z;
        c[4 * i + 3] = q[i].w;
      }
      float nr[K];
      int mt[K];
      bool vd[K];
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
        const bool ok = near <= far && meta >= 0;
        nr[k] = ok ? near : CUDART_INF_F;
        mt[k] = meta;
        vd[k] = ok;
      }
      nxt = descend<K, kMaxStack>(nr, mt, vd, stack, sp);
    }
    if (nxt < 0 && sp > 0) {
      --sp;
      nxt = sp < kMaxStack ? stack[sp] : -1;
    }
    cur = nxt;
  }
  return false;
}

// One step of kernel 1's fed grid (widerow_traverse.cu), whose lanes walk
// their rays a row at a time: the body of walk's loop with the row batch,
// at row `cur` (relative to the table's first row), with the reciprocals
// ix, iy, iz. Returns the next row (the nearest hit child, else the top of
// the stack), -1 when the walk is done, or kAccepted. walk keeps its own
// loop: written as a loop over this step it ran kernel 2's any hit 3-4%
// slower on the card (PERF.md).
constexpr int kAccepted = -2;

template <bool kAnyHit, int K>
__device__ __forceinline__ int step(const float* __restrict__ nodes,
                                    int n_rows, int cur, int max_leaf,
                                    float ox, float oy, float oz, float dx,
                                    float dy, float dz, float ix, float iy,
                                    float iz, float tmin, Best& best,
                                    int* stack, int& sp) {
  constexpr int kHead = head_quads<K>();
  const int r = min(cur, n_rows - 1);
  const float4* row =
      reinterpret_cast<const float4*>(nodes + (size_t)r * kWidth);
  float4 q[15];
#pragma unroll
  for (int i = 0; i < kHead; ++i) q[i] = __ldg(row + i);
  const float4 tail = __ldg(row + 15);  // cols 60..63
  int nxt = -1;
  if (tail.w > 0.5f) {
    if (leaf_rows<kAnyHit, kHead>(row, q, tail, max_leaf, ox, oy, oz, dx,
                                  dy, dz, tmin, best)) {
      return kAccepted;
    }
  } else {
    // internal: K children of 7 floats (lo.xyz hi.xyz child row)
    float c[7 * K];
#pragma unroll
    for (int i = 0; i < kHead; ++i) {
      c[4 * i + 0] = q[i].x;
      c[4 * i + 1] = q[i].y;
      c[4 * i + 2] = q[i].z;
      c[4 * i + 3] = q[i].w;
    }
    float nr[K];
    int mt[K];
    bool vd[K];
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
      const bool ok = near <= far && meta >= 0;
      nr[k] = ok ? near : CUDART_INF_F;
      mt[k] = meta;
      vd[k] = ok;
    }
    nxt = descend<K, kMaxStack>(nr, mt, vd, stack, sp);
  }
  if (nxt < 0 && sp > 0) {
    --sp;
    nxt = sp < kMaxStack ? stack[sp] : -1;
  }
  return nxt;
}

// The slab test of a box lo, hi against a ray: its entry distance `near`
// and whether the ray enters it within [tmin, best_t] (`near <= far`), in
// the order of operations of a BVH child's test.
__device__ __forceinline__ float slab(float lx, float ly, float lz, float hx,
                                      float hy, float hz, float ox, float oy,
                                      float oz, float ix, float iy, float iz,
                                      float tmin, float best_t, bool& ok) {
  const float tx0 = (lx - ox) * ix;
  const float tx1 = (hx - ox) * ix;
  const float ty0 = (ly - oy) * iy;
  const float ty1 = (hy - oy) * iy;
  const float tz0 = (lz - oz) * iz;
  const float tz1 = (hz - oz) * iz;
  const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fmaxf(fminf(tz0, tz1), tmin));
  const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                          fminf(fmaxf(tz0, tz1), best_t));
  ok = near <= far;
  return near;
}

// Entry distance of the ray into box c of lo, hi ([C, 3] each, read through
// __ldg); `ok` when it enters within [tmin, best_t].
__device__ __forceinline__ float box_near(const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          int c, float ox, float oy, float oz,
                                          float ix, float iy, float iz,
                                          float tmin, float best_t, bool& ok) {
  return slab(__ldg(lo + 3 * c + 0), __ldg(lo + 3 * c + 1),
              __ldg(lo + 3 * c + 2), __ldg(hi + 3 * c + 0),
              __ldg(hi + 3 * c + 1), __ldg(hi + 3 * c + 2), ox, oy, oz, ix,
              iy, iz, tmin, best_t, ok);
}

// Insert key (n, c) into the ascending buffer bn, bc of kPick keys, dropping
// the largest. Keys arrive in increasing c, so a new key is smaller than a
// buffered one exactly when its distance is: ties keep the smaller index
// first. Static indices only, so the buffer stays in registers.
__device__ __forceinline__ void pick_insert(float* bn, int* bc, float n,
                                            int c) {
  if (!(n < bn[kPick - 1])) return;
#pragma unroll
  for (int j = kPick - 1; j > 0; --j) {
    const bool up = n < bn[j - 1];
    const bool here = !up && n < bn[j];
    bn[j] = up ? bn[j - 1] : (here ? n : bn[j]);
    bc[j] = up ? bc[j - 1] : (here ? c : bc[j]);
  }
  if (n < bn[0]) {
    bn[0] = n;
    bc[0] = c;
  }
}

// Shared memory nearest_first needs for `count` boxes: a tile of up to
// kBoxTile boxes, 8 floats each (lo.xyz hi.x | hi.yz and 2 unused, read as
// two float4). Sized to the boxes, so a small set leaves the L1 its room.
__host__ __device__ __forceinline__ int pick_smem_bytes(int count) {
  return 32 * (count < kBoxTile ? count : kBoxTile);
}

// Boxes c0 .. c0 + m - 1 of lo, hi into the tile s (m <= kBoxTile), 8 floats
// each, the block's threads together.
__device__ __forceinline__ void stage_boxes(const float* __restrict__ lo,
                                            const float* __restrict__ hi,
                                            int c0, int m, float* s) {
  for (int j = threadIdx.x; j < 3 * m; j += blockDim.x) {
    const int b = j / 3, k = j - 3 * b;
    s[8 * b + k] = __ldg(lo + 3 * c0 + j);
    s[8 * b + 3 + k] = __ldg(hi + 3 * c0 + j);
  }
}

// Where nearest_first's first scan finds the boxes: staged by the block
// tile by tile between barriers; staged whole in `tile` before (count <=
// kBoxTile, stage_boxes); or read through __ldg (`tile` unused).
enum class BoxScan { kStageTiles, kStaged, kLdg };

// Nearest-first order over `count` boxes lo, hi ([C, 3] each: the chunks of
// a large table, the TLAS entries of a two-level scene): the boxes the ray
// enters within [tmin, best.t] in ascending (entry distance, index),
// stopping at the first whose distance is >= best.t. visit(c) walks box c
// (updating best) and returns true to stop (an accepted any hit). kScan
// says where the first scan finds the boxes (BoxScan). With kStageTiles
// every thread of the block must call it, with `tile` the block's
// pick_smem_bytes(count) of shared memory: it stages the boxes between
// barriers; threads with live == false only help to stage. With kStaged or
// kLdg a thread calls it alone, without barriers.
//
// The first scan keeps the kPick smallest keys in registers and the keys of
// up to kSpill boxes that passed it in local memory, in scan order. When
// the buffer runs dry while more boxes passed, it refills from those keys,
// or, when more than kSpill passed, by a scan of every box through __ldg;
// either way it takes the smallest keys after the last one taken among the
// boxes still entered before best.t.
template <BoxScan kScan = BoxScan::kStageTiles, class Visit>
__device__ __forceinline__ void nearest_first(
    const float* __restrict__ lo, const float* __restrict__ hi, int count,
    float4* tile, bool live, float ox, float oy, float oz, float ix,
    float iy, float iz, float tmin, const Best& best, Visit visit) {
  float bn[kPick];
  int bc[kPick];
#pragma unroll
  for (int j = 0; j < kPick; ++j) {
    bn[j] = CUDART_INF_F;
    bc[j] = 0;
  }
  float spill_n[kSpill];
  int spill_c[kSpill];
  // the first scan, against t_max (= best.t before any visit)
  int passed = 0;
  float* s = reinterpret_cast<float*>(tile);
  for (int c0 = 0; c0 < count; c0 += kBoxTile) {
    const int m = min(kBoxTile, count - c0);
    if (kScan == BoxScan::kStageTiles) {
      __syncthreads();  // every thread is done with the last tile
      stage_boxes(lo, hi, c0, m, s);
      __syncthreads();
    }
    if (live) {
#pragma unroll 4
      for (int b = 0; b < m; ++b) {
        bool ok;
        float nr;
        if (kScan == BoxScan::kLdg) {
          nr = box_near(lo, hi, c0 + b, ox, oy, oz, ix, iy, iz, tmin, best.t,
                        ok);
        } else {
          const float4 p = tile[2 * b];
          const float4 q = tile[2 * b + 1];
          nr = slab(p.x, p.y, p.z, p.w, q.x, q.y, ox, oy, oz, ix, iy, iz,
                    tmin, best.t, ok);
        }
        if (ok && nr < best.t) {
          if (passed < kSpill) {
            spill_n[passed] = nr;
            spill_c[passed] = c0 + b;
          }
          ++passed;
          pick_insert(bn, bc, nr, c0 + b);
        }
      }
    }
  }
  if (!live) return;
  int left = min(passed, kPick);  // buffered keys not yet taken
  bool more = passed > kPick;     // keys of the scan beyond the buffer
  float last_n = 0.0f;
  int last_c = -1;
  while (true) {
    if (left == 0) {
      if (!more) break;
      // refill: the smallest keys after the last one taken among the boxes
      // still entered before best.t
#pragma unroll
      for (int j = 0; j < kPick; ++j) bn[j] = CUDART_INF_F;
      int found = 0;
      if (passed <= kSpill) {
        for (int j = 0; j < passed; ++j) {
          const float nr = spill_n[j];
          const int c = spill_c[j];
          if ((nr > last_n || (nr == last_n && c > last_c)) && nr < best.t) {
            ++found;
            pick_insert(bn, bc, nr, c);
          }
        }
      } else {
        for (int c = 0; c < count; ++c) {
          bool ok;
          const float nr =
              box_near(lo, hi, c, ox, oy, oz, ix, iy, iz, tmin, best.t, ok);
          if (ok && (nr > last_n || (nr == last_n && c > last_c)) &&
              nr < best.t) {
            ++found;
            pick_insert(bn, bc, nr, c);
          }
        }
      }
      left = min(found, kPick);
      more = found > kPick;
      if (left == 0) break;
    }
    const float nr = bn[0];
    const int c = bc[0];
#pragma unroll
    for (int j = 0; j + 1 < kPick; ++j) {
      bn[j] = bn[j + 1];
      bc[j] = bc[j + 1];
    }
    --left;
    if (nr >= best.t) break;
    if (visit(c)) break;
    last_n = nr;
    last_c = c;
  }
}

}  // namespace widerow
